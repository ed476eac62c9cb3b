"""What every cell shares: finding its files, the generator of traffic and
weights, the statistics, the peaks of the card and the reading of a trace."""
