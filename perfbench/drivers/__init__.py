"""One driver per path of the program: how it is set up, warmed, driven
through the measured window, traced and checked."""
