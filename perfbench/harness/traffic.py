"""The one generator of every traffic mix: ids, rows and arrival times drawn
from the run's seed by the parameters a traffic file gives.

Id distributions (a traffic file's ``{"dist": ...}``):

- ``uniform``: every id alike.
- ``zipf`` with ``exponent``: the id of popularity rank ``r`` is drawn with
  weight ``(r + 1) ** -exponent``; ranks are dealt to ids by a permutation
  drawn from the seed, so the hot ids lie anywhere in the table.
- ``same_cluster`` with ``clusters`` (item ids only): an item of the row's
  user's cluster, ``user % clusters``, drawn uniformly; the planted weights
  (``harness/weights.py``) make such an item rank high for the user.
- ``catalog_drift`` (item ids only): the item law of the repo's synthetic
  corpus generator (``data/synthetic_scale.py``), written out again here
  with the parameters a recorded corpus was made with. Items are dealt to
  ``clusters`` clusters of Dirichlet(``size_concentration``) sizes, laid out
  by a random permutation. A row picks a cluster by its user's affinity
  (softmax of ``affinity_scale`` u.c / sqrt(``latent_dim``) over normal
  latents) or, with probability ``noise``, by the clusters' sizes; then an
  item of the cluster's launched part (``catalog_start_frac`` growing to all
  over the corpus's time) with weight ``(rank + 1) ** -within_zipf``, the
  ranks rotated by ``drift_ranks_per_era`` in each of ``num_eras`` eras. The
  rows cover the time ``span`` (the train split's share, in order) in
  ``chunks`` equal chunks. A batch of an epoch is a random sample of its
  rows, so what a step sees (its distinct items, its repeats) follows the
  marginal law: each row's cluster is drawn from the affinity averaged over
  every user, not from its own user's.

Draws run on the device in a few large calls. Every stream of the run has a
generator of its own, seeded from the run's seed and the stream's number.
"""

from __future__ import annotations

import numpy as np
import torch

# Streams of one run: each draw has its own generator.
WEIGHTS, USERS, ITEMS, RANKS, ORDER, ARRIVALS, SAMPLE = range(7)


def seed_for(seed: int, stream: int) -> int:
    """A 63-bit seed of ``stream`` within the run of ``seed`` (any whole
    number, also past 2**32)."""
    return (int(seed) * 1_000_003 + 7919 * stream + 1) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed_for(seed, stream))


def draw_ids(spec: dict, n: int, num_ids: int, seed: int, stream: int, device,
             *, users: torch.Tensor | None = None, num_users: int | None = None) -> torch.Tensor:
    """``n`` int64 ids in ``[0, num_ids)`` by ``spec`` on ``device``
    (``users``: the rows' users, for ``same_cluster``; ``num_users``: the
    users' number, for ``catalog_drift``)."""
    dist = spec["dist"]
    if dist == "catalog_drift":
        if num_users is None:
            raise ValueError("catalog_drift items need the number of users")
        return _catalog_drift(spec, n, num_ids, num_users, seed, stream, device)
    gen = generator(seed, stream, device)
    if dist == "uniform":
        return torch.randint(0, num_ids, (n,), generator=gen, device=device)
    if dist == "zipf":
        ranks = torch.arange(1, num_ids + 1, device=device, dtype=torch.float64)
        cdf = torch.cumsum(ranks.pow(-float(spec["exponent"])), 0)
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * cdf[-1]
        rank = torch.searchsorted(cdf, u).clamp_(max=num_ids - 1)
        order = torch.randperm(num_ids, generator=generator(seed, stream + 100, device),
                               device=device)
        return order[rank]
    if dist == "same_cluster":
        if users is None:
            raise ValueError("same_cluster items need the rows' users")
        clusters = int(spec["clusters"])
        home = users % clusters
        members = (num_ids - 1 - home) // clusters + 1  # ids home, home + C, ... below num_ids
        pick = (torch.rand(n, generator=gen, device=device, dtype=torch.float64)
                * members).long().clamp_(max=members - 1)
        return home + clusters * pick
    raise ValueError(f"unknown id distribution {dist!r}")


def cluster_sizes(rng: np.random.Generator, clusters: int, num_items: int,
                  concentration: float) -> np.ndarray:
    """Items per cluster: Dirichlet shares rounded, at least one each, the
    sum repaired one item at a time over the largest clusters."""
    counts = np.maximum(1, np.round(rng.dirichlet(np.full(clusters, concentration))
                                    * num_items).astype(np.int64))
    diff = int(counts.sum()) - num_items
    order = np.argsort(-counts)
    i = 0
    while diff != 0:
        c = order[i % clusters]
        step = -1 if diff > 0 else 1
        if counts[c] + step >= 1:
            counts[c] += step
            diff += step
        i += 1
    return counts


def _catalog_drift(spec: dict, n: int, num_items: int, num_users: int, seed: int,
                   stream: int, device) -> torch.Tensor:
    dev = torch.device(device)
    rng = np.random.default_rng(seed_for(seed, stream))
    gen = generator(seed, stream, dev)
    c = int(spec["clusters"])
    d = int(spec["latent_dim"])
    sizes = torch.as_tensor(cluster_sizes(rng, c, num_items, float(spec["size_concentration"])),
                            device=dev)
    slot_start = torch.cumsum(sizes, 0) - sizes
    item_of_slot = torch.randperm(num_items, generator=gen, device=dev)
    centroids = torch.randn((c, d), generator=gen, device=dev)
    affinity = torch.zeros(c, dtype=torch.float64, device=dev)
    scale = float(spec["affinity_scale"]) / d ** 0.5
    for lo in range(0, num_users, 1 << 17):  # every user's latent, in blocks
        u = torch.randn((min(1 << 17, num_users - lo), d), generator=gen, device=dev)
        affinity += torch.softmax(scale * (u @ centroids.T), dim=1).sum(0, dtype=torch.float64)
    noise = float(spec["noise"])
    p_cluster = (1.0 - noise) * affinity / num_users + noise * sizes.double() / num_items
    lo_t, hi_t = (float(x) for x in spec["span"])
    chunks, eras = int(spec["chunks"]), int(spec["num_eras"])
    start_frac, drift = float(spec["catalog_start_frac"]), int(spec["drift_ranks_per_era"])
    zipf = float(spec["within_zipf"])
    out = torch.empty(n, dtype=torch.long, device=dev)
    cluster_ids = torch.arange(c, device=dev)
    for k in range(chunks):
        rlo, rhi = n * k // chunks, n * (k + 1) // chunks
        if rhi == rlo:
            continue
        t = lo_t + (hi_t - lo_t) * (k + 0.5) / chunks
        era = min(eras - 1, int(t * eras))
        alive = torch.clamp(torch.ceil(sizes.double() * (start_frac + (1.0 - start_frac) * t)),
                            min=1).long()
        first = torch.cumsum(alive, 0) - alive  # each cluster's start in the flat layout
        of = torch.repeat_interleave(cluster_ids, alive)
        pos = torch.arange(int(alive.sum()), device=dev) - first[of]
        rank = (pos + (era * drift) % alive[of]) % alive[of]
        cum = torch.cumsum((rank + 1).double() ** -zipf, 0)
        before = torch.where(first > 0, cum[(first - 1).clamp(min=0)], 0.0)
        total = cum[first + alive - 1] - before
        key = of.double() + (cum - before[of]) / total[of]  # cluster + its cdf: increasing
        rows_cl = torch.multinomial(p_cluster, rhi - rlo, replacement=True, generator=gen)
        u = torch.rand(rhi - rlo, generator=gen, device=dev, dtype=torch.float64)
        at = torch.searchsorted(key, rows_cl.double() + u, right=True) - first[rows_cl]
        at = torch.minimum(at, alive[rows_cl] - 1)
        out[rlo:rhi] = item_of_slot[slot_start[rows_cl] + at]
    return out


def poisson_arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of an open loop of
    Poisson arrivals at ``rate`` a second over ``seconds``."""
    rng = np.random.default_rng(seed_for(seed, ARRIVALS))
    n = int(rate * seconds * 1.2) + 100
    due = np.cumsum(rng.exponential(1.0 / rate, n))
    while due[-1] < seconds:  # the draw ran short: extend it
        due = np.concatenate([due, due[-1] + np.cumsum(rng.exponential(1.0 / rate, n))])
    return due[due < seconds]


def log_q(item_ids: torch.Tensor, num_items: int) -> torch.Tensor:
    """log of each item's share of the drawn rows (``+1e-12``, as the
    train CLI takes it from its vocabulary's frequencies), float32."""
    counts = torch.bincount(item_ids, minlength=num_items).double()
    return torch.log(counts / counts.sum() + 1e-12).float()


def sample_indices(n_pool: int, n_sample: int, seed: int) -> np.ndarray:
    """A sorted sample, drawn from the seed, of ``n_sample`` of ``n_pool``
    indices (all of them when the pool is smaller)."""
    rng = np.random.default_rng(seed_for(seed, SAMPLE))
    if n_pool <= n_sample:
        return np.arange(n_pool)
    return np.sort(rng.choice(n_pool, n_sample, replace=False))
