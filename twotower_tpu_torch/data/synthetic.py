"""Synthetic interaction generator for tests and benchmarks (the PyTorch
port's copy of ``twotower_tpu/data/synthetic.py``; the large-size draw runs
on the device with a ``torch.Generator``).

No reference analog (the reference's tests hand-build tiny DataFrames,
tests/unit/test_preprocessor.py:277-292); this produces arbitrarily sized,
seeded, power-law-distributed interactions with latent structure so retrieval
metrics are meaningfully above chance — letting us exercise the full train/
eval path without network access to the real Amazon Reviews dataset.
"""

from __future__ import annotations

import numpy as np

from twotower_tpu_torch.data.schema import Interactions


def _affinity_items_np(u_lat, i_lat, users, affinity_scale, rng):
    """Chunked numpy gumbel-argmax (small workloads / no accelerator)."""
    latent_dim = u_lat.shape[1]
    items = np.empty(len(users), dtype=np.int64)
    chunk = 8192
    for start in range(0, len(users), chunk):
        end = min(start + chunk, len(users))
        uu = users[start:end]
        logits = (
            np.float32(affinity_scale) * (u_lat[uu] @ i_lat.T)
            / np.float32(np.sqrt(latent_dim))
        )
        gumbel = -np.log(
            -np.log(rng.random(logits.shape, dtype=np.float32) + 1e-12) + 1e-12
        )
        items[start:end] = np.argmax(logits + gumbel, axis=1)
    return items


def _affinity_items_torch(u_lat, i_lat, users, affinity_scale, seed, device):
    """Device-side gumbel-argmax: the ``[chunk, num_items]`` logits live in
    device memory and only the winning item ids come back to the host.
    Deterministic for a fixed seed (its own ``torch.Generator`` stream: the
    values differ from the numpy route, the distribution is identical).
    The gumbel noise is ``-log(E + 1e-12)`` with ``E ~ Exp(1)``, the same
    variable as the numpy route's ``-log(-log(U + 1e-12) + 1e-12)``."""
    import torch

    from twotower_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u_lat_d = torch.from_numpy(u_lat).to(dev)
    i_lat_d = torch.from_numpy(i_lat).to(dev)
    users_d = torch.from_numpy(np.asarray(users, np.int64)).to(dev)
    scale = float(affinity_scale) / float(np.sqrt(np.float32(u_lat.shape[1])))
    out = torch.empty(len(users), dtype=torch.int64, device=dev)
    chunk = 8192
    for start in range(0, len(users), chunk):
        logits = (u_lat_d[users_d[start : start + chunk]] @ i_lat_d.T).mul_(scale)
        noise = torch.empty_like(logits).exponential_(generator=gen).add_(1e-12).log_()
        out[start : start + chunk] = torch.argmax(logits.sub_(noise), dim=1)
    return out.cpu().numpy()


def generate_interactions(
    num_users: int = 1000,
    num_items: int = 500,
    num_interactions: int = 10_000,
    latent_dim: int = 8,
    noise: float = 0.5,
    with_text: bool = False,
    seed: int = 42,
    affinity_scale: float = 1.0,
    device=None,
) -> Interactions:
    """Sample interactions from a latent-factor model.

    Users/items get latent vectors; each interaction draws its item from the
    user's affinity softmax with probability ``1 - noise`` and from a global
    power-law popularity distribution with probability ``noise`` — a true
    component mixture, so the power-law head adds realistic skew without
    multiplying into every affinity draw (an additive ``log(popularity)``
    logit term lets one zipf-head item dominate the whole catalog at small
    ``num_items``). A two-tower model can recover the latent structure and
    beat random Recall@K by a wide margin. ``affinity_scale`` sharpens the
    softmax: at large catalogs (10k+ items) raise it to ~3 so per-user mass
    concentrates enough for a meaningful recall ceiling.

    Past ``num_interactions * num_items >= 2**28`` the affinity draw runs on
    ``device`` (``cuda`` unless the caller asks for the CPU); below it the
    numpy route draws the same values as the JAX package's.
    """
    rng = np.random.default_rng(seed)
    u_lat = rng.normal(size=(num_users, latent_dim)).astype(np.float32)
    i_lat = rng.normal(size=(num_items, latent_dim)).astype(np.float32)
    popularity = rng.zipf(1.5, size=num_items).astype(np.float64)
    popularity /= popularity.sum()

    users = rng.integers(0, num_users, size=num_interactions)

    # Gumbel-argmax over the full [chunk, num_items] affinity logits is the
    # bandwidth hot spot (it IS a softmax sample, exactly): at 1M
    # interactions x 100k items it streams hundreds of GB, so past a size
    # threshold the affinity draw runs on the device.
    if num_interactions * num_items >= 1 << 28:
        aff_items = _affinity_items_torch(
            u_lat, i_lat, users, affinity_scale, seed, device
        )
    else:
        aff_items = _affinity_items_np(u_lat, i_lat, users, affinity_scale, rng)
    pop_items = rng.choice(num_items, size=num_interactions, p=popularity)
    use_pop = rng.random(num_interactions) < noise
    items = np.where(use_pop, pop_items, aff_items).astype(np.int64)

    affinity = np.einsum("nd,nd->n", u_lat[users], i_lat[items]) / np.sqrt(latent_dim)
    rating = np.clip(np.round(3.0 + affinity + 0.5 * rng.normal(size=num_interactions)), 1, 5)
    base_ts = 1_600_000_000
    timestamp = base_ts + np.sort(rng.integers(0, 3 * 365 * 86400, size=num_interactions))

    text = None
    title = None
    if with_text:
        words = np.array(
            ["great", "terrible", "quality", "product", "love", "broken",
             "works", "fast", "shipping", "recommend", "money", "waste"],
            dtype=object,
        )
        text = np.array(
            [" ".join(rng.choice(words, size=rng.integers(5, 20))) for _ in range(num_interactions)],
            dtype=object,
        )
        title = np.array(
            [" ".join(rng.choice(words, size=2)) for _ in range(num_interactions)], dtype=object
        )

    return Interactions(
        user_id=np.array([f"U{u:07d}" for u in users], dtype=object),
        item_id=np.array([f"I{i:07d}" for i in items], dtype=object),
        rating=rating.astype(np.float32),
        timestamp=timestamp.astype(np.int64),
        text=text,
        title=title,
    )
