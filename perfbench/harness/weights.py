"""The model's weights, made on the device from the run's seed in a few large
calls, in the layout the program takes (``twotower_tpu_torch.models.
two_tower``): ``{"user_embedding": [U', E], "item_embedding": [I', E],
"user_tower": [{"kernel": [in, out], "bias": [out]}, ...], "item_tower":
[...]}``, float32, tables padded to a multiple of 128 rows with at least one
spare row. The reference calls the same function to make the same weights
again; both sides get the same inputs and nothing the other made.

Kinds (a traffic file's ``weights``):

- ``random``: table rows ``N(0, 1/E)``, He-initialised tower kernels, zero
  biases.
- ``planted`` with ``clusters`` and ``noise``: row ``r`` of each table is its
  cluster's centroid (``r % clusters``) plus ``noise`` times a normal draw,
  over ``sqrt(E)``, and the item tower is a copy of the user tower, so a
  user's own cluster ranks high for it: an evaluation then reads real ranks
  and not the zeros of random weights.
"""

from __future__ import annotations

import torch

from perfbench.harness.traffic import WEIGHTS, generator

LANE = 128


def padded_rows(n: int) -> int:
    """The program's table layout: ``n`` rows and a spare one, rounded up to
    a multiple of 128."""
    return -(-(max(n, 1) + 1) // LANE) * LANE


def _tower(gen, in_dim: int, dims: list[int], device) -> list[dict]:
    layers = []
    for out in dims:
        kernel = torch.randn((in_dim, out), generator=gen, device=device) * (2.0 / in_dim) ** 0.5
        layers.append({"kernel": kernel, "bias": torch.zeros(out, device=device)})
        in_dim = out
    return layers


def _planted_table(gen, rows: int, dim: int, centroids: torch.Tensor, noise: float):
    table = torch.randn((rows, dim), generator=gen, device=centroids.device)
    table.mul_(noise)
    clusters = centroids.shape[0]
    for lo in range(0, rows, 1 << 22):  # bounded temporaries
        hi = min(rows, lo + (1 << 22))
        idx = torch.arange(lo, hi, device=centroids.device) % clusters
        table[lo:hi].add_(centroids[idx])
    return table.mul_(dim ** -0.5)


def make_params(spec: dict, seed: int, num_users: int, num_items: int, model: dict,
                device) -> dict:
    """Weights of ``spec``'s kind for ``model`` (``embedding_dim``,
    ``user_tower_dims``, ``item_tower_dims``) on ``device``."""
    gen = generator(seed, WEIGHTS, device)
    e = int(model["embedding_dim"])
    kind = spec.get("kind", "random")
    if kind == "random":
        params = {
            "user_embedding": torch.randn((padded_rows(num_users), e), generator=gen,
                                          device=device) * e ** -0.5,
            "item_embedding": torch.randn((padded_rows(num_items), e), generator=gen,
                                          device=device) * e ** -0.5,
        }
        params["user_tower"] = _tower(gen, e, list(model["user_tower_dims"]), device)
        params["item_tower"] = _tower(gen, e, list(model["item_tower_dims"]), device)
        return params
    if kind == "planted":
        if list(model["user_tower_dims"]) != list(model["item_tower_dims"]):
            raise ValueError("planted weights share one tower: the towers' widths must agree")
        centroids = torch.randn((int(spec["clusters"]), e), generator=gen, device=device)
        noise = float(spec["noise"])
        params = {
            "user_embedding": _planted_table(gen, padded_rows(num_users), e, centroids, noise),
            "item_embedding": _planted_table(gen, padded_rows(num_items), e, centroids, noise),
        }
        tower = _tower(gen, e, list(model["user_tower_dims"]), device)
        params["user_tower"] = tower
        params["item_tower"] = [{k: v.clone() for k, v in layer.items()} for layer in tower]
        return params
    raise ValueError(f"unknown weights kind {kind!r}")
