"""Out-of-core synthetic corpus generator for full-scale lifecycle runs
(PyTorch port's copy of ``twotower_tpu/data/synthetic_scale.py``).

``python -m twotower_tpu_torch.data.synthetic_scale --output-dir DIR
[--oracle] [--device {cuda,cpu} | --no-device]``

The corpus is calibrated to the shape of 5-core Amazon review exports:
power-law item popularity, a growing catalog, temporal popularity drift,
and 5-core-surviving user/item frequency.

- **Streams straight to parquet shards** in bounded chunks: peak host RAM
  is O(chunk + num_items), never O(num_interactions). Id strings are built
  once as pyarrow tables and gathered per chunk (``pc.take``).
- **Cluster latent-factor model**: items belong to one of ``num_clusters``
  taste clusters; a user draws a cluster from the softmax of their latent
  affinity over cluster centroids (O(C) per row, not O(num_items)), then an
  item within the cluster from a rank-power-law.
- **Temporal drift**: timestamps increase monotonically across the corpus;
  the catalog grows linearly from ``catalog_start_frac`` to 1.0, and
  within-cluster popularity ranks rotate by ``drift_ranks_per_era`` every
  era, so the head of the distribution moves between the temporal-split
  train and test windows.
- **Oracle mode** (``--oracle``): a stationary teacher whose exact
  ``P(item | user)`` is known; its parameters are written beside the shards
  as ``oracle_teacher.npz`` for ``evaluation/oracle.py``.

Cluster sampler: below ``num_interactions * num_clusters < 2**31`` (and
always with ``--no-device``) the numpy sampler runs, and a seed gives the
same parquet rows and teacher arrays as the JAX package's numpy path, bit
for bit. At or past it the gumbel-argmax runs on ``device`` (``cuda``
unless the caller asks for the CPU) with a ``torch.Generator`` seeded from
``seed``; its stream differs from the JAX package's threefry by design, as
``data/synthetic.py``'s draw does past 2^28 cells, while the distribution
is the same. A failing device sampler raises: there is no fallback.

Distribution calibration (why the defaults look like 5-core Amazon):

- interactions/user ~ Poisson(rows/users): at the 50M/2.5M default, mean 20
  -- essentially every user survives a 5-core filter.
- interactions/item: mean ``rows/items`` (~42 at default), with a
  within-cluster rank^-0.8 power law -- max/min weight ratio ~170 inside a
  cluster, so tail items still expect >=6 draws and mostly survive 5-core
  while the global head is strongly skewed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)


class ClusterCatalog:
    """Static item-side state: cluster assignment, launch order, popularity.

    Items are dealt to clusters contiguously with Dirichlet-perturbed sizes
    (clusters are unequal, like real categories). Within a cluster, the item
    at *launch position* p is the p-th to become available; its popularity
    rank at era e is ``(p + e * drift) % alive`` — early items dominate early
    eras and drift down as the catalog grows and ranks rotate.
    """

    def __init__(
        self,
        num_items: int,
        num_clusters: int,
        rng: np.random.Generator,
        within_zipf: float = 0.8,
    ):
        self.num_items = int(num_items)
        self.num_clusters = int(num_clusters)
        self.within_zipf = float(within_zipf)
        sizes = rng.dirichlet(np.full(num_clusters, 8.0))
        counts = np.maximum(1, np.round(sizes * num_items).astype(np.int64))
        # exact-sum repair: trim/pad the largest clusters
        diff = counts.sum() - num_items
        order = np.argsort(-counts)
        i = 0
        while diff != 0:
            c = order[i % num_clusters]
            step = -1 if diff > 0 else 1
            if counts[c] + step >= 1:
                counts[c] += step
                diff += step
            i += 1
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        # global item ids are a fixed random permutation so cluster id and
        # item id are uncorrelated (vocab order leaks nothing)
        self.item_of_slot = rng.permutation(num_items).astype(np.int64)

    def cluster_sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def alive_counts(self, catalog_frac: float) -> np.ndarray:
        """Per-cluster number of launched items at a catalog fraction."""
        sizes = self.cluster_sizes()
        return np.maximum(1, np.ceil(sizes * catalog_frac).astype(np.int64))

    def static_log_pop(self) -> tuple[np.ndarray, np.ndarray]:
        """Oracle-mode item law: with a full catalog and zero drift, item
        at launch position p of cluster c has within-cluster probability
        ``(p+1)^-zipf / Z_c`` forever. Returns ``(item_cluster [N] int32,
        log_pop [N] f32)`` — the exact ``log P(i | c(i))`` table the oracle
        evaluator scores with."""
        item_cluster = np.empty(self.num_items, np.int32)
        log_pop = np.empty(self.num_items, np.float32)
        for c in range(self.num_clusters):
            lo = int(self.offsets[c])
            n = int(self.offsets[c + 1] - lo)
            slots = self.item_of_slot[lo : lo + n]
            w = (np.arange(1, n + 1, dtype=np.float64)) ** (-self.within_zipf)
            lp = np.log(w) - np.log(w.sum())
            item_cluster[slots] = c
            log_pop[slots] = lp.astype(np.float32)
        return item_cluster, log_pop

    def sample_items(
        self,
        clusters: np.ndarray,
        catalog_frac: float,
        era: int,
        drift_ranks_per_era: int,
        rng: np.random.Generator,
    ) -> np.ndarray:
        """Vectorized within-cluster popularity draw for a chunk of rows.

        Rows are grouped by cluster (one argsort), then each occupied
        cluster does a single cdf-inverse categorical draw over its alive
        slots with era-rotated rank weights.
        """
        alive = self.alive_counts(catalog_frac)
        order = np.argsort(clusters, kind="stable")
        sorted_cl = clusters[order]
        bounds = np.searchsorted(sorted_cl, np.arange(self.num_clusters + 1))
        out_sorted = np.empty(len(clusters), np.int64)
        # rank weights are shared across clusters up to truncation: build the
        # longest needed table once per chunk
        max_alive = int(alive.max())
        base_w = (np.arange(1, max_alive + 1, dtype=np.float64)) ** (
            -self.within_zipf
        )
        for c in np.flatnonzero(np.diff(bounds) > 0):
            lo, hi = bounds[c], bounds[c + 1]
            n_alive = int(alive[c])
            # popularity rank of launch-position p at this era
            rot = (era * drift_ranks_per_era) % n_alive
            ranks = (np.arange(n_alive) + rot) % n_alive
            w = base_w[ranks]
            cdf = np.cumsum(w)
            cdf /= cdf[-1]
            u = rng.random(hi - lo)
            pos = np.searchsorted(cdf, u, side="right")
            out_sorted[lo:hi] = self.item_of_slot[self.offsets[c] + pos]
        out = np.empty_like(out_sorted)
        out[order] = out_sorted
        return out


def _cluster_choice_np(
    u_lat: np.ndarray,
    c_lat: np.ndarray,
    users: np.ndarray,
    affinity_scale: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Host gumbel-argmax over [rows, C] cluster logits, sub-chunked."""
    d = u_lat.shape[1]
    out = np.empty(len(users), np.int64)
    sub = 131_072
    for s in range(0, len(users), sub):
        e = min(s + sub, len(users))
        logits = (
            np.float32(affinity_scale)
            * (u_lat[users[s:e]] @ c_lat.T)
            / np.float32(np.sqrt(d))
        )
        g = -np.log(-np.log(rng.random(logits.shape, dtype=np.float32) + 1e-12) + 1e-12)
        out[s:e] = np.argmax(logits + g, axis=1)
    return out


class _ClusterChoiceTorch:
    """Device gumbel-argmax: the [sub, C] logits live on ``device``, only
    the winning cluster ids come home. Same distribution as the numpy path,
    from its own stream (a ``torch.Generator`` seeded from ``seed``)."""

    def __init__(self, u_lat, c_lat, affinity_scale, seed, device):
        self.sub = 131_072
        self._u = torch.from_numpy(u_lat).to(device)
        self._c = torch.from_numpy(c_lat).to(device)
        self._scale = float(affinity_scale)
        self._sqrt_d = float(np.sqrt(np.float32(u_lat.shape[1])))
        self._gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, users: np.ndarray) -> np.ndarray:
        out = np.empty(len(users), np.int64)
        for s in range(0, len(users), self.sub):
            e = min(s + self.sub, len(users))
            uu = torch.from_numpy(users[s:e]).to(self._u.device)
            logits = self._scale * (self._u[uu] @ self._c.T) / self._sqrt_d
            # argmax(logits + Gumbel) with Gumbel = -log(Exp(1)).
            expo = torch.empty_like(logits).exponential_(generator=self._gen)
            out[s:e] = (logits - expo.log()).argmax(dim=1).cpu().numpy()
        return out


def _id_table(prefix: str, count: int):
    """One pyarrow string array ``{prefix}{00000000+i}`` built in slices."""
    import pyarrow as pa
    import pyarrow.compute as pc

    parts = []
    for s in range(0, count, 4_000_000):
        e = min(s + 4_000_000, count)
        ints = pa.array(np.arange(s, e, dtype=np.int64))
        padded = pc.utf8_lpad(pc.cast(ints, pa.string()), 8, "0")
        prefixes = pa.array(np.full(e - s, prefix), type=pa.string())
        parts.append(pc.binary_join_element_wise(prefixes, padded, ""))
    return pa.concat_arrays(parts)


def generate_parquet(
    out_dir: str | Path,
    num_interactions: int = 50_000_000,
    num_users: int = 2_500_000,
    num_items: int = 1_200_000,
    num_clusters: int = 2048,
    latent_dim: int = 16,
    affinity_scale: float = 4.0,
    noise: float = 0.3,
    within_zipf: float = 0.8,
    catalog_start_frac: float = 0.6,
    num_eras: int = 12,
    drift_ranks_per_era: int = 3,
    chunk_rows: int = 1_000_000,
    rows_per_file: int = 5_000_000,
    seed: int = 42,
    base_ts: int = 1_600_000_000,
    span_seconds: int = 3 * 365 * 86400,
    use_device: bool | None = None,
    oracle: bool = False,
    device=None,
) -> dict:
    """Write ``interactions_{k:04d}.parquet`` shards under ``out_dir``.

    Output schema matches the prepare-data input contract
    (``schema.REQUIRED_COLUMNS``): user_id, parent_asin, rating, timestamp.
    Timestamps are globally non-decreasing (chunk k covers the k-th slice of
    the time range), so the corpus is naturally in temporal order like the
    reference's timestamp-sorted 5-core exports. Deterministic for a fixed
    seed and chunk_rows. Returns a stats dict (also written as
    ``generator_stats.json``).

    ``use_device``: True runs the cluster sampler on ``device`` (``cuda``
    unless the caller asks for the CPU), False the numpy one; None (the
    default) chooses the device past ``num_interactions * num_clusters >=
    2**31`` (see the module docstring).
    """
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    if use_device is None:
        # device path pays off once the per-chunk matmul is nontrivial
        use_device = num_interactions * num_clusters >= 1 << 31
    if use_device:
        from twotower_tpu_torch.utils.platform import resolve_device

        device = resolve_device(device)  # no GPU: raise before any work
    t0 = time.time()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if oracle:
        # Oracle mode: a STATIONARY teacher whose exact
        # conditional P(item | user) is computable in closed form —
        # P(i|u) = [(1-noise)*softmax_c(scale*u.c/sqrt(d)) +
        # noise*cluster_mass][c(i)] * pop(i|c(i)). Catalog growth and
        # popularity drift are disabled (they would make the Bayes ranker
        # era-dependent); the teacher's parameters are written next to the
        # shards so evaluation/oracle.py can score the exact ceiling.
        catalog_start_frac, num_eras, drift_ranks_per_era = 1.0, 1, 0
    rng = np.random.default_rng(seed)
    u_lat = rng.normal(size=(num_users, latent_dim)).astype(np.float32)
    c_lat = rng.normal(size=(num_clusters, latent_dim)).astype(np.float32)
    catalog = ClusterCatalog(num_items, num_clusters, rng, within_zipf)
    if oracle:
        item_cluster, log_pop = catalog.static_log_pop()
        np.savez_compressed(
            out_dir / "oracle_teacher.npz",
            u_lat=u_lat,
            c_lat=c_lat,
            item_cluster=item_cluster,
            log_pop=log_pop,
            cluster_mass=(
                catalog.cluster_sizes().astype(np.float64) / num_items
            ).astype(np.float32),
            affinity_scale=np.float32(affinity_scale),
            noise=np.float32(noise),
            latent_dim=np.int32(latent_dim),
            seed=np.int64(seed),
        )

    pick_cluster = None
    if use_device:
        pick_cluster = _ClusterChoiceTorch(u_lat, c_lat, affinity_scale, seed, device)
    user_table = _id_table("U", num_users)
    item_table = _id_table("I", num_items)

    schema_pa = pa.schema(
        [
            ("user_id", pa.string()),
            ("parent_asin", pa.string()),
            ("rating", pa.float32()),
            ("timestamp", pa.int64()),
        ]
    )
    n_chunks = -(-num_interactions // chunk_rows)
    writer = None
    file_idx = 0
    rows_in_file = 0
    files: list[str] = []
    item_touch = np.zeros(num_items, bool)
    rating_sum = 0.0

    def open_writer():
        nonlocal writer, file_idx, rows_in_file
        path = out_dir / f"interactions_{file_idx:04d}.parquet"
        writer = pq.ParquetWriter(path, schema_pa, compression="snappy")
        files.append(path.name)
        file_idx += 1
        rows_in_file = 0

    try:
        for k in range(n_chunks):
            rows = min(chunk_rows, num_interactions - k * chunk_rows)
            frac_t = (k + 0.5) / n_chunks  # chunk midpoint in [0, 1)
            era = min(num_eras - 1, int(frac_t * num_eras))
            catalog_frac = catalog_start_frac + (1.0 - catalog_start_frac) * frac_t

            users = rng.integers(0, num_users, size=rows)
            if pick_cluster is not None:
                aff_cl = pick_cluster(users)
            else:
                aff_cl = _cluster_choice_np(u_lat, c_lat, users, affinity_scale, rng)
            # popularity-noise mixture: with prob `noise` the row ignores the
            # user's taste and draws a cluster by cluster mass (global
            # popularity), keeping the marginal item law power-law-shaped
            pop_cl = rng.choice(
                num_clusters,
                size=rows,
                p=catalog.cluster_sizes() / num_items,
            )
            use_pop = rng.random(rows) < noise
            clusters = np.where(use_pop, pop_cl, aff_cl)
            items = catalog.sample_items(
                clusters, catalog_frac, era, drift_ranks_per_era, rng
            )
            item_touch[items] = True

            affinity = (
                np.einsum("nd,nd->n", u_lat[users], c_lat[clusters])
                / np.sqrt(np.float32(latent_dim))
            )
            rating = np.clip(
                np.round(3.0 + affinity + 0.5 * rng.normal(size=rows)), 1, 5
            ).astype(np.float32)
            lo = base_ts + int(span_seconds * k / n_chunks)
            hi = base_ts + int(span_seconds * (k + 1) / n_chunks)
            timestamp = np.sort(rng.integers(lo, hi, size=rows)).astype(np.int64)
            rating_sum += float(rating.sum())

            table = pa.Table.from_arrays(
                [
                    pc.take(user_table, pa.array(users)),
                    pc.take(item_table, pa.array(items)),
                    pa.array(rating),
                    pa.array(timestamp),
                ],
                schema=schema_pa,
            )
            if writer is None or rows_in_file >= rows_per_file:
                if writer is not None:
                    writer.close()
                open_writer()
            writer.write_table(table)
            rows_in_file += rows
            if (k + 1) % 5 == 0 or k + 1 == n_chunks:
                logger.info(
                    "generated %d/%d chunks (%.0f rows/s)",
                    k + 1,
                    n_chunks,
                    (k + 1) * chunk_rows / (time.time() - t0),
                )
    finally:
        if writer is not None:
            writer.close()

    stats = {
        "num_interactions": int(num_interactions),
        "num_users": int(num_users),
        "num_items": int(num_items),
        "items_touched": int(item_touch.sum()),
        "num_clusters": int(num_clusters),
        "rating_mean": rating_sum / num_interactions,
        "files": files,
        "seconds": round(time.time() - t0, 1),
        "params": {
            "affinity_scale": affinity_scale,
            "noise": noise,
            "within_zipf": within_zipf,
            "catalog_start_frac": catalog_start_frac,
            "num_eras": num_eras,
            "drift_ranks_per_era": drift_ranks_per_era,
            "seed": seed,
            "oracle": oracle,
        },
    }
    (out_dir / "generator_stats.json").write_text(json.dumps(stats, indent=2))
    logger.info(
        "synthetic corpus: %d rows, %d/%d items touched, %.1fs",
        num_interactions, stats["items_touched"], num_items, stats["seconds"],
    )
    return stats


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m twotower_tpu_torch.data.synthetic_scale",
        description="Generate a large synthetic interaction corpus as parquet shards",
    )
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--interactions", type=int, default=50_000_000)
    p.add_argument("--users", type=int, default=2_500_000)
    p.add_argument("--items", type=int, default=1_200_000)
    p.add_argument("--clusters", type=int, default=2048)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--affinity-scale", type=float, default=4.0)
    p.add_argument("--noise", type=float, default=0.3)
    p.add_argument(
        "--within-zipf", type=float, default=0.8,
        help="within-cluster popularity exponent; oracle-parity corpora "
        "use flatter values (0.5) to keep duplicate (user,item) pairs "
        "rare — dedupe-keep-latest on a resampling teacher otherwise "
        "distorts the law the ceiling is computed for",
    )
    p.add_argument("--chunk-rows", type=int, default=1_000_000)
    p.add_argument("--rows-per-file", type=int, default=5_000_000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-device", action="store_true",
                   help="force the numpy cluster sampler")
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the cluster sampler runs past the size rule (default "
        "cuda; there is no fallback to the CPU)",
    )
    p.add_argument(
        "--oracle", action="store_true",
        help="stationary teacher mode: disable catalog growth/drift and "
        "write oracle_teacher.npz (exact Bayes-ceiling parameters) next "
        "to the shards — see evaluation/oracle.py",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    from twotower_tpu_torch.utils.platform import resolve_device

    setup_logging()
    args = build_argparser().parse_args(argv)
    if not args.no_device:
        resolve_device(args.device)  # no GPU: raise before any work
    stats = generate_parquet(
        args.output_dir,
        num_interactions=args.interactions,
        num_users=args.users,
        num_items=args.items,
        num_clusters=args.clusters,
        latent_dim=args.latent_dim,
        affinity_scale=args.affinity_scale,
        noise=args.noise,
        within_zipf=args.within_zipf,
        chunk_rows=args.chunk_rows,
        rows_per_file=args.rows_per_file,
        seed=args.seed,
        use_device=False if args.no_device else None,
        oracle=args.oracle,
        device=args.device,
    )
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
