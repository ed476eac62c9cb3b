"""Exact Bayes-ceiling evaluation against a planted oracle teacher (PyTorch
port of ``twotower_tpu/evaluation/oracle.py``).

``data.synthetic_scale --oracle`` samples interactions from a KNOWN
stationary teacher,

    P(item = i | user = u)
        = [(1-noise) * softmax_c(scale * <u_lat[u], c_lat[c]> / sqrt(d))
           + noise * cluster_mass[c]]_{c(i)}  *  pop(i | c(i)),

whose Bayes-optimal ranker (sort items by P(i|u), i.e. by
``log p_u[c(i)] + log_pop[i]``) is computable in closed form. The teacher's
own Recall@K / NDCG@K on the held-out split IS the ceiling: no model can
beat it in expectation, so a trained student's metrics become a fraction
of optimal instead of a bare number.

Ranks are computed EXACTLY (no top-k truncation): for each held-out row
the rank of the true item is the count of items scoring strictly higher,
plus same-score items with a lower index (``lax.top_k``'s tie order, which
the port's evaluation keeps, so teacher and student tie semantics match).
Scoring runs on ``--device`` (``cuda`` unless ``--device cpu``), streaming
the item table in chunks sized from the device's free memory.

Two differences from the JAX module, neither of which changes a rank:
``plugin_ranks`` builds the fitted per-user mixture only for the users of
the evaluated rows (the JAX module's dense ``[num_users, C]`` float64
count is about 60 GB at the generator's default shape), and the CLI takes
the temporal split from ``--config/--override`` as ``evaluate-model`` does
(with neither, the default config's split, as the JAX CLI uses).

CLI::

    python -m twotower_tpu_torch.evaluation.oracle \\
        --teacher <gen_dir>/oracle_teacher.npz --prepared-dir <prep> \\
        --subset test [--rows 500000] [--plugin] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)

# Bytes a scored [batch, chunk] element costs (float32 score, the compare
# masks and the count), and the share of free memory a chunk may take.
_BYTES_PER_SCORE = 8
_CUDA_FREE_SHARE = 0.25
_CPU_CHUNK_BYTES = 256 << 20


class OracleTeacher:
    """Closed-form scorer for the planted teacher."""

    def __init__(self, npz_path: str | Path):
        with np.load(npz_path) as z:
            self.u_lat = z["u_lat"]
            self.c_lat = z["c_lat"]
            self.item_cluster = z["item_cluster"]
            self.log_pop = z["log_pop"]
            self.cluster_mass = z["cluster_mass"]
            self.affinity_scale = float(z["affinity_scale"])
            self.noise = float(z["noise"])
        self.num_users = self.u_lat.shape[0]
        self.num_items = self.item_cluster.shape[0]

    def log_p_clusters(self, user_idx: np.ndarray) -> np.ndarray:
        """``log P(cluster | user)`` for a batch of users -- [B, C] f32. The
        product and the softmax stay on the host in float32, as the JAX
        module computes them."""
        d = self.u_lat.shape[1]
        logits = (
            self.affinity_scale
            * (self.u_lat[user_idx] @ self.c_lat.T)
            / np.sqrt(np.float32(d))
        )
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        softmax = e / e.sum(axis=-1, keepdims=True)
        p = (1.0 - self.noise) * softmax + self.noise * self.cluster_mass[None, :]
        return np.log(p).astype(np.float32)

    def item_scores(self, user_idx: np.ndarray) -> np.ndarray:
        """Full ``log P(i|u)`` matrix [B, N] (small corpora / tests)."""
        logp = self.log_p_clusters(user_idx)
        return logp[:, self.item_cluster] + self.log_pop[None, :]


def exact_ranks(
    teacher: OracleTeacher,
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    *,
    batch_size: int = 4096,
    chunk: int | None = None,
    device=None,
) -> np.ndarray:
    """Exact 0-based rank of each row's true item under the teacher."""
    return _structured_ranks(
        teacher.log_p_clusters, teacher.item_cluster, teacher.log_pop,
        user_idx, item_idx, batch_size=batch_size, chunk=chunk, device=device,
    )


def plugin_ranks(
    teacher: OracleTeacher,
    train_user: np.ndarray,
    train_item: np.ndarray,
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    *,
    batch_size: int = 4096,
    chunk: int | None = None,
    mix_prior: float = 5.0,
    pop_prior: float = 0.1,
    device=None,
) -> np.ndarray:
    """Ranks under the PLUG-IN skyline: the teacher's own parametric
    family fitted to the (finite) train data instead of the true
    parameters -- empirical per-user cluster mixture and empirical
    within-cluster popularity, Dirichlet-smoothed toward the global law.

    The natural ``achievable-from-this-data`` yardstick between the
    exact-teacher ceiling (infinite-data optimum) and the student: the
    student/plug-in ratio isolates what the training stack loses, with the
    finite-sample gap (plug-in/teacher) reported separately. Not a formal
    bound -- a skyline.

    The per-user mixture is built for the users of ``user_idx`` only (their
    rows of the JAX module's dense ``[num_users, C]`` table, bit for bit).
    """
    C = teacher.c_lat.shape[0]
    n_items = teacher.num_items
    tr_cl = teacher.item_cluster[train_item]
    # global cluster mass and within-cluster item popularity from train
    cl_counts = np.bincount(tr_cl, minlength=C).astype(np.float64)
    global_mix = (cl_counts + 1.0) / (cl_counts + 1.0).sum()
    item_counts = np.bincount(train_item, minlength=n_items).astype(np.float64)
    pop = item_counts + pop_prior
    cluster_tot = np.bincount(
        teacher.item_cluster, weights=pop, minlength=C
    )
    log_pop_hat = np.log(pop / cluster_tot[teacher.item_cluster]).astype(
        np.float32
    )
    # per-user mixture of the evaluated users: counts over clusters,
    # smoothed toward global
    users = np.unique(user_idx)
    pos = np.minimum(np.searchsorted(users, train_user), len(users) - 1)
    seen = users[pos] == train_user
    key = pos[seen].astype(np.int64) * C + tr_cl[seen]
    uc = np.bincount(key, minlength=len(users) * C).astype(np.float64)
    uc = uc.reshape(len(users), C)
    mix = uc + mix_prior * global_mix[None, :]
    logp_users = np.log(mix / mix.sum(axis=1, keepdims=True)).astype(np.float32)

    def logp_fn(batch_users: np.ndarray) -> np.ndarray:
        return logp_users[np.searchsorted(users, batch_users)]

    return _structured_ranks(
        logp_fn, teacher.item_cluster, log_pop_hat,
        user_idx, item_idx, batch_size=batch_size, chunk=chunk, device=device,
    )


def _chunk_items(batch: int, n_items: int, device: torch.device) -> int:
    """Items scored at once for ``batch`` rows: a quarter of the card's free
    memory on CUDA, a fixed 256 MiB on the CPU."""
    if device.type == "cuda":
        budget = int(torch.cuda.mem_get_info(device)[0] * _CUDA_FREE_SHARE)
    else:
        budget = _CPU_CHUNK_BYTES
    return max(1, min(n_items, budget // (_BYTES_PER_SCORE * batch)))


def _structured_ranks(
    logp_fn,
    item_cluster_np: np.ndarray,
    log_pop_np: np.ndarray,
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    *,
    batch_size: int = 4096,
    chunk: int | None = None,
    device=None,
) -> np.ndarray:
    """Exact ranks for any ``score(u, i) = logp_u[c(i)] + log_pop[i]``
    scorer, on ``device`` (``cuda`` unless the caller asks for the CPU):
    a gather, a float32 add and compares, ``lax.top_k``'s tie order. Given
    the same ``logp`` the ranks equal the JAX module's exactly."""
    from twotower_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    item_cluster = torch.from_numpy(np.asarray(item_cluster_np, np.int64)).to(dev)
    log_pop = torch.from_numpy(np.asarray(log_pop_np, np.float32)).to(dev)
    n_items = item_cluster.shape[0]
    ranks = np.empty(len(user_idx), np.int32)
    for s in range(0, len(user_idx), batch_size):
        e = min(s + batch_size, len(user_idx))
        logp = torch.from_numpy(np.ascontiguousarray(logp_fn(user_idx[s:e]))).to(dev)
        ti = torch.from_numpy(np.asarray(item_idx[s:e], np.int64)).to(dev)
        true_score = (
            logp.gather(1, item_cluster[ti][:, None]).squeeze(1) + log_pop[ti]
        )[:, None]
        step = chunk or _chunk_items(e - s, n_items, dev)
        acc = torch.zeros(e - s, dtype=torch.int64, device=dev)
        for lo in range(0, n_items, step):
            hi = min(lo + step, n_items)
            scores = logp.index_select(1, item_cluster[lo:hi]) + log_pop[None, lo:hi]
            idx = torch.arange(lo, hi, device=dev)[None, :]
            ahead = (scores > true_score) | ((scores == true_score) & (idx < ti[:, None]))
            acc += ahead.sum(dim=1)
        ranks[s:e] = acc.cpu().numpy()
    return ranks


def metrics_from_ranks(
    rank: np.ndarray, ks: tuple[int, ...], *, mrr_cap: int | None = None
) -> dict[str, float]:
    """Same formulas as ``evaluation.metrics.metrics_at_k`` (including the
    max-K-truncated MRR) so teacher and student numbers are comparable."""
    rank = rank.astype(np.float64)
    out: dict[str, float] = {}
    gain = 1.0 / np.log2(rank + 2.0)
    for k in sorted(ks):
        hit = rank < k
        out[f"recall@{k}"] = float(hit.mean())
        out[f"ndcg@{k}"] = float((hit * gain).mean())
    cap = mrr_cap if mrr_cap is not None else max(ks)
    out["mrr"] = float(((rank < cap) / (rank + 1.0)).mean())
    return out


def _vocab_to_generator_idx(ids: np.ndarray, prefix: str) -> np.ndarray:
    """Map vocab id strings (``U00000042`` / ``I00000007``,
    ``synthetic_scale._id_table``) back to teacher row indices."""
    arr = np.asarray(ids, dtype=str)
    return np.char.lstrip(arr, prefix).astype(np.int64)


def strided(n: int, cap: int | None) -> np.ndarray:
    """Same rule as training.train.strided_subsample / evaluate --rows."""
    if cap is None or cap >= n:
        return np.arange(n)
    return np.linspace(0, n - 1, num=cap, dtype=np.int64)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m twotower_tpu_torch.evaluation.oracle",
        description="Exact Bayes-ceiling metrics of the planted teacher "
        "on a prepared artifact's held-out split",
    )
    ap.add_argument("--teacher", required=True,
                    help="oracle_teacher.npz from synthetic_scale --oracle")
    ap.add_argument("--prepared-dir", required=True)
    ap.add_argument("--config", type=str, default=None,
                    help="config whose preprocessing split fractions define "
                    "the held-out split (as evaluate-model's)")
    ap.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE")
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to rank on (default cuda; there is no fallback to the CPU)",
    )
    ap.add_argument("--subset", choices=["val", "test"], default="test")
    ap.add_argument("--rows", type=int, default=None,
                    help="strided subsample cap (full split if omitted)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument(
        "--ks", type=int, nargs="*", default=[1, 5, 10, 20, 50, 100]
    )
    ap.add_argument(
        "--plugin", action="store_true",
        help="also score the PLUG-IN skyline (teacher's parametric family "
        "fitted to the train split): the achievable-from-this-data "
        "yardstick between the exact-teacher ceiling and the student",
    )
    ap.add_argument("--out", type=str, default=None)
    return ap


def main(argv: list[str] | None = None) -> int:
    from twotower_tpu_torch.config import load_config, parse_cli_overrides
    from twotower_tpu_torch.data.prepared import PreparedDataset
    from twotower_tpu_torch.utils.platform import resolve_device

    setup_logging()
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)  # no GPU: raise before any work
    cfg = load_config(args.config, parse_cli_overrides(args.override))

    teacher = OracleTeacher(args.teacher)
    ds = PreparedDataset(args.prepared_dir)
    rule = ds.temporal_rule(
        cfg.preprocessing.train_split, cfg.preprocessing.val_split
    )
    subsets = (args.subset, "train") if args.plugin else (args.subset,)
    splits = ds.load_splits(rule, subsets)
    split = splits[args.subset]
    # Vocab indices -> teacher indices (the prepared artifact re-encodes
    # ids by first appearance; the teacher is indexed by generator id).
    user_map = _vocab_to_generator_idx(np.asarray(ds.vocab.users.ids), "U")
    item_map = _vocab_to_generator_idx(np.asarray(ds.vocab.items.ids), "I")
    sel = strided(len(split["user_idx"]), args.rows)
    gen_users = user_map[split["user_idx"][sel]]
    gen_items = item_map[split["item_idx"][sel]]
    logger.info(
        "oracle ceiling: %d %s rows (of %d), %d items",
        len(sel), args.subset, len(split["user_idx"]), teacher.num_items,
    )
    ranks = exact_ranks(teacher, gen_users, gen_items, batch_size=args.batch, device=device)
    metrics = metrics_from_ranks(ranks, tuple(args.ks))
    result = {
        "teacher": str(args.teacher),
        "subset": args.subset,
        "rows": int(len(sel)),
        "metrics": metrics,
        "median_rank": int(np.median(ranks)),
    }
    if args.plugin:
        train = splits["train"]
        p_ranks = plugin_ranks(
            teacher,
            user_map[train["user_idx"]],
            item_map[train["item_idx"]],
            gen_users,
            gen_items,
            batch_size=args.batch,
            device=device,
        )
        result["plugin_metrics"] = metrics_from_ranks(p_ranks, tuple(args.ks))
        result["plugin_median_rank"] = int(np.median(p_ranks))
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
