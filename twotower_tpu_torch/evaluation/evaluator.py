"""Full-corpus retrieval evaluator (PyTorch).

Counterpart of ``twotower_tpu/evaluation/evaluator.py``: encode the whole
item corpus through the candidate tower once per evaluation (chunked, on the
device; with the item text tokens when the model has a text tower), then stream user batches through the query tower -> MIPS top-k ->
metrics. Exact mode (``retrieval.eval_exact``, the default) searches with
``ops.topk.topk_mips_twopass`` (float32 scores), so metrics are deterministic
up to tie order. Validation mode (``eval_exact=false``) keeps the corpus at
``retrieval.eval_corpus_dtype`` (float32 or bfloat16) and searches with the
serving search ``topk_mips_approx``, an exact top-k over the scores at that
precision, as the JAX package computes it off the TPU.

The metric sums stay on the device across batches and are read once at the
end (the counterpart of the JAX evaluator's single fetch after its
``lax.scan``). With ``mesh=`` the encoded corpus stays row-sharded over
``model`` and the queries split over ``data`` (``parallel/spmd.py``); the
parameters are the rank's shard in the layout ``TrainState.for_config(
mesh=)`` gives them. The JAX evaluator's time-budgeted scan segments guard a
watchdog of its TPU transport and have no counterpart here:
``retrieval.eval_device_scan`` and ``retrieval.eval_scan_budget_s`` are
accepted and change nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.evaluation.metrics import metrics_at_k
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.ops.topk import exact_scan_chunk, topk_mips_approx, topk_mips_twopass
from twotower_tpu_torch.utils.platform import resolve_device

logger = get_logger(__name__)


class Evaluator:
    """Recall@K / NDCG@K / MRR over the full item corpus."""

    @staticmethod
    def auto_chunk_size(num_items: int, batch_size: int) -> int:
        """Corpus-stream chunk for the exact search: ``exact_scan_chunk``
        (power of two, 2 GB score budget, 131072 cap), CLAMPED to the corpus
        size rounded up to the 64-row two-pass block, so a small corpus is
        not padded to a 131072-row chunk."""
        chunk = exact_scan_chunk(batch_size)
        if num_items < chunk:
            chunk = max(64, -(-num_items // 64) * 64)
        return chunk

    def __init__(
        self,
        config: Config,
        num_items: int,
        *,
        batch_size: int = 4096,
        corpus_chunk_size: int | None = None,
        item_tokens=None,
        mesh=None,
        device: str | torch.device | None = None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # The item text tokens ([num_items, T]) of a model with a text tower,
        # resident on the device for the corpus encode.
        self.item_tokens = (
            None if item_tokens is None else torch.as_tensor(item_tokens).to(self.device)
        )
        self.config = config
        self.num_items = num_items
        self.ks = tuple(sorted(config.retrieval.top_k_eval))
        self.max_k = min(max(self.ks), num_items)
        self.batch_size = batch_size
        self.exact = config.retrieval.eval_exact
        # Explicit chunks round down to the two-pass block multiple, as the
        # search itself does; the chunk bounds the [batch, chunk] scores.
        self.corpus_chunk_size = (
            max(64, corpus_chunk_size // 64 * 64)
            if corpus_chunk_size is not None
            else self.auto_chunk_size(num_items, batch_size)
        )
        self._ks_used = tuple(k for k in self.ks if k <= self.max_k) or (self.max_k,)
        if mesh is not None:
            from twotower_tpu_torch.parallel.sharding import StateSharding
            from twotower_tpu_torch.parallel.sparse_spmd import use_sparse_mesh_path
            from twotower_tpu_torch.parallel.spmd import make_sharded_eval_step

            if batch_size % mesh.num_data:
                raise ValueError(f"eval batch_size={batch_size} must divide by "
                                 f"num_data={mesh.num_data}")
            self._sharded = make_sharded_eval_step(
                config, mesh, num_items, self.max_k, item_tokens=self.item_tokens,
                sharding=StateSharding(mesh, use_sparse_mesh_path(config)))

    def _encode_corpus(self, params) -> torch.Tensor:
        """The corpus ``[num_items, D]`` at ``retrieval.eval_corpus_dtype``,
        encoded once per evaluation. Not padded: the JAX evaluator pads the
        exact corpus to the chunk multiple once so that its search need not
        pad a copy on every batch; the port's searches read slices of the
        corpus and never copy it, and padding rows would only add columns to
        the score product."""
        emb = two_tower.embed_item_table(params, self.config.model, self.num_items,
                                         item_tokens=self.item_tokens)
        return emb.to(getattr(torch, self.config.retrieval.eval_corpus_dtype))

    @torch.no_grad()
    def evaluate(
        self,
        params,
        user_idx: np.ndarray,
        item_idx: np.ndarray,
    ) -> dict[str, float]:
        """Single-positive protocol: for each (user, held-out item) row, rank
        the full corpus for the user and score where the item lands."""
        if self.mesh is not None:
            return self._evaluate_sharded(params, user_idx, item_idx)
        mcfg = self.config.model
        corpus = self._encode_corpus(params)
        users = torch.as_tensor(np.asarray(user_idx, np.int64)).to(self.device)
        items = torch.as_tensor(np.asarray(item_idx, np.int64)).to(self.device)
        keys = (
            [f"recall@{k}" for k in self._ks_used]
            + [f"ndcg@{k}" for k in self._ks_used]
            + ["mrr"]
        )
        sums = torch.zeros(len(keys), device=self.device)
        n = len(users)
        for start in range(0, n, self.batch_size):
            bu = users[start : start + self.batch_size]
            bi = items[start : start + self.batch_size]
            user_emb = two_tower.embed_users(params, bu, mcfg, train=False)
            if self.exact:
                _, topk_idx = topk_mips_twopass(
                    user_emb, corpus, self.max_k, chunk_size=self.corpus_chunk_size
                )
            else:
                _, topk_idx = topk_mips_approx(user_emb, corpus, self.max_k)
            m = metrics_at_k(topk_idx, bi, self._ks_used)
            # metrics_at_k returns means over the batch's rows; times the row
            # count they are sums.
            sums += torch.stack([m[k] for k in keys]) * len(bu)
        host = sums.tolist()  # the one device-to-host read
        out = {k: v / max(n, 1e-12) for k, v in zip(keys, host)} if n else {}
        logger.info(
            "evaluated %d rows over %d items: %s",
            n, self.num_items, {k: round(v, 4) for k, v in sorted(out.items())},
        )
        return out

    def _evaluate_sharded(self, params, user_idx, item_idx) -> dict[str, float]:
        """The mesh path (``parallel.spmd.make_sharded_eval_step``): every rank
        passes the same split; each data shard scores its rows of each
        batch (padded to the batch with zero-weight rows) against the
        corpus shards of its model group, and the sums are all-reduced over
        ``data`` once, so every rank returns the same metrics."""
        from twotower_tpu_torch.parallel.spmd import eval_keys

        mesh = self.mesh
        encode, eval_batch = self._sharded
        full, corpus = encode(params)
        bs, per = self.batch_size, self.batch_size // mesh.num_data
        lo = mesh.d_idx * per
        keys = eval_keys(self.config, self.max_k)
        sums = torch.zeros(len(keys) + 1, device=self.device)
        n = len(user_idx)
        for start in range(0, n, bs):
            rows = np.zeros((3, bs), np.int64)
            real = min(bs, n - start)
            rows[0, :real] = user_idx[start:start + real]
            rows[1, :real] = item_idx[start:start + real]
            rows[2, :real] = 1
            u, it, w = torch.as_tensor(rows[:, lo:lo + per]).to(self.device)
            sums += eval_batch(full, corpus, u, it, w.float())
        host = mesh.data.all_reduce(sums).tolist()
        out = {k: v / max(host[-1], 1.0) for k, v in zip(keys, host)} if n else {}
        logger.info(
            "evaluated %d rows over %d items (mesh %dx%d, corpus shard %d rows): %s",
            n, self.num_items, mesh.num_data, mesh.num_model, corpus.shape[0],
            {k: round(v, 4) for k, v in sorted(out.items())},
        )
        return out

    def make_evaluate_fn(self, user_idx: np.ndarray, item_idx: np.ndarray):
        """Bind an eval split for the Trainer's ``evaluate_fn`` hook."""

        def fn(params) -> dict[str, float]:
            return self.evaluate(params, user_idx, item_idx)

        return fn
