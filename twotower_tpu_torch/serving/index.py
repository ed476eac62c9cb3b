"""Retrieval index: the serving-side candidate search (PyTorch).

Counterpart of ``twotower_tpu/serving/index.py`` on one device. The item
corpus is encoded once through the candidate tower (with each item's text
tokens when the model has a text tower), padded once to its
search's layout (``exact_padded_rows`` / ``ann_padded_rows``; padding rows
are never scored) and kept resident in the precision
``serving.corpus_dtype`` resolves to: float32 under ``tpu_mips_exact``, and
bfloat16 (the default), int8 or int8_rowscale under ``tpu_mips``.

Search: ``tpu_mips_exact`` is the evaluation's two-pass exact search
(``topk_mips_twopass``, float32, TF32 off), so served results equal the
evaluation's bit for bit. Every other ``index_type`` (``cpu_flat``
included, as in the JAX index) takes ``topk_mips_approx``, which on this
device is an exact top-k over the scores at the corpus's resident
precision: the JAX default's ``lax.approx_max_k`` is a TPU primitive that
the JAX package itself computes as an exact top-k off the TPU.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.ops.topk import (
    ann_padded_rows,
    exact_padded_rows,
    quantize_corpus,
    topk_mips_approx,
    topk_mips_twopass,
)
from twotower_tpu_torch.utils.platform import resolve_device

logger = get_logger(__name__)


class RetrievalIndex:
    """User/query -> top-k item retrieval over a frozen model.

    Id-based queries (known users), embedding queries (cold start, external
    towers), history-pooled queries and item-to-item similarity. Tensors
    live on ``device`` (``cuda`` unless the caller asks for the CPU);
    results come back as numpy, one ``[B, k]`` copy to the host a call.
    """

    def __init__(
        self, config: Config, params, num_users: int, num_items: int,
        item_tokens=None, mesh=None, device: str | torch.device | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded serving corpus is not ported yet "
                "(ROADMAP.md, Queue 1: Sharded serving and the scaling tools)"
            )
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.num_users = num_users
        self.num_items = num_items
        self.checkpoint_step: int | None = None  # set by from_checkpoint
        resolved = config.serving.resolve_corpus_dtype()
        self.quantized = resolved.startswith("int8")
        self.exact = config.serving.index_type == "tpu_mips_exact"
        padded = exact_padded_rows(num_items) if self.exact else ann_padded_rows(num_items)
        tokens = None if item_tokens is None else torch.as_tensor(item_tokens).to(self.device)
        with torch.no_grad():
            emb = two_tower.embed_item_table(params, config.model, num_items,
                                             item_tokens=tokens)
            if padded != num_items:
                emb = F.pad(emb, (0, 0, 0, padded - num_items))
            if self.quantized:
                self.corpus, self.corpus_scale = quantize_corpus(
                    emb, per_row=resolved == "int8_rowscale")
            else:
                self.corpus, self.corpus_scale = emb.to(getattr(torch, resolved)), None
        del emb, tokens
        logger.info(
            "retrieval index ready: %d items (%d padded rows) x %d dims (%s) on %s",
            num_items, padded, self.corpus.shape[1], resolved, self.device,
        )

    # ------------------------------------------------------------------

    def _search(self, emb: torch.Tensor, k: int):
        if self.exact:
            return topk_mips_twopass(emb, self.corpus, k, num_valid=self.num_items)
        return topk_mips_approx(
            emb, self.corpus, k, recall_target=self.config.serving.recall_target,
            num_valid=self.num_items, item_scale=self.corpus_scale,
        )

    def _rows(self, item_idx: torch.Tensor) -> torch.Tensor:
        """Corpus rows as float32, dequantized for an int8 corpus."""
        rows = self.corpus[item_idx].float()
        if self.quantized:
            scale = self.corpus_scale
            rows = rows * (scale[item_idx][..., None] if scale.dim() else scale)
        return rows

    def _host(self, vals: torch.Tensor, idx: torch.Tensor):
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array).to(self.device)

    @torch.no_grad()
    def recommend(self, user_idx: np.ndarray, k: int = 100) -> tuple[np.ndarray, np.ndarray]:
        """Top-k items for known users: (scores [B,k], item_idx [B,k])."""
        user_idx = np.atleast_1d(np.asarray(user_idx, np.int64))
        if (user_idx < 0).any() or (user_idx >= self.num_users).any():
            raise ValueError("user_idx out of range")
        emb = two_tower.embed_users(self.params, self._tensor(user_idx), self.config.model)
        return self._host(*self._search(emb, k))

    @torch.no_grad()
    def recommend_by_history(
        self, hist_idx: np.ndarray, k: int = 100
    ) -> tuple[np.ndarray, np.ndarray]:
        """Cold-start retrieval from interaction history (no user id).

        ``hist_idx``: ``[B, W]`` item indices padded with ``-1``; each row's
        valid items are mean-pooled in the (dequantized) corpus embedding
        space and re-normalized. Rows must hold at least one valid item (the
        service layer validates)."""
        hist = np.atleast_2d(np.asarray(hist_idx, np.int64))
        if hist.ndim != 2:
            raise ValueError("hist_idx must be [B, W]")
        if (hist >= self.num_items).any():
            raise ValueError("history item_idx out of range")
        hist = self._tensor(hist)
        mask = (hist >= 0).float()[..., None]
        rows = self._rows(hist.clamp(min=0))
        pooled = (rows * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return self._host(*self._search(pooled / norm.clamp(min=1e-12), k))

    @torch.no_grad()
    def recommend_by_embedding(self, emb: np.ndarray, k: int = 100):
        """Top-k for externally computed query embeddings [B, D]."""
        return self._host(*self._search(self._tensor(np.asarray(emb, np.float32)), k))

    @torch.no_grad()
    def similar_items(self, item_idx: np.ndarray, k: int = 100):
        """Item-to-item neighbours (self-match removed): searches k+1 and
        drops each row's own id, or its last id where the item itself did
        not surface (a reduced-precision corpus can rank it lower)."""
        item_idx = np.atleast_1d(np.asarray(item_idx, np.int64))
        if (item_idx < 0).any() or (item_idx >= self.num_items).any():
            raise ValueError("item_idx out of range")
        # The query rows are the (dequantized) corpus rows; an int8 search
        # re-quantizes them per row.
        vals, idx = self._host(*self._search(self._rows(self._tensor(item_idx)), k + 1))
        keep = idx != item_idx[:, None]
        keep[keep.all(axis=1), -1] = False  # an id appears at most once a row
        n = len(item_idx)
        return vals[keep].reshape(n, k), idx[keep].reshape(n, k)

    # ------------------------------------------------------------------

    def export_corpus(self, path: str | Path) -> None:
        """Persist the corpus embeddings (npz, float32, dequantized)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with torch.no_grad():
            corpus = self._rows(torch.arange(self.num_items, device=self.device))
        np.savez_compressed(path, corpus=corpus.cpu().numpy())
        logger.info("exported corpus embeddings -> %s", path)

    @classmethod
    def from_checkpoint(
        cls, config: Config, checkpoint_dir: str | Path, mesh=None,
        step: int | None = None, device: str | torch.device | None = None,
    ) -> "RetrievalIndex":
        """Load params and vocab (and ``item_tokens.npz``, the item text
        tokens of a model with a text tower) from a ``train-model``
        checkpoint directory.

        ``step``: a specific checkpoint step (default: the best-metric step,
        as ``evaluate-model`` restores). The step is recorded as
        ``index.checkpoint_step``, which the service reports as the live
        model version (and hot-reloads past, ``RecommendService.reload``)."""
        from twotower_tpu_torch.data.vocab import VocabPair
        from twotower_tpu_torch.evaluation.evaluate import restore_params

        device = resolve_device(device)  # no GPU: raise before any work
        from twotower_tpu_torch.evaluation.evaluate import load_item_tokens

        ckpt_dir = Path(checkpoint_dir)
        vocab = VocabPair.load(ckpt_dir / "vocab")
        num_users, num_items = len(vocab.users), len(vocab.items)
        params, meta = restore_params(
            config, ckpt_dir, num_users, num_items, step=step, device=device
        )
        index = cls(config, params, num_users, num_items,
                    item_tokens=load_item_tokens(ckpt_dir), mesh=mesh, device=device)
        index.vocab = vocab
        index.checkpoint_step = meta.get("step")
        return index
