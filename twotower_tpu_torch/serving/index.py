"""Retrieval index: the serving-side candidate search (PyTorch).

Counterpart of ``twotower_tpu/serving/index.py``. The item corpus is
encoded once through the candidate tower (with each item's text tokens
when the model has a text tower), padded once to its search's layout
(``exact_padded_rows`` / ``ann_padded_rows``; padding rows are never
scored) and kept resident in the precision ``serving.corpus_dtype``
resolves to: float32 under ``tpu_mips_exact``, and bfloat16 (the default),
int8 or int8_rowscale under ``tpu_mips``.

Search: ``tpu_mips_exact`` is the evaluation's two-pass exact search
(``topk_mips_twopass``, float32-accurate: float32 products with TF32 off on
the CPU, the float32 prefilter's three TF32 passes on the card), so served
results equal the evaluation's bit for bit. Every other ``index_type`` (``cpu_flat``
included, as in the JAX index) takes ``topk_mips_approx``, which on this
device is an exact top-k over the scores at the corpus's resident
precision: the JAX default's ``lax.approx_max_k`` is a TPU primitive that
the JAX package itself computes as an exact top-k off the TPU.

``mesh``: a list of devices, which may repeat (``["cuda:0"] * 4``), over
which one process shards the index for catalogs past one card's memory
(JAX's 1-D serving mesh over ``jax.devices()``, single-controller as
here). The corpus is cut in equal shards in JAX's layout: each of
``ceil(N / S)`` rows padded to its search's layout, the padding one global
tail past ``num_items``. The embedding tables are row-sharded the same way,
so each shard encodes its own corpus rows on its own device, and the towers
are copied to each device. A query searches every shard on its device and
merges the shards' ``[B, k]`` candidates exactly on the first device
(``ops.topk``'s sharded searches in their one-process form); user rows and
corpus rows are gathered from the shards that own them. An int8 corpus
takes its global scale over every shard, so its ids equal the
single-device index's.
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
    corpus_scale,
    exact_padded_rows,
    quantize_corpus,
    topk_mips_approx,
    topk_mips_approx_sharded,
    topk_mips_sharded,
    topk_mips_twopass,
)
from twotower_tpu_torch.utils import profiling
from twotower_tpu_torch.utils.platform import resolve_device

logger = get_logger(__name__)

TOWERS = ("user_tower", "item_tower")


def _row_shards(table: torch.Tensor, rows: int, devices: list) -> list[torch.Tensor]:
    """``table`` cut in shards of ``rows`` rows (the last may be shorter or
    empty), shard ``s`` on ``devices[s]``."""
    return [table[s * rows:(s + 1) * rows].to(dev) for s, dev in enumerate(devices)]


def _gather_rows(shards: list[torch.Tensor], rows: int, ids: torch.Tensor,
                 device: torch.device, read=None) -> torch.Tensor:
    """``table[ids]`` of a table held in row shards of ``rows`` rows, on
    ``device``: each id's row read from the shard that owns it, by
    ``read(s, local_ids)`` (default: shard ``s``'s rows as stored)."""
    if read is None:
        def read(s, local):
            return shards[s][local]
    flat = ids.reshape(-1)
    out = None
    owner = torch.div(flat, rows, rounding_mode="floor")
    for s, shard in enumerate(shards):
        sel = torch.nonzero(owner == s).squeeze(1)
        got = read(s, (flat[sel] - s * rows).to(shard.device)).to(device)
        if out is None:
            out = got.new_empty((flat.shape[0], got.shape[1]))
        out[sel] = got
    return out.view(*ids.shape, -1)


def refuse_sequence_tower(config: Config, checkpoint_dir) -> None:
    """Serving takes user ids: a checkpoint of a sequence user tower
    (``model.user_tower: sequence``), which embeds a user from their recent
    items, is refused by name."""
    if config.model.user_tower == "sequence":
        raise ValueError(
            f"{checkpoint_dir} holds a sequence user tower (model.user_tower=sequence): "
            "serving a sequence-tower checkpoint is not supported (it embeds users from "
            "their histories, which /recommend does not take)")


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
            if device is not None:
                raise ValueError("pass the devices of a sharded index as mesh=, not device=")
            self.devices = [resolve_device(d) for d in mesh]
            if not self.devices:
                raise ValueError("mesh= names no device")
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]  # where queries run and shards merge
        self.mesh = None if mesh is None else list(self.devices)
        self.config = config
        self.num_users = num_users
        self.num_items = num_items
        self.checkpoint_step: int | None = None  # set by from_checkpoint
        resolved = config.serving.resolve_corpus_dtype()
        self.quantized = resolved.startswith("int8")
        self.per_row = resolved == "int8_rowscale"
        self.exact = config.serving.index_type == "tpu_mips_exact"
        with torch.no_grad():
            if self.mesh is None:
                self.params = params
                padded = self._build_single(params, item_tokens, resolved)
            else:
                self.params = None  # row-sharded: self._user_shards, self._towers
                padded = self._build_sharded(params, item_tokens, resolved)
        logger.info(
            "retrieval index ready: %d items (%d padded rows) x %d dims (%s) on %s%s",
            num_items, padded, self.dim, resolved, self.device,
            "" if self.mesh is None else
            f", {len(self.devices)}-way sharded over {[str(d) for d in self.devices]}",
        )

    def _build_single(self, params, item_tokens, resolved: str) -> int:
        padded = (exact_padded_rows(self.num_items) if self.exact
                  else ann_padded_rows(self.num_items))
        tokens = None if item_tokens is None else torch.as_tensor(item_tokens).to(self.device)
        emb = two_tower.embed_item_table(params, self.config.model, self.num_items,
                                         item_tokens=tokens)
        if padded != self.num_items:
            emb = F.pad(emb, (0, 0, 0, padded - self.num_items))
        if self.quantized:
            self.corpus, self.corpus_scale = quantize_corpus(emb, per_row=self.per_row)
        else:
            self.corpus, self.corpus_scale = emb.to(getattr(torch, resolved)), None
        self.dim = self.corpus.shape[1]
        return padded

    def _build_sharded(self, params, item_tokens, resolved: str) -> int:
        """Each shard's corpus rows encoded on its device from its own item
        table rows (text rows gathered from their owners), padded, cast or
        quantized; the user table row-sharded; the towers on every
        device."""
        n_shards, mcfg = len(self.devices), self.config.model
        local = -(-self.num_items // n_shards)
        self.shard_rows = exact_padded_rows(local) if self.exact else ann_padded_rows(local)
        self._towers = {}
        for dev in self.devices:
            if dev not in self._towers:
                self._towers[dev] = {k: [{n: t.to(dev) for n, t in layer.items()}
                                         for layer in params[k]] for k in TOWERS}
        self._user_rows = -(-params["user_embedding"].shape[0] // n_shards)
        self._user_shards = _row_shards(params["user_embedding"], self._user_rows,
                                        self.devices)
        text_rows = text_shards = None
        if item_tokens is not None:
            if "text_embedding" not in params:
                raise ValueError("model has no text tower (set model.text_buckets > 0)")
            text_rows = -(-params["text_embedding"].shape[0] // n_shards)
            text_shards = _row_shards(params["text_embedding"], text_rows, self.devices)
            item_tokens = torch.as_tensor(item_tokens)
        parts = []
        for s, dev in enumerate(self.devices):
            lo = s * self.shard_rows
            hi = max(lo, min(lo + self.shard_rows, self.num_items))
            emb = torch.zeros((self.shard_rows, list(mcfg.item_tower_dims)[-1]), device=dev)
            # embed_item_table's chunks of 65536 rows, cut at the shard's edges
            for start in sorted({lo, *range(-(-lo // 65536) * 65536, hi, 65536)} - {hi}):
                end = min(start // 65536 * 65536 + 65536, hi)
                rows = params["item_embedding"][start:end].to(dev)
                if text_shards is not None:
                    tokens = item_tokens[start:end].to(dev)
                    rows = rows + two_tower.pool_rows(
                        _gather_rows(text_shards, text_rows, tokens, dev), tokens)
                emb[start - lo:end - lo] = two_tower.apply_item_tower(
                    self._towers[dev], rows, mcfg, train=False)
            parts.append(emb)
        del text_shards
        if self.quantized:
            scale = None if self.per_row else corpus_scale(parts)
            q = [quantize_corpus(x, per_row=self.per_row, scale=scale) for x in parts]
            self.corpus = [c for c, _ in q]
            self.corpus_scale = [sc for _, sc in q] if self.per_row else scale
        else:
            self.corpus = [x.to(getattr(torch, resolved)) for x in parts]
            self.corpus_scale = None
        del parts
        self.dim = self.corpus[0].shape[1]
        return self.shard_rows * n_shards

    # ------------------------------------------------------------------

    def _search(self, emb: torch.Tensor, k: int):
        recall = self.config.serving.recall_target
        if self.mesh is not None:
            if self.exact:
                return topk_mips_sharded(emb, self.corpus, k, num_items=self.num_items)
            return topk_mips_approx_sharded(emb, self.corpus, k, recall_target=recall,
                                            num_items=self.num_items,
                                            item_scale_shard=self.corpus_scale)
        if self.exact:
            return topk_mips_twopass(emb, self.corpus, k, num_valid=self.num_items)
        return topk_mips_approx(
            emb, self.corpus, k, recall_target=recall,
            num_valid=self.num_items, item_scale=self.corpus_scale,
        )

    def _rows(self, item_idx: torch.Tensor) -> torch.Tensor:
        """Corpus rows as float32 on the query device, dequantized for an
        int8 corpus (read from the shards that own them when sharded)."""
        if self.mesh is None:
            return self._dequantized(self.corpus, self.corpus_scale, item_idx)

        def read(s, local):
            scale = self.corpus_scale[s] if self.per_row else self.corpus_scale
            return self._dequantized(self.corpus[s], scale, local)

        return _gather_rows(self.corpus, self.shard_rows, item_idx, self.device, read)

    def _dequantized(self, corpus, scale, idx: torch.Tensor) -> torch.Tensor:
        rows = corpus[idx].float()
        if self.quantized:
            scale = scale.to(rows.device)
            rows = rows * (scale[idx][..., None] if scale.dim() else scale)
        return rows

    def _user_embeddings(self, user_idx: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return two_tower.embed_users(self.params, user_idx, self.config.model)
        rows = _gather_rows(self._user_shards, self._user_rows, user_idx, self.device)
        return two_tower.apply_user_tower(self._towers[self.device], rows, self.config.model)

    def _host(self, vals: torch.Tensor, idx: torch.Tensor):
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array).to(self.device)

    @torch.no_grad()
    def recommend(self, user_idx: np.ndarray, k: int = 100) -> tuple[np.ndarray, np.ndarray]:
        """Top-k items for known users: (scores [B,k], item_idx [B,k]).

        Traced (``utils/profiling.py``), four spans tile the call:
        ``index.h2d`` (the ids checked and copied to the device),
        ``index.user_tower`` and ``index.search`` (their launches) and
        ``index.d2h`` (the wait for the device and the copy back)."""
        with profiling.span("index.h2d"):
            user_idx = np.atleast_1d(np.asarray(user_idx, np.int64))
            if (user_idx < 0).any() or (user_idx >= self.num_users).any():
                raise ValueError("user_idx out of range")
            ids = self._tensor(user_idx)
        with profiling.span("index.user_tower"):
            emb = self._user_embeddings(ids)
        with profiling.span("index.search"):
            found = self._search(emb, k)
        with profiling.span("index.d2h"):
            return self._host(*found)

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
        with torch.no_grad():  # in slices: a sharded corpus never sits whole on a card
            corpus = np.concatenate([
                self._rows(torch.arange(lo, min(lo + (1 << 20), self.num_items),
                                        device=self.device)).cpu().numpy()
                for lo in range(0, self.num_items, 1 << 20)]) if self.num_items else \
                np.zeros((0, self.dim), np.float32)
        np.savez_compressed(path, corpus=corpus)
        logger.info("exported corpus embeddings -> %s", path)

    @classmethod
    def from_checkpoint(
        cls, config: Config, checkpoint_dir: str | Path, mesh=None,
        step: int | None = None, device: str | torch.device | None = None,
    ) -> "RetrievalIndex":
        """Load params and vocab (and ``item_tokens.npz``, the item text
        tokens of a model with a text tower) from a ``train-model``
        checkpoint directory; with ``mesh``, a sharded index over its devices.

        ``step``: a specific checkpoint step (default: the best-metric step,
        as ``evaluate-model`` restores). The step is recorded as
        ``index.checkpoint_step``, which the service reports as the live
        model version (and hot-reloads past, ``RecommendService.reload``)."""
        from twotower_tpu_torch.data.vocab import VocabPair
        from twotower_tpu_torch.evaluation.evaluate import load_item_tokens, restore_params

        refuse_sequence_tower(config, checkpoint_dir)
        if mesh is None:
            device = resolve_device(device)  # no GPU: raise before any work
        else:  # restored to host memory, then each row shard placed on its device
            for d in mesh:
                resolve_device(d)

        ckpt_dir = Path(checkpoint_dir)
        vocab = VocabPair.load(ckpt_dir / "vocab")
        num_users, num_items = len(vocab.users), len(vocab.items)
        params, meta = restore_params(
            config, ckpt_dir, num_users, num_items, step=step,
            device=device if mesh is None else "cpu",
        )
        index = cls(config, params, num_users, num_items,
                    item_tokens=load_item_tokens(ckpt_dir), mesh=mesh, device=device)
        index.vocab = vocab
        index.checkpoint_step = meta.get("step")
        return index
