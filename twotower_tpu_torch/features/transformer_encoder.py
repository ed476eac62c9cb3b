"""Transformer text encoder: HF tokenizer ids and a pretrained-embedding init
(the port's counterpart of ``twotower_tpu/features/transformer_encoder.py``).

The transformer stays off the train step's hot path, as in the JAX package:

- ``encode`` / ``encode_per_item``: a WordPiece/BPE tokenizer gives the same
  static-shape ``[N, max_tokens]`` int32 contract as the hashed n-gram
  encoder (ids shifted +1 so that 0 stays the PAD bucket), so the towers'
  masked-mean text pooling, evaluation's corpus encode and serving take
  it unchanged.
- ``word_embedding_init``: the checkpoint's word-embedding matrix,
  PCA-projected to ``embedding_dim`` and RMS-matched to the random init's
  scale, as the text table's initial value (``init_train_state(
  text_embedding_init=)``). The same numpy computation as the JAX package,
  so the same matrix gives the same table bit for bit.
- ``encode_vectors``: the whole model's masked-mean pooled last hidden
  state in fixed-shape batches on the GPU (the CPU only when asked for by
  name), for offline similarity artifacts and cold-start items.

The tokenizer and model load from local directories only
(``local_files_only=True``). ``transformers`` is imported only when
``model_path`` has to be loaded: a tokenizer and a model handed in through
``tokenizer=`` and ``model=`` need no ``transformers`` at all. ``model=`` is
any ``nn.Module`` called as ``model(input_ids=, attention_mask=)`` that
returns the last hidden state first (``BertModel``, ``AutoModel``, or a
stand-in built from ``torch.nn``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from twotower_tpu_torch.features.text_encoder import PAD_ID, select_first_item_texts
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.ops.precision import float32_products

logger = get_logger(__name__)


class TransformerTextEncoder:
    """HF-tokenizer text -> fixed-shape token ids (and the model behind it).

    Emits the hashed encoder's output contract: ``[N, max_tokens]`` int32,
    token 0 = PAD. Real token ids are shifted +1 (``num_buckets`` = the
    tokenizer's vocabulary + 1), so id 0 stays the mask sentinel whatever id
    the tokenizer's own pad token has.
    """

    def __init__(
        self,
        model_path: str | None = None,
        *,
        tokenizer: Any = None,
        model: Any = None,
        max_tokens: int = 32,
    ):
        if tokenizer is None:
            if not model_path:
                raise ValueError("TransformerTextEncoder needs model_path or tokenizer")
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        self.tokenizer = tokenizer
        self.max_tokens = int(max_tokens)
        self.model_path = model_path
        self._model = model

    @property
    def num_buckets(self) -> int:
        """Text-table rows: the tokenizer's vocabulary plus the shifted-in PAD
        bucket 0. ``len(tokenizer)`` (not ``vocab_size``), so added special
        tokens count."""
        return len(self.tokenizer) + 1

    # -- token encoding (the training path's contract) ---------------------

    def encode(self, texts: np.ndarray) -> np.ndarray:
        """``[N]`` text column -> ``[N, max_tokens]`` int32, PAD = 0. Whole
        texts are deduplicated first and the distinct set tokenized once."""
        norm = np.array(["" if t is None else str(t) for t in texts], dtype=object)
        uniq, inverse = np.unique(norm, return_inverse=True)
        out_u = np.full((len(uniq), self.max_tokens), PAD_ID, np.int32)
        nonempty = [i for i, t in enumerate(uniq.tolist()) if t]
        if nonempty:
            enc = self.tokenizer(
                [str(uniq[i]) for i in nonempty],
                truncation=True,
                max_length=self.max_tokens,
                padding="max_length",
                return_attention_mask=True,
            )
            ids = np.asarray(enc["input_ids"], np.int64)
            mask = np.asarray(enc["attention_mask"], np.int64)
            out_u[nonempty] = ((ids + 1) * mask).astype(np.int32)
        return out_u[inverse.reshape(norm.shape)]

    def encode_per_item(
        self,
        item_idx: np.ndarray,
        texts: np.ndarray | None,
        num_items: int,
        titles: np.ndarray | None = None,
    ) -> np.ndarray:
        """Per-item token table ``[num_items, max_tokens]``: the hashed
        encoder's first-non-empty-occurrence selection (title preferred,
        ``select_first_item_texts``), then one tokenizer pass over the
        distinct item texts."""
        table = np.full((num_items, self.max_tokens), PAD_ID, np.int32)
        items, item_texts = select_first_item_texts(item_idx, texts, num_items, titles)
        if len(items):
            table[items] = self.encode(np.array(item_texts, dtype=object))
        return table

    # -- pretrained weights ------------------------------------------------

    def _require_model(self) -> Any:
        if self._model is None:
            if not self.model_path:
                raise ValueError("no model given and no model_path to load one from")
            from transformers import AutoModel

            self._model = AutoModel.from_pretrained(self.model_path, local_files_only=True)
        return self._model

    def _word_embeddings(self) -> np.ndarray:
        """The checkpoint's input word-embedding matrix ``[V, H]``, float32.

        Found structurally: a 2-D parameter whose leading dimension is
        ``len(tokenizer)`` (preferred: a checkpoint resized for added tokens)
        or the base ``vocab_size``; among ties, names containing
        "embed"/"wte" win. No per-architecture map.
        """
        model = self._require_model()
        sizes = (len(self.tokenizer), self.tokenizer.vocab_size)
        hits = [
            (name.lower(), param)
            for name, param in model.named_parameters()
            if param.ndim == 2 and param.shape[0] in sizes
        ]
        if not hits:
            raise ValueError(
                f"no [vocab in {set(sizes)}, H] embedding among the model's parameters"
            )
        # Prefer the resized (len(tokenizer)) match, then embed-like names.
        hits.sort(
            key=lambda h: (h[1].shape[0] != sizes[0], not ("embed" in h[0] or "wte" in h[0]))
        )
        name, param = hits[0]
        logger.info("word embeddings from %s: %s", name, tuple(param.shape))
        return param.detach().float().cpu().numpy()

    def word_embedding_init(
        self, embedding_dim: int, *, pad_multiple: int | None = None
    ) -> np.ndarray:
        """Text-table init ``[padded_rows(num_buckets), embedding_dim]`` from
        the pretrained word embeddings.

        ``H -> embedding_dim`` by PCA (the top principal directions of the
        centred matrix) when H exceeds it, zero padding otherwise; rows are
        RMS-matched to the random init's ``1/sqrt(E)`` scale. Row 0 (PAD) and
        the rows past the matched vocabulary stay zero. ``pad_multiple``
        defaults to the table layout's own ``two_tower.LANE``.
        """
        from twotower_tpu_torch.models.two_tower import LANE, padded_rows

        if pad_multiple is None:
            pad_multiple = LANE

        emb = self._word_embeddings()
        v, h = emb.shape
        e = int(embedding_dim)
        centered = emb - emb.mean(axis=0, keepdims=True)
        if h > e:
            # Eigendecomposition of the [H, H] covariance: the same principal
            # directions as an SVD of [V, H], for less work.
            cov = centered.T @ centered
            _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
            proj = centered @ vecs[:, ::-1][:, :e]
        elif h < e:
            proj = np.concatenate([centered, np.zeros((v, e - h), np.float32)], axis=1)
        else:
            proj = centered
        rms = float(np.sqrt(np.mean(np.square(proj)))) or 1.0
        proj = proj * ((1.0 / np.sqrt(e)) / rms)
        table = np.zeros((padded_rows(self.num_buckets, pad_multiple), e), np.float32)
        # +1: the id shift that keeps 0 = PAD. v is the matched matrix's row
        # count, so every pretrained row lands in the table.
        table[1 : v + 1] = proj
        return table

    # -- the whole model's contextual vectors (offline) ---------------------

    def encode_vectors(
        self, texts: np.ndarray, *, batch_size: int = 128, device: str | torch.device | None = None
    ) -> np.ndarray:
        """Masked-mean pooled last-hidden-state vectors ``[N, H]`` float32.

        Runs the whole model on ``device`` (``None``: the GPU, through
        ``resolve_device``; a model loaded from ``model_path`` or handed in
        elsewhere is moved there first, in place) in fixed-shape batches
        (the tail batch padded and sliced off), in eval mode (as a Flax
        model's default deterministic call), under ``torch.inference_mode()``
        with TF32 off for the float32 products (``float32_products()``).
        """
        from twotower_tpu_torch.utils.platform import resolve_device

        device = resolve_device(device)
        model = self._require_model().to(device)
        norm = ["" if t is None else str(t) for t in texts]
        n = len(norm)
        if n == 0:
            # A stable trailing dimension for empty input, from the model's
            # config (hidden_size, or n_embd for GPT-style configs).
            cfg = getattr(model, "config", None)
            hidden = int(getattr(cfg, "hidden_size", None) or getattr(cfg, "n_embd", 0) or 0)
            return np.zeros((0, hidden), np.float32)
        enc = self.tokenizer(
            norm,
            truncation=True,
            max_length=self.max_tokens,
            padding="max_length",
            return_attention_mask=True,
        )
        ids = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc["attention_mask"], np.int64)
        # Empty texts still tokenize to [CLS][SEP]-style frames; their
        # vectors are defined (special-token context).
        was_training = model.training
        model.eval()
        outs = []
        try:
            with torch.inference_mode(), float32_products():
                for start in range(0, n, batch_size):
                    ids_b = ids[start : start + batch_size]
                    mask_b = mask[start : start + batch_size]
                    live = len(ids_b)
                    if live < batch_size:
                        # All-PAD rows: the clamped denominator keeps them finite.
                        ids_b = np.pad(ids_b, ((0, batch_size - live), (0, 0)))
                        mask_b = np.pad(mask_b, ((0, batch_size - live), (0, 0)))
                    ids_t = torch.from_numpy(ids_b).to(device)
                    mask_t = torch.from_numpy(mask_b).to(device)
                    hidden = model(input_ids=ids_t, attention_mask=mask_t)[0]
                    m = mask_t.to(hidden.dtype)[:, :, None]
                    pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
                    outs.append(pooled[:live].float().cpu().numpy())
        finally:
            model.train(was_training)
        return np.concatenate(outs, axis=0)


def build_text_encoder(model_cfg: Any) -> Any:
    """The config's text encoder: ``None`` when the text tower is off, a
    ``HashedNgramEncoder`` for ``text_encoder='hashed'`` with ``text_buckets
    > 0``, or a ``TransformerTextEncoder`` for ``'transformer'`` (its buckets
    come from the tokenizer: callers resolve ``model.text_buckets`` to
    ``encoder.num_buckets``, see ``training/train.py``)."""
    if model_cfg.text_encoder == "transformer":
        return TransformerTextEncoder(model_cfg.text_model_path, max_tokens=model_cfg.text_tokens)
    if model_cfg.text_buckets > 0:
        from twotower_tpu_torch.features.text_encoder import HashedNgramEncoder

        return HashedNgramEncoder(
            num_buckets=model_cfg.text_buckets, max_tokens=model_cfg.text_tokens
        )
    return None
