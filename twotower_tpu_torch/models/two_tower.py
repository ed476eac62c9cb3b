"""Two-tower retrieval model: embedding tables + dual MLP towers (PyTorch).

Counterpart of ``twotower_tpu/models/two_tower.py``. Parameters are a plain
dict in the JAX package's layout so that the bridge (``bridge.py``) and the
parity tests compare like with like::

    {"user_embedding": [U, E], "item_embedding": [I, E],
     "user_tower": [{"kernel": [in, out], "bias": [out]}, ...],
     "item_tower": [...], "text_embedding": [T, E] (model.text_buckets > 0)}

``kernel`` keeps JAX's ``[in, out]`` layout, so a layer is ``x @ kernel +
bias``. Master parameters are float32.

Compute dtype: with ``compute_dtype="bfloat16"`` each tower GEMM takes
bf16-rounded operands and accumulates in float32, returning float32 — the
semantics of the JAX ``dot_general(..., preferred_element_type=f32)``. A
plain bf16 ``torch.matmul`` would return bf16 and round the tower output, so
the operands are rounded to bf16 and multiplied as float32 (a product of two
bf16 values is exact in float32). The bias is added in float32, hidden
activations are rounded back to the compute dtype, and the last layer's
output stays float32.
"""

from __future__ import annotations

from typing import Any

import torch

from twotower_tpu_torch.config import ModelConfig

Params = dict[str, Any]

LANE = 128  # table rows are padded to this multiple, as in the JAX package


def padded_rows(n: int, multiple: int = LANE) -> int:
    """Table rows padded to a multiple with AT LEAST one spare row — the
    last padded row is the ``dead row`` scatter target that sparse updates
    aim duplicate/invalid ids at (training/sparse.py)."""
    return -(-(max(n, 1) + 1) // multiple) * multiple


def dead_row(table: torch.Tensor) -> int:
    """Index of the guaranteed-unused padding row (never a real id)."""
    return table.shape[0] - 1


def compute_dtype_of(config: ModelConfig) -> torch.dtype:
    return getattr(torch, config.compute_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_tower(
    gen: torch.Generator, in_dim: int, dims: list[int], device: torch.device
) -> list[Params]:
    """He-initialized MLP stack (relu hidden activations)."""
    layers = []
    for out_dim in dims:
        kernel = torch.randn(
            (in_dim, out_dim), generator=gen, device=device, dtype=torch.float32
        ) * (2.0 / in_dim) ** 0.5
        layers.append(
            {"kernel": kernel, "bias": torch.zeros(out_dim, device=device)}
        )
        in_dim = out_dim
    return layers


def init_params(
    gen: torch.Generator,
    config: ModelConfig,
    num_users: int,
    num_items: int,
    *,
    pad_multiple: int = LANE,
    text_embedding_init: Any = None,
) -> Params:
    """Build the parameter dict on ``gen.device`` (same shapes as the JAX
    package; the values differ, since torch and JAX draw different numbers
    from one seed — the bridge carries JAX's values across when a test
    needs them).

    With ``model.text_buckets > 0`` the dict also holds the hashed-text
    bucket table ``text_embedding`` (``[padded_rows(text_buckets), E]``,
    row 0 the PAD bucket), drawn after the towers, or
    ``text_embedding_init`` (that shape, e.g. pretrained word embeddings)
    in its place (JAX ``two_tower.py:100-114``)."""
    device = gen.device
    e = config.embedding_dim
    scale = e**-0.5

    def table(rows: int) -> torch.Tensor:
        return torch.randn(
            (padded_rows(rows, pad_multiple), e), generator=gen, device=device
        ) * scale

    params = {
        "user_embedding": table(num_users),
        "item_embedding": table(num_items),
        "user_tower": _init_tower(gen, e, list(config.user_tower_dims), device),
        "item_tower": _init_tower(gen, e, list(config.item_tower_dims), device),
    }
    if config.text_buckets > 0:
        rows = padded_rows(config.text_buckets, pad_multiple)
        if text_embedding_init is not None:
            init = torch.as_tensor(text_embedding_init, dtype=torch.float32).to(device)
            if tuple(init.shape) != (rows, e):
                raise ValueError(
                    f"text_embedding_init shape {tuple(init.shape)} != ({rows}, {e})"
                )
            params["text_embedding"] = init.clone()
        else:
            params["text_embedding"] = table(config.text_buckets)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to ``dtype`` and carry the value on in float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _apply_tower(
    layers: list[Params],
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype,
    dropout_rate: float,
    dropout_gen: torch.Generator | None,
) -> torch.Tensor:
    """MLP tower: relu between layers, linear output, inverted dropout."""
    x = _round(x.float(), compute_dtype)
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ _round(layer["kernel"], compute_dtype) + layer["bias"]
        if i < n - 1:
            x = torch.relu(x)
            if dropout_rate > 0.0 and dropout_gen is not None:
                keep = (
                    torch.rand(x.shape, generator=dropout_gen, device=x.device)
                    < 1.0 - dropout_rate
                )
                x = torch.where(keep, x / (1.0 - dropout_rate), 0.0)
            x = _round(x, compute_dtype)
    return x  # float32 out of the last layer


def _maybe_normalize(x: torch.Tensor, normalize: bool) -> torch.Tensor:
    if not normalize:
        return x
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def _apply(
    layers: list[Params],
    emb: torch.Tensor,
    config: ModelConfig,
    train: bool,
    dropout_gen: torch.Generator | None,
) -> torch.Tensor:
    out = _apply_tower(
        layers,
        emb,
        compute_dtype=compute_dtype_of(config),
        dropout_rate=config.dropout_rate if train else 0.0,
        dropout_gen=dropout_gen,
    )
    return _maybe_normalize(out, config.normalize_embeddings)


def apply_user_tower(
    params: Params,
    emb: torch.Tensor,
    config: ModelConfig,
    *,
    train: bool = False,
    dropout_gen: torch.Generator | None = None,
) -> torch.Tensor:
    """Query-tower MLP over pre-gathered embedding rows (the sparse-update
    training path differentiates w.r.t. ``emb`` directly)."""
    return _apply(params["user_tower"], emb, config, train, dropout_gen)


def apply_item_tower(
    params: Params,
    emb: torch.Tensor,
    config: ModelConfig,
    *,
    train: bool = False,
    dropout_gen: torch.Generator | None = None,
) -> torch.Tensor:
    """Candidate-tower MLP over pre-gathered rows."""
    return _apply(params["item_tower"], emb, config, train, dropout_gen)


def embed_users(
    params: Params,
    user_idx: torch.Tensor,
    config: ModelConfig,
    *,
    train: bool = False,
    dropout_gen: torch.Generator | None = None,
) -> torch.Tensor:
    """Query tower: table gather -> MLP -> optional L2 normalize."""
    return apply_user_tower(
        params, params["user_embedding"][user_idx], config,
        train=train, dropout_gen=dropout_gen,
    )


def pool_rows(tok_rows: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Masked-mean pool of pre-gathered token rows ``[B, T, E]`` (token 0 =
    PAD) -> ``[B, E]``: the one embedding-bag of ``pool_text`` and the
    sparse step (JAX ``two_tower.py:200-213``)."""
    mask = (tokens != 0).to(tok_rows.dtype)[..., None]
    total = torch.sum(tok_rows * mask, dim=1)
    count = torch.clamp(torch.sum(mask, dim=1), min=1.0)
    return total / count


def pool_text(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-bag over hashed n-gram tokens ``[B, T]`` -> ``[B, E]``."""
    return pool_rows(params["text_embedding"][tokens], tokens)


def embed_items(
    params: Params,
    item_idx: torch.Tensor,
    config: ModelConfig,
    *,
    train: bool = False,
    dropout_gen: torch.Generator | None = None,
    text_tokens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Candidate tower: table gather (+ the pooled text embedding of
    ``text_tokens``, ``[B, T]`` hashed n-gram ids aligned with
    ``item_idx``) -> MLP -> optional L2 normalize."""
    emb = params["item_embedding"][item_idx]
    if text_tokens is not None:
        if "text_embedding" not in params:
            raise ValueError("model has no text tower (set model.text_buckets > 0)")
        emb = emb + pool_text(params, text_tokens)
    return apply_item_tower(params, emb, config, train=train, dropout_gen=dropout_gen)


@torch.no_grad()
def embed_item_table(
    params: Params,
    config: ModelConfig,
    num_items: int,
    *,
    chunk_size: int = 65536,
    item_tokens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Materialize the item-corpus embedding matrix ``[num_items, D]`` by
    streaming the table through the candidate tower in chunks of rows (eval
    mode: no dropout) — the corpus encode pass of evaluation and index
    building. ``item_tokens``: optional per-item hashed text ``[num_items,
    T]`` on the params' device. Counterpart of the JAX ``embed_item_table``,
    which maps the tower over the whole padded table (its padding rows read
    a real item's tokens, then are sliced off); only the ``num_items`` real
    rows are encoded here, and each row's output does not depend on its
    chunk."""
    parts = []
    for start in range(0, num_items, chunk_size):
        idx = torch.arange(start, min(start + chunk_size, num_items),
                           device=params["item_embedding"].device)
        tokens = None if item_tokens is None else item_tokens[idx]
        parts.append(embed_items(params, idx, config, text_tokens=tokens))
    return torch.cat(parts)


def forward(
    params: Params,
    user_idx: torch.Tensor,
    item_idx: torch.Tensor,
    config: ModelConfig,
    *,
    train: bool = False,
    dropout_gen: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both towers for one batch -> (user_emb ``[B, D]``, item_emb ``[B, D]``).
    One generator feeds both towers' dropout masks in turn."""
    return (
        embed_users(params, user_idx, config, train=train, dropout_gen=dropout_gen),
        embed_items(params, item_idx, config, train=train, dropout_gen=dropout_gen),
    )
