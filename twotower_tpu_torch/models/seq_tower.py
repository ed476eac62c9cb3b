"""Sequence user tower: DeepSeek-V2's decoder layers over each user's packed
interaction history (``model.user_tower: sequence``).

A user is the items they interacted with, in time order. Each input slot is
one such item, read from the item table (``item_embedding``) and projected
from the table's width to ``hidden_size``; the layers are DeepSeek-V2's
(arXiv:2405.04434): pre-norm blocks of multi-head latent attention (MLA,
no query compression) and a feed-forward, each wrapped in a residual. The
first ``first_k_dense_replace`` feed-forwards are dense SwiGLUs; every
other one is a mixture of experts: a softmax router over
``n_routed_experts`` SwiGLU experts, greedy top-``num_experts_per_tok``
with the chosen scores as gates (the published ``norm_topk_prob`` false
and ``routed_scaling_factor`` 1), plus ``n_shared_experts`` experts' width
of an always-on SwiGLU. Every slot's output goes through a final RMSNorm and a
projection to the item tower's width, then is L2-normalized: the user's
state after that item, scored against the next item.

Packed streams: a step's slots are many users' windows laid end to end,
``pos`` giving each slot's place in its window (0 at a window's start).
Attention is causal within a window and never reaches into another; RoPE
positions restart at each window. A window holds at most ``max_window``
slots, so a query's keys lie in its own block of ``max_window`` slots or
the one before (``ops/attention.py``: one kernel of the blocks' scores,
mask, softmax and values on the card, forward and backward).

Each attention and feed-forward block keeps only its input for the backward
and runs again there (activation recomputation).

Routing is dropless: every slot reaches all its experts at any imbalance.
The slots are sorted by expert into one buffer of static size (each
expert's rows padded to a multiple of ``ALIGN``) and the experts' products
run as grouped GEMMs (``torch._grouped_mm``) over it.

Precision: with ``compute_dtype`` bfloat16 every product takes bfloat16
operands (the float32 master weights cast each step) and accumulates in
float32 on the tensor cores, returning bfloat16, except attention's scores:
they stay float32 from their product through the mask and the softmax, and
are not rounded to bfloat16 (the probabilities are, for their product with
the values). Norms, softmaxes, RoPE and the router run in float32, and the
residual stream is float32. With float32 everything is float32 (the CPU
tests' setting).

The balance loss is DeepSeek-V2's expert-level one, per user window:
``alpha * sum_i f_i P_i`` with ``f_i = N / (K T) * sum_t 1(t routes to i)``
and ``P_i = 1 / T * sum_t s_i,t`` over the window's ``T`` slots, averaged
over the windows.

Departures from the published model are listed in
``reference/seq_tower.py``.

Parameters (``params["seq_tower"]``), linear weights ``[out, in]``::

    {"in_proj": [H, E], "norm": [H], "out_proj": [D, H],
     "layers": [{"attn_norm": [H], "ffn_norm": [H],
                 "attn": {"q": [h (dn + dr), H], "kv_a": [r + dr, H],
                          "kv_norm": [r], "kv_b": [h (dn + dv), r],
                          "o": [H, h dv]},
                 # a dense layer
                 "mlp": {"gate_up": [2 F, H], "down": [H, F]},
                 # a mixture-of-experts layer
                 "router": [N, H],
                 "experts": {"gate_up": [N, 2 I, H], "down": [N, H, I]},
                 "shared": {"gate_up": [2 S I, H], "down": [H, S I]}}, ...]}
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from twotower_tpu_torch.ops.attention import stream_attention
from twotower_tpu_torch.utils import profiling

ALIGN = 16  # rows of each expert's group in the sorted buffer: a multiple of this
INIT_STD = 0.02  # DeepSeek-V2's initializer_range


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) * INIT_STD


def init_params(gen: torch.Generator, config) -> dict:
    """The tower's float32 weights, drawn on ``gen.device`` from ``gen``:
    linear weights ``N(0, 0.02^2)``, norm weights one."""
    s = config.sequence
    dev = gen.device
    h, nh = s.hidden_size, s.num_attention_heads
    dn, dr, dv, r = s.qk_nope_head_dim, s.qk_rope_head_dim, s.v_head_dim, s.kv_lora_rank
    layers = []
    for i in range(s.num_hidden_layers):
        layer = {
            "attn_norm": torch.ones(h, device=dev),
            "attn": {"q": _normal(gen, (nh * (dn + dr), h), dev),
                     "kv_a": _normal(gen, (r + dr, h), dev),
                     "kv_norm": torch.ones(r, device=dev),
                     "kv_b": _normal(gen, (nh * (dn + dv), r), dev),
                     "o": _normal(gen, (h, nh * dv), dev)},
            "ffn_norm": torch.ones(h, device=dev),
        }
        if i < s.first_k_dense_replace:
            f = s.intermediate_size
            layer["mlp"] = {"gate_up": _normal(gen, (2 * f, h), dev),
                            "down": _normal(gen, (h, f), dev)}
        else:
            n, f = s.n_routed_experts, s.moe_intermediate_size
            layer["router"] = _normal(gen, (n, h), dev)
            layer["experts"] = {"gate_up": _normal(gen, (n, 2 * f, h), dev),
                                "down": _normal(gen, (n, h, f), dev)}
            if s.n_shared_experts:
                fs = f * s.n_shared_experts
                layer["shared"] = {"gate_up": _normal(gen, (2 * fs, h), dev),
                                   "down": _normal(gen, (h, fs), dev)}
        layers.append(layer)
    return {"in_proj": _normal(gen, (h, config.embedding_dim), dev), "layers": layers,
            "norm": torch.ones(h, device=dev),
            "out_proj": _normal(gen, (config.output_dim, h), dev)}


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1.0 else 1.0


def softmax_scale(s) -> float:
    """DeepSeek's: ``(dn + dr) ** -0.5``, times ``mscale(factor,
    mscale_all_dim) ** 2`` under YaRN (the local ``transformers`` port's
    attention takes a different factor; DeepSeek's own code is followed)."""
    scale = (s.qk_nope_head_dim + s.qk_rope_head_dim) ** -0.5
    rs = s.rope_scaling or {}
    if rs and float(rs.get("mscale_all_dim", 0.0)):
        m = _yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale *= m * m
    return scale


def rope_tables(s, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)``, float32 ``[max_window, qk_rope_head_dim]``: DeepSeek's
    YaRN rotary embedding (``DeepseekV2YarnRotaryEmbedding``) at the
    positions a window can hold, in the half-split layout."""
    dim, base = s.qk_rope_head_dim, float(s.rope_theta)
    half = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** half)
    rs = s.rope_scaling or {}
    mscale = 1.0
    if rs:
        factor = float(rs["factor"])
        orig = float(rs["original_max_position_embeddings"])

        def correction_dim(rotations: float) -> float:
            return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

        low = max(math.floor(correction_dim(float(rs["beta_fast"]))), 0)
        high = min(math.ceil(correction_dim(float(rs["beta_slow"]))), dim - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                           / (high - low), 0.0, 1.0)
        extra = 1.0 - ramp
        inv_freq = freq_extra / factor * (1.0 - extra) + freq_extra * extra
        mscale = (_yarn_mscale(factor, float(rs.get("mscale", 1.0)))
                  / _yarn_mscale(factor, float(rs.get("mscale_all_dim", 0.0))))
    else:
        inv_freq = freq_extra
    t = torch.arange(s.max_window, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 (returns float32)."""
    xf = x.float()
    return weight * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps))


def _lin(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(cd), w.to(cd))


def _swiglu(x: torch.Tensor, p: dict, cd: torch.dtype) -> torch.Tensor:
    g, u = _lin(x, p["gate_up"], cd).chunk(2, dim=-1)
    return _lin(F.silu(g) * u, p["down"], cd)


def attention(p: dict, x: torch.Tensor, ctx: "_Stream") -> torch.Tensor:
    """MLA over the stream (``x``: the normed input ``[S, H]``): the
    projections here, the block attention over them in
    ``ops/attention.py``."""
    s, cd = ctx.cfg, ctx.cd
    n = x.shape[0]
    nh, dn, dr, dv = s.num_attention_heads, s.qk_nope_head_dim, s.qk_rope_head_dim, s.v_head_dim
    q = _lin(x, p["q"], cd).view(n, nh, dn + dr)
    q_pe = q[..., dn:]
    q_pe.copy_(_rope(q_pe, ctx.cos[:, None, :], ctx.sin[:, None, :]))  # in place in q
    c, k_pe = _lin(x, p["kv_a"], cd).split([s.kv_lora_rank, dr], dim=-1)
    c = rms_norm(c, p["kv_norm"], s.rms_norm_eps)
    kv = _lin(c, p["kv_b"], cd).view(n, nh, dn + dv)  # k_nope | v
    out = stream_attention(q, kv, _rope(k_pe, ctx.cos, ctx.sin), ctx.pos, s.max_window,
                           ctx.scale)
    return _lin(out, p["o"], cd)


def route(router: torch.Tensor, x: torch.Tensor, s) -> tuple[torch.Tensor, ...]:
    """Softmax router in float32 and greedy top-k: ``(scores [T, N],
    gates [T, K], experts [T, K])``."""
    scores = torch.softmax(F.linear(x.float(), router.float()), dim=-1)
    gates, experts = torch.topk(scores, s.num_experts_per_tok, dim=-1, sorted=False)
    return scores, gates, experts


def capacity(slots: int, n_experts: int) -> int:
    """Rows of the sorted buffer: every (slot, expert) pair, each expert's
    group padded up to a multiple of ``ALIGN``."""
    return -(-(slots + n_experts * (ALIGN - 1)) // ALIGN) * ALIGN


def dispatch(experts: torch.Tensor, n_experts: int) -> tuple[torch.Tensor, ...]:
    """The sorted buffer's layout for ``experts`` ``[T, K]``, static shapes
    (no host read): ``order`` (the pairs sorted by expert, stably), ``dest``
    (each sorted pair's row in the buffer), ``src`` (each buffer row's slot,
    ``T`` for a padding row) and ``ends`` (int32 end of each expert's
    group, the last one at the buffer's end)."""
    t, k = experts.shape
    dev = experts.device
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    padded = (counts + ALIGN - 1) // ALIGN * ALIGN
    cap = capacity(t * k, n_experts)
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    ends = torch.cat([ends[:-1], ends.new_full((1,), cap)])
    sorted_e = flat[order]
    first = torch.cumsum(counts, 0) - counts
    dest = starts[sorted_e] + torch.arange(t * k, device=dev) - first[sorted_e]
    src = torch.full((cap,), t, dtype=torch.long, device=dev)
    src[dest] = order // k
    return order, dest, src, ends.to(torch.int32)


def _grouped(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor, cd) -> torch.Tensor:
    """``x`` rows of group ``g`` times ``w[g]^T`` (``w``: ``[G, out, in]``)."""
    return torch._grouped_mm(x.to(cd), w.to(cd).transpose(-2, -1), offs=ends)


def routed_experts(p: dict, x: torch.Tensor, gates, experts, n_experts: int, cd):
    """The routed experts' gated sum for every slot of ``x`` ``[T, H]``
    (float32). The gate scales each pair's activation before the expert's
    down projection (which is linear), and a slot's pairs are summed in
    float32."""
    t, h = x.shape
    order, dest, src, ends = dispatch(experts, n_experts)
    xs = torch.cat([x.to(cd), x.new_zeros((1, h), dtype=cd)])[src]
    g, u = _grouped(xs, p["gate_up"], ends, cd).chunk(2, dim=-1)
    k = experts.shape[1]
    gate_rows = torch.zeros(xs.shape[0], dtype=torch.float32, device=x.device)
    gate_rows = gate_rows.index_copy(0, dest, gates.reshape(-1)[order])
    y = _grouped(F.silu(g) * u * gate_rows[:, None].to(cd), p["down"], ends, cd)
    per_pair = torch.empty((t * k, h), dtype=y.dtype, device=y.device)
    per_pair[order] = y[dest]
    return per_pair.view(t, k, h).sum(1, dtype=torch.float32)


def balance_loss(scores, experts, weight, window, alpha: float):
    """DeepSeek-V2's expert-level balance loss per window (``window``: each
    slot's window number, below the slots' count), averaged over the windows
    with a slot of weight > 0; and each expert's routed slots of weight > 0
    (float32 ``[N]``)."""
    t, n = scores.shape
    k = experts.shape[1]
    w = weight.float()
    chosen = torch.zeros_like(scores).scatter_(1, experts, 1.0) * w[:, None]
    size = torch.zeros(t, device=scores.device).index_add_(0, window, w)
    hits = scores.new_zeros((t, n)).index_add_(0, window, chosen)
    mass = scores.new_zeros((t, n)).index_add_(0, window, scores * w[:, None])
    denom = size.clamp(min=1.0)[:, None]
    per_window = ((hits * n / (k * denom)) * (mass / denom)).sum(1)
    live = (size > 0).float()
    loss = alpha * (per_window * live).sum() / live.sum().clamp(min=1.0)
    return loss, chosen.sum(0)


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------


class _Stream:
    """What every block of one stream reads: the configuration, the compute
    dtype, each slot's place in its window and RoPE there, each slot's
    window and weight; and, during the stream's forward only (not when the
    backward runs a block again), the phase events of a timed capture and
    the routes' hook."""

    def __init__(self, config, pos: torch.Tensor, weight: torch.Tensor, cd):
        s = self.cfg = config.sequence
        self.cd = cd
        n = pos.shape[0]
        if n % s.max_window:
            raise ValueError(f"a stream of {n} slots is not a multiple of "
                             f"max_window={s.max_window}")
        cos, sin = rope_tables(s, pos.device)
        self.cos, self.sin = cos[pos.long()], sin[pos.long()]
        self.pos = pos.to(torch.int32)
        self.window = torch.cumsum((pos == 0).long(), 0) - 1  # a stream starts a window
        self.weight = weight
        self.scale = softmax_scale(s)
        self.phases = profiling.capturing_phases()
        self.routes = None

    def phase(self, name: str) -> None:
        if self.phases is not None:
            self.phases.boundary(name)


class _Mark(torch.autograd.Function):
    """The identity, marking a phase boundary of a timed capture: ``fwd``
    where the forward passes, ``bwd`` where the gradient does (on the
    autograd thread: the phases ride in ``ctx``)."""

    @staticmethod
    def forward(ctx, x, phases, fwd, bwd):
        ctx.phases, ctx.bwd = phases, bwd
        phases.boundary(fwd)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.phases.boundary(ctx.bwd)
        return g, None, None, None


def _mark(x: torch.Tensor, ctx: _Stream, fwd: str, bwd: str) -> torch.Tensor:
    if ctx.phases is None or not x.requires_grad:
        return x
    return _Mark.apply(x, ctx.phases, fwd, bwd)


def _attn_block(layer: dict, h: torch.Tensor, ctx: _Stream) -> torch.Tensor:
    x = rms_norm(h, layer["attn_norm"], ctx.cfg.rms_norm_eps)
    return h + attention(layer["attn"], x, ctx).float()


def _dense_block(layer: dict, h: torch.Tensor, ctx: _Stream) -> torch.Tensor:
    x = rms_norm(h, layer["ffn_norm"], ctx.cfg.rms_norm_eps).to(ctx.cd)
    return h + _swiglu(x, layer["mlp"], ctx.cd).float()


def _moe_block(layer: dict, h: torch.Tensor, ctx: _Stream):
    s, cd = ctx.cfg, ctx.cd
    x = rms_norm(h, layer["ffn_norm"], s.rms_norm_eps).to(cd)
    scores, gates, experts = route(layer["router"], x, s)
    if ctx.routes is not None:
        ctx.routes.append(experts.detach())
    aux, counts = balance_loss(scores, experts, ctx.weight, ctx.window, s.aux_loss_alpha)
    ctx.phase("seq.experts")
    out = routed_experts(layer["experts"], x, gates, experts, s.n_routed_experts, cd)
    if "shared" in layer:
        ctx.phase("seq.shared")
        out = out + _swiglu(x, layer["shared"], cd).float()
    return h + out, aux, counts


def _run(fn, *args):
    """A block, its activations recomputed in the backward: only its input
    is kept (the activations of 32,768 slots over 5 layers would not fit
    beside 38.7 GB of weights, gradients and Adam). No randomness runs inside."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward_stream(params: dict, rows: torch.Tensor, pos: torch.Tensor, weight: torch.Tensor,
                   config, *, routes: list | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layers over a packed stream: ``rows`` ``[S, E]`` (the slots' item
    rows), ``pos`` ``[S]`` (each slot's place in its window), ``weight``
    ``[S]`` (0 for a padding slot). Returns the final hidden state ``[S, H]``
    (float32, before the final norm), the balance loss (summed over the MoE
    layers) and each MoE layer's routed slots per expert (``[L_moe, N]``,
    float32). ``routes``: a list to which each MoE layer's chosen experts
    (``[S, K]``) are appended."""
    cd = getattr(torch, config.compute_dtype)
    ctx = _Stream(config, pos, weight, cd)
    ctx.routes = routes
    s = ctx.cfg
    p = params["seq_tower"]
    h = _lin(rows, p["in_proj"], cd).float()
    aux = h.new_zeros(())
    counts = []
    before = "backward"  # the phase the gradient enters below the first block
    for i, layer in enumerate(p["layers"]):
        h = _mark(h, ctx, "seq.attention", before)
        h = _run(_attn_block, layer, h, ctx)
        if i < s.first_k_dense_replace:
            h = _mark(h, ctx, "seq.dense_ffn", "seq.attention")
            h = _run(_dense_block, layer, h, ctx)
            before = "seq.dense_ffn"
        else:
            h = _mark(h, ctx, "seq.router", "seq.attention")
            h, layer_aux, layer_counts = _run(_moe_block, layer, h, ctx)
            aux = aux + layer_aux
            counts.append(layer_counts.detach())
            before = "seq.experts"
    h = _mark(h, ctx, "forward", before)
    ctx.phases, ctx.routes = None, None  # the backward runs blocks again
    counts = torch.stack(counts) if counts else h.new_zeros((0, s.n_routed_experts))
    return h, aux, counts


def head(params: dict, h: torch.Tensor, config) -> torch.Tensor:
    """Final RMSNorm, the projection to the item tower's width, L2 norm
    (float32 ``[*, D]``)."""
    p = params["seq_tower"]
    cd = getattr(torch, config.compute_dtype)
    x = rms_norm(h, p["norm"], config.sequence.rms_norm_eps)
    u = _lin(x, p["out_proj"], cd).float()
    return u * torch.rsqrt(torch.sum(u * u, dim=-1, keepdim=True) + 1e-12)


def stream_of_windows(windows: torch.Tensor, lengths: torch.Tensor):
    """A stream of ``B`` windows padded to ``W`` slots each (``windows``
    ``[B, W]`` item ids, left-aligned, ``lengths`` ``[B]`` in ``[1, W]``):
    ``(ids [B W], pos [B W], weight [B W])``, the padding slots weight 0
    (they sit after each window's last slot, where no real slot reads
    them)."""
    b, w = windows.shape
    pos = torch.arange(w, device=windows.device).repeat(b)
    weight = (torch.arange(w, device=windows.device)[None, :] < lengths[:, None]).reshape(-1)
    return windows.reshape(-1), pos, weight.float()


EVAL_SLOTS = 32768  # slots of one stream of windows while evaluating


def embed_windows(params: dict, windows: torch.Tensor, lengths: torch.Tensor,
                  config) -> torch.Tensor:
    """Each window's user state after its last item: ``[B, D]``, L2-normed
    (no dropout), the windows run in streams of ``EVAL_SLOTS`` slots."""
    b, w = windows.shape
    if w != config.sequence.max_window:
        raise ValueError(f"windows of {w} slots; the tower takes {config.sequence.max_window}")
    per = max(1, EVAL_SLOTS // w)
    out = []
    for lo in range(0, b, per):
        win, n = windows[lo:lo + per].long(), lengths[lo:lo + per].long()
        ids, pos, weight = stream_of_windows(win, n)
        h, _, _ = forward_stream(params, params["item_embedding"][ids], pos, weight, config)
        last = torch.arange(len(n), device=windows.device) * w + n - 1
        out.append(head(params, h[last], config))
    return torch.cat(out)

