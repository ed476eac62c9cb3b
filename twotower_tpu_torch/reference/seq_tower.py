"""Plain reference of the sequence user tower's train step, in float32 with
TF32 off: DeepSeek-V2's decoder layers over packed user windows, the item
tower over the targets, the in-batch softmax with log-Q correction, the
balance loss, L2, Adam on the dense weights and lazy Adam on the item rows.
It imports ``torch`` and nothing else; it has no kernels, no grouped
products and no activation recomputation, and shares no code with the
program it checks.

Departures from the published DeepSeek-V2-Lite
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json):

- Tokens are a user's interacted items: the 102,400-token vocabulary and its
  embedding are replaced by the item table (width ``embedding_dim``) and a
  learned ``embedding_dim -> hidden_size`` projection (``in_proj``, no
  bias).
- The LM head is replaced by a learned ``hidden_size -> D`` projection
  (``out_proj``, no bias) after the final RMSNorm, L2-normalized: each
  slot's user state, scored against the next item's item-tower output.
- Depth: ``num_hidden_layers`` as configured (the benchmark's 5 of 27).
- RoPE dimensions are rotated in the half-split layout; DeepSeek's
  checkpoints keep them interleaved and permute them on the fly, which for
  weights drawn fresh is the same model up to a fixed permutation of
  columns.
- Positions restart at each window (at most ``max_window`` slots), and
  attention never crosses a window.
- The softmax scale is DeepSeek's own: ``(dn + dr) ** -0.5 * mscale ** 2``,
  ``mscale = 0.1 * mscale_all_dim * ln(factor) + 1``.
- No dropout in the sequence tower; the item tower keeps its own.

Layout: ``params`` as the program's (``{"item_embedding", "item_tower",
"seq_tower"}``, linear weights ``[out, in]``); ``cfg`` a plain dict of the
sequence block's keys and ``embedding_dim``.

The lower precision, for a control: ``dtype`` (float8 e4m3, bfloat16) rounds
every product's operands in the towers to it; float32 rounds nothing.
"""

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
NEG = -1e9


class no_tf32:
    """TF32 off for the enclosed float32 products and convolutions."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def rnd(x, dtype):
    return x if dtype == torch.float32 else x.to(dtype).float()


def mm(x, w, dtype):
    """``x @ w.T`` with both operands rounded to ``dtype``, in float32."""
    return rnd(x, dtype) @ rnd(w, dtype).T


def rms_norm(x, w, eps):
    return w * x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def ln(x):
    return float(torch.log(torch.tensor(float(x), dtype=torch.float64)))


def yarn_mscale(scale, m):
    return 0.1 * m * ln(scale) + 1.0 if scale > 1.0 else 1.0


def rope_at(pos, cfg):
    """cos and sin ``[S, dr]`` of DeepSeek's YaRN rotary embedding at the
    slots' positions."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg.get("rope_scaling") or {}
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    m = 1.0
    if rs:
        factor = float(rs["factor"])
        orig = float(rs["original_max_position_embeddings"])
        pi = float(torch.pi)

        def corr(rot):
            return dim * ln(orig / (rot * 2 * pi)) / (2 * ln(base))

        lo = max(int(torch.floor(torch.tensor(corr(float(rs["beta_fast"]))))), 0)
        hi = min(int(torch.ceil(torch.tensor(corr(float(rs["beta_slow"]))))), dim - 1)
        hi = hi + 0.001 if lo == hi else hi
        keep = 1.0 - torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - lo) / (hi - lo),
                                 0.0, 1.0)
        freq = freq / factor * (1.0 - keep) + freq * keep
        m = yarn_mscale(factor, float(rs.get("mscale", 1.0))) / yarn_mscale(
            factor, float(rs.get("mscale_all_dim", 0.0)))
    ang = pos.double().cpu()[:, None] * freq[None, :]
    ang = torch.cat([ang, ang], dim=1)
    return ((ang.cos() * m).float().to(pos.device), (ang.sin() * m).float().to(pos.device))


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def windows_of(pos):
    """Each slot's window number (a window starts where ``pos`` is 0)."""
    return torch.cumsum((pos == 0).long(), 0) - 1


def allowed(pos):
    """``[S, S]``: query ``q`` may read key ``k`` (same window, ``k <= q``)."""
    w = windows_of(pos)
    s = pos.shape[0]
    idx = torch.arange(s, device=pos.device)
    return (w[:, None] == w[None, :]) & (idx[None, :] <= idx[:, None])


def softmax_scale(cfg):
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling") or {}
    if rs and float(rs.get("mscale_all_dim", 0.0)):
        m = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale = scale * m * m
    return scale


def mla(p, x, pos, cfg, dtype):
    s = x.shape[0]
    nh, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = mm(x, p["q"], dtype).view(s, nh, dn + dr)
    kv_a = mm(x, p["kv_a"], dtype)
    c, k_pe = kv_a[:, :r], kv_a[:, r:]
    kv = mm(rms_norm(c, p["kv_norm"], cfg["rms_norm_eps"]), p["kv_b"], dtype).view(s, nh, dn + dv)
    cos, sin = rope_at(pos, cfg)
    q_pe = rotate(q[..., dn:], cos[:, None], sin[:, None])
    k_pe = rotate(k_pe, cos, sin)
    qh = torch.cat([q[..., :dn], q_pe], dim=-1).transpose(0, 1)  # [nh, S, dn + dr]
    kh = torch.cat([kv[..., :dn], k_pe[:, None, :].expand(s, nh, dr)], dim=-1).transpose(0, 1)
    vh = kv[..., dn:].transpose(0, 1)
    scores = (rnd(qh, dtype) @ rnd(kh, dtype).transpose(1, 2)) * softmax_scale(cfg)
    scores = scores.masked_fill(~allowed(pos)[None], float("-inf"))
    out = rnd(torch.softmax(scores, dim=-1), dtype) @ rnd(vh, dtype)  # [nh, S, dv]
    return mm(out.transpose(0, 1).reshape(s, nh * dv), p["o"], dtype)


def swiglu(x, gate_up, down, dtype):
    h = mm(x, gate_up, dtype)
    f = h.shape[1] // 2
    return mm(torch.nn.functional.silu(h[:, :f]) * h[:, f:], down, dtype)


def moe(layer, x, cfg, dtype):
    """Softmax router, greedy top-k, every chosen expert run on its slots
    (one expert at a time), the shared experts on every slot."""
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(x @ layer["router"].T, dim=-1)
    gates, experts = torch.topk(scores, k, dim=-1)  # norm_topk_prob false, scaling 1
    out = torch.zeros_like(x)
    ex = layer["experts"]
    for e in range(cfg["n_routed_experts"]):
        slot, which = torch.nonzero(experts == e, as_tuple=True)
        if slot.numel():
            y = swiglu(x[slot], ex["gate_up"][e], ex["down"][e], dtype)
            out = out.index_add(0, slot, y * gates[slot, which][:, None])
    if "shared" in layer:
        out = out + swiglu(x, layer["shared"]["gate_up"], layer["shared"]["down"], dtype)
    return out, scores, experts


def balance(scores, experts, weight, pos, cfg):
    """DeepSeek-V2's expert-level balance loss of each window (slots of
    weight 0 left out), summed over the windows, and the windows counted."""
    n, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    w = windows_of(pos)
    member = (w[None, :] == torch.arange(int(w.max()) + 1, device=w.device)[:, None]).float()
    member = member * weight[None, :]
    size = member.sum(1)
    chosen = torch.nn.functional.one_hot(experts, n).sum(1).float()
    f = (member @ chosen) * n / (k * size.clamp(min=1.0)[:, None])
    p = (member @ scores) / size.clamp(min=1.0)[:, None]
    live = size > 0
    return cfg["aux_loss_alpha"] * ((f * p).sum(1) * live).sum(), live.sum()


def tower(params, rows, pos, weight, cfg, dtype=torch.float32):
    """The tower over a stream: ``(u [S, D] L2-normed, balance-loss sum
    over the windows, windows, each MoE layer's experts [S, K])``."""
    p = params["seq_tower"]
    eps = cfg["rms_norm_eps"]
    h = mm(rows, p["in_proj"], dtype)
    aux, windows, routes = h.new_zeros(()), 0, []
    for i, layer in enumerate(p["layers"]):
        h = h + mla(layer["attn"], rms_norm(h, layer["attn_norm"], eps), pos, cfg, dtype)
        x = rms_norm(h, layer["ffn_norm"], eps)
        if i < cfg["first_k_dense_replace"]:
            h = h + swiglu(x, layer["mlp"]["gate_up"], layer["mlp"]["down"], dtype)
        else:
            out, scores, experts = moe(layer, x, cfg, dtype)
            h = h + out
            loss, windows = balance(scores, experts, weight, pos, cfg)
            aux = aux + loss
            routes.append(experts)
    u = mm(rms_norm(h, p["norm"], eps), p["out_proj"], dtype)
    return u * torch.rsqrt((u * u).sum(-1, keepdim=True) + 1e-12), aux, windows, routes


def item_tower(layers, x, masks, rate, dtype):
    """The MLP item tower: ``x @ kernel + bias``, relu, inverted dropout by
    the given keep masks, activations rounded to ``dtype``; normalized."""
    x = rnd(x, dtype)
    for i, layer in enumerate(layers):
        x = rnd(x, dtype) @ rnd(layer["kernel"], dtype) + layer["bias"]
        if i < len(layers) - 1:
            x = torch.relu(x)
            if rate > 0.0:
                x = torch.where(masks[i], x / (1.0 - rate), 0.0)
            x = rnd(x, dtype)
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def in_batch_loss(u, v, items, weights, log_q, temperature):
    """Every slot against every target: logits ``u v^T / T - log q``,
    another column holding the row's own item, or of weight 0, masked;
    weighted mean of ``logsumexp - diagonal``."""
    b = u.shape[0]
    logits = (u @ v.T) / temperature - log_q[items][None, :]
    eye = torch.eye(b, dtype=torch.bool, device=u.device)
    masked = ((items[None, :] == items[:, None]) | (weights[None, :] == 0.0)) & ~eye
    logits = logits.masked_fill(masked, NEG)
    per_row = torch.logsumexp(logits, dim=1) - logits.diagonal()
    return (per_row * weights).sum() / weights.sum().clamp(min=1.0)


def blocks(pos, size):
    """``(lo, hi)`` ranges of at most about ``size`` slots, cut only where a
    window starts."""
    starts = torch.nonzero(pos == 0).flatten().tolist() + [pos.shape[0]]
    out, lo = [], 0
    for s in starts[1:]:
        if s - lo >= size:
            out.append((lo, s))
            lo = s
    if lo < pos.shape[0]:
        out.append((lo, pos.shape[0]))
    return out


def dense_leaves(params):
    """The dense weights in the program's leaf order (dict keys sorted)."""
    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]
    return leaves({k: v for k, v in params.items() if k != "item_embedding"})


def grads(params, rows, batch, log_q, cfg, masks, dtype=torch.float32, block=None):
    """The step's loss, the gradient of every dense leaf (``dense_leaves``'
    order) and of each slot's history and target row, and each MoE layer's
    experts. ``rows``: ``(history rows [S, E], target rows [S, E])``.
    ``block``: run the tower over blocks of windows of about that many
    slots (the loss still spans the whole stream): every block once
    without the gradient for the loss's inputs, then again with it."""
    pos, weight, items = batch["pos"], batch["weight"].float(), batch["item_idx"].long()
    h_rows, i_rows = rows
    leaves = dense_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    h_rows = h_rows.detach().requires_grad_(True)
    i_rows = i_rows.detach().requires_grad_(True)
    spans = [(0, pos.shape[0])] if block is None else blocks(pos, block)
    with torch.enable_grad():
        v = item_tower(params["item_tower"], i_rows, masks, cfg["dropout"], dtype)
        with torch.no_grad():
            us, routes = [], []
            aux_sum, windows = 0.0, 0
            for lo, hi in spans:
                u, aux, n, r = tower(params, h_rows[lo:hi], pos[lo:hi], weight[lo:hi], cfg, dtype)
                us.append(u)
                routes.append(r)
                aux_sum, windows = aux_sum + float(aux), windows + int(n)
        u = torch.cat(us).requires_grad_(True)
        reg = sum((layer["kernel"] ** 2).sum() for layer in params["item_tower"])
        reg = reg + (h_rows ** 2).sum() + (i_rows ** 2).sum()
        loss = in_batch_loss(u, v, items, weight, log_q, cfg["temperature"]) + cfg["l2"] * reg
        g = torch.autograd.grad(loss, [u, *leaves, h_rows, i_rows], allow_unused=True)
        du, total = g[0], list(g[1:])
        for lo, hi in spans:
            u_b, aux, _, _ = tower(params, h_rows[lo:hi], pos[lo:hi], weight[lo:hi], cfg, dtype)
            part = torch.autograd.grad([u_b, aux / max(windows, 1)], [*leaves, h_rows],
                                       grad_outputs=[du[lo:hi], torch.ones_like(aux)],
                                       allow_unused=True)
            total = [a if b is None else (b if a is None else a + b)
                     for a, b in zip(total, [*part, None])]
    for t in leaves:
        t.requires_grad_(False)
    total = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, total[:-2])] + \
        total[-2:]
    loss_value = float(loss.detach()) + aux_sum / max(windows, 1)
    layers = [torch.cat([r[i] for r in routes]) for i in range(len(routes[0]))]
    return loss_value, total[:-2], total[-2], total[-1], layers


def adam(p, g, mu, nu, t, lr):
    """One ``optax.adam`` update in place (``t``: the count after it)."""
    mu.mul_(B1).add_(g, alpha=1.0 - B1)
    nu.mul_(B2).add_(g * g, alpha=1.0 - B2)
    c1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** t
    c2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** t
    p.sub_(lr * ((mu / c1.to(p.device)) / (torch.sqrt(nu / c2.to(p.device)) + EPS)))


def step(params, state, batch, log_q, cfg, masks, t, lr, dtype=torch.float32, block=None):
    """One train step, in place. ``params["item_embedding"]``: the rows the
    step reads, ``(ids [R] unique ascending, rows [R, E])``; ``state``:
    ``{"mu": [...], "nu": [...]}`` over ``dense_leaves`` and
    ``{"rows_mu", "rows_nu"}`` ``[R, E]``; ``t`` the step's count (from 1).
    Returns ``(loss, dense gradients, row gradients [R, E] summed over both
    sources, each MoE layer's experts)``."""
    ids, table = params["item_embedding"]
    hist = torch.searchsorted(ids, batch["hist_idx"].long())
    tgt = torch.searchsorted(ids, batch["item_idx"].long())
    with no_tf32():
        loss, g_dense, g_hist, g_item, routes = grads(
            params, (table[hist], table[tgt]), batch, log_q, cfg, masks, dtype, block)
        g_rows = torch.zeros_like(table).index_add_(0, hist, g_hist).index_add_(0, tgt, g_item)
        with torch.no_grad():
            for p, g, mu, nu in zip(dense_leaves(params), g_dense, state["mu"], state["nu"]):
                adam(p, g, mu, nu, t, lr)
            touched = torch.zeros(len(ids), dtype=torch.bool, device=ids.device)
            touched[hist] = True
            touched[tgt] = True
            sel = torch.nonzero(touched).flatten()
            p, m, n = table[sel], state["rows_mu"][sel], state["rows_nu"][sel]
            adam(p, g_rows[sel], m, n, t, lr)
            table[sel], state["rows_mu"][sel], state["rows_nu"][sel] = p, m, n
    return loss, g_dense, g_rows, routes
