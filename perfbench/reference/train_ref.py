"""Plain reference of the sparse training step: row gather, both towers with
their dropout, in-batch sampled softmax with log-Q correction and hit
masking, L2 on the tower kernels and the gathered rows, dense Adam on the
towers and lazy Adam on the touched table rows. It follows the first steps
of an epoch from the initial weights, which it makes again from the seed.

Semantics (the configuration's, written out here once more):

- A tower: the input and each kernel rounded to the compute dtype (bfloat16),
  ``x @ W + b`` in float32, relu, inverted dropout at rate ``p`` where a
  uniform draw is ``< 1 - p``, the activation rounded to the compute dtype;
  no relu, dropout or rounding after the last layer; the output normalised
  by ``x * rsqrt(sum x^2 + 1e-12)``.
- The epoch's order: ``torch.randperm(rows, generator)`` with the generator
  seeded ``((seed + 1) << 32) + epoch`` on the device; step ``i`` takes the
  rows ``perm[i B:(i + 1) B]``.
- The dropout masks: one generator seeded ``seed + 1`` on the device, drawn
  ``torch.rand`` of each hidden activation's shape, the user tower's layers
  first, then the item tower's, step after step from the run's first step
  (``dropout_generator`` draws the steps before a later one).
- The loss: ``s = u v^T``, logits ``s / T - log q[item]``, a column whose
  item equals the row's (off the diagonal) or whose weight is 0 set to
  -1e9, per row ``logsumexp - diagonal``, weighted mean over
  ``max(sum w, 1)``; plus ``l2`` times the squares of the tower kernels and
  of the gathered rows.
- Adam (b1 0.9, b2 0.999, eps 1e-8, optax's) on the towers; on each table
  the rows touched in a step get the same update from their summed
  gradient, and no other row moves. The bias corrections count the run's
  steps: step ``t`` of the run divides by ``1 - b ** t``.

The lower precision, for the control: ``dtype=torch.float8_e4m3fn`` rounds
the towers' operands and activations to float8 e4m3 in place of bfloat16.
"""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
NEG = -1e9


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def no_tf32():
    """TF32 off for the enclosed float32 products (restored after)."""
    class _Off:
        def __enter__(self):
            m = torch.backends.cuda.matmul
            self.new = hasattr(m, "fp32_precision")
            self.saved = m.fp32_precision if self.new else m.allow_tf32
            if self.new:
                m.fp32_precision = "ieee"
            else:
                m.allow_tf32 = False

        def __exit__(self, *exc):
            m = torch.backends.cuda.matmul
            if self.new:
                m.fp32_precision = self.saved
            else:
                m.allow_tf32 = self.saved
    return _Off()


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def epoch_order(seed: int, epoch: int, rows: int, device) -> torch.Tensor:
    gen = torch.Generator(device=torch.device(device)).manual_seed(((seed + 1) << 32) + epoch)
    return torch.randperm(rows, generator=gen, device=device)


def dropout_generator(seed: int, steps_before: int, batch: int, towers: dict, device):
    """The dropout generator as the run's step ``steps_before + 1`` finds it:
    seeded ``seed + 1``, then every mask of the ``steps_before`` steps
    before drawn (``towers``' hidden widths, user tower first)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    shapes = [(batch, layer["kernel"].shape[1]) for v in towers.values() for layer in v[:-1]]
    bufs = [torch.empty(s, device=dev) for s in shapes]
    for _ in range(steps_before):
        for buf in bufs:
            torch.rand(buf.shape, generator=gen, device=dev, out=buf)
    return gen


def tower(layers, x, *, dtype, rate: float, gen):
    x = _round(x.float(), dtype)
    for i, layer in enumerate(layers):
        x = x @ _round(layer["kernel"], dtype) + layer["bias"]
        if i < len(layers) - 1:
            x = torch.relu(x)
            if rate > 0.0:
                keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
                x = torch.where(keep, x / (1.0 - rate), 0.0)
            x = _round(x, dtype)
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def loss_and_grads(u, v, items, weights, log_q, temperature: float):
    """The in-batch loss and its gradients w.r.t. ``u`` and ``v``, written
    out."""
    b = u.shape[0]
    logits = (u @ v.T) / temperature - log_q[items][None, :]
    eye = torch.eye(b, dtype=torch.bool, device=u.device)
    masked = (items[None, :] == items[:, None]) | (weights[None, :] == 0.0)
    logits = torch.where(masked & ~eye, NEG, logits)
    lse = torch.logsumexp(logits, dim=1)
    denom = torch.clamp(weights.sum(), min=1.0)
    loss = torch.sum((lse - logits.diagonal()) * weights) / denom
    ds = (torch.softmax(logits, dim=1) - eye.float()) * (weights / denom)[:, None] / temperature
    return loss, ds @ v, ds.T @ u


def _adam(p, g, mu, nu, t: int, lr: float):
    mu.mul_(B1).add_(g, alpha=1.0 - B1)
    nu.mul_(B2).add_(g * g, alpha=1.0 - B2)
    c1 = 1.0 - torch.pow(torch.tensor(B1, device=p.device), float(t))
    c2 = 1.0 - torch.pow(torch.tensor(B2, device=p.device), float(t))
    p.sub_(lr * ((mu / c1) / (torch.sqrt(nu / c2) + EPS)))


def follow_steps(towers: dict, rows: dict, batches: list[dict], log_q, *, lr: float, l2: float,
                 temperature: float, dropout: float, dtype: torch.dtype, dropout_gen,
                 moments: dict | None = None, steps_before: int = 0) -> dict:
    """Run ``len(batches)`` steps from ``towers`` (``{"user_tower": [...],
    "item_tower": [...]}``) and ``rows`` (``{"user_embedding": (ids [R],
    rows [R, E]), "item_embedding": ...}``: every row the steps touch, ids
    unique). Each batch holds ``user_idx``, ``item_idx``, ``weight``.
    Returns each step's loss, the first step's gradients (towers as leaves,
    tables as ``[R, E]`` over ``rows``' ids) and the weights after the last
    step. The inputs are not changed.

    From the run's start by default (Adam's moments zero). A later step
    starts from ``moments`` (``{"towers": {k: [{n: (mu, nu)}]}, "tables":
    {k: (mu [R, E], nu [R, E])}}``) after ``steps_before`` steps."""
    towers = {k: [{n: t.clone() for n, t in layer.items()} for layer in v]
              for k, v in towers.items()}
    tables = {k: (ids, t.clone()) for k, (ids, t) in rows.items()}
    if moments is None:
        tower_mo = {k: [{n: (torch.zeros_like(t), torch.zeros_like(t))
                         for n, t in layer.items()} for layer in v] for k, v in towers.items()}
        table_mo = {k: (torch.zeros_like(t), torch.zeros_like(t))
                    for k, (_, t) in tables.items()}
    else:
        tower_mo = {k: [{n: (mu.clone(), nu.clone()) for n, (mu, nu) in layer.items()}
                        for layer in v] for k, v in moments["towers"].items()}
        table_mo = {k: (mu.clone(), nu.clone()) for k, (mu, nu) in moments["tables"].items()}
    with no_tf32():
        return _follow(towers, tables, tower_mo, table_mo, batches, log_q, lr=lr, l2=l2,
                       temperature=temperature, dropout=dropout, dtype=dtype,
                       dropout_gen=dropout_gen, start=steps_before + 1)


def _follow(towers, tables, tower_mo, table_mo, batches, log_q, *, lr, l2, temperature,
            dropout, dtype, dropout_gen, start: int) -> dict:
    losses, first = [], None
    for step, batch in enumerate(batches, start=start):
        slots = {}
        for name, key in (("user_embedding", "user_idx"), ("item_embedding", "item_idx")):
            ids, table = tables[name]
            slots[name] = torch.searchsorted(ids, batch[key].long())
        leaves = [t.requires_grad_() for v in towers.values() for layer in v
                  for t in layer.values()]
        u_rows = tables["user_embedding"][1][slots["user_embedding"]].requires_grad_()
        i_rows = tables["item_embedding"][1][slots["item_embedding"]].requires_grad_()
        with torch.enable_grad():
            u = tower(towers["user_tower"], u_rows, dtype=dtype, rate=dropout, gen=dropout_gen)
            v = tower(towers["item_tower"], i_rows, dtype=dtype, rate=dropout, gen=dropout_gen)
            loss, du, dv = loss_and_grads(u.detach(), v.detach(), batch["item_idx"].long(),
                                          batch["weight"].float(), log_q, temperature)
            reg = sum(torch.sum(layer["kernel"] ** 2) for v_ in towers.values()
                      for layer in v_) + torch.sum(u_rows ** 2) + torch.sum(i_rows ** 2)
            grads = torch.autograd.grad([u, v, reg], [*leaves, u_rows, i_rows],
                                        grad_outputs=[du, dv, torch.tensor(l2, device=u.device)])
        for t in leaves:
            t.requires_grad_(False)
        losses.append(float(loss + l2 * reg.detach()))
        tower_grads = grads[:len(leaves)]
        row_grads = {}
        for name, g in (("user_embedding", grads[-2]), ("item_embedding", grads[-1])):
            ids, table = tables[name]
            summed = torch.zeros_like(table).index_add_(0, slots[name], g)
            touched = torch.zeros(len(ids), dtype=torch.bool, device=ids.device)
            touched[slots[name]] = True
            row_grads[name] = (summed, touched)
        if first is None:
            first = {"towers": [g.clone() for g in tower_grads],
                     "tables": {k: s.clone() for k, (s, _) in row_grads.items()}}
        with torch.no_grad():
            flat_mo = [m for v in tower_mo.values() for layer in v for m in layer.values()]
            for p, g, (mu, nu) in zip(leaves, tower_grads, flat_mo):
                _adam(p, g, mu, nu, step, lr)
            for name, (summed, touched) in row_grads.items():
                _, table = tables[name]
                mu, nu = table_mo[name]
                sel = touched.nonzero().squeeze(1)
                p, m, n = table[sel], mu[sel], nu[sel]
                _adam(p, summed[sel], m, n, step, lr)
                table[sel], mu[sel], nu[sel] = p, m, n
    return {"losses": losses, "grad1": first,
            "towers": towers, "tables": {k: t for k, (_, t) in tables.items()}}


def tower_leaves(towers: dict) -> list[torch.Tensor]:
    """Tower leaves in the order ``follow_steps`` reports their gradients:
    the dict's order, each layer's kernel then bias."""
    return [t for v in towers.values() for layer in v for t in layer.values()]
