"""Train state + optimizer factory (PyTorch).

Counterpart of ``twotower_tpu/training/state.py``. The state is a plain
dataclass of tensors. The train step updates its tensors in place (the
JAX step donates its state for the same reason: no copy of the tables per
step) and returns a new ``TrainState`` that shares them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Any, Callable

import torch

from twotower_tpu_torch.config import TrainingConfig
from twotower_tpu_torch.utils.platform import resolve_device

Schedule = Callable[[int], float]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Map over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """Leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@dataclass
class AdamState:
    """Adam state, optax's ``ScaleByAdamState`` layout: ``mu`` and ``nu``
    have the structure of the parameters they cover. ``count`` is the
    number of updates applied, which also drives a schedule (optax keeps
    it again in ``ScaleByScheduleState``)."""

    count: int
    mu: Any
    nu: Any


@dataclass
class RssState:
    """Adagrad state, optax's ``ScaleByRssState`` layout: the running sum of
    squared gradients per parameter, and the update count."""

    count: int
    sum_of_squares: Any


@dataclass
class SgdState:
    """SGD keeps no slots (optax's ``EmptyState``); ``count`` drives a
    schedule (``ScaleByScheduleState``)."""

    count: int


OPT_STATES = (AdamState, RssState, SgdState)


def opt_slots(state: Any) -> dict[str, Any]:
    """An optimizer state's trees by field name (every field but ``count``)."""
    return {f.name: getattr(state, f.name) for f in fields(state) if f.name != "count"}


def opt_state_to_tree(state: Any) -> dict:
    """``{"count": int, <slot>: tree, ...}``: the layout that checkpoints and
    the bridge store (an adam state: ``count``, ``mu``, ``nu``)."""
    return {"count": int(state.count), **opt_slots(state)}


def opt_state_from_tree(tree: dict) -> Any:
    """Inverse of ``opt_state_to_tree``: the state class whose slots are the
    tree's keys."""
    slots = {k: v for k, v in tree.items() if k != "count"}
    for cls in OPT_STATES:
        if {f.name for f in fields(cls)} - {"count"} == set(slots):
            return cls(count=int(tree["count"]), **slots)
    raise ValueError(f"no optimizer state has the slots {sorted(slots)}")


class _Optimizer:
    """optax semantics written out by hand (optax 0.2.6): the update is
    computed per parameter leaf and applied in place.

    ``weight_decay`` is coupled L2 unless ``decoupled``: ``g + wd * p``
    before the optimizer's transform (``chain(add_decayed_weights(wd),
    tx)``, on every leaf, tables included: optax takes no mask there); with
    ``decoupled`` (adamw) ``u + wd * p`` after it. Then ``p -= lr * u``
    with ``lr`` a constant or a schedule of the count before the update
    (``scale_by_learning_rate``).

    ``update_(params, grads, state, *, clock=None, lr=None)``: with
    ``clock`` (the count before this update, a 0-d float32 tensor on the
    device) and ``lr`` (a 0-d tensor there), whatever depends on the count
    is computed on the device, so the update can be captured in a CUDA
    graph and replayed; ``state.count`` is then host bookkeeping only. The
    same object serves the dense towers of the sparse step and the whole
    parameter tree of the dense step."""

    def __init__(self, learning_rate: float | Schedule, *, weight_decay: float = 0.0,
                 decoupled: bool = False):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.decoupled = decoupled

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def _coupled(self, g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        if self.weight_decay and not self.decoupled:
            return g + self.weight_decay * p
        return g

    def _apply(self, p: torch.Tensor, u: torch.Tensor, lr) -> None:
        if self.weight_decay and self.decoupled:
            u = u + self.weight_decay * p
        # optax rounds -lr * u, then adds it: no fused multiply-add.
        p.sub_(u * lr)

    @torch.no_grad()
    def update_(self, params: Any, grads: Any, state: Any, *,
                clock: torch.Tensor | None = None, lr: torch.Tensor | None = None) -> Any:
        if clock is None:
            lr = self.lr(state.count)
        leaves = zip(tree_leaves(params), tree_leaves(grads),
                     *(tree_leaves(t) for t in opt_slots(state).values()))
        self._update_leaves(leaves, state.count, clock, lr)
        return replace(state, count=state.count + 1)


class Adam(_Optimizer):
    """``optax.adam`` (and ``adamw`` with ``decoupled``): ``mu_hat /
    (sqrt(nu_hat) + eps)``, bias corrections by the incremented count."""

    def __init__(self, learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, **decay):
        super().__init__(learning_rate, **decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Any) -> AdamState:
        return AdamState(count=0, mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def _update_leaves(self, leaves, count, clock, lr) -> None:
        b1, b2 = self.b1, self.b2
        # The bias corrections in float32 from the incremented count, as
        # optax computes them from its count array.
        t = (torch.tensor(float(count)) if clock is None else clock) + 1.0
        c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        for p, g, mu, nu in leaves:
            g = self._coupled(g, p)
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            self._apply(p, (mu / c1) / (torch.sqrt(nu / c2) + self.eps), lr)


class Adagrad(_Optimizer):
    """``optax.adagrad`` (``scale_by_rss``): the accumulator starts at
    ``initial_accumulator_value``, ``s += g**2``, and the update is ``g *
    where(s > 0, rsqrt(s + eps), 0)``."""

    def __init__(self, learning_rate: float | Schedule, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, **decay):
        super().__init__(learning_rate, **decay)
        self.initial_accumulator_value, self.eps = initial_accumulator_value, eps

    def init(self, params: Any) -> RssState:
        return RssState(count=0, sum_of_squares=tree_map(
            lambda t: torch.full_like(t, self.initial_accumulator_value), params))

    def _update_leaves(self, leaves, count, clock, lr) -> None:
        for p, g, s in leaves:
            g = self._coupled(g, p)
            s.add_(g * g)
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0)
            self._apply(p, inv * g, lr)


class Sgd(_Optimizer):
    """``optax.sgd`` without momentum: ``u = g``."""

    def init(self, params: Any) -> SgdState:
        return SgdState(count=0)

    def _update_leaves(self, leaves, count, clock, lr) -> None:
        for p, g in leaves:
            self._apply(p, self._coupled(g, p), lr)


Optimizer = Adam | Adagrad | Sgd


def f32_pow(base: float, exp: int) -> float:
    """``base ** exp`` rounded through float32, as the JAX step computes it."""
    return float(torch.tensor(base, dtype=torch.float32) ** exp)


@dataclass
class TrainState:
    """Training state. On the sparse path ``opt_state`` covers the dense
    (tower) params and ``table_state`` holds the packed per-table Adam
    moments (``training/sparse.py``); on the dense path ``opt_state``
    covers every parameter and ``table_state`` is None. On a mesh the
    tensors are this rank's shard (``sharding``)."""

    step: int
    params: Any
    opt_state: Any
    table_state: Any = None
    # On a mesh: how the tensors above are sharded
    # (``parallel.sharding.StateSharding``); None on one device.
    sharding: Any = None

    @classmethod
    def create(cls, params: Any, optimizer: Optimizer) -> "TrainState":
        """State for the dense step: the optimizer over every parameter."""
        return cls(step=0, params=params, opt_state=optimizer.init(params))

    @classmethod
    def for_config(cls, params: Any, optimizer: Optimizer, config: Any,
                   mesh: Any = None) -> "TrainState":
        """State matching ``config.training.sparse_table_updates``. With
        ``mesh`` (``parallel.mesh.Mesh``), ``params`` are the full
        parameters and the state is this rank's shard on the mesh's device:
        the sparse mesh path's layout (tables and packed moments row-sharded
        over the combined axis) where ``parallel.use_sparse_mesh_path``, else
        the dense one (tables over ``model``, the optimizer over every leaf),
        as the JAX ``init_train_state`` lays them out."""
        if mesh is not None:
            from dataclasses import replace

            from twotower_tpu_torch.parallel.sharding import StateSharding, shard_tree
            from twotower_tpu_torch.parallel.sparse_spmd import use_sparse_mesh_path

            sparse = use_sparse_mesh_path(config)
            local = shard_tree(params, mesh, config.mesh, sparse_mesh=sparse)
            state = cls.create_sparse(local, optimizer) if sparse else cls.create(local, optimizer)
            return replace(state, sharding=StateSharding(mesh, sparse))
        if config.training.effective_sparse_updates():
            return cls.create_sparse(params, optimizer)
        return cls.create(params, optimizer)

    @classmethod
    def create_sparse(cls, params: Any, optimizer: Optimizer) -> "TrainState":
        """State for the sparse-table path: optimizer over dense params only,
        explicit Adam moments per embedding table."""
        from twotower_tpu_torch.training.sparse import init_table_state, split_params

        tables, dense = split_params(params)
        return cls(
            step=0,
            params=params,
            opt_state=optimizer.init(dense),
            table_state=init_table_state(tables),
        )


def init_train_state(
    config: Any,
    optimizer: Optimizer,
    num_users: int,
    num_items: int,
    mesh: Any = None,
    *,
    text_embedding_init: Any = None,
    device: str | torch.device | None = None,
) -> TrainState:
    """Fresh seeded state on ``device`` (``cuda`` unless the caller asks for
    the CPU), laid out for ``training.sparse_table_updates``; with ``mesh``,
    this rank's shard on the mesh's device (``TrainState.for_config``). The
    parameters are drawn on the CPU and moved, so one seed gives the same
    initial model on every device and at every world size.
    ``text_embedding_init``: an optional ``[padded_rows(text_buckets),
    embedding_dim]`` text table in place of the random one
    (``two_tower.init_params``)."""
    from twotower_tpu_torch.models import two_tower

    dev = mesh.device if mesh is not None else resolve_device(device)
    gen = torch.Generator().manual_seed(config.training.seed)
    params = two_tower.init_params(
        gen, config.model, num_users, num_items, text_embedding_init=text_embedding_init
    )
    if mesh is not None:
        return TrainState.for_config(params, optimizer, config, mesh=mesh)
    return TrainState.for_config(tree_map(lambda t: t.to(dev), params), optimizer, config)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _lr_schedule(config: TrainingConfig) -> Schedule:
    """Warmup + optional cosine decay (training.decay_steps) to 1% of
    peak: ``optax.warmup_cosine_decay_schedule`` / ``linear_schedule`` as
    the JAX package builds them. Shared by every optimizer and the sparse
    lazy-Adam rows (``training.sparse.make_lr_fn``)."""
    peak = config.learning_rate
    warmup = max(config.warmup_steps, 0)
    if config.decay_steps <= 0:
        return _linear(0.0, peak, config.warmup_steps)
    warm = _linear(0.0 if config.warmup_steps > 0 else peak, peak, warmup)
    decay_steps = config.decay_steps  # (warmup + decay) - warmup
    alpha = 0.01

    def schedule(count: int) -> float:
        if count < warmup:
            return warm(count)
        t = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def lr_at(config: TrainingConfig, count: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``count`` (a 0-d float32 tensor on the device),
    computed there in float32 as optax computes it from its count array:
    the device twin of the constant rate and of ``_lr_schedule``."""
    peak = config.learning_rate
    if config.warmup_steps <= 0 and config.decay_steps <= 0:
        return torch.full_like(count, peak)

    def linear(init: float, end: float, steps: int) -> torch.Tensor:
        if steps <= 0:
            return torch.full_like(count, init)
        frac = 1.0 - torch.clamp(count, 0, steps) / steps
        return (init - end) * frac + end

    if config.decay_steps <= 0:
        return linear(0.0, peak, config.warmup_steps)
    warmup = max(config.warmup_steps, 0)
    warm = linear(0.0 if config.warmup_steps > 0 else peak, peak, warmup)
    t = torch.clamp(count - warmup, max=config.decay_steps)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * t / config.decay_steps))
    alpha = 0.01
    return torch.where(count < warmup, warm, peak * ((1.0 - alpha) * cosine + alpha))


def make_optimizer(config: TrainingConfig) -> Optimizer:
    """The optimizer of ``training.optimizer`` (reference schema: adam, lr
    0.001), as the JAX package chains it (``make_optimizer``,
    ``twotower_tpu/training/state.py:129-148``): adam, adamw (decoupled
    ``weight_decay``), adagrad or sgd; any ``weight_decay`` but adamw's is
    coupled L2 on every leaf."""
    lr: float | Schedule = config.learning_rate
    if config.warmup_steps > 0 or config.decay_steps > 0:
        lr = _lr_schedule(config)
    name = config.optimizer.lower()
    classes = {"adam": Adam, "adamw": Adam, "adagrad": Adagrad, "sgd": Sgd}
    if name not in classes:
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    return classes[name](lr, weight_decay=config.weight_decay, decoupled=name == "adamw")
