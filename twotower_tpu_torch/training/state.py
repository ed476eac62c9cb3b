"""Train state + optimizer factory (PyTorch).

Counterpart of ``twotower_tpu/training/state.py``. The state is a plain
dataclass of tensors. The train step updates its tensors in place (the
JAX step donates its state for the same reason: no copy of the tables per
step) and returns a new ``TrainState`` that shares them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
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
    """Dense-tower Adam state, optax's ``ScaleByAdamState`` layout: ``mu``
    and ``nu`` have the structure of the parameters they cover."""

    count: int
    mu: Any
    nu: Any


class Adam:
    """Adam with optax semantics: ``mu_hat / (sqrt(nu_hat) + eps)``, bias
    correction by the incremented count, ``lr`` a constant or a schedule of
    the count before the increment (``optax.adam``)."""

    def __init__(
        self,
        learning_rate: float | Schedule,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Any) -> AdamState:
        return AdamState(
            count=0,
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    @torch.no_grad()
    def update_(
        self,
        params: Any,
        grads: Any,
        state: AdamState,
        *,
        clock: torch.Tensor | None = None,
        lr: torch.Tensor | None = None,
    ) -> AdamState:
        """Update ``params`` and the moments in place; returns the state
        with the count advanced.

        With ``clock`` (the count before this update, a 0-d float32 tensor
        on the device) and ``lr`` (a 0-d tensor there), the bias corrections
        are computed on the device from ``clock + 1``, as the JAX step
        computes them from its count array, so the update can be captured
        in a CUDA graph and replayed; ``state.count`` is then host
        bookkeeping only."""
        b1, b2 = self.b1, self.b2
        if clock is None:
            lr = self.lr(state.count)
            count = state.count + 1
            c1 = 1.0 - f32_pow(b1, count)
            c2 = 1.0 - f32_pow(b2, count)
        else:
            t = clock + 1.0
            c1 = 1.0 - torch.pow(b1, t)
            c2 = 1.0 - torch.pow(b2, t)
        for p, g, mu, nu in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state.mu), tree_leaves(state.nu),
        ):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if clock is None:
                p.add_(step, alpha=-lr)
            else:
                p.sub_(step * lr)
        return AdamState(count=state.count + 1, mu=state.mu, nu=state.nu)


def f32_pow(base: float, exp: int) -> float:
    """``base ** exp`` rounded through float32, as the JAX step computes it."""
    return float(torch.tensor(base, dtype=torch.float32) ** exp)


@dataclass
class TrainState:
    """Training state. ``opt_state`` covers the dense (tower) params;
    ``table_state`` holds the packed per-table Adam moments of the sparse
    path (``training/sparse.py``)."""

    step: int
    params: Any
    opt_state: AdamState
    table_state: Any = None

    @classmethod
    def for_config(cls, params: Any, optimizer: Adam, config: Any) -> "TrainState":
        """State matching ``config.training.sparse_table_updates``."""
        if not config.training.effective_sparse_updates():
            raise NotImplementedError(
                "the dense train step is not ported yet (ROADMAP.md, Queue 1: the dense "
                "step); "
                "use training.sparse_table_updates with the adam optimizer"
            )
        return cls.create_sparse(params, optimizer)

    @classmethod
    def create_sparse(cls, params: Any, optimizer: Adam) -> "TrainState":
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
    optimizer: Adam,
    num_users: int,
    num_items: int,
    mesh: Any = None,
    *,
    device: str | torch.device | None = None,
) -> TrainState:
    """Fresh seeded state on ``device`` (``cuda`` unless the caller asks for
    the CPU). Single device only. The parameters are drawn on the CPU and
    moved, so one seed gives the same initial model on every device."""
    from twotower_tpu_torch.models import two_tower

    if mesh is not None:
        raise NotImplementedError(
            "the multi-device mesh path is not ported yet (ROADMAP.md, Queue 1: multi-GPU)"
        )
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(config.training.seed)
    params = two_tower.init_params(gen, config.model, num_users, num_items)
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
    the JAX package builds them. Shared by the dense Adam and the sparse
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


def make_optimizer(config: TrainingConfig) -> Adam:
    """The dense-tower optimizer (reference schema: adam, lr 0.001)."""
    if config.optimizer.lower() != "adam" or config.weight_decay > 0:
        raise NotImplementedError(
            f"optimizer {config.optimizer!r} with weight_decay "
            f"{config.weight_decay} is not ported yet; only adam without "
            "weight decay is (ROADMAP.md, Queue 1: the dense step and optimizers)"
        )
    lr: float | Schedule = config.learning_rate
    if config.warmup_steps > 0 or config.decay_steps > 0:
        lr = _lr_schedule(config)
    return Adam(lr)
