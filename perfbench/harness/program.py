"""What every driver reads of the program's configuration: the
``twotower_tpu_torch`` ``Config`` a cell runs (its configuration file's
``port`` block with the traffic's ``overrides`` and the run's seed), the
model's widths, and the precisions that follow from it.

The precision a reference scores at is the one the configuration states for
the path, and the control's is the nearest below it (``CONTROL``): nothing
of either is a traffic setting.
"""

from __future__ import annotations

# The nearest precision below each one a configuration states: the control.
CONTROL = {"float64": "float32", "float32": "tf32", "bfloat16": "fp8", "float16": "fp8",
           "int8": "int4"}


def program_config(run):
    """The program's ``Config`` for ``run``: the configuration file's
    ``port`` block, the traffic's ``overrides``, ``training.seed`` from the
    run's seed."""
    from twotower_tpu_torch.config import Config

    over = dict(run.cell.traffic.get("overrides", {}))
    over["training.seed"] = run.program_seed
    return Config.from_dict(run.cell.config["port"]).with_overrides(over)


def model_of(cfg) -> dict:
    """The widths ``harness/weights.py`` makes weights for."""
    m = cfg.model
    return {"embedding_dim": m.embedding_dim, "user_tower_dims": list(m.user_tower_dims),
            "item_tower_dims": list(m.item_tower_dims)}


def control_of(precision: str) -> str:
    return CONTROL[precision]
