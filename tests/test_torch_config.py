"""The port's CLI override parser: the reference's behaviour on ordinary
values, without the reference's over-eager numeric coercion (``nan``,
``inf`` and ``1_000`` stay strings; only strict scientific notation such as
``1e-5`` becomes a float)."""

import math

import pytest

from twotower_tpu.config import parse_cli_overrides as jax_parse_cli_overrides
from twotower_tpu_torch.config import Config, parse_cli_overrides

ORDINARY = [
    "model.l2_regularization=1e-5",
    "training.learning_rate=2.5E-3",
    "training.epochs=3",
    "dataset.name=books",
    "model.user_tower_dims=[64,32]",
    "training.batch_size=512",
    "model.compute_dtype=float32",
    "model.temperature=0.05",
    "training.use_log_q=false",
]


def test_ordinary_overrides_match_the_reference():
    assert parse_cli_overrides(ORDINARY) == jax_parse_cli_overrides(ORDINARY)


@pytest.mark.parametrize(
    "text,value",
    [("1e-5", 1e-05), ("-2E+3", -2000.0), ("3.5e2", 350.0), ("+1.e-3", 1e-3)],
)
def test_scientific_notation_becomes_a_float(text, value):
    out = parse_cli_overrides([f"model.l2_regularization={text}"])["model.l2_regularization"]
    assert isinstance(out, float) and out == value


@pytest.mark.parametrize("text", ["nan", "inf", "-inf", "Infinity", "1_000", "1_0.5", "1e5x"])
def test_number_like_strings_stay_strings(text):
    assert parse_cli_overrides([f"dataset.name={text}"]) == {"dataset.name": text}


def test_yaml_special_floats_and_plain_numbers_keep_their_yaml_type():
    out = parse_cli_overrides(["a=.nan", "b=7", "c=0.25", "d=true", "e=null"])
    assert math.isnan(out["a"])
    assert out["b"] == 7 and isinstance(out["b"], int)
    assert out["c"] == 0.25
    assert out["d"] is True and out["e"] is None


def test_string_field_override_reaches_the_config():
    cfg = Config().with_overrides(parse_cli_overrides(["dataset.name=inf"]))
    assert cfg.dataset.name == "inf"


def test_override_must_be_a_pair():
    with pytest.raises(ValueError):
        parse_cli_overrides(["bad-pair"])
