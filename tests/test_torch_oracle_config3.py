"""Config 3's oracle (``tools/oracle_parity.py``'s ``config3`` preset: 250k
users, 1.2M items, 256 clusters, latent 16, within-zipf 0.5, seed 42) on
the port against the JAX package, at the full shape of its teacher.

The teacher is drawn from ``np.random.default_rng(seed)`` before any
interaction, so both generators run with a few thousand interactions and
the numpy cluster sampler and still write the full-scale teacher. Its
arrays must be equal bit for bit, and its digest must be the constant that
``chip_smoke.py`` phase 7h holds the card's teacher to. The exact and
plug-in ranks of 64 of the generator's rows over all 1.2M items must equal
the JAX package's."""

import re
from pathlib import Path

import numpy as np
import pytest

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.data import synthetic_scale as jax_scale
from twotower_tpu.evaluation import oracle as jax_oracle
from twotower_tpu_torch.data import synthetic_scale as scale
from twotower_tpu_torch.evaluation import oracle
from twotower_tpu_torch.tools import oracle_parity

pq = pytest.importorskip("pyarrow.parquet")

ROOT = Path(__file__).resolve().parents[1]
PRESET = oracle_parity.SCALES["config3"]
ROWS = 3_000  # interactions drawn; the teacher does not depend on them
EVAL_ROWS = 64


def _shape(**kw) -> dict:
    return dict(num_interactions=ROWS, num_users=PRESET["users"], num_items=PRESET["items"],
                num_clusters=PRESET["clusters"], latent_dim=PRESET["latent"],
                within_zipf=PRESET["zipf"], seed=42, oracle=True, **kw)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """(port dir, JAX dir, stats) of both generators at config 3's shape."""
    root = tmp_path_factory.mktemp("oracle_config3")
    stats = scale.generate_parquet(root / "port", use_device=False, **_shape())
    jax_scale.generate_parquet(root / "jax", use_jax=False, **_shape())
    return root / "port", root / "jax", stats


@pytest.fixture(scope="module")
def rows(generated):
    """The generator's (user, item) rows as teacher indices."""
    port, _, stats = generated
    tables = [pq.read_table(port / f) for f in stats["files"]]
    users = np.concatenate([oracle._vocab_to_generator_idx(
        np.asarray(t.column("user_id")), "U") for t in tables])
    items = np.concatenate([oracle._vocab_to_generator_idx(
        np.asarray(t.column("parent_asin")), "I") for t in tables])
    return users, items


def test_teacher_equals_jax_bit_for_bit(generated):
    port, jax_dir, _ = generated
    with np.load(port / "oracle_teacher.npz") as a, np.load(jax_dir / "oracle_teacher.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            x, y = a[key], b[key]
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), key
        assert a["u_lat"].shape == (PRESET["users"], PRESET["latent"])
        assert a["c_lat"].shape == (PRESET["clusters"], PRESET["latent"])
        assert a["item_cluster"].shape == a["log_pop"].shape == (PRESET["items"],)


def test_teacher_digest_is_chip_smokes_constant(generated):
    """The digest phase 7h checks on the card, computed here from the JAX
    package's teacher, so the constant cannot drift from it."""
    port, jax_dir, _ = generated
    want = re.search(r'^ORACLE3_TEACHER_SHA256 = "([0-9a-f]{64})"$',
                     (ROOT / "chip_smoke.py").read_text(), re.M).group(1)
    assert oracle_parity.teacher_digest(jax_dir / "oracle_teacher.npz") == want
    assert oracle_parity.teacher_digest(port / "oracle_teacher.npz") == want


def test_exact_ranks_equal_jax(generated, rows):
    port, jax_dir, _ = generated
    users, items = rows[0][:EVAL_ROWS], rows[1][:EVAL_ROWS]
    got = oracle.exact_ranks(oracle.OracleTeacher(port / "oracle_teacher.npz"), users, items,
                             batch_size=32, device="cpu")
    ref = jax_oracle.exact_ranks(jax_oracle.OracleTeacher(jax_dir / "oracle_teacher.npz"),
                                 users, items, batch_size=32)
    np.testing.assert_array_equal(got, ref)
    assert got.max() < PRESET["items"] and np.median(got) < PRESET["items"] / 4


def test_plugin_ranks_equal_jax(generated, rows):
    """The plug-in fitted on the other rows, ranked over all 1.2M items.
    The JAX module's per-user table is dense over ``num_users``; its teacher
    is told of the users below the largest one in the rows (rows of other
    users are never read), so the table is not 250k x 256 float64."""
    port, jax_dir, _ = generated
    users, items = rows
    train_u, train_i = users[EVAL_ROWS:], items[EVAL_ROWS:]
    ours = oracle.OracleTeacher(port / "oracle_teacher.npz")
    ref_teacher = jax_oracle.OracleTeacher(jax_dir / "oracle_teacher.npz")
    ref_teacher.num_users = int(users.max()) + 1
    got = oracle.plugin_ranks(ours, train_u, train_i, users[:EVAL_ROWS], items[:EVAL_ROWS],
                              batch_size=32, device="cpu")
    ref = jax_oracle.plugin_ranks(ref_teacher, train_u, train_i, users[:EVAL_ROWS],
                                  items[:EVAL_ROWS], batch_size=32)
    np.testing.assert_array_equal(got, ref)
