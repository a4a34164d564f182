"""A seed names one initial model in both packages: the port's numpy copy
of ``jax.random`` (cliora_tpu_torch/utils/prng.py) against ``jax.random``
itself, and the port's ``init_params`` / ``Trainer.build`` from a seed
against the JAX package's.

Keys, raw bits and uniforms must be equal bit for bit.  Normals and
every initial parameter may differ by ``INIT_ULP`` ulp (chip_smoke.py's:
XLA's f32 ``log1p`` inside ``erf_inv`` against the port's f64 one
rounded to f32) and must be bit-equal for at least ``BIT_EQUAL_MIN`` of
the values.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.models.params import init_params as jax_init_params
from cliora_tpu.training import trainer as jt
from cliora_tpu.training.checkpoint import flatten as jax_flatten
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.params import init_params
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.training.checkpoint import flatten
from cliora_tpu_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from chip_smoke import INIT_ULP  # noqa: E402
from chip_smoke import ulp_distance as _ulp  # noqa: E402

SEEDS = [0, 11, 2**31 - 1, 2**32 + 5, -1]
# odd shapes, one of more than 2**16 elements, and one of more than a
# chunk of prng.normal (2**20), drawn on several threads
SHAPES = [(1,), (7,), (3, 5), (2, 3, 5), (257, 263), (1025, 1031)]
BIT_EQUAL_MIN = 0.98


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_are_jax_random_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    got_key = prng.PRNGKey(seed)
    assert got_key.dtype == np.uint32
    np.testing.assert_array_equal(got_key, np.asarray(key))
    for num in (2, 3, 6, (2, 3)):
        np.testing.assert_array_equal(prng.split(got_key, num),
                                      np.asarray(jax.random.split(key, num)))
    # a split of a split: keys whose high word is not 0
    sub, got_sub = jax.random.split(key)[1], prng.split(got_key)[1]
    np.testing.assert_array_equal(prng.split(got_sub, 5),
                                  np.asarray(jax.random.split(sub, 5)))
    for shape in SHAPES:
        np.testing.assert_array_equal(prng.bits(got_sub, shape),
                                      np.asarray(jax.random.bits(sub, shape)))
        np.testing.assert_array_equal(
            prng.uniform(got_sub, shape),
            np.asarray(jax.random.uniform(sub, shape)))
        np.testing.assert_array_equal(
            prng.uniform(got_sub, shape, -3.7, 5.1),
            np.asarray(jax.random.uniform(sub, shape, minval=-3.7,
                                          maxval=5.1)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normals_are_jax_random_within_ulp(seed):
    key = prng.split(prng.PRNGKey(seed))[0]
    for shape in SHAPES:
        got = prng.normal(key, shape)
        want = np.asarray(jax.random.normal(jnp.asarray(key), shape))
        assert got.dtype == np.float32 and got.shape == want.shape
        ulp = _ulp(got, want)
        assert ulp.max() <= INIT_ULP, (shape, ulp.max())
        if got.size > 2**16:
            assert np.mean(ulp == 0) >= BIT_EQUAL_MIN, np.mean(ulp == 0)


def test_erf_inv_is_xlas_at_the_edges():
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.array([-1, lo, -0.5, -1e-30, 0, 1e-7, 0.25, 0.9999, -lo, 1],
                 np.float32)
    got = prng.erf_inv(x)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[[0, -1]], [-np.inf, np.inf])
    finite = ~np.isinf(want)
    assert _ulp(got[finite], want[finite]).max() <= INIT_ULP


_OBJ = dict(use_obj=True, n_regions=4, obj_feat_size=12)
INIT_CASES = {
    "mlp_share": dict(share=True),
    "mlp_no_share": dict(share=False),
    "compress": dict(share=False, compress=True),
    "treelstm": dict(arch="treelstm", share=False),
    "word": dict(arch="word", **_OBJ),
    "use_obj": dict(**_OBJ),
    "pretrained": dict(share=False),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_params_from_a_seed_is_the_jax_packages(case):
    """Every leaf of the port's init within INIT_ULP of the JAX package's
    from the same seed (the split tree followed, unused keys included)."""
    kw = dict(size=24, input_size=20, **INIT_CASES[case])
    vocab = 300
    emb = (np.random.RandomState(3).randn(vocab, 20).astype(np.float32)
           if case == "pretrained" else vocab)
    got = flatten(init_params(prng.PRNGKey(7), ModelConfig(**kw), emb))
    want = jax_flatten(jax_init_params(jax.random.PRNGKey(7),
                                       JaxConfig(**kw), emb))
    assert sorted(got) == sorted(want)
    ulp = []
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        ulp.append(_ulp(got[k], want[k]).ravel())
        assert ulp[-1].max() <= INIT_ULP, (k, ulp[-1].max())
    assert np.mean(np.concatenate(ulp) == 0) >= BIT_EQUAL_MIN
    if case == "pretrained":
        # the table's key is split off and left unused, as in JAX
        np.testing.assert_array_equal(got["embed/embeddings"], emb)
        drawn = flatten(init_params(prng.PRNGKey(7), ModelConfig(**kw),
                                    vocab))
        for k in got:
            if k != "embed/embeddings":
                np.testing.assert_array_equal(got[k], drawn[k], err_msg=k)


def test_trainer_build_from_a_seed_is_the_jax_packages():
    kw = dict(size=16, input_size=12, share=False, **_OBJ)
    got = flatten(tt.Trainer.build(ModelConfig(**kw), tt.TrainConfig(), 50,
                                   seed=11, device="cpu").params)
    want = jax_flatten(jt.Trainer.build(JaxConfig(**kw), jt.TrainConfig(),
                                        50, seed=11).params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _ulp(got[k], want[k]).max() <= INIT_ULP, k


def test_grammar_init_is_the_fixture_with_the_pinned_digest():
    """The port's seed-11 init of the README's grammar demonstration, as
    its train CLI builds it, against the JAX package's
    (tests/data/grammar_jax_init.npz), and the digest of its bits that
    chip_smoke.py's ``learn`` phase checks on the card's host."""
    got = chip_smoke.grammar_init("cpu")
    with np.load(chip_smoke.GRAMMAR_JAX_INIT) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    ulp = np.concatenate([_ulp(got[k], want[k]).ravel()
                          for k in sorted(want)])
    assert ulp.max() <= INIT_ULP
    assert np.mean(ulp == 0) >= BIT_EQUAL_MIN
    assert chip_smoke.init_digest(got) == chip_smoke.GRAMMAR_INIT_SHA256
