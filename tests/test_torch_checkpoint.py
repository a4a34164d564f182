"""Parameters: the port's tree, keys and shapes equal the JAX package's,
and the flat-dict path carries weights across unchanged."""

import jax
import numpy as np
import pytest
import torch

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.models.params import init_params as jax_init_params
from cliora_tpu.models.params import param_count as jax_param_count
from cliora_tpu.training.checkpoint import flatten as jax_flatten
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.params import init_params, param_count
from cliora_tpu_torch.training.checkpoint import (
    flatten,
    params_from_numpy,
    unflatten_like,
)
from cliora_tpu_torch.utils.prng import PRNGKey


@pytest.mark.parametrize("share,compress", [(True, False), (False, True)])
def test_init_params_tree_matches_jax(share, compress):
    kw = dict(size=8, input_size=12, share=share, compress=compress)
    got = flatten(init_params(PRNGKey(0), ModelConfig(**kw), 30))
    want_tree = jax_init_params(jax.random.PRNGKey(0), JaxConfig(**kw), 30)
    want = jax_flatten(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
    assert param_count(params_from_numpy(got, "cpu")) == \
        jax_param_count(want_tree)


def test_init_params_is_seeded_and_standard_normal():
    cfg = ModelConfig(size=32, input_size=16)
    a = flatten(init_params(PRNGKey(5), cfg, 200))
    b = flatten(init_params(PRNGKey(5), cfg, 200))
    c = flatten(init_params(PRNGKey(6), cfg, 200))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["embed/mat"], c["embed/mat"])
    allv = np.concatenate([v.ravel() for v in a.values()])
    assert abs(allv.mean()) < 0.02 and abs(allv.std() - 1) < 0.02


def test_pretrained_embeddings_are_kept():
    table = np.arange(30 * 12, dtype=np.float32).reshape(30, 12)
    cfg = ModelConfig(size=8, input_size=12)
    p = init_params(PRNGKey(0), cfg, table)
    np.testing.assert_array_equal(p["embed"]["embeddings"].numpy(), table)
    with pytest.raises(ValueError, match="input_size"):
        init_params(PRNGKey(0), cfg, table[:, :5])


def test_jax_params_round_trip_without_transposes():
    want = jax_flatten(jax_init_params(jax.random.PRNGKey(1),
                                       JaxConfig(size=8, input_size=12), 30))
    tree = params_from_numpy(want, "cpu")
    assert tuple(tree["diora"]["inside_compose"]["fc0"]["w"].shape) == (8, 16)
    got = flatten(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # unflatten_like: missing keys keep the template, extras are ignored
    template = init_params(PRNGKey(0), ModelConfig(size=8, input_size=12),
                           30)
    partial = {k: v for k, v in want.items() if not k.startswith("embed/")}
    partial["unused/key"] = np.zeros(3, np.float32)
    rebuilt, missing, used = unflatten_like(template, partial)
    assert sorted(missing) == ["embed/embeddings", "embed/mat", "embed/mat1"]
    assert sorted(used) == sorted(k for k in want
                                  if not k.startswith("embed/"))
    assert torch.equal(rebuilt["embed"]["mat"], template["embed"]["mat"])
    np.testing.assert_array_equal(rebuilt["diora"]["inside_score"]["mat"],
                                  want["diora/inside_score/mat"])
    with pytest.raises(ValueError, match="shape"):
        unflatten_like(template, {"embed/mat": np.zeros((2, 2), np.float32)})
