"""The whole slice: the port's ``Trainer.parse`` + decode vs the JAX
package's ``Trainer.parse`` (``impl='xla'`` and ``impl='pallas'``) from
the same weights."""

import numpy as np
import pytest

from cliora_tpu.analysis.trees import decode_batch as jax_decode_batch
from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.training.checkpoint import flatten
from cliora_tpu.training.trainer import TrainConfig as JaxTrainConfig
from cliora_tpu.training.trainer import Trainer as JaxTrainer
from cliora_tpu_torch.analysis.trees import decode_batch
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.training.checkpoint import params_from_numpy
from cliora_tpu_torch.training.trainer import TrainConfig, Trainer

D, E, V = 16, 24, 40


def _trainers(compute_dtype="float32"):
    jtr = JaxTrainer.build(
        JaxConfig(size=D, input_size=E, compute_dtype=compute_dtype),
        JaxTrainConfig(lr=1e-3, k_neg=5), V, seed=0)
    ttr = Trainer(ModelConfig(size=D, input_size=E,
                              compute_dtype=compute_dtype),
                  TrainConfig(), params_from_numpy(flatten(jtr.params), "cpu"),
                  device="cpu")
    return jtr, ttr


@pytest.fixture(scope="module")
def trainers():
    return _trainers()


def _batch(B, n, seed=0, lengths=False):
    rs = np.random.RandomState(seed)
    batch = {"sentences": rs.randint(2, V, (B, n)),
             "neg_samples": rs.choice(V, 5, replace=False)}
    if lengths:
        batch["lengths"] = rs.randint(2, n + 1, B).astype(np.int32)
    return batch


def _trees(decoded):
    return [t for t, _ in decoded]


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_parse_matches_jax(trainers, jax_impl):
    jtr, ttr = trainers
    batch = _batch(16, 6)       # B % 16 == 0: the Pallas kernel takes it
    want, _ = jtr.parse(batch, outside=False, impl=jax_impl)
    assert want["parse_impl"] == jax_impl
    got, metrics = ttr.parse(batch)
    assert got["parse_impl"] == "plain" and metrics == {}
    np.testing.assert_array_equal(got["cky_bp"], want["cky_bp"])
    got_dec, want_dec = decode_batch(got["cky_bp"], 6), \
        jax_decode_batch(want["cky_bp"], 6)
    assert got_dec == want_dec
    assert _trees(got_dec) == _trees(want_dec)


def test_parse_with_lengths_matches_jax(trainers):
    """Padded bucket: ``lengths`` routes to the plain chart pass (as the
    JAX package's to its XLA pass) and steers the decode."""
    jtr, ttr = trainers
    batch = _batch(8, 9, seed=1, lengths=True)
    want, _ = jtr.parse(batch, outside=False, impl="pallas")
    assert want["parse_impl"] == "xla"
    got, _ = ttr.parse(batch)
    assert got["parse_impl"] == "plain"
    np.testing.assert_array_equal(got["cky_bp"], want["cky_bp"])
    lens = batch["lengths"]
    got_dec = decode_batch(got["cky_bp"], 9, lengths=lens)
    assert got_dec == jax_decode_batch(want["cky_bp"], 9, lengths=lens)
    assert all(t[1][-1] == (0, m - 1) for t, m in zip(got_dec, lens))


def test_parse_bf16_tracks_jax():
    """bf16 charts: route attribution is recorded and the port's trees
    stay close to the JAX XLA route's (near-tie split scores round
    differently across backends)."""
    jtr, ttr = _trainers("bfloat16")
    batch = _batch(16, 8, seed=2)
    want, _ = jtr.parse(batch, outside=False, impl="xla")
    got, _ = ttr.parse(batch)
    assert got["parse_impl"] == "plain"
    assert np.mean(got["cky_bp"] == want["cky_bp"]) >= 0.95


def test_parse_routes_and_refusals(trainers):
    _, ttr = trainers
    batch = _batch(4, 5)
    assert ttr.parse(batch, impl="plain")[0]["parse_impl"] == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        ttr.parse(batch, impl="cuda")
    for kwargs in ({"compute_loss": True}, {"with_chart": True},
                   {"outside": True}):
        with pytest.raises(NotImplementedError, match="slice"):
            ttr.parse(batch, **kwargs)
    with pytest.raises(NotImplementedError, match="CLIORA"):
        ModelConfig(use_obj=True)
    with pytest.raises(ValueError):
        ModelConfig(parse_impl="pallas")


def test_embed_span_matches_jax(trainers):
    import jax.numpy as jnp
    import torch

    from cliora_tpu.models.diora import embed_forward as jax_embed_forward
    from cliora_tpu_torch.models.diora import embed_forward, embed_span

    jtr, ttr = trainers
    tok = _batch(3, 7, seed=4)["sentences"]
    want, _ = jax_embed_forward(jtr.params["embed"], jnp.asarray(tok))
    got = embed_span(ttr.params["embed"], torch.as_tensor(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    full, _ = embed_forward(ttr.params["embed"], torch.as_tensor(tok))
    assert torch.equal(got, full)
