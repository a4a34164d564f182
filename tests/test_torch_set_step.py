"""``Trainer.set_step`` and the step counters, against the JAX package.

The JAX ``set_step`` sets the host step (and ``TrainState.step``), which
key the dropout stream only; Adam's count lives in the optimizer state
and only ``install_state`` writes it
(cliora_tpu/training/trainer.py:561-571).  A caller's dropout stream
(``step(rng=...)`` there, ``step(generator=...)`` here) advances Adam's
count but not the host step (:657-659).  Both cases start the packages
from one set of weights (``port_init``) and batches; the model is DIORA
at f32, so nothing in the step is random.
"""

import numpy as np
import torch

import jax

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.training import trainer as jt
from cliora_tpu.training.checkpoint import flatten
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.training.checkpoint import flatten as tflatten
from cliora_tpu_torch.training.checkpoint import params_from_numpy
from torch_parity import adam_moved, jax_tree, port_init

D, E, V, K = 16, 24, 50, 5
B, L = 4, 6
LR = 1e-3


def _trainers():
    model, train = dict(size=D, input_size=E), dict(lr=LR, k_neg=K,
                                                   emb_trainable=True)
    cfg, tc = ModelConfig(**model), tt.TrainConfig(**train)
    flat = port_init(cfg, tc, V, seed=6)
    port = tt.Trainer(cfg, tc, params_from_numpy(flat, "cpu"), device="cpu")
    ref = jt.Trainer(JaxConfig(**model), jt.TrainConfig(**train),
                     jax_tree(flat))
    return port, ref


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"sentences": rs.randint(2, V, (B, L)),
            "neg_samples": rs.choice(V, K, replace=False)}


def _jax_count(ref):
    return int(ref.state.opt_state[1].inner_state[0].count)


def _assert_params_match(port, ref, steps):
    """The one-step check's tolerance (tests/test_torch_train_step.py):
    atol 1e-3 * lr on the entries Adam moved."""
    moved = adam_moved(ref, steps)
    want = flatten(ref.params)
    for k, v in tflatten(port.params).items():
        np.testing.assert_allclose(v[moved[k]], want[k][moved[k]],
                                   atol=1e-3 * LR, err_msg=k)


def test_set_step_leaves_adam_count():
    """``set_step(5)`` on fresh trainers, then one step: Adam's count is 1
    in both packages (the port wrote 5 and counted to 6 before, and its
    parameters moved up to 4.8e-4 away from JAX's), the host step 6."""
    port, ref = _trainers()
    port.set_step(5)
    ref.set_step(5)
    assert port.opt_state()["count"] == _jax_count(ref) == 0
    batch = _batch(7)
    port.step(batch)
    ref.step(batch)
    assert port.opt_state()["count"] == _jax_count(ref) == 1
    assert port._host_step == ref._host_step == 6
    _assert_params_match(port, ref, 1)


def test_step_with_callers_stream_keeps_host_step():
    """A step on the caller's dropout stream advances Adam's count and
    leaves the host step where it was, in both packages, with the
    parameters of one step; the next step on the trainer's own stream
    advances both counters (parameters over several steps:
    tests/test_torch_multi_step.py)."""
    port, ref = _trainers()
    port.step(_batch(7), generator=torch.Generator().manual_seed(0))
    ref.step(_batch(7), rng=jax.random.PRNGKey(0))
    assert port._host_step == ref._host_step == 0
    assert port.opt_state()["count"] == _jax_count(ref) == 1
    _assert_params_match(port, ref, 1)
    port.step(_batch(8))
    ref.step(_batch(8))
    assert port._host_step == ref._host_step == 1
    assert port.opt_state()["count"] == _jax_count(ref) == 2
