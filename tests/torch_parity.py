"""Helpers for the port's parity tests: one parameter set made by the JAX
package, carried into the port through the flat-dict path
(JAX ``init_params`` -> ``flatten`` -> ``params_from_numpy``).

JAX is imported inside the helpers, so a test file that uses them can
still be collected on a machine without JAX (the card's), where its
card-only tests run and its JAX parity tests skip.
"""

import numpy as np


def jax_diora_params(D: int, seed: int, **cfg_kwargs):
    """(JAX diora params, the same weights as port tensors on the CPU)."""
    import jax

    from cliora_tpu.models.config import ModelConfig
    from cliora_tpu.models.params import init_diora_params
    from cliora_tpu.training.checkpoint import flatten
    from cliora_tpu_torch.training.checkpoint import params_from_numpy

    dp = init_diora_params(jax.random.PRNGKey(seed),
                           ModelConfig(size=D, **cfg_kwargs))
    return dp, params_from_numpy(flatten(dp), "cpu")


def leaves(dp_jax, x: np.ndarray) -> np.ndarray:
    """DIORA leaf vectors ``unit_norm(tanh(leaf_fc(x)))`` made by the
    JAX package, as numpy, so both packages start from the same h0."""
    import jax.numpy as jnp

    from cliora_tpu.ops.core import unit_norm

    lf = dp_jax["inside_compose"]["leaf_fc"]
    return np.array(unit_norm(jnp.tanh(x @ lf["w"].T + lf["b"])))
