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


def port_init(cfg, tc, vocab: int, seed: int):
    """The port's N(0, 1) init of a full model as a flat dict of numpy
    arrays (no JAX compile), with the zero-init image encoder moved off
    its tied state: every region score ties at zero, and the span x
    region routes split a tie's gradient differently."""
    from cliora_tpu_torch.training.checkpoint import flatten
    from cliora_tpu_torch.training.trainer import Trainer

    flat = flatten(Trainer.build(cfg, tc, vocab, seed=seed,
                                 device="cpu").params)
    rs = np.random.RandomState(seed + 1)
    for k in flat:
        if k.startswith("img_encoder/"):
            flat[k] = (0.01 * rs.randn(*flat[k].shape)).astype(np.float32)
    return flat


def jax_tree(flat):
    """A flat ``{"a/b/c": array}`` dict as the JAX package's nested param
    tree of jax arrays."""
    import jax.numpy as jnp

    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.array(arr)
    return tree


def adam_moved(jax_trainer, steps: int):
    """Per parameter path, the entries whose root-mean-square gradient over
    ``steps`` Adam steps (the bias-corrected second moment of the JAX
    trainer's masked-Adam state) exceeds 1e-6.  Adam moves an entry by
    about lr a step whatever its gradient's size, so the sign of a
    gradient at rounding level is no contract between the packages."""
    from cliora_tpu.training.checkpoint import flatten

    adam = jax_trainer.state.opt_state[1].inner_state[0]
    return {k: np.sqrt(np.asarray(v) / (1 - 0.999 ** steps)) > 1e-6
            for k, v in flatten(adam.nu).items()}
