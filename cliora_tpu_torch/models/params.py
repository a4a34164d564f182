"""Parameter initialization (counterpart of cliora_tpu/models/params.py).

Parameters are nested dicts of tensors with the JAX package's tree and
keys; linear weights use the torch ``(out, in)`` layout.  Every
parameter is drawn from N(0, 1) -- the reference calls
``param.data.normal_()`` on everything after construction
(cliora/net/diora.py:234-237, cliora/net/trainer.py:214-217,41-44).  The
draws come from an explicit ``torch.Generator`` on the CPU, so a seed
gives the same weights on every device; they differ from the JAX
package's ``jax.random`` draws (carry those across with
``training.checkpoint.params_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from cliora_tpu_torch.models.config import ModelConfig


def _normal(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _init_linear(gen, out_dim, in_dim):
    return {"w": _normal(gen, out_dim, in_dim), "b": _normal(gen, out_dim)}


def _init_compose(gen, cfg: ModelConfig, leaf: bool):
    D = cfg.size
    cp = {"fc0": _init_linear(gen, D, 2 * D), "fc1": _init_linear(gen, D, D)}
    if leaf:
        cp["leaf_fc"] = _init_linear(gen, D, D)
    return cp


def init_diora_params(gen, cfg: ModelConfig):
    """(reference: cliora/net/diora.py:453-471 ``DioraMLP.init_parameters``)"""
    D = cfg.size
    dp = {
        "inside_compose": _init_compose(gen, cfg, leaf=True),
        "inside_score": {"mat": _normal(gen, D, D)},
    }
    if not cfg.share:
        dp["outside_compose"] = _init_compose(gen, cfg, leaf=False)
        dp["outside_score"] = {"mat": _normal(gen, D, D)}
    if cfg.compress:
        dp["root_mat_out"] = _normal(gen, D, D)
    else:
        dp["root_vector_out_h"] = _normal(gen, D)
    return dp


def init_embed_params(gen, cfg: ModelConfig, embeddings):
    """Word embedding table + two projections (span / word).

    (reference: cliora/net/trainer.py:204-224 ``Embed``)

    Args:
      embeddings: (V, E) array of pretrained vectors, or an int V to
        create a trainable table ~ N(0,1) (the ``--emb none`` path).
    """
    D = cfg.size
    if isinstance(embeddings, (int, np.integer)):
        table = _normal(gen, int(embeddings), cfg.input_size)
    else:
        table = torch.as_tensor(np.asarray(embeddings), dtype=torch.float32)
        if table.shape[1] != cfg.input_size:
            raise ValueError(f"embeddings width {table.shape[1]} != "
                             f"input_size {cfg.input_size}")
    return {
        "embeddings": table,
        "mat": _normal(gen, D, cfg.input_size),
        "mat1": _normal(gen, D, cfg.input_size),
    }


def init_recon_params(gen, cfg: ModelConfig):
    """(reference: cliora/net/trainer.py:25-44 ReconstructionSoftmaxLoss)"""
    return {"mat": _normal(gen, cfg.size, cfg.input_size)}


def to_device(tree, device):
    """Nested dict of tensors -> the same tree on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_params(gen: torch.Generator, cfg: ModelConfig, embeddings,
                device="cpu"):
    """Full Net parameter tree (reference: cliora/net/trainer.py:227-241).

    Drawn from the CPU generator ``gen``, then moved to ``device``.
    """
    params = {
        "embed": init_embed_params(gen, cfg, embeddings),
        "diora": init_diora_params(gen, cfg),
        "reconstruct": init_recon_params(gen, cfg),
    }
    return to_device(params, device)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
