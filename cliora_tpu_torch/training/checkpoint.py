"""Flat parameter dicts (counterpart of cliora_tpu/training/checkpoint.py).

Parameters travel as flat dicts of ``/``-joined paths -> numpy arrays,
the convention of the JAX package's ``flatten``/``unflatten_like``
(cliora_tpu/training/checkpoint.py:57-90) and of its ``.npz``
checkpoints.  Linear weights use the torch ``(out, in)`` layout in both
packages, so carrying weights across is a rename-free copy: nothing is
transposed.  Optimizer state and the reference ``.pt`` interop come with
the training slice of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SEP = "/"


def flatten(params) -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> ``{"a/b/c": np.ndarray}`` on the host."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
        else:
            out[SEP.join(prefix)] = node.detach().cpu().numpy()

    walk((), params)
    return out


def unflatten_like(template, flat: Dict[str, np.ndarray]):
    """Rebuild a tree shaped like ``template`` from a flat dict.

    Missing keys keep the template's value; extra keys are ignored.
    Values take the template leaf's dtype and device.
    Returns ``(tree, missing_keys, used_keys)``.
    """
    missing, used = [], []

    def rebuild(prefix, node):
        if isinstance(node, dict):
            return {k: rebuild(prefix + (str(k),), v)
                    for k, v in node.items()}
        key = SEP.join(prefix)
        if key not in flat:
            missing.append(key)
            return node
        used.append(key)
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(
                f"{key}: shape {arr.shape} != {tuple(node.shape)}")
        return torch.tensor(arr, dtype=node.dtype, device=node.device)

    return rebuild((), template), missing, used


def params_from_numpy(flat: Dict[str, np.ndarray], device) -> dict:
    """Flat ``{"a/b/c": array}`` (e.g. the JAX package's ``flatten`` of
    its params) -> nested dict of float32 tensors on ``device``."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split(SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.tensor(np.asarray(arr, dtype=np.float32),
                                  device=device)
    return tree
