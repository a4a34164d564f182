"""Parameter checkpoints (counterpart of cliora_tpu/training/checkpoint.py).

Parameters travel as flat dicts of ``/``-joined paths -> numpy arrays,
the convention of the JAX package's ``flatten``/``unflatten_like``
(cliora_tpu/training/checkpoint.py:57-90) and of its ``.npz``
checkpoints, so a ``.npz`` written by either package loads in the other.
Linear weights use the torch ``(out, in)`` layout in both packages, so
carrying weights across is a rename-free copy: nothing is transposed.

Interop with the reference: it saves ``{'state_dict': <torch
name->tensor>}`` via ``torch.save``; the mapping to our paths is a rename.
The loader keeps the reference's tolerant semantics: strip the DDP
``module.`` prefix, ignore unknown keys, keep current values for missing
keys (a zero-init image encoder survives a DIORA->CLIORA warm start), and
optionally keep the current embedding table (reference:
cliora/net/trainer.py:400-435).

Optimizer state travels in the JAX package's ``.opt.pkl`` format
(cliora_tpu/training/checkpoint.py:112-122): a pickle whose
``jax.tree.leaves`` are Adam's count (an int32 scalar), then ``mu`` of
each trainable parameter in sorted key-path order, then ``nu`` in the
same order.  The JAX loader keeps only those leaves and unflattens them
into its own optax template, so either package's file loads in the
other.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

SEP = "/"

# our path -> reference torch state_dict name (diora core; share=True
# aliases outside_* to the same tensors in the reference state_dict)
_TORCH_NAME = {
    "embed/embeddings": "embed.embeddings.weight",
    "embed/mat": "embed.mat",
    "embed/mat1": "embed.mat1",
    "reconstruct/mat": "reconstruct_softmax_loss.mat",
    "img_encoder/fc/w": "img_encoder.fc.weight",
    "img_encoder/fc/b": "img_encoder.fc.bias",
    "img_encoder/fc_vis/w": "img_encoder.fc_vis.weight",
    "img_encoder/fc_vis/b": "img_encoder.fc_vis.bias",
    "diora/inside_score/mat": "diora.inside_score_func.mat",
    "diora/inside_compose/leaf_fc/w": "diora.inside_compose_func.leaf_fc.weight",
    "diora/inside_compose/leaf_fc/b": "diora.inside_compose_func.leaf_fc.bias",
    "diora/inside_compose/fc0/w": "diora.inside_compose_func.h_fcs.0.weight",
    "diora/inside_compose/fc0/b": "diora.inside_compose_func.h_fcs.0.bias",
    "diora/inside_compose/fc1/w": "diora.inside_compose_func.h_fcs.2.weight",
    "diora/inside_compose/fc1/b": "diora.inside_compose_func.h_fcs.2.bias",
    "diora/outside_score/mat": "diora.outside_score_func.mat",
    "diora/outside_compose/fc0/w": "diora.outside_compose_func.h_fcs.0.weight",
    "diora/outside_compose/fc0/b": "diora.outside_compose_func.h_fcs.0.bias",
    "diora/outside_compose/fc1/w": "diora.outside_compose_func.h_fcs.2.weight",
    "diora/outside_compose/fc1/b": "diora.outside_compose_func.h_fcs.2.bias",
    "diora/root_vector_out_h": "diora.root_vector_out_h",
    "diora/root_mat_out": "diora.root_mat_out",
}

# share=True: the reference state_dict also holds the outside modules,
# aliasing the inside ones
_SHARE_ALIAS = {
    "diora/inside_score/mat": "diora.outside_score_func.mat",
    "diora/inside_compose/fc0/w": "diora.outside_compose_func.h_fcs.0.weight",
    "diora/inside_compose/fc0/b": "diora.outside_compose_func.h_fcs.0.bias",
    "diora/inside_compose/fc1/w": "diora.outside_compose_func.h_fcs.2.weight",
    "diora/inside_compose/fc1/b": "diora.outside_compose_func.h_fcs.2.bias",
    "diora/inside_compose/leaf_fc/w": "diora.outside_compose_func.leaf_fc.weight",
    "diora/inside_compose/leaf_fc/b": "diora.outside_compose_func.leaf_fc.bias",
}


def flatten(params) -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> ``{"a/b/c": np.ndarray}``, copied to the
    host (a CPU tensor's array would change with the next step)."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
        else:
            out[SEP.join(prefix)] = node.detach().to("cpu", copy=True).numpy()

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


def _nest(flat: Dict[str, np.ndarray], leaf) -> dict:
    """Flat ``{"a/b/c": array}`` -> nested dict of ``leaf(f32 array)``."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, name = key.split(SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf(np.asarray(arr, dtype=np.float32))
    return tree


def params_from_numpy(flat: Dict[str, np.ndarray], device) -> dict:
    """Flat ``{"a/b/c": array}`` (e.g. the JAX package's ``flatten`` of
    its params) -> nested dict of float32 tensors on ``device``."""
    return _nest(flat, lambda a: torch.tensor(a, device=device))


def save_params(path: str, params, save_embeddings: bool = True,
                extra: Optional[Dict[str, Any]] = None):
    """Native ``.npz`` checkpoint of flat ``a/b/c`` paths, with ``extra``
    values under ``__extra__/`` keys (reference: trainer.py:383-398
    save_model)."""
    flat = flatten(params)
    if not save_embeddings:
        flat = {k: v for k, v in flat.items() if "embeddings" not in k}
    if extra:
        for k, v in extra.items():
            flat["__extra__" + SEP + k] = np.asarray(v)
    np.savez(path, **flat)


def load_params(path: str, template):
    """Load a native ``.npz`` checkpoint into ``template``'s structure,
    dtypes and device; returns ``(params, missing_keys)``."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__extra__")}
    params, missing, _ = unflatten_like(template, flat)
    return params, missing


def _strip_ddp_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def import_torch_checkpoint(path: str, template,
                            load_embeddings: bool = True):
    """Load a reference ``torch.save({'state_dict': ...})`` checkpoint.

    (reference: cliora/net/trainer.py:400-435 ``Trainer.load_model``)
    Returns ``(params, missing_paths)``.
    """
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = _strip_ddp_prefix(blob["state_dict"])
    flat = {}
    for our_key, torch_key in _TORCH_NAME.items():
        if torch_key not in state_dict:
            continue
        if not load_embeddings and "embeddings" in our_key:
            continue
        flat[our_key] = state_dict[torch_key].detach().float().numpy()
    params, missing, _ = unflatten_like(template, flat)
    return params, missing


def export_torch_checkpoint(path: str, params, save_embeddings: bool = True):
    """Write our params as a reference-compatible torch checkpoint.

    ``share=True`` models (no ``diora/outside_score``) also emit the
    aliased ``outside_*`` names, as the reference state_dict does for its
    shared modules.
    """
    flat = flatten(params)
    shared = "diora/outside_score/mat" not in flat
    state_dict = {}
    for our_key, arr in flat.items():
        if not save_embeddings and "embeddings" in our_key:
            continue
        torch_key = _TORCH_NAME.get(our_key)
        if torch_key is None:
            continue
        state_dict[torch_key] = torch.from_numpy(np.array(arr))
        if shared and our_key in _SHARE_ALIAS:
            state_dict[_SHARE_ALIAS[our_key]] = state_dict[torch_key]
    torch.save({"state_dict": state_dict}, path)


def save_opt_state(path: str, opt_state: Dict[str, Any]):
    """Write ``Trainer.opt_state()`` (``{"count", "mu", "nu"}``, by
    parameter path) as ``(count, mu, nu)``: plain tuples, dicts and numpy
    arrays, whose ``jax.tree.leaves`` (dict keys sorted) are the leaves of
    the JAX package's masked-Adam state in its order."""
    blob = (np.asarray(opt_state["count"], dtype=np.int32),
            _nest(opt_state["mu"], np.asarray),
            _nest(opt_state["nu"], np.asarray))
    with open(path, "wb") as f:
        pickle.dump(blob, f)


class _OptaxState(tuple):
    """Stand-in for an optax state class (a NamedTuple): keeps its fields
    in order; the empty ones (``EmptyState``, ``MaskedNode``) hold no
    leaves."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


_NUMPY_GLOBALS = {
    (mod, name)
    for core in ("numpy.core", "numpy._core")
    for mod, name in ((core + ".multiarray", "_reconstruct"),
                      (core + ".multiarray", "scalar"),
                      (core + ".numeric", "_frombuffer"))
} | {("numpy", "ndarray"), ("numpy", "dtype")}


class _OptStateUnpickler(pickle.Unpickler):
    """Reads numpy arrays, and optax's state classes as stand-ins: optax
    (and with it JAX) is never imported.  Any other class is refused."""

    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            return type(name, (_OptaxState,), {})
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} has no place in an optimizer-state file")


def load_opt_state(path: str) -> Dict[str, Any]:
    """Read an ``.opt.pkl`` written by either package into
    ``{"count": int, "mu": {path: array}, "nu": {path: array}}``, for
    ``Trainer.install_state``.

    The tree is walked in ``jax.tree.leaves`` order (dict keys sorted,
    state fields in order): the one leaf outside a dict is the count, the
    first dict of parameters is ``mu`` and the second ``nu``, each read
    by key path, never by position."""
    with open(path, "rb") as f:
        tree = _OptStateUnpickler(f).load()
    scalars, dicts = [], []

    def flat_dict(prefix, node, out):
        if isinstance(node, dict):
            for k in sorted(node):
                flat_dict(prefix + (str(k),), node[k], out)
        elif isinstance(node, tuple):     # a masked (frozen) leaf: empty
            for x in node:
                flat_dict(prefix, x, out)
        else:
            out[SEP.join(prefix)] = np.asarray(node)

    def walk(node):
        if isinstance(node, dict):
            dicts.append({})
            flat_dict((), node, dicts[-1])
        elif isinstance(node, (tuple, list)):
            for x in node:
                walk(x)
        else:
            scalars.append(np.asarray(node))

    walk(tree)
    if len(scalars) != 1 or scalars[0].ndim != 0 or len(dicts) != 2:
        raise ValueError(
            f"{path}: expected an Adam count and two parameter trees, found "
            f"{len(scalars)} scalars and {len(dicts)} trees")
    return {"count": int(scalars[0]), "mu": dicts[0], "nu": dicts[1]}
