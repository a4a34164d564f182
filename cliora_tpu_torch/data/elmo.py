"""Context-insensitive ELMo character-CNN in PyTorch.

The port's counterpart of cliora_tpu/data/elmo.py (reference:
cliora/external/standalone_elmo.py:244-583): the char-id mapping, the
char embedding, width-N convolutions + max-pool, highway layers and the
linear projection to 512.  Weights load from the standard ELMo hdf5 file
+ options json (:func:`load_weights`, which alone needs ``h5py``).  Each
vocab word is embedded independently, so sentence-boundary handling
reduces to the special ``<S>``/``</S>`` char sequences.  The
convolutions and GEMMs are library calls, as the JAX package leaves
them to XLA; :func:`embed_tokens` runs on the card unless asked for the
CPU.  The convolutions run without TF32 (:func:`encode_chars`), so the
card's vectors keep f32 agreement with the CPU's and the JAX package's.
"""

from __future__ import annotations

import contextlib
import json
from typing import Dict, List

import numpy as np
import torch

MAX_WORD_LENGTH = 50
BOS_CHAR = 258   # <begin word>
EOW_CHAR = 259   # <end word>
PAD_CHAR = 260
BOS_SENT_CHAR = 256
EOS_SENT_CHAR = 257


def _special_word(first_char: int) -> List[int]:
    ids = [PAD_CHAR] * MAX_WORD_LENGTH
    ids[0] = BOS_CHAR
    ids[1] = first_char
    ids[2] = EOW_CHAR
    return ids


def word_to_char_ids(word: str) -> List[int]:
    """utf-8 bytes framed by begin/end-of-word chars, padded to 50.

    (reference: standalone_elmo.py:285-307; ids are +1-shifted at lookup
    time so 0 is the mask row)
    """
    if word == "<S>":
        return _special_word(BOS_SENT_CHAR)
    if word == "</S>":
        return _special_word(EOS_SENT_CHAR)
    encoded = word.encode("utf-8", "ignore")[: MAX_WORD_LENGTH - 2]
    ids = [PAD_CHAR] * MAX_WORD_LENGTH
    ids[0] = BOS_CHAR
    for i, b in enumerate(encoded):
        ids[i + 1] = b
    ids[len(encoded) + 1] = EOW_CHAR
    return ids


def load_weights(options_path: str, weights_path: str) -> Dict:
    """Read the ELMo hdf5 into a plain dict of float32 arrays.

    Same tensor surgery as the reference loader (transposes, the tf->torch
    highway sign flip, zero row 0 of the char table):
    standalone_elmo.py:495-583.  ``convs[i]["w"]`` is ``(width, E,
    num)``, the JAX package's layout.
    """
    import h5py

    with open(options_path) as f:
        options = json.load(f)
    cnn = options["char_cnn"]
    out_dim = options["lstm"]["projection_dim"]

    with h5py.File(weights_path, "r") as f:
        char_embed = f["char_embed"][...]
        table = np.zeros((char_embed.shape[0] + 1, char_embed.shape[1]),
                         np.float32)
        table[1:] = char_embed

        convs = []
        for i, (width, num) in enumerate(cnn["filters"]):
            w = f["CNN"][f"W_cnn_{i}"][...]   # (1, width, embed, num)
            b = f["CNN"][f"b_cnn_{i}"][...]
            convs.append({
                "w": np.asarray(w.squeeze(0), np.float32),  # (width, E, num)
                "b": np.asarray(b, np.float32),
                "width": width,
            })

        highways = []
        for k in range(cnn["n_highway"]):
            g = f[f"CNN_high_{k}"]
            highways.append({
                "w_t": np.asarray(g["W_transform"][...], np.float32),
                "b_t": np.asarray(g["b_transform"][...], np.float32),
                # tf gate convention is flipped vs. the torch port
                "w_c": np.asarray(-g["W_carry"][...], np.float32),
                "b_c": np.asarray(-g["b_carry"][...], np.float32),
            })

        proj = {
            "w": np.asarray(f["CNN_proj"]["W_proj"][...], np.float32),
            "b": np.asarray(f["CNN_proj"]["b_proj"][...], np.float32),
        }

    return {"table": table, "convs": convs, "highways": highways,
            "proj": proj, "activation": cnn["activation"],
            "out_dim": out_dim}


def to_device(weights: Dict, device) -> Dict:
    """:func:`load_weights`'s dict with every array a float32 tensor on
    ``device`` (each conv's weight as ``conv1d`` takes it, ``(num, E,
    width)``)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "table": t(weights["table"]),
        "convs": [{"w": t(c["w"]).permute(2, 1, 0).contiguous(),
                   "b": t(c["b"])} for c in weights["convs"]],
        "highways": [{k: t(v) for k, v in hw.items()}
                     for hw in weights["highways"]],
        "proj": {k: t(v) for k, v in weights["proj"].items()},
        "activation": weights["activation"],
        "out_dim": weights["out_dim"],
    }


@contextlib.contextmanager
def _f32_convolutions():
    """cuDNN's convolutions in full f32 inside the block.  torch runs them
    in TF32 by default (``torch.backends.cudnn.allow_tf32`` is True),
    which keeps 10 mantissa bits; the caller's setting is restored after.
    (``torch.backends.cudnn.flags`` would also reset the flags it is not
    given, ``enabled`` among them.)  The setting is the process's, so a
    convolution on another thread inside the block runs without TF32
    too."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


def encode_chars(weights: Dict, char_ids: torch.Tensor) -> torch.Tensor:
    """(N, 50) raw char ids (pre-shift) -> (N, out_dim) embeddings, f32.

    ``weights``: :func:`to_device`'s dict on ``char_ids``' device.  Char
    table lookup with the +1 shift, one valid convolution per filter
    width (bias added, without TF32 on the card) with a max over
    positions and the activation, highways ``g * h + (1 - g) * relu(h W_t
    + b_t)`` with the sigmoid gate ``g`` of the flipped carry weights,
    then the projection.  (cliora_tpu/data/elmo.py:106-135)
    """
    act = torch.tanh if weights["activation"] == "tanh" else torch.relu
    x = weights["table"][char_ids.long() + 1]           # (N, 50, E)
    x = x.transpose(1, 2)                               # (N, E, 50)
    feats = []
    for conv in weights["convs"]:
        with _f32_convolutions():
            y = torch.nn.functional.conv1d(x, conv["w"], conv["b"])
        feats.append(act(torch.amax(y, dim=-1)))        # (N, num)
    h = torch.cat(feats, dim=-1)
    for hw in weights["highways"]:
        nonlinear = torch.relu(h @ hw["w_t"] + hw["b_t"])
        gate = torch.sigmoid(h @ hw["w_c"] + hw["b_c"])
        h = gate * h + (1.0 - gate) * nonlinear
    return h @ weights["proj"]["w"] + weights["proj"]["b"]


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the ELMo encoder runs on the GPU unless the "
            "caller asks for the CPU (device='cpu')")
    return torch.device("cuda", torch.cuda.current_device())


@torch.no_grad()
def embed_with(weights: Dict, tokens: List[str], batch_size: int = 1024,
               device=None) -> np.ndarray:
    """Embed a token list with in-memory weights (:func:`load_weights`'s
    form) -> (len(tokens), out_dim) float32, ``batch_size`` words a call,
    on ``device`` (default: the current card)."""
    dev = _device(device)
    w = to_device(weights, dev)
    out = np.zeros((len(tokens), weights["out_dim"]), np.float32)
    for start in range(0, len(tokens), batch_size):
        chunk = tokens[start:start + batch_size]
        ids = torch.as_tensor(np.asarray([word_to_char_ids(t) for t in chunk],
                                         np.int64), device=dev)
        out[start:start + len(chunk)] = encode_chars(w, ids).cpu().numpy()
    return out


def embed_tokens(tokens: List[str], options_path: str, weights_path: str,
                 batch_size: int = 1024, device=None) -> np.ndarray:
    """Embed a token list -> (len(tokens), 512) float32 from the weight
    files, on ``device`` (default: the current card).

    (reference: cliora/data/embeddings.py:46-109 ``ElmoEmbedder.__call__``,
    which embeds each word as its own sentence)
    """
    return embed_with(load_weights(options_path, weights_path), tokens,
                      batch_size=batch_size, device=device)

