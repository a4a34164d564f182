"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

import cliora_tpu_torch
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.training.trainer import TrainConfig, Trainer

PKG = os.path.dirname(os.path.abspath(cliora_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)

_IMPORT_ALL = r"""
import pkgutil, sys
import cliora_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cliora_tpu_torch.__path__,
                                              "cliora_tpu_torch.")]
for m in mods:
    __import__(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cliora_tpu"))
print(len(mods), bad)
"""


def test_import_every_module_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15, out.stdout
    assert bad == "[]", bad


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|cliora_tpu)\b(?!_)"
    r"|from\s+(jax|jaxlib|cliora_tpu)\b(?!_))", re.M)


def test_sources_have_no_jax_import():
    paths = [os.path.join(d, f) for d, _, files in os.walk(PKG)
             for f in files if f.endswith(".py")]
    paths.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(paths) >= 16
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not _FORBIDDEN.search(src), path
        assert "cliora_tpu." not in src.replace("cliora_tpu_torch.", ""), path


def test_default_device_is_the_card(monkeypatch):
    """Without ``device`` the trainer runs on CUDA, and raises where there
    is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(size=8, input_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer.build(cfg, TrainConfig(), 10, seed=0)
    tr = Trainer.build(cfg, TrainConfig(), 10, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainConfig(), tr.params)
