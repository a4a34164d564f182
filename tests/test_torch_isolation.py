"""The port stands alone: it imports neither JAX, optax nor the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
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
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "cliora_tpu"))
print(len(mods), bad)
"""


def test_import_every_module_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    # models/ ops/ training/ analysis/ chart/ native/, and since the CLI
    # slice data/ utils/ scripts/
    assert int(count) >= 40, out.stdout
    assert bad == "[]", bad


_TRAIN_CLI = r"""
import sys
from cliora_tpu_torch.scripts import train
train.main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "cliora_tpu"))
print(bad)
"""


def test_train_cli_runs_without_jax(tmp_path):
    """The port's train CLI, run on the CPU over a small text corpus for
    one epoch (train, checkpoint, eval), imports none of JAX, optax or
    the JAX package."""
    words = [f"w{i}" for i in range(20)]
    rs = np.random.RandomState(0)
    corpus = tmp_path / "train.txt"
    corpus.write_text("".join(
        " ".join(words[i] for i in rs.randint(0, 20, 5)) + "\n"
        for _ in range(12)))
    args = ["--device", "cpu", "--data_type", "txt", "--emb", "none",
            "--train_path", str(corpus), "--validation_path", str(corpus),
            "--experiment_path", str(tmp_path / "exp"), "--hidden_dim", "8",
            "--k_neg", "3", "--batch_size", "4", "--max_epoch", "1"]
    out = subprocess.run([sys.executable, "-c", _TRAIN_CLI, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert (tmp_path / "exp" / "model.epoch_0.npz").exists()


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|optax|cliora_tpu)\b(?!_)"
    r"|from\s+(jax|jaxlib|optax|cliora_tpu)\b(?!_))", re.M)


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


def test_serving_entry_points_need_the_card(tmp_path, monkeypatch):
    """``export_parser``, ``ExportedParser`` and ``make_server`` run on the
    card unless the caller asks for the CPU, and raise without one."""
    from cliora_tpu_torch.scripts.serve import make_server
    from cliora_tpu_torch.serving import (
        ExportedParser,
        export_parser,
        save_bundle,
    )

    cfg = ModelConfig(size=8, input_size=8)
    tr = Trainer.build(cfg, TrainConfig(), 10, seed=0, device="cpu")
    bundle = str(tmp_path / "bundle")
    save_bundle(bundle, cfg, export_parser(cfg, tr.params, [2],
                                           platforms=["cpu"]))
    assert ExportedParser(bundle, device="cpu").parse([[1, 2]]) == [(0, 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_parser(cfg, tr.params, [2])
    with pytest.raises(RuntimeError, match="CUDA"):
        ExportedParser(bundle)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(bundle, port=0, warm=False)
