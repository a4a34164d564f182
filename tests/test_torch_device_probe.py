"""The port's card probes (utils/device_probe.py, the counterpart of
cliora_tpu/utils/tpu_probe.py), on the CPU: ``nvidia-smi``'s line is
parsed into the card's name, power limit and count, and a CUDA init that
cannot succeed reports False within its time limit."""

import subprocess

from cliora_tpu_torch.utils import device_probe


def test_card_info_parses_nvidia_smi(monkeypatch):
    out = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
           "NVIDIA H100 80GB HBM3, 700.00 W\n")

    def run(cmd, **kwargs):
        assert cmd == ["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]
        return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")

    monkeypatch.setattr(device_probe.subprocess, "run", run)
    assert device_probe.card_info() == {
        "line": "NVIDIA H100 80GB HBM3, 700.00 W",
        "name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
        "count": 2}


def test_cuda_reachable_false_without_a_card(monkeypatch):
    """This machine has no card: the probe's subprocess fails and the
    probe says so; a probe that outlives its limit says so too."""
    import torch

    assert device_probe.cuda_reachable(timeout_s=120) is \
        torch.cuda.is_available()

    def slow(*args, **kwargs):
        raise subprocess.TimeoutExpired(args[0], kwargs.get("timeout"))

    monkeypatch.setattr(device_probe.subprocess, "run", slow)
    assert device_probe.cuda_reachable(timeout_s=0.1) is False
