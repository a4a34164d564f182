"""The port's bench (cliora_tpu_torch/tools/bench.py) on the CPU, its
console scripts, and the right-branching baseline the grammar
demonstration is held to.

bench.py is read with ``ast``, never imported or run: the tool's workload
must be bench.py's.  The step's FLOP count must be the same whatever
implements the span x region products and in either compute dtype, and
turning the contrastive loss on must add exactly its three span x region
products (scores forward, both gradients), 3 x 2·A·M·C·R·D with
M = L(L+1)/2 spans a sentence and A = C = B.
"""

import ast
import importlib
import json
import math
import os
import pkgutil
import subprocess
import sys
import tomllib

import numpy as np
import pytest

import cliora_tpu_torch
from cliora_tpu_torch.analysis.eval import right_branching_f1
from cliora_tpu_torch.analysis.trees import F1Meter
from cliora_tpu_torch.scripts import common as cli_common
from cliora_tpu_torch.scripts import right_branch
from cliora_tpu_torch.tools import bench, profile_step
from cliora_tpu_torch.utils.flags import argument_parser, parse_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    cliora_tpu_torch.__file__)))
# a tiny bench model: the widths of the FLOP check
TINY = {"D": 16, "E": 16, "V": 50, "K": 5, "R": 36, "F": 32}
TB, TL = 4, 6
PORT_SCRIPTS = {
    "cliora-torch-train": "cliora_tpu_torch.scripts.train:main",
    "cliora-torch-parse": "cliora_tpu_torch.scripts.parse:main",
    "cliora-torch-parse-diora": "cliora_tpu_torch.scripts.parse_diora:main",
    "cliora-torch-export": "cliora_tpu_torch.scripts.export_model:main",
    "cliora-torch-serve": "cliora_tpu_torch.scripts.serve:main",
}


def _bench_py():
    """bench.py's workload constants and config keywords, from its source:
    ``{name: value}`` of its assignments (top level and in ``main``) and
    the keywords of its ``ModelConfig`` and ``TrainConfig`` calls."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    names, calls = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            if isinstance(target, ast.Name):
                names[target.id] = value
            elif isinstance(target, ast.Tuple):
                names.update(zip((t.id for t in target.elts), value))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id in ("ModelConfig", "TrainConfig")):
            calls[node.func.id] = {
                kw.arg: ast.literal_eval(kw.value) for kw in node.keywords
                if isinstance(kw.value, ast.Constant)}
    return names, calls


def test_no_card_line(tmp_path):
    """Without CUDA the tool prints bench.py's fields with value 0.0 and
    an error, exits 0, and names no TPU number."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m",
                          "cliora_tpu_torch.tools.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    assert line["metric"] == "cliora_train_sentences_per_sec_per_card"
    assert line["unit"] == "sentences/sec/card"
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "CUDA" in line["error"]
    assert not any("tpu" in k.lower() for k in line), line


def test_constants_are_bench_py():
    names, calls = _bench_py()
    for k in ("B", "L", "D", "E", "V", "K", "R", "F", "WARMUP", "STEPS",
              "K_CALL", "BASELINE_SENTS_PER_SEC"):
        assert getattr(bench, k) == names[k], k
    assert bench.DTYPE == calls["ModelConfig"]["compute_dtype"]
    assert calls["ModelConfig"]["use_obj"] is True


def test_trainer_config_is_bench_py():
    """The trainer the tool builds (at tiny widths) takes bench.py's lr,
    losses, trainable table and dtype, on the ``cuda`` route where
    bench.py takes ``pallas``."""
    _, calls = _bench_py()
    want = calls["TrainConfig"]
    trainer, batch = profile_step.build(TB, TL, bench.DTYPE, "cpu", "cuda",
                                        **TINY)
    tc, cfg = trainer.tc, trainer.cfg
    assert want["attn_impl"] == "pallas" and tc.attn_impl == "cuda"
    for k in ("lr", "vg_loss", "use_contr", "emb_trainable"):
        assert getattr(tc, k) == want[k], k
    assert cfg.compute_dtype == bench.DTYPE and cfg.use_obj
    assert tc.k_neg == TINY["K"] and cfg.n_regions == TINY["R"]
    assert tuple(batch["sentences"].shape) == (TB, TL)
    assert tuple(batch["obj_feats"].shape) == (TB, TINY["R"], TINY["F"])


@pytest.fixture(scope="module")
def flops():
    return {(impl, dtype): bench.step_flops(TB, TL, dtype, impl, "cpu",
                                            **TINY)
            for impl in ("einsum", "chunked", "cuda")
            for dtype in ("float32", "bfloat16")}


@pytest.mark.parametrize("impl", ["einsum", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_flops_is_the_work(flops, impl, dtype):
    """The count reads the same under every route (on the CPU the ``cuda``
    route's wrappers run their plain versions) and in either dtype."""
    assert flops[(impl, dtype)] == flops[("chunked", "float32")] > 0


def test_step_flops_contrastive_products(flops):
    without = bench.step_flops(TB, TL, "float32", "chunked", "cpu",
                               use_contr=False, **TINY)
    M = TL * (TL + 1) // 2
    products = 3 * 2 * TB * M * TB * TINY["R"] * TINY["D"]
    assert flops[("chunked", "float32")] - without == products


def test_run_on_the_cpu():
    result = bench.run(B=TB, L=TL, steps=10, k_call=5, device="cpu", **TINY)
    for k in ("value", "step_ms", "eager_pipelined_step_ms", "capture_s"):
        assert math.isfinite(result[k]) and result[k] > 0, k
    assert math.isclose(result["value"], 1e3 * TB / result["step_ms"])
    assert result["vs_baseline"] == result["value"] / 2.11
    assert result["mfu_vs_h100_bf16_peak"] is None
    assert "cpu" in result["mfu_note"]
    assert result["device"] == "cpu" and result["power_limit"] is None
    assert result["idle_share"] == "not measured"
    assert result["step_flops"] > 0 and result["loss_finite"]
    assert result["workload"]["timed_steps"] == 10


def test_isolation_scan_takes_up_the_tool():
    """The isolation tests walk every module of the port and scan every
    source under it: the bench is among them, and clean."""
    from test_torch_isolation import _FORBIDDEN, PKG

    mods = {m.name for m in pkgutil.walk_packages(cliora_tpu_torch.__path__,
                                                  "cliora_tpu_torch.")}
    assert "cliora_tpu_torch.tools.bench" in mods
    path = os.path.join(PKG, "tools", "bench.py")
    with open(path) as f:
        assert not _FORBIDDEN.search(f.read())


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_console_script_resolves(name):
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts[name] == PORT_SCRIPTS[name]
    module, func = scripts[name].split(":")
    assert callable(getattr(importlib.import_module(module), func))


_HELP = r"""
import importlib, sys
name, target = sys.argv[1:3]
module, func = target.split(":")
sys.argv = [name, "--help"]
try:
    getattr(importlib.import_module(module), func)()
    code = 0
except SystemExit as e:
    code = e.code or 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "cliora_tpu"))
print(code, bad)
"""


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_console_script_help_without_jax(name):
    out = subprocess.run([sys.executable, "-c", _HELP, name,
                          PORT_SCRIPTS[name]], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stdout


@pytest.fixture(scope="module")
def ptb(tmp_path_factory):
    """The grammar demonstration's corpus at a tenth of its size, by
    tools/make_synthetic_ptb.py, and the options of its validation
    split."""
    root = str(tmp_path_factory.mktemp("synth"))
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tools", "make_synthetic_ptb.py"),
                    root, "300", "50"], check=True, capture_output=True,
                   timeout=120)
    args = ["--data_type", "ptb", "--emb", "w2v",
            "--embeddings_path", os.path.join(root, "glove.txt"),
            "--train_path", os.path.join(root, "train.pkl"),
            "--validation_path", os.path.join(root, "valid.pkl"),
            "--batch_size", "8", "--device", "cpu"]
    return args


def test_right_branching_baseline(ptb, capsys):
    """The baseline scores right-branching trees as the eval scores a
    parse (root dropped, length <= 2 skipped): its sentence F1 is
    scripts/right_branch.py's, whose corpus F1 keeps the reference's
    all-recalled count (1.0); its corpus F1 is a plain span count."""
    options = parse_args(argument_parser(), ptb)
    it = cli_common.get_validation_iterator(
        options, cli_common.get_validation_dataset(options))
    got = right_branching_f1(it, options.seed)
    assert right_branch.run(options) == 1.0
    printed = capsys.readouterr().out.strip().rsplit("sent_f1:", 1)[1]
    assert math.isclose(got["sent_f1"], float(printed), rel_tol=1e-6)
    want = F1Meter()
    rows = 0
    for bm in it.get_iterator(random_seed=options.seed):
        n = bm["length"]
        if n <= 2:
            continue
        for gt in bm["GT"][:bm.get("real_size", bm["batch_size"])]:
            want.update({(i, n - 1) for i in range(1, n - 1)},
                        set(gt[:-1]))
            rows += 1
    assert rows == 50
    assert got == {"corpus_f1": want.corpus_f1, "sent_f1": want.sent_f1}
    assert 0.2 < got["corpus_f1"] < 0.7
