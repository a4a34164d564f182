"""Data- and tensor-parallel cases of the port, run by gloo workers and
by the tests' one-process references (tests/test_torch_parallel.py,
tests/test_torch_multihost.py, tests/test_torch_dist_ckpt.py,
tests/test_torch_tp.py, tests/test_torch_tp_ckpt.py).

A worker is this file run as a script, ``python torch_dp.py OUT RANK
WORLD PORT GROUP``: it joins a gloo group on localhost, runs the cases
of ``GROUP`` on its rows of each global batch, and writes what it saw to
``OUT/rank{RANK}.npz``.  It imports torch and the port only.  The
``tp*`` groups lay the world out as a ``dp x mp`` grid with ``mp = 2``.
"""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

D, E, V, R, F, K = 16, 24, 50, 3, 16, 5
B, L = 8, 6             # the global batch; 4 rows a rank at world 2
LR = 1e-3
STEPS = 3


def case_configs(name):
    """(ModelConfig kwargs, TrainConfig kwargs, lengths or not) of a
    case.  ``cliora*``: VG + contrastive; ``_einsum``: the materialized
    scores, else the fused ``cuda`` route (its plain version on the
    CPU); ``_lengths``: padded rows; ``_dropout``: attention dropout
    0.1; ``_accum``: two microbatches; ``_zero1``: ZeRO-1;
    ``_treelstm``, ``_word``: those archs; ``_remat_<policy>``: the chart
    levels rematerialized under that policy; ``_1step``: one batch, not
    ``STEPS``."""
    model = dict(size=D, input_size=E)
    train = dict(lr=LR, k_neg=K, emb_trainable=True, attn_impl="cuda")
    if name.startswith("cliora"):
        model.update(use_obj=True, n_regions=R, obj_feat_size=F,
                     attn_dropout=0.1 if "_dropout" in name else 0.0)
        train.update(vg_loss=True, use_contr=True)
    if "_einsum" in name:
        train["attn_impl"] = "einsum"
    if "_accum" in name:
        train["accum_steps"] = 2
    if "_zero1" in name:
        train["zero1"] = True
    for arch in ("treelstm", "word"):
        if f"_{arch}" in name:
            model["arch"] = arch
    if "_remat_" in name:
        model.update(remat=True, remat_policy=name.split("_remat_")[1])
    return model, train, "_lengths" in name


def configs(name):
    from cliora_tpu_torch.models.config import ModelConfig
    from cliora_tpu_torch.training.trainer import TrainConfig

    model, train, _ = case_configs(name)
    return ModelConfig(**model), TrainConfig(**train)


def batches(name, steps=STEPS, seed=3):
    """The case's global batches (numpy).  Every row's image differs, so
    a gradient that reaches the wrong rank's image shows."""
    _, _, with_lengths = case_configs(name)
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(1 if "_1step" in name else steps):
        b = {"sentences": rs.randint(2, V, (B, L)),
             "neg_samples": rs.choice(V, K, replace=False)}
        if name.startswith("cliora"):
            b["obj_feats"] = rs.randn(B, R, F).astype(np.float32)
        if with_lengths:
            b["lengths"] = rs.randint(3, L + 1, B)
        out.append(b)
    return out


def init_flat(name, seed=5):
    sys.path.insert(0, HERE)
    from torch_parity import port_init

    cfg, tc = configs(name)
    return port_init(cfg, tc, V, seed=seed)


def trainer(name, mesh=None, flat=None):
    from cliora_tpu_torch.training.checkpoint import params_from_numpy
    from cliora_tpu_torch.training.trainer import Trainer

    cfg, tc = configs(name)
    flat = init_flat(name) if flat is None else flat
    return Trainer(cfg, tc, params_from_numpy(flat, "cpu"), device="cpu",
                   mesh=mesh)


def run_case(name, mesh=None, grouped=False):
    """Train the case for ``STEPS`` steps on this rank's rows (all rows
    without a mesh); returns ``(losses (steps, metrics), names, flat
    params, opt_state, trainer)``."""
    from cliora_tpu_torch.parallel.mesh import shard_batch
    from cliora_tpu_torch.training.checkpoint import flatten

    tr = trainer(name, mesh)
    mine = [shard_batch(mesh, b) for b in batches(name)]
    ms = tr.steps(mine) if grouped else [tr.step(b) for b in mine]
    names = sorted(ms[0])
    losses = np.array([[float(m[k]) for k in names] for m in ms])
    return losses, names, flatten(tr.full_params()), tr.opt_state(), tr


# -- the worker -------------------------------------------------------------

def _save(out, rank, rec):
    np.savez(os.path.join(out, f"rank{rank}.npz"), **rec)


def _case_record(rec, tag, losses, names, flat, opt):
    rec[f"{tag}/losses"] = losses
    rec[f"{tag}/names"] = np.array(names)
    for k, v in flat.items():
        rec[f"{tag}/param/{k}"] = v
    rec[f"{tag}/opt/count"] = np.array(opt["count"])
    for part in ("mu", "nu"):
        for k, v in opt[part].items():
            rec[f"{tag}/opt/{part}/{k}"] = v



def join(rank, world, port, mp=1):
    """Join the gloo group of the worker launch; returns its mesh."""
    from cliora_tpu_torch.parallel.mesh import make_mesh
    from cliora_tpu_torch.parallel.multihost import initialize_multihost

    assert initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    return make_mesh(world, mp=mp)


PARALLEL_CASES = ("diora", "cliora", "cliora_lengths", "cliora_einsum",
                  "cliora_dropout", "cliora_accum", "cliora_zero1",
                  "cliora_lengths_zero1")


def group_parallel(out, rank, world, port, rec):
    """tests/test_torch_parallel.py: every dp case, then ZeRO-1's
    ``install_state`` of its own state, which must keep the shards."""
    mesh = join(rank, world, port)
    for name in PARALLEL_CASES:
        losses, names, flat, opt, tr = run_case(name, mesh)
        _case_record(rec, name, losses, names, flat, opt)
        if name == "cliora_zero1":
            st = tr.zero1.state
            before = [st[k].clone() for k in ("exp_avg", "exp_avg_sq")]
            tr.install_state(dict(_tree_items(tr.params)), opt)
            rec["zero1_install_equal"] = np.array(all(
                bool((a == st[k]).all()) for a, k in
                zip(before, ("exp_avg", "exp_avg_sq"))))
            rec["zero1_slice_len"] = np.array(tr.zero1.slice_len)


def _tree_items(params):
    from cliora_tpu_torch.training.trainer import tree_leaves, tree_paths

    return list(zip(tree_paths(params),
                    [p.detach().clone() for p in tree_leaves(params)]))


def eval_batches(seed=7, n=5):
    """An odd number of validation batches (the ranks' shares differ),
    one of length 2 (skipped), with gold spans."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        n_words = 2 if i == 1 else L
        out.append({"sentences": rs.randint(2, V, (4, n_words)),
                    "batch_size": 4, "length": n_words,
                    "neg_samples": rs.choice(V, K, replace=False),
                    "GT": [[(0, 2), (3, n_words - 1), (0, n_words - 1)]
                           for _ in range(4)]})
    return out


class ListIterator:
    def __init__(self, batches):
        self.batches = batches

    def get_iterator(self, random_seed=None):
        return iter(self.batches)


def group_multihost(out, rank, world, port, rec):
    """tests/test_torch_multihost.py: the rendezvous, ``Trainer.steps`` on
    the CPU, and the distributed ``run_eval``."""
    import torch
    import torch.distributed as dist

    from cliora_tpu_torch.analysis.eval import run_eval
    from cliora_tpu_torch.parallel.multihost import (
        initialize_multihost,
        is_chief,
    )

    mesh = join(rank, world, port)
    # idempotent: a second call joins nothing new
    assert initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    x = torch.full((2,), float(rank + 1))
    dist.all_reduce(x)
    rec["all_reduce"] = x.numpy()
    rec["is_chief"] = np.array(is_chief())
    rec["rank"] = np.array(dist.get_rank())
    for grouped in (False, True):
        losses, names, flat, _, tr = run_case("cliora", mesh, grouped)
        _case_record(rec, f"steps_{grouped}", losses, names, flat,
                     tr.opt_state())
    tr = run_case("diora", mesh)[-1]
    metrics = run_eval(tr, ListIterator(eval_batches()))
    for k, v in metrics.items():
        rec[f"eval/{k}"] = np.array(v)


def write_corpus(root, n_train=32, n_test=8, length=5, seed=0):
    """A Flickr-layout text corpus of one sentence length (full batches
    of 8), with gold trees (tests/test_multihost.py's)."""
    import json
    import pickle

    words = ["_PAD", "<unk>", "a", "dog", "cat", "runs", "fast", "the",
             "big", "red"]
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for split, n_sent in (("train", n_train), ("test", n_test)):
        lines, ids = [], []
        for i in range(n_sent):
            sent = " ".join(words[rs.randint(2, len(words))]
                            for _ in range(length))
            gold = ([(j, length - 1) for j in range(length - 2, 0, -1)]
                    + [(0, length - 1)])
            lines.append(json.dumps([sent, gold]))
            ids.append(f"{100 + i}\t0")
        with open(os.path.join(root, f"flickr_{split}.json"), "w") as f:
            f.write("\n".join(lines))
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids))
        if split == "test":
            anno = {f"{100 + i}_0": [
                {"phr0": (0, 2, [0.0, 0.0, 10.0, 10.0])}, [1, 1]]
                for i in range(n_sent)}
            with open(os.path.join(root, f"gt_anno_{split}.pkl"),
                      "wb") as f:
                pickle.dump(anno, f)
    with open(os.path.join(root, "flickr.dic.json"), "w") as f:
        json.dump({w: i for i, w in enumerate(words)}, f)


def cli_flags(corpus, extra=()):
    return ["--data_type", "flickr", "--emb", "none",
            "--train_path", os.path.join(corpus, "flickr_train.json"),
            "--validation_path", os.path.join(corpus, "flickr_test.json"),
            "--hidden_dim", "16", "--k_neg", "4", "--batch_size", "8",
            "--validation_batch_size", "4", "--lr", "1e-3", "--seed", "3",
            "--device", "cpu", "--log_every_batch", "100", *extra]


def group_cli(out, rank, world, port, rec, extra=()):
    """tests/test_torch_multihost.py: the train CLI in ``world``
    processes with ``--zero1`` and the ``extra`` flags (the corpus is
    written beforehand): two epochs, then every rank resumes from the
    chief's epoch-0 files and runs the second epoch again."""
    import torch.distributed as dist

    from cliora_tpu_torch.scripts import train

    corpus = os.path.join(out, "corpus")
    dist_flags = ["--world_size", str(world), "--local_rank", str(rank),
                  "--master_addr", "127.0.0.1", "--master_port", str(port),
                  "--n_devices", str(world), "--zero1", *extra]
    exp1, exp2 = os.path.join(out, "exp1"), os.path.join(out, "exp2")
    _, r1 = train.main(cli_flags(corpus, dist_flags + [
        "--experiment_path", exp1, "--max_epoch", "2"]))
    dist.barrier()
    _, r2 = train.main(cli_flags(corpus, dist_flags + [
        "--experiment_path", exp2, "--max_epoch", "2",
        "--resume", os.path.join(exp1, "model.epoch_0.npz")]))
    rec["epochs"] = np.array([r["epoch"] for r in r1 + r2])
    rec["f1"] = np.array([r["metrics"]["corpus_f1"] for r in r1 + r2])


def group_dist_ckpt(out, rank, world, port, rec):
    """tests/test_torch_dist_ckpt.py: a ZeRO-1 CLIORA trainer saved at
    this world size after two steps (one DCP directory, each rank its
    slice of Adam's state), and the state it saved."""
    from cliora_tpu_torch.parallel.mesh import shard_batch
    from cliora_tpu_torch.training.checkpoint import flatten
    from cliora_tpu_torch.training.dist_ckpt import save_state

    mesh = join(rank, world, port)
    tr = trainer("cliora_zero1", mesh)
    for b in batches("cliora_zero1")[:2]:
        tr.step(shard_batch(mesh, b))
    save_state(os.path.join(out, "zero1.dcp"), tr)
    _case_record(rec, "saved", np.zeros((1, 1)), ["none"],
                 flatten(tr.params), tr.opt_state())


# -- tensor parallelism ------------------------------------------------------

MP = 2
TP_CASES = ("diora", "cliora", "cliora_zero1", "diora_zero1")
# cases of the two-rank (1, 2) grid only
TP_MORE_CASES = ("cliora_treelstm_1step", "cliora_word", "cliora_dropout",
                 "cliora_dropout_remat_full", "cliora_dropout_remat_dots",
                 "cliora_dropout_remat_gathers")


def tp_ops_inputs(seed=13):
    """Whole weights and inputs of the sharded ops at the small width
    (numpy, the same on every rank)."""
    rs = np.random.RandomState(seed)

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)

    return {"fc0/w": f(D, 2 * D), "fc0/b": f(D), "fc1/w": f(D, D),
            "fc1/b": f(D), "mat": f(D, D), "l": f(B, 7, D), "r": f(B, 7, D),
            "table": f(V, E), "emat": f(D, E), "emat1": f(D, E),
            "tokens": rs.randint(0, V, (B, L)),
            "neg": rs.choice(V, K, replace=False), "img_w": f(D, F),
            "img_b": f(D), "img_vw": f(D, F), "img_vb": f(D),
            "feats": f(B, R, F), "out_h": f(B, 21, D), "g": f(B, 7, D)}


def tp_ops(mesh):
    """Each sharded op of parallel/sharding.py's list, on whole inputs:
    ``{op: (outputs, {input or weight: gradient})}`` of a scalar of the
    outputs; with a ``mesh`` the weights are the rank's slices and each
    weight's gradient is gathered whole (an input's is the rank's, which
    ``copy_to_mp`` makes whole)."""
    import torch

    from cliora_tpu_torch.models.diora import (
        embed_forward,
        image_encoder_forward,
    )
    from cliora_tpu_torch.ops.core import bilinear, compose_mlp
    from cliora_tpu_torch.parallel.sharding import (
        copy_to_mp,
        gather_mp,
        mp_slice,
    )
    from cliora_tpu_torch.training.losses import reconstruction_loss

    x = tp_ops_inputs()

    def t(k, dim=None):
        v = torch.tensor(x[k])
        if mesh is not None and dim is not None:
            v = mp_slice(v, mesh, dim).contiguous()
        return v.requires_grad_(v.is_floating_point())

    def whole(v, dim):
        g = v.grad
        return g if mesh is None or dim is None else gather_mp(g, mesh, dim)

    def copied(v):
        return copy_to_mp(v, mesh)

    out = {}
    w0, b0, w1, b1 = t("fc0/w", 0), t("fc0/b", 0), t("fc1/w", 1), t("fc1/b")
    l, r = t("l"), t("r")
    h = compose_mlp({"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}},
                    copied(l), copied(r), mp=mesh)
    (h * torch.tensor(x["g"])).sum().backward()
    out["compose"] = (h, {"fc0/w": whole(w0, 0), "fc0/b": whole(b0, 0),
                          "fc1/w": whole(w1, 1), "fc1/b": b1.grad,
                          "l": l.grad, "r": r.grad})
    mat, l, r = t("mat", 1), t("l"), t("r")
    s = bilinear(mat, copied(l), copied(r), mp=mesh)
    (s * s).sum().backward()
    out["bilinear"] = (s, {"mat": whole(mat, 1), "l": l.grad, "r": r.grad})
    table, m0, m1 = t("table", 1), t("emat", 1), t("emat1", 1)
    tok = torch.tensor(x["tokens"])
    xs, xw = embed_forward({"embeddings": table, "mat": m0, "mat1": m1},
                           tok, mp=mesh)
    (xs.square().sum() + (xw * xs).sum()).backward()
    out["embed"] = (torch.stack([xs, xw]), {
        "embeddings": whole(table, 1), "mat": whole(m0, 1),
        "mat1": whole(m1, 1)})
    iw, ib, vw, vb = t("img_w", 1), t("img_b"), t("img_vw", 1), t("img_vb")
    os_, ow = image_encoder_forward(
        {"fc": {"w": iw, "b": ib}, "fc_vis": {"w": vw, "b": vb}},
        torch.tensor(x["feats"]), mp=mesh)
    (os_.square().sum() + (ow * os_).sum()).backward()
    out["image_encoder"] = (torch.stack([os_, ow]), {
        "fc/w": whole(iw, 1), "fc/b": ib.grad, "fc_vis/w": whole(vw, 1),
        "fc_vis/b": vb.grad})
    table, rmat, oh = t("table", 1), t("emat", 1), t("out_h")
    loss = reconstruction_loss({"mat": rmat}, table, tok,
                               torch.tensor(x["neg"]), oh, mp=mesh)
    loss.backward()
    out["reconstruction"] = (loss, {"embeddings": whole(table, 1),
                                    "mat": whole(rmat, 1), "outside_h":
                                    oh.grad})
    return out


def _ops_record(rec, tag, ops):
    for op, (val, grads) in ops.items():
        rec[f"{tag}/{op}/out"] = val.detach().numpy()
        for k, g in grads.items():
            rec[f"{tag}/{op}/grad/{k}"] = g.numpy()


def tp_parse_batch(seed=17):
    rs = np.random.RandomState(seed)
    return {"sentences": rs.randint(2, V, (B, L))}


def group_tp(out, rank, world, port, rec):
    """tests/test_torch_tp.py: the sharded ops against the whole ones,
    the text and CLIORA steps (and ZeRO-1) over three global batches,
    each rank's slice shapes, ``install_state`` of the trainer's own
    whole state, and the parse under mp."""
    from cliora_tpu_torch.parallel.mesh import shard_batch

    mesh = join(rank, world, port, mp=MP)
    rec["grid"] = np.array([mesh.size, mesh.rank, mesh.mp, mesh.mp_rank])
    if mesh.size == 1:
        _ops_record(rec, "tp", tp_ops(mesh))
    for name in TP_CASES + (TP_MORE_CASES if mesh.size == 1 else ()):
        losses, names, flat, opt, tr = run_case(name, mesh)
        _case_record(rec, name, losses, names, flat, opt)
    tr = trainer("diora", mesh)
    for k, p in zip(*map(lambda f: f(tr.params), (_paths, _leaves))):
        rec[f"shape/{k}"] = np.array(p.shape)
    before = [p.detach().clone() for p in _leaves(tr.params)]
    tr.install_state(tr.full_params(), tr.opt_state())
    rec["install_keeps_slices"] = np.array(all(
        bool(torch_equal(a, b)) for a, b in zip(before, _leaves(tr.params))))
    res, _ = tr.parse(tp_parse_batch())
    rec["parse/cky_bp"] = res["cky_bp"]
    rec["parse/route"] = np.array(res["parse_impl"])
    # two steps on one batch: the loss descends
    tr = trainer("cliora", mesh)
    b = shard_batch(mesh, batches("cliora")[0])
    rec["descend"] = np.array([float(tr.step(b)["total_loss"])
                               for _ in range(2)])


def group_tp_ckpt(out, rank, world, port, rec):
    """tests/test_torch_tp_ckpt.py: a ZeRO-1 text trainer at ``(dp, 2)``
    after two steps writes the ``.npz`` and ``.opt.pkl`` (the chief) and a
    DCP directory; a fresh trainer restored from the directory takes the
    third step, beside the uninterrupted trainer's third step."""
    from cliora_tpu_torch.training.checkpoint import (
        save_opt_state,
        save_params,
    )
    from cliora_tpu_torch.parallel.mesh import shard_batch
    from cliora_tpu_torch.training.dist_ckpt import restore_state, save_state

    mesh = join(rank, world, port, mp=MP)
    name = "diora_zero1"
    mine = [shard_batch(mesh, b) for b in batches(name)]
    tr = trainer(name, mesh)
    for b in mine[:2]:
        tr.step(b)
    opt, params = tr.opt_state(), tr.full_params()
    if rank == 0:
        save_params(os.path.join(out, "tp.npz"), params)
        save_opt_state(os.path.join(out, "tp.opt.pkl"), opt)
    save_state(os.path.join(out, "tp.dcp"), tr)
    _case_record(rec, "saved", np.zeros((1, 1)), ["none"],
                 {k: v for k, v in _flat(params).items()}, opt)
    fresh = trainer(name, mesh)
    restore_state(os.path.join(out, "tp.dcp"), fresh)
    for tag, t in (("uninterrupted", tr), ("resumed", fresh)):
        m = t.step(mine[2])
        _case_record(rec, tag, np.array([[float(m["total_loss"])]]),
                     ["total_loss"], _flat(t.full_params()), t.opt_state())


def group_tp_restore(out, rank, world, port, rec):
    """tests/test_torch_tp_ckpt.py: the DCP directory written at mp = 2
    (``OUT/../tp.dcp``), restored by a dp group without tensor
    parallelism, replicated and under ZeRO-1."""
    from cliora_tpu_torch.training.dist_ckpt import restore_state

    mesh = join(rank, world, port)
    for zero1 in (False, True):
        tr = trainer("diora_zero1" if zero1 else "diora", mesh)
        restore_state(os.path.join(os.path.dirname(out), "tp.dcp"), tr)
        _case_record(rec, f"zero1_{zero1}", np.zeros((1, 1)), ["none"],
                     _flat(tr.full_params()), tr.opt_state())


def _flat(params):
    from cliora_tpu_torch.training.checkpoint import flatten
    return flatten(params)


def _paths(tree):
    from cliora_tpu_torch.training.trainer import tree_paths
    return tree_paths(tree)


def _leaves(tree):
    from cliora_tpu_torch.training.trainer import tree_leaves
    return tree_leaves(tree)


def torch_equal(a, b):
    import torch
    return torch.equal(a, b)


GROUPS = {"parallel": group_parallel, "multihost": group_multihost,
          "cli": group_cli, "dist_ckpt": group_dist_ckpt, "tp": group_tp,
          "tp_ckpt": group_tp_ckpt, "tp_restore": group_tp_restore,
          "tp_cli": lambda *a: group_cli(*a, extra=("--mp", str(MP)))}


def worker_main(out, rank, world, port, group):
    import torch.distributed as dist

    rec = {}
    GROUPS[group](out, rank, world, port, rec)
    _save(out, rank, rec)
    dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out, group, world=2, timeout=240):
    """Run ``group`` in ``world`` worker processes; returns each rank's
    record."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), str(r),
         str(world), str(port), group],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text}"
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(world)]


if __name__ == "__main__":
    worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                int(sys.argv[4]), sys.argv[5])
