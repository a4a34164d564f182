"""CLI flag surface + json round-trip.

The port's copy of cliora_tpu/utils/flags.py: the same flags and
defaults, so the shell scripts (scripts/train_diora.sh,
scripts/train_cliora.sh) run unchanged, with these differences.
``--parse_impl`` takes the port's routes ``auto``/``plain``/``cuda``
(the JAX ``xla`` and ``pallas``), ``--attn_impl`` takes
``einsum``/``chunked``/``cuda`` (the JAX ``pallas``); ``--jax_cache_dir``
is gone; ``--device`` (default ``cuda``) picks the trainer's device.
Flags whose feature is not ported yet raise ``NotImplementedError``
naming the ROADMAP item (:func:`refuse_unported`), rather than being
accepted and ignored.  (reference: cliora/scripts/train.py:278-458,
cliora/utils/flags.py:1-43)
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

DATA_TYPES = ("coco", "flickr", "ptb", "txt", "jsonl", "conll",
              "synthetic")


def _bool_flag(v: str) -> bool:
    """Parse explicit boolean flag values ('true'/'false'/'1'/'0')."""
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean or 'auto': {v}")


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()

    # Debug / provenance
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", default=11, type=int)
    p.add_argument("--git_sha", default=None, type=str)
    p.add_argument("--git_branch_name", default=None, type=str)
    p.add_argument("--git_dirty", default=None, type=str)
    p.add_argument("--uuid", default=None, type=str)
    p.add_argument("--model_flags", default=None, type=str,
                   help="Load model settings from a flags file.")
    p.add_argument("--flags", default=None, type=str,
                   help="Load any settings from a flags file.")

    # Distribution: not ported yet beyond one device (refuse_unported);
    # legacy GPU flags accepted+ignored
    p.add_argument("--device", default="cuda", type=str,
                   help="Device of the trainer: 'cuda' (default; raises "
                        "without a card) or 'cpu'.")
    p.add_argument("--n_devices", default=None, type=int,
                   help="Width of the data-parallel group (1 only, "
                        "until the parallelism slice of the port).")
    p.add_argument("--mp", default=1, type=int,
                   help="Tensor-parallel width (1 only, until the "
                        "parallelism slice of the port).")
    p.add_argument("--cuda", action="store_true")       # ignored
    p.add_argument("--multigpu", action="store_true")   # ignored
    p.add_argument("--local_rank", default=None, type=int)  # ignored
    p.add_argument("--master_addr", default="127.0.0.1", type=str)
    p.add_argument("--master_port", default="29500", type=str)
    p.add_argument("--world_size", default=None, type=int)

    # Logging
    p.add_argument("--default_experiment_directory", default="./log",
                   type=str)
    p.add_argument("--experiment_name", default=None, type=str)
    p.add_argument("--experiment_path", default=None, type=str)
    p.add_argument("--log_every_batch", default=10, type=int)
    p.add_argument("--save_latest", default=1000, type=int)
    p.add_argument("--save_distinct", default=5000, type=int)
    p.add_argument("--save_after", default=1000, type=int)

    # Loading
    p.add_argument("--load_model_path", default=None, type=str)

    # Data
    p.add_argument("--data_type", default="flickr", choices=DATA_TYPES)
    p.add_argument("--train_data_type", default=None, choices=DATA_TYPES)
    p.add_argument("--validation_data_type", default=None,
                   choices=DATA_TYPES)
    p.add_argument("--train_path", default=None, type=str)
    p.add_argument("--validation_path", default=None, type=str)
    p.add_argument("--embeddings_path", default=None, type=str)
    p.add_argument("--data_path", default=None, type=str,
                   help="Directory with MAF feature files "
                        "(default: ./flickr_data/flickr_feat_maf/).")

    # Data (synthetic)
    p.add_argument("--synthetic-nexamples", default=1000, type=int)
    p.add_argument("--synthetic-vocabsize", default=1000, type=int)
    p.add_argument("--synthetic-embeddingsize", default=1024, type=int)
    p.add_argument("--synthetic-minlen", default=20, type=int)
    p.add_argument("--synthetic-maxlen", default=21, type=int)
    p.add_argument("--synthetic-seed", default=11, type=int)
    p.add_argument("--synthetic-length", default=None, type=int)
    p.add_argument("--use-synthetic-embeddings", action="store_true")

    # Data (preprocessing)
    p.add_argument("--uppercase", action="store_true")
    p.add_argument("--train_filter_length", default=50, type=int)
    p.add_argument("--validation_filter_length", default=0, type=int)

    # Model
    # 'hard' = S-DIORA greedy aggregation (mlp compose + argmax split)
    p.add_argument("--arch", default="mlp",
                   choices=("mlp", "treelstm", "hard", "word"))
    p.add_argument("--share", action="store_false")
    p.add_argument("--hidden_dim", default=400, type=int)
    p.add_argument("--normalize", default="unit",
                   choices=("none", "unit"))
    p.add_argument("--compress", action="store_true")
    p.add_argument("--reconstruct_mode", default="softmax",
                   choices=("softmax",))
    p.add_argument("--emb", default="w2v",
                   choices=("w2v", "skip", "elmo", "both", "none"))

    # Negative sampler
    p.add_argument("--margin", default=1, type=float)
    p.add_argument("--k_neg", default=100, type=int)
    p.add_argument("--freq_dist_power", default=0.75, type=float)

    # ELMo
    p.add_argument("--elmo_options_path", default=None, type=str)
    p.add_argument("--elmo_weights_path", default=None, type=str)
    p.add_argument("--elmo_cache_dir", default="./log/elmo", type=str)

    # Training
    p.add_argument("--batch_size", default=10, type=int)
    p.add_argument("--length_to_size", default=None, type=str)
    p.add_argument("--length_buckets", default=None, type=str,
                   help="comma-separated padded lengths, e.g. '10,20,40': "
                        "batches pad up to the next bucket and mask the "
                        "pad cells -- one compiled program per bucket "
                        "instead of per exact length.")
    p.add_argument("--n_length_buckets", default=0, type=int,
                   help="auto-pick this many length buckets from the "
                        "corpus length histogram (0 = off).")
    p.add_argument("--bucket_policy", default="work",
                   choices=("work", "quantile"),
                   help="how --n_length_buckets picks edges: 'work' = DP "
                        "minimizing padded chart work (splits the long "
                        "tail), 'quantile' = equal example mass.")
    p.add_argument("--bucket_sizes", default=None, type=str,
                   help="per-bucket batch sizes 'edge:B,...' (padded "
                        "bucket length -> batch size); buckets not "
                        "listed keep --batch_size.  Short buckets are "
                        "dispatch-floor-bound and run up to ~2.5x the "
                        "per-sentence throughput at B=512 (BASELINE.md "
                        "round 4).  NOTE: changes the SGD batch at "
                        "those lengths (not reference-parity dynamics)."
                        "  Tune with tools/autotune_buckets.py.")
    p.add_argument("--mixed_buckets", action="store_true",
                   help="fill train batches with MIXED true lengths from "
                        "one bucket (each row padded to the bucket edge, "
                        "per-example lengths mask the model) instead of "
                        "one exact length per batch.  Removes the "
                        "dropped-rare-length and surplus waste of exact "
                        "grouping; requires --length_buckets or "
                        "--n_length_buckets.  Sentences shorter than 3 "
                        "tokens are dropped at composition (the exact-"
                        "length path skips such batches instead).")
    p.add_argument("--batch_order", default="shuffle",
                   choices=("shuffle", "blocked"),
                   help="'shuffle' (default): uniform batch order, the "
                        "reference's SGD order statistics.  'blocked': "
                        "same-shape train batches come in runs of "
                        "--steps_per_call so each run fuses into ONE "
                        "device dispatch (Trainer.steps); with many "
                        "length buckets a uniform shuffle almost never "
                        "forms same-shape runs and per-step dispatch "
                        "latency dominates short buckets.  SGD sees "
                        "same-bucket runs of K (batches within a run "
                        "remain random) -- a mild order-statistics "
                        "deviation from the reference.")
    p.add_argument("--include_partial", action="store_true",
                   help="keep final sub-batch-size TRAIN batches "
                        "instead of dropping them (the reference drops "
                        "them, cliora/data/dataloader.py "
                        "FixedLengthBatchSampler).  With "
                        "--mixed_buckets + --pad_batches this trains "
                        "100%% of the corpus: the full-coverage "
                        "production mode (BASELINE.md round 5).  "
                        "Validation always includes partial batches.")
    p.add_argument("--pad_batches", action="store_true",
                   help="pad partial TRAIN batches up to --batch_size "
                        "with repeated rows (masked out of the losses; "
                        "epoch sents/s counts real rows only) so "
                        "--include_partial adds no new compiled batch "
                        "shapes.  Validation batches are always padded.")
    p.add_argument("--eval_buckets", action="store_true",
                   help="pad VALIDATION batches to the training length-"
                        "bucket edges so per-epoch eval compiles one "
                        "parse program per bucket instead of one per "
                        "exact sentence length (~4x fewer compiles on a "
                        "L<=40 mix).  Metrics are identical -- run_eval "
                        "masks and decodes by true length "
                        "(tests/test_mixed_buckets.py "
                        "test_run_eval_ragged_matches_exact).  Off by "
                        "default: parse/phrase_embed chart dumps index "
                        "by exact length and keep exact batches.")
    p.add_argument("--bucket_floor_len", default=10.0, type=float,
                   help="work-policy cost model: per-step overhead as an "
                        "equivalent cubic length (v5e B=128: t(L) ~ 5ms "
                        "+ 0.0045ms*L^3 -> ~10).")
    p.add_argument("--train_dataset_size", default=None, type=int)
    p.add_argument("--validation_dataset_size", default=None, type=int)
    p.add_argument("--validation_batch_size", default=None, type=int)
    p.add_argument("--max_epoch", default=5, type=int)
    p.add_argument("--max_step", default=None, type=int)
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--finetune_after", default=0, type=int)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 matmul compute in the chart passes.")
    p.add_argument("--remat", nargs="?", const=True, default=False,
                   type=lambda v: v if v == "auto" else _bool_flag(v),
                   help="rematerialize chart levels in the backward "
                        "(torch.utils.checkpoint): bare --remat forces "
                        "it on; '--remat auto' decides per batch shape "
                        "from an activation-memory estimate against "
                        "--remat_budget_gb.")
    p.add_argument("--remat_budget_gb", default=10.0, type=float,
                   help="device-memory budget of '--remat auto'.")
    p.add_argument("--steps_per_call", default=1, type=int,
                   help="group this many consecutive same-shape train "
                        "batches into one Trainer.steps call: on the card "
                        "one train step per shape is captured as a CUDA "
                        "graph and replayed for each batch.")
    p.add_argument("--accum_steps", default=1, type=int,
                   help="gradient accumulation: split each batch into "
                        "this many sequential microbatches, average the "
                        "grads, apply one update.  Batch-coupled losses "
                        "(contrastive/VG negatives) scope to the "
                        "microbatch.")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 sharded Adam state (not ported yet: "
                        "ROADMAP A8).")
    p.add_argument("--remat_policy", default="full",
                   choices=("full", "dots", "gathers"),
                   help="what a checkpointed level keeps for its "
                        "backward (with --remat).")
    p.add_argument("--remat_frac", default=0.0, type=float,
                   help="with --remat, only checkpoint levels whose "
                        "intermediates are >= this fraction of the "
                        "pass's biggest level.")
    p.add_argument("--parse_impl", default="auto",
                   choices=("auto", "plain", "cuda"),
                   help="CKY decode route: 'auto' (default) takes the "
                        "fused inside+CKY CUDA kernel on the card and the "
                        "plain PyTorch chart pass on the CPU; 'plain' / "
                        "'cuda' force one ('cuda' only where the kernel "
                        "supports the batch).  The JAX package's 'xla' is "
                        "'plain', its 'pallas' is 'cuda'.")
    p.add_argument("--attn_impl", default="einsum",
                   choices=("einsum", "chunked", "cuda"),
                   help="span x region score reduction in training "
                        "(ops/span_region.py): 'einsum' materializes the "
                        "(B, B, cells, R) tensor, 'chunked' and 'cuda' "
                        "fuse the max, 'cuda' with the CUDA kernels K2-K4 "
                        "(the JAX package's 'pallas').")
    p.add_argument("--profile_steps", default=0, type=int,
                   help="Capture a torch.profiler trace of the first N "
                        "steps to <experiment_path>/profile.")
    p.add_argument("--resume", default=None, type=str,
                   help="Resume from a model.epoch_N.npz checkpoint "
                        "(with its .opt.pkl and experiment json): restores "
                        "params AND optimizer state "
                        "(the reference only warm-starts weights). "
                        "'auto' picks the newest epoch checkpoint in "
                        "--experiment_path (preemption restarts; falls "
                        "back to a fresh start when none exists).")
    p.add_argument("--ckpt_keep", default=0, type=int,
                   help="keep only the newest N per-epoch checkpoints "
                        "(0 = keep all, the reference behavior); "
                        "model.best.* is never pruned.")
    p.add_argument("--ckpt_backend", default="npz",
                   choices=("npz", "orbax"),
                   help="per-epoch checkpoint format: 'npz' (plus the "
                        ".pt torch export and the .opt.pkl optimizer "
                        "state); 'orbax' is not ported yet (ROADMAP A5).")

    # Parsing
    p.add_argument("--postprocess", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--img_root", default="./flickr_data/", type=str,
                   help="Image directory root for --visualize.")

    # Optimization
    p.add_argument("--lr", default=2e-3, type=float)

    # Visual features / losses
    p.add_argument("--alpha_contr", type=float, default=1.0)
    p.add_argument("--obj_feats", action="store_true")
    p.add_argument("--vl_margin", default=0.2, type=float)
    p.add_argument("--use_contr", action="store_true")
    p.add_argument("--use_contr_ce", action="store_true")
    p.add_argument("--vg_loss", action="store_true")
    p.add_argument("--alpha_vg", type=float, default=1.0)
    p.add_argument("--alpha_kl", type=float, default=1.0)
    p.add_argument("--hinge_margin", default=1, type=float)

    return p


# flag values whose feature the port does not have yet -> the ROADMAP item
# that brings it
_UNPORTED = (
    ("--mp > 1", lambda o: o.mp > 1, "A8"),
    ("--n_devices > 1", lambda o: (o.n_devices or 1) > 1, "A8"),
    ("--world_size", lambda o: o.world_size is not None, "A8"),
    ("--zero1", lambda o: o.zero1, "A8"),
    ("--ckpt_backend orbax", lambda o: o.ckpt_backend == "orbax", "A5"),
    ("--emb elmo", lambda o: o.emb == "elmo", "A6"),
)


def refuse_unported(options):
    """Raise ``NotImplementedError`` for a flag whose feature is not
    ported yet, naming the ROADMAP item that brings it."""
    for flag, applies, item in _UNPORTED:
        if applies(options):
            raise NotImplementedError(
                f"{flag}: not ported to cliora_tpu_torch yet "
                f"(ROADMAP {item})")


def parse_args(parser, args=None):
    """Post-processing defaults (reference: train.py:404-458), then
    :func:`refuse_unported`."""
    options, _ = parser.parse_known_args(args)

    options.train_data_type = (options.train_data_type
                               or options.data_type)
    options.validation_data_type = (options.validation_data_type
                                    or options.data_type)
    options.validation_batch_size = (options.validation_batch_size
                                     or options.batch_size)

    if not options.git_sha:
        options.git_sha = os.popen(
            "git rev-parse HEAD 2>/dev/null").read().strip()
    if not options.git_branch_name:
        options.git_branch_name = os.popen(
            "git rev-parse --abbrev-ref HEAD 2>/dev/null").read().strip()
    if not options.git_dirty:
        options.git_dirty = os.popen(
            "git diff --quiet 2>/dev/null && echo clean || echo dirty"
        ).read().strip()
    if not options.uuid:
        options.uuid = str(uuid.uuid4())
    if not options.experiment_name:
        options.experiment_name = options.uuid[:8]
    if not options.experiment_path:
        options.experiment_path = os.path.join(
            options.default_experiment_directory, options.experiment_name)

    if options.length_to_size is not None and isinstance(
            options.length_to_size, str):
        parts = [x.split(":") for x in options.length_to_size.split(",")]
        options.length_to_size = {int(a): int(b) for a, b in parts}

    options.lowercase = not options.uppercase

    for k, v in vars(options).items():
        if isinstance(v, str) and v.startswith("~"):
            setattr(options, k, os.path.expanduser(v))

    MODEL_FLAGS = ("arch", "compress", "emb", "hidden_dim", "normalize",
                   "reconstruct_mode")
    if options.model_flags is not None:
        options = init_with_flags_file(options, options.model_flags,
                                       MODEL_FLAGS)
    if options.flags is not None:
        options = init_with_flags_file(options, options.flags)

    refuse_unported(options)
    return options


def stringify_flags(options) -> str:
    return json.dumps(vars(options), indent=2, sort_keys=True, default=str)


def save_flags(options, experiment_path: str):
    """(reference: cliora/utils/flags.py:39-43)"""
    os.makedirs(experiment_path, exist_ok=True)
    with open(os.path.join(experiment_path, "flags.json"), "w") as f:
        f.write(stringify_flags(options))


def init_with_flags_file(options, flags_file: str, restrict=None):
    """(reference: cliora/utils/flags.py:12-36)"""
    with open(flags_file) as f:
        flags = json.load(f)
    for k, v in flags.items():
        if restrict is not None and k not in restrict:
            continue
        setattr(options, k, v)
    return options
