"""Training entry point.

The port's counterpart of cliora_tpu/scripts/train.py, on one device.
Usage mirrors the reference's shell scripts (reference:
cliora/scripts/train.py, train_diora.sh, train_cliora.sh), e.g.::

    python -m cliora_tpu_torch.scripts.train \\
        --data_type flickr --emb skip \\
        --train_path flickr_data/flickr_train.json \\
        --validation_path flickr_data/flickr_test.json \\
        --embeddings_path skip_thoughts_dict.pkl \\
        --batch_size 32 --hidden_dim 400 --k_neg 100 --lr 5e-4 \\
        --max_epoch 30 --train_filter_length 40

It runs on the card unless ``--device cpu`` is given.  Batches are
uploaded ahead of the step (data/prefetch.py); with ``--steps_per_call
K`` consecutive same-shape batches go through one ``Trainer.steps``
call, which on the card replays one captured CUDA graph per shape.
"""

from __future__ import annotations

import glob
import os
import random
import re
import time

import torch

from cliora_tpu_torch.analysis.eval import run_eval
from cliora_tpu_torch.data.prefetch import device_prefetch
from cliora_tpu_torch.scripts.common import (
    build_trainer,
    get_train_and_validation,
    get_train_iterator,
    get_validation_iterator,
    resume_state,
)
from cliora_tpu_torch.training.checkpoint import (
    export_torch_checkpoint,
    save_opt_state,
    save_params,
)
from cliora_tpu_torch.utils.checkpoint import save_experiment
from cliora_tpu_torch.utils.flags import (
    argument_parser,
    parse_args,
    save_flags,
    stringify_flags,
)
from cliora_tpu_torch.utils.observability import (
    ExperimentLogger,
    configure_experiment,
    get_logger,
)


def generate_seeds(n, seed=11):
    """(reference: cliora/scripts/train.py:42-45)"""
    random.seed(seed)
    return [random.randint(0, 2 ** 16) for _ in range(n)]


def step_stream(trainer, batches, steps_per_call: int = 1,
                max_steps=None):
    """Yield (batch_map, metrics) pairs; with steps_per_call > 1,
    consecutive same-shape batches go through ONE ``Trainer.steps`` call
    (on the card, replays of one captured CUDA graph).  Nothing here
    reads a metric, so no group waits for the device.

    ``max_steps`` caps the total optimizer steps *applied*: the final
    group is truncated so --max_step never overshoots by up to K-1
    silently-applied-but-uncounted updates.

    Failures report the offending batch shape before propagating
    (reference: cliora/net/trainer.py:469-481;
    cliora_tpu/scripts/train.py:62-110)."""
    def shape_of(bm):
        return tuple(bm["sentences"].shape)

    def run(fn, bms):
        try:
            return fn()
        except Exception:
            get_logger().info("Step failed with batch shape: {}".format(
                shape_of(bms[0])))
            raise

    if steps_per_call <= 1:
        for bm in batches:
            yield bm, run(lambda: trainer.step(bm), [bm])
        return

    pending = []
    done = 0

    def flush():
        nonlocal done
        if not pending:
            return
        group = pending[:]
        ms = run(lambda: trainer.steps(group), group)
        pending.clear()
        done += len(group)
        yield from zip(group, ms)

    def budget():
        return (steps_per_call if max_steps is None
                else min(steps_per_call, max_steps - done))

    for bm in batches:
        if max_steps is not None and done >= max_steps:
            return
        if pending and shape_of(bm) != shape_of(pending[0]):
            yield from flush()
            if max_steps is not None and done >= max_steps:
                return
        pending.append(bm)
        if len(pending) >= budget():
            yield from flush()
    yield from flush()


def _sync(trainer):
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)


def run_train(options, train_iterator, trainer, validation_iterator):
    """The epoch loop: train, checkpoint, eval, keep-best.  Returns one
    record per epoch run: ``{"epoch", "step", "sents", "wall_s",
    "sents_per_s", "eval_wall_s", "metrics"}`` (the wall times end in a
    device sync)."""
    logger = get_logger()
    experiment_logger = ExperimentLogger()
    save_emb = options.emb == "none"

    seeds = generate_seeds(options.max_epoch, options.seed)
    step = 0
    start_epoch = 0
    rst = resume_state(options)
    if rst:
        # exact resume: restart at the epoch AFTER the checkpointed one,
        # with the recorded optimizer-step count, so the epoch-seed
        # schedule (and hence batch order) continues exactly where the
        # uninterrupted run would be.  The counter restore happened in
        # build_trainer.
        start_epoch = int(rst["epoch"]) + 1
        step = int(rst.get("step", 0))
        if rst.get("seed") is not None and rst["seed"] != options.seed:
            logger.info(
                f"WARNING: resuming with --seed {options.seed} but the "
                f"checkpoint was trained with seed {rst['seed']}; batch "
                f"order will not reproduce the original run")
        logger.info(f"resume: starting at epoch {start_epoch}, "
                    f"step {step}")
    best_f1 = -1.0
    best_epoch = None
    if rst:
        # keep-best continuity: without this a resumed run could demote
        # model.best to a worse post-resume epoch
        best_f1 = float(rst.get("best_f1", -1.0))
        best_epoch = rst.get("best_epoch")
    profiler = None
    records = []

    try:
        for epoch, seed in zip(range(options.max_epoch), seeds):
            if epoch < start_epoch:
                continue
            logger.info(f"epoch={epoch} seed={seed}")
            batches = (bm for bm in train_iterator.get_iterator(
                random_seed=seed) if bm["length"] > 2)
            remaining = (None if options.max_step is None
                         else max(0, options.max_step - step))
            stream = step_stream(
                trainer, device_prefetch(batches, trainer.device),
                options.steps_per_call, max_steps=remaining)
            epoch_t0, epoch_sents = time.time(), 0
            while True:
                if options.profile_steps and step == 0 and profiler is None:
                    profiler = _start_profiler(trainer)
                try:
                    batch_map, metrics = next(stream)
                except StopIteration:
                    break
                result = dict(metrics)
                if profiler is not None and step + 1 >= options.profile_steps:
                    profiler = _stop_profiler(profiler, trainer, options)
                result["length"] = batch_map["length"]
                result["batch_size"] = batch_map["batch_size"]
                # count REAL sentences only (padded/repeated rows do
                # work but carry no training signal)
                epoch_sents += int(batch_map.get(
                    "real_size", batch_map["batch_size"]))
                experiment_logger.record(result)
                if step % options.log_every_batch == 0:
                    experiment_logger.log_batch(
                        epoch, step, step, batch_size=options.batch_size)
                step += 1
                if options.max_step is not None and step >= options.max_step:
                    break

            _sync(trainer)
            wall = time.time() - epoch_t0
            experiment_logger.log_epoch(epoch, step, n_sentences=epoch_sents,
                                        wall_s=wall)

            base = os.path.join(options.experiment_path,
                                f"model.epoch_{epoch}")
            save_params(base + ".npz", trainer.params,
                        save_embeddings=save_emb)
            export_torch_checkpoint(base + ".pt", trainer.params,
                                    save_embeddings=save_emb)
            save_opt_state(base + ".opt.pkl", trainer.opt_state())
            save_experiment(
                os.path.join(options.experiment_path,
                             f"experiment.epoch_{epoch}.json"), step,
                epoch=epoch, host_step=trainer._host_step,
                seed=options.seed)
            _prune_checkpoints(options, epoch, logger)

            eval_t0 = time.time()
            metrics = run_eval(trainer, validation_iterator,
                               seed=options.seed,
                               use_obj=options.obj_feats)
            eval_wall = time.time() - eval_t0
            corpus_f1 = metrics["corpus_f1"]
            if corpus_f1 > best_f1:
                best_f1, best_epoch = corpus_f1, epoch
            # refresh the snapshot with this epoch's eval so a resumed
            # run keeps the keep-best state too
            save_experiment(
                os.path.join(options.experiment_path,
                             f"experiment.epoch_{epoch}.json"), step,
                epoch=epoch, host_step=trainer._host_step,
                seed=options.seed, best_f1=best_f1,
                best_epoch=best_epoch)
            if best_epoch == epoch:
                # keep-best checkpoint (the reference keeps only
                # per-epoch files, cliora/scripts/train.py:105-107)
                best = os.path.join(options.experiment_path, "model.best")
                save_params(best + ".npz", trainer.params,
                            save_embeddings=save_emb,
                            extra={"epoch": epoch, "corpus_f1": corpus_f1})
                export_torch_checkpoint(best + ".pt", trainer.params,
                                        save_embeddings=save_emb)
            logger.info(
                f"epoch={epoch} corpus_f1={corpus_f1:.4f} "
                f"sent_f1={metrics['sent_f1']:.4f} "
                f"grounding_acc={metrics['grounding_acc']:.4f} "
                f"best_f1={best_f1:.4f} eval_wall={eval_wall:.1f}s")
            records.append({"epoch": epoch, "step": step,
                            "sents": epoch_sents, "wall_s": wall,
                            "sents_per_s": epoch_sents / wall if wall else
                            None, "eval_wall_s": eval_wall,
                            "metrics": metrics})

            if options.max_step is not None and step >= options.max_step:
                logger.info(f"Max-Step={options.max_step} Quitting.")
                break
    finally:
        if profiler is not None:
            _stop_profiler(profiler, trainer, options)
        if best_epoch is not None:
            logger.info(f"best model: epoch={best_epoch} "
                        f"corpus_f1={best_f1:.4f} "
                        f"(model.best.npz / model.best.pt)")
    return records


def _prune_checkpoints(options, epoch, logger):
    """``--ckpt_keep N``: keep only the newest N per-epoch checkpoints
    (the npz/pt/opt.pkl triplets).  ``model.best.*`` and the experiment
    jsons are never pruned.  Default 0 keeps every epoch, like the
    reference (cliora/scripts/train.py:105-107)."""
    keep = options.ckpt_keep
    if keep < 1:
        return
    by_epoch = {}
    for p in glob.glob(os.path.join(options.experiment_path,
                                    "model.epoch_*")):
        m = re.match(r"model\.epoch_(\d+)\.", os.path.basename(p))
        if m:
            by_epoch.setdefault(int(m.group(1)), []).append(p)
    for e in sorted(by_epoch):
        if e <= epoch - keep:
            for p in by_epoch[e]:
                os.remove(p)
            logger.info(
                f"pruned epoch-{e} checkpoint (--ckpt_keep {keep})")


def _start_profiler(trainer):
    """``--profile_steps``: a ``torch.profiler`` trace of the host and,
    on the card, the device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.__enter__()
    return profiler


def _stop_profiler(profiler, trainer, options):
    """Close the ``--profile_steps`` trace and write it as a Chrome trace
    to ``<experiment_path>/profile/trace.json``; returns None."""
    _sync(trainer)
    profiler.__exit__(None, None, None)
    out = os.path.join(options.experiment_path, "profile")
    os.makedirs(out, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(out, "trace.json"))
    get_logger().info(f"Profiler trace written to {out}")
    return None


def run(options, region_features=None):
    """Datasets, iterators and trainer from ``options``, then
    :func:`run_train`.  ``region_features`` maps a Flickr mode ("train",
    "test") to its ``(features, bboxes, pos_bboxes)`` arrays, in place of
    its HDF5 file.  Returns ``(trainer, epoch records)``."""
    logger = get_logger()
    region_features = region_features or {}
    train_dataset, validation_dataset = get_train_and_validation(options)
    if options.debug:
        train_iterator = get_validation_iterator(
            options, validation_dataset,
            region_features=region_features.get("test"))
    else:
        train_iterator = get_train_iterator(
            options, train_dataset,
            region_features=region_features.get("train"))
    validation_iterator = get_validation_iterator(
        options, validation_dataset,
        # --eval_buckets: share the train edges so eval sees one shape
        # per bucket, not one per exact length
        length_buckets=(train_iterator.length_buckets
                        if options.eval_buckets else None),
        region_features=region_features.get("test"))
    embeddings = train_dataset["embeddings"]

    logger.info("Initializing model.")
    trainer = build_trainer(options, embeddings)
    return trainer, run_train(options, train_iterator, trainer,
                              validation_iterator)


def main(args=None, region_features=None):
    options = parse_args(argument_parser(), args)
    configure_experiment(options.experiment_path)
    get_logger().info(stringify_flags(options))
    save_flags(options, options.experiment_path)
    return run(options, region_features)


if __name__ == "__main__":
    main()
