"""Shared CLI plumbing: options -> configs -> Trainer, dataset loading.

The port's counterpart of cliora_tpu/scripts/common.py.  ``build_trainer``
builds the port's ``Trainer`` on ``--device`` and covers a warm start
from ``.npz``/``.pt`` (``--load_model_path``) and ``--resume`` (a
checkpoint path or ``auto``): parameters, optimizer state, then the host
step counter from the experiment json.
(reference: cliora/scripts/train.py:31-45,222-254 + cliora/net/trainer.py
``build_net``)
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from cliora_tpu_torch.data.dataset import (
    ConsolidateDatasets,
    ReconstructDataset,
    make_batch_iterator,
)
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.params import param_count
from cliora_tpu_torch.training.checkpoint import (
    import_torch_checkpoint,
    load_opt_state,
    load_params,
)
from cliora_tpu_torch.training.trainer import TrainConfig, Trainer
from cliora_tpu_torch.utils.checkpoint import load_experiment
from cliora_tpu_torch.utils.observability import get_logger


def model_config_from_options(options, embeddings) -> ModelConfig:
    if isinstance(embeddings, (int, np.integer)):
        input_size = 1024       # trainable table width (--emb none)
    else:
        input_size = int(np.asarray(embeddings).shape[1])
    arch, aggregate = options.arch, "soft"
    if arch == "hard":  # S-DIORA: mlp compose, greedy split aggregation
        arch, aggregate = "mlp", "hard"
    return ModelConfig(
        size=options.hidden_dim,
        input_size=input_size,
        arch=arch,
        aggregate=aggregate,
        share=options.share,
        normalize=options.normalize,
        compress=options.compress,
        use_obj=options.obj_feats,
        compute_dtype="bfloat16" if options.bf16 else "float32",
        remat=options.remat,
        remat_frac=options.remat_frac,
        remat_policy=options.remat_policy,
        remat_budget_gb=options.remat_budget_gb,
        parse_impl=options.parse_impl,
    )


def train_config_from_options(options) -> TrainConfig:
    # embeddings trainable only for --emb none text-only pretraining;
    # frozen during CLIORA finetune (reference: trainer.py:536-546)
    emb_trainable = options.emb == "none" and not options.obj_feats
    return TrainConfig(
        lr=options.lr,
        k_neg=options.k_neg,
        emb_trainable=emb_trainable,
        vg_loss=options.vg_loss,
        alpha_vg=options.alpha_vg,
        use_contr=options.use_contr,
        alpha_contr=options.alpha_contr,
        vl_margin=options.vl_margin,
        attn_impl=options.attn_impl,
        accum_steps=options.accum_steps,
        zero1=options.zero1,
    )


def build_trainer(options, embeddings) -> Trainer:
    """A new trainer on ``options.device`` (``embeddings``: a pretrained
    (V, E) matrix, or an int vocab size for the trainable ``--emb none``
    table), then the warm start or resume the options ask for."""
    logger = get_logger()
    cfg = model_config_from_options(options, embeddings)
    tc = train_config_from_options(options)
    trainer = Trainer.build(cfg, tc, embeddings, seed=options.seed,
                            device=options.device)

    if options.resume:
        if options.resume == "auto":
            options.resume = _latest_checkpoint(options.experiment_path)
            if options.resume is None:
                # cold start (first run after scheduling): train fresh
                logger.info("--resume auto: no checkpoint found; "
                            "starting fresh")
                logger.info(f"# of params = {param_count(trainer.params)}")
                return trainer
        logger.info(f"Resuming from: {options.resume}")
        params, missing = load_params(options.resume, trainer.params)
        if missing:
            raise ValueError(f"{options.resume}: no {missing}")
        opt_state = load_opt_state(options.resume.replace(".npz",
                                                          ".opt.pkl"))
        trainer.install_state(params, opt_state)
        # exact resume: the host step counter (the dropout stream) from
        # the experiment json, after Adam's count came with its state
        rst = resume_state(options)
        if rst and "host_step" in rst:
            trainer.set_step(int(rst["host_step"]))
        logger.info(f"# of params = {param_count(trainer.params)}")
        return trainer

    if options.load_model_path:
        logger.info(f"Loading model: {options.load_model_path}")
        load_embeddings = options.emb == "none"
        if options.load_model_path.endswith((".pt", ".pth")):
            params, missing = import_torch_checkpoint(
                options.load_model_path, trainer.params,
                load_embeddings=load_embeddings)
        else:
            params, missing = load_params(options.load_model_path,
                                          trainer.params)
        for k in missing:
            logger.info(f"Not initialized from checkpoint: {k}")
        trainer.install_state(params)

    logger.info(f"# of params = {param_count(trainer.params)}")
    return trainer


def resume_state(options):
    """The ``{step, epoch, host_step, seed}`` snapshot recorded with the
    checkpoint being ``--resume``\\ d, or None.

    Looks for ``experiment.epoch_N.json`` next to the checkpoint (then in
    the experiment dir), N parsed from the ``model.epoch_N.*`` filename.
    Old-format jsons (reference parity: ``{step}`` only,
    cliora/utils/checkpoint.py:4-8) still yield the epoch so the run at
    least restarts at the right epoch boundary.
    """
    path = options.resume
    if not path or path == "auto":
        return None
    m = re.match(r"model\.epoch_(\d+)\.", os.path.basename(str(path)))
    if not m:
        return None
    epoch = int(m.group(1))
    for d in (os.path.dirname(str(path)) or ".", options.experiment_path):
        j = os.path.join(d, f"experiment.epoch_{epoch}.json")
        if os.path.exists(j):
            st = load_experiment(j)
            st.setdefault("epoch", epoch)
            return st
    return {"epoch": epoch}


def _latest_checkpoint(experiment_path):
    """Newest per-epoch ``.npz`` checkpoint for ``--resume auto``: rerun
    the same command with the same --experiment_path and training
    continues from the last completed epoch."""
    best, best_epoch = None, -1
    for p in glob.glob(os.path.join(experiment_path, "model.epoch_*")):
        m = re.match(r"model\.epoch_(\d+)\.npz$", os.path.basename(p))
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = p, int(m.group(1))
    return best


def get_train_dataset(options):
    return ReconstructDataset().initialize(
        options, text_path=options.train_path,
        embeddings_path=options.embeddings_path,
        filter_length=options.train_filter_length,
        data_type=options.train_data_type)


def get_validation_dataset(options):
    return ReconstructDataset().initialize(
        options, text_path=options.validation_path,
        embeddings_path=options.embeddings_path,
        filter_length=options.validation_filter_length,
        data_type=options.validation_data_type)


def get_train_iterator(options, dataset, region_features=None):
    # include_partial=False is the reference default (drop final
    # sub-B batches, cliora/data/dataloader.py); --include_partial
    # [--pad_batches] opts into full-coverage training.
    # region_features: the Flickr split's arrays in place of its HDF5
    # file (data/datasets.py read_features)
    return make_batch_iterator(
        options, dataset,
        include_partial=options.include_partial,
        filter_length=options.train_filter_length,
        batch_size=options.batch_size,
        length_to_size=options.length_to_size, mode="train",
        data_path=options.data_path,
        pad_batches=options.pad_batches,
        region_features=region_features)


def get_validation_iterator(options, dataset, length_buckets=None,
                            region_features=None):
    """``length_buckets`` (from --eval_buckets, scripts/train.py) pads
    validation batches to those edges; run_eval masks and decodes by
    true length so metrics are unchanged."""
    return make_batch_iterator(
        options, dataset, include_partial=True,
        filter_length=options.validation_filter_length,
        batch_size=options.validation_batch_size,
        length_to_size=options.length_to_size, mode="test",
        data_path=options.data_path,
        # pad surplus batches so eval sees one shape per length
        pad_batches=True,
        length_buckets=length_buckets,
        region_features=region_features)


def get_train_and_validation(options):
    train_dataset = get_train_dataset(options)
    validation_dataset = get_validation_dataset(options)
    if options.data_type not in ("coco", "flickr"):
        ConsolidateDatasets([train_dataset, validation_dataset]).run()
    return train_dataset, validation_dataset
