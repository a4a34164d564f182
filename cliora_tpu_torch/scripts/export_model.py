"""Export a trained model as a serving bundle (``torch.export``).

The port's counterpart of cliora_tpu/scripts/export_model.py.  Seals the
parse -- symbolic batch dimension, weights as a ``params.npz`` sidecar
(or baked into every program with ``--export_baked_params``) -- into
per-length programs a serving host runs with no model code
(cliora_tpu_torch/serving.py).  Model loading is parse.py's::

    python -m cliora_tpu_torch.scripts.export_model \\
        --data_type flickr --emb none \\
        --validation_path flickr_data/flickr_test.json \\
        --load_model_path exp/model.best.npz \\
        --experiment_path exp_export \\
        --export_lengths 10,20,40 [--export_platforms cuda,cpu] \\
        [--device cpu]

The bundle lands in ``<experiment_path>/bundle``.  A ``.pt2`` program is
read by the torch version that wrote it.
"""

from __future__ import annotations

import os
import time

from cliora_tpu_torch.scripts.common import (
    build_trainer,
    get_validation_dataset,
)
from cliora_tpu_torch.serving import export_parser, save_bundle
from cliora_tpu_torch.utils.flags import argument_parser, parse_args
from cliora_tpu_torch.utils.observability import (
    configure_experiment,
    get_logger,
)


def add_export_flags(p):
    p.add_argument("--export_lengths", default="10,20,40", type=str,
                   help="comma-separated padded sentence lengths; one "
                        "program per bucket, requests pad to the "
                        "smallest covering bucket.")
    p.add_argument("--export_platforms", default=None, type=str,
                   help="comma-separated torch devices the programs may "
                        "run on (e.g. 'cuda,cpu'); exported on the first. "
                        "Default: the --device of the trainer.")
    p.add_argument("--export_batch", default=None, type=int,
                   help="pin the batch dimension (default: symbolic -- "
                        "any batch size at serving time).")
    p.add_argument("--export_baked_params", action="store_true",
                   help="bake the weights into every program as "
                        "constants.  Default: the weights are the "
                        "programs' first input, with a params.npz "
                        "sidecar the loader uploads once.")
    return p


def run(options):
    logger = get_logger()
    dataset = get_validation_dataset(options)
    trainer = build_trainer(options, dataset["embeddings"])

    lengths = [int(x) for x in options.export_lengths.split(",")]
    platforms = (options.export_platforms.split(",")
                 if options.export_platforms else [trainer.device.type])
    in_args = not options.export_baked_params
    artifacts = {}
    for L in lengths:
        t0 = time.perf_counter()
        artifacts.update(export_parser(
            trainer.cfg, trainer.params, [L],
            platforms=platforms, batch=options.export_batch,
            params_in_args=in_args))
        logger.info(f"exported bucket L={L}: "
                    f"{len(artifacts[L]) / 1e6:.2f} MB in "
                    f"{time.perf_counter() - t0:.1f} s")
    bundle = os.path.join(options.experiment_path, "bundle")
    save_bundle(bundle, trainer.cfg, artifacts,
                word2idx=dataset["word2idx"],
                batch=options.export_batch,
                params=trainer.params if in_args else None,
                extra_meta={"source_checkpoint": options.load_model_path})
    logger.info(f"bundle written to {bundle}")
    return bundle


def main(args=None):
    options = parse_args(add_export_flags(argument_parser()), args)
    configure_experiment(options.experiment_path)
    return run(options)


if __name__ == "__main__":
    main()
