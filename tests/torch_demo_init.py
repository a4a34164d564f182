"""The JAX package's initial parameters of the README's grammar-induction
demonstration, for the port's chip smoke run.

The two packages draw their N(0, 1) init from different generators
(``jax.random`` against ``torch.Generator``), so ``--seed 11`` names
another initial model in the port (ROADMAP.md, C5), and the card's
machine has no JAX.  :func:`write` saves the model the JAX package's
README command starts from (``python -m cliora_tpu.scripts.train`` with
the demonstration's flags and its default seed) as an ``.npz`` without
the fixed embedding table: ``chip_smoke.py``'s ``learn`` phase hands it
to the port's train CLI as ``--load_model_path``.  The initial
parameters depend on the flags and the embedding width only, so a small
corpus from tools/make_synthetic_ptb.py (whose embeddings do not depend
on its size) stands in for the demonstration's.

    JAX_PLATFORMS=cpu python tests/torch_demo_init.py

writes ``tests/data/grammar_jax_init.npz``;
tests/test_torch_demos.py holds the committed file to the JAX package.
"""

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "grammar_jax_init.npz")


def write(path):
    """The JAX CLI's trainer for the grammar demonstration's flags, built
    as ``build_trainer`` builds it, its parameters saved to ``path``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import GRAMMAR_FLAGS
    from cliora_tpu.scripts import common
    from cliora_tpu.training.checkpoint import save_params
    from cliora_tpu.utils.flags import argument_parser, parse_args

    with tempfile.TemporaryDirectory() as work:
        subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "make_synthetic_ptb.py"),
                        work, "40", "10"], check=True, capture_output=True,
                       timeout=300)
        options = parse_args(argument_parser(), GRAMMAR_FLAGS + [
            "--embeddings_path", os.path.join(work, "glove.txt"),
            "--train_path", os.path.join(work, "train.pkl"),
            "--validation_path", os.path.join(work, "valid.pkl"),
            "--experiment_path", os.path.join(work, "exp")])
        train, _ = common.get_train_and_validation(options)
        trainer = common.build_trainer(options, train["embeddings"])
        save_params(path, trainer.state.params, save_embeddings=False)


if __name__ == "__main__":
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    write(FIXTURE)
    print(FIXTURE)
