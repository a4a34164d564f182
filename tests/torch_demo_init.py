"""The JAX package's initial parameters of the README's grammar-induction
demonstration, the reference for the port's init on the card's machine.

The port draws its init from ``jax.random``'s stream reproduced in numpy
(cliora_tpu_torch/utils/prng.py), so ``--seed 11`` names the JAX
package's initial model in both packages; the card's machine has no JAX
to compare with.  :func:`write` saves the model the JAX package's README
command starts from (``python -m cliora_tpu.scripts.train`` with the
demonstration's flags and its default seed) as an ``.npz`` without the
fixed embedding table: ``chip_smoke.py``'s ``learn`` phase holds the
port's draw on the card's host to it (``init_check``), and
tests/test_torch_prng.py holds the port's draw on the CPU to it.  The
initial parameters depend on the flags and the embedding width only, so
a small corpus from tools/make_synthetic_ptb.py (whose embeddings do not
depend on its size) stands in for the demonstration's.

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
