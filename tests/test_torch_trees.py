"""The port's decode (C decoder and python oracle) vs the JAX package's."""

import os

import numpy as np
import pytest

from cliora_tpu.analysis import trees as jtrees
from cliora_tpu_torch import native
from cliora_tpu_torch.analysis import trees
from cliora_tpu_torch.chart.offsets import random_backpointers


@pytest.mark.parametrize("n", [1, 2, 5, 13, 20])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_decode_batch_matches_python_and_jax(n, with_lengths):
    rs = np.random.RandomState(n)
    bp = random_backpointers(rs, n, 9)
    lengths = (rs.randint(1, n + 1, 9).astype(np.int32)
               if with_lengths else None)
    got = trees.decode_batch(bp, n, lengths)
    assert trees.last_decoder == ("native" if native.load() else "python")
    oracle = []
    for b in range(9):
        m = None if lengths is None else int(lengths[b])
        tree = trees.bp_to_tree(n, bp[b], length=m)
        oracle.append((tree, trees.tree_to_spans(tree)))
    assert got == oracle
    assert got == jtrees.decode_batch(bp, n, lengths)


def test_native_builds_into_port_build_dir():
    mod = native.load()
    if mod is None:
        pytest.skip("no C compiler to build the native decoder")
    assert os.path.dirname(os.path.dirname(mod.__file__)) == native.BUILD_DIR
    assert "cliora_tpu_torch" in mod.__file__


def test_tree_strings_match_jax():
    rs = np.random.RandomState(3)
    bp = random_backpointers(rs, 7, 4)
    words = list("abcdefg")
    for row in bp:
        tree = trees.bp_to_tree(7, row)
        assert tree == jtrees.bp_to_tree(7, row)
        assert trees.tree_to_string(tree, words) == \
            jtrees.tree_to_string(tree, words)
        assert trees.replace_leaves(tree, words) == \
            jtrees.replace_leaves(tree, words)
