"""Faults planted in the program under the check of ``correct``.

Each breaks a built trainer in place, the way a later change could break
the timed path, so that the check's own tests and readings can see it
fail: a train step that leaves the state unchanged, a train step that
takes the mean over half of its batch, a parse that answers for half of
its rows, and a parse whose trees are altered where they are produced
(the root's split moved by one).
"""

from __future__ import annotations

import numpy as np


def state_unchanged(trainer):
    trainer.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer):
    whole = trainer._microbatches

    def half(tokens, obj, lengths):
        return [tuple(None if x is None else x[: x.shape[0] // 2]
                      for x in part)
                for part in whole(tokens, obj, lengths)]

    trainer._microbatches = half


def parse_half_batch(trainer):
    whole = trainer.parse

    def parse(batch_map, **kw):
        res, metrics = whole(batch_map, **kw)
        res["cky_bp"] = res["cky_bp"][: len(res["cky_bp"]) // 2]
        return res, metrics

    trainer.parse = parse


def parse_altered_answer(trainer):
    whole = trainer.parse

    def parse(batch_map, **kw):
        res, metrics = whole(batch_map, **kw)
        n = np.shape(batch_map["sentences"])[1]
        if n > 2:
            bp = np.array(res["cky_bp"], copy=True)
            root = n * (n + 1) // 2 - 1
            bp[:, root] = (bp[:, root] + 1) % (n - 1)
            res["cky_bp"] = bp
        return res, metrics

    trainer.parse = parse


FAULTS = {
    "train": {"state_unchanged": state_unchanged, "half_batch": half_batch},
    "parse": {"half_batch": parse_half_batch,
              "altered_answer": parse_altered_answer},
}
