"""The parse forward's share of the card's peak, in %: the window's
requests' matmul-like FLOP (embed, leaves, the inside pass with its
child-linear terms taken once a cell, ``benchmark/core/flops.py:
parse_forward``), over the window's seconds, over the peak of the
configuration's compute dtype."""


def read(run):
    if run.kind != "parse" or run.window_s <= 0 or not run.flops:
        return None
    return 100.0 * run.flops / run.window_s / run.peak_flops
