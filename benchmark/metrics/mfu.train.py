"""The whole train step's share of the card's peak, in %: the window's
steps' matmul-like FLOP, counted from their padded shapes in closed form
with the least formulation the repository knows
(``benchmark/core/flops.py:train_step``), over the window's seconds,
over the peak of the configuration's compute dtype."""


def read(run):
    if run.kind != "train" or run.window_s <= 0 or not run.flops:
        return None
    return 100.0 * run.flops / run.window_s / run.peak_flops
