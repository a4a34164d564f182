"""The arithmetic of the f32 route of kernel K4
(cliora_tpu_torch/csrc/span_region.cu ``k4_dobj_regs``, f32 spans with
R = 36), emulated in plain torch on the CPU and held to the plain version
with the limit the kernel is held to on the card: the rows of each
``dobj_segments`` segment summed in increasing order, one fmaf a row per
accumulator entry, and the segments added in order.
"""

import numpy as np
import pytest
import torch

from cliora_tpu_torch.ops import span_region as sr

RTOL = 1e-4          # SR_F32_RTOL of chip_smoke.py: a fraction of the scale


def _f32(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


def _dobj_in_segment_order(span, am, g, R, segs):
    """K4's f32 order: segment z takes rows [A M z / segs, A M (z + 1) /
    segs) in increasing order, one fused multiply-add a row into the
    accumulator entry its region picks (the f64 product of two f32 values
    is exact; its sum rounded to f32 is the fmaf); the segments' f32 sums
    are then added in segment order."""
    A, M, D = span.shape
    C = g.shape[1]
    rows = A * M
    img = torch.arange(C)
    out = None
    for z in range(segs):
        acc = torch.zeros(C, R, D, dtype=torch.float32)
        for row in range(rows * z // segs, rows * (z + 1) // segs):
            a, m = divmod(row, M)
            r = am[a, :, m].long()
            upd = (acc[img, r].double()
                   + g[a, :, m].double()[:, None] * span[a, m].double())
            acc[img, r] = upd.float()
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("a,m,c,d,ties", [
    (128, 20, 16, 16, False),       # the VG call's rows, 10 segments
    (64, 100, 16, 24, False),       # the card test's many segments
    (37, 13, 37, 40, False),        # one segment
    (128, 20, 16, 16, True),        # every row on region 0 (init)
    (128, 20, 128, 400, False)])    # the VG call itself: 2 segments
def test_dobj_segment_order_matches_plain(a, m, c, d, ties):
    """K4's f32 route in the segment count ``dobj_segments`` gives it at
    R = 36 and in its order, within 1e-4 of the plain version's scale;
    every row lands in exactly one segment."""
    R = 36
    rs = np.random.RandomState(a + m + c)
    span = _f32(rs, a, m, d)
    am = torch.from_numpy(rs.randint(0, R, (a, c, m)).astype(np.int32))
    if ties:
        am = torch.zeros_like(am)
    g = _f32(rs, a, c, m)
    segs = sr.dobj_segments(a * m, c, R, d, False)
    rows = a * m
    bounds = [(rows * z // segs, rows * (z + 1) // segs) for z in range(segs)]
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(hi == lo for (_, hi), (lo, _) in zip(bounds, bounds[1:]))
    want = sr.span_region_dobj_plain(span, am, g, R, torch.float32)
    got = _dobj_in_segment_order(span, am, g, R, segs)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= RTOL * scale
    if (a, m, c) == (128, 20, 16):
        assert segs == 10
    if (a, m, c) == (128, 20, 128):
        assert segs == 2


def test_wrappers_refuse_unaligned_operands():
    """TMA, 16-byte cp.async copies and float4 loads need a 16-byte-aligned
    base, in f32 as in bf16: a view 4 bytes past the start is refused."""
    buf = torch.zeros(65)
    sr._check_aligned("span", buf[:64])
    with pytest.raises(ValueError, match="16-byte"):
        sr._check_aligned("span", buf[1:])
