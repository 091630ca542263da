"""k2_roi_roofline_pct.eval: the RoI and exact-position taps' least time
(the map cells the boxes' samples touch, read once, the outputs written
once; roofline.py) over the device time of every kernel launched inside the
span the benchmark puts around the program's call into
ops/roi_align.py:roi_and_exact_batched (K2 and its axis weights). Moves
eval_images_per_s."""

from h100_bench import layers


def read(cell, outcome):
    return layers.span_roofline_pct(outcome, "k2_roi", layers.roi_least_s)
