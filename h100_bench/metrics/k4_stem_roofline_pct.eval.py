"""k4_stem_roofline_pct.eval: the stem's least time (its two convolutions'
bytes and operations from their shapes, roofline.py) over the device time of
every kernel launched inside the span the benchmark puts around the
program's call into ops/stem.py:fused_stem (K4 and its operand packing).
Moves eval_images_per_s."""

from h100_bench import layers


def read(cell, outcome):
    return layers.span_roofline_pct(outcome, "k4_stem", layers.stem_least_s)
