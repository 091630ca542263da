"""step_mfu.eval: the predict step's share of the card's peak in the traced
window: forward FLOPs an image (flops.py, from the configuration's layer
shapes) x images completed, over the window's seconds and the dtype's peak
(roofline.py). Moves eval_images_per_s."""

from h100_bench import flops, layers


def read(cell, outcome):
    return layers.step_mfu_pct(cell, outcome, float(flops.forward_flops(cell.config)))
