"""step_mfu.train: the training step's share of the card's peak in the
traced window: 3 x the forward FLOPs an image (flops.py) x images trained,
over the window's seconds and the dtype's peak (roofline.py). Moves
train_images_per_s."""

from h100_bench import flops, layers


def read(cell, outcome):
    return layers.step_mfu_pct(cell, outcome, float(flops.train_flops(cell.config)))
