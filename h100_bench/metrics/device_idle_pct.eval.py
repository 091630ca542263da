"""device_idle_pct.eval: the share of the traced window in which no kernel,
copy or memset ran on the card (torch.profiler). Moves eval_images_per_s."""

from h100_bench import layers


def read(cell, outcome):
    return layers.idle_pct(outcome)
