"""device_idle_pct.serve: the share of the traced window in which no kernel,
copy or memset ran on the card (torch.profiler). Moves serve_p95_ms."""

from h100_bench import layers


def read(cell, outcome):
    return layers.idle_pct(outcome)
