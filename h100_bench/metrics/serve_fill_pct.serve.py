"""serve_fill_pct.serve: requests the window served over (device steps x
batch_size): the steps counted around MicroBatchServer's step call by the
benchmark, the requests by their futures. Moves serve_p95_ms."""


def read(cell, outcome):
    steps = outcome.layer.get("steps", 0)
    if not steps:
        return None
    return 100.0 * outcome.layer["served"] / (steps * outcome.layer["batch_size"])
