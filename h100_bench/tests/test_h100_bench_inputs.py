"""The benchmark's inputs and its arithmetic on the CPU: generators that
repeat by seed, and FLOP counts against ultralytics' published totals."""

import json

import numpy as np
import pytest
import torch

from h100_bench import flops, scenes
from h100_bench.tests.tiny import BENCH

# ultralytics' README tables, 640 px, nc 80: yolov8l 165.2 GFLOPs, yolo12l 88.9
# (thop counts the convolutions; the area attention's matmuls are functional
# calls it does not count)
PUBLISHED_GFLOPS = {"yolov8l-nc20": 165.2, "yolo12l-nc20": 88.9}
FLOPS_TOL = 0.005


def test_scenes_repeat_by_seed():
    a = scenes.make_scenes(torch.Generator().manual_seed(2 ** 33 + 5), 2, 64)
    b = scenes.make_scenes(torch.Generator().manual_seed(2 ** 33 + 5), 2, 64)
    c = scenes.make_scenes(torch.Generator().manual_seed(2 ** 33 + 6), 2, 64)
    assert a.dtype == np.uint8 and a.shape == (2, 64, 64, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_arrivals_repeat_by_seed_and_share_their_gaps():
    a = scenes.poisson_arrivals(80.0, 20.0, 2 ** 40 + 1)
    b = scenes.poisson_arrivals(80.0, 20.0, 2 ** 40 + 1)
    c = scenes.poisson_arrivals(80.0, 20.0, 2 ** 40 + 2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert (np.diff(a) > 0).all() and a[-1] < 20.0
    # every seed offers the same gaps, in another order
    ga, gc = np.sort(np.diff(np.r_[0.0, a])), np.sort(np.diff(np.r_[0.0, c]))
    k = min(len(ga), len(gc)) - 5
    assert np.allclose(ga[:k], gc[:k])
    assert abs(len(a) - 1600) <= 5


@pytest.mark.parametrize("name", sorted(PUBLISHED_GFLOPS))
def test_flops_match_published(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    parts = flops.forward_parts(dict(cfg, nc=80), 640)
    assert abs(parts["conv"] / 1e9 / PUBLISHED_GFLOPS[name] - 1) < FLOPS_TOL
    assert flops.forward_flops(cfg) == sum(flops.forward_parts(cfg).values())
    assert flops.train_flops(cfg) == 3 * flops.forward_flops(cfg)
    if name.startswith("yolo12"):
        assert parts["attention"] > 0


def test_yolo12l_attention_flops_from_shapes():
    """A2C2f at P4 (40x40 tokens, 256 channels, 4 areas; 4 blocks of 2
    ABlocks) and at P5 (20x20, one area; 4 x 2): 2 products of 2 N^2 C / area."""
    cfg = json.loads((BENCH / "configs" / "yolo12l-nc20.json").read_text())
    p4 = 8 * 2 * 2 * 1600 ** 2 * 256 / 4
    p5 = 8 * 2 * 2 * 400 ** 2 * 256
    assert flops.forward_parts(cfg)["attention"] == p4 + p5
