"""Port parity for the RoI / exact-position taps (ops/roi_align.py, kernel
K2's plain version) against the JAX package and the NumPy torchvision
roi_align oracle, on the CPU. Tolerance 1e-5: the same f32 axis weights
contracted with the map in another summation order."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _reference_bridge import tv_roi_align

import ood_in_object_detection_tpu.ops.pallas.roi as proi
from ood_in_object_detection_tpu.ops import roi_align as jroi
from ood_in_object_detection_torch.ops import roi_align as troi


def _weights(rng, b, n2, h, w):
    return (rng.uniform(size=(b, n2, w)).astype(np.float32),
            rng.uniform(size=(b, n2, h)).astype(np.float32))


@pytest.mark.parametrize("b,n2,h,w,c", [(2, 34, 16, 16, 8), (1, 7, 8, 8, 8), (2, 600, 12, 12, 16)])
def test_plain_contraction_matches_pallas_two_stage(b, n2, h, w, c, monkeypatch):
    rng = np.random.default_rng(n2)
    f = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wx, wy = _weights(rng, b, n2, h, w)
    monkeypatch.setattr(proi.pl, "pallas_call",
                        functools.partial(proi.pl.pallas_call, interpret=True))
    ref = np.asarray(proi.roi_matmul_level_two_stage(jnp.asarray(f), jnp.asarray(wx), jnp.asarray(wy)))
    got = troi.roi_contract(torch.from_numpy(f), torch.from_numpy(wx), torch.from_numpy(wy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_roi_contract_rejects_mismatched_shapes():
    f = torch.zeros(1, 4, 5, 3)
    with pytest.raises(ValueError):
        troi.roi_contract(f, torch.zeros(1, 2, 4), torch.zeros(1, 2, 4))


def _setup(seed=0, b=3, n=17):
    rng = np.random.default_rng(seed)
    fmaps = [rng.normal(size=(b, 16, 16, 8)).astype(np.float32),
             rng.normal(size=(b, 8, 8, 12)).astype(np.float32),
             rng.normal(size=(b, 4, 4, 24)).astype(np.float32)]
    xy = rng.uniform(-10, 100, size=(b, n, 2))
    wh = rng.uniform(0.5, 60, size=(b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    level = rng.integers(0, 3, size=(b, n))
    aidx = rng.integers(0, sum(f.shape[1] * f.shape[2] for f in fmaps), size=(b, n))
    return fmaps, boxes, level, aidx


@pytest.mark.parametrize("samples", [0, 4])
def test_roi_and_exact_matches_jax(samples):
    fmaps, boxes, level, aidx = _setup()
    j_roi, j_ex = jroi.roi_and_exact_batched(
        [jnp.asarray(f) for f in fmaps], jnp.asarray(boxes), jnp.asarray(aidx, jnp.int32),
        jnp.asarray(level, jnp.int32), img_w=128, samples=samples)
    t_roi, t_ex = troi.roi_and_exact_batched(
        [torch.from_numpy(f) for f in fmaps], torch.from_numpy(boxes), torch.from_numpy(aidx),
        torch.from_numpy(level), img_w=128, samples=samples)
    np.testing.assert_allclose(t_roi.numpy(), np.asarray(j_roi), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_ex.numpy(), np.asarray(j_ex), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("samples", [0, 3])
def test_axis_weights_match_jax(samples):
    rng = np.random.default_rng(7)
    lo = rng.uniform(-3, 40, 64).astype(np.float32)
    span = rng.uniform(0.2, 45, 64).astype(np.float32)
    ref = np.asarray(jroi._axis_weights(jnp.asarray(lo), jnp.asarray(span), 40, samples))
    got = troi._axis_weights(torch.from_numpy(lo), torch.from_numpy(span), 40, samples).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("samples", [0, 2])
def test_roi_align_matches_torchvision_oracle(samples):
    """Adaptive (sampling_ratio=-1) and fixed grids against the NumPy
    re-implementation of torchvision.ops.roi_align (aligned=False)."""
    rng = np.random.default_rng(3)
    c, h, w, img = 5, 24, 24, 96  # square, like the letterboxed inputs
    fmap = rng.normal(size=(1, c, h, w)).astype(np.float32)
    xy = rng.uniform(0, 80, size=(12, 2))
    wh = rng.uniform(1, 70, size=(12, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, img)], -1).astype(np.float32)
    scale = w / img
    ref = tv_roi_align(torch.from_numpy(fmap), [torch.from_numpy(boxes)], (1, 1),
                       spatial_scale=scale, sampling_ratio=samples or -1, aligned=False)
    got = troi.roi_align_1x1_batched_level(
        torch.from_numpy(np.ascontiguousarray(fmap.transpose(0, 2, 3, 1))),
        torch.from_numpy(boxes)[None], scale, samples=samples)
    np.testing.assert_allclose(got[0].numpy(), ref[:, :, 0, 0].numpy(), rtol=1e-5, atol=1e-5)
