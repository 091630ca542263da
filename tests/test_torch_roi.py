"""Port parity for the RoI / exact-position taps (ops/roi_align.py, kernel
K2's plain version) against the JAX package and the NumPy torchvision
roi_align oracle, on the CPU. Tolerance 1e-5: the same f32 axis weights
contracted with the map in another summation order.

bf16 maps (--bf16): the plain contraction rounds Q = wy * wx to bf16 and
sums bf16(Q) * f in f32, the contract of ops/pallas/roi.py:
roi_matmul_level_pallas; it is held against that kernel's store variant
(interpret mode) at f32 sum-order tolerance, and against its expand variant,
which rounds wy to bf16 before the product, within one bf16 ulp of Q times
sum |f|."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _reference_bridge import tv_roi_align

import ood_in_object_detection_tpu.ops.pallas.roi as proi
from ood_in_object_detection_tpu.ops import roi_align as jroi
from ood_in_object_detection_torch.ops import roi_align as troi
from torch_threads import _two_threads  # noqa: F401 (autouse)


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


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bf16_level(seed, b, n2, h, w, c):
    """A bf16 map and RoI-like axis weights: a run of positive hats per row,
    plus one-hot rows as the exact tap has."""
    rng = np.random.default_rng(seed)
    f = _bf16(rng.normal(size=(b, h, w, c)).astype(np.float32))
    wx = np.zeros((b, n2, w), np.float32)
    wy = np.zeros((b, n2, h), np.float32)
    for i in range(b):
        for n in range(n2):
            if n % 4 == 3:
                wx[i, n, rng.integers(0, w)] = wy[i, n, rng.integers(0, h)] = 1.0
                continue
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            x1, y1 = min(w, x0 + rng.integers(1, 9)), min(h, y0 + rng.integers(1, 9))
            wx[i, n, x0:x1] = rng.uniform(0.01, 1, x1 - x0) / (x1 - x0)
            wy[i, n, y0:y1] = rng.uniform(0.01, 1, y1 - y0) / (y1 - y0)
    return f, wx, wy


def _pallas_roi(f, wx, wy, variant, monkeypatch):
    monkeypatch.setattr(proi.pl, "pallas_call",
                        functools.partial(proi.pl.pallas_call, interpret=True))
    return np.asarray(proi.roi_matmul_level_pallas(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(wx), jnp.asarray(wy), variant=variant))


@pytest.mark.parametrize("b,n2,h,w,c", [(2, 24, 12, 12, 16), (1, 40, 20, 16, 8)])
def test_plain_bf16_matches_pallas_store(b, n2, h, w, c, monkeypatch):
    f, wx, wy = _bf16_level(n2, b, n2, h, w, c)
    ref = _pallas_roi(f, wx, wy, "store", monkeypatch)
    got = troi.roi_contract(torch.from_numpy(f).to(torch.bfloat16), torch.from_numpy(wx),
                            torch.from_numpy(wy))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_plain_bf16_within_an_ulp_of_pallas_expand(monkeypatch):
    """expand rounds wy to bf16 before forming Q, so its Q is bf16(bf16(wy)
    * wx): each term may sit one bf16 ulp of Q (<= 2^-7 |Q|) away."""
    f, wx, wy = _bf16_level(5, 2, 24, 12, 12, 16)
    ref = _pallas_roi(f, wx, wy, "expand", monkeypatch)
    got = troi.roi_contract_plain(torch.from_numpy(f).to(torch.bfloat16), torch.from_numpy(wx),
                                  torch.from_numpy(wy)).numpy()
    q = np.abs(wy[..., :, None] * wx[..., None, :]).reshape(2, 24, -1)
    bound = 2.0 ** -7 * np.einsum("bnk,bkc->bnc", q, np.abs(f).reshape(2, -1, 16))
    assert (np.abs(got - ref) <= bound + 1e-5 * np.abs(ref).max()).all()
    assert np.abs(got - ref).max() > 0, "the variants agree exactly: the case checks nothing"


def test_plain_bf16_is_the_f32_sum_of_rounded_q():
    """The contract itself, in float64 from the bf16-rounded Q and map; the
    one-hot rows reproduce the map's bf16 values exactly."""
    f, wx, wy = _bf16_level(9, 2, 32, 10, 14, 8)
    got = troi.roi_contract_plain(torch.from_numpy(f).to(torch.bfloat16), torch.from_numpy(wx),
                                  torch.from_numpy(wy)).numpy()
    q = _bf16((wy[..., :, None] * wx[..., None, :]).reshape(2, 32, -1)).astype(np.float64)
    want = np.einsum("bnk,bkc->bnc", q, f.reshape(2, -1, 8).astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    onehot = (wx.max(-1) == 1.0) & (wy.max(-1) == 1.0)
    np.testing.assert_array_equal(got[onehot], want[onehot])


@pytest.mark.parametrize("samples", [0, 4])
def test_roi_and_exact_bf16_matches_jax(samples):
    """Both packages' level-routed taps on bf16 maps (the JAX XLA branch,
    ops/roi_align.py:307-311): bf16 outputs, one bf16 rounding of the same
    f32 sums apart at most."""
    fmaps, boxes, level, aidx = _setup(seed=4)
    fmaps = [_bf16(f) for f in fmaps]
    j_roi, j_ex = jroi.roi_and_exact_batched(
        [jnp.asarray(f, jnp.bfloat16) for f in fmaps], jnp.asarray(boxes),
        jnp.asarray(aidx, jnp.int32), jnp.asarray(level, jnp.int32), img_w=128, samples=samples)
    t_roi, t_ex = troi.roi_and_exact_batched(
        [torch.from_numpy(f).to(torch.bfloat16) for f in fmaps], torch.from_numpy(boxes),
        torch.from_numpy(aidx), torch.from_numpy(level), img_w=128, samples=samples)
    assert j_roi.dtype == jnp.bfloat16 and t_roi.dtype == torch.bfloat16
    for t, j in ((t_roi, j_roi), (t_ex, j_ex)):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.float().numpy(), j, rtol=2.0 ** -7, atol=1e-6 * np.abs(j).max())
    np.testing.assert_array_equal(t_ex.float().numpy(), np.asarray(j_ex, np.float32))


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts one element past a 16-byte
    aligned allocation."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=dtype)
    t = base[1:n + 1].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("dtype,c,vector", [
    (torch.bfloat16, 256, True), (torch.bfloat16, 512, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 33, False), (torch.bfloat16, 12, False),
    (torch.float32, 256, True), (torch.float32, 12, True), (torch.float32, 33, False),
    (torch.float32, 6, False)])
def test_k2_path_by_channels(dtype, c, vector):
    """K2 loads 8 bf16 or 4 f32 channels per lane where C allows it, else
    one channel per lane."""
    f = torch.zeros((2, 5, 7, c), dtype=dtype)
    assert f.data_ptr() % 16 == 0
    wx, wy = torch.zeros((2, 3, 7)), torch.zeros((2, 3, 5))
    assert troi.k2_vector_path(f, wx, wy) is vector


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_path_scalar_for_misaligned_map(dtype):
    f = _misaligned((1, 4, 4, 64), dtype)
    assert troi.k2_vector_path(f, torch.zeros((1, 2, 4)), torch.zeros((1, 2, 4))) is False


@pytest.mark.parametrize("case", ["f16_map", "f64_weights", "strided_map", "strided_wx",
                                  "huge_map"])
def test_k2_refuses_what_the_kernel_does_not_take(case):
    f = torch.zeros((1, 4, 6, 8))
    wx, wy = torch.zeros((1, 3, 6)), torch.zeros((1, 3, 4))
    if case == "f16_map":
        f, err = f.half(), TypeError
    elif case == "f64_weights":
        wx, err = wx.double(), TypeError
    elif case == "strided_map":
        f, err = torch.zeros((1, 6, 4, 8)).transpose(1, 2), ValueError
    elif case == "strided_wx":
        wx, err = torch.zeros((1, 6, 3)).transpose(1, 2), ValueError
    else:
        f, err = torch.zeros((1, 1025, 1024, 1)), ValueError
        wx, wy = torch.zeros((1, 3, 1024)), torch.zeros((1, 3, 1025))
    with pytest.raises(err):
        troi.k2_vector_path(f, wx, wy)
