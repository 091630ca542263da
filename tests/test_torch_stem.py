"""The port's inference stem (ops/stem.py) against the JAX package's, on the
CPU: fused_stem_plain against models/folded_stem.py:phase_folded_stem (the
JAX model's stem) in f32 and bf16 and against ops/pallas/stem.py:pallas_stem
in interpret mode (the Pallas kernel that K4 replaces), the corner impulse
that exercises every zero-padding path, the unfused Conv modules at v8l
width, and the port's YOLOv8n forward with the folded stem on and off.

Tolerances: f32 2e-5 (rtol and atol), the same convolutions summed in
another order. bf16: 2 ** -7 of the map's largest magnitude, two bf16 ulps
of it: both sides round at the same points (the folded convs' outputs, the
multiply-add of inference BN, SiLU), but XLA and PyTorch may keep f32
between two of them, so an element can land one ulp apart at each of the
two roundings.

Inputs come from numpy seeds; weights are HWIO on the JAX side and OIHW in
the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ood_in_object_detection_tpu.models.folded_stem import phase_folded_stem, space_to_depth4
from ood_in_object_detection_tpu.ops.pallas.stem import pallas_stem
from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.ops import stem as S
from ood_in_object_detection_torch.utils.weights import calibrate_batchnorm
from test_torch_kernels_cuda import k4_contract, stem_convs
from torch_threads import _two_threads  # noqa: F401 (autouse)


def _params(seed, c1, c2):
    """JAX-side (HWIO, bn dicts) stem parameters, as tests/test_pallas_stem.py
    draws them."""
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(3, 3, 3, c1)) * 0.5).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, c1, c2)) * 0.2).astype(np.float32)

    def bn(c):
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (rng.normal(size=c) * 0.1).astype(np.float32),
                "mean": (rng.normal(size=c) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}

    return w1, bn(c1), w2, bn(c2)


def _torch_params(w1, bn1, w2, bn2):
    tbn = lambda bn: {k: torch.from_numpy(v) for k, v in bn.items()}  # noqa: E731
    return (torch.from_numpy(w1.transpose(3, 2, 0, 1).copy()), tbn(bn1),
            torch.from_numpy(w2.transpose(3, 2, 0, 1).copy()), tbn(bn2))


def _jax(fn, *args, **kw):
    return fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else
                {k: jnp.asarray(v) for k, v in a.items()} for a in args], **kw)


def _plain(x, params, dtype):
    """fused_stem_plain on NHWC numpy -> NHWC f32 numpy."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    return S.fused_stem_plain(xt, *_torch_params(*params), dtype).permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("c1,c2,h,w", [(16, 32, 32, 48), (64, 128, 64, 64), (80, 160, 32, 32)])
def test_plain_matches_phase_folded_stem_f32(c1, c2, h, w):
    params = _params(c1 + h, c1, c2)
    x = np.random.default_rng(w).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    want = np.asarray(_jax(phase_folded_stem, x, *params, dtype=jnp.float32))
    got = _plain(x, params, torch.float32)
    assert got.shape == (2, h // 4, w // 4, c2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c1,c2", [(16, 32), (64, 128)])
def test_plain_matches_phase_folded_stem_bf16(c1, c2):
    params = _params(c1, c1, c2)
    x = np.random.default_rng(c2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = _jax(phase_folded_stem, x, *params, dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = S.fused_stem_plain(xt, *_torch_params(*params), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 2.0 ** -7, f"bf16 stem differs by {err} of the map's scale"


@pytest.mark.parametrize("name,seed", [("yolo11x", 0), ("yolo12x", 1)])
def test_x_scale_stem_matches_phase_folded_stem_bf16(name, seed):
    """yolo11x's and yolo12x's stems (C1 96, C2 192) take the fused route,
    as the JAX model folds them, and in bf16 fused_stem (the CPU's plain
    version) stays within 2^-7 of the map's scale of JAX's
    phase_folded_stem; as two Conv modules they rounded at other points,
    1.44e-2 of the scale apart."""
    with torch.device("meta"):
        tm = build_model(name, nc=2)
    assert tm.stem_route == "fused" and tm.stem_widths == (96, 192)
    params = _params(seed, 96, 192)
    x = np.random.default_rng(seed + 7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(_jax(phase_folded_stem, x, *params, dtype=jnp.bfloat16), np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = S.fused_stem(xt, *stem_convs(_torch_params(*params)), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 192, 16, 16)
    err = np.abs(got.permute(0, 2, 3, 1).float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2.0 ** -7, f"{name}: bf16 stem differs by {err} of the map's scale"


@pytest.mark.parametrize("c1,c2,hw", [(16, 32, 64), (32, 64, 64), (16, 32, 128)])
def test_plain_matches_pallas_stem(c1, c2, hw):
    """The mirror of tests/test_pallas_stem.py:35-45, against the port."""
    params = _params(hw + c1, c1, c2)
    x = np.random.default_rng(hw).uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    z = space_to_depth4(jnp.asarray(x))
    want = np.asarray(pallas_stem(z, *[jnp.asarray(p) if isinstance(p, np.ndarray) else
                                       {k: jnp.asarray(v) for k, v in p.items()}
                                       for p in params], dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(_plain(x, params, torch.float32), want, rtol=2e-5, atol=2e-5)


def test_corner_impulse_matches_jax():
    """One bright pixel at the image corner: the top and left zero padding
    of both convs (tests/test_pallas_stem.py:47-57)."""
    params = _params(5, 16, 32)
    x = np.zeros((1, 32, 32, 3), np.float32)
    x[0, 0, 0, 0] = 5.0
    got = _plain(x, params, torch.float32)
    folded = np.asarray(_jax(phase_folded_stem, x, *params, dtype=jnp.float32))
    pallas = np.asarray(pallas_stem(space_to_depth4(jnp.asarray(x)),
                                    *[jnp.asarray(p) if isinstance(p, np.ndarray) else
                                      {k: jnp.asarray(v) for k, v in p.items()} for p in params],
                                    dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got, folded, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


def test_fused_stem_matches_unfused_convs_v8l_width():
    """fused_stem (its plain version, on the CPU) against the two Conv
    modules it replaces, at yolov8l's stem widths (C1=64, C2=128)."""
    conv0, conv1 = stem_convs(_torch_params(*_params(11, 64, 128)))
    x = torch.from_numpy(np.random.default_rng(11).uniform(0, 1, (2, 3, 64, 96)).astype(np.float32))
    with torch.no_grad():
        want = conv1(conv0(x))
        got = S.fused_stem(x, conv0, conv1, torch.float32)
    assert got.shape == want.shape == (2, 128, 16, 24)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=2e-5 * float(want.abs().max()))


def test_bn_fold_matches_jax():
    from ood_in_object_detection_tpu.ops.pallas.stem import _bn_fold

    _, bn1, _, _ = _params(3, 16, 32)
    inv, shift = S.bn_fold({k: torch.from_numpy(v) for k, v in bn1.items()})
    jinv, jshift = _bn_fold({k: jnp.asarray(v) for k, v in bn1.items()})
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6)
    np.testing.assert_allclose(shift.numpy(), np.asarray(jshift), rtol=1e-6, atol=1e-7)


def test_k4_weights_layout():
    """K4's operand layout: w1 (27, C1) holds the BN-folded conv1 weight of
    channel o at [9 ci + 3 dy + dx, o]; w2 (C1, 9, C2) the conv2 weight of
    output channel o at [c1, 3 dy + dx, o]."""
    w1, bn1, w2, bn2 = _torch_params(*_params(4, 16, 64))
    w1k, b1, w2k, b2 = S.k4_weights(w1, bn1, w2, bn2, torch.float32)
    inv1, _ = S.bn_fold(bn1)
    inv2, shift2 = S.bn_fold(bn2)
    assert w1k.shape == (27, 16) and w2k.shape == (16, 9, 64)
    np.testing.assert_allclose(w1k[9 * 2 + 3 * 1 + 0, 5].item(),
                               (w1[5, 2, 1, 0] * inv1[5]).item(), rtol=1e-6)
    np.testing.assert_allclose(w2k[5, 3 * 2 + 1, 39].item(),
                               (w2[39, 5, 2, 1] * inv2[39]).item(), rtol=1e-6)
    torch.testing.assert_close(b2, shift2)
    bf = S.k4_weights(w1, bn1, w2, bn2, torch.bfloat16)[2]
    assert torch.equal(bf, bf.to(torch.bfloat16).float()), "bf16 weights are not rounded"


@pytest.mark.parametrize("shape,c1,c2", [((1, 3, 64, 64), 104, 128), ((1, 3, 64, 64), 64, 200),
                                         ((1, 4, 64, 64), 16, 32), ((1, 3, 66, 64), 16, 32)])
def test_k4_refuses_shapes(shape, c1, c2):
    with pytest.raises(ValueError, match="K4 takes"):
        S.check_k4_shapes(shape, c1, c2)


@pytest.fixture(scope="module")
def v8n():
    model = build_model("yolov8n", nc=2)
    init_weights(model, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 3, 96, 96)).astype(np.float32))
    calibrate_batchnorm(model, x)
    return model, x


def test_v8n_forward_folded_stem_on_off(v8n):
    model, x = v8n
    assert model._can_fold_stem(x)
    with torch.no_grad():
        on = model(x)
        model.folded_stem = False
        try:
            off = model(x)
        finally:
            model.folded_stem = True
    for a, b in zip(on[0] + on[1], off[0] + off[1]):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5 * np.abs(b).max())


def test_fold_gate(v8n):
    """The JAX gate (yolo.py:398-410): no fold in training or for H, W not
    multiples of 4; the fold calls fused_stem."""
    model, x = v8n
    assert not model._can_fold_stem(x[..., :94, :94])
    model.train()
    try:
        assert not model._can_fold_stem(x)
    finally:
        model.eval()
    calls = []
    real = S.fused_stem

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    import ood_in_object_detection_torch.models.yolo as Y

    Y.fused_stem = spy
    try:
        with torch.no_grad():
            model(x)
            model(x[..., :94, :94])
    finally:
        Y.fused_stem = real
    assert calls == [x.shape]


@pytest.mark.parametrize("c1,c2", [(16, 32), (32, 64)])
def test_k4_contract_matches_pallas_stem_bf16(c1, c2):
    """K4's arithmetic, emulated in plain PyTorch (the CUDA tests hold the
    kernel to it), is pallas_stem's in bf16: BN folded into bf16 weights,
    f32 sums, the conv1 map rounded to bf16. Sum order aside, a conv1 value
    may round to the other side: 2^-7 of the map's scale."""
    params = _params(c1 + 1, c1, c2)
    x = np.random.default_rng(c1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = pallas_stem(space_to_depth4(jnp.asarray(x)),
                       *[jnp.asarray(p) if isinstance(p, np.ndarray) else
                         {k: jnp.asarray(v) for k, v in p.items()} for p in params],
                       dtype=jnp.bfloat16, interpret=True)
    want = np.asarray(want, np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = k4_contract(xt, *_torch_params(*params), torch.bfloat16)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    plain = _plain(x, params, torch.bfloat16)
    assert np.abs(plain - want).max() <= 2.0 ** -5 * np.abs(want).max()


def _unpack_mma_b(frags: np.ndarray) -> np.ndarray:
    """(N/8, K/16, 32, 4) mma.sync m16n8k16 B fragments -> (K, N), from the
    PTX fragment table: lane = 4 g + t holds B[2t + e % 2 + 8 (e // 2), g]
    of its k-step and n-tile in element e."""
    nts, kss = frags.shape[:2]
    out = np.full((16 * kss, 8 * nts), np.nan, np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(4):
            k = 2 * t + e % 2 + 8 * (e // 2)
            for ks in range(kss):
                out[16 * ks + k, g::8] = frags[:, ks, lane, e]
    return out


@pytest.mark.parametrize("c1,c2", [(16, 32), (24, 48), (64, 128), (80, 160)])
def test_k4_pack_bf16_unpacks_to_k4_weights(c1, c2):
    """K4's tensor-core operands hold k4_weights' folded bf16 weights
    exactly, at the mma fragment positions, with zeros in the padding."""
    w1, bn1, w2, bn2 = _torch_params(*_params(c1 + c2, c1, c2))
    w1k, b1, w2k, b2 = S.k4_weights(w1, bn1, w2, bn2, torch.bfloat16)
    w1p, b1p, w2p, b2p = S.k4_operands(w1, bn1, w2, bn2, torch.bfloat16)
    c1p = -(-c1 // 16) * 16
    assert w1p.dtype == w2p.dtype == torch.bfloat16 and b1p.dtype == b2p.dtype == torch.float32
    assert w1p.shape == (c1p // 8, 2, 32, 4) and w2p.shape == (c2 // 8, 9, c1p // 16, 32, 4)
    assert w1p.is_contiguous() and w2p.is_contiguous()
    want1 = np.zeros((32, c1p), np.float32)
    want1[:27, :c1] = w1k.numpy()
    np.testing.assert_array_equal(_unpack_mma_b(w1p.float().numpy()), want1)
    for tap in range(9):
        want2 = np.zeros((c1p, c2), np.float32)
        want2[:c1] = w2k[:, tap].numpy()
        np.testing.assert_array_equal(_unpack_mma_b(w2p[:, tap].float().numpy()), want2)
    np.testing.assert_array_equal(b1p.numpy(), np.pad(b1.numpy(), (0, c1p - c1)))
    np.testing.assert_array_equal(b2p.numpy(), b2.numpy())


def _k4_packed_emulation(x: torch.Tensor, w1p, b1p, w2p, b2p) -> torch.Tensor:
    """The bf16 kernel's two implicit GEMMs in plain PyTorch, on its packed
    operands: conv1 as (pixels, 32) x (32, C1p) with K ordered (ci, dy, dx),
    h1 rounded to bf16, conv2 as (pixels, 9 C1p) x (9 C1p, C2) with K
    ordered (tap, c); products exact and sums in f64, bias and SiLU in f32."""
    b, _, h, w = x.shape
    w1 = torch.from_numpy(_unpack_mma_b(w1p.float().numpy())).double()
    w2 = torch.cat([torch.from_numpy(_unpack_mma_b(w2p[:, t].float().numpy()))
                    for t in range(9)]).double()                   # (9 C1p, C2)
    c1p, c2 = w1.shape[1], w2.shape[1]
    a1 = F.unfold(x.to(torch.bfloat16).double(), 3, padding=1, stride=2)   # (B, 27, L)
    a1 = F.pad(a1.transpose(1, 2), (0, 5))                                 # (B, L, 32)
    h1 = F.silu((a1 @ w1).float() + b1p).to(torch.bfloat16)
    h1 = h1.transpose(1, 2).reshape(b, c1p, h // 2, w // 2).double()
    a2 = F.unfold(h1, 3, padding=1, stride=2).reshape(b, c1p, 9, -1)       # (c, tap)
    a2 = a2.permute(0, 3, 2, 1).reshape(b, -1, 9 * c1p)                    # (tap, c)
    y = F.silu((a2 @ w2).float() + b2p).to(torch.bfloat16)
    return y.transpose(1, 2).reshape(b, c2, h // 4, w // 4)


@pytest.mark.parametrize("c1,c2,hw", [(16, 32, 32), (24, 48, 40), (64, 128, 48)])
def test_k4_packed_emulation_matches_plain_bf16(c1, c2, hw):
    """What the bf16 kernel computes from its packed operands agrees with
    the plain version within 2^-5 of the map's scale and with its own
    contract (k4_contract) within 2^-7: the tolerances the CUDA tests hold
    the kernel to."""
    params = _torch_params(*_params(c1 + hw, c1, c2))
    x = torch.from_numpy(np.random.default_rng(hw).uniform(0, 1, (2, 3, hw, hw)).astype(np.float32))
    got = _k4_packed_emulation(x, *S.k4_operands(*params, torch.bfloat16)).float()
    ref = S.fused_stem_plain(x, *params, torch.bfloat16).float()
    scale = float(ref.abs().max())
    assert got.shape == ref.shape == (2, c2, hw // 4, hw // 4)
    assert float((got - ref).abs().max()) <= 2.0 ** -5 * scale
    own = k4_contract(x, *params, torch.bfloat16).float()
    assert float((got - own).abs().max()) <= 2.0 ** -7 * scale


def test_k4_operands_f32_are_k4_weights():
    """In f32 the launcher takes k4_pack_f32: k4_weights' values, conv2's
    weight regrouped into (C1/8, 3, 3, 8, C2) chunks."""
    params = _torch_params(*_params(6, 16, 32))
    got = S.k4_operands(*params, torch.float32)
    want = S.k4_weights(*params, torch.float32)
    for i in (0, 1, 3):
        assert torch.equal(got[i], want[i])
    assert torch.equal(got[2], S.k4_pack_f32(*params)[2])
    assert torch.equal(got[2].permute(0, 3, 1, 2, 4).reshape(16, 9, 32), want[2])


@pytest.mark.parametrize("c1,c2", [(16, 32), (24, 48), (64, 128), (80, 160)])
def test_k4_pack_f32_unpacks_to_k4_weights(c1, c2):
    """Every element of the f32 kernel's streamed chunks is k4_weights'
    folded conv2 weight of its (input channel, tap, output channel)."""
    w1, bn1, w2, bn2 = _torch_params(*_params(c1 + c2 + 1, c1, c2))
    w1k, b1, w2k, b2 = S.k4_weights(w1, bn1, w2, bn2, torch.float32)
    p1, pb1, w2p, pb2 = S.k4_pack_f32(w1, bn1, w2, bn2)
    assert w2p.shape == (c1 // 8, 3, 3, 8, c2) and w2p.is_contiguous()
    assert w2p.dtype == p1.dtype == torch.float32
    for i in (0, 1, 3):
        assert torch.equal((p1, pb1, w2p, pb2)[i], (w1k, b1, w2k, b2)[i])
    wp, wk = w2p.numpy(), w2k.numpy()
    for c in range(c1):
        for dy in range(3):
            for dx in range(3):
                np.testing.assert_array_equal(wp[c // 8, dy, dx, c % 8], wk[c, 3 * dy + dx])
    # a chunk (c8, dy) is 24 consecutive rows of C2: rows dx * 8 + c % 8
    flat = w2p.reshape(-1, c2)
    assert torch.equal(flat[(1 * 3 + 2) * 24 + 1 * 8 + 5], w2k[1 * 8 + 5, 3 * 2 + 1])


def _k4_f32_tile_emulation(x, w1, b1, w2p, b2):
    """The f32 kernel's indexing on the CPU (csrc/fused_stem.cu,
    fused_stem_f32_kernel): per (image, 8x8 output tile) the image patch
    from rows 4 oy0 - 3 and columns 4 ox0 - 4 (zeros outside the image),
    conv1 cell (r, q) from patch[ci, 2 r + dy, 2 q + dx + 1] into slot
    17 r + 9 (q & 1) + (q >> 1) (zero outside the conv1 map), then each
    thread's 8 pixels (p, g) x 8 channels summed over the chunks (c8, dy) of
    w2p: slot (2 p + dy) 17 + 9 (dx & 1) + (dx >> 1) + g, B row dx 8 + cc.
    Sums in f64."""
    xb = x.double().numpy()
    w1, b1, w2p, b2 = (t.double().numpy() for t in (w1, b1, w2p, b2))
    bsz, _, h, w = xb.shape
    c1, c2 = w1.shape[1], w2p.shape[-1]
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    out = np.zeros((bsz, c2, h4, w4))
    r = np.arange(17)[:, None, None]
    q = np.arange(17)[None, :, None]
    k = np.arange(27)[None, None, :]
    ci, rows, cols = np.broadcast_arrays(k // 9, 2 * r + (k % 9) // 3, 2 * q + k % 3 + 1)
    slot = (np.arange(17)[:, None] * 17 + (np.arange(17) & 1) * 9 + (np.arange(17) >> 1)).ravel()
    p, g = np.arange(8)[:, None], np.arange(8)[None, :]
    silu = lambda v: v / (1 + np.exp(-v))  # noqa: E731
    for b in range(bsz):
        for oy0 in range(0, h4, 8):
            for ox0 in range(0, w4, 8):
                padded = np.zeros((3, h + 40, w + 40))
                padded[:, 3:3 + h, 4:4 + w] = xb[b]
                patch = padded[:, 4 * oy0:4 * oy0 + 35, 4 * ox0:4 * ox0 + 40]
                cell = silu(patch[ci, rows, cols] @ w1 + b1)             # (17, 17, C1)
                gy, gx = 2 * oy0 - 1 + np.arange(17), 2 * ox0 - 1 + np.arange(17)
                inside = ((gy >= 0) & (gy < h2))[:, None] & ((gx >= 0) & (gx < w2))[None, :]
                cell *= inside[..., None]
                s = np.zeros((289, c1))
                s[slot] = cell.reshape(289, c1)
                acc = np.zeros((8, 8, c2))
                for qi in range(3 * c1 // 8):
                    c8, dy = divmod(qi, 3)
                    for dx in range(3):
                        idx = (2 * p + dy) * 17 + (dx & 1) * 9 + (dx >> 1) + g
                        acc += s[idx, 8 * c8:8 * c8 + 8] @ w2p[c8, dy, dx]
                tile = silu(acc + b2).transpose(2, 0, 1)                   # (C2, p, g)
                ny, nx = min(8, h4 - oy0), min(8, w4 - ox0)
                out[b, :, oy0:oy0 + ny, ox0:ox0 + nx] = tile[:, :ny, :nx]
    return torch.from_numpy(out).float()


@pytest.mark.parametrize("c1,c2,hw", [(16, 32, (40, 40)), (24, 48, (48, 36))])
def test_k4_f32_tile_emulation_matches_plain(c1, c2, hw):
    """The f32 kernel's tile, slot and chunk indexing, emulated on the CPU,
    gives the stem within the CUDA tests' f32 tolerance (2e-5 of the map's
    scale) against the plain version and k4_contract, partial tiles
    included (H/4 or W/4 not a multiple of 8)."""
    params = _torch_params(*_params(c1 + hw[1], c1, c2))
    x = torch.from_numpy(np.random.default_rng(hw[0]).uniform(0, 1, (2, 3, *hw)).astype(np.float32))
    got = _k4_f32_tile_emulation(x, *S.k4_pack_f32(*params))
    ref = S.fused_stem_plain(x, *params, torch.float32)
    scale = float(ref.abs().max())
    assert got.shape == ref.shape == (2, c2, hw[0] // 4, hw[1] // 4)
    assert float((got - ref).abs().max()) <= 2e-5 * scale
    assert float((got - k4_contract(x, *params, torch.float32)).abs().max()) <= 2e-5 * scale


def test_profile_k4_f32_instruments_every_phase():
    """scripts/profile_k4_f32.py finds each of its anchors in the f32
    kernel once: five clock64 probes, start to output."""
    from ood_in_object_detection_torch.scripts.profile_k4_f32 import instrumented_source

    src = instrumented_source(3200)
    assert src.count("clock64()") == 5
    assert all(f"pr_[{i}] = clock64()" in src for i in range(5))
    assert 'extern "C" int profile_read' in src
