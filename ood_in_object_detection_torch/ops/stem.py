"""The inference stem: the first two k3/s2 Conv+BN+SiLU blocks in one
function, and kernel K4's wrapper.

    fused_stem(x) == silu(bn2(conv2(silu(bn1(conv1(x))))))   (inference BN)

Port of ood_in_object_detection_tpu/ops/pallas/stem.py:pallas_stem (the
Pallas kernel) and models/folded_stem.py:phase_folded_stem (its XLA version,
which the JAX model runs on every inference forward, models/yolo.py:398-431).

- :func:`fused_stem_plain` is a plain PyTorch port of phase_folded_stem:
  space-to-depth by 4, both convs refolded as k2/s1 convs over the phase
  channels with top-left zero padding, inference BN as one multiply-add in
  the compute dtype.
- :func:`fused_stem` calls the operator ``ood_torch::fused_stem``
  (ops/library.py), which launches CUDA kernel K4 (``csrc/fused_stem.cu``) on
  CUDA tensors and runs :func:`fused_stem_plain` on CPU tensors; in bf16 the
  kernel runs on tensor cores and takes its weights in mma fragment order
  (:func:`k4_pack_bf16`), in f32 it runs on CUDA cores on conv2 weights
  regrouped into the chunks it streams (:func:`k4_pack_f32`). K4 computes the
  contract of pallas_stem: BN folded into the weights in f32
  (:func:`bn_fold`, stem.py:56-59), the folded weights and the image rounded
  to the compute dtype, f32 accumulation, f32 bias and SiLU, the conv1
  intermediate rounded to the compute dtype (stem.py:151). In f32 the two
  agree to summation order; in bf16 they round at different points.

Layouts are the port's: (B, C, H, W) in, (B, C2, H/4, W/4) out, conv weights
OIHW. BN parameters travel as dicts with the JAX package's keys
(scale / bias / mean / var).
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import library

BN_EPS = 1e-3
# the widths K4 takes, multiples of 8: every scale's stem, up to yolo11x's
# and yolo12x's C1 96, C2 192 (csrc/fused_stem.cu's second specialization)
K4_C1_RANGE = (16, 96)
K4_C2_RANGE = (32, 192)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU rounded where jax.nn.silu rounds. Its jaxpr is ``x * (1 / (1 +
    exp(-x)))``, and in bf16 every one of those four ops rounds to bf16; f32
    takes F.silu."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


def bn_fold(bn: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as ``x * inv + shift``, in f32 (stem.py:56-59)."""
    inv = bn["scale"].float() * torch.rsqrt(bn["var"].float() + BN_EPS)
    return inv, bn["bias"].float() - bn["mean"].float() * inv


def stem_conv_params(conv0, conv1):
    """(w1, bn1, w2, bn2) of two models/layers.Conv modules."""
    out = []
    for m in (conv0, conv1):
        c = m.conv
        if c.kernel_size != (3, 3) or c.stride != (2, 2) or c.padding != (1, 1) or c.groups != 1:
            raise ValueError("fused_stem: both stem convs must be k3/s2/p1, ungrouped")
        out += [c.weight, dict(scale=m.bn.weight, bias=m.bn.bias, mean=m.bn.running_mean,
                               var=m.bn.running_var)]
    return tuple(out)


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 16C, H/4, W/4), channels ordered (qy, qx, c)."""
    b, c, h, w = x.shape
    z = x.reshape(b, c, h // 4, 4, w // 4, 4).permute(0, 3, 5, 1, 2, 4)
    return z.reshape(b, 16 * c, h // 4, w // 4)


def _phase_tap(p: int, d: int) -> Tuple[int, int]:
    """Input phase q and k2 tap k of the k3/s2 tap ``d`` of output phase ``p``
    (folded_stem.py:16-21): the image row 2p + d - 1 of a 4-row group."""
    t = 2 * p + d - 1
    return t % 4, 1 + (t // 4 if t >= 0 else -1)


def fold_w1(w1: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) k3/s2 kernel -> (4O, 16C, 2, 2) k2/s1 kernel over the
    space-to-depth image; out-channels ordered (py, px, o), in (qy, qx, c)."""
    o, c = w1.shape[:2]
    out = w1.new_zeros((4 * o, 16 * c, 2, 2))
    for py in range(2):
        for dy in range(3):
            qy, ky = _phase_tap(py, dy)
            for px in range(2):
                for dx in range(3):
                    qx, kx = _phase_tap(px, dx)
                    ci, oi = (qy * 4 + qx) * c, (py * 2 + px) * o
                    out[oi:oi + o, ci:ci + c, ky, kx] = w1[:, :, dy, dx]
    return out


def fold_w2(w2: torch.Tensor) -> torch.Tensor:
    """(C2, C1, 3, 3) k3/s2 kernel -> (C2, 4C1, 2, 2) k2/s1 kernel over the
    phase tensor; in-channels ordered (py, px, c1)."""
    c2, c1 = w2.shape[:2]
    out = w2.new_zeros((c2, 4 * c1, 2, 2))
    dy_of = {(0, 1): 0, (1, 0): 1, (1, 1): 2}  # (k, phase) -> k3 tap
    for (ky, py), dy in dy_of.items():
        for (kx, px), dx in dy_of.items():
            ci = (py * 2 + px) * c1
            out[:, ci:ci + c1, ky, kx] = w2[:, :, dy, dx]
    return out


def _conv_k2_s1_tl(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k2/s1 conv with top/left zero padding (window rows y-1..y)."""
    return F.conv2d(F.pad(x, (1, 0, 1, 0)), k)


def _bn_inference(x: torch.Tensor, bn: Dict[str, torch.Tensor], tile: int = 1) -> torch.Tensor:
    """One multiply-add in x's dtype; the (C,) coefficients in f32
    (folded_stem.py:80-85)."""
    inv, shift = bn_fold(bn)
    inv, shift = inv.repeat(tile), shift.repeat(tile)
    return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def fused_stem_plain(x: torch.Tensor, w1: torch.Tensor, bn1: Dict[str, torch.Tensor],
                     w2: torch.Tensor, bn2: Dict[str, torch.Tensor],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch phase-folded stem (port of phase_folded_stem):
    (B, C, H, W) -> (B, C2, H/4, W/4) in ``dtype``."""
    z = space_to_depth4(x.to(dtype))
    h = _conv_k2_s1_tl(z, fold_w1(w1.float()).to(dtype))
    h = silu(_bn_inference(h, bn1, tile=4))  # phase channels (py, px, o)
    y = _conv_k2_s1_tl(h, fold_w2(w2.float()).to(dtype))
    return silu(_bn_inference(y, bn2))


def k4_weights(w1, bn1, w2, bn2, dtype: torch.dtype):
    """K4's operands, BN folded in f32 and the weights rounded to ``dtype``
    (held as f32): w1 (27, C1), b1 (C1,), w2 (C1, 9, C2), b2 (C2,)."""
    inv1, b1 = bn_fold(bn1)
    inv2, b2 = bn_fold(bn2)
    c2, c1 = w2.shape[:2]
    w1f = (w1.float() * inv1[:, None, None, None]).to(dtype).float().reshape(c1, 27)
    w2f = (w2.float() * inv2[:, None, None, None]).to(dtype).float().reshape(c2, c1, 9)
    return (w1f.t().contiguous(), b1.contiguous(), w2f.permute(1, 2, 0).contiguous(),
            b2.contiguous())


def _mma_b_fragments(wmat: torch.Tensor) -> torch.Tensor:
    """(L, K, N) with K % 16 == 0, N % 8 == 0 -> (N/8, L, K/16, 32, 4): the
    B operand of mma.sync.m16n8k16 per n-tile, matrix and k-step, lane =
    4 g + t holding rows 2t, 2t+1, 2t+8, 2t+9 of the k-step at column g."""
    m, k, n = wmat.shape
    w = wmat.reshape(m, k // 16, 2, 4, 2, n // 8, 8)   # (L, ks, half, t, e, nt, g)
    return w.permute(5, 0, 1, 6, 3, 2, 4).reshape(n // 8, m, k // 16, 32, 4)


_K4_PACK_INDEX: dict = {}


def _k4_pack_index(c1: int, c2: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each element of w1p and w2p comes from in ``cat([w1 folded
    (C1, 27), w2 folded (C2, C1, 9), 0])`` flattened: the fragment order of
    :func:`_mma_b_fragments` applied to flat indices, the padding pointing
    at the trailing zero. Built once per widths and device: a layout, no
    weights."""
    key = (c1, c2, str(device))
    if key not in _K4_PACK_INDEX:
        c1p = -(-c1 // 16) * 16
        zero = 27 * c1 + 9 * c1 * c2
        ar = torch.arange
        i1 = torch.full((32, c1p), zero, dtype=torch.long)
        i1[:27, :c1] = ar(c1) * 27 + ar(27)[:, None]                   # W1[k, o] = w1[o, k]
        i2 = torch.full((9, c1p, c2), zero, dtype=torch.long)
        i2[:, :c1] = 27 * c1 + ar(c2) * (9 * c1) + ar(c1)[:, None] * 9 + ar(9)[:, None, None]
        _K4_PACK_INDEX[key] = (_mma_b_fragments(i1[None])[:, 0].reshape(-1).to(device),
                               _mma_b_fragments(i2).reshape(-1).to(device))
    return _K4_PACK_INDEX[key]


def k4_pack_bf16(w1, bn1, w2, bn2):
    """K4's bf16 operands in its tensor-core layout: BN folded in f32, the
    weights rounded to bf16 (the values of :func:`k4_weights`), C1 padded
    with zeros to C1p, a multiple of 16 (one mma k-step):

    - w1p bf16 (C1p/8, 2, 32, 4): the B fragments of W1 (32, C1p), rows
      (ci, dy, dx) under 5 zero rows, per n-tile and k-step;
    - b1p f32 (C1p,), zero past C1;
    - w2p bf16 (C2/8, 9, C1p/16, 32, 4): the B fragments of each tap's W2
      (C1p, C2), per n-tile, tap (3 dy + dx) and k-step;
    - b2 f32 (C2,).

    One gather through a cached index (:func:`_k4_pack_index`) puts both
    weights in place, so folding and packing take a few launches."""
    inv1, b1 = bn_fold(bn1)
    inv2, b2 = bn_fold(bn2)
    c2, c1 = w2.shape[:2]
    c1p = -(-c1 // 16) * 16
    src = torch.cat([(w1.float() * inv1[:, None, None, None]).reshape(-1),
                     (w2.float() * inv2[:, None, None, None]).reshape(-1),
                     w1.new_zeros(1, dtype=torch.float32)]).to(torch.bfloat16)
    i1, i2 = _k4_pack_index(c1, c2, w1.device)
    return (src[i1].view(c1p // 8, 2, 32, 4), F.pad(b1, (0, c1p - c1)),
            src[i2].view(c2 // 8, 9, c1p // 16, 32, 4), b2.contiguous())


def k4_pack_f32(w1, bn1, w2, bn2):
    """K4's f32 operands: :func:`k4_weights` in f32, with conv2's weight
    regrouped into the chunks the kernel streams through shared memory:

    - w1 f32 (27, C1), b1 f32 (C1,), b2 f32 (C2,) as in :func:`k4_weights`;
    - w2p f32 (C1/8, 3, 3, 8, C2): ``w2p[c8, dy, dx, cc, n]`` is the folded
      weight of input channel 8 c8 + cc, tap (dy, dx), output channel n, so
      a chunk (c8, dy), 3 taps x 8 channels x C2, is contiguous."""
    w1k, b1, w2k, b2 = k4_weights(w1, bn1, w2, bn2, torch.float32)
    c1, _, c2 = w2k.shape
    w2p = w2k.reshape(c1 // 8, 8, 3, 3, c2).permute(0, 2, 3, 1, 4).contiguous()
    return w1k, b1, w2p, b2


def k4_operands(w1, bn1, w2, bn2, dtype: torch.dtype):
    """What K4's launcher takes in ``dtype``: :func:`k4_pack_f32` in f32,
    :func:`k4_pack_bf16` in bf16."""
    if dtype == torch.bfloat16:
        return k4_pack_bf16(w1, bn1, w2, bn2)
    return k4_pack_f32(w1, bn1, w2, bn2)


def k4_takes(c1: int, c2: int) -> bool:
    """Whether K4 takes a stem of these widths (:func:`check_k4_shapes` on
    the card). The model's stem gate does not ask it: the fold is a choice
    of the spec, as in the JAX model, and a CUDA stem past this range raises
    rather than run another route."""
    (lo, hi), (lo2, hi2) = K4_C1_RANGE, K4_C2_RANGE
    return lo <= c1 <= hi and lo2 <= c2 <= hi2 and c1 % 8 == 0 and c2 % 8 == 0


def check_k4_shapes(x_shape, c1: int, c2: int) -> None:
    """Raise on a shape K4 does not take."""
    b, cin, h, w = x_shape
    lo, hi = K4_C1_RANGE
    if cin != 3 or h % 4 or w % 4:
        raise ValueError(f"fused_stem: K4 takes (B, 3, H, W) images with H, W multiples "
                         f"of 4, got {tuple(x_shape)}")
    lo2, hi2 = K4_C2_RANGE
    if not k4_takes(c1, c2):
        raise ValueError(f"fused_stem: K4 takes C1 in [{lo}, {hi}] and C2 in [{lo2}, {hi2}], "
                         f"multiples of 8, got C1={c1}, C2={c2}")


def fused_stem(x: torch.Tensor, conv0, conv1, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Both stem Conv blocks (models/layers.Conv ``conv0``, ``conv1``) at
    inference: (B, C, H, W) -> (B, C2, H/4, W/4) in ``dtype``, H and W
    multiples of 4.

    Replaces ops/pallas/stem.py:pallas_stem. Calls the operator
    ``ood_torch::fused_stem`` (ops/library.py): CUDA tensors launch kernel
    K4 (csrc/fused_stem.cu) in f32 or bf16 and raise on shapes it does not
    take; CPU tensors take :func:`fused_stem_plain`."""
    w1, bn1, w2, bn2 = stem_conv_params(conv0, conv1)
    if x.dim() != 4 or x.shape[2] % 4 or x.shape[3] % 4:
        raise ValueError(f"fused_stem: (B, C, H, W) with H, W multiples of 4, got {tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_stem: K4 computes in f32 or bf16, not {dtype}")
    return library.fused_stem_op(x, w1, bn1["scale"], bn1["bias"], bn1["mean"], bn1["var"],
                                 w2, bn2["scale"], bn2["bias"], bn2["mean"], bn2["var"],
                                 dtype == torch.bfloat16)


def fused_stem_launch(x: torch.Tensor, operands, c1: int, c2: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Launch kernel K4 on a CUDA image (B, 3, H, W) with BN already folded
    (:func:`k4_operands` in ``dtype``) -> (B, C2, H/4, W/4) in ``dtype``;
    counts the launch in ``fused_stem.launches`` and, per card index, in
    ``fused_stem.launches_by_device``."""
    from .kernels import _build

    check_k4_shapes(x.shape, c1, c2)
    x = x.to(dtype).contiguous()
    if x.data_ptr() % 16:  # the bf16 kernel copies the image in 8-byte groups
        x = x.clone()
    w1k, b1, w2k, b2 = operands
    _build.require_cuda("fused_stem", x=x, w1=w1k, b1=b1, w2=w2k, b2=b2)
    b, _, h, w = x.shape
    out = torch.empty((b, c2, h // 4, w // 4), dtype=dtype, device=x.device)
    code = _build.launcher("fused_stem")(
        x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(), b2.data_ptr(),
        b, h, w, c1, c2, int(dtype == torch.bfloat16), out.data_ptr(),
        _build.stream_handle(x.device))
    _build.count_launch(fused_stem, device=x.device.index)
    _build.check_launch("fused_stem", code)
    return out


fused_stem.launches = 0
fused_stem.launches_by_device = collections.Counter()
