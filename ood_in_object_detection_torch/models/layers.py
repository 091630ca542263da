"""YOLO layers (v8, v9, v10, 11, 12) as PyTorch modules (NCHW).

Port of ood_in_object_detection_tpu/models/layers.py and of the CBLinear /
CBFuse steps of its models/yolo.py; reference ultralytics
nn/modules/{conv,block}.py.
Module and attribute names follow ultralytics, so the state_dict that
``utils/weight_import.py:export_state_dict`` writes from the JAX variables
loads here with ``strict=True`` and no renaming table.

Compute dtype: every layer computes in the dtype of its input, and the model
casts the image once (models/yolo.py). Parameters stay f32; a bf16 input is
the JAX package's ``dtype=bf16`` (flax Conv and BatchNorm, layers.py:43-79):
the conv runs on bf16 operands and returns bf16, inference BN computes in
f32 from the bf16 conv output and rounds to bf16, SiLU rounds at each of
its ops, as jax.nn.silu does (ops/stem.py:silu). The weights are cast at
each call, as flax promotes its f32 params at each call: no cached copy can
go stale when weights are loaded or calibrated after the model is built,
and the cast is a small share of a conv's time. ``torch.autocast`` is not
used, since it rounds at other points than flax.

In training, BatchNorm is flax's (:func:`bn_train`), not nn.BatchNorm2d's:
batch statistics with the biased variance, the running statistics updated
with that biased variance, and the update held back until the trainer
commits it (:func:`commit_batch_stats`).

Under spatial parallelism (parallel/spatial.py: an ``sp`` shard's thread
holds a slab of the map's rows) every op that reads across rows takes its
rule here: a conv or pool taller or longer-strided than 1 runs on the
window of rows its outputs read, the neighbours' halo rows included and the
image edge padded as the op pads it (zeros for a conv, -inf for a max-pool,
none for the VALID 2x2 average pool), with height padding 0; the resizes
stay local, their rows aligned; an attention block runs on the gathered
map and keeps the shard's rows. Every other op is row-local. In training
one rank holds each slab (parallel/spatial.py:RankShard) and the same
rules exchange rows between ranks, with their gradients.

On a ``model`` axis in training (train/trainer.py:shard_state) a conv
whose weight :func:`parallel.mesh.param_spec` splits holds its slice of the
output channels (``conv.tp``, the ``model`` axis): it computes those
channels alone, between the tensor-parallel pair (parallel/distributed.py:
``to_model`` at its input, ``gather_channels`` at its output), so that its
bias, BatchNorm and SiLU run on the whole, replicated channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stem import silu
from ..parallel import spatial
from ..parallel.distributed import (all_reduce_sum_autograd, bn_axis, gather_channels,
                                    to_model)

BN_EPS = 1e-3
BN_MOMENTUM = 0.03
BN_DECAY = 0.97  # flax's momentum: running = 0.97 * running + (1 - 0.97) * batch


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on ``x`` in x's dtype, its f32 weight (and bias) cast to it;
    the bias is added after the conv's result is rounded, as flax does. On
    an ``sp`` shard a kernel or stride taller than 1 runs on its window of
    rows (:meth:`parallel.spatial.Shard.window`, zeros past the image). A
    conv split over a ``model`` axis (``conv.tp``) computes its slice of the
    output channels, from the input channels of its groups, and gathers
    the slices before the bias."""
    padding = conv.padding
    (kh, kw), (sh, _) = conv.kernel_size, conv.stride
    groups = conv.groups
    tp = getattr(conv, "tp", None)
    if tp is not None:
        x = to_model(x, tp)
        if groups > 1:  # shard_state checked that the slices hold whole groups
            c = x.shape[1] // tp.size
            x = x[:, tp.index * c:(tp.index + 1) * c]
            groups //= tp.size
    shard = spatial.current()
    if shard is not None and (kh > 1 or sh > 1):
        x = shard.window(x, kh, sh, padding[0], 0.0)
        padding = (0, padding[1])
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, padding, conv.dilation, groups)
    if tp is not None:
        y = gather_channels(y, tp)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)[:, None, None]


def bn_inference(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax BatchNorm(dtype=x.dtype) at inference: ``(x - mean) * (scale *
    rsqrt(var + eps)) + bias`` in f32 on the running statistics, rounded to
    x's dtype."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    y = (x.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
    return (y + bn.bias[:, None, None]).to(x.dtype)


def bn_train(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3,
    dtype=x.dtype) (layers.py:70-73 of the JAX package; flax
    linen/normalization.py ``_compute_stats``, ``_normalize``): the batch
    mean and biased variance over (B, H, W) in f32, the variance in its fast
    form ``max(E[x^2] - E[x]^2, 0)``; ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in f32, rounded to x's dtype. The running statistics
    flax writes, ``0.97 * running + (1 - 0.97) * batch`` with the biased
    variance (nn.BatchNorm2d writes the unbiased one), wait in
    ``bn.pending_stats`` until :func:`commit_batch_stats`: a layer
    recomputed under remat sets the same values again, and the buffers move
    only when the step is taken, as the JAX step returns its new
    ``batch_stats``.

    Inside ``parallel.distributed.global_batch`` on more than one rank the
    statistics are the global batch's, as in the JAX package's one logical
    step: the f32 sums of x and x^2 and the count are summed over the ranks
    of its BatchNorm axis (with their gradient), so the running statistics
    come out the same on every rank. The count is the values this rank
    holds: its own rows of its own images (an ``sp`` slab holds no halo
    rows here), and the ranks of one ``model`` index alone, which hold the
    channels whole. (``nn.SyncBatchNorm`` would store the unbiased
    variance.)"""
    xf = x.float()
    axis = bn_axis()
    if axis is not None:
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        sums = all_reduce_sum_autograd(
            torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]), axis.group)
        c = xf.shape[1]
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    else:
        mean = xf.mean((0, 2, 3))
        var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.pending_stats = (BN_DECAY * bn.running_mean + (1 - BN_DECAY) * mean,
                            BN_DECAY * bn.running_var + (1 - BN_DECAY) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


@torch.no_grad()
def commit_batch_stats(model: nn.Module) -> int:
    """Write every pending flax running statistic (:func:`bn_train`) into
    its BatchNorm's buffers; -> how many BatchNorms moved."""
    n = 0
    for m in model.modules():
        stats = getattr(m, "pending_stats", None)
        if isinstance(m, nn.BatchNorm2d) and stats is not None:
            m.running_mean.copy_(stats[0])
            m.running_var.copy_(stats[1])
            m.pending_stats = None
            n += 1
    return n


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d(eps=1e-3) + SiLU, padding k // 2.
    BatchNorm in training mode is flax's (:func:`bn_train`), but under
    torch's cumulative average (``momentum=None``, which
    utils/weights.py:calibrate_batchnorm sets), which keeps nn.BatchNorm2d's
    own."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x):
        if self.bn.training and self.bn.momentum is not None:
            x = bn_train(self.bn, conv_in_dtype(self.conv, x))
        elif x.dtype == torch.float32:
            x = self.bn(conv_in_dtype(self.conv, x))
        else:
            x = bn_inference(self.bn, conv_in_dtype(self.conv, x))
        return silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convs, fast (reference block.py C2f); ``block(c)``
    makes each of the n blocks (bottlenecks of e 1.0 by default)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5,
                 block=None):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        block = block or (lambda c: Bottleneck(c, c, shortcut, k=(3, 3), e=1.0))
        self.m = nn.ModuleList(block(self.c) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), dim=1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast; the max-pool pads with -inf."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool(ys[-1], self.k))
        return self.cv2(torch.cat(ys, dim=1))


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample."""

    def forward(self, x):
        return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Concat(nn.Module):
    """Concatenate on channels (the inputs are chosen by the spec)."""

    def forward(self, xs):
        return torch.cat(xs, dim=1)



def max_pool(x: torch.Tensor, k: int, s: int = 1) -> torch.Tensor:
    """Max-pool with padding k // 2 filled with -inf (flax max_pool); on an
    ``sp`` shard, over its window of rows (-inf past the image)."""
    shard = spatial.current()
    if shard is not None:
        return F.max_pool2d(shard.window(x, k, s, k // 2, float("-inf")), k, s, (0, k // 2))
    return F.max_pool2d(x, k, s, k // 2)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (2, 2), strides=(1, 1), padding='VALID')``, rounded
    as XLA sums the window: row-major, each add in x's dtype (in bf16 each
    partial sum rounds to bf16); the /4 is exact. A map of H rows gives H -
    1; on an ``sp`` shard each shard but the last takes one row below."""
    shard = spatial.current()
    if shard is not None:
        x = shard.window(x, 2, 1, 0, None)
    a, b = x[..., :-1, :-1], x[..., :-1, 1:]
    c, d = x[..., 1:, :-1], x[..., 1:, 1:]
    return (((a + b) + c) + d) / 4


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), tokens row-major as the JAX layers'
    NHWC reshape orders them."""
    return x.flatten(2).transpose(1, 2)


def tokens_to_map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (..., n, d) operands, rounded where the
    JAX layers round (layers.py:468-474, 553-564): the scores in f32 (a
    bf16 product is exact in f32), the softmax in f32 cast to v's dtype,
    the second product in v's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1))
    return torch.matmul(torch.softmax(s * scale, dim=-1).to(v.dtype), v)


# ---------------------------------------------------------------------------
# yolo11 / yolo12 blocks
# ---------------------------------------------------------------------------


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference block.py C3); ``k`` holds the
    kernels of each ``block``'s two convs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5,
                 k=(1, 3), block=Bottleneck):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(block(c_, c_, shortcut, k=k, e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class C3k(C3):
    """C3 whose bottlenecks take k x k kernels (reference block.py C3k)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5,
                 k: int = 3):
        super().__init__(c1, c2, n, shortcut, e, k=(k, k))


class C3k2(C2f):
    """C2f whose blocks are C3k (``c3k``) or bottlenecks of e 0.5
    (reference block.py C3k2)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut, e, block=lambda c: (
            C3k(c, c, 2, shortcut) if c3k else Bottleneck(c, c, shortcut, k=(3, 3), e=0.5)))


class Attention(nn.Module):
    """Multi-head self-attention over the H x W grid with a depthwise 3x3
    positional conv on v (reference block.py Attention). qkv's channels are
    per head [q | k | v] of key_dim, key_dim, head_dim."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        shard = spatial.current()
        if shard is not None:  # attention reads every row
            return shard.on_whole_map(self.forward, x)
        b, c, h, w = x.shape
        qkv = map_to_tokens(self.qkv(x)).reshape(b, h * w, self.num_heads, -1)
        q, k, v = (t.transpose(1, 2) for t in
                   qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=-1))
        out = attend(q, k, v, self.key_dim ** -0.5)  # (b, heads, n, head_dim)

        def as_map(t):
            return tokens_to_map(t.transpose(1, 2).reshape(b, h * w, c), h, w)

        return self.proj(as_map(out) + self.pe(as_map(v)))


class PSABlock(nn.Module):
    """Attention then a 2x MLP, each with a residual (reference block.py
    PSABlock)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4):
        super().__init__()
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn = nn.Sequential(Conv(c, 2 * c, 1), Conv(2 * c, c, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """CSP wrapper around n PSABlocks on half the channels (reference
    block.py C2PSA)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, 0.5, self.c // 64) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat([a, self.m(b)], dim=1))


class PSA(PSABlock):
    """Position-sensitive attention (reference block.py PSA, yolov10): one
    PSABlock, held directly as ``attn`` and ``ffn``, on half the channels."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        c = int(c2 * e)
        super().__init__(c, 0.5, c // 64)
        self.c = c
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat([a, super().forward(b)], dim=1))


class AAttn(nn.Module):
    """Area attention (reference block.py AAttn, yolo12): the row-major
    token axis splits into ``area`` groups that attend on their own; qkv's
    channels are per head [q | k | v] of head_dim each, and the 7x7
    positional conv reads v in head-major channel order."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Conv(dim, 3 * dim, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        shard = spatial.current()
        if shard is not None:  # area attention reads every row
            return shard.on_whole_map(self.forward, x)
        b, c, h, w = x.shape
        n = h * w
        qkv = map_to_tokens(self.qkv(x)).reshape(
            b * self.area, n // self.area, self.num_heads, 3, self.head_dim)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
        out = attend(q, k, v, self.head_dim ** -0.5)  # (b * area, heads, n / area, hd)

        def as_map(t):
            return tokens_to_map(t.transpose(1, 2).reshape(b, n, c), h, w)

        return self.proj(as_map(out) + self.pe(as_map(v)))


class ABlock(nn.Module):
    """Area attention then an MLP of ``mlp_ratio``, each with a residual
    (reference block.py ABlock)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, num_heads, area)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1), Conv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """Area-attention C2f (reference block.py A2C2f, yolo12): n pairs of
    ABlocks (``a2``) or n C3k blocks; with ``residual`` (yolo12 l/x) the
    output is ``x + gamma * out``, gamma initialised to 0.01."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1,
                 residual: bool = False, mlp_ratio: float = 2.0, e: float = 0.5,
                 shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if a2 and residual else None
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area) for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut) for _ in range(n))

    def forward(self, x):
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        out = self.cv2(torch.cat(ys, dim=1))
        if self.gamma is None:
            return out
        return x + self.gamma.to(out.dtype)[:, None, None] * out


# ---------------------------------------------------------------------------
# yolov10 blocks
# ---------------------------------------------------------------------------


class SCDown(nn.Module):
    """Pointwise conv then a depthwise k/s conv (reference block.py SCDown)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """Depthwise 7x7 and 3x3 branches summed, then SiLU (reference block.py
    RepVGGDW, train form)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 7, 1, g=c, act=False)
        self.conv1 = Conv(c, c, 3, 1, g=c, act=False)

    def forward(self, x):
        return silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Conditional identity block (reference block.py CIB); ``lk`` takes
    RepVGGDW as the middle depthwise conv."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            Conv(c1, c1, 3, g=c1), Conv(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
            Conv(2 * c_, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB blocks (reference block.py C2fCIB)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, e,
                         block=lambda c: CIB(c, c, shortcut, e=1.0, lk=lk))


# ---------------------------------------------------------------------------
# yolov9 blocks
# ---------------------------------------------------------------------------


class RepConvN(nn.Module):
    """RepConv in its train form: k x k and 1x1 conv branches summed, then
    SiLU (reference conv.py RepConvN; the JAX package's RepConvDW)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, act=False)
        self.conv2 = Conv(c1, c2, 1, s, act=False)

    def forward(self, x):
        return silu(self.conv1(x) + self.conv2(x))


class RepBottleneck(Bottleneck):
    """Bottleneck whose first conv is RepConvN (reference block.py RepBottleneck)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 3), e: float = 0.5):
        super().__init__(c1, c2, shortcut, k, e)
        self.cv1 = RepConvN(c1, int(c2 * e), k[0], 1)


class RepCSP(C3):
    """C3 of RepBottlenecks (reference block.py RepCSP)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, True, e, k=(3, 3), block=RepBottleneck)


class RepNCSPELAN4(nn.Module):
    """GELAN block (reference block.py RepNCSPELAN4); ``c3`` and ``c4`` are
    taken as given, not width-scaled."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), Conv(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), Conv(c4, c4, 3, 1))
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), dim=1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, dim=1))


class ELAN1(nn.Module):
    """RepNCSPELAN4 with plain 3x3 convs in place of RepCSP + Conv
    (reference block.py ELAN1)."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = Conv(c3 // 2, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    forward = RepNCSPELAN4.forward


class ADown(nn.Module):
    """2x2/s1 average pool, then half the channels through a 3x3/s2 conv and
    half through a 3x3/s2 max-pool and a 1x1 conv (reference block.py ADown)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1 // 2, self.c, 3, 2)
        self.cv2 = Conv(c1 // 2, self.c, 1, 1)

    def forward(self, x):
        x1, x2 = avg_pool2(x).chunk(2, dim=1)
        return torch.cat([self.cv1(x1), self.cv2(max_pool(x2, 3, 2))], dim=1)


class AConv(nn.Module):
    """2x2/s1 average pool then a 3x3/s2 conv (reference block.py AConv)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2)

    def forward(self, x):
        return self.cv1(avg_pool2(x))


class SPPELAN(nn.Module):
    """SPP-ELAN (reference block.py SPPELAN): three chained k x k max-pools
    after a 1x1 conv, all four concatenated into cv5."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(max_pool(y[-1], self.k))
        return self.cv5(torch.cat(y, dim=1))


class CBLinear(nn.Module):
    """A biased 1x1 conv whose output splits into channel chunks (reference
    block.py CBLinear, yolov9e)."""

    def __init__(self, c1: int, c2s):
        super().__init__()
        self.c2s = list(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), 1, 1, 0, bias=True)

    def forward(self, x):
        return conv_in_dtype(self.conv, x).split(self.c2s, dim=1)


class CBFuse(nn.Module):
    """Chunk ``idx[i]`` of each CBLinear input, nearest-resized to the last
    input's grid and added to it in order (reference block.py CBFuse; the
    JAX package's order of the sums)."""

    def __init__(self, idx):
        super().__init__()
        self.idx = list(idx)

    def forward(self, xs):
        acc = xs[-1]
        shard = spatial.current()
        for i, src in zip(self.idx, xs[:-1]):
            if shard is not None:
                check_aligned(shard, src[i], acc)
            acc = acc + F.interpolate(src[i], size=acc.shape[2:], mode="nearest")
        return acc


def check_aligned(shard, src: torch.Tensor, dst: torch.Tensor) -> None:
    """A nearest resize of ``src`` to ``dst``'s rows stays local on ``sp``
    shards only where every shard's rows of ``dst`` are its rows of ``src``
    times one integer factor. The equal slabs of an image
    (parallel/spatial.py:row_spans, a whole number of rows at the largest
    stride) always line up so; a layout that does not breaks that
    invariant and raises ValueError."""
    (s0, sh), (d0, dh) = shard.layout(src), shard.layout(dst)
    m = sum(dh) // max(1, sum(sh))
    if sum(dh) != m * sum(sh) or any(d != m * s for d, s in zip(d0 + dh, s0 + sh)):
        raise ValueError(
            f"a nearest resize of rows {sh} to {dh} over sp shards is not row-local: the "
            "image was not split into equal slabs at the largest stride")
