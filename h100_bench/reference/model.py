"""Plain PyTorch YOLO detectors, built from an ultralytics model yaml.

The benchmark's reference forward: written from ultralytics'
``nn/tasks.py:parse_model`` and ``nn/modules/{conv,block,head}.py`` (v8.3),
in float32 NCHW, every convolution and product through
:mod:`.precision`. Module and parameter names are ultralytics', so the
state dict the benchmark makes here loads into the program by name. It
imports nothing of the program.

Supported modules: Conv, C2f, C3k2 (with C3k), SPPF, A2C2f (area
attention), nn.Upsample, Concat, Detect (the v8 head, or the depthwise
class branch of ultralytics' non-legacy head).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import precision as P

REG_MAX = 16
BN_EPS = 1e-3


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


class Conv(nn.Module):
    """Conv2d(bias=False) -> BatchNorm2d(eps 1e-3) -> SiLU."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=0.03)
        self.act = act

    def forward(self, x):
        c = self.conv
        y = P.conv2d(x, c.weight, None, c.stride, c.padding, c.groups)
        y = batch_norm(self.bn, y) if self.training and self.bn.momentum is not None else self.bn(y)
        return F.silu(y) if self.act else y


def batch_norm(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """Training BatchNorm as the program states it (flax's): the batch's
    mean and biased variance E[y^2] - E[y]^2; the running statistics
    0.97 x old + 0.03 x batch wait in ``bn.pending`` for the step's end."""
    mean = y.mean((0, 2, 3))
    var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp(min=0)
    with torch.no_grad():
        bn.pending = (0.97 * bn.running_mean + 0.03 * mean, 0.97 * bn.running_var + 0.03 * var)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return (y - mean[:, None, None]) * scale[:, None, None] + bn.bias[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=False, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(self._block(shortcut) for _ in range(n))

    def _block(self, shortcut):
        return Bottleneck(self.c, self.c, shortcut, k=(3, 3), e=1.0)

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class C3(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5, k=(1, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, k=k, e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k(C3):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5, k=3):
        super().__init__(c1, c2, n, shortcut, e, k=(k, k))


class C3k2(C2f):
    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, shortcut=True):
        self._c3k = c3k
        super().__init__(c1, c2, n, shortcut, e)

    def _block(self, shortcut):
        if self._c3k:
            return C3k(self.c, self.c, 2, shortcut)
        return Bottleneck(self.c, self.c, shortcut, k=(3, 3), e=0.5)


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class AAttn(nn.Module):
    """Area attention (ultralytics block.py AAttn)."""

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        all_head_dim = self.head_dim * num_heads
        self.qkv = Conv(dim, all_head_dim * 3, 1, act=False)
        self.proj = Conv(all_head_dim, dim, 1, act=False)
        self.pe = Conv(all_head_dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).flatten(2).transpose(1, 2)
        if self.area > 1:
            qkv = qkv.reshape(B * self.area, N // self.area, C * 3)
            B, N, _ = qkv.shape
        q, k, v = (qkv.view(B, N, self.num_heads, self.head_dim * 3)
                   .permute(0, 2, 3, 1)
                   .split([self.head_dim, self.head_dim, self.head_dim], dim=2))
        attn = P.matmul(q.transpose(-2, -1), k) * (self.head_dim ** -0.5)
        attn = attn.softmax(dim=-1)
        x = P.matmul(v, attn.transpose(-2, -1))
        x = x.permute(0, 3, 1, 2)
        v = v.permute(0, 3, 1, 2)
        if self.area > 1:
            x = x.reshape(B // self.area, N * self.area, C)
            v = v.reshape(B // self.area, N * self.area, C)
            B, N, _ = x.shape
        x = x.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
        v = v.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
        return self.proj(x + self.pe(v))


class ABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1), Conv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False, mlp_ratio=2.0, e=0.5,
                 shortcut=True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(0.01 * torch.ones(c2)) if a2 and residual else None
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area) for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut) for _ in range(n))

    def forward(self, x):
        y = [self.cv1(x)]
        for m in self.m:
            y.append(m(y[-1]))
        y = self.cv2(torch.cat(y, 1))
        if self.gamma is not None:
            return x + self.gamma.view(1, -1, 1, 1) * y
        return y


class Upsample(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class DFL(nn.Module):
    def __init__(self, c1=REG_MAX):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)


class Detect(nn.Module):
    """Raw maps (B, 4*REG_MAX + nc, H, W) per level; ``legacy`` is the v8 class branch."""

    def __init__(self, nc, ch: Sequence[int], legacy=True):
        super().__init__()
        self.nc = nc
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1)) for x in ch)
        if legacy:
            self.cv3 = nn.ModuleList(
                nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1)) for x in ch)
        else:
            self.cv3 = nn.ModuleList(
                nn.Sequential(nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
                              nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
                              nn.Conv2d(c3, nc, 1)) for x in ch)
        self.dfl = DFL(REG_MAX)

    @staticmethod
    def _branch(seq, x):
        last = seq[2]
        return P.conv2d(seq[1](seq[0](x)), last.weight, last.bias)

    def forward(self, xs):
        return [torch.cat((self._branch(b, x), self._branch(c, x)), 1)
                for x, b, c in zip(xs, self.cv2, self.cv3)]

    def output_convs(self):
        """(box convs, class convs): the final 1x1 convs of each level."""
        return [s[2] for s in self.cv2], [s[2] for s in self.cv3]


class YOLO(nn.Module):
    """``forward(x)`` -> (raw maps, neck maps), x (B, 3, H, W) in [0, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        nc = cfg["nc"]
        depth, width, max_ch = cfg["depth_multiple"], cfg["width_multiple"], cfg["max_channels"]
        scale = cfg["scale"]
        rows = cfg["backbone"] + cfg["head"]
        self.save: List = []
        ch = [3]
        layers = []
        legacy = True
        for i, (f, n, name, args) in enumerate(rows):
            args = list(args)
            n = max(round(n * depth), 1) if n > 1 else n
            c1 = ch[f] if isinstance(f, int) else None
            if name in ("Conv", "C2f", "C3k2", "SPPF", "A2C2f"):
                c2 = make_divisible(min(args[0], max_ch) * width, 8)
                if name == "Conv":
                    m = Conv(c1, c2, *args[1:])
                elif name == "SPPF":
                    m = SPPF(c1, c2, *args[1:])
                elif name == "C2f":
                    m = C2f(c1, c2, n, *args[1:])
                elif name == "C3k2":
                    legacy = False
                    c3k = True if scale in "mlx" else (args[1] if len(args) > 1 else False)
                    m = C3k2(c1, c2, n, c3k, *args[2:])
                else:
                    legacy = False
                    a2 = args[1] if len(args) > 1 else True
                    area = args[2] if len(args) > 2 else 1
                    extra = (True, 1.2) if scale in "lx" else ()
                    m = A2C2f(c1, c2, n, a2, area, *extra)
            elif name == "nn.Upsample":
                c2, m = c1, Upsample()
            elif name == "Concat":
                c2, m = sum(ch[j] for j in f), Concat()
            elif name == "Detect":
                c2, m = 0, Detect(nc, [ch[j] for j in f], legacy)
                self.neck_layers = tuple(f)
                self.neck_channels = tuple(ch[j] for j in f)
            else:
                raise ValueError(f"module {name} is not in the reference")
            layers.append(m)
            if i == 0:
                ch = []
            ch.append(c2)
        self.rows = rows
        self.model = nn.ModuleList(layers)
        self.nc = nc

    def forward(self, x):
        ys = []
        for (f, _, name, _), m in zip(self.rows, self.model):
            if isinstance(f, int):
                inp = x if f == -1 else ys[f]
            else:
                inp = [x if j == -1 else ys[j] for j in f]
            if name == "Detect":
                return m(inp), inp
            x = m(inp)
            ys.append(x)
        raise RuntimeError("no Detect layer")

    def detect(self) -> Detect:
        return self.model[-1]


def build(cfg: dict, device="cpu") -> YOLO:
    """The model's module tree on ``device`` with uninitialised storage."""
    with torch.device("meta"):
        model = YOLO(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_from_seed(model: YOLO, generator: torch.Generator, calib: torch.Tensor,
                   head: str = "spread") -> YOLO:
    """Seeded weights made where the model lies, one draw for all of them.

    - Every conv weight U(-1/sqrt(fan_in), +1/sqrt(fan_in)) (torch's Conv2d
      default), from one uniform draw cut into leaves; conv biases 0,
      A2C2f's gamma 0.01, DFL's fixed arange(16).
    - BatchNorm: scale 1, shift 0, running statistics those of one forward
      of ``calib`` ((B, 3, H, W) in [0, 1]), layer by layer, so every channel
      is unit scale as a trained model's would be.
    - The head's final 1x1 convs, ``head="spread"``: each output channel
      scaled by U(0.5, 1.5) * 4, biases N(0, 1), the box bins' biases
      falling by 0.5 a bin, so that confidences and boxes are spread and not
      tied (a detector to evaluate); ``head="bias_init"``: ultralytics'
      Detect.bias_init, box biases 1 and class biases log(5 / nc / (640 /
      stride)^2) (a detector to train).
    """
    dev = calib.device
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d) and m.weight.requires_grad]
    total = sum(c.weight.numel() for c in convs)
    u = torch.rand(total, generator=generator, device=dev)
    off = 0
    for c in convs:
        n = c.weight.numel()
        bound = 1.0 / math.sqrt(c.weight[0].numel())
        c.weight.copy_(((u[off:off + n] * 2 - 1) * bound).view_as(c.weight))
        off += n
        if c.bias is not None:
            c.bias.zero_()
    for m in model.modules():
        if isinstance(m, A2C2f) and m.gamma is not None:
            m.gamma.fill_(0.01)
        if isinstance(m, DFL):
            m.conv.weight.copy_(torch.arange(REG_MAX, dtype=torch.float32).view(1, REG_MAX, 1, 1))
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average: one batch gives its own statistics
    model.train()
    with P.precision("f32"):
        model(calib)
    model.eval()
    for bn in bns:
        bn.momentum = 0.03
    boxes, classes = model.detect().output_convs()
    if head == "bias_init":
        for b, c, s in zip(boxes, classes, (8, 16, 32)):
            b.bias.fill_(1.0)
            c.bias.fill_(math.log(5 / model.nc / (640 / s) ** 2))
        return model
    heads = boxes + classes
    cout = [h.weight.shape[0] for h in heads]
    f = torch.rand(sum(cout), generator=generator, device=dev) * 4.0 + 2.0
    b = torch.randn(sum(cout), generator=generator, device=dev)
    off = 0
    for h, n in zip(heads, cout):
        h.weight.mul_(f[off:off + n].view(-1, 1, 1, 1))
        h.bias.copy_(b[off:off + n])
        off += n
    for h in boxes:
        h.bias.sub_(0.5 * (torch.arange(4 * REG_MAX, device=dev) % REG_MAX).float())
    return model


def state_dict(model: YOLO) -> dict:
    return {k: v.detach() for k, v in model.state_dict().items()}
