"""Plain training step: forward with batch statistics, the v8 detection loss,
backward, Nesterov SGD in three groups under the warm-up schedule.

Written from ultralytics' ``utils/loss.py`` (v8DetectionLoss: BCE on
task-aligned soft targets, CIoU and distribution focal loss on the
assigned anchors, gains box 7.5, cls 0.5, dfl 1.5, times the batch size),
``utils/tal.py`` (TaskAlignedAssigner: anchors strictly inside a box, the
top 10 by score^0.5 x CIoU^6 per box, an anchor claimed by several boxes
kept by the one it overlaps most among them, targets normalised per box)
and ``engine/trainer.py`` (three groups: weights of two or more dimensions
with weight decay 5e-4, other one-dimensional weights, biases; the warm-up
of LR and momentum by linear interpolation over max(round(warmup_epochs x
batches per epoch), 100) steps; Nesterov SGD, momentum 0.937), with the
program's stated BatchNorm: the batch's mean and biased variance, E[x^2] -
E[x]^2, and running statistics 0.97 x old + 0.03 x batch; after each step
the EMA of the parameters (``utils/torch_utils.py`` ModelEMA, on the
parameters alone, as the program states): d = 0.9999 x (1 - exp(-updates /
2000)), ema = d x ema + (1 - d) x parameter, in float32. Imports nothing of
the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M
from . import precision as P
from .detect import STRIDES
from .model import REG_MAX


def anchors_of(raw) -> tuple:
    pts, strides = [], []
    for f, s in zip(raw, STRIDES):
        h, w = f.shape[2:]
        gy, gx = torch.meshgrid(torch.arange(h, device=f.device, dtype=torch.float32) + 0.5,
                                torch.arange(w, device=f.device, dtype=torch.float32) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((h * w,), float(s), device=f.device))
    return torch.cat(pts), torch.cat(strides)


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """ultralytics bbox_iou(CIoU=True) between xyxy boxes, broadcasting."""
    (ax1, ay1, ax2, ay2), (bx1, by1, bx2, by2) = a.unbind(-1), b.unbind(-1)
    w1, h1, w2, h2 = ax2 - ax1, ay2 - ay1 + eps, bx2 - bx1, by2 - by1 + eps
    inter = ((torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(0)
             * (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((bx1 + bx2 - ax1 - ax2) ** 2 + (by1 + by2 - ay1 - ay2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


@torch.no_grad()
def assign(scores, boxes, points, labels, gt, mask, nc, topk=10, alpha=0.5, beta=6.0, eps=1e-9):
    """Task-aligned targets: (target boxes, target scores, foreground mask)."""
    b, a, _ = scores.shape
    m = labels.shape[1]
    delta = torch.cat([points[None, None] - gt[:, :, None, :2],
                       gt[:, :, None, 2:] - points[None, None]], -1)
    inside = (delta.amin(-1) > eps) & mask[:, :, None]                     # (B, M, A)
    sc = scores.gather(2, labels[:, None, :].expand(b, a, m)).transpose(1, 2)  # (B, M, A)
    ov = ciou(gt[:, :, None, :], boxes[:, None, :, :]).clamp(0) * inside
    metric = sc.pow(alpha) * ov.pow(beta) * inside
    # the top k, the lower anchor first among equal metrics (the program's stated order)
    top = torch.sort(metric, dim=-1, descending=True, stable=True).indices[..., :topk]
    chosen = torch.zeros_like(inside).scatter_(-1, top, True)
    pos = chosen & inside
    many = pos.sum(1, keepdim=True) > 1
    best = torch.where(pos, ov, torch.full_like(ov, -1.0)).argmax(1, keepdim=True)
    pos = torch.where(many, torch.zeros_like(pos).scatter_(1, best, True), pos)
    fg = pos.any(1)
    gi = pos.float().argmax(1)                                             # (B, A)
    tbox = gt.gather(1, gi[..., None].expand(b, a, 4))
    tlab = labels.gather(1, gi)
    metric = metric * pos
    norm = (metric * (ov * pos).amax(-1, keepdim=True)
            / (metric.amax(-1, keepdim=True) + eps)).amax(1)               # (B, A)
    tscore = F.one_hot(tlab, nc).float() * (norm * fg)[..., None]
    return tbox, tscore, fg


def detection_loss(raw, labels, gt, mask, nc, gains=(7.5, 0.5, 1.5)) -> torch.Tensor:
    b = raw[0].shape[0]
    points, strides = anchors_of(raw)
    x = torch.cat([f.flatten(2) for f in raw], 2).transpose(1, 2).float()
    dist_logits = x[..., :4 * REG_MAX].reshape(b, -1, 4, REG_MAX)
    logits = x[..., 4 * REG_MAX:]
    dist = dist_logits.softmax(-1) @ torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
    boxes = torch.cat([points - dist[..., :2], points + dist[..., 2:]], -1)  # grid units
    tbox, tscore, fg = assign(logits.detach().sigmoid(), (boxes.detach() * strides[:, None]),
                              points * strides[:, None], labels.long(), gt.float(), mask.bool(),
                              nc)
    norm = tscore.sum().clamp(min=1)
    bce = F.binary_cross_entropy_with_logits(logits, tscore, reduction="none").sum() / norm
    weight = tscore.sum(-1)[fg]
    tgrid = (tbox / strides[:, None])[fg]
    box = ((1.0 - ciou(boxes[fg], tgrid)) * weight).sum() / norm
    pts = points.expand(b, -1, -1)[fg]
    target = torch.cat([pts - tgrid[:, :2], tgrid[:, 2:] - pts], -1).clamp(0, REG_MAX - 1.01)
    left = target.long()
    wl = left + 1 - target
    logp = F.log_softmax(dist_logits[fg], -1)
    dfl = -(logp.gather(-1, left[..., None])[..., 0] * wl
            + logp.gather(-1, (left + 1)[..., None])[..., 0] * (1 - wl)).mean(-1)
    dfl = (dfl * weight).sum() / norm
    return (gains[0] * box + gains[1] * bce + gains[2] * dfl) * b


def schedule(cfg: dict, step: int) -> tuple:
    """(lr of biases, lr of the rest, momentum) at 0-based step, float32."""
    f = np.float32
    nb, epochs = cfg["steps_per_epoch"], cfg["epochs"]
    epoch = np.floor(f(step) / f(nb))
    lf = np.maximum(f(1) - epoch / f(epochs), f(0)) * f(1 - cfg["lrf"]) + f(cfg["lrf"])
    base = f(cfg["lr0"]) * lf
    nw = max(round(cfg["warmup_epochs"] * nb), 100)
    t = np.clip(f(step) / f(nw), f(0), f(1))
    return (f(cfg["warmup_bias_lr"]) + t * (base - f(cfg["warmup_bias_lr"])), t * base,
            f(cfg["warmup_momentum"]) + t * f(cfg["momentum"] - cfg["warmup_momentum"]))


def ema_decay(cfg: dict, updates: int) -> np.float32:
    """The EMA's decay after ``updates`` steps, float32."""
    f = np.float32
    return f(cfg["ema_decay"]) * (f(1) - np.exp(-f(updates) / f(cfg["ema_tau"])))


class Trainer:
    """The reference's training of ``model`` (a model.YOLO) in place."""

    def __init__(self, model: M.YOLO, cfg: dict, mode: str = "f32"):
        self.model, self.cfg, self.mode = model, cfg, mode
        self.step_no = 0
        self.buf: Dict[str, torch.Tensor] = {}
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.ema = {n: p.detach().clone() for n, p in self.params.items()}

    def group(self, name: str, p: torch.Tensor) -> str:
        if name.rsplit(".", 1)[-1] == "bias":
            return "bias"
        return "decay" if p.ndim >= 2 else "rest"

    def step(self, batch: dict) -> float:
        """One step; -> the loss. ``self.first_grad`` holds the gradient the
        optimizer took at the first step (weight decay included)."""
        model = self.model
        model.train()
        for p in self.params.values():
            p.grad = None
        with P.precision(self.mode):
            raw, _ = model(batch["images"])
            loss = detection_loss(raw, batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"],
                                  model.nc)
        loss.backward()
        lr_bias, lr_rest, mom = schedule(self.cfg, self.step_no)
        grads = {}
        with torch.no_grad():
            for n, p in self.params.items():
                g = self.group(n, p)
                d = p.grad + self.cfg["weight_decay"] * p if g == "decay" else p.grad.clone()
                grads[n] = d
                buf = self.buf.get(n)
                buf = d.clone() if buf is None else buf.mul_(float(mom)).add_(d)
                self.buf[n] = buf
                p.add_(d + float(mom) * buf, alpha=-float(lr_bias if g == "bias" else lr_rest))
            for m in model.modules():
                pending = getattr(m, "pending", None)
                if pending is not None:
                    m.running_mean.copy_(pending[0])
                    m.running_var.copy_(pending[1])
                    m.pending = None
            d = ema_decay(self.cfg, self.step_no + 1)
            for n, p in self.params.items():
                self.ema[n].mul_(float(d)).add_(p, alpha=float(np.float32(1) - d))
        if self.step_no == 0:
            self.first_grad = {n: float(g.norm()) for n, g in grads.items()}
        self.step_no += 1
        return float(loss.detach())


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().float().norm()) for n, t in tensors.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    """max over leaves |prog - ref| / max(ref, the median leaf's ref)."""
    med = float(np.median([ref[n] for n in leaves]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves)
