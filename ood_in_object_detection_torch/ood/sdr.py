"""Supervised dimensionality reduction (SDR) for the distance methods.

Port of ood_in_object_detection_tpu/ood/sdr.py. The reference's SDR
variants (Umap, CosineIvis, L1Ivis, L2Ivis) wrap umap-learn and ivis
models, one embedder per stride fitted on the InD activations and applied
before clustering and scoring (ood_utils.py:2433-2571; EMBEDDING_DIMS 32,
K 15 in custom_hyperparams.py:22-27). The JAX package replaces them with a
small MLP trained on triplets, and so does this port:

- ``ivis`` mode (the paper's SDR): anchor and positive of the same class,
  negative of another class;
- ``umap`` mode: the positive one of the anchor's k cosine nearest
  neighbours, the negative any sample.

The loss is ``mean(softplus(|za - zp|^2 - |za - zn|^2))`` on L2-normalised
inputs, trained by Adam. The triplets are drawn on the host by
``np.random.default_rng(seed)`` with the JAX package's calls in its order,
so both packages train on the same triplets; the initial weights come from
a seeded ``torch.Generator`` (the JAX package's come from ``jax.random``, so
fitted embedders agree by quality, not by value; ``utils/weights.py:
sdr_params_from_jax`` carries JAX parameters across).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import CUSTOM_HYP
from .distance import l2_normalize_rows


def embedder_widths(n: int, d: int, out_dim: int) -> List[int]:
    """The ivis 'maaten' stack 500-500-2000 above 512 samples, else a
    narrow 128-128 one (JAX sdr.py:91)."""
    return [d, 500, 500, 2000, out_dim] if n > 512 else [d, 128, 128, out_dim]


def resolve_device(device) -> torch.device:
    """``None`` is the card; a card that is missing raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the SDR embedder fits on the card by default and CUDA is not "
                           "available: pass device='cpu'")
    return torch.device("cuda")


class TripletEmbedder(nn.Module):
    """One stride's embedder: Linear layers with SELU between them (the
    ivis 'maaten' network; JAX ``_mlp_apply``). Weights are normal x
    sqrt(2 / fan_in) from a ``torch.Generator`` seeded by ``seed``, biases
    zero (JAX ``_mlp_init``)."""

    def __init__(self, widths: List[int], seed: int = 15):
        super().__init__()
        self.widths = list(widths)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.layers:
                fan_in = layer.in_features
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen)
                                   * math.sqrt(2.0 / fan_in))
                layer.bias.zero_()
        self.fit_stats: dict = {}

    @property
    def in_dim(self) -> int:
        return self.widths[0]

    @property
    def out_dim(self) -> int:
        return self.widths[-1]

    @property
    def device(self) -> torch.device:
        return self.layers[0].weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.selu(x)
        return x

    @torch.no_grad()
    def transform(self, x: np.ndarray) -> np.ndarray:
        """(N, ...) activations -> (N, out_dim): flattened, L2-normalised,
        through the MLP on the embedder's device (JAX sdr.py:61-64)."""
        flat = torch.as_tensor(np.asarray(x, np.float32).reshape(len(x), -1), device=self.device)
        return self(l2_normalize_rows(flat)).cpu().numpy()


def triplet_loss(model: nn.Module, a: torch.Tensor, p: torch.Tensor,
                 n: torch.Tensor) -> torch.Tensor:
    """``mean(softplus(dp - dn))`` (JAX sdr.py:67-72). ``F.softplus`` is
    the identity above 20 where ``jax.nn.softplus`` is ``logaddexp(x, 0)``;
    they differ there by log1p(exp(-x)) < 2.1e-9, under half an f32 ulp of
    20."""
    za, zp, zn = model(a), model(p), model(n)
    dp = ((za - zp) ** 2).sum(-1)
    dn = ((za - zn) ** 2).sum(-1)
    return F.softplus(dp - dn).mean()


def normalized_rows(feats: np.ndarray) -> np.ndarray:
    """(N, ...) -> (N, D) float32 L2-normalised rows, on the host."""
    flat = torch.as_tensor(np.asarray(feats, np.float32).reshape(len(feats), -1))
    return l2_normalize_rows(flat).numpy()


def cosine_neighbours(flat: np.ndarray, k_neighbors: int) -> np.ndarray:
    """(N, kk) indices of each row's kk nearest rows by cosine similarity,
    in ``np.argpartition``'s order, computed with NumPy on the host as the
    JAX package does (sdr.py:98-101): the order depends on the values, and
    every later triplet on the order."""
    sims = flat @ flat.T
    np.fill_diagonal(sims, -np.inf)
    kk = min(k_neighbors, len(flat) - 1)
    return np.argpartition(-sims, kk, axis=1)[:, :kk]


def triplet_indices(flat: np.ndarray, labels: Optional[np.ndarray], k_neighbors: int,
                    epochs: int, batch: int, seed: int):
    """Yield one (anchors, positives, negatives) index triple a step: the
    draws of ``np.random.default_rng(seed)`` in the JAX package's order
    (sdr.py:86, 111-128). ``ivis`` (labels given): per element, one
    ``rng.choice`` among its class, then one among the other classes (none
    when a side is empty); ``umap`` (labels None): the neighbour column,
    then the negatives. Each class's index arrays are built once (the JAX
    loop rebuilds the same arrays per element). A single sample has no
    neighbour, and is its own positive in umap mode, drawing only the
    negatives (the JAX loop raises there: ``rng.integers(0, 0)``)."""
    rng = np.random.default_rng(seed)
    n = len(flat)
    if labels is None:
        nbrs = cosine_neighbours(flat, k_neighbors)
    else:
        labels = np.asarray(labels)
        classes = np.unique(labels)
        same = {c: np.flatnonzero(labels == c) for c in classes.tolist()}
        diff = {c: np.flatnonzero(labels != c) for c in classes.tolist()}
    for _ in range(epochs):
        for _ in range(max(n // batch, 1)):
            ai = rng.integers(0, n, batch)
            if labels is None:
                pi = nbrs[ai, rng.integers(0, nbrs.shape[1], batch)] if nbrs.shape[1] else ai
                ni = rng.integers(0, n, batch)
            else:
                pi = np.empty(batch, int)
                ni = np.empty(batch, int)
                for j, idx in enumerate(ai):
                    c = labels[idx].item()
                    pi[j] = rng.choice(same[c]) if same[c].size else idx
                    ni[j] = rng.choice(diff[c]) if diff[c].size else idx
            yield ai, pi, ni


# fit_stats' final_loss: the mean over this many last steps (one step's
# loss is one batch's)
FINAL_LOSS_STEPS = 10


def make_optimizer(model: nn.Module, lr: float, eps: float = 1e-8) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8 outside the root."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=eps)


def train_triplet_embedder(model: TripletEmbedder, flat: np.ndarray,
                           labels: Optional[np.ndarray], k_neighbors: int = 15,
                           epochs: int = 30, batch: int = 256, lr: float = 1e-3,
                           seed: int = 15, max_steps: Optional[int] = None,
                           eps: float = 1e-8) -> torch.Tensor:
    """Adam steps on ``model`` (in place, on its device and in its dtype)
    over the triplets of :func:`triplet_indices` on the L2-normalised rows
    ``flat``; -> the loss of each step (one tensor, read once at the end).
    ``max_steps`` stops early. Records ``model.fit_stats``: steps, the
    seconds of the whole loop and of the host's triplet sampling, and
    ``final_loss``, the mean loss of the last FINAL_LOSS_STEPS steps."""
    dev = model.device
    rows = torch.as_tensor(np.asarray(flat), dtype=model.layers[0].weight.dtype, device=dev)
    opt = make_optimizer(model, lr, eps)
    losses, sampling = [], 0.0
    t0 = time.perf_counter()
    draws = triplet_indices(flat, labels, k_neighbors, epochs, batch, seed)
    while max_steps is None or len(losses) < max_steps:
        ts = time.perf_counter()
        try:
            ai, pi, ni = next(draws)
        except StopIteration:
            break
        idx = torch.as_tensor(np.stack([ai, pi, ni]), device=dev)
        sampling += time.perf_counter() - ts
        opt.zero_grad(set_to_none=True)
        loss = triplet_loss(model, rows[idx[0]], rows[idx[1]], rows[idx[2]])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    out = torch.stack(losses) if losses else torch.empty(0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    model.fit_stats = dict(steps=len(losses), seconds=time.perf_counter() - t0,
                           sampling_s=sampling, n=len(flat), widths=list(model.widths),
                           final_loss=float(out[-FINAL_LOSS_STEPS:].mean()) if losses else None)
    return out


def fit_triplet_embedder(feats: np.ndarray, labels: Optional[np.ndarray], out_dim: int = 32,
                         k_neighbors: int = 15, epochs: int = 30, batch: int = 256,
                         lr: float = 1e-3, seed: int = 15, device=None) -> TripletEmbedder:
    """A fitted embedder of (N, ...) activations; ``labels`` None is the
    unsupervised ``umap`` mode. ``device`` None is the card."""
    flat = normalized_rows(feats)
    n, d = flat.shape
    model = TripletEmbedder(embedder_widths(n, d, out_dim), seed=seed).to(resolve_device(device))
    train_triplet_embedder(model, flat, labels, k_neighbors, epochs, batch, lr, seed)
    model.eval()
    return model


def fit_stride_embedders(acts, kind: str, device=None) -> List[Optional[TripletEmbedder]]:
    """acts[class][stride] = (N, ...) activations -> one fitted embedder per
    stride on ``device`` (None: the card), each on every non-empty sample of
    its stride, not gated by MIN_SAMPLES (reference
    _DimensionalityReductionMethod.generate_clusters, ood_utils.py:2450-2456);
    None for a stride without samples. ``kind`` 'ivis' labels the samples
    by class, 'umap' does not."""
    ivis_p = CUSTOM_HYP.dr.ivis
    embedders: List[Optional[TripletEmbedder]] = []
    for s in range(3):
        samples = stride_samples(acts, s, kind)
        embedders.append(None if samples is None else fit_triplet_embedder(
            *samples, out_dim=ivis_p.EMBEDDING_DIMS, k_neighbors=ivis_p.K, device=device))
    return embedders


def stride_samples(acts, s: int, kind: str):
    """Stride ``s``'s fitting samples: ((N, D) float32 rows of every
    class's non-empty activations, their class labels, None in 'umap'
    mode), or None when the stride has none."""
    per_stride, per_labels = [], []
    for c, per_cls in enumerate(acts):
        a = per_cls[s]
        if isinstance(a, np.ndarray) and a.size:
            per_stride.append(np.asarray(a, np.float32).reshape(len(a), -1))
            per_labels.append(np.full(len(a), c))
    if not per_stride:
        return None
    return np.concatenate(per_stride), (np.concatenate(per_labels) if kind == "ivis" else None)


def sdr_transform(state: dict, acts, cls_idx: int = 0, stride_idx: int = 0) -> np.ndarray:
    """A DistanceOODMethod's ``transform_fn``: (N, ...) activations -> the
    stride's embedding from ``state`` (the method's ``sdr_state``); raw
    L2-normalised rows for a stride never seen during fitting (JAX
    sdr.py:138-146). Raises before the embedders are fitted."""
    if state["embedders"] is None:
        raise RuntimeError("SDR transform used before fitting (call generate_clusters)")
    emb = state["embedders"][stride_idx]
    if emb is None:
        return normalized_rows(acts)
    return emb.transform(acts)


def attach_sdr_transform(method, kind: str = "ivis", device=None) -> None:
    """Make a DistanceOODMethod an SDR method (JAX sdr.py:132-171): its
    ``sdr_state`` holds the kind, the fitting device (None: the card) and
    the ``embedders`` list, None until the method's first
    ``generate_clusters`` fits them (:func:`fit_stride_embedders`); its
    ``transform_fn`` is :func:`sdr_transform`. Both the host transform and
    :func:`sdr_embeddings` read the embedders from ``method.sdr_state``."""
    method.sdr_state = {"embedders": None, "kind": kind, "device": device}
    method.transform_fn = sdr_transform


def sdr_embeddings(method, flat: torch.Tensor, level: torch.Tensor) -> Optional[torch.Tensor]:
    """(B*N, Cmax) L2-normalised box features and their levels -> (B*N,
    out_dim) f32 SDR embeddings (JAX pipeline.py:333-350): each stride's
    embedder sees the first ``in_dim`` channels normalised again, a stride
    without an embedder gives zeros, each box takes its level's row. None
    when the method has no fitted embedder. bf16 features are normalised in
    bf16 and upcast before the MLP (JAX promotes bf16 @ f32 to f32)."""
    state = method.sdr_state
    if state is None or state["embedders"] is None or \
            all(e is None for e in state["embedders"]):
        return None
    embs = state["embedders"]
    out_dim = next(e.out_dim for e in embs if e is not None)
    zs = []
    with torch.no_grad():
        for emb in embs:
            if emb is None:
                zs.append(torch.zeros(flat.shape[0], out_dim, device=flat.device))
            else:
                zs.append(emb(l2_normalize_rows(flat[:, : emb.in_dim]).float()))
    rows = torch.arange(flat.shape[0], device=flat.device)
    return torch.stack(zs)[level.long(), rows]
