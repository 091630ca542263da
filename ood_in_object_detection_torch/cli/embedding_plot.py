"""2D embedding plots of extracted activations, known vs unknown classes
(port of ood_in_object_detection_tpu/cli/embedding_plot.py; reference
create_umap_representation.py:25-735).

Modes (umap-learn stands aside for the SDR triplet embedder, ood/sdr.py):

- ``sdr``: a supervised 2D embedding fitted on the known classes, the
  unknown classes projected into the same space (reference 'umap');
- ``pca_sdr``: PCA to 50 components first (reference 'pca_umap');
- ``pca``: a plain 2D PCA.

Fit on the KNOWN-class activations only, then *transform* the unknown ones
(reference create_and_plot_one_stride); ``--one_per_stride`` fits per
stride, else the strides are pooled; ``--grid_search`` sweeps the
embedder's epochs and neighbours, one figure per configuration. Each figure
is a known-only scatter and a known + unknown overlay (unknowns as
squares), drawn with matplotlib. PCA is this module's own NumPy code
(:class:`PCA`, scikit-learn 1.9's ``PCA(n_components)``): the card's
machine has no scikit-learn. The SDR fit runs on ``--device``, with TF32
off (core/precision.py).

    python -m ood_in_object_detection_torch.cli.embedding_plot \\
        --activations acts.pkl --number_of_known_classes 20 --out_dir plots
"""

from __future__ import annotations

import argparse
import itertools
import logging
import pickle
from pathlib import Path
from typing import List, Tuple

import numpy as np
import scipy.linalg

from ..core.precision import disable_tf32

log = logging.getLogger("embedding_plot")


def svd_flip_rows(vt: np.ndarray) -> np.ndarray:
    """Each row of ``vt`` signed so that its largest magnitude is positive
    (scikit-learn's ``svd_flip(u, v, u_based_decision=False)``)."""
    pick = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), pick])
    return vt * signs[:, None]


class PCA:
    """scikit-learn 1.9's ``PCA(n_components)`` (whiten off, copy on):

    - ``svd_solver='auto'``: ``covariance_eigh`` when there are at most
      1000 features and at least 10 times as many samples, else ``full``
      when neither side exceeds 500, else ``randomized`` when
      ``n_components < 0.8 * min(shape)``, else ``full``;
    - the mean is taken out (``full``, ``randomized``) or the covariance
      centred (``covariance_eigh``), then the SVD or the eigendecomposition
      (scipy's ``gesdd``, ``np.linalg.eigh``), components signed by
      ``svd_flip`` on their rows;
    - ``randomized``: scikit-learn draws its range finder's start from
      NumPy's global state (the JAX tool calls it unseeded), so that regime
      has no fixed answer; this class takes the ``full`` solver's exact SVD
      there, which spans the same leading subspace.

    Float32 input stays float32, anything else becomes float64."""

    def __init__(self, n_components: int):
        self.n_components = n_components

    @staticmethod
    def _as_float(x) -> np.ndarray:
        x = np.asarray(x)
        return x if x.dtype in (np.float32, np.float64) else x.astype(np.float64)

    def solver(self, shape) -> str:
        n, d = shape
        if d <= 1000 and n >= 10 * d:
            return "covariance_eigh"
        if max(shape) <= 500:
            return "full"
        if 1 <= self.n_components < 0.8 * min(shape):
            return "randomized"
        return "full"

    def fit(self, x) -> "PCA":
        x = self._as_float(x)
        n, d = x.shape
        k = self.n_components
        if not 0 < k <= min(n, d):
            raise ValueError(f"n_components={k} must be between 1 and min(n_samples, "
                             f"n_features)={min(n, d)}")
        self.svd_solver_ = self.solver(x.shape)
        self.mean_ = np.mean(x, axis=0)
        if self.svd_solver_ == "covariance_eigh":
            cov = x.T @ x
            cov -= n * self.mean_.reshape(-1, 1) * self.mean_.reshape(1, -1)
            cov /= n - 1
            _, vecs = np.linalg.eigh(cov)
            vt = np.flip(vecs, axis=1).T
        else:
            _, _, vt = scipy.linalg.svd(x - self.mean_, full_matrices=False)
        self.components_ = np.array(svd_flip_rows(vt)[:k])
        return self

    def transform(self, x) -> np.ndarray:
        x = self._as_float(x)
        return x @ self.components_.T - self.mean_.reshape(1, -1) @ self.components_.T


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("embedding_plot")
    p.add_argument("--activations", required=True,
                   help="pickle from cli.extract_activations")
    p.add_argument("--mode", default="sdr", choices=["sdr", "pca_sdr", "pca"])
    p.add_argument("--number_of_known_classes", type=int, required=True)
    p.add_argument("--one_per_stride", action="store_true",
                   help="one embedding per stride (reference one_umap_per_stride)")
    p.add_argument("--stride", type=int, default=-1,
                   help="restrict to one stride (-1 = all)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_per_class", type=int, default=500)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--k_neighbors", type=int, default=15)
    p.add_argument("--grid_search", action="store_true",
                   help="sweep embedder params, one figure per config "
                        "(reference grid_search_umap)")
    p.add_argument("--class_names", nargs="*", default=None)
    p.add_argument("--device", default="0",
                   help="CUDA device index for the SDR fit, or 'cpu'")
    return p


def _gather(acts, strides: List[int], max_per_class: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    groups = []  # (class, (N, C_s) rows): strides differ in channel width
    for c, per_cls in enumerate(acts):
        for s in strides:
            a = per_cls[s] if isinstance(per_cls, (list, tuple)) else per_cls
            if isinstance(a, np.ndarray) and a.size:
                groups.append((c, a.reshape(len(a), -1).astype(np.float32)))
    if not groups:
        return np.empty((0, 1), np.float32), np.empty(0, int)
    width = max(g.shape[1] for _, g in groups)
    feats, labels = [], []
    for c in sorted({c for c, _ in groups}):
        a = np.concatenate([np.pad(g, ((0, 0), (0, width - g.shape[1])))
                            for cc, g in groups if cc == c])
        if len(a) > max_per_class:
            a = a[rng.choice(len(a), max_per_class, replace=False)]
        feats.append(a)
        labels.append(np.full(len(a), c))
    return np.concatenate(feats), np.concatenate(labels)


def _fit_transform(mode: str, Xk, yk, Xu, epochs: int, k_neighbors: int, device=None):
    """Fit on known, transform both known and unknown (reference
    create_and_plot_one_stride: fit_transform(known, y) + transform(unknown));
    the SDR fit on ``device`` (None: the card)."""
    if mode == "pca":
        pca = PCA(n_components=2).fit(Xk)
        return pca.transform(Xk), (pca.transform(Xu) if len(Xu) else Xu[:, :2])
    if mode == "pca_sdr":
        pca = PCA(n_components=min(50, Xk.shape[1], len(Xk))).fit(Xk)
        Xk = pca.transform(Xk).astype(np.float32)
        Xu = pca.transform(Xu).astype(np.float32) if len(Xu) else Xu[:, : Xk.shape[1]]
    from ..ood.sdr import fit_triplet_embedder

    emb = fit_triplet_embedder(Xk, yk, out_dim=2, epochs=epochs, k_neighbors=k_neighbors,
                               device=device)
    return emb.transform(Xk), (emb.transform(Xu) if len(Xu) else np.empty((0, 2)))


def _plot(ek, yk, eu, yu, class_names, title: str, out_png: Path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cmap = plt.cm.tab20(np.arange(40) % 20)
    fig, ax = plt.subplots(figsize=(14, 10))
    color_idx = 0

    def label(c):
        return class_names[int(c)] if class_names and int(c) < len(class_names) else f"cls{int(c)}"

    for c in np.unique(yk):
        pts = ek[yk == c]
        if len(pts):
            ax.scatter(*pts.T, color=cmap[color_idx % 40], label=label(c), alpha=0.7, s=8)
            color_idx += 1
    fig.savefig(out_png.with_name(out_png.stem + "_known.png"), dpi=130, bbox_inches="tight")
    # overlay unknowns as squares (reference: marker='s', cap at 15 classes)
    for i, c in enumerate(np.unique(yu)):
        if i >= 15:
            break
        pts = eu[yu == c]
        if len(pts) > 50:
            ax.scatter(*pts.T, color=cmap[color_idx % 40], label=label(c), alpha=0.7, s=10,
                       marker="s")
            color_idx += 1
    ax.legend(fontsize=7, ncol=2)
    ax.set_title(title)
    fig.savefig(out_png, dpi=130, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rng = np.random.default_rng(0)
    disable_tf32()
    device = "cpu" if args.device == "cpu" else f"cuda:{int(args.device)}"

    payload = pickle.loads(Path(args.activations).read_bytes())
    acts = payload.get("roi_feats") or payload.get("logits")
    if acts is None:
        raise SystemExit("no activations found in payload")
    n_strides = max(len(p) for p in acts if isinstance(p, (list, tuple))) \
        if any(isinstance(p, (list, tuple)) for p in acts) else 1
    stride_sets = ([[s] for s in range(n_strides)] if args.one_per_stride
                   else [[args.stride]] if args.stride >= 0
                   else [list(range(n_strides))])

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    nk = args.number_of_known_classes

    configs = [dict(epochs=args.epochs, k_neighbors=args.k_neighbors)]
    if args.grid_search and args.mode != "pca":
        configs = [dict(epochs=e, k_neighbors=k)
                   for e, k in itertools.product([10, 20, 40], [5, 15, 30])]

    for strides in stride_sets:
        X, y = _gather(acts, strides, args.max_per_class, rng)
        if not len(X):
            log.warning("strides %s: no activations", strides)
            continue
        known = y < nk
        Xk, yk = X[known], y[known]
        Xu, yu = X[~known], y[~known]
        if not len(Xk):
            log.warning("strides %s: no known-class activations", strides)
            continue
        tag = "all" if len(strides) > 1 else f"s{strides[0]}"
        for cfg in configs:
            ek, eu = _fit_transform(args.mode, Xk, yk, Xu, **cfg, device=device)
            suffix = f"_e{cfg['epochs']}_k{cfg['k_neighbors']}" if args.grid_search else ""
            out = out_dir / f"{args.mode}_{tag}{suffix}.png"
            _plot(ek, yk, eu, yu, args.class_names,
                  f"{args.mode} strides={strides} {cfg}", out)
            log.info("wrote %s", out)


if __name__ == "__main__":
    main()
