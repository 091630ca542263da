"""Aggregate benchmark result CSVs into paper-style tables and pareto plots.

Capability parity with the reference's post-hoc notebooks
(process_results.ipynb / score_fusion_plot.ipynb, README.md:63-77 folder
layout): collect every ``results/*.csv`` produced by
`eval/results_writer.py` (reference schema, constants.py column sets),
concatenate, and emit

- ``summary.csv``: every run, sorted by the primary metric,
- ``best_per_method.csv``: the best configuration row per Method,
- ``pareto.csv`` + ``pareto.png``: the pareto-efficient set over a
  (known-performance, unknown-performance) metric pair — the paper's
  mAP-vs-U-F1 trade-off fronts.

Port of ood_in_object_detection_tpu/cli/process_results.py: pandas is
imported inside the functions that use it and matplotlib inside the
plots, so that the module imports where neither is installed.

Usage:
  python -m ood_in_object_detection_torch.cli.process_results \
      --results_dir results --out_dir results/processed \
      --metric_x "mAP_(VOC_test)" --metric_y "U-F1_(COOD)"
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def load_results(results_dir: str):
    """Every ``results/*.csv`` with a Method column, concatenated (a
    pandas DataFrame, with each row's ``source_file``)."""
    import pandas as pd

    paths = sorted(Path(results_dir).rglob("*.csv"))
    frames = []
    for p in paths:
        try:
            df = pd.read_csv(p)
        except Exception:
            continue
        if "Method" in df.columns:
            df["source_file"] = str(p)
            frames.append(df)
    if not frames:
        raise SystemExit(f"no result CSVs with a Method column under {results_dir}")
    return pd.concat(frames, ignore_index=True)


def pareto_front(df, mx: str, my: str):
    """Rows not dominated in (mx, my), both maximized, sorted by mx."""
    sub = df.dropna(subset=[mx, my]).copy()
    pts = sub[[mx, my]].to_numpy(float)
    keep = []
    for i, (x, y) in enumerate(pts):
        dominated = np.any((pts[:, 0] >= x) & (pts[:, 1] >= y)
                           & ((pts[:, 0] > x) | (pts[:, 1] > y)))
        if not dominated:
            keep.append(i)
    return sub.iloc[keep].sort_values(mx)


def fusion_scatter(npz_path: str, out_path: str) -> str:
    """Score-fusion analysis figure (reference score_fusion_plot.ipynb): the
    INDness of fusion member A against member B per detected box, colored by
    the fused verdict, with the INDness=0 decision boundaries splitting the
    plane into quadrants. Input: .npz from
    ood.pipeline.collect_fusion_member_indness (or ood_eval
    --dump_fusion_scores)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(npz_path, allow_pickle=False)
    ind = data["indness"]
    names = [str(n) for n in data["member_names"]]
    dec = data["decision"].astype(bool)
    assert ind.shape[0] >= 2, "fusion scatter needs >= 2 members"
    a, b = ind[0], ind[1]
    fig, ax = plt.subplots(figsize=(6.5, 6))
    ax.scatter(a[dec], b[dec], s=14, c="#1f6f43", alpha=0.65,
               label=f"fused InD (n={int(dec.sum())})")
    ax.scatter(a[~dec], b[~dec], s=14, c="#b23a48", alpha=0.65, marker="x",
               label=f"fused OoD (n={int((~dec).sum())})")
    ax.axhline(0.0, color="k", lw=1, ls="--")
    ax.axvline(0.0, color="k", lw=1, ls="--")
    # with CLIP_FUSION_SCORES=False INDness can exceed ±1: grow the limits
    # to the data so extreme-score boxes stay visible, never shrink below ±1
    lim_a = max(1.0, float(np.abs(a).max(initial=0.0))) * 1.05
    lim_b = max(1.0, float(np.abs(b).max(initial=0.0))) * 1.05
    ax.set_xlim(-lim_a, lim_a)
    ax.set_ylim(-lim_b, lim_b)
    ax.set_xlabel(f"INDness — {names[0]}")
    ax.set_ylabel(f"INDness — {names[1]}")
    ax.set_title("Score fusion: member INDness with decision quadrants")
    ax.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fusion_npz", default=None,
                    help="render the score-fusion member scatter from a "
                         ".npz (collect_fusion_member_indness) and exit")
    ap.add_argument("--fusion_out", default=None,
                    help="output PNG for --fusion_npz "
                         "(default: <npz dir>/fusion_scatter.png)")
    ap.add_argument("--results_dir", default="results")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--metric_x", default="mAP_(VOC_test)")
    ap.add_argument("--metric_y", default="U-F1_(COOD)")
    ap.add_argument("--sort_by", default=None,
                    help="primary metric for summary/best tables "
                         "(default: metric_y)")
    ap.add_argument("--no_plot", action="store_true")
    args = ap.parse_args(argv)

    if args.fusion_npz:
        out = args.fusion_out or str(Path(args.fusion_npz).with_name(
            "fusion_scatter.png"))
        print(f"fusion scatter -> {fusion_scatter(args.fusion_npz, out)}")
        return 0

    out_dir = Path(args.out_dir or (Path(args.results_dir) / "processed"))
    out_dir.mkdir(parents=True, exist_ok=True)
    df = load_results(args.results_dir)
    sort_by = args.sort_by or args.metric_y
    if sort_by in df.columns:
        df = df.sort_values(sort_by, ascending=False)
    df.to_csv(out_dir / "summary.csv", index=False)

    if sort_by in df.columns:
        best = df.dropna(subset=[sort_by]).groupby("Method", as_index=False).first()
        best.to_csv(out_dir / "best_per_method.csv", index=False)
    else:
        best = None

    have_xy = args.metric_x in df.columns and args.metric_y in df.columns
    if have_xy:
        front = pareto_front(df, args.metric_x, args.metric_y)
        front.to_csv(out_dir / "pareto.csv", index=False)
        if not args.no_plot:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(7, 5))
            sub = df.dropna(subset=[args.metric_x, args.metric_y])
            for m, g in sub.groupby("Method"):
                ax.scatter(g[args.metric_x], g[args.metric_y], s=18, label=str(m))
            ax.plot(front[args.metric_x], front[args.metric_y],
                    "k--", lw=1, label="pareto front")
            ax.set_xlabel(args.metric_x)
            ax.set_ylabel(args.metric_y)
            ax.legend(fontsize=7, ncol=2)
            fig.tight_layout()
            fig.savefig(out_dir / "pareto.png", dpi=150)
            plt.close(fig)
        n_front = len(front)
    else:
        n_front = 0

    print(f"processed {len(df)} rows from {args.results_dir} -> {out_dir} "
          f"(best_per_method: {0 if best is None else len(best)}, "
          f"pareto: {n_front})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
