"""Serve a bundle of ``utils/export.py`` under closed-loop clients, in a
process that builds no model and reads no checkpoint.

    python -m ood_in_object_detection_torch.scripts.serve_bundle --bundle DIR \\
        --images requests.npy --out served.pkl [--clients 8] [--max_wait_ms 2] \\
        [--device cpu]

``--images``: an (N, S, S, 3) uint8 array, one request an image.
``MicroBatchServer.from_bundle`` loads DIR (the card unless ``--device cpu``)
and warms up on the bundle's step; ``--clients`` threads then submit the N
requests, each client its share one at a time (client c takes requests c,
c + clients, ...). The kernels' launch counters are set to 0 just before the
clients start and read just after they finish. TF32 is off for cuDNN
convolutions and matmuls, as in the CLIs (core/precision.py).

Prints one JSON line: the load and warm-up seconds, the served images/s,
the p50 / p99 / mean latency, the number of groups, the launches of K4, K1,
K2 (f32, bf16) and K3 over the clients' run and per group, and whether the
process imported the checkpoint reader (core/checkpoint.py). Writes each
request's result and the server's groups (the request indices of each
stacked batch, in row order) to ``--out`` (pickle), for a caller that holds
them against a live detector.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import threading
import time

import numpy as np
import torch

from ..core.precision import disable_tf32
from ..ood import distance as D
from ..ops import nms as N
from ..ops import roi_align as R
from ..ops import stem as S
from ..serving import MicroBatchServer

COUNTERS = {"fused_stem": (S.fused_stem, "launches"),
            "greedy_keep": (N.greedy_keep, "launches"),
            "roi_contract": (R.roi_contract, "launches"),
            "roi_contract_bf16": (R.roi_contract, "launches_bf16"),
            "min_group_distances": (D.min_group_distances, "launches")}


def read_counters() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def serve(bundle, images: np.ndarray, clients: int = 8, max_wait_ms: float = 2.0,
          device=None) -> tuple:
    """-> (report dict, results list, groups list) of one closed-loop run."""
    t0 = time.perf_counter()
    srv = MicroBatchServer.from_bundle(bundle, device=device, max_wait_ms=max_wait_ms)
    if srv.detector.device.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    views = [images[k] for k in range(len(images))]
    index = {id(v): k for k, v in enumerate(views)}
    results, lat, errors, groups = [None] * len(views), [0.0] * len(views), [], []
    collect = srv._collect

    def recording_collect():  # each group's requests, in the rows' order
        group = collect()
        if group is not None:
            groups.append([index[id(r.image)] for r in group])
        return group

    srv._collect = recording_collect  # before start(): its thread's first wait
    t0 = time.perf_counter()
    srv.start()
    warmup_s = time.perf_counter() - t0
    ready = threading.Barrier(clients)

    def client(c):
        ready.wait(timeout=60)  # the clients start together
        for k in range(c, len(views), clients):
            t = time.perf_counter()
            try:
                results[k] = srv.predict_one(views[k])
            except Exception as e:  # noqa: BLE001 (reported)
                errors.append(f"request {k}: {e!r}")
            lat[k] = time.perf_counter() - t

    try:
        for fn, attr in COUNTERS.values():
            setattr(fn, attr, 0)
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = read_counters()
    finally:
        srv.stop()
    ms = np.asarray(lat) * 1e3
    report = dict(bundle=str(bundle), device=str(srv.detector.device), requests=len(views),
                  clients=clients, batch=srv.batch_size, max_wait_ms=max_wait_ms,
                  conf_thres=srv.conf_thres, method=type(srv.ood_method).__name__,
                  load_s=load_s, warmup_s=warmup_s, wall_s=wall,
                  images_per_s=len(views) / wall,
                  latency_ms=dict(p50=float(np.percentile(ms, 50)),
                                  p99=float(np.percentile(ms, 99)), mean=float(ms.mean())),
                  groups=len(groups), launches=launches,
                  launches_per_group={k: v / max(len(groups), 1) for k, v in launches.items()},
                  failed=errors[:5], unanswered=sum(r is None for r in results),
                  imports_checkpoint_reader="ood_in_object_detection_torch.core.checkpoint"
                                            in sys.modules)
    return report, results, groups


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--images", required=True, help="(N, S, S, 3) uint8 .npy, one request each")
    ap.add_argument("--out", required=True, help="pickle of the results and groups")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--device", default=None, help="'cpu', or the card by default")
    args = ap.parse_args(argv)
    disable_tf32()
    images = np.load(args.images)
    report, results, groups = serve(args.bundle, images, args.clients, args.max_wait_ms,
                                    args.device)
    report["tf32"] = dict(cudnn=torch.backends.cudnn.allow_tf32,
                          matmul=torch.backends.cuda.matmul.allow_tf32)
    with open(args.out, "wb") as f:
        pickle.dump(dict(results=results, groups=groups), f)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
