"""Port parity for centroid distances (ood/distance.py, kernel K3's plain
version; ood/methods.py DistanceOODMethod) against the JAX package, on the
CPU, for cosine, l2 and l1, with empty groups.

Tolerances: cosine and l1 within 1e-5. L2 gets atol 1e-3 where the
distance is near 0: it is sqrt(|x|^2 + |c|^2 - 2 x.c), and the f32
cancellation error of ~1e-7 in the squared distance becomes ~3e-4 after
the square root of a value near zero."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_tpu.ood.distance import l2_normalize_rows as j_normalize
from ood_in_object_detection_tpu.ops.pallas import distance as pdist
from ood_in_object_detection_torch.ood import distance as tdist
from ood_in_object_detection_torch.ood import methods as tmethods


def _bank(rng, g=6, k=4, d=128):
    cents = rng.normal(0, 1, (g, k, d)).astype(np.float32)
    kmask = np.zeros((g, k), bool)
    kmask[0, :1] = True
    kmask[1, :3] = True
    kmask[2] = True
    kmask[4, :2] = True  # groups 3 and 5 empty
    return cents, kmask


def _close(got, ref, metric):
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    atol = 1e-3 if metric == "l2" else 1e-5
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_min_group_plain_matches_pallas(metric, monkeypatch):
    rng = np.random.default_rng(0)
    cents, kmask = _bank(rng)
    feats = rng.normal(0, 1, (37, 128)).astype(np.float32)
    feats[3] = cents[2, 1]  # an exact hit: l2 distance ~0
    if metric == "cosine":
        feats = np.asarray(j_normalize(jnp.asarray(feats)))
        cents = np.asarray(j_normalize(jnp.asarray(cents)))
    monkeypatch.setattr(pdist.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    ref = np.asarray(pdist.min_group_distances_pallas(
        jnp.asarray(feats), jnp.asarray(cents), jnp.asarray(kmask), metric))
    got = tdist.min_group_distances(torch.from_numpy(feats), torch.from_numpy(cents),
                                    torch.from_numpy(kmask), metric).numpy()
    assert np.isinf(got[:, 3]).all() and np.isinf(got[:, 5]).all()
    _close(got, ref, metric)


@pytest.mark.parametrize("metric", ["cosine", "l2", "l1"])
def test_min_group_plain_matches_jax_reference(metric):
    rng = np.random.default_rng(1)
    cents, kmask = _bank(rng, g=9, k=3, d=64)
    feats = rng.normal(0, 1, (50, 64)).astype(np.float32)
    ref = np.asarray(pdist.min_group_distances_ref(
        jnp.asarray(feats), jnp.asarray(cents), jnp.asarray(kmask), metric))
    got = tdist.min_group_distances(torch.from_numpy(feats), torch.from_numpy(cents),
                                    torch.from_numpy(kmask), metric).numpy()
    _close(got, ref, metric)


def _acts(rng, nc=3, dims=(16, 32, 64)):
    """[class][stride] activations; class 2 stride 1 has too few samples
    to get a cluster and class 1 stride 2 none at all."""
    acts = []
    for c in range(nc):
        row = []
        for s, d in enumerate(dims):
            n = 2 if (c, s) == (2, 1) else 0 if (c, s) == (1, 2) else 20
            row.append(rng.normal(c, 1.0, (n, d)).astype(np.float32) if n else np.empty(0, np.float32))
        acts.append(row)
    return acts


@pytest.mark.parametrize("name", ["Cosine_cl_stride", "L2_cl_stride", "L1_cl_stride"])
def test_distance_method_matches_jax(name):
    rng = np.random.default_rng(2)
    acts = _acts(rng)
    jm = jmethods.DistanceOODMethod.from_name(name)
    tm = tmethods.DistanceOODMethod.from_name(name)
    for m in (jm, tm):
        m.generate_clusters(acts)
        m.generate_thresholds(m.compute_scores_from_activations(acts), 0.95)
    for row_j, row_t in zip(jm.thresholds, tm.thresholds):
        for a, b in zip(row_j, row_t):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(b, a, rtol=1e-5)
    n = 64
    feats = rng.normal(1, 1, (n, 64)).astype(np.float32)
    feats = np.asarray(j_normalize(jnp.asarray(feats)))
    cls = rng.integers(0, 3, n)
    stride = rng.integers(0, 3, n)
    ref = np.asarray(jm.distances(jnp.asarray(feats), jnp.asarray(cls, jnp.int32),
                                  jnp.asarray(stride, jnp.int32)))
    got = tm.distances(torch.from_numpy(feats), torch.from_numpy(cls),
                       torch.from_numpy(stride)).numpy()
    empty = ((cls == 2) & (stride == 1)) | ((cls == 1) & (stride == 2))
    assert empty.any() and (got[empty] == tdist.NO_CLUSTER_DISTANCE).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    valid = np.ones(n, bool)
    dec_j = np.asarray(jm.decide_from_distances(jnp.asarray(ref), jnp.asarray(cls, jnp.int32),
                                                jnp.asarray(stride, jnp.int32), jnp.asarray(valid)))
    dec_t = tm.decide_from_distances(torch.from_numpy(got), torch.from_numpy(cls),
                                     torch.from_numpy(stride), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(dec_t, dec_j)
    ind_j = np.asarray(jm.indness_from_distances(jnp.asarray(ref), jnp.asarray(cls, jnp.int32),
                                                 jnp.asarray(stride, jnp.int32), jnp.asarray(valid)))
    ind_t = tm.indness_from_distances(torch.from_numpy(got), torch.from_numpy(cls),
                                      torch.from_numpy(stride), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(ind_t, ind_j, rtol=1e-4, atol=1e-5)


def test_unported_cluster_methods_raise():
    """GMM and BGMM build, as every cluster method of the JAX package does:
    an L2_cl_stride with GMM fits the JAX package's centroids after the
    same np.random.seed, and an SDR name takes BGMM alike."""
    from ood_in_object_detection_tpu.core.config import CUSTOM_HYP as JHYP
    from ood_in_object_detection_torch.core.config import CUSTOM_HYP as THYP

    rng = np.random.default_rng(5)
    acts = [[(rng.normal(size=(n, 8)) + rng.normal(size=(1, 8))).astype(np.float32)
             if n else np.empty(0) for n in row] for row in ((40, 0, 12), (30, 25, 0))]
    got, want = [], []
    for mod, out in ((tmethods, got), (jmethods, want)):
        m = mod.DistanceOODMethod.from_name("L2_cl_stride", cluster_method="GMM")
        np.random.seed(0)
        out.append(m.generate_clusters(acts))
    assert JHYP.clusters.MIN_SAMPLES == THYP.clusters.MIN_SAMPLES
    fitted = 0
    for trow, jrow in zip(got[0], want[0]):
        for t, j in zip(trow, jrow):
            assert np.shape(t) == np.shape(j)
            if np.ndim(j) == 2:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
                fitted += 1
    assert fitted == 4
    t = tmethods.DistanceOODMethod.from_name("Umap", cluster_method="BGMM")
    j = jmethods.DistanceOODMethod.from_name("Umap", cluster_method="BGMM")
    assert (t.name, t.metric, t.cluster_method) == (j.name, j.metric, j.cluster_method)


# K3's schedule (csrc/min_group_distance.cu), emulated in plain torch: row
# tiles (rows past N clamped to the last, never written), runs of groups,
# each run's valid centroids compacted in order into slices of at most BN
# columns, D in chunks with zeros past D, each chunk split among ksplit
# thread groups whose partial dots are summed in group order, |x|^2 and
# |c|^2 summed over the same chunks (l2), the distances folded segment by
# segment (8 columns, one fold per change of group) into a running minimum
# a (row, group), +inf where a group has no valid centroid.

def _k3_schedule(feats, cents, kmask, metric):
    n, d = feats.shape
    g, k, _ = cents.shape
    plan = tdist.k3_plan(n, g, k)
    chunk, kgw = plan.chunk, plan.chunk // plan.ksplit
    chunks = -(-d // chunk)
    pad = chunks * chunk - d
    x = torch.nn.functional.pad(feats, (0, pad))
    flat_c = torch.nn.functional.pad(cents.reshape(g * k, d), (0, pad))
    flat_m = kmask.reshape(-1)
    out = torch.full((n, g), float("nan"))
    slices = 0
    for t in range(plan.row_tiles):
        r0 = t * plan.bm
        xt = x[torch.clamp(torch.arange(r0, r0 + plan.bm), max=n - 1)]
        rows = min(plan.bm, n - r0)
        for run in range(plan.runs):
            g0 = run * plan.gr
            ng = min(plan.gr, g - g0)
            runmin = torch.full((plan.bm, ng), float("inf"))
            valid = torch.nonzero(flat_m[g0 * k:(g0 + ng) * k]).flatten()
            for s0 in range(0, len(valid), plan.bn):
                cols = valid[s0:s0 + plan.bn]
                cs = flat_c[g0 * k + cols]
                part = torch.zeros(plan.ksplit, plan.bm, len(cols))
                xx, cc = torch.zeros(plan.bm), torch.zeros(len(cols))
                for ch in range(chunks):
                    for kg in range(plan.ksplit):
                        sl = slice(ch * chunk + kg * kgw, ch * chunk + (kg + 1) * kgw)
                        part[kg] += xt[:, sl] @ cs[:, sl].T
                    sl = slice(ch * chunk, (ch + 1) * chunk)
                    xx += (xt[:, sl] ** 2).sum(1)
                    cc += (cs[:, sl] ** 2).sum(1)
                dot = part[0]
                for kg in range(1, plan.ksplit):
                    dot = dot + part[kg]
                dist = (torch.sqrt(torch.clamp(xx[:, None] + cc[None] - 2.0 * dot, min=0.0))
                        if metric == "l2" else 1.0 - dot)
                grp = (cols // k).tolist()
                for c0 in range(0, len(cols), 8):
                    cur, best = grp[c0], dist[:, c0]
                    for c in range(c0 + 1, min(c0 + 8, len(cols))):
                        if grp[c] != cur:
                            runmin[:, cur] = torch.minimum(runmin[:, cur], best)
                            cur, best = grp[c], dist[:, c]
                        else:
                            best = torch.minimum(best, dist[:, c])
                    runmin[:, cur] = torch.minimum(runmin[:, cur], best)
                slices += 1
            out[r0:r0 + rows, g0:g0 + ng] = runmin[:rows]
    return out, slices


def _k3_inputs(rng, n, g, k, d, metric, masked=0.3, empty=(0,)):
    """Unit feature rows, as the distance methods give them
    (ood/pipeline.py:distance_features); for l2 centroids of norm 0.5-1,
    like means of unit rows, for cosine unit ones; one row an exact hit."""
    feats = np.array(j_normalize(jnp.asarray(rng.normal(0, 1, (n, d)).astype(np.float32))))
    cents = np.array(j_normalize(jnp.asarray(rng.normal(0, 1, (g, k, d)).astype(np.float32))))
    if metric == "l2":
        cents = (cents * rng.uniform(0.5, 1.0, (g, k, 1))).astype(np.float32)
    kmask = rng.uniform(size=(g, k)) > masked
    for e in empty:
        kmask[e] = False
    feats[min(3, n - 1)] = cents[-1, int(np.argmax(kmask[-1]))]  # dist ~0
    return feats, cents, kmask


@pytest.mark.parametrize("n,g,k", [(2400, 60, 1), (2400, 60, 5), (2400, 60, 200), (7, 3, 64),
                                   (7, 3, 65)])
def test_k3_plan(n, g, k):
    """The eval path's K 1 is one run of all 60 groups over 100 row tiles of
    24 (one block an SM, one wave); K 5 takes 12 groups a run; K > 64 the
    wide tile, one group a block."""
    plan = tdist.k3_plan(n, g, k)
    assert plan.row_tiles == -(-n // plan.bm) and plan.runs == -(-g // plan.gr)
    assert plan.chunk % (2 * plan.ksplit) == 0
    if k <= 64:
        assert not plan.wide and plan.gr * k <= plan.bn and plan.bm == 24
        assert plan.gr == min(g, 64 // k)
    else:
        assert plan.wide and plan.gr == 1 and plan.bn == 128
    if (n, g, k) == (2400, 60, 1):
        assert (plan.runs, plan.row_tiles) == (1, 100)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("case", ["ragged_rows", "ragged_d", "k_past_tile", "all_empty_group",
                                  "kd_past_227kb"])
def test_k3_schedule_matches_plain(case, metric):
    """N not a multiple of the row tile; D not a multiple of the chunk; K
    past one column tile (two slices, the minimum carried); an all-empty
    group; K D past 227 KB of shared memory (K 120, D 512: the bank the old
    kernel could not stage)."""
    rng = np.random.default_rng(len(case))
    n, g, k, d, masked, empty = {"ragged_rows": (37, 6, 5, 64, 0.3, (0,)),
                                 "ragged_d": (20, 5, 3, 100, 0.3, (0,)),
                                 "k_past_tile": (21, 3, 150, 40, 0.05, ()),
                                 "all_empty_group": (18, 4, 70, 32, 0.3, (1, 3)),
                                 "kd_past_227kb": (19, 2, 120, 512, 0.3, (0,))}[case]
    feats, cents, kmask = _k3_inputs(rng, n, g, k, d, metric, masked, empty)
    f, c, m = torch.from_numpy(feats), torch.from_numpy(cents), torch.from_numpy(kmask)
    got, slices = _k3_schedule(f, c, m, metric)
    ref = tdist.min_group_distances_plain(f, c, m, metric).numpy()
    assert not np.isnan(got.numpy()).any()
    _close(got.numpy(), ref, metric)
    for e in empty:
        assert np.isinf(got.numpy()[:, e]).all()
    plan = tdist.k3_plan(n, g, k)
    if case == "k_past_tile":  # more valid centroids in a group than one slice holds
        assert kmask.sum(1).max() > plan.bn and slices > plan.runs * plan.row_tiles
    if case == "kd_past_227kb":
        assert k * d * 4 > 227 * 1024


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("k", [5, 140])
def test_k3_schedule_matches_pallas(k, metric, monkeypatch):
    """K > 1 with empty groups: the emulated schedule, the port's wrapper
    (plain on the CPU) and the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(k)
    feats, cents, kmask = _k3_inputs(rng, 40, 5, k, 64, metric, 0.05, (0, 3))
    monkeypatch.setattr(pdist.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    ref = np.asarray(pdist.min_group_distances_pallas(
        jnp.asarray(feats), jnp.asarray(cents), jnp.asarray(kmask), metric))
    f, c, m = torch.from_numpy(feats), torch.from_numpy(cents), torch.from_numpy(kmask)
    got, _ = _k3_schedule(f, c, m, metric)
    assert np.isinf(ref[:, 0]).all() and np.isinf(ref[:, 3]).all()
    _close(got.numpy(), ref, metric)
    _close(tdist.min_group_distances(f, c, m, metric).numpy(), ref, metric)


@pytest.mark.parametrize("tile", ["Narrow", "Wide"])
def test_k3_plan_matches_kernel_tiles(tile):
    """ood/distance.py's plan (rows, columns, chunk, ksplit) is the tile
    csrc/min_group_distance.cu compiles: Cfg<BM, BN, TM, TN, WC, KSPLIT,
    GR_MAX, CHUNK, STAGES, MIN_BLOCKS>."""
    src = (Path(tdist.__file__).parents[1] / "csrc" / "min_group_distance.cu").read_text()
    args = re.search(rf"using {tile} = Cfg<([^>]*)>;", src).group(1)
    bm, bn, _, _, _, ksplit, gr_max, chunk, _, _ = (int(v) for v in args.split(","))
    assert (bm, bn, chunk, ksplit) == (tdist.K3_NARROW if tile == "Narrow" else tdist.K3_WIDE)
    assert gr_max == (bn if tile == "Narrow" else 1)
