"""Port parity for centroid distances (ood/distance.py, kernel K3's plain
version; ood/methods.py DistanceOODMethod) against the JAX package, on the
CPU, for cosine, l2 and l1, with empty groups.

Tolerances: cosine and l1 within 1e-5. L2 gets atol 1e-3 where the
distance is near 0: it is sqrt(|x|^2 + |c|^2 - 2 x.c), and the f32
cancellation error of ~1e-7 in the squared distance becomes ~3e-4 after
the square root of a value near zero."""

import functools

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmethods.DistanceOODMethod.from_name("L2_cl_stride", cluster_method="KMeans_10")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmethods.DistanceOODMethod.from_name("Umap")
