"""Enhanced unknown localization (EUL) of the port against the JAX package,
on the CPU, with inputs made from a numpy seed and fed to both.

- The torch front end (ood/unknown_device.py) against JAX's
  ``eul_frontend`` / ``eul_frontend_masks``: saliency and thresholds within
  2e-6 of the saliency's largest magnitude (f32 sums in another order),
  masks equal.
- The batched rank (``rank_reduce_batched``: K2 and K3's plain versions
  here) against JAX's ``_rank_reduce_device_batched``: scores within
  rtol 1e-5, atol 1e-6; closest class ids equal.
- ``distances_to_all_class_centroids_stride0`` against JAX's: 1e-5.
- The NumPy/scipy copies of ood/unknown.py against the originals: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.core.config import CUSTOM_HYP as JHYP
from ood_in_object_detection_tpu.core.config import UnkEnhancementParams as JUnk
from ood_in_object_detection_tpu.ood import distance as jdist
from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_tpu.ood import pipeline as jpipe
from ood_in_object_detection_tpu.ood import unknown as junk
from ood_in_object_detection_tpu.ood import unknown_device as jdev
from ood_in_object_detection_torch.core.config import CUSTOM_HYP as THYP
from ood_in_object_detection_torch.core.config import UnkEnhancementParams as TUnk
from ood_in_object_detection_torch.ood import distance as tdist
from ood_in_object_detection_torch.ood import methods as tmethods
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ood import unknown as tunk
from ood_in_object_detection_torch.ood import unknown_device as tdev
from torch_threads import _two_threads  # noqa: F401 (autouse)

SUMMARIZERS = sorted(tdev.DEVICE_SUMMARIZERS)
FE_TOL = 2e-6  # of the saliency's largest magnitude
RANK_OPS = ("min", "mean", "max", "sum", "geometric_mean", "entropy")


def _blob_maps(seed, b=2, h=12, w=16, c=32, dyadic=False):
    """Noise maps with a brighter block per image, so thresholds separate
    regions. ``dyadic``: values in multiples of 1/8 below 8 in magnitude."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    for i in range(b):
        y, x = rng.integers(1, h - 5), rng.integers(1, w - 6)
        f[i, y : y + 4, x : x + 5] += rng.uniform(1.0, 3.0)
    return np.clip(np.round(f * 8) / 8, -7.875, 7.875) if dyadic else f


def _jax_masks(packed, w):
    return np.unpackbits(np.asarray(packed), axis=-1)[..., :w].astype(bool)


def _same_thresholds(t, j, scale):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    np.testing.assert_allclose(t[np.isfinite(t)], j[np.isfinite(j)], rtol=0, atol=FE_TOL * scale)


@pytest.mark.parametrize("summarizer", SUMMARIZERS)
def test_summarizers_match_jax(summarizer):
    """Saliency of generic f32 maps, masked to the crop: within FE_TOL of
    its largest magnitude (sums in another order)."""
    f = _blob_maps(len(summarizer))
    pads = np.array([[1, 2], [0, 0]], np.int32)
    tp = torch.from_numpy(pads).long()
    mask = tdev._grid_mask(tp, *f.shape[1:3])
    want = np.asarray(jdev._summarize(f, jdev._grid_mask(pads, *f.shape[1:3]), summarizer))
    got = tdev._summarize(torch.from_numpy(f), mask, summarizer).numpy()
    crop = mask.numpy()
    np.testing.assert_allclose(got[crop], want[crop], rtol=0,
                               atol=FE_TOL * np.abs(want[crop]).max())


@pytest.mark.parametrize("pads", [[[0, 0], [0, 0]], [[2, 2], [6, 2]]], ids=["pad0", "letterbox"])
@pytest.mark.parametrize("method", ["recursive_otsu", "quantile"])
@pytest.mark.parametrize("summarizer", SUMMARIZERS)
def test_frontend_matches_jax(summarizer, method, pads):
    """The whole front end, masks equal. The map's values are multiples of
    1/8 and each crop holds a power-of-two count of cells (16 x 16 and
    16 x 8 of 20 x 20; 16 x 16 at pad 0), so the means and sums are exact in
    f32 in both packages (std's sum of squares and root stay within a bit
    or two): a saliency some bits apart can move a cell across a histogram
    edge and an Otsu threshold by a bin."""
    hw = 16 if pads[0][0] == 0 else 20
    f = _blob_maps(len(summarizer) + len(method), h=hw, w=hw, dyadic=True)
    pads = np.asarray(pads, np.int32)
    kw = dict(summarizer=summarizer, method=method, num_thresholds=3)
    jsal, jthr = map(np.asarray, jdev.eul_frontend(f, pads, **kw))
    tsal, tthr = tdev.eul_frontend(torch.from_numpy(f), torch.from_numpy(pads).long(), **kw)
    crop = tdev._grid_mask(torch.from_numpy(pads).long(), hw, hw).numpy()
    scale = np.abs(jsal[crop]).max()
    np.testing.assert_allclose(tsal.numpy()[crop], jsal[crop], rtol=0, atol=FE_TOL * scale)
    _same_thresholds(tthr.numpy(), jthr, scale)
    assert np.isfinite(jthr).sum() >= 4, "the case thresholds nothing"

    jp, jt = jdev.eul_frontend_masks(f, pads, **kw)
    tm, tt = tdev.eul_frontend_masks(torch.from_numpy(f), torch.from_numpy(pads).long(), **kw)
    _same_thresholds(tt.numpy(), np.asarray(jt), scale)
    assert tm.dtype == torch.bool and tm.any()
    np.testing.assert_array_equal(tm.numpy(), _jax_masks(jp, hw))


def test_frontend_bf16_map_is_upcast():
    """A bf16 map's saliency is the f32 saliency of the same (bf16) values."""
    f = torch.from_numpy(_blob_maps(3)).to(torch.bfloat16)
    pads = torch.zeros((2, 2), dtype=torch.long)
    kw = dict(summarizer="mean_absolute_deviation_of_ftmaps", method="recursive_otsu",
              num_thresholds=3)
    s16, t16 = tdev.eul_frontend(f, pads, **kw)
    s32, t32 = tdev.eul_frontend(f.float(), pads, **kw)
    assert s16.dtype == torch.float32
    assert torch.equal(s16, s32) and torch.equal(t16, t32)


def _hyp(cls, **kw):
    h = cls()
    for k, v in kw.items():
        setattr(h, k, v)
    return h


@pytest.mark.parametrize("num_thresholds,trick", [(3, False), (4, True), (4, False)],
                         ids=["3thr", "otsu_trick", "4thr"])
def test_frontend_batched_matches_jax(num_thresholds, trick):
    """Per image (cropped masks, thresholds) through eul_frontend_batched,
    with letterbox pads of 2 x 2 and 6 x 2 cells (exact saliency, as in
    test_frontend_matches_jax)."""
    f = _blob_maps(11, b=2, h=20, w=20, c=24, dyadic=True)
    ratio_pads = [((1.0, 1.0), (16.0, 16.0)), ((1.0, 1.0), (48.0, 16.0))]
    kw = dict(NUM_THRESHOLDS=num_thresholds, OTSU_RECURSIVE_TRICK_FOR_4_THRS=trick)
    got = tunk.eul_frontend_batched(torch.from_numpy(f), ratio_pads, _hyp(TUnk, **kw))
    want = junk.eul_frontend_batched(f, ratio_pads, _hyp(JUnk, **kw))
    assert len(got) == len(want) == 2
    for (tm, tts), (jm, jts) in zip(got, want):
        assert len(tts) == len(jts) > 0
        np.testing.assert_allclose(tts, jts, rtol=1e-5, atol=1e-6)
        assert tm.shape == jm.shape
        np.testing.assert_array_equal(tm, jm)
    assert got[0][0].shape[1:] == (16, 16) and got[1][0].shape[1:] == (16, 8)


def test_frontend_constant_map():
    """Zero ptp: no thresholds at any node, masks all False, nothing kept."""
    f = np.ones((2, 8, 8, 4), np.float32)
    pads = np.zeros((2, 2), np.int32)
    for method in ("recursive_otsu", "quantile"):
        kw = dict(summarizer="sum_of_ftmaps", method=method, num_thresholds=3)
        jp, jt = jdev.eul_frontend_masks(f, pads, **kw)
        tm, tt = tdev.eul_frontend_masks(torch.from_numpy(f), torch.from_numpy(pads).long(), **kw)
        jt = np.asarray(jt)
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tm.numpy(), _jax_masks(jp, 8))
        if method == "recursive_otsu":
            assert not np.isfinite(jt).any() and not tm.any()
    got = tunk.eul_frontend_batched(torch.from_numpy(f), [((1.0, 1.0), (0.0, 0.0))] * 2)
    assert all(m.shape[0] == 0 and ts == [] for m, ts in got)


def test_frontend_without_device_path_is_none():
    """multithreshold_otsu and fast_otsu take the host functions."""
    f = torch.zeros((1, 8, 8, 4))
    for m in ("multithreshold_otsu", "fast_otsu", "k_means"):
        assert tunk.eul_frontend_batched(f, [((1.0, 1.0), (0.0, 0.0))],
                                         _hyp(TUnk, THRESHOLDING_METHOD=m)) is None


def _bank_methods(name, nc, c, seed, empty=(2,)):
    """The same stride-0 clusters (1-3 centroids a class, none for ``empty``)
    in both packages' methods."""
    rng = np.random.default_rng(seed)
    clusters = []
    for k in range(nc):
        row = [np.empty(0)] * 3
        if k not in empty:
            row[0] = rng.normal(size=(1 + k % 3, c)).astype(np.float32)
        clusters.append(row)
    jm = jmethods.DistanceOODMethod.from_name(name)
    tm = tmethods.DistanceOODMethod.from_name(name)
    jm.clusters, tm.clusters = clusters, clusters
    return jm, tm


@pytest.mark.parametrize("metric_name", ["Cosine_cl_stride", "L2_cl_stride", "L1_cl_stride"])
def test_distances_to_all_class_centroids_stride0_matches_jax(metric_name):
    jm, tm = _bank_methods(metric_name, 5, 16, 4)
    jbank, _ = jpipe._stride0_rank_bank(jm, 16)
    tbank, rows = tpipe._stride0_rank_bank(tm, 16, "cpu")
    feats = np.random.default_rng(5).normal(size=(23, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    want = np.asarray(jdist.distances_to_all_class_centroids_stride0(feats, jbank, jm.metric))
    got = tdist.distances_to_all_class_centroids_stride0(torch.from_numpy(feats), tbank,
                                                         tm.metric).numpy()
    assert got.shape == (23, 5)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[:, 2]).all() and np.isfinite(got[:, [0, 1, 3, 4]]).all()
    np.testing.assert_allclose(got[:, rows.numpy()], want[:, rows.numpy()], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric_name", ["Cosine_cl_stride", "L2_cl_stride"])
@pytest.mark.parametrize("op,gated", [(op, False) for op in RANK_OPS] + [("min", True)])
def test_rank_reduce_matches_jax(op, gated, metric_name):
    """The batched rank of padded proposals (B, n, 4) on P3, every rank op
    and the gated 'min' (closest class ids)."""
    b, h, w, c = 3, 16, 16, 8
    p3 = np.random.default_rng(6).normal(size=(b, h, w, c)).astype(np.float32)
    jm, tm = _bank_methods(metric_name, 4, c, 7)
    jbank, jrows = jpipe._stride0_rank_bank(jm, c)
    tbank, trows = tpipe._stride0_rank_bank(tm, c, "cpu")
    np.testing.assert_array_equal(trows.numpy(), jrows)
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 12, (b, 5, 2))
    props = np.concatenate([xy, xy + rng.uniform(1, 6, (b, 5, 2))], -1).astype(np.float32)
    import jax.numpy as jnp

    want = jpipe._rank_reduce_device_batched(
        jnp.asarray(p3), jnp.asarray(props), jbank.centroids, jbank.count, jnp.asarray(jrows),
        metric=jm.metric, op=op, gated=gated)
    got = tpipe.rank_reduce_batched(torch.from_numpy(p3), torch.from_numpy(props), tbank,
                                    trows, tm.metric, op, gated)
    if gated:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert len(np.unique(got[1].numpy())) > 1, "every proposal is closest to one class"
    else:
        assert got.shape == (b, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_rank_reduce_bf16_map_matches_f32():
    """A bf16 P3 is ranked on its f32 upcast (K2's f32 route)."""
    p3 = torch.from_numpy(_blob_maps(9, b=2, h=16, w=16, c=8)).to(torch.bfloat16)
    _, tm = _bank_methods("Cosine_cl_stride", 3, 8, 1, empty=())
    bank, rows = tpipe._stride0_rank_bank(tm, 8, "cpu")
    props = torch.tensor([[[1.0, 2.0, 7.0, 9.0], [0.0, 0.0, 15.0, 15.0]]] * 2)
    got = tpipe.rank_reduce_batched(p3, props, bank, rows, "cosine", "entropy", False)
    want = tpipe.rank_reduce_batched(p3.float(), props, bank, rows, "cosine", "entropy", False)
    assert torch.equal(got, want)


def test_stride0_rank_bank_gates_like_jax():
    for clusters, ch in (([[np.empty(0)] * 3], 8),
                         ([[np.ones((2, 4), np.float32), np.empty(0), np.empty(0)]], 8),
                         ([[np.ones((2, 4), np.float32), np.empty(0), np.empty(0)]], 4)):
        jm = jmethods.DistanceOODMethod.from_name("L2_cl_stride")
        tm = tmethods.DistanceOODMethod.from_name("L2_cl_stride")
        jm.clusters = tm.clusters = clusters
        assert (tpipe._stride0_rank_bank(tm, ch, "cpu") is None) == \
            (jpipe._stride0_rank_bank(jm, ch) is None)


def test_host_rank_fn_matches_jax():
    """The per-image rank fn (for a refused bank) against JAX's host rank fn,
    with the ops switched on both packages' CUSTOM_HYP."""
    p3 = np.random.default_rng(12).normal(size=(16, 16, 8)).astype(np.float32)
    jm, tm = _bank_methods("Cosine_cl_stride", 3, 8, 2, empty=(1,))
    props = np.array([[1.0, 1.0, 5.0, 7.0], [3.0, 2.0, 12.0, 9.0], [0.0, 0.0, 15.0, 15.0]],
                     np.float32)
    jfn, tfn = jpipe._make_rank_fn(jm, p3), tpipe._make_rank_fn(tm, torch.from_numpy(p3))
    for op, gated in (("entropy", False), ("mean", False), ("min", True)):
        with _rank_hyp(op, gated):
            got, want = tfn(props), jfn(props)
        if gated:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(got[1], want[1])
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jm.clusters = tm.clusters = [[np.empty(0)] * 3]
    np.testing.assert_array_equal(tpipe._make_rank_fn(tm, torch.from_numpy(p3))(props),
                                  jpipe._make_rank_fn(jm, p3)(props))


class _both_hyp:
    """Set unk fields (and unk.rank fields) on both packages' CUSTOM_HYP,
    restored after."""

    def __init__(self, rank=None, **unk):
        self.rank, self.unk = rank or {}, unk

    def __enter__(self):
        self.old = (JHYP.unk, THYP.unk)
        for hyp in (JHYP, THYP):
            hyp.unk = dataclasses.replace(
                hyp.unk, rank=dataclasses.replace(hyp.unk.rank, **self.rank), **self.unk)

    def __exit__(self, *exc):
        JHYP.unk, THYP.unk = self.old


def _rank_hyp(op, gated=False):
    return _both_hyp(rank=dict(RANK_BOXES_OPERATION=op, USE_OOD_THR_TO_REMOVE_PROPS=gated))


@pytest.mark.parametrize("op", ["entropy", "min"])
def test_generate_unk_prop_thr_matches_jax(op):
    jm, tm = _bank_methods("Cosine_cl_stride", 4, 12, 3, empty=(3,))
    rng = np.random.default_rng(13)
    acts = [[rng.normal(size=(n, 12)).astype(np.float32), np.empty(0), np.empty(0)]
            for n in (9, 0, 14, 5)]
    got, want = tm.generate_unk_prop_thr(acts, 0.95, op), jm.generate_unk_prop_thr(acts, 0.95, op)
    assert got is not None and tm.unk_prop_thr == got
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tm.clusters = [[np.empty(0)] * 3] * 4
    assert tm.generate_unk_prop_thr(acts, 0.95) is None and tm.unk_prop_thr is None


# --- the NumPy/scipy copies against the originals --------------------------


@pytest.mark.parametrize("name", sorted(junk.SUMMARIZERS))
def test_host_summarizers_equal_jax(name):
    f = _blob_maps(1, b=1)[0]
    np.testing.assert_array_equal(tunk.select_summarizer(name)(f),
                                  junk.select_summarizer(name)(f))


@pytest.mark.parametrize("method", ["recursive_otsu", "multithreshold_otsu", "quantile",
                                    "fast_otsu"])
@pytest.mark.parametrize("num_thresholds", [3, 4])
def test_host_thresholders_equal_jax(method, num_thresholds):
    sal = junk.mean_absolute_deviation_of_ftmaps(_blob_maps(2, b=1, h=20, w=20)[0])
    with _both_hyp(OTSU_RECURSIVE_TRICK_FOR_4_THRS=True):
        got = tunk.select_thresholding(method, num_thresholds)(sal)
        want = junk.select_thresholding(method, num_thresholds)(sal)
    assert got == want and len(got) > 0
    assert tunk.threshold_otsu(sal) == junk.threshold_otsu(sal)


@pytest.mark.parametrize("num_thresholds", [2, 3, 4])
def test_k_means_thresholding_matches_jax(num_thresholds):
    """The k_means thresholder on the port's k-means against the JAX
    package's on scikit-learn's, on a saliency map and through
    select_thresholding: the thresholds within 1e-6."""
    sal = junk.mean_absolute_deviation_of_ftmaps(_blob_maps(6, b=1, h=24, w=20)[0])
    got = tunk.k_means_thresholding(sal, num_thresholds)
    want = junk.k_means_thresholding(sal, num_thresholds)
    assert len(got) == len(want) == num_thresholds - 1
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(tunk.select_thresholding("k_means", num_thresholds)(sal),
                               junk.select_thresholding("k_means", num_thresholds)(sal),
                               rtol=1e-6)


def test_boxes_nms_rank_equal_jax():
    sal = junk.sum_of_ftmaps(_blob_maps(4, b=1, h=20, w=24)[0])
    thr = junk.recursive_otsu(sal, 4)
    got, want = tunk.extract_boxes_from_saliency(sal, thr), junk.extract_boxes_from_saliency(sal, thr)
    assert [len(b) for b in got] == [len(b) for b in want] and sum(map(len, got)) > 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    boxes = np.concatenate(got)
    scores = np.random.default_rng(1).uniform(size=len(boxes))
    np.testing.assert_array_equal(tunk.greedy_nms_np(boxes, scores, 0.5),
                                  junk.greedy_nms_np(boxes, scores, 0.5))
    mat = np.random.default_rng(2).uniform(0.1, 2.0, (4, 9))
    for op in RANK_OPS:
        np.testing.assert_array_equal(tunk.rank_distances(mat, op), junk.rank_distances(mat, op))


@pytest.mark.parametrize("case", ["default", "simple_heuristics", "no_heuristics", "gated",
                                  "unk_thr", "greater_rank_no_nms"])
def test_proposals_for_image_equal_jax(case):
    """unknown_proposals_for_image on the host path (and the candidate /
    finish halves) with a rank fn, each gate of select_unk_proposals."""
    f = _blob_maps(5, b=1, h=20, w=20, c=16)[0]
    ratio_pad = ((1.0, 1.0), (16.0, 8.0))
    preds = np.array([[40.0, 30.0, 90.0, 80.0], [8.0, 16.0, 40.0, 60.0]])
    kw = {"default": {}, "no_heuristics": dict(USE_HEURISTICS=False),
          "simple_heuristics": dict(USE_SIMPLE_HEURISTICS=True, USE_FIRST_THRESHOLD=False,
                                    MIN_BOX_SIZE=2, MAX_IOU_WITH_PREDS=0.5,
                                    MAX_INTERSECTION_W_PREDS=0.5),
          "gated": {}, "unk_thr": {}, "greater_rank_no_nms": {}}[case]
    rank_kw = {"gated": dict(USE_OOD_THR_TO_REMOVE_PROPS=True),
               "greater_rank_no_nms": dict(GET_BOXES_WITH_GREATER_RANK=True, NMS=0.0),
               "unk_thr": dict(USE_UNK_PROPOSALS_THR=True)}.get(case, {})
    out = []
    for mod, cls in ((tunk, TUnk), (junk, JUnk)):
        hyp = _hyp(cls, **kw)
        for k, v in rank_kw.items():
            setattr(hyp.rank, k, v)

        def rank_fn(props):
            s = np.sin(props.sum(1))
            return (s, (props[:, 0] > 5).astype(int)) if case == "gated" else s

        out.append(mod.unknown_proposals_for_image(
            f, ratio_pad, preds, rank_score_fn=rank_fn, hyp=hyp, unk_prop_thr=0.3,
            class_thresholds=np.array([0.2, 0.5])))
    (tp, td, tr), (jp, jd, jr) = out
    assert len(jp) > 0
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(td, jd)
    assert (tr is None) == (jr is None)
    if tr is not None:
        np.testing.assert_array_equal(tr, jr)
