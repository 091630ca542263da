"""The NumPy modules the port re-homes from the JAX package (core/config.py,
eval/owod_protocol.py, ood/thresholds.py, ood/matching.py) give the JAX
package's results on the same inputs: equal, not within a tolerance, since
the code is the same."""

import numpy as np
import pytest

from ood_in_object_detection_tpu.core import config as jconfig
from ood_in_object_detection_tpu.eval import owod_protocol as jowod
from ood_in_object_detection_tpu.ood import matching as jmatching
from ood_in_object_detection_tpu.ood import thresholds as jthr
from ood_in_object_detection_torch.core import config as tconfig
from ood_in_object_detection_torch.eval import owod_protocol as towod
from ood_in_object_detection_torch.ood import matching as tmatching
from ood_in_object_detection_torch.ood import thresholds as tthr


def test_config_defaults_match_jax():
    assert (tconfig.hyperparams_to_dict(tconfig.Hyperparams())
            == jconfig.hyperparams_to_dict(jconfig.Hyperparams()))


def _boxes(rng, n, img=200.0):
    xy = rng.uniform(0, img * 0.8, (n, 2))
    wh = rng.uniform(8, img * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _owod_records(seed, known_targets=True):
    """Predictions that jitter targets (so some match) plus strays; targets
    with known classes 0..2 and the unknown class."""
    rng = np.random.default_rng(seed)
    preds, tgts = [], []
    for i in range(6):
        m = int(rng.integers(1, 6))
        tb = _boxes(rng, m)
        tc = rng.choice([0, 1, 2, jowod.UNKNOWN_CLASS_INDEX], m).astype(np.float64)
        if not known_targets:
            tc[:] = jowod.UNKNOWN_CLASS_INDEX
        pb = np.concatenate([tb + rng.normal(0, 3, tb.shape), _boxes(rng, 3)])
        pc = np.concatenate([np.where(rng.uniform(size=m) < 0.7, tc,
                                      rng.choice([0, 1, 2], m)), rng.choice([0, 1, 2], 3)])
        preds.append(dict(img_name=f"im{i}", bboxes=pb, cls=pc.astype(np.float64),
                          conf=rng.uniform(0.1, 1.0, len(pb))))
        tgts.append(dict(img_name=f"im{i}", bboxes=tb, cls=tc))
    return preds, tgts


@pytest.mark.parametrize("seed,known_targets", [(0, True), (1, True), (2, False)])
def test_owod_metrics_match_jax(seed, known_targets):
    preds, tgts = _owod_records(seed, known_targets)
    names, known = ["a", "b", "c", "unknown"], [0, 1, 2]
    got = towod.compute_metrics(preds, tgts, names, known)
    assert got == jowod.compute_metrics(preds, tgts, names, known)
    assert len(got) == (7 if known_targets else 4)


@pytest.mark.parametrize("is_distance", [True, False])
def test_thresholds_match_jax(is_distance):
    rng = np.random.default_rng(3)
    sizes = [0, 4, 6, 30]
    per_class = [rng.normal(size=n).astype(np.float32) for n in sizes]
    per_stride = [[rng.normal(size=n).astype(np.float32) for n in sizes[:3]] for _ in range(4)]
    assert (tthr.generate_thresholds_per_class(per_class, 0.95, is_distance)
            == jthr.generate_thresholds_per_class(per_class, 0.95, is_distance))
    t = tthr.generate_thresholds_per_class_per_stride(per_stride, 0.9, is_distance)
    assert t == jthr.generate_thresholds_per_class_per_stride(per_stride, 0.9, is_distance)
    np.testing.assert_array_equal(tthr.pack_thresholds_per_class_per_stride(t),
                                  jthr.pack_thresholds_per_class_per_stride(t))


@pytest.mark.parametrize("n,m", [(9, 4), (3, 7), (0, 2)])
def test_matching_matches_jax(n, m):
    rng = np.random.default_rng(n * 10 + m)
    tb = _boxes(rng, m)
    tc = rng.integers(0, 2, m).astype(np.float64)
    pick = rng.integers(0, m, n)
    pb = tb[pick] + rng.normal(0, 4, (n, 4))
    pc = np.where(rng.uniform(size=n) < 0.8, tc[pick], 1 - tc[pick])
    got = tmatching.match_predictions_to_targets(pb, pc, tb, tc, 0.5)
    assert got == jmatching.match_predictions_to_targets(pb, pc, tb, tc, 0.5)
    if n:
        assert got, "no prediction matched: the case checks nothing"
