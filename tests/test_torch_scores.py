"""Port parity for the logits OoD scores and methods (ood/scores.py,
ood/methods.py LogitsOODMethod, fuse_decisions) against the JAX package on
the CPU: scores within 1e-5, decisions equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_tpu.ood import scores as jscores
from ood_in_object_detection_torch.ood import methods as tmethods
from ood_in_object_detection_torch.ood import scores as tscores


def _logits(rng, n=40, nc=5):
    return rng.normal(0, 3, (n, nc)).astype(np.float32), rng.integers(0, nc, n)


@pytest.mark.parametrize("name,temper", [("MSP", 1.0), ("Energy", 1.0), ("Energy", 2.0),
                                         ("ODIN", 1000.0), ("Sigmoid", 1.0), ("NoMethod", 1.0)])
def test_scores_match_jax(name, temper):
    lg, cls = _logits(np.random.default_rng(0))
    ref = np.asarray(jscores.logits_score_fn(name, temper)(jnp.asarray(lg), jnp.asarray(cls, jnp.int32)))
    got = tscores.logits_score_fn(name, temper)(torch.from_numpy(lg), torch.from_numpy(cls)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,before_sigmoid", [("MSP", True), ("Energy", True), ("MSP", False)])
def test_logits_method_fit_and_decide_match_jax(name, before_sigmoid):
    rng = np.random.default_rng(1)
    nc = 3
    acts = [rng.normal(c, 2, (30, nc)).astype(np.float32) for c in range(nc - 1)]
    acts.append(np.empty((0, nc), np.float32))  # an unfit class
    jm = jmethods.LogitsOODMethod(name, use_values_before_sigmoid=before_sigmoid)
    tm = tmethods.LogitsOODMethod(name, use_values_before_sigmoid=before_sigmoid)
    for m in (jm, tm):
        m.generate_thresholds(m.compute_scores_from_activations(acts), 0.95)
    assert tm.thresholds[2] is None and jm.thresholds[2] is None
    np.testing.assert_allclose(tm.thresholds[:2], jm.thresholds[:2], rtol=1e-5)
    lg = rng.normal(0, 2, (2, 25, nc)).astype(np.float32)
    cls = rng.integers(0, nc, (2, 25))
    valid = rng.uniform(size=(2, 25)) > 0.2
    args_j = (jnp.asarray(lg), jnp.asarray(cls, jnp.int32), jnp.asarray(valid))
    args_t = (torch.from_numpy(lg), torch.from_numpy(cls), torch.from_numpy(valid))
    np.testing.assert_array_equal(tm.decide(*args_t).numpy(), np.asarray(jm.decide(*args_j)))
    np.testing.assert_allclose(tm.indness(*args_t).numpy(), np.asarray(jm.indness(*args_j)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("strategy", ["and", "or", "score", "vote"])
def test_fuse_decisions_match_jax(strategy):
    rng = np.random.default_rng(2)
    ds = [rng.integers(0, 2, (2, 9)).astype(np.int32) for _ in range(3)]
    ref = np.asarray(jmethods.fuse_decisions(strategy, *map(jnp.asarray, ds)))
    got = tmethods.fuse_decisions(strategy, *map(torch.from_numpy, ds)).numpy()
    np.testing.assert_array_equal(got, ref)
