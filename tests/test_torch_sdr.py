"""The SDR methods (supervised dimensionality reduction: Umap, CosineIvis,
L1Ivis, L2Ivis; ood_in_object_detection_torch/ood/sdr.py) against the JAX
package's ood/sdr.py, on the CPU. The JAX embedder's initial weights come
from jax.random, which torch cannot reproduce, so the parity tests carry
the JAX parameters across (utils/weights.py:sdr_params_from_jax); full fits
from each package's own init are held by embedding quality instead."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ood_in_object_detection_tpu.cli.factory import build_ood_method as jbuild
from ood_in_object_detection_tpu.engine import PredictOutput as JOut
from ood_in_object_detection_tpu.ood import pipeline as jpipe
from ood_in_object_detection_tpu.ood import sdr as jsdr
from ood_in_object_detection_tpu.ood.distance import l2_normalize_rows as jnorm
from ood_in_object_detection_tpu.ops.nms import Detections as JDet
from ood_in_object_detection_torch.cli.factory import build_ood_method as tbuild
from ood_in_object_detection_torch.engine import PredictOutput as TOut
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ood import sdr as tsdr
from ood_in_object_detection_torch.ood.distance import NO_CLUSTER_DISTANCE
from ood_in_object_detection_torch.ood.methods import (SDR_METHODS, DistanceOODMethod,
                                                       LogitsOODMethod)
from ood_in_object_detection_torch.ops.nms import Detections as TDet
from ood_in_object_detection_torch.utils.weights import sdr_params_from_jax
from torch_threads import _two_threads  # noqa: F401 (autouse)

# both sides of the width switch at 512 samples (128-128 below, 500-500-2000 above)
NS = (200, 600)
# f32 MLP, loss and gradient on the same parameters: relative to each
# array's largest magnitude (matmuls sum in different orders)
FWD_RTOL = 1e-5
# 5 Adam steps: losses, and each parameter array's move in the Frobenius
# norm (optax and torch.optim round differently; where a gradient element
# is near eps, m / (sqrt(v) + eps) turns its rounding into up to 3.7e-4 of
# the largest move: single elements, 1 of 64000, so the norm)
ADAM_RTOL = 1e-4


def _jax_params(widths, seed=1):
    return [{k: np.array(v) for k, v in layer.items()}
            for layer in jsdr._mlp_init(jax.random.PRNGKey(seed), widths)]


def _data(n, d=24, nc=3, seed=0):
    rng = np.random.default_rng(seed + n)
    centres = rng.normal(size=(nc, d)) * 2.0
    y = rng.integers(0, nc, n)
    return (centres[y] + rng.normal(size=(n, d))).astype(np.float32), y


def _close(got, ref, rtol, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("n", NS)
def test_mlp_loss_and_gradient_match_jax(n):
    """Forward, triplet loss and its gradient on carried parameters equal
    JAX's _mlp_apply and value_and_grad(_triplet_loss) within FWD_RTOL. The
    last layer's bias cancels in za - zp and za - zn, so its gradient is
    rounding noise in both packages: held to the scale of that layer's
    weight gradient."""
    x, _ = _data(n)
    widths = tsdr.embedder_widths(n, x.shape[1], 32)
    assert widths[1:-1] == ([500, 500, 2000] if n > 512 else [128, 128])
    params = _jax_params(widths)
    emb = sdr_params_from_jax(params)
    flat = np.asarray(jnorm(jnp.asarray(x)))
    _close(emb(torch.as_tensor(flat)).detach().numpy(),
           jsdr._mlp_apply(params, jnp.asarray(flat)), FWD_RTOL, "forward")
    rng = np.random.default_rng(n)
    a, p, ng = (flat[rng.integers(0, n, 64)] for _ in range(3))
    lj, gj = jax.jit(jax.value_and_grad(jsdr._triplet_loss))(params,
                                                              *map(jnp.asarray, (a, p, ng)))
    lt = tsdr.triplet_loss(emb, *map(torch.as_tensor, (a, p, ng)))
    lt.backward()
    _close(lt.item(), float(lj), FWD_RTOL, "loss")
    for i, layer in enumerate(emb.layers):
        gw = np.asarray(gj[i]["w"]).T
        _close(layer.weight.grad.numpy(), gw, FWD_RTOL, f"w{i}")
        np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(gj[i]["b"]),
                                   rtol=FWD_RTOL, atol=FWD_RTOL * np.abs(gw).max(),
                                   err_msg=f"b{i}")


class _JaxRecorder:
    """Stands in for the jax module inside JAX's sdr.py: ``jax.jit(step)``
    becomes a step that records its triplets and leaves the parameters."""

    def __init__(self):
        self.batches = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        def step(params, opt, a, p, ne):
            self.batches.append(tuple(np.asarray(v) for v in (a, p, ne)))
            return params, opt, 0.0
        return step


@pytest.mark.parametrize("mode", ["ivis", "ivis_one_class", "umap"])
def test_triplet_sequence_matches_jax(mode, monkeypatch):
    """The port draws the JAX package's triplets, index for index, in both
    modes (and with one class, where no negative is drawn); in umap mode
    the cosine neighbours equal those JAX's code computes on its rows."""
    n, d = 300, 16
    x, y = _data(n, d)
    if mode == "ivis_one_class":
        y = np.zeros(n, int)
    labels = None if mode == "umap" else y
    rec = _JaxRecorder()
    monkeypatch.setattr(jsdr, "jax", rec)
    jsdr.fit_triplet_embedder(x, labels, out_dim=8, k_neighbors=15, epochs=3, batch=64, seed=7)
    jflat = np.asarray(jnorm(jnp.asarray(x)))
    row_of = {r.tobytes(): i for i, r in enumerate(jflat)}
    assert len(row_of) == n
    jidx = [np.array([[row_of[r.tobytes()] for r in part] for part in b]) for b in rec.batches]
    tflat = tsdr.normalized_rows(x)
    tidx = [np.stack(t) for t in tsdr.triplet_indices(tflat, labels, 15, 3, 64, 7)]
    assert len(tidx) == len(jidx) == 3 * (n // 64)
    for step, (t, j) in enumerate(zip(tidx, jidx)):
        np.testing.assert_array_equal(t, j, err_msg=f"step {step}")
    if mode == "umap":
        sims = jflat @ jflat.T
        np.fill_diagonal(sims, -np.inf)
        np.testing.assert_array_equal(tsdr.cosine_neighbours(tflat, 15),
                                      np.argpartition(-sims, 15, axis=1)[:, :15])
    if mode == "ivis_one_class":
        assert all((t[2] == t[0]).all() for t in tidx)


def test_umap_fit_of_a_single_sample():
    """A stride with one sample (the lazy fit takes every stride that has
    any): umap mode has no neighbour to draw, so the sample is its own
    positive and only the negatives are drawn (the JAX package raises,
    ValueError from rng.integers(0, 0)); ivis mode draws as JAX does."""
    x = np.ones((1, 6), np.float32)
    with pytest.raises(ValueError):
        jsdr.fit_triplet_embedder(x, None, out_dim=4, epochs=1, batch=8)
    draws = list(tsdr.triplet_indices(tsdr.normalized_rows(x), None, 15, 2, 8, 0))
    assert len(draws) == 2 and all((t == 0).all() for d in draws for t in d)
    emb = tsdr.fit_triplet_embedder(x, None, out_dim=4, epochs=2, batch=8, device="cpu")
    assert emb.fit_stats["steps"] == 2 and np.isfinite(emb.transform(x)).all()


@pytest.mark.parametrize("n", NS[1:])
def test_adam_steps_match_jax(n):
    """5 Adam steps from carried parameters on the same triplets: the losses,
    and each parameter array's move from the start (in the Frobenius norm),
    within ADAM_RTOL of optax.adam's. Adam's step is a ratio m / (sqrt(v) +
    eps) of sums rounded in different orders, so its rounding is relative to
    the step, not to the parameter. The last layer's bias (a gradient of
    rounding noise, see above) moves by up to lr a step in either package's
    own direction: held to that band."""
    x, y = _data(n)
    flat = tsdr.normalized_rows(x)
    params = _jax_params(tsdr.embedder_widths(n, x.shape[1], 32), seed=3)
    emb = sdr_params_from_jax(params)
    opt = tsdr.make_optimizer(emb, 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = optax.adam(1e-3)
    jopt = tx.init(jp)

    @jax.jit
    def jstep(params, opt, a, p, ne):  # JAX sdr.py:105-109
        loss, g = jax.value_and_grad(jsdr._triplet_loss)(params, a, p, ne)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(params, up), opt, loss

    jl, tl = [], []
    for ai, pi, ni in list(tsdr.triplet_indices(flat, y, 15, 1, 64, 5))[:5]:
        a, p, ng = flat[ai], flat[pi], flat[ni]
        jp, jopt, loss = jstep(jp, jopt, *map(jnp.asarray, (a, p, ng)))
        jl.append(float(loss))
        opt.zero_grad()
        lt = tsdr.triplet_loss(emb, *map(torch.as_tensor, (a, p, ng)))
        lt.backward()
        opt.step()
        tl.append(lt.item())
    _close(tl, jl, ADAM_RTOL, "losses")
    def move_err(p_t, p_j, p0):
        return np.linalg.norm(p_t - p_j) / np.linalg.norm(p_j - p0)

    last = len(emb.layers) - 1
    for i, layer in enumerate(emb.layers):
        w0, b0 = params[i]["w"], params[i]["b"]
        assert move_err(layer.weight.detach().numpy().T, np.asarray(jp[i]["w"]), w0) < ADAM_RTOL
        b_t, b_j = layer.bias.detach().numpy(), np.asarray(jp[i]["b"])
        if i < last:
            assert move_err(b_t, b_j, b0) < ADAM_RTOL, f"b{i}"
        else:
            assert np.abs(b_t - b_j).max() <= 2 * 1e-3 * 5 * (1 + ADAM_RTOL)


def test_train_triplet_embedder_runs_the_drawn_steps():
    """train_triplet_embedder takes one Adam step per drawn triplet batch
    (epochs x max(n // batch, 1)), returns their losses and records the
    step count, the widths and the host's sampling seconds."""
    x, y = _data(150, 8)
    flat = tsdr.normalized_rows(x)
    emb = tsdr.TripletEmbedder(tsdr.embedder_widths(150, 8, 4), seed=2)
    losses = tsdr.train_triplet_embedder(emb, flat, y, epochs=3, batch=64, seed=2)
    assert losses.shape == (6,) and torch.isfinite(losses).all()
    assert emb.fit_stats["steps"] == 6 and emb.fit_stats["widths"] == [8, 128, 128, 4]
    assert 0 < emb.fit_stats["sampling_s"] < emb.fit_stats["seconds"]
    assert len(tsdr.train_triplet_embedder(emb, flat, None, epochs=3, batch=64,
                                           max_steps=2)) == 2


def test_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsdr.fit_triplet_embedder(np.ones((4, 3), np.float32), None)


def test_supervised_embedder_separates_classes():
    """tests/test_sdr.py's bound on the port's own fit."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 0.3, (120, 24)) + 3
    b = rng.normal(0, 0.3, (120, 24)) - 3
    x = np.concatenate([a, b]).astype(np.float32)
    y = np.concatenate([np.zeros(120), np.ones(120)])
    z = tsdr.fit_triplet_embedder(x, y, out_dim=8, epochs=10, batch=64, device="cpu").transform(x)
    assert z.shape == (240, 8)
    inter = np.linalg.norm(z[:120].mean(0) - z[120:].mean(0))
    intra = (z[:120].std(0).mean() + z[120:].std(0).mean()) / 2
    assert inter > 2 * intra


def test_sdr_trustworthiness_and_separation_vs_pca():
    """tests/test_sdr_quality.py's bounds on the port's own fit: local
    structure within 0.1 of PCA's trustworthiness, class separation above
    PCA's."""
    from sklearn.decomposition import PCA
    from sklearn.manifold import trustworthiness

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(5, 64)) * 3.0
    x = np.concatenate([centers[c] + rng.normal(size=(60, 64)) * 0.8
                        for c in range(5)]).astype(np.float32)
    y = np.repeat(np.arange(5), 60)
    z = tsdr.fit_triplet_embedder(x, y, out_dim=16, epochs=30, batch=128, seed=0,
                                  device="cpu").transform(x)
    zp = PCA(n_components=16, random_state=0).fit_transform(x)

    def separation(z):
        cents = np.stack([z[y == c].mean(0) for c in range(5)])
        intra = np.mean([np.linalg.norm(z[y == c] - cents[c], axis=1).mean() for c in range(5)])
        d = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1)
        return d[np.triu_indices(5, 1)].mean() / max(intra, 1e-9)

    t_sdr = trustworthiness(x, z, n_neighbors=10)
    t_pca = trustworthiness(x, zp, n_neighbors=10)
    assert t_sdr > 0.75 and t_sdr > t_pca - 0.1, (t_sdr, t_pca)
    assert separation(z) > separation(zp)


NECK_CH = (16, 32, 64)


def _acts(seed, nc=3, strides=(0, 1, 2), n_per=40, step=0):
    """[class][stride] activations around a centre per (class, stride),
    class c with n_per + step * c rows (one size a stride keeps the JAX
    package's eager ops to one compile a shape)."""
    rng = np.random.default_rng(seed)
    acts = [[np.empty(0, np.float32) for _ in range(3)] for _ in range(nc)]
    for c in range(nc):
        for s in strides:
            centre = np.zeros(NECK_CH[s])
            centre[(3 * c + s) % NECK_CH[s]] = 2.0
            acts[c][s] = (centre + rng.normal(0, 0.5, (n_per + step * c, NECK_CH[s]))
                          ).astype(np.float32)
    return acts


def _carried_pair(name, strides=(0, 1, 2)):
    """The JAX method and the port's, each holding the same per-stride
    embedders (JAX parameters carried across), None for a stride left out."""
    jm, tm = jbuild(name), tbuild(name, device="cpu")
    jembs, tembs = [], []
    for s in range(3):
        if s not in strides:
            jembs.append(None)
            tembs.append(None)
            continue
        params = _jax_params([NECK_CH[s], 128, 128, 32], seed=10 + s)
        jembs.append(jsdr.TripletEmbedder(params=jax.tree_util.tree_map(jnp.asarray, params),
                                          in_dim=NECK_CH[s], out_dim=32))
        tembs.append(sdr_params_from_jax(params))
    jm.sdr_state["embedders"], tm.sdr_state["embedders"] = jembs, tembs
    return jm, tm


# carried embedders: clusters, scores and thresholds within FIT_RTOL of
# each array's scale (f32 MLPs and distances summed in different orders)
FIT_RTOL = 2e-5


@pytest.mark.parametrize("name", SDR_METHODS)
def test_fit_with_carried_embedders_matches_jax(name):
    """generate_clusters, compute_scores_from_activations and
    generate_thresholds of each SDR method, on the same embedders, equal
    JAX's within FIT_RTOL; the clusters live in the 32-wide space."""
    acts = _acts(1)
    jm, tm = _carried_pair(name)
    assert tm.metric == jm.metric
    jc, tc = jm.generate_clusters(acts), tm.generate_clusters(acts)
    for c in range(3):
        for s in range(3):
            assert tc[c][s].shape == (1, 32)
            _close(tc[c][s], jc[c][s], FIT_RTOL, f"centroid {c},{s}")
    js, ts = jm.compute_scores_from_activations(acts), tm.compute_scores_from_activations(acts)
    for c in range(3):
        for s in range(3):
            _close(ts[c][s], js[c][s], FIT_RTOL, f"scores {c},{s}")
    jt, tt = jm.generate_thresholds(js, 0.95), tm.generate_thresholds(ts, 0.95)
    _close(np.asarray(tt, np.float64), np.asarray(jt, np.float64), FIT_RTOL, "thresholds")


def test_generate_clusters_fits_each_stride_on_every_sample():
    """The lazy fit: one embedder per stride with samples, fitted on all of
    them (none gated by MIN_SAMPLES); a stride without samples keeps raw
    normalised rows; the transform raises before fitting."""
    acts = _acts(2, strides=(0, 1), n_per=2, step=7)  # 2, 9, 16 samples a class
    m = tbuild("L2Ivis", device="cpu")
    with pytest.raises(RuntimeError, match="before fitting"):
        m.transform(acts[0][0], 0, 0)
    m.generate_clusters(acts)
    embs = m.sdr_state["embedders"]
    assert embs[2] is None and m.sdr_state["kind"] == "ivis"
    assert [e.fit_stats["n"] for e in embs[:2]] == [27, 27]
    assert embs[0].in_dim == 16 and embs[1].in_dim == 32 and embs[0].out_dim == 32
    raw = np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32)
    np.testing.assert_allclose(m.transform(raw, 0, 2),
                               raw / np.linalg.norm(raw, axis=1, keepdims=True), rtol=1e-6)
    assert m.clusters[0][0].size == 0 and m.clusters[1][0].shape == (1, 32)  # MIN_SAMPLES 3
    assert tbuild("Umap", device="cpu").sdr_state["kind"] == "umap"


def test_a_copy_embeds_with_its_own_state():
    """The host transform and the box embedding both read the method's
    ``sdr_state``: a ``dataclasses.replace`` copy shares it (one lazy fit
    serves both), and a copy given a state of its own embeds with it on
    both paths."""
    import dataclasses

    m = tbuild("CosineIvis", device="cpu")
    twin = dataclasses.replace(m)
    m.generate_clusters(_acts(2, strides=(0,), n_per=10))
    assert twin.sdr_state["embedders"] is m.sdr_state["embedders"]
    other = dataclasses.replace(m)
    other.sdr_state = dict(m.sdr_state, embedders=[tsdr.TripletEmbedder([16, 128, 128, 32],
                                                                        seed=99), None, None])
    x = _acts(3, strides=(0,), n_per=6)[0][0]
    for meth in (m, other):
        emb = meth.sdr_state["embedders"][0]
        np.testing.assert_array_equal(meth.transform(x, 0, 0), emb.transform(x))
        flat = tsdr.l2_normalize_rows(torch.tensor(x))
        got = tsdr.sdr_embeddings(meth, flat, torch.zeros(len(x), dtype=torch.long))
        torch.testing.assert_close(got, emb(tsdr.l2_normalize_rows(flat)), rtol=0, atol=0)
    assert not np.allclose(m.transform(x, 0, 0), other.transform(x, 0, 0))


def _outputs(dtype, seed=5, b=2, n=16, nc=3):
    """The same synthetic post-NMS outputs for both packages: taps in
    ``dtype`` (bf16 values identical on both sides), every level present."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, nc, (b, n))
    level = rng.integers(0, 3, (b, n))
    valid = np.arange(n)[None] < np.array([[n - 3], [n - 5]])
    feats = np.zeros((b, n, 64), np.float32)
    for i in range(b):
        for j in range(n):
            ch = NECK_CH[level[i, j]]
            centre = np.zeros(ch)
            centre[(3 * cls[i, j] + level[i, j]) % ch] = 2.0
            scale = 0.5 if j % 3 else 1.5  # some boxes far from their class
            feats[i, j, :ch] = centre + rng.normal(0, scale, ch)
    feats[:, :, 60:] += 7.0  # channels past a box's stride width are masked out
    zeros = np.zeros((b, n), np.float32)
    jfeats = jnp.asarray(feats, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tfeats = torch.tensor(feats, dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    jdet = JDet(boxes=jnp.zeros((b, n, 4)), conf=jnp.asarray(zeros + 0.5),
                cls=jnp.asarray(cls, jnp.int32), anchor_idx=jnp.zeros((b, n), jnp.int32),
                valid=jnp.asarray(valid))
    tdet = TDet(boxes=torch.zeros(b, n, 4), conf=torch.tensor(zeros + 0.5),
                cls=torch.tensor(cls), anchor_idx=torch.zeros(b, n, dtype=torch.int64),
                valid=torch.tensor(valid))
    jout = JOut(jdet, jnp.zeros((b, n, nc)), jnp.asarray(level, jnp.int32), jdet.anchor_idx,
                jfeats, jfeats, ())
    tout = TOut(tdet, torch.zeros(b, n, nc), torch.tensor(level), tdet.anchor_idx,
                tfeats, tfeats, ())
    return jout, tout


# each box's distance from the same embedders, relative to itself: f32 taps
# FIT_RTOL; bf16 taps are normalised twice in bf16 before the f32 MLP, where
# one rounding step of a row's norm moves it by up to 2^-8 (4.0e-3 seen)
DIST_RTOL = {"f32": FIT_RTOL, "bf16": 1e-2}


@pytest.mark.parametrize("name,dtype", [(n, "f32") for n in SDR_METHODS]
                         + [("CosineIvis", "bf16"), ("L2Ivis", "bf16")])
def test_decisions_with_sdr_match_jax(name, dtype):
    """_decisions_for_method on a synthetic PredictOutput with an SDR
    method fitted on strides 0 and 1 only (stride 2 has no embedder: its
    boxes get zero embeddings and no cluster, so OoD): decisions equal and
    raw scores (negated distances) within DIST_RTOL of JAX's. Boxes whose
    distance lies within that tolerance of their threshold are excluded
    from the decision check, and there must be few of them."""
    jm, tm = _carried_pair(name, strides=(0, 1))
    acts = _acts(3, strides=(0, 1))
    for m in (jm, tm):
        m.generate_clusters(acts)
        m.generate_thresholds(m.compute_scores_from_activations(acts), 0.9)
    jout, tout = _outputs(dtype)
    jraw = np.asarray(jpipe._decisions_for_method(jm, jout, NECK_CH, raw=True), np.float64)
    traw = tpipe._decisions_for_method(tm, tout, NECK_CH, raw=True).numpy().astype(np.float64)
    rtol = DIST_RTOL[dtype]
    level2 = np.asarray(jout.stride_level) == 2
    assert level2.any() and (jraw[level2] == -NO_CLUSTER_DISTANCE).all()
    np.testing.assert_array_equal(traw[level2], jraw[level2])
    np.testing.assert_allclose(traw[~level2], jraw[~level2], rtol=rtol, err_msg="raw scores")
    jdec = np.asarray(jpipe._decisions_for_method(jm, jout, NECK_CH))
    tdec = tpipe._decisions_for_method(tm, tout, NECK_CH).numpy()
    thr = np.asarray(tm.packed_thresholds())[np.asarray(jout.det.cls),
                                             np.asarray(jout.stride_level)]
    clear = np.abs(-jraw - np.nan_to_num(thr, nan=np.inf)) > rtol * np.abs(jraw)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tdec[clear], jdec[clear])
    valid = np.asarray(jout.det.valid)
    assert (tdec[level2] == 0).all() and 0 < tdec[valid & ~level2].sum() < (valid & ~level2).sum()


def test_eul_rank_with_sdr_matches_jax():
    """EUL's rank with an SDR method: no device bank (the stride-0
    centroids live in the embedded space), and the host rank fn puts each
    proposal's feature through the method's transform, as JAX's does
    (pipeline.py:607-608): scores within FIT_RTOL for entropy and the gated
    'min' (its closest classes equal)."""
    from test_torch_unknown import _rank_hyp

    jm, tm = _carried_pair("CosineIvis")
    acts = _acts(4)
    jm.generate_clusters(acts)
    tm.generate_clusters(acts)
    assert tpipe._stride0_rank_bank(tm, NECK_CH[0], "cpu") is None
    p3 = np.random.default_rng(14).normal(size=(16, 16, NECK_CH[0])).astype(np.float32)
    props = np.array([[1.0, 1.0, 5.0, 7.0], [3.0, 2.0, 12.0, 9.0], [0.0, 0.0, 15.0, 15.0]],
                     np.float32)
    jfn, tfn = jpipe._make_rank_fn(jm, p3), tpipe._make_rank_fn(tm, torch.from_numpy(p3))
    for op, gated in (("entropy", False), ("min", True)):
        with _rank_hyp(op, gated):
            got, want = tfn(props), jfn(props)
        if gated:
            _close(got[0], want[0], FIT_RTOL)
            np.testing.assert_array_equal(got[1], want[1])
        else:
            _close(got, want, FIT_RTOL)


def test_fusion_with_sdr_members_from_the_factory():
    """The fusion_strategies grid's SDR rows build: each SDR member carries
    its ivis transform, each distance member its own cluster method."""
    f1 = tbuild("fusion-MSP-CosineIvis", "KMeans", device="cpu")
    assert isinstance(f1.methods[0], LogitsOODMethod) and f1.strategy == "and"
    assert f1.methods[1].sdr_state["kind"] == "ivis" and f1.methods[1].metric == "cosine"
    assert f1.methods[1].cluster_method == "KMeans"
    f2 = tbuild("fusion-CosineIvis-Cosine_cl_stride", "one-DBSCAN", fusion_strategy="or",
                device="cpu")
    a, b = f2.methods
    assert isinstance(a, DistanceOODMethod) and a.transform_fn is not None
    assert b.transform_fn is None and b.sdr_state is None
    assert (a.cluster_method, b.cluster_method, f2.strategy) == ("one", "DBSCAN", "or")


def test_predict_cli_refuses_an_sdr_method(tmp_path):
    """cli/predict.py rebuilds fitted methods from pkl artifacts, which hold
    no embedder: an SDR method is a ValueError, as in the JAX CLI."""
    import pickle

    from ood_in_object_detection_torch.cli import predict as tpredict

    thr = tmp_path / "t_thresholds.pkl"
    thr.write_bytes(pickle.dumps([[[0.5] * 3] * 2, [0.1, 0.2]]))
    clusters = tmp_path / "t_clusters.pkl"
    clusters.write_bytes(pickle.dumps([[[np.ones((1, 32), np.float32)] * 3] * 2, None]))
    args = tpredict.build_parser().parse_args(
        ["--source", "x", "--ood_method", "fusion-L2Ivis-MSP", "--ood_thresholds", str(thr),
         "--ood_clusters", str(clusters)])
    with pytest.raises(ValueError, match="L2Ivis uses a fitted SDR embedding"):
        tpredict.load_ood_method(args)
