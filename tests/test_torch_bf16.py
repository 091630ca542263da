"""The port's --bf16 eval path against the JAX package's, on the CPU:
uint8 images -> YOLOv8n in bf16 (f32 parameters, bf16 compute and taps) ->
detect/NMS -> RoI taps -> MSP and Cosine_cl_stride -> extract -> fit ->
evaluate, on an on-disk dataset (96 px, nc=2) read through the port's data
modules, with the same weights in three detectors: the port in bf16, the
JAX package in bf16 and the port in f32.

bf16 rounding noise grows with depth in a random network: with identity
BatchNorm scales, calibrated maps differ between a bf16 and an f32 forward
by 29-52 % of their largest magnitude (tests/bf16_margin_search.py), and
between two bf16 forwards that sum in another order by as much (a one-ulp
difference from a sum order is amplified layer after layer), which no
decision survives. Two tests follow from that:

- test_layers_bf16_match_jax_layer_by_layer runs every layer of the port's
  bf16 model on the JAX bf16 model's own input to that layer, so nothing
  accumulates: it holds the rounding points themselves, to two bf16 ulps.
- The end-to-end tests use shared weights whose BatchNorm scales are set to
  BN_SCALE before the calibration, so that each Conv block leaves
  activations of that standard deviation, as a trained network's are well
  conditioned; the three forwards' confidences then agree to ~2e-3. The
  confidence thresholds sit in wide gaps of the fixture's confidence
  distribution. Random weights allow no margin above that spread (the best
  of 120 seeds offers 0.38 of it, tests/bf16_margin_search.py): on the OoD
  images, where detections and
  decisions are demanded equal, the smallest margin (1.66e-3) equals the
  spread (1.66e-3), and the fixture asserts margins of CONF_GAP, two bf16
  ulps of a logit near the thresholds. The InD images only feed the fit,
  whose thresholds the JAX package itself holds to a band. Detections are
  compared per image as sets of (anchor, class): two detections whose
  confidences sit within bf16 noise of each other may come out in either
  order, which changes nothing downstream."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.engine import Detector as JaxDetector
from ood_in_object_detection_tpu.models import build_model as jax_build_model
from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_tpu.ood import pipeline as jpipe
from ood_in_object_detection_torch.data import DetectionDataset, PaddedBatcher
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.models import build_model
from ood_in_object_detection_torch.ood import methods as tmethods
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ops import nms as tnms
from ood_in_object_detection_torch.ops.boxes import box_iou
from ood_in_object_detection_torch.ops.fused_detect import select_candidates
from test_torch_model import shared_weights
from test_torch_pipeline import _flat, _label_from_detections, _write_images

IMG, NC, IOU = 96, 2, 0.7
KNOWN, NAMES = [0, 1], ["c0", "c1", "unknown"]
N_IMAGES = 16  # 8 InD and 8 OoD
SEED, SPREAD, BN_SCALE, CONF_TRAIN, CONF_TEST = 1, 2.0, 0.2, 0.6753, 0.6871
# bf16-sized margins: a logit near 0.7 has a bf16 ulp of 2^-8, ~8e-4 in
# confidence; box IoUs move by ~1e-3 between the forwards
CONF_GAP, IOU_GAP, SCORE_GAP = 1.6e-3, 2e-2, 5e-3


def make_fixture(root, seed=SEED, spread=SPREAD, bn_scale=BN_SCALE):
    images = np.random.default_rng(seed).integers(0, 256, (N_IMAGES, IMG, IMG, 3),
                                                   dtype=np.uint8)
    ind_files = _write_images(root, "ind", images[:N_IMAGES // 2])
    ood_files = _write_images(root, "ood", images[N_IMAGES // 2:])
    calib = torch.from_numpy(images).float().permute(0, 3, 1, 2) * (1 / 255)
    jm, variables, tm = shared_weights("yolov8n", nc=NC, seed=seed, calib=calib, spread=spread,
                                       bn_scale=bn_scale)
    t16 = build_model("yolov8n", nc=NC, dtype=torch.bfloat16)
    t16.load_state_dict(tm.state_dict())
    t32 = Detector(model=tm, img_size=IMG)
    _label_from_detections(t32, ind_files, CONF_TRAIN)
    _label_from_detections(t32, ood_files, CONF_TEST, unknown_every=3)
    names = [f"c{k}" for k in range(6)]
    batches = {}
    for split, files in (("ind", ind_files), ("ood", ood_files)):
        ds = DetectionDataset.from_image_list([str(f) for f in files], names, number_of_classes=NC)
        batches[split] = list(PaddedBatcher(ds, batch_size=4, img_size=IMG, max_gt=32,
                                            image_dtype="uint8"))
    j16 = JaxDetector(model=jax_build_model("yolov8n", nc=NC, dtype=jnp.bfloat16),
                      variables=variables, img_size=IMG)
    return dict(root=root, t32=t32, t16=Detector(model=t16.eval(), img_size=IMG), j16=j16,
                batches=batches)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_fixture(tmp_path_factory.mktemp("torch_bf16"))


def _conf_noise(fx, images, conf_thres) -> float:
    """The largest confidence difference, per anchor kept by all three
    detectors, between the port's bf16 or the JAX bf16 run and the f32 run."""
    per = [_by_anchor(d.predict(images, conf_thres=conf_thres), "conf")
           for d in (fx["t32"], fx["t16"], fx["j16"])]
    noise = 0.0
    for i in range(len(images)):
        for other in per[1:]:
            noise = max([noise] + [abs(other[i][a] - c) for a, c in per[0][i].items()
                                   if a in other[i]])
    return noise


def _by_anchor(out, field="cls", values=None):
    """Per image, {anchor index: class (or ``field`` of the detections, or
    ``values``)} of the valid detections."""
    get = {"cls": out.det.cls, "conf": out.det.conf}.get(field) if values is None else values
    rows = []
    for i in range(len(np.asarray(out.det.valid))):
        v = np.asarray(out.det.valid[i])
        rows.append({int(a): float(x) for a, x in zip(np.asarray(out.anchor_idx[i])[v],
                                                       np.asarray(get[i])[v])})
    return rows


def non_degeneracy(fx, split: str, conf_thres: float) -> dict:
    """The smallest margins of one split, measured on the f32 port, and the
    largest confidence difference between the three forwards there."""
    m = dict(conf_to_thr=np.inf, pair_gap=np.inf, iou_to_thr=np.inf, conf_noise=0.0,
             candidates=0)
    for batch in fx["batches"][split]:
        x = torch.from_numpy(batch["images"]).float().permute(0, 3, 1, 2) * (1.0 / 255.0)
        with torch.no_grad():
            raw, _ = fx["t32"].model(x)
        cand = select_candidates(raw, NC, conf_thres, pre_nms_k=1024)
        conf_all = torch.sigmoid(torch.cat([r[:, 64:].amax(1).flatten(1) for r in raw], 1))
        m["conf_to_thr"] = min(m["conf_to_thr"], float((conf_all - conf_thres).abs().min()))
        m["conf_noise"] = max(m["conf_noise"], _conf_noise(fx, batch["images"], conf_thres))
        for i in range(len(x)):
            shifted, valid = tnms.nms_inputs(cand.boxes[i], cand.conf[i], cand.cls[i], conf_thres)
            m["candidates"] += int(valid.sum())
            if valid.sum() < 2:
                continue
            iou = box_iou(shifted[valid], shifted[valid])
            m["iou_to_thr"] = min(m["iou_to_thr"], float((iou - IOU).abs().min()))
            conf = cand.conf[i][valid]
            near = (iou > IOU - 0.2) & ~torch.eye(len(conf), dtype=torch.bool)
            if near.any():  # pairs whose order NMS reads
                m["pair_gap"] = min(m["pair_gap"],
                                    float((conf[:, None] - conf[None, :]).abs()[near].min()))
    return m


def test_fixture_is_non_degenerate_at_bf16_margin(fx):
    """On the OoD images, where detections and decisions are demanded equal,
    no confidence within CONF_GAP of its threshold, no pair of overlapping
    candidates within CONF_GAP of a tie, no IoU within IOU_GAP of the NMS
    threshold; the three forwards' confidences within 2e-3."""
    m = non_degeneracy(fx, "ood", CONF_TEST)
    assert m["candidates"] > 10, m
    assert m["conf_to_thr"] > CONF_GAP, f"a confidence sits at its threshold: {m}"
    assert m["pair_gap"] > CONF_GAP, f"two overlapping candidates nearly tie: {m}"
    assert m["iou_to_thr"] > IOU_GAP, f"an IoU sits at the NMS threshold: {m}"
    assert m["conf_noise"] < 2e-3, f"the forwards disagree beyond bf16 noise: {m}"
    assert non_degeneracy(fx, "ind", CONF_TRAIN)["candidates"] > 20
    for b in fx["batches"].values():
        assert sum(batch["gt_mask"].sum() for batch in b) > 0


def test_layers_bf16_match_jax_layer_by_layer(fx):
    """Each layer of the port's bf16 model run on the JAX bf16 model's own
    input to that layer (stem unfolded on both sides), so that nothing
    accumulates across layers: the rounding points are the same, and a
    layer's output differs only where a sum taken in another order rounds to
    the other side of a bf16 value, then runs through the layer's few convs:
    within 2^-6 of the layer's largest magnitude (measured: 8.8e-3 at most,
    0 on 10 of the 17 layers)."""
    jm = fx["j16"].model.clone(folded_stem=False)
    x = jnp.asarray(fx["batches"]["ind"][0]["images"], jnp.float32) / 255.0
    _, state = jm.apply(fx["j16"].variables, x, train=False, capture_intermediates=True,
                        mutable=["intermediates"])
    inter = state["intermediates"]

    def t(a):  # JAX NHWC bf16 -> port NCHW bf16, exactly
        return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).to(torch.bfloat16)

    model = fx["t16"].model
    ys, errs = [], {}
    with torch.no_grad():
        for li, ((frm, _, mod, _), m) in enumerate(zip(model.spec, model.model)):
            if mod == "Detect":
                got = m([ys[i] for i in frm])
                want = inter["detect"]["__call__"][0]
            elif mod in ("Upsample", "Concat"):  # exact data movement on both sides
                ys.append(m([ys[-1] if i == -1 else ys[i] for i in frm] if mod == "Concat"
                            else ys[-1]))
                continue
            else:
                inp = t(x.astype(jnp.bfloat16)) if li == 0 else ys[-1] if frm == -1 else ys[frm]
                got = [m(inp)]
                want = [inter[f"l{li}_{mod}"]["__call__"][0]]
                assert want[0].dtype == jnp.bfloat16 and got[0].dtype == torch.bfloat16
                ys.append(t(want[0]))
            for g, w in zip(got, want):
                w = np.asarray(w, np.float32)
                errs[f"{li}_{mod}"] = max(errs.get(f"{li}_{mod}", 0.0), float(
                    np.abs(g.permute(0, 2, 3, 1).float().numpy() - w).max() / np.abs(w).max()))
    assert len(errs) == 17, sorted(errs)  # every layer but the 2 Upsample and 4 Concat
    assert max(errs.values()) <= 2.0 ** -6, errs


def _match(a, b):
    """Rows of detections a and b (PredictOutputs) keyed by image and anchor:
    -> (image, row in a, row in b) per detection both hold, after asserting
    that they hold the same (anchor, class) sets per image."""
    ca, cb = _by_anchor(a), _by_anchor(b)
    assert ca == cb, "the detection sets differ"
    rows = []
    for i, det in enumerate(ca):
        ra = {int(x): j for j, x in enumerate(np.asarray(a.anchor_idx[i]))}
        rb = {int(x): j for j, x in enumerate(np.asarray(b.anchor_idx[i]))}
        rows += [(i, ra[k], rb[k]) for k in det]
    return tuple(np.asarray(r) for r in zip(*rows))


def test_predict_bf16_matches_jax_bf16(fx):
    """Neck taps in bf16 in both packages (the JAX package pins the same,
    test_bf16_flag_reaches_jitted_step_dtype); equal detections (valid count,
    anchor and class per image) and levels; floats within bf16 tolerances:
    boxes 0.5 px, confidences 4e-3, logits 2e-2, taps 5e-2 of their scale
    (two bf16 forwards that sum in another order; measured 3.1e-2 on the
    taps)."""
    n = 0
    for batch in fx["batches"]["ood"]:
        t = fx["t16"].predict(batch["images"], conf_thres=CONF_TEST)
        j = fx["j16"].predict(batch["images"], conf_thres=CONF_TEST)
        assert all(f.dtype == torch.bfloat16 for f in t.neck)
        assert all(f.dtype == jnp.bfloat16 for f in j.neck)
        assert t.roi_feats.dtype == torch.bfloat16 and j.roi_feats.dtype == jnp.bfloat16
        assert t.det.boxes.dtype == torch.float32 and t.logits.dtype == torch.float32
        np.testing.assert_array_equal(t.det.valid.sum(1).numpy(), np.asarray(j.det.valid).sum(1))
        img, rt, rj = _match(t, j)
        n += len(img)
        np.testing.assert_array_equal(t.stride_level.numpy()[img, rt],
                                      np.asarray(j.stride_level)[img, rj])
        for a, b, tol in ((t.det.boxes, j.det.boxes, 0.5), (t.det.conf, j.det.conf, 4e-3),
                          (t.logits, j.logits, 2e-2)):
            np.testing.assert_allclose(a.numpy()[img, rt], np.asarray(b)[img, rj], atol=tol)
        for a, b in ((t.roi_feats, j.roi_feats), (t.exact_feats, j.exact_feats)):
            b = np.asarray(b, np.float32)[img, rj]
            np.testing.assert_allclose(a.float().numpy()[img, rt], b, atol=5e-2 * np.abs(b).max())
    assert n > 10


def _methods(name):
    if name == "MSP":
        return (jmethods.LogitsOODMethod("MSP"), tmethods.LogitsOODMethod("MSP"),
                tmethods.LogitsOODMethod("MSP"))
    return (jmethods.DistanceOODMethod.from_name(name),
            tmethods.DistanceOODMethod.from_name(name), tmethods.DistanceOODMethod.from_name(name))


@pytest.mark.parametrize("name", ["MSP", "Cosine_cl_stride"])
def test_extract_fit_evaluate_bf16(fx, name):
    """Per-box decisions equal across the port's bf16 run, the JAX
    package's bf16 run and the port's f32 run; bf16 thresholds within the
    JAX package's own bf16 band (rtol 0.1, atol 1e-4,
    tests/test_reference_cli_parity.py:470-472) of both others."""
    jm, tm, fm = _methods(name)
    ind, ood = fx["batches"]["ind"], fx["batches"]["ood"]
    for det, m in ((fx["j16"], jm), (fx["t16"], tm), (fx["t32"], fm)):
        pipe = jpipe if det is fx["j16"] else tpipe
        acts = pipe.extract_ind_activations(det, ind, m, conf_thr_train=CONF_TRAIN)
        flat = acts[id(m)] if name == "MSP" else [a for row in acts[id(m)] for a in row]
        assert sum(len(a) for a in flat) > 10, "no matched InD boxes: the fit would be empty"
        pipe.fit_ind_pipeline(m, acts, tpr=0.95)
    jt, tt, ft = _flat(jm.thresholds), _flat(tm.thresholds), _flat(fm.thresholds)
    assert np.isfinite(tt).sum() > 0
    for other in (jt, ft):
        np.testing.assert_array_equal(np.isnan(tt), np.isnan(other))
        np.testing.assert_allclose(tt, other, rtol=0.1, atol=1e-4)

    neck = fx["t16"].neck_channels()
    verdicts = []
    for batch in ood:
        outs = [d.predict(batch["images"], conf_thres=CONF_TEST) for d in
                (fx["j16"], fx["t16"], fx["t32"])]
        decs = [np.asarray(jpipe._decisions_for_method(jm, outs[0], neck)),
                tpipe._decisions_for_method(tm, outs[1], neck).numpy(),
                tpipe._decisions_for_method(fm, outs[2], neck).numpy()]
        keyed = [_by_anchor(o, values=d) for o, d in zip(outs, decs)]
        assert keyed[1] == keyed[0], "the port's bf16 decisions differ from JAX's bf16"
        assert keyed[1] == keyed[2], "the port's bf16 decisions differ from its f32 ones"
        # not a coin flip at the threshold: the JAX bf16 scores keep a margin
        jraw = np.asarray(jpipe._decisions_for_method(jm, outs[0], neck, raw=True), np.float32)
        thr = (np.nan_to_num(np.asarray(jm.packed_thresholds()), nan=0.0)
               if name == "MSP" else -np.asarray(jm.packed_thresholds()))
        cls, lvl, valid = (np.asarray(outs[0].det.cls), np.asarray(outs[0].stride_level),
                           np.asarray(outs[0].det.valid))
        box_thr = thr[cls] if name == "MSP" else thr[cls, lvl]
        gap = np.abs(jraw - box_thr)[valid & np.isfinite(box_thr)]
        assert gap.min() > SCORE_GAP, f"a score sits within {gap.min()} of its threshold"
        verdicts.append(decs[1][np.asarray(outs[1].det.valid)])
    verdicts = np.concatenate(verdicts)
    assert len(verdicts) > 8
    if name != "MSP":
        assert 0 < verdicts.sum() < len(verdicts), "every box got the same verdict"
    jres = jpipe.evaluate_method(fx["j16"], ood, jm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    tres = tpipe.evaluate_method(fx["t16"], ood, tm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    # the metric values are not compared between the runs: the OWOD
    # protocol matches boxes to ground truth at IoU 0.5 and ranks detections
    # across images, and bf16 moves boxes by up to 0.5 px (measured: WI-08
    # 0.125 against 0.222 for MSP with equal detections and decisions)
    for res in (jres, tres):
        assert set(res) == {"mAP", "U-AP", "U-F1", "U-PRE", "U-REC", "A-OSE", "WI-08"}
        assert all(np.isfinite(v) for v in res.values()), res


def test_cli_bf16_reaches_the_port(fx, tmp_path, monkeypatch):
    """--bf16 on the port's CLI builds the detector in bf16: neck taps leave
    in bf16, boxes in f32, and the run writes its results row."""
    from types import SimpleNamespace as NS

    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval

    args = NS(bf16=True, img_size=IMG, owod_task_ind="", model_version="yolov8", model="n",
              device="cpu")
    det = ood_eval.load_detector(args, default_nc=NC)
    assert det.model.compute_dtype == torch.bfloat16
    out = det.predict(np.zeros((1, IMG, IMG, 3), np.uint8))
    assert out.neck[0].dtype == torch.bfloat16 and out.det.boxes.dtype == torch.float32

    root = fx["root"]
    for split in ("ind", "ood"):
        (root / f"{split}.txt").write_text("\n".join(
            f"./{split}/images/{p.name}" for p in sorted((root / split / "images").iterdir())))
        (root / f"{split}.yaml").write_text(
            f"path: .\ntrain: {split}.txt\nval: {split}.txt\nnames:\n  0: c0\n  1: c1\n")
    monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / "results")
    monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / "storage")
    built = []

    def load(a, default_nc=20):
        built.append(a.bf16)
        return fx["t16"]

    monkeypatch.setattr(ood_eval, "load_detector", load)
    rows = ood_eval.main([
        "--ood_method", "MSP", "--model", "n", "--device", "cpu", "--bf16",
        "--ind_dataset", str(root / "ind.yaml"), "--ood_datasets", str(root / "ood.yaml"),
        "--conf_thr_train", str(CONF_TRAIN), "--conf_thr_test", str(CONF_TEST),
        "--img_size", str(IMG), "--batch_size", "4", "--name", "torchbf16"])
    assert built == [True]
    assert len(rows) == 1 and rows[0]["Method"] == "MSP"
    assert len(list((tmp_path / "results").glob("*torchbf16.csv"))) == 1
