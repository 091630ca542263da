"""The ported slice as a whole against the JAX package, on the CPU:
uint8 images -> YOLOv8n forward -> detect/NMS -> RoI taps -> MSP and
Cosine_cl_stride -> extract -> fit -> evaluate -> OWOD metrics, on an
on-disk dataset (96 px, nc=2) and shared weights (the JAX init carried into
torch, BatchNorm-calibrated and head-spread there, and imported back).

Integer outputs are demanded exactly, so the test first asserts that the
fixture is non-degenerate: per image, consecutive candidate confidences are
more than 1e-4 apart, and so are all evaluated detections' confidences (the
OWOD protocol ranks them across images); no candidate pair's IoU is within
1e-3 of the NMS threshold; and no evaluated box's score is within 1e-4 of
its threshold.
Ground-truth boxes are the torch model's own detections, written as labels,
so that the Hungarian matching of the InD extraction is not empty."""

import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.data import DetectionDataset, PaddedBatcher
from ood_in_object_detection_tpu.engine import Detector as JaxDetector
from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_tpu.ood import pipeline as jpipe
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.ood import methods as tmethods
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ops import nms as tnms
from ood_in_object_detection_torch.ops.boxes import box_iou
from ood_in_object_detection_torch.ops.fused_detect import select_candidates
from test_torch_model import shared_weights
from test_torch_unknown import _both_hyp
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, NC, IOU = 96, 2, 0.7
KNOWN, NAMES = [0, 1], ["c0", "c1", "unknown"]
# a seed, head spread and confidence thresholds for which the fixture is
# non-degenerate (test_fixture_is_non_degenerate): 107 InD detections to
# fit on, 33 evaluated detections. A small spread keeps the logits, and so
# the f32 differences between the two packages' forwards, small.
SEED, SPREAD, CONF_TRAIN, CONF_TEST = 14, 2.0, 0.7, 0.8


def _write_images(root, name, images):
    from PIL import Image

    (root / name / "images").mkdir(parents=True)
    (root / name / "labels").mkdir()
    files = []
    for i, img in enumerate(images):
        f = root / name / "images" / f"{name}{i}.png"
        Image.fromarray(img).save(f)
        files.append(f)
    return files


def _label_from_detections(det: Detector, files, conf: float, unknown_every: int = 0):
    """Write each image's top detections as its YOLO labels; with
    ``unknown_every`` > 0 every that-many-th box gets the unknown class 5."""
    from PIL import Image

    images = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
    out = det.predict(images, conf_thres=conf, iou_thres=IOU)
    for i, f in enumerate(files):
        n = min(int(out.det.valid[i].sum()), 30)
        lines = []
        for j in range(n):
            x1, y1, x2, y2 = (out.det.boxes[i, j].numpy() / IMG).tolist()
            c = 5 if unknown_every and j % unknown_every == unknown_every - 1 else int(out.det.cls[i, j])
            lines.append(f"{c} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}")
        (f.parent.parent / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    images = np.random.default_rng(SEED).integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    ind_files = _write_images(root, "ind", images[:4])
    ood_files = _write_images(root, "ood", images[4:])
    calib = torch.from_numpy(images).float().permute(0, 3, 1, 2) * (1 / 255)
    jm, variables, tm = shared_weights("yolov8n", nc=NC, seed=SEED, calib=calib, spread=SPREAD)
    tdet = Detector(model=tm, img_size=IMG)
    _label_from_detections(tdet, ind_files, CONF_TRAIN)
    _label_from_detections(tdet, ood_files, CONF_TEST, unknown_every=3)
    names = [f"c{k}" for k in range(6)]
    ind = DetectionDataset.from_image_list([str(f) for f in ind_files], names, number_of_classes=NC)
    ood = DetectionDataset.from_image_list([str(f) for f in ood_files], names, number_of_classes=NC)
    batches = {k: list(PaddedBatcher(ds, batch_size=4, img_size=IMG, max_gt=32, image_dtype="uint8"))
               for k, ds in (("ind", ind), ("ood", ood))}
    jdet = JaxDetector(model=jm, variables=variables, img_size=IMG)
    return dict(root=root, tdet=tdet, jdet=jdet, batches=batches)


def test_fixture_is_non_degenerate(fx):
    model = fx["tdet"].model
    for split, conf_thres in (("ind", CONF_TRAIN), ("ood", CONF_TEST)):
        for batch in fx["batches"][split]:
            x = torch.from_numpy(batch["images"]).float().permute(0, 3, 1, 2) * (1.0 / 255.0)
            with torch.no_grad():
                raw, _ = model(x)
            cand = select_candidates(raw, NC, conf_thres, pre_nms_k=1024)
            for i in range(len(x)):
                conf = cand.conf[i][cand.conf[i] > conf_thres]
                assert len(conf) > 1
                assert (conf[:-1] - conf[1:]).min() > 1e-4, "candidate confidences nearly tie"
                shifted, valid = tnms.nms_inputs(cand.boxes[i], cand.conf[i], cand.cls[i],
                                                 conf_thres)
                iou = box_iou(shifted[valid], shifted[valid])
                assert not ((iou - IOU).abs() < 1e-3).any(), "an IoU sits at the NMS threshold"
            assert batch["gt_mask"].sum() > 0
    confs = torch.cat([fx["tdet"].predict(b["images"], conf_thres=CONF_TEST).det.conf.flatten()
                       for b in fx["batches"]["ood"]])
    confs = torch.sort(confs[confs > 0], descending=True).values
    assert len(confs) > 10
    assert (confs[:-1] - confs[1:]).min() > 1e-4, "evaluated confidences nearly tie"


def test_predict_matches_jax(fx):
    images = fx["batches"]["ind"][0]["images"]
    t = fx["tdet"].predict(images, conf_thres=CONF_TRAIN)
    j = fx["jdet"].predict(images, conf_thres=CONF_TRAIN)
    for field in ("valid", "cls", "anchor_idx"):
        np.testing.assert_array_equal(getattr(t.det, field).numpy(),
                                      np.asarray(getattr(j.det, field)), err_msg=field)
    np.testing.assert_array_equal(t.stride_level.numpy(), np.asarray(j.stride_level))
    assert t.det.valid.sum() > 20
    np.testing.assert_allclose(t.det.boxes.numpy(), np.asarray(j.det.boxes), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(t.det.conf.numpy(), np.asarray(j.det.conf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.logits.numpy(), np.asarray(j.logits), rtol=1e-4, atol=1e-3)
    for a, b in ((t.roi_feats, j.roi_feats), (t.exact_feats, j.exact_feats)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def _methods(name):
    if name == "MSP":
        return jmethods.LogitsOODMethod("MSP"), tmethods.LogitsOODMethod("MSP")
    return jmethods.DistanceOODMethod.from_name(name), tmethods.DistanceOODMethod.from_name(name)


def _flat(thresholds):
    out = []
    for t in thresholds:
        out.extend(_flat(t) if isinstance(t, list) else [np.nan if t is None else t])
    return np.asarray(out, np.float64)


@pytest.mark.parametrize("name", ["MSP", "Cosine_cl_stride", "L1_cl_stride"])
def test_extract_fit_evaluate_match_jax(fx, name):
    jm, tm = _methods(name)
    ind, ood = fx["batches"]["ind"], fx["batches"]["ood"]
    jacts = jpipe.extract_ind_activations(fx["jdet"], ind, jm, conf_thr_train=CONF_TRAIN)
    tacts = tpipe.extract_ind_activations(fx["tdet"], ind, tm, conf_thr_train=CONF_TRAIN)
    jflat = jacts[id(jm)] if name == "MSP" else [a for row in jacts[id(jm)] for a in row]
    tflat = tacts[id(tm)] if name == "MSP" else [a for row in tacts[id(tm)] for a in row]
    assert sum(len(a) for a in tflat) > 10, "no matched InD boxes: the fit would be empty"
    for a, b in zip(tflat, jflat):
        assert a.shape == b.shape
        if a.size:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())

    jpipe.fit_ind_pipeline(jm, jacts, tpr=0.95)
    tpipe.fit_ind_pipeline(tm, tacts, tpr=0.95)
    jt, tt = _flat(jm.thresholds), _flat(tm.thresholds)
    assert np.isfinite(tt).sum() > 0
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    if name != "MSP":
        assert sum(isinstance(c, np.ndarray) and c.ndim == 2 for row in tm.clusters for c in row) > 0

    neck_j, neck_t = fx["jdet"].neck_channels(), fx["tdet"].neck_channels()
    assert tuple(neck_j) == tuple(neck_t)
    verdicts = []
    for batch in ood:
        jout = fx["jdet"].predict(batch["images"], conf_thres=CONF_TEST)
        tout = fx["tdet"].predict(batch["images"], conf_thres=CONF_TEST)
        jdec = np.asarray(jpipe._decisions_for_method(jm, jout, neck_j))
        tdec = tpipe._decisions_for_method(tm, tout, neck_t).numpy()
        np.testing.assert_array_equal(tdec, jdec)
        # decisions are not a coin flip at the threshold: scores keep a margin
        jraw = np.asarray(jpipe._decisions_for_method(jm, jout, neck_j, raw=True))
        thr = (np.nan_to_num(np.asarray(jm.packed_thresholds()), nan=0.0)
               if name == "MSP" else -np.asarray(jm.packed_thresholds()))
        cls, lvl, valid = (np.asarray(jout.det.cls), np.asarray(jout.stride_level),
                           np.asarray(jout.det.valid))
        box_thr = thr[cls] if name == "MSP" else thr[cls, lvl]
        gap = np.abs(jraw - box_thr)[valid & np.isfinite(box_thr)]
        assert gap.min() > 1e-4 * max(1.0, np.abs(box_thr[np.isfinite(box_thr)]).max())
        verdicts.append(tdec[valid])

    verdicts = np.concatenate(verdicts)
    if name != "MSP":  # MSP calls every box kept at CONF_TEST in-distribution here
        assert 0 < verdicts.sum() < len(verdicts), "every box got the same verdict"
    jres = jpipe.evaluate_method(fx["jdet"], ood, jm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    tres = tpipe.evaluate_method(fx["tdet"], ood, tm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    assert set(tres) == {"mAP", "U-AP", "U-F1", "U-PRE", "U-REC", "A-OSE", "WI-08"}
    assert tres == jres


def _write_yamls(root):
    for split in ("ind", "ood"):
        (root / f"{split}.txt").write_text("\n".join(
            f"./{split}/images/{p.name}" for p in sorted((root / split / "images").iterdir())))
        (root / f"{split}.yaml").write_text(
            f"path: .\ntrain: {split}.txt\nval: {split}.txt\nnames:\n  0: c0\n  1: c1\n")


def _cli_args(fx, *extra):
    root = fx["root"]
    _write_yamls(root)
    return ["--model", "n", "--device", "cpu",
            "--ind_dataset", str(root / "ind.yaml"), "--ood_datasets", str(root / "ood.yaml"),
            "--conf_thr_train", str(CONF_TRAIN), "--conf_thr_test", str(CONF_TEST),
            "--img_size", str(IMG), "--batch_size", "4", "--name", "torchsmoke", *extra]


def test_cli_runs_on_fixture(fx, tmp_path, monkeypatch):
    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval

    monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / "results")
    monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / "storage")
    monkeypatch.setattr(ood_eval, "load_detector", lambda args, default_nc=20: fx["tdet"])
    rows = ood_eval.main(["--ood_method", "Cosine_cl_stride", *_cli_args(fx)])
    assert len(rows) == 1 and rows[0]["Method"] == "Cosine_cl_stride"
    assert len(list((tmp_path / "results").glob("*torchsmoke.csv"))) == 1


def _run_both_clis(fx, tmp_path, monkeypatch, argv):
    """The port's CLI and the JAX package's on the same fixture, each with
    its own detector (shared weights), storage and results -> two rows.
    '@' in an argument becomes the package's key; the JAX CLI's --device is
    an index, and its detector is given, so it gets none."""
    from ood_in_object_detection_torch import constants as TC
    from ood_in_object_detection_torch.cli import ood_eval as tcli
    from ood_in_object_detection_tpu import constants as JC
    from ood_in_object_detection_tpu.cli import ood_eval as jcli

    rows = {}
    for key, C, cli, det in (("torch", TC, tcli, fx["tdet"]), ("jax", JC, jcli, fx["jdet"])):
        monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / key / "results")
        monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / key / "storage")
        monkeypatch.setattr(cli, "load_detector", lambda args, default_nc=20, d=det: d)
        run = cli.run_eval
        monkeypatch.setattr(cli, "run_eval", lambda *a, run=run, key=key, **k:
                            rows.setdefault(key, run(*a, **k)))
        args = [a.replace("@", key) for a in argv]
        if key == "jax":
            i = args.index("--device")
            args = args[:i] + args[i + 2:]
        cli.main(args)
    return rows["torch"], rows["jax"]


def test_cli_eul_matches_jax(fx, tmp_path, monkeypatch):
    """--enhanced_unk_localization --device cpu: the same OWOD columns as
    the JAX CLI on the same weights and fitted state."""
    from ood_in_object_detection_torch.eval.results_writer import dataset_result_columns

    (trow,), (jrow,) = _run_both_clis(fx, tmp_path, monkeypatch, [
        "--ood_method", "Cosine_cl_stride", "--enhanced_unk_localization", *_cli_args(fx)])
    cols = dataset_result_columns("coco_ood")
    assert "U-AP" in " ".join(cols)
    np.testing.assert_equal({k: trow[k] for k in cols}, {k: jrow[k] for k in cols})
    assert "True" in trow["args"] and "enhanced_unk_localization" in trow["args"]


def test_cli_dump_fusion_scores_matches_jax(fx, tmp_path, monkeypatch):
    """--dump_fusion_scores writes the JAX CLI's arrays: member INDness
    within 1e-4 (f32 forwards of two packages), decisions, classes equal."""
    _run_both_clis(fx, tmp_path, monkeypatch, [
        "--ood_method", "fusion-MSP-Cosine_cl_stride", "--fusion_strategy", "score",
        "--dump_fusion_scores", str(tmp_path / "@" / "fusion.npz"), *_cli_args(fx)])
    t, j = (np.load(tmp_path / k / "fusion.npz") for k in ("torch", "jax"))
    assert sorted(t.files) == sorted(j.files) == ["cls", "conf", "decision", "indness",
                                                  "member_names"]
    np.testing.assert_array_equal(t["member_names"], j["member_names"])
    assert t["indness"].shape == j["indness"].shape and t["indness"].shape[1] > 10
    np.testing.assert_allclose(t["indness"], j["indness"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t["conf"], j["conf"], rtol=1e-4, atol=1e-6)
    for k in ("decision", "cls"):
        np.testing.assert_array_equal(t[k], j[k])
    assert 0 < t["decision"].sum() < len(t["decision"])


@pytest.fixture(scope="module")
def cos_acts(fx):
    """Cosine_cl_stride InD activations of both packages on the fixture."""
    jm, tm = _methods("Cosine_cl_stride")
    ind = fx["batches"]["ind"]
    return (jpipe.extract_ind_activations(fx["jdet"], ind, jm, conf_thr_train=CONF_TRAIN)[id(jm)],
            tpipe.extract_ind_activations(fx["tdet"], ind, tm, conf_thr_train=CONF_TRAIN)[id(tm)])


def _eul_props(fx, jm, tm, batch):
    """One batch's per-image EUL proposals through each package's batch
    function, as its evaluate_method calls it."""
    from ood_in_object_detection_tpu.ood.thresholds import pack_thresholds_per_class_per_stride
    from ood_in_object_detection_tpu.ood.unknown import eul_frontend_batched

    out = {}
    for key, pipe, det, m in (("jax", jpipe, fx["jdet"], jm), ("torch", tpipe, fx["tdet"], tm)):
        o = pipe._predict_step(det, CONF_TEST)(batch["images"])
        boxes, valid = np.asarray(o.det.boxes), np.asarray(o.det.valid)
        pred = {i: boxes[i, : int(valid[i].sum())].astype(np.float64) for i in range(len(boxes))}
        if key == "torch":
            bank = pipe._stride0_rank_bank(m, det.neck_channels()[0], "cpu")
            out[key] = pipe.eul_proposals_batch(m, bank, o.p3, batch["ratio_pad"], pred)
            continue
        cls_thr = None
        if jpipe.CUSTOM_HYP.unk.rank.USE_OOD_THR_TO_REMOVE_PROPS:
            cls_thr = np.nan_to_num(np.asarray(pack_thresholds_per_class_per_stride(
                m.thresholds))[:, 0], nan=np.inf)
        out[key] = pipe._eul_proposals_batch(
            m, pipe._stride0_rank_bank(m, det.neck_channels()[0]), o.p3,
            tuple(o.p3.shape[1:3]), eul_frontend_batched(o.p3, batch["ratio_pad"]),
            batch["ratio_pad"], pred, cls_thr)
    return out["torch"], out["jax"]


EUL_CASES = {"default": {},
             "ood_thr_min": dict(USE_OOD_THR_TO_REMOVE_PROPS=True, RANK_BOXES_OPERATION="min"),
             "unk_prop_thr": dict(USE_UNK_PROPOSALS_THR=True)}


@pytest.mark.parametrize("case", list(EUL_CASES))
def test_eul_evaluate_matches_jax(fx, cos_acts, case):
    """evaluate_method(..., enhanced_unk_localization=True) for
    Cosine_cl_stride: per-image proposals (image pixels) and decisions
    equal, rank scores within 1e-5, OWOD metric dicts equal; the rank
    options on both packages' CUSTOM_HYP, restored after."""
    ood = fx["batches"]["ood"]
    with _both_hyp(rank=EUL_CASES[case]):
        jm, tm = _methods("Cosine_cl_stride")
        jpipe.fit_ind_pipeline(jm, {id(jm): cos_acts[0]}, tpr=0.95)
        tpipe.fit_ind_pipeline(tm, {id(tm): cos_acts[1]}, tpr=0.95)
        if case == "unk_prop_thr":
            assert tm.unk_prop_thr is not None
            np.testing.assert_allclose(tm.unk_prop_thr, jm.unk_prop_thr, rtol=1e-5)
        else:
            assert tm.unk_prop_thr is None
        n_props = 0
        for batch in ood:
            got, want = _eul_props(fx, jm, tm, batch)
            assert got.keys() == want.keys()
            for i in want:
                (tp, td, tr), (jp, jd, jr) = got[i], want[i]
                np.testing.assert_array_equal(tp, jp)
                np.testing.assert_array_equal(td, jd)
                np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-6)
                n_props += len(tp)
        assert n_props > 0, "EUL proposed nothing: the case checks nothing"
        jres = jpipe.evaluate_method(fx["jdet"], ood, jm, KNOWN, NAMES, conf_thr_test=CONF_TEST,
                                     enhanced_unk_localization=True)
        tres = tpipe.evaluate_method(fx["tdet"], ood, tm, KNOWN, NAMES, conf_thr_test=CONF_TEST,
                                     enhanced_unk_localization=True)
    assert set(tres) == {"mAP", "U-AP", "U-F1", "U-PRE", "U-REC", "A-OSE", "WI-08"}
    assert tres == jres


@pytest.mark.parametrize("strategy", ["and", "or", "score"])
def test_fusion_matches_jax(fx, strategy):
    """fusion-MSP-Cosine_cl_stride: per-leaf thresholds, fused decisions,
    fused INDness (1e-4) and OWOD metric dicts against the JAX package."""
    from ood_in_object_detection_torch.cli.factory import build_ood_method as tbuild
    from ood_in_object_detection_tpu.cli.factory import build_ood_method as jbuild

    name = "fusion-MSP-Cosine_cl_stride"
    jm, tm = jbuild(name, fusion_strategy=strategy), tbuild(name, fusion_strategy=strategy)
    assert jm.strategy == tm.strategy == strategy
    ind, ood = fx["batches"]["ind"], fx["batches"]["ood"]
    jpipe.fit_ind_pipeline(jm, jpipe.extract_ind_activations(fx["jdet"], ind, jm,
                                                             conf_thr_train=CONF_TRAIN))
    tpipe.fit_ind_pipeline(tm, tpipe.extract_ind_activations(fx["tdet"], ind, tm,
                                                             conf_thr_train=CONF_TRAIN))
    for jl, tl in zip(jpipe._leaf_methods(jm), tpipe._leaf_methods(tm)):
        jt, tt = _flat(jl.thresholds), _flat(tl.thresholds)
        np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
        np.testing.assert_allclose(tt, jt, rtol=1e-5)
    neck = fx["tdet"].neck_channels()
    decided = []
    for batch in ood:
        jout = jpipe._predict_step(fx["jdet"], CONF_TEST)(batch["images"])
        tout = tpipe._predict_step(fx["tdet"], CONF_TEST)(batch["images"])
        jdec = np.asarray(jpipe._decisions_for_method(jm, jout, neck))
        tdec = tpipe._decisions_for_method(tm, tout, neck).numpy()
        np.testing.assert_array_equal(tdec, jdec)
        np.testing.assert_allclose(
            tpipe._decisions_for_method(tm, tout, neck, want_scores=True).numpy(),
            np.asarray(jpipe._decisions_for_method(jm, jout, neck, want_scores=True)),
            rtol=1e-4, atol=1e-4)
        decided.append(tdec[np.asarray(tout.det.valid)])
    decided = np.concatenate(decided)
    # MSP calls every box kept at CONF_TEST in-distribution here, so 'and'
    # (InD if either member says so) is all-InD
    assert decided.all() if strategy == "and" else 0 < decided.sum() < len(decided)
    jres = jpipe.evaluate_method(fx["jdet"], ood, jm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    tres = tpipe.evaluate_method(fx["tdet"], ood, tm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    assert tres == jres


@pytest.mark.parametrize("flag", [["--compile_cache", "c"], ["--cluster_method", "GMM"]])
def test_cli_unported_flags_raise(flag, tmp_path, monkeypatch):
    """--compile_cache is not ported and raises naming ROADMAP; --cluster_method
    GMM passes the CLI's checks and reaches the datasets (missing here)."""
    from ood_in_object_detection_torch.cli import ood_eval

    monkeypatch.chdir(tmp_path)
    argv = ["--ood_method", "MSP", "--ind_dataset", "x.yaml", "--ood_datasets", "y.yaml",
            "--device", "cpu", *flag]
    if flag[0] == "--compile_cache":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ood_eval.main(argv)
        return
    ood_eval.check_ported(ood_eval.build_parser().parse_args(argv + ["--visualize_clusters"]))
    with pytest.raises(FileNotFoundError, match="x.yaml"):
        ood_eval.main(argv)
