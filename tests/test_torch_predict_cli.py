"""The port's predict CLI (cli/predict.py) against the JAX package's, on the
CPU: the mirror of tests/test_cli_predict_val.py's predict tests.

Both CLIs run on the same image directory, each from its own checkpoint of
the same weights (the non-degenerate fixture of tests/test_torch_pipeline.py,
converted as tests/test_torch_checkpoint.py converts it) with the same
fitted Cosine_cl_stride artifacts (a cli.ood_eval run of the port): classes,
per-box OoD verdicts and counts equal, boxes within 1e-3 px (f32 forwards of
two packages), scores within 1e-5."""

import json
import pickle

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.cli import predict as tpredict
from test_torch_checkpoint import ckpts  # noqa: F401 (module fixture)
from test_torch_pipeline import CONF_TEST, IMG, _cli_args, fx  # noqa: F401
from torch_threads import _two_threads  # noqa: F401 (autouse)

METHOD = "Cosine_cl_stride"


@pytest.fixture(scope="module")
def fitted(fx, ckpts, tmp_path_factory):  # noqa: F811
    """The port's eval CLI run with --model_path: its Cosine_cl_stride
    thresholds and clusters (pkl) and the fit-config sidecar."""
    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval

    root = tmp_path_factory.mktemp("fit")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(C, "RESULTS_PATH", root / "results")
        mp.setattr(C, "STORAGE_PATH", root / "storage")
        ood_eval.main(["--ood_method", METHOD, "--model_path", str(ckpts[1]), *_cli_args(fx)])
    finally:
        mp.undo()
    (thr,) = (root / "storage").glob("*_thresholds.pkl")
    (cl,) = (root / "storage").glob("*_clusters.pkl")
    return thr, cl


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    """Three random images of other sizes than the model's (letterboxed)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i, hw in enumerate([(50, 70), (64, 64), (90, 40)]):
        Image.fromarray(rng.uniform(0, 255, (*hw, 3)).astype(np.uint8)).save(d / f"img{i}.jpg")
    return d


def _predict_args(fx, ckpt, out, *extra):  # noqa: F811
    return ["--source", str(fx["root"] / "ood" / "images"), "--model_path", str(ckpt),
            "--img_size", str(IMG), "--batch_size", "3", "--conf", str(CONF_TEST),
            "--save_dir", str(out), "--save_txt", "--save_json", *extra]


def test_predict_cli_matches_jax(fx, ckpts, fitted, tmp_path):  # noqa: F811
    """Four images in groups of three (the last zero-padded), with verdicts:
    the JAX CLI's classes, verdicts and counts per image, boxes within 1e-3
    px; the txt lines carry the same fields."""
    from ood_in_object_detection_tpu.cli import predict as jpredict

    thr, cl = fitted
    ood = ["--ood_method", METHOD, "--ood_thresholds", str(thr), "--ood_clusters", str(cl),
           "--no_save"]
    trecs = tpredict.main(_predict_args(fx, ckpts[1], tmp_path / "t", "--device", "cpu", *ood))
    jpredict.main(_predict_args(fx, ckpts[0], tmp_path / "j", *ood))
    t = json.loads((tmp_path / "t" / "predictions.json").read_text())
    j = json.loads((tmp_path / "j" / "predictions.json").read_text())
    assert t == trecs and len(t) == len(j) > 10
    assert 0 < sum(r["is_ood"] for r in t) < len(t), "the verdicts are all alike"
    for a, b in zip(t, j):
        assert (a["image"], a["category"], a["name"], a["is_ood"]) == \
            (b["image"], b["category"], b["name"], b["is_ood"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=1e-5)
    for f in sorted((tmp_path / "j").glob("*.txt")):
        tl, jl = ((d / f.name).read_text().splitlines() for d in (tmp_path / "t", tmp_path / "j"))
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            a, b = a.split(), b.split()
            assert len(a) == len(b) == 7 and a[0] == b[0] and a[6] == b[6]
            np.testing.assert_allclose(np.float64(a[1:6]), np.float64(b[1:6]), atol=2e-5)


def test_predict_cli_end_to_end(img_dir, ckpts, tmp_path):  # noqa: F811
    """Letterboxed sources of three sizes in groups of two: an annotated
    image, a txt and JSON records per image, boxes inside each source."""
    from PIL import Image

    out = tmp_path / "pred"
    recs = tpredict.main(["--source", str(img_dir), "--model_path", str(ckpts[1]),
                          "--img_size", "64", "--batch_size", "2", "--conf", "1e-9",
                          "--device", "cpu", "--save_dir", str(out), "--save_txt",
                          "--save_json"])
    assert len(list(out.glob("*_pred.jpg"))) == 3
    txts = sorted(out.glob("img*.txt"))
    assert len(txts) == 3
    for t in txts:
        for line in t.read_text().splitlines():
            vals = line.split()
            assert len(vals) == 6  # cls cx cy w h conf
            cx, cy, w, h, conf = map(float, vals[1:])
            assert 0 <= cx <= 1 and 0 <= cy <= 1 and 0 < conf <= 1
    dets = json.loads((out / "predictions.json").read_text())
    assert dets == recs and {"image", "bbox", "category", "name", "score"} <= set(dets[0])
    sizes = {str(p): Image.open(p).size for p in img_dir.iterdir()}
    for d in dets:
        w, h = sizes[d["image"]]
        x1, y1, x2, y2 = d["bbox"]
        assert 0 <= x1 <= x2 <= w + 1e-6 and 0 <= y1 <= y2 <= h + 1e-6


def test_predict_cli_glob_and_single_file(img_dir):
    assert len(tpredict.collect_sources([str(img_dir)])) == 3
    assert len(tpredict.collect_sources([str(img_dir / "img0.jpg")])) == 1
    assert len(tpredict.collect_sources([str(img_dir / "img*.jpg")])) == 3
    with pytest.raises(FileNotFoundError):
        tpredict.collect_sources([str(img_dir / "nothing*.jpg")])


def test_predict_cli_ood_requires_thresholds(img_dir, ckpts, tmp_path):  # noqa: F811
    with pytest.raises(ValueError, match="ood_thresholds"):
        tpredict.main(["--source", str(img_dir / "img0.jpg"), "--model_path", str(ckpts[1]),
                       "--img_size", "64", "--device", "cpu", "--save_dir", str(tmp_path),
                       "--ood_method", "MSP"])


def test_predict_load_ood_method_sidecar_config(tmp_path):
    """The *_thresholds.json sidecar is authoritative: load_ood_method
    rebuilds the method with the fit-time temperature and sigmoid space
    whatever the flags say; another method name is an error."""
    from ood_in_object_detection_torch.ood.methods import LogitsOODMethod

    m = LogitsOODMethod("ODIN", temper=7.0, use_values_before_sigmoid=False)
    rng = np.random.default_rng(0)
    m.generate_thresholds([rng.uniform(0.2, 1.0, 40) for _ in range(2)], 0.95)
    thr = tmp_path / "x_thresholds.pkl"
    thr.write_bytes(pickle.dumps([m.thresholds]))
    thr.with_suffix(".json").write_text(json.dumps({
        "ood_method": "ODIN", "temperature_odin": 7.0, "use_values_before_sigmoid": False}))
    args = tpredict.build_parser().parse_args(
        ["--source", "x", "--ood_method", "ODIN", "--ood_thresholds", str(thr)])
    loaded = tpredict.load_ood_method(args)
    assert loaded.temper == 7.0 and loaded.use_values_before_sigmoid is False
    assert loaded.thresholds == m.thresholds
    args2 = tpredict.build_parser().parse_args(
        ["--source", "x", "--ood_method", "MSP", "--ood_thresholds", str(thr)])
    with pytest.raises(ValueError, match="fitted for ODIN"):
        tpredict.load_ood_method(args2)


def test_predict_refuses_sdr_and_unported_flags(tmp_path):
    """An SDR method's embedder is fitted in the process and no artifact
    holds it: ValueError, as the JAX CLI raises; --compile_cache has no
    counterpart; --data_parallel with a batch that does not divide over its
    mesh raises (ValueError) before any image is read."""
    thr = tmp_path / "s_thresholds.pkl"
    thr.write_bytes(pickle.dumps([[[0.5] * 3] * 2]))
    args = tpredict.build_parser().parse_args(
        ["--source", "x", "--ood_method", "CosineIvis", "--ood_thresholds", str(thr)])
    with pytest.raises(ValueError, match="SDR embedding"):
        tpredict.load_ood_method(args)
    with pytest.raises(NotImplementedError, match="compiles"):
        tpredict.main(["--source", "x", "--compile_cache", "c"])
    with pytest.raises(ValueError, match="divide"):
        tpredict.main(["--source", "x", "--data_parallel", "--device", "cpu,cpu,cpu"])


def test_predict_cli_torch_weights(fx, ckpts, tmp_path):  # noqa: F811
    """--torch_weights on a .pt written by torch.save ({'ema': None,
    'model': state_dict}, as ultralytics keys it): the class count comes
    from the class bias (not --nc), and the detections are those of
    --model_path on the same weights."""
    from ood_in_object_detection_torch.core.checkpoint import load_checkpoint

    sd, _ = load_checkpoint(ckpts[1])
    pt = tmp_path / "w.pt"
    torch.save({"ema": None, "model": sd}, pt)
    args = tpredict.build_parser().parse_args(
        ["--source", "x", "--torch_weights", str(pt), "--device", "cpu", "--img_size", str(IMG)])
    det, nc = tpredict.build_detector(args)
    assert nc == det.nc == 2
    common = ["--conf", str(CONF_TEST), "--img_size", str(IMG), "--device", "cpu", "--no_save",
              "--source", str(fx["root"] / "ood" / "images")]
    a = tpredict.main(["--torch_weights", str(pt), "--save_dir", str(tmp_path / "a"), *common])
    b = tpredict.main(["--model_path", str(ckpts[1]), "--save_dir", str(tmp_path / "b"), *common])
    assert a == b and len(a) > 10
