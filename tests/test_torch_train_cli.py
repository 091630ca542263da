"""The port's train and val CLIs (cli/{train,val}.py) end to end on the CPU:
yolov8n at 64 px, nc 2, a seeded disk dataset of 8 scenes whose labels are
a fixture model's own detections (BatchNorm calibrated on the scenes, the
head spread), so that validation finds real matches. ``cli.val``'s mAP50
and mAP50-95 equal the JAX package's ``validate`` on the same weights
within 1e-6."""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.cli import train as ttrain
from ood_in_object_detection_torch.cli import val as tval
from ood_in_object_detection_torch.core.checkpoint import save_checkpoint
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)

IMG, NC = 64, 2
# the JAX CLI's results.csv header (cli/train.py of the JAX package)
CSV_HEADER = ("epoch,time_s,train/box_loss,train/cls_loss,train/dfl_loss,train/total_loss,lr,"
              "metrics/mAP50,metrics/mAP50-95\n")


def scenes(rng, n):
    yy, xx = np.mgrid[:IMG, :IMG]
    imgs = np.empty((n, IMG, IMG, 3), np.float32)
    for img in imgs:
        img[:] = rng.uniform(0, 255, 3)
        for _ in range(rng.integers(2, 5)):
            cx, cy = rng.uniform(0, IMG, 2)
            r = rng.uniform(IMG / 10, IMG / 4)
            img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
        img += rng.normal(0, 8, img.shape)
    return np.clip(imgs, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def fixture_data(tmp_path_factory):
    """-> (root, dataset yaml, fixture checkpoint dir, numpy state_dict)."""
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    imgs = scenes(rng, 8)
    tm = build_model("yolov8n", nc=NC)
    init_weights(tm, torch.Generator().manual_seed(0))
    calibrate_batchnorm(tm, torch.from_numpy(imgs).float().permute(0, 3, 1, 2) / 255)
    sd = spread_detect_head(numpy_state_dict(tm), seed=1)
    load_jax_variables(tm, sd)
    out = Detector(model=tm.eval(), img_size=IMG).predict(imgs, conf_thres=0.25)
    (root / "images").mkdir()
    (root / "labels").mkdir()
    names, n_boxes = [], 0
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(root / "images" / f"s{i}.png")
        keep = out.det.valid[i].numpy()
        rows = [f"{int(c)} {(x1 + x2) / 2 / IMG:.6f} {(y1 + y2) / 2 / IMG:.6f} "
                f"{(x2 - x1) / IMG:.6f} {(y2 - y1) / IMG:.6f}"
                for (x1, y1, x2, y2), c in zip(out.det.boxes[i].numpy()[keep][:6],
                                                out.det.cls[i].numpy()[keep][:6])]
        n_boxes += len(rows)
        (root / "labels" / f"s{i}.txt").write_text("\n".join(rows) + "\n")
        names.append(f"./images/s{i}.png")
    assert n_boxes >= 8
    (root / "split.txt").write_text("\n".join(names) + "\n")
    (root / "d.yaml").write_text("path: .\ntrain: split.txt\nval: split.txt\n"
                                 "names:\n  0: a\n  1: b\n")
    save_checkpoint(root / "fixture", tm, {"name": "fixture", "nc": NC}, "yolov8n")
    return root, root / "d.yaml", root / "fixture", sd


def train_args(root, yaml, *extra):
    return ["--dataset", str(yaml), "--model", "n", "--batch_size", "4", "--img_size", str(IMG),
            "--workers", "2", "--device", "cpu", "--out_dir", str(root / "runs"),
            "--max_gt", "8", "--val_every", "1", *extra]


def read_scalars(run_dir):
    tb_loader = pytest.importorskip("tensorboard.backend.event_processing.event_file_loader")
    files = sorted(run_dir.glob("events.out.tfevents.*"))
    assert len(files) == 1
    events = list(tb_loader.EventFileLoader(str(files[0])).Load())
    assert events[0].file_version == "brain.Event:2"

    def val(v):
        return v.simple_value if v.WhichOneof("value") == "simple_value" else v.tensor.float_val[0]

    return [(v.tag, e.step, val(v)) for e in events[1:] for v in e.summary.value]


@pytest.fixture(scope="module")
def trained(fixture_data):
    """cli.train, 1 epoch of 2 steps (8 scenes, batch 4, augmentation on)."""
    root, yaml, _, _ = fixture_data
    ttrain.main(train_args(root, yaml, "--epochs", "1", "--name", "r"))
    return root / "runs" / "r"


def test_train_cli_writes_results_events_and_checkpoint(trained):
    lines = (trained / "results.csv").read_text().splitlines(keepends=True)
    assert lines[0] == CSV_HEADER and len(lines) == 2
    row = lines[1].strip().split(",")
    assert row[0] == "0" and all(math.isfinite(float(v)) for v in row[1:])
    scalars = read_scalars(trained)
    tags = {t for t, s, _ in scalars if s == 0}
    assert {"train/box_loss", "train/cls_loss", "train/dfl_loss", "train/total_loss", "lr/lr0",
            "metrics/mAP50(B)", "metrics/mAP50-95(B)"} <= tags
    meta = json.loads((trained / "meta.json").read_text())
    assert meta["epoch"] == 0 and meta["model_name"] == "yolov8n"
    assert meta["train_args"]["name"] == "r" and meta["train_args"]["nc"] == NC
    payload = torch.load(trained / "state.pt", weights_only=True)
    assert payload["step"] == 2 and payload["opt_state"]["state"]


def test_train_cli_resumes_at_the_next_epoch(fixture_data, trained):
    root, yaml, _, _ = fixture_data
    run = root / "runs" / "r2"
    run.mkdir(parents=True)
    for f in trained.iterdir():  # a copy of the epoch-0 run to resume from
        (run / f.name).write_bytes(f.read_bytes())
    ttrain.main(train_args(root, yaml, "--epochs", "2", "--name", "r2", "--resume", str(run)))
    lines = (run / "results.csv").read_text().splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["0", "1"]
    assert json.loads((run / "meta.json").read_text())["epoch"] == 1
    assert torch.load(run / "state.pt", weights_only=True)["step"] == 4


def test_train_cli_val_only(fixture_data, caplog):
    root, yaml, ckpt, _ = fixture_data
    with caplog.at_level("INFO", logger="train"):
        ttrain.main(train_args(root, yaml, "--val_only", "--model_path", str(ckpt)))
    assert any("val-only: mAP50=" in r.getMessage() for r in caplog.records)


def test_val_cli_matches_jax_validate(fixture_data):
    """cli.val --out on the fixture checkpoint against the JAX package's
    validate on the same weights (export_state_dict's names imported into
    the JAX variables)."""
    from ood_in_object_detection_tpu.cli.train import validate as jax_validate
    from ood_in_object_detection_tpu.data import DetectionDataset as JDataset
    from ood_in_object_detection_tpu.models import build_model as jax_build_model
    from ood_in_object_detection_tpu.utils.weight_import import import_state_dict

    root, yaml, ckpt, sd = fixture_data
    out = root / "val.json"
    got = tval.main(["--model_path", str(ckpt), "--dataset", str(yaml), "--img_size", str(IMG),
                     "--batch_size", "4", "--max_gt", "8", "--device", "cpu", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["mAP50"] == pytest.approx(got["mAP50"]) and "mAP50_95" in written

    jm = jax_build_model("yolov8n", nc=NC)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    v, missing = import_state_dict(shapes, sd, 22, strict=True)
    assert not missing
    state = types.SimpleNamespace(ema_params=v["params"], batch_stats=v["batch_stats"])
    args = types.SimpleNamespace(img_size=IMG, batch_size=4, max_gt=8, workers=2)
    want = jax_validate(jm, state, JDataset.from_yaml(str(yaml), split="val"), args, NC)
    assert want["mAP50"] > 0.3
    for k in ("mAP50", "mAP50_95"):
        assert abs(written[k] - float(want[k])) <= 1e-6, (k, written[k], want[k])


def test_clis_run_on_the_card_by_default(fixture_data):
    """Without --device both CLIs take CUDA device 0: with no card they
    raise, no silent CPU fallback; flags the port cannot honour raise naming
    their item, and the hub-only families are refused as in JAX."""
    root, yaml, ckpt, _ = fixture_data
    base = ["--dataset", str(yaml), "--model", "n", "--img_size", str(IMG), "--epochs", "1",
            "--out_dir", str(root / "runs"), "--name", "nocard"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main(base)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tval.main(["--model_path", str(ckpt), "--dataset", str(yaml)])
    with pytest.raises(NotImplementedError, match="compile_cache"):
        ttrain.main(base + ["--compile_cache", "/tmp/cc"])
    with pytest.raises(NotImplementedError, match="compile_cache"):
        tval.main(["--model_path", str(ckpt), "--dataset", str(yaml), "--compile_cache", "x"])
    with pytest.raises(SystemExit, match="hub-pretrained"):
        ttrain.main(base + ["--model_version", "yolov5", "--device", "cpu"])
