"""The port's checkpoints (core/checkpoint.py) and ``--model_path`` against
the JAX package, on the CPU.

A JAX checkpoint (orbax, the JAX package's ``save_checkpoint``) converts to
the port's by the JAX ``load_checkpoint`` -> ``export_state_dict`` -> the
port's ``save_checkpoint`` (:func:`convert_jax_checkpoint`, README.md's
command). The port's round trip is bit-equal; exported weights of one small
model of each family load strictly through a checkpoint; and both eval CLIs
run ``--model_path`` on the non-degenerate fixture of
tests/test_torch_pipeline.py (96 px, nc 2, shared weights) with equal OWOD
rows and cache files equal up to the port's ``torch_`` prefix."""

import json
import types

import jax
import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.core import checkpoint as jckpt
from ood_in_object_detection_tpu.models import build_model as jax_build_model
from ood_in_object_detection_tpu.utils.weight_import import export_state_dict
from ood_in_object_detection_torch.core import checkpoint as tckpt
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.models import build_model
from ood_in_object_detection_torch.utils import weights as W
from test_torch_pipeline import _cli_args, fx  # noqa: F401 (the shared fixture)
from torch_threads import _two_threads  # noqa: F401 (autouse)

RUN = "fxrun"  # the checkpoints' directory stem, which keys the caches


def convert_jax_checkpoint(jax_dir, out_dir) -> None:
    """A JAX package checkpoint -> a port checkpoint: parameters and EMA,
    exported under ultralytics names, with the same meta.json keys."""
    _, meta = jckpt.load_checkpoint(jax_dir)
    with torch.device("meta"):  # the detect layer's index only
        idx = build_model(meta["model_name"], nc=2).detect_layer_idx
    params, ema = (export_state_dict(jckpt.load_checkpoint(jax_dir, use_ema=e)[0],
                                     detect_layer_idx=idx) for e in (False, True))
    tckpt.save_checkpoint(out_dir, {"params": params, "ema_params": ema}, meta["train_args"],
                          meta["model_name"], meta["epoch"])


@pytest.fixture(scope="module")
def ckpts(fx, tmp_path_factory):  # noqa: F811
    """The fixture's JAX variables saved by the JAX package (EMA: the same
    weights) and converted; -> (jax dir, port dir), both named RUN."""
    root = tmp_path_factory.mktemp("ckpt")
    v = fx["jdet"].variables
    state = types.SimpleNamespace(params=v["params"], ema_params=v["params"],
                                  batch_stats=v["batch_stats"], opt_state=None)
    jdir, tdir = root / "jax" / RUN, root / "torch" / RUN
    jckpt.save_checkpoint(jdir, state, train_args={"name": RUN, "nc": 2},
                          model_name="yolov8n", epoch=3)
    convert_jax_checkpoint(jdir, tdir)
    return jdir, tdir


def test_converted_checkpoint_holds_the_jax_weights(fx, ckpts):  # noqa: F811
    """The converted checkpoint's EMA weights are the fixture's torch
    weights (the same JAX variables exported), its meta the JAX meta, and
    the detector it builds predicts as the fixture's."""
    jdir, tdir = ckpts
    sd, meta = tckpt.load_checkpoint(tdir)
    assert meta == {"train_args": {"name": RUN, "nc": 2}, "model_name": "yolov8n", "epoch": 3,
                    "nc": 2}
    assert json.loads((tdir / "meta.json").read_text()).keys() == \
        json.loads((jdir / "meta.json").read_text()).keys()
    assert tckpt.checkpoint_name(tdir) == jckpt.checkpoint_name(jdir) == RUN
    want = fx["tdet"].model.state_dict()
    assert sd.keys() == want.keys()
    for k, v in sd.items():  # BN's num_batches_tracked: bookkeeping the export zeroes
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    det = Detector.create(meta["model_name"], nc=meta["nc"], img_size=96, device="cpu",
                          state_dict=sd)
    images = fx["batches"]["ood"][0]["images"]
    got, ref = det.predict(images, conf_thres=0.5), fx["tdet"].predict(images, conf_thres=0.5)
    assert torch.equal(got.det.boxes, ref.det.boxes) and torch.equal(got.det.cls, ref.det.cls)


def test_round_trip_is_bit_equal(tmp_path):
    """save -> load gives back every tensor bit for bit, the EMA by default
    and the parameters with use_ema=False, f32 on the CPU."""
    det = Detector.create("yolov8n", nc=3, img_size=64, device="cpu")
    params = det.model.state_dict()
    ema = {k: v * 0.5 if v.is_floating_point() else v for k, v in params.items()}
    tckpt.save_checkpoint(tmp_path / "c", {"params": det.model, "ema_params": ema},
                          {"name": "r"}, "yolov8n", epoch=7)
    got_ema, meta = tckpt.load_checkpoint(tmp_path / "c")
    got_params, _ = tckpt.load_checkpoint(tmp_path / "c", use_ema=False)
    assert tckpt.state_dict_equal(got_ema, ema) and tckpt.state_dict_equal(got_params, params)
    assert not tckpt.state_dict_equal(got_ema, params)
    assert meta == {"train_args": {"name": "r"}, "model_name": "yolov8n", "epoch": 7, "nc": 3}
    assert all(v.device.type == "cpu" for v in got_ema.values())
    assert tckpt.checkpoint_name(tmp_path / "c") == "r"
    with pytest.raises(ValueError, match="cannot resume"):  # weights only, no optimizer state
        tckpt.restore_train_state(tmp_path / "c", det.model, None, None)


@pytest.mark.parametrize("name", ["yolov8n", "yolov9t", "yolov10n", "yolo11n", "yolo12n"])
def test_every_family_loads_strict_through_a_checkpoint(name, tmp_path):
    """Seeded values in the shapes of the JAX model's variables
    (jax.eval_shape), exported by the JAX package, saved as a port
    checkpoint and loaded strictly: every tensor in place, none left."""
    with torch.device("meta"):
        idx = build_model(name, nc=2).detect_layer_idx
    jm = jax_build_model(name, nc=2)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            np.zeros((1, 64, 64, 3), np.float32), train=False))
    rng = np.random.default_rng(len(name))
    variables = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    sd = export_state_dict(variables, detect_layer_idx=idx)
    tckpt.save_checkpoint(tmp_path / name, {"params": sd}, {"name": name}, name)
    loaded, meta = tckpt.load_checkpoint(tmp_path / name)
    det = Detector.create(meta["model_name"], nc=meta["nc"], img_size=64, device="cpu",
                          state_dict=loaded)
    own = det.model.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(own[k].numpy(), v, err_msg=k)
    fresh = build_model(name, nc=2)
    assert W.load_torch_state_dict(fresh, loaded, strict=True) == []


def test_load_torch_state_dict_reports_missing_keys():
    """strict=False loads what matches and returns the model's keys that
    the file lacks (the JAX import_state_dict's ``missing``); a shape that
    differs raises."""
    m = build_model("yolov8n", nc=2)
    sd = {k: torch.full_like(v, 0.25) for k, v in m.state_dict().items()
          if k.startswith("model.0.")}
    missing = W.load_torch_state_dict(m, sd, strict=False)
    assert len(missing) == len(m.state_dict()) - len(sd) and "model.0.conv.weight" not in missing
    assert torch.all(m.model[0].conv.weight == 0.25)
    with pytest.raises(KeyError, match="not found"):
        W.load_torch_state_dict(m, sd, strict=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        W.load_torch_state_dict(m, {"model.0.conv.weight": torch.zeros(1)})


def _run_both_clis_from_checkpoints(fx, ckpts, tmp_path, monkeypatch, method):  # noqa: F811
    """Both packages' eval CLIs with --model_path on their own checkpoint
    of the same weights, each with its own storage and results -> (rows,
    cache file names) per package. The JAX CLI's detector is built by its
    own load_detector once per checkpoint and kept, so that its compiled
    step serves both methods."""
    from ood_in_object_detection_torch import constants as TC
    from ood_in_object_detection_torch.cli import ood_eval as tcli
    from ood_in_object_detection_tpu import constants as JC
    from ood_in_object_detection_tpu.cli import ood_eval as jcli

    jdir, tdir = ckpts
    out = {}
    for key, C, cli, path in (("torch", TC, tcli, tdir), ("jax", JC, jcli, jdir)):
        monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / key / "results")
        monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / key / "storage")
        run = cli.run_eval
        rows = []
        monkeypatch.setattr(cli, "run_eval", lambda *a, run=run, rows=rows, **k:
                            rows.extend(run(*a, **k)) or rows)
        args = ["--ood_method", method, "--model_path", str(path), *_cli_args(fx)]
        if key == "jax":
            i = args.index("--device")
            args = args[:i] + args[i + 2:]
            real = jcli.load_detector

            def load_once(a, default_nc=20, real=real):
                if "jax_ckpt_det" not in fx:
                    fx["jax_ckpt_det"] = real(a, default_nc)
                return fx["jax_ckpt_det"]

            monkeypatch.setattr(jcli, "load_detector", load_once)
        cli.main(args)
        out[key] = (rows, sorted(p.name for p in (tmp_path / key / "storage").iterdir()))
    return out["torch"], out["jax"]


@pytest.mark.parametrize("method", ["MSP", "Cosine_cl_stride"])
def test_cli_model_path_matches_jax(fx, ckpts, tmp_path, monkeypatch, method):  # noqa: F811
    """--model_path: the port's CLI builds the checkpoint's model and gives
    the JAX CLI's OWOD row; the caches carry the checkpoint's stem, named as
    the JAX CLI names them behind the 'torch_' prefix."""
    from ood_in_object_detection_torch.eval.results_writer import dataset_result_columns

    (trows, tfiles), (jrows, jfiles) = _run_both_clis_from_checkpoints(
        fx, ckpts, tmp_path, monkeypatch, method)
    cols = dataset_result_columns("coco_ood")
    assert len(trows) == len(jrows) == 1
    np.testing.assert_equal({k: trows[0][k] for k in cols}, {k: jrows[0][k] for k in cols})
    assert len(tfiles) == 4 and all(f.startswith("torch_") and f"_{RUN}_" in f for f in tfiles)
    assert [f[len("torch_"):] for f in tfiles] == jfiles
