"""The port's f32 contract (core/precision.py): every command-line entry
point switches TF32 off for cuDNN convolutions and CUDA matmuls where it
picks its device, for ``--device cpu`` too, so that its f32 path is f32 on
the card whatever PyTorch's defaults (cuDNN TF32 on).

Each entry runs with both flags set True before it, up to the step after
its device choice, where a stub stops it (the model's construction, the
first file it reads); the flags must then be False. A fixture puts the
process's flags back afterwards."""

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.core.precision import disable_tf32


class _Stop(Exception):
    pass


def _stop(*a, **k):
    raise _Stop


@pytest.fixture
def tf32_on():
    prior = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prior


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _dataset_stub(monkeypatch, module):
    class _DS:
        number_of_classes = 2

    monkeypatch.setattr(module, "load_dataset", lambda *a, **k: _DS())


def _ood_eval(tmp_path, monkeypatch):
    from ood_in_object_detection_torch.cli import ood_eval
    from ood_in_object_detection_torch.engine import Detector

    _dataset_stub(monkeypatch, ood_eval)
    monkeypatch.setattr(Detector, "create", _stop)
    ood_eval.main(["--ood_method", "MSP", "--ind_dataset", "i.yaml", "--ood_datasets", "o.yaml",
                   "--device", "cpu"])


def _predict(tmp_path, monkeypatch):
    from PIL import Image

    from ood_in_object_detection_torch.cli import predict
    from ood_in_object_detection_torch.engine import Detector

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "a.png")
    monkeypatch.setattr(Detector, "create", _stop)
    predict.main(["--source", str(tmp_path / "a.png"), "--device", "cpu"])


def _train(tmp_path, monkeypatch):
    from ood_in_object_detection_torch.cli import train
    from ood_in_object_detection_torch.parallel import mesh

    monkeypatch.setattr(mesh, "make_mesh", _stop)
    train.main(["--dataset", str(tmp_path / "missing.yaml"), "--device", "cpu"])


def _train_data_parallel(tmp_path, monkeypatch):
    """Two ranks: the ranks take the flags the parent holds when it spawns
    them (parallel/distributed.py:spawn), so they must be off by then."""
    from ood_in_object_detection_torch.cli import train
    from ood_in_object_detection_torch.parallel import distributed

    monkeypatch.setattr(distributed, "spawn", _stop)
    train.main(["--dataset", str(tmp_path / "missing.yaml"), "--device", "cpu,cpu",
                "--batch_size", "2"])


def _val(tmp_path, monkeypatch):
    from ood_in_object_detection_torch.cli import val

    with pytest.raises(FileNotFoundError):  # the dataset, read after the device
        val.main(["--model_path", str(tmp_path / "ckpt"), "--dataset",
                  str(tmp_path / "missing.yaml"), "--device", "cpu"])
    raise _Stop


def _extract_activations(tmp_path, monkeypatch):
    from ood_in_object_detection_torch.cli import extract_activations
    from ood_in_object_detection_torch.engine import Detector

    monkeypatch.setattr(Detector, "create", _stop)
    extract_activations.main(["--dataset", "d.yaml", "--out", str(tmp_path / "a.pkl"),
                              "--device", "cpu"])


def _embedding_plot(tmp_path, monkeypatch):
    from ood_in_object_detection_torch.cli import embedding_plot

    with pytest.raises(FileNotFoundError):  # the payload, read after the device
        embedding_plot.main(["--activations", str(tmp_path / "missing.pkl"),
                             "--number_of_known_classes", "2", "--out_dir", str(tmp_path),
                             "--device", "cpu"])
    raise _Stop


def _serve_bundle(tmp_path, monkeypatch):
    from ood_in_object_detection_torch.scripts import serve_bundle

    with pytest.raises(FileNotFoundError):  # the requests, read after the flags
        serve_bundle.main(["--bundle", str(tmp_path), "--images", str(tmp_path / "r.npy"),
                           "--out", str(tmp_path / "o.pkl"), "--device", "cpu"])
    raise _Stop


ENTRIES = {"ood_eval": _ood_eval, "predict": _predict, "train": _train,
           "train_data_parallel": _train_data_parallel, "val": _val,
           "extract_activations": _extract_activations, "embedding_plot": _embedding_plot,
           "serve_bundle": _serve_bundle}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_cli_switches_tf32_off(entry, tf32_on, tmp_path, monkeypatch):
    assert _flags() == (True, True)
    with pytest.raises(_Stop):
        ENTRIES[entry](tmp_path, monkeypatch)
    assert _flags() == (False, False)


def test_disable_tf32(tf32_on):
    disable_tf32()
    assert _flags() == (False, False)
    disable_tf32()  # idempotent
    assert _flags() == (False, False)


def test_serve_bundle_has_no_tf32_flag():
    """TF32 off is the bundle server's only setting: the flag that switched
    it off is gone and no flag switches it on."""
    from ood_in_object_detection_torch.scripts import serve_bundle

    with pytest.raises(SystemExit):
        serve_bundle.main(["--bundle", "b", "--images", "r.npy", "--out", "o.pkl", "--no_tf32"])
