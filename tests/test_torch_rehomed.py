"""The NumPy modules the port re-homes from the JAX package (core/config.py,
eval/owod_protocol.py, ood/thresholds.py, ood/matching.py, constants.py,
data/{dataset,letterbox}.py, eval/results_writer.py,
utils/visualization.py, ood/dbcv.py) give the JAX package's results on the same inputs:
equal, not within a tolerance, since the code is the same."""

import numpy as np
import pytest

from ood_in_object_detection_tpu import constants as jconstants
from ood_in_object_detection_tpu import data as jdata
from ood_in_object_detection_tpu.core import config as jconfig
from ood_in_object_detection_tpu.eval import owod_protocol as jowod
from ood_in_object_detection_tpu.eval import results_writer as jwriter
from ood_in_object_detection_tpu.ood import dbcv as jdbcv
from ood_in_object_detection_tpu.ood import matching as jmatching
from ood_in_object_detection_tpu.ood import thresholds as jthr
from ood_in_object_detection_tpu.utils import visualization as jvis
from ood_in_object_detection_torch import constants as tconstants
from ood_in_object_detection_torch import data as tdata
from ood_in_object_detection_torch.core import config as tconfig
from ood_in_object_detection_torch.eval import owod_protocol as towod
from ood_in_object_detection_torch.eval import results_writer as twriter
from ood_in_object_detection_torch.ood import dbcv as tdbcv
from ood_in_object_detection_torch.ood import matching as tmatching
from ood_in_object_detection_torch.ood import thresholds as tthr
from ood_in_object_detection_torch.utils import visualization as tvis


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


def test_constants_match_jax():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names and names == [n for n in dir(tconstants) if n.isupper()]
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


@pytest.mark.parametrize("hw", [(60, 80), (96, 96), (130, 70)])
def test_letterbox_matches_jax(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, got_rp = tdata.letterbox_np(img, (96, 96))
    want, want_rp = jdata.letterbox_np(img, (96, 96))
    np.testing.assert_array_equal(got, want)
    assert got_rp == want_rp
    boxes = np.array([[10.0, 12.0, 40.0, 50.0], [0.0, 0.0, 96.0, 96.0]])
    np.testing.assert_array_equal(tdata.scale_boxes_back(boxes, got_rp, hw),
                                  jdata.scale_boxes_back(boxes, want_rp, hw))


@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    """Five PNGs of three sizes with YOLO labels (one image unlabelled),
    listed by a dataset yaml."""
    from PIL import Image

    root = tmp_path_factory.mktemp("rehomed_ds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    for i, hw in enumerate([(64, 80), (96, 96), (50, 120), (80, 64), (96, 72)]):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            root / "images" / f"im{i}.png")
        if i == 3:
            continue
        rows = [f"{int(rng.integers(0, 3))} {rng.uniform(0.2, 0.8):.5f} {rng.uniform(0.2, 0.8):.5f}"
                f" {rng.uniform(0.05, 0.3):.5f} {rng.uniform(0.05, 0.3):.5f}"
                for _ in range(int(rng.integers(1, 5)))]
        (root / "labels" / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    (root / "list.txt").write_text("\n".join(f"./images/im{i}.png" for i in range(5)))
    (root / "ds.yaml").write_text("path: .\ntrain: list.txt\nval: list.txt\n"
                                  "names:\n  0: a\n  1: b\n  2: c\n")
    return root


@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
def test_dataset_and_batcher_match_jax(disk_dataset, image_dtype):
    tds = tdata.DetectionDataset.from_yaml(str(disk_dataset / "ds.yaml"), split="val")
    jds = jdata.DetectionDataset.from_yaml(str(disk_dataset / "ds.yaml"), split="val")
    assert (tds.names, tds.number_of_classes, len(tds)) == (jds.names, jds.number_of_classes,
                                                          len(jds)) == (["a", "b", "c"], 3, 5)
    for a, b in zip(tds.labels, jds.labels):
        assert a.im_file == b.im_file and a.shape == b.shape
        np.testing.assert_array_equal(a.cls, b.cls)
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
    tb = list(tdata.PaddedBatcher(tds, batch_size=2, img_size=64, max_gt=8,
                                  image_dtype=image_dtype, workers=1))
    jb = list(jdata.PaddedBatcher(jds, batch_size=2, img_size=64, max_gt=8,
                                  image_dtype=image_dtype, workers=1))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert tb[-1]["batch_mask"].tolist() == [True, False]


def test_results_row_matches_jax(tmp_path):
    class Method:
        name, cluster_method = "Cosine_cl_stride", "one"
        clusters = [[np.zeros((1, 4)), np.empty(0), np.zeros((2, 4))]]

    metrics = {"mAP": 0.5, "U-AP": 0.25, "U-F1": 0.1, "U-PRE": 0.2, "U-REC": 0.3,
               "A-OSE": 4.0, "WI-08": 0.01}
    rows = []
    for w in (twriter, jwriter):
        row = w.method_info_row(Method(), "train", 0.15, 0.15, 0.95, "none")
        for key in ("coco_ood", "coco_mixed"):
            w.fill_dataset_results(row, key, metrics)
        w.fill_dataset_results(row, "owod", metrics, "t1")
        rows.append(w.finalize_row(row, "yolov8n", {"bf16": True}))
    assert rows[0] == rows[1]
    assert rows[0]["mean_n_clus"] == 1.5
    t = twriter.append_results(rows[:1], str(tmp_path / "t"), "row")
    j = jwriter.append_results(rows[1:], str(tmp_path / "j"), "row")
    assert t.read_text() == j.read_text()


def test_visualization_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    boxes = np.array([[4.0, 5.0, 30.0, 40.0], [10.0, 2.0, 60.0, 20.0]])
    args = (img, boxes, ["c0 0.91", ""], [(255, 0, 0), (0, 255, 0)])
    np.testing.assert_array_equal(tvis.draw_boxes(*args), jvis.draw_boxes(*args))


@pytest.mark.parametrize("metric", ["l1", "l2", "cosine"])
def test_dbcv_matches_jax(metric):
    """ood/dbcv.py is the JAX package's module, unchanged: the same source
    and the same validity index, noise label included."""
    from pathlib import Path

    assert Path(tdbcv.__file__).read_text() == Path(jdbcv.__file__).read_text()
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(c, 0.3, (25, 6)) for c in (0.0, 3.0, -3.0)])
    labels = np.repeat([0, 1, 2], 25)
    labels[::11] = -1
    assert tdbcv.validity_index(x, labels, metric=metric, d=6) == \
        jdbcv.validity_index(x, labels, metric=metric, d=6)


@pytest.mark.parametrize("rel", ["data/oak_sos.py", "data/owod_tools.py", "utils/log.py",
                                 "data/augment.py", "eval/det_metrics.py", "utils/tb_events.py"])
def test_tool_modules_are_the_jax_modules(rel):
    """data/oak_sos.py, data/owod_tools.py, utils/log.py and the training
    path's data/augment.py, eval/det_metrics.py and utils/tb_events.py are
    the JAX package's modules, unchanged."""
    from pathlib import Path

    import ood_in_object_detection_torch as T
    import ood_in_object_detection_tpu as J

    assert (Path(T.__file__).parent / rel).read_text() == (Path(J.__file__).parent / rel).read_text()


def test_oak_sos_and_owod_tools_match_jax(tmp_path):
    """The copies give the JAX modules' outputs: OAK annotation lines, an SOS
    mask's box, a split list and a task-stem list written alike."""
    from ood_in_object_detection_torch.data import oak_sos as toak, owod_tools as towod_t
    from ood_in_object_detection_tpu.data import oak_sos as joak, owod_tools as jowod_t

    anns = [{"id": 0, "category": "a", "box2d": {"x1": 10, "y1": 20, "x2": 30, "y2": 60}},
            {"id": 2, "category": "b", "box2d": {"x1": 1, "y1": 2, "x2": 40, "y2": 9}},
            {"id": 5, "category": "c", "box2d": {"x1": 0, "y1": 0, "x2": 10, "y2": 10}}]
    assert toak.oak_annotations_to_yolo_lines(anns, 3, 100, 80) == \
        joak.oak_annotations_to_yolo_lines(anns, 3, 100, 80)
    seg = np.zeros((40, 50), np.uint8)
    seg[5:17, 8:30] = 3
    assert toak.segmentation_to_bbox(seg, 3) == joak.segmentation_to_bbox(seg, 3)
    imgs = tmp_path / "imgs"
    (imgs / "sub").mkdir(parents=True)
    for name in ("a.jpg", "sub/b.png", "c.txt"):
        (imgs / name).write_bytes(b"x")
    for key, mod in (("t", towod_t), ("j", jowod_t)):
        assert mod.write_split_txt([str(imgs)], str(tmp_path / key / "split.txt"),
                                   relative_to=str(tmp_path)) == 2
        assert mod.write_task_stems_txt(["x1", "x2"], str(tmp_path / key / "stems.txt")) == 2
    for name in ("split.txt", "stems.txt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
