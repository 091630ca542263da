"""The port's model zoo (models/yolo.py) against the JAX package's: the spec
tables, every name that the JAX SCALES builds (state_dict keys and shapes
equal to ``export_state_dict`` of the JAX variables, through
``jax.eval_shape``, as tests/test_all_models_build.py builds them), the
Detect layer index, the stem gate and the CLI's name resolution.

Also the shared helpers of the per-family parity files
(tests/test_torch_models_{v9,v10,v11,v12}.py): seeded weights made on the
torch side and imported into the JAX variables (``import_state_dict``,
strict), and a harness that runs one layer class of each package on the
same input."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ood_in_object_detection_tpu.cli import factory as jfactory
from ood_in_object_detection_tpu.models import build_model as jax_build_model
from ood_in_object_detection_tpu.models import yolo as jyolo
from ood_in_object_detection_tpu.utils.weight_import import export_state_dict, import_state_dict
from ood_in_object_detection_torch.cli import factory as tfactory
from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.models import yolo as tyolo
from ood_in_object_detection_torch.ops import stem as tstem
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)
from torch_threads import _two_threads  # noqa: F401 (autouse)

ALL_NAMES = sorted({f"{fam}{size}" for fam, sizes in jyolo.SCALES.items() for size in sizes})
IMG = 64
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# one layer on one input against the JAX layer, of its output's largest
# magnitude: f32, the convs and the attention's products sum in another
# order than XLA's; bf16, the same rounding points, but a sum taken in
# another order may round to the other side of a bf16 value and run on
# through the layer's few convs (tests/test_torch_bf16.py holds the v8
# layers to the same bound)
LAYER_TOL = {"f32": 1e-5, "bf16": 2.0 ** -6}


def jax_variables(jm, state_dict, detect_layer_idx, img=IMG):
    """The JAX variables of ``jm`` holding a torch-named numpy state_dict
    (strict): the tree's shapes come from jax.eval_shape, so no JAX init
    runs."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)),
                                            train=False))
    variables, missing = import_state_dict(shapes, state_dict, detect_layer_idx, strict=True)
    assert not missing
    return variables


def zoo_weights(name, nc, seed=0, calib=None, spread=4.0, bn_scale=1.0, img=IMG):
    """-> (jax model, jax variables, torch model) holding the same weights:
    the port's seeded init, every BatchNorm scale set to ``bn_scale`` and
    calibrated on ``calib`` (NHWC floats; seeded uniform noise by default),
    the head spread (utils/weights.py), then imported into the JAX
    variables. A2C2f's gamma is drawn from U(0.5, 1.5), so that its
    residual weighs as much as the block."""
    tm = build_model(name, nc=nc)
    init_weights(tm, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, p in tm.named_parameters():
            if key.endswith(".gamma"):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape).astype(np.float32)))
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            torch.nn.init.constant_(m.weight, bn_scale)
    if calib is None:
        calib = rng.uniform(0, 1, (4, img, img, 3)).astype(np.float32)
    calibrate_batchnorm(tm, torch.from_numpy(calib).permute(0, 3, 1, 2).contiguous())
    sd = spread_detect_head(numpy_state_dict(tm), seed=seed + 1, scale=spread)
    load_jax_variables(tm, sd)
    jm = jax_build_model(name, nc=nc)
    return jm, jax_variables(jm, sd, tm.detect_layer_idx, img), tm.eval()


def one2many_maps(tm, neck):
    """yolov10's one2many maps, which the eval forward does not build: its
    Detect in training form (both branch pairs) with BatchNorm on its
    running statistics, as the JAX model's eval forward runs them."""
    head = tm.model[-1]
    head.train()
    for m in head.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    try:
        return head(neck)[0]
    finally:
        head.eval()


def forward_pair(jm, variables, tm, x):
    """Both forwards on NHWC floats ``x`` -> ([JAX maps], [port maps]), raw
    levels, neck taps (and yolov10's one2many levels, the port's from
    :func:`one2many_maps`), all NHWC numpy."""
    jout = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        tout = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        assert len(tout) == 2
        if len(jout) == 3:
            tout = (*tout, one2many_maps(tm, tout[1]))
    assert len(jout) == len(tout)
    j = [np.asarray(a) for part in jout for a in part]
    t = [a.permute(0, 2, 3, 1).numpy() for part in tout for a in part]
    return j, t


def assert_forward_matches(jm, variables, tm, x, rtol=1e-4, atol=1e-4):
    """Raw maps and neck taps (and yolov10's one2many maps) within ``rtol``
    and ``atol`` of each tensor's largest magnitude
    (tests/test_torch_model.py's f32 tolerance)."""
    j, t = forward_pair(jm, variables, tm, x)
    for a, b in zip(t, j):
        assert a.std() > 0.1, "activations collapsed: the comparison would be vacuous"
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * np.abs(b).max())


class _Wrap(fnn.Module):
    """One JAX layer named ``l0_L``, so that its parameter paths translate to
    ``model.0.<...>`` torch names."""

    make: functools.partial

    @fnn.compact
    def __call__(self, x):
        return self.make(name="l0_L")(x, False)


def _seeded_state(layer, seed):
    """A numpy state_dict for ``layer`` (keys ``model.0.<...>``): conv
    weights U(+-1/sqrt(fan_in)), conv biases and BatchNorm statistics and
    affine parameters drawn from seeded ranges away from identity, gamma
    from U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in layer.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            a = np.zeros((), np.int64)
        elif k.endswith("running_var") or k.endswith("gamma"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean") or k.endswith("bias"):
            a = rng.normal(0.0, 0.2, shape)
        elif v.dim() == 4:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            a = rng.uniform(-bound, bound, shape)
        else:  # BatchNorm scale
            a = rng.uniform(0.5, 1.5, shape)
        out[f"model.0.{k}"] = np.asarray(a, np.int64 if a.dtype == np.int64 else np.float32)
    return out


def layer_parity(jax_make, torch_layer, shape_nhwc, dtype=torch.float32, seed=0,
                 input_std=1.0):
    """Run JAX layer ``jax_make(name=...)`` (a partial of a JAX layer class
    with its dtype) and ``torch_layer`` on one seeded input of ``shape_nhwc``
    with the same seeded weights -> the largest difference over the
    largest magnitude of the JAX output (one output, or a tuple's)."""
    sd = _seeded_state(torch_layer, seed)
    holder = torch.nn.Module()
    holder.model = torch.nn.ModuleList([torch_layer])
    load_jax_variables(holder, sd)
    holder.eval()
    jm = _Wrap(jax_make)
    x = np.random.default_rng(seed + 100).normal(0.0, input_std, shape_nhwc).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(xt.float().permute(0, 2, 3, 1).numpy()).astype(jdt)  # the same values
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xj))
    variables, missing = import_state_dict(shapes, sd, detect_layer_idx=99, strict=True)
    assert not missing
    # f32 under jit (one compile, not one an op); bf16 op by op, where each
    # op rounds to bf16 as the port's layers do (under jit XLA may keep a
    # fused intermediate in f32)
    jout = (jm.apply if dtype == torch.bfloat16 else jax.jit(jm.apply))(variables, xj)
    with torch.no_grad():
        tout = torch_layer(xt)
    jout = jout if isinstance(jout, (tuple, list)) else [jout]
    tout = tout if isinstance(tout, (tuple, list)) else [tout]
    err = 0.0
    for a, b in zip(tout, jout):
        assert a.dtype == dtype and b.dtype == jdt
        b = np.asarray(b, np.float32)
        a = a.float().permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape and b.std() > 1e-2
        err = max(err, float(np.abs(a - b).max() / np.abs(b).max()))
    return err


def assert_layer_matches(case, dtype):
    """``case``: (partial of the JAX layer class without its dtype, a
    factory of the port's layer, the NHWC input shape); ``dtype``: a key of
    DTYPES."""
    make, torch_make, shape = case
    tdt, jdt = DTYPES[dtype]
    err = layer_parity(functools.partial(make, dtype=jdt), torch_make(), shape, tdt)
    assert err <= LAYER_TOL[dtype], err


def test_spec_tables_equal_jax():
    assert tyolo.SPECS == jyolo.SPECS
    assert tyolo.SCALES == jyolo.SCALES
    assert tyolo.HEAD_STYLE == jyolo.HEAD_STYLE
    assert tyolo._REPEAT_AS_N == jyolo._REPEAT_AS_N
    assert tfactory.FAMILY_SCALES == jfactory.FAMILY_SCALES


@pytest.mark.parametrize("name", ALL_NAMES)
def test_state_dict_matches_jax_export(name):
    """Keys and shapes equal to the JAX export of the same name, and the
    same Detect index and neck widths."""
    with torch.device("meta"):  # shapes only: no memory, no init
        tm = build_model(name, nc=7)
    jm = jax_build_model(name, nc=7)
    x = jnp.zeros((1, IMG, IMG, 3))
    out, shapes = jax.eval_shape(
        lambda: jm.init_with_output(jax.random.PRNGKey(0), x, train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = export_state_dict(zeros, detect_layer_idx=tm.detect_layer_idx)
    mine = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert mine == {k: tuple(v.shape) for k, v in sd.items()}
    assert tm.detect_layer_idx == len(jm.spec) - 1 == (
        42 if name == "yolov9e" else 21 if name.startswith("yolo12")
        else 23 if name.startswith(("yolov10", "yolo11")) else 22)
    assert tm.neck_channels == tuple(f.shape[-1] for f in out[1])


def test_resolve_model_name_matches_jax():
    """Every (family, scale) pair, the v9 l/x -> c remap included; pairs the
    JAX CLI refuses exit here too."""
    for family in list(jfactory.FAMILY_SCALES) + ["yolov7"]:
        for scale in "nsmblxtceq":
            try:
                want = jfactory.resolve_model_name(family, scale)
            except SystemExit as e:
                with pytest.raises(SystemExit) as got:
                    tfactory.resolve_model_name(family, scale)
                assert str(got.value) == str(e)
                continue
            assert tfactory.resolve_model_name(family, scale) == want
    assert tfactory.resolve_model_name("yolov9", "l") == "yolov9c"


def test_unknown_family_or_size_raises():
    with pytest.raises(ValueError, match="unknown model name"):
        build_model("yolov7n")
    with pytest.raises(ValueError, match="unknown size"):
        build_model("yolo11b")


@pytest.mark.parametrize("name", ALL_NAMES)
def test_stem_route_by_shape(name):
    """Every scale folds its stem, as the JAX model's spec gate does,
    yolo11x/12x (C1 96, C2 192) included, and K4 takes every folded stem's
    widths; yolov9e (layer 0 read later) runs two Conv modules. The route
    comes from the spec alone: the same on a meta tensor as on the CPU."""
    with torch.device("meta"):  # shapes only
        tm = build_model(name, nc=2).eval()
        plain = build_model(name, nc=2, folded_stem=False).eval()
    want = "conv" if name == "yolov9e" else "fused"
    assert tm.stem_route == want
    assert (want == "fused") == tstem.k4_takes(*tm.stem_widths) or name == "yolov9e"
    for device in ("cpu", "meta"):
        assert tm._can_fold_stem(torch.empty(1, 3, IMG, IMG, device=device)) == (want == "fused")
    assert not plain._can_fold_stem(torch.empty(1, 3, IMG, IMG))


def test_k4_range_unchanged():
    """K4's range reaches the x-scale stems of yolo11 and yolo12 (C1 96,
    C2 192) and no further."""
    assert tstem.K4_C1_RANGE == (16, 96) and tstem.K4_C2_RANGE == (32, 192)
    assert tstem.k4_takes(80, 160) and tstem.k4_takes(96, 192)
    assert not tstem.k4_takes(104, 192) and not tstem.k4_takes(96, 200)
    tstem.check_k4_shapes((1, 3, 64, 64), 96, 192)
    with pytest.raises(ValueError, match="K4 takes C1"):
        tstem.check_k4_shapes((1, 3, 64, 64), 104, 208)


@pytest.mark.parametrize("name,fused", [("yolo11n", True), ("yolo12x", True),
                                        ("yolo11x", True), ("yolov9e", False)])
def test_stem_route_taken_by_forward(name, fused, monkeypatch):
    """The forward calls fused_stem exactly on the fused route: the wide
    stems of yolo11x/12x too (K4 on the card), not yolov9e's."""
    calls = []
    real = tyolo.fused_stem
    monkeypatch.setattr(tyolo, "fused_stem", lambda *a, **k: calls.append(1) or real(*a, **k))
    tm = build_model(name, nc=2).eval()
    with torch.no_grad():
        raw, _ = tm(torch.rand(1, 3, 32, 32))
    assert len(calls) == int(fused) and raw[0].shape == (1, 66, 4, 4)


@pytest.mark.parametrize("version,scale,name", [("yolov9", "t", "yolov9t"),
                                                ("yolov10", "n", "yolov10n"),
                                                ("yolo11", "n", "yolo11n"),
                                                ("yolo12", "n", "yolo12n")])
def test_cli_loads_every_family(version, scale, name):
    """The CLI's --model_version / --model build the family's model (OWOD
    task 1's 20 classes) on the CPU, and its predict runs (v9's l/x -> c
    remap: test_resolve_model_name_matches_jax)."""
    from ood_in_object_detection_torch.cli import ood_eval

    args = ood_eval.build_parser().parse_args([
        "--ood_method", "MSP", "--ind_dataset", "x.yaml", "--ood_datasets", "y.yaml",
        "--model_version", version, "--model", scale, "--device", "cpu", "--img_size", "64"])
    det = ood_eval.load_detector(args)
    ref = build_model(name, nc=det.nc)
    assert det.device.type == "cpu" and det.nc == 20
    assert {k: v.shape for k, v in det.model.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    out = det.predict(np.zeros((1, 64, 64, 3), np.uint8), conf_thres=0.0)
    assert out.roi_feats.shape[-1] == max(det.neck_channels())
