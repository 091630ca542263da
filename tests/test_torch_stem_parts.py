"""Port parity for the stem probe ladders (ops/stem_parts.py, the plain
versions of the three kernels behind
ood_in_object_detection_torch/scripts/bench_stem_parts.py) against the
eight ``pl.pallas_call`` sites of scripts/bench_stem_parts{,2,3,4}.py, on
the CPU.

Each script's ``main()`` runs as written at a small size (B, H, W = 2, 40,
16; H = 80 for ladder 2, whose th=80 rung needs it; ladder 3's ``rows``
divided by 400 so that they divide the row count), with two patches:
``timed`` calls each rung's function once on numpy-seeded inputs (the
port's ``make_inputs``, handed to both packages), and ``pl.pallas_call``
runs in interpret mode and records its full output. The scripts' own
return values (sums over a sparse sample that never sees column 1) are
not compared. Copies and shifts must match exactly; GEMM modes within
2^-7 of the output's largest magnitude (one bf16 ulp of h1 or of the
output where an f32 sum taken in another order rounds to the other side).
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ood_in_object_detection_torch.ops import stem_parts as SP
from ood_in_object_detection_torch.scripts import bench_stem_parts as BSP
from torch_threads import _two_threads  # noqa: F401 (autouse)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
SCRIPT = {1: "bench_stem_parts", 2: "bench_stem_parts2", 3: "bench_stem_parts3",
          4: "bench_stem_parts4"}
SIZE = {1: (2, 40, 16), 2: (2, 80, 16), 3: (2, 40, 16), 4: (2, 40, 16)}
GEMM_TOL = 2.0 ** -7


def _load(ladder):
    name = SCRIPT[ladder]
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _to_jax(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def recorded(ladder):
    """-> (the port's inputs, {rung label: the Pallas kernel's full output})."""
    m = _load(ladder)
    b, h, w = SIZE[ladder]
    inputs = BSP.make_inputs(ladder, b, h, w, seed=ladder)
    by_shape = {tuple(t.shape): _to_jax(t) for k, t in inputs.items() if k.startswith("w")}
    z = _to_jax(inputs["z"])
    outputs, current = {}, [None]
    pallas_call = m.pl.pallas_call

    def recording_pallas_call(*args, **kwargs):
        kernel = pallas_call(*args, interpret=True, **kwargs)

        def run(*operands):
            out = kernel(*operands)
            assert current[0] not in outputs, f"{current[0]}: two pallas_calls"
            outputs[current[0]] = np.asarray(out.astype(jnp.float32))
            return out
        return run

    def timed(name, fn, *args, **_):
        current[0] = name
        fn(z, *(by_shape[tuple(a.shape)] for a in args[1:]), jnp.int32(0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m, "B", b)
        mp.setattr(m, "H", h)
        mp.setattr(m, "W", w)
        mp.setattr(m, "timed", timed)
        mp.setattr(m.pl, "pallas_call", recording_pallas_call)
        if ladder == 3:
            mp.setattr(m, "blocked2d", lambda rows, sem, f=m.blocked2d: f(rows // 400, sem))
            mp.setattr(m, "dense128", lambda rows, f=m.dense128: f(rows // 400))
        m.main()
    return inputs, outputs


def pallas_rungs(ladder):
    return [r.name for r in BSP.RUNGS if r.ladder == ladder and r.kind != "library"]


def check_rung(ladder, name):
    inputs, outputs = recorded(ladder)
    rung = next(r for r in BSP.RUNGS if r.ladder == ladder and r.name == name)
    ref = outputs[name]
    got = BSP.call(rung, inputs).float().numpy()   # CPU tensors: the plain versions
    assert got.shape == ref.shape
    if rung.kind == "mm":
        err = np.abs(got - ref).max()
        assert err <= GEMM_TOL * np.abs(ref).max(), (err, np.abs(ref).max())
        assert np.abs(ref).max() > 0
    else:
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, BSP.call(rung, inputs, plain=True).float().numpy())


@pytest.mark.parametrize("ladder", [1, 2, 3, 4])
def test_every_pallas_rung_of_main_is_ported(ladder):
    """The port's rung table holds exactly the rungs whose kernels main()
    launches (26: 5 + 8 + 7 + 6)."""
    assert sorted(recorded(ladder)[1]) == sorted(pallas_rungs(ladder))


@pytest.mark.parametrize("name", pallas_rungs(1))
def test_ladder1_bench_stem_parts_matches_jax(name):
    check_rung(1, name)


@pytest.mark.parametrize("name", pallas_rungs(2))
def test_ladder2_bench_stem_parts2_matches_jax(name):
    check_rung(2, name)


@pytest.mark.parametrize("name", pallas_rungs(3))
def test_ladder3_bench_stem_parts3_matches_jax(name):
    check_rung(3, name)


@pytest.mark.parametrize("name", pallas_rungs(4))
def test_ladder4_bench_stem_parts4_matches_jax(name):
    check_rung(4, name)


def test_bitcast_roll_is_a_two_pixel_shift():
    """shift_bench('bitcast_roll') bitcasts pairs of bf16 rows into one int32
    row, so its roll by 1 moves two pixels: it equals the port's shift 2
    exactly and is not the one-pixel shift of the other two modes."""
    inputs, outputs = recorded(2)
    zt = inputs["zt20"]
    got = outputs["tiled + shift bitcast_roll"]
    np.testing.assert_array_equal(got, SP.shift_add_plain(zt, 2).float().numpy())
    one = SP.shift_add_plain(zt, 1).float().numpy()
    np.testing.assert_array_equal(outputs["tiled + shift concat"], one)
    assert np.abs(got - one).max() > 1.0
    # at column 1 the two-pixel shift reads the last pixel of the row above
    zf = zt.float()
    want = (zf[:, 3, 1, :32] + zf[:, 2, -1, :32]).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[:, 1, 1], want)


def test_tile_windows_matches_jnp_stack():
    z = BSP.make_inputs(2, 2, 40, 8, seed=3)["z"]
    zj = _to_jax(z)
    ref = jnp.stack([zj[:, k * 20:k * 20 + 22] for k in range(2)], 1).reshape(4, 22, 8, 48)
    np.testing.assert_array_equal(BSP.tile_windows(z, 20).float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    z = torch.zeros(1, 6, 4, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        SP.window_copy(z, row0=6)
    with pytest.raises(ValueError):
        SP.shift_add(z, 3)
    with pytest.raises(ValueError):
        SP.stem_gemm(z, {"w48": torch.zeros(48, 64, dtype=torch.bfloat16)}, "mm")
    with pytest.raises(ValueError):
        SP.stem_gemm(z, {}, "conv")


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    inputs = BSP.make_inputs(1, 1, 4, 8, seed=1)
    before = (SP.window_copy.launches, SP.shift_add.launches, SP.stem_gemm.launches)
    SP.window_copy(inputs["z"])
    SP.shift_add(inputs["z"], 1)
    for mode in SP.GEMM_MODES:
        SP.stem_gemm(inputs["z"], inputs, mode)
    assert (SP.window_copy.launches, SP.shift_add.launches, SP.stem_gemm.launches) == before


def test_entry_point_runs_every_rung_on_the_cpu(capsys):
    records = BSP.main(["--device", "cpu", "--batch", "1", "--height", "40", "--width", "8"])
    assert [r["rung"] for r in records] == [r.name for r in BSP.RUNGS] + ["yardstick"]
    # host times only: no device time, rate or bound from a CPU run
    assert all("ms" not in r and "bound_ms" not in r and "gb_per_s" not in r for r in records)
    assert len(capsys.readouterr().out.strip().splitlines()) == len(BSP.RUNGS) + 1


# csrc/stem_parts_mm.cu on the CPU: its weight images, its operand map and
# its schedule (the kernel itself runs only on the card,
# tests/test_torch_kernels_cuda.py)

MM_SOURCE = Path(SP.__file__).resolve().parents[1] / "csrc" / "stem_parts_mm.cu"
FULL_MODES = ("halo_full_noshift", "halo_full")


@pytest.mark.parametrize("name", sorted(SP.GEMM_IMAGE_SHAPES))
def test_gemm_weight_packer_inverts_exactly(name):
    w = BSP.make_inputs(4, 1, 4, 8, seed=5)[name]
    image = SP.pack_gemm_weight(w, name)
    k, n = SP.GEMM_IMAGE_SHAPES[name]
    assert image.shape == (k * n,)
    # every row the kernel reads; w1's rows 120:128 face the Pallas union's
    # zero lanes, no K row reads them, and they come back as zeros
    read = sorted(r for r in SP.W1_KERNEL_ROWS if r >= 0) if name == "w1" else list(range(k))
    back = SP.unpack_gemm_weight(image, name)
    assert torch.equal(back[read], w[read])
    assert not back[[r for r in range(back.shape[0]) if r not in read]].any()


def test_w1_kernel_order_zeroes_channels_32_to_36_of_the_prev_taps():
    w1 = BSP.make_inputs(1, 1, 4, 8, seed=2)["w1"]
    kernel = SP.pack_gemm_weight(w1, "w1")[SP.gemm_image_offsets(128, 64)]
    assert torch.equal(kernel[:96], w1[:96])
    for first, src in ((96, 96), (112, 108)):   # prev[32:48], zx_prev[32:48]
        assert not kernel[first:first + 4].any()
        assert torch.equal(kernel[first + 4:first + 16], w1[src:src + 12])


def _silu(v):
    """The kernel's SiLU, h + h tanh(h) with h = v / 2 (tanh.approx on the card)."""
    h = 0.5 * v
    return h + h * torch.tanh(h)


def _image_matrix(weights, name, rows, cols):
    """The (rows, cols) B operand the kernel's descriptors read from an image:
    kernel K row k is image row k % (the image's rows)."""
    k, n = SP.GEMM_IMAGE_SHAPES[name]
    m = SP.pack_gemm_weight(weights[name], name)[SP.gemm_image_offsets(k, n)].float()
    return m[torch.arange(rows) % k][:, :cols]


def emulate_stem_gemm(z, weights, mode):
    """The kernel's arithmetic on the CPU: z zero-filled at column -1, past
    the last 64-pixel strip and above row 0 (TMA's fill), the first operand
    gathered chunk by chunk from :func:`SP.gemm_chunks`, B read from the
    packed images, h1 = bf16(silu(.)), the full modes' v as two copies of h1
    times w2's two halves plus h1_prev (the row above) times the other two."""
    names = SP.GEMM_WEIGHTS[mode]
    halo, full = mode.startswith("halo"), mode in FULL_MODES
    pad, extra = (2 if halo else 0), (1 if full else 0)
    b, hin, w, _ = z.shape
    hout, wp = hin + pad - 2, -(-w // SP.GEMM_STRIP) * SP.GEMM_STRIP
    zf = F.pad(z.float(), (0, 0, 1, wp - w, 2, 0))     # rows -2, -1; columns -1 and past W
    hy = torch.arange(-extra, hout)                     # the h1 rows computed

    def tap(dr, sh, ch):
        return zf[:, hy + dr - pad + 2, 1 - sh:1 - sh + wp, ch:ch + 8]

    chunks = SP.gemm_chunks(mode)
    if mode == "mm_shift":
        a = torch.cat([(tap(*c) + tap(c[0], 1, c[2])).bfloat16().float() for c in chunks], -1)
    else:
        a = torch.cat([tap(*c) for c in chunks], -1)
    n1 = 32 if mode in ("halo_mm_pad", "halo_mm_concat") else 64
    h1 = _silu(a @ _image_matrix(weights, names[0], a.shape[-1], n1)).bfloat16().float()
    if len(names) == 1:
        out = h1
    elif not full:
        out = _silu(h1 @ _image_matrix(weights, names[1], 64, SP.COUT))
    else:
        w2 = _image_matrix(weights, "w2", 192, SP.COUT)
        cur, prv = h1[:, 1:], h1[:, :-1, ..., 32:64]
        out = _silu(cur @ w2[:64] + cur @ w2[64:128] + prv @ w2[128:160] + prv @ w2[160:])
    return out[:, :, :w].bfloat16()


@pytest.mark.parametrize("mode", SP.GEMM_MODES)
@pytest.mark.parametrize("b,h,w", [(1, 7, 13), (1, 45, 37), (2, 41, 160)])
def test_kernel_operand_map_emulation_matches_plain(mode, b, h, w):
    """Within 2^-7 of the output's scale, as the kernel is held on the card:
    the emulation sums in another order and takes SiLU through tanh."""
    inputs = BSP.make_inputs(4 if mode.startswith("halo") else 1, b, h, w, seed=b * h + w)
    got = emulate_stem_gemm(inputs["z"], inputs, mode).float()
    ref = SP.stem_gemm_plain(inputs["z"], inputs, mode).float()
    assert got.shape == ref.shape == (b, h, w, SP.COUT)
    scale = float(ref.abs().max())
    assert scale > 0 and float((got - ref).abs().max()) <= GEMM_TOL * scale


@pytest.mark.parametrize("mode", SP.GEMM_MODES)
@pytest.mark.parametrize("b,h,w,rows", [(2, 41, 160, 40), (1, 45, 37, 40), (3, 7, 13, 40),
                                        (128, 160, 160, 40), (2, 41, 65, 7)])
def test_gemm_plan_covers_every_output_pixel_once(mode, b, h, w, rows):
    halo, full = mode.startswith("halo"), mode in FULL_MODES
    hin = h if halo else h + 2
    plan = SP.gemm_plan(mode, b, hin, w, rows)
    lo = min(c[0] for c in SP.gemm_chunks(mode))
    seen = torch.zeros(b, h, w, dtype=torch.int32)
    for mine in plan:
        assert mine, "a warpgroup without work is not launched"
        for it in mine:
            assert it["h_rows"] == (it["y0"] - (1 if full else 0), it["y1"])
            pad = 2 if halo else 0
            assert it["z_rows"] == (it["h_rows"][0] + lo - pad, it["y1"] + 2 - pad)
            seen[it["b"], it["y0"]:it["y1"], it["x0"]:it["x0"] + SP.GEMM_STRIP] += 1
    assert int(seen.min()) == int(seen.max()) == 1
    counts = [len(mine) for mine in plan]
    assert max(counts) - min(counts) <= 1
    assert len(plan) <= 132 * SP.GEMM_WARPGROUPS


def test_gemm_constants_match_the_source():
    src = MM_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kStrip"), const("kWG"), const("kStages")) == (
        SP.GEMM_STRIP, SP.GEMM_WARPGROUPS, SP.GEMM_STAGES)
    cin, cout = map(int, re.search(r"constexpr int kCin = (\d+), kCout = (\d+);", src).groups())
    assert (cin, cout) == (SP.CIN, SP.COUT)
    # every chunk is one 16-byte ldmatrix row inside a pixel of the 48-channel TMA box
    for mode in SP.GEMM_MODES:
        assert all(ch % 8 == 0 and ch + 8 <= cin for _, _, ch in SP.gemm_chunks(mode))
    # the descriptors' byte offsets: the two 8-row halves of a k-step, then
    # the 8-column groups, of the packer's layout
    lbo, sbo = map(int, re.search(r"constexpr int kLBO = (\d+), kSBO = (\d+);", src).groups())
    off = SP.gemm_image_offsets(16, 64)
    assert (2 * int(off[8, 0]), 2 * int(off[0, 8])) == (lbo, sbo)
    assert 2 * int(SP.gemm_image_offsets(32, 64)[16, 0]) == 16 * 64 * 2  # a k-step of w1's image
