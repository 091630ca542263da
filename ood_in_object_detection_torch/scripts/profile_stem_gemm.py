"""Where the stem ladder's GEMM kernel spends its cycles, per phase of a row, on the card.

    python -m ood_in_object_detection_torch.scripts.profile_stem_gemm [--modes halo_full,mm,...]

Builds ``csrc/stem_parts_mm.cu`` a second time with ``-DSTEM_PARTS_MM_PROBE=1``:
thread 0 of each warpgroup then sums ``clock64()`` deltas per phase of its
row steps (waiting for the ring, building the operand, the first product,
the ring's release, SiLU and the second product, the output row). For each
mode, on the ladder's inputs (``bench_stem_parts.make_inputs`` at B, H, W =
128, 160, 160), it holds the probe build's output against the plain version
within 2^-7 of its scale, times the kernel (its C entry point on weights
packed once) with and without probes in turns (CUDA events, mean of 20
launches after 3), and reads the cycles of one more launch. One JSON line
per mode, with the card's name. It raises without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import List, Optional

import torch

from ..ops import stem_parts as SP
from ..ops.kernels import _build
from .bench_stem_parts import make_inputs, timer

# the probe build's phases of a warpgroup's row step (csrc/stem_parts_mm.cu, Probe)
PHASES = ("wait", "operand", "product1", "release", "silu_product2", "output")


def build_probe():
    """The probe build's C entry point and its reader of the sums."""
    src = _build.CSRC_DIR / "stem_parts_mm.cu"
    lib_path = _build.BUILD_DIR / "stem_parts_mm_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DSTEM_PARTS_MM_PROBE=1",
                           "-o", str(lib_path), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the probe build:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    entry, argtypes = _build.KERNELS["stem_parts_mm"]
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.stem_parts_mm_probe.argtypes, lib.stem_parts_mm_probe.restype = [ctypes.c_void_p], ctypes.c_int
    return fn, lib.stem_parts_mm_probe


def probe_sums(read) -> list:
    """The sums since the last read: cycles per phase, then row steps."""
    sums = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    if read(ctypes.addressof(sums)) != 0:
        raise RuntimeError("profile_stem_gemm: reading the probes failed")
    return list(sums)


def launch(fn, z, images, mode: str) -> torch.Tensor:
    b, hin, w, _ = z.shape
    hout = hin if mode.startswith("halo") else hin - 2
    out = torch.empty((b, hout, w, SP.COUT), dtype=z.dtype, device=z.device)
    code = fn(z.data_ptr(), images[0].data_ptr(),
              0 if len(images) == 1 else images[1].data_ptr(), SP.GEMM_MODES.index(mode), b,
              hin, w, SP.GEMM_ROWS_PER_ITEM, out.data_ptr(), _build.stream_handle(z.device))
    if code != 0:
        raise RuntimeError(f"profile_stem_gemm: launch failed with error {code}")
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser("profile_stem_gemm", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--modes", default=",".join(SP.GEMM_MODES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_stem_gemm: needs a CUDA card")
    probed, read = build_probe()
    plain_build = _build.launcher("stem_parts_mm")
    device = torch.device("cuda")
    ms_of = timer(device)
    records = []
    with torch.no_grad():
        for mode in args.modes.split(","):
            inputs = make_inputs(4 if mode.startswith("halo") else 1, 128, 160, 160,
                                 device=device)
            images = [SP.pack_gemm_weight(inputs[k], k) for k in SP.GEMM_WEIGHTS[mode]]
            ref = SP.stem_gemm_plain(inputs["z"], inputs, mode).float()
            scale = float(ref.abs().max())
            err = float((launch(probed, inputs["z"], images, mode).float() - ref).abs().max())
            if err > 2.0 ** -7 * scale:
                raise AssertionError(f"profile_stem_gemm {mode}: err {err} (scale {scale})")
            ms, probe_ms = [], []
            for _ in range(2):
                ms.append(ms_of(lambda: launch(plain_build, inputs["z"], images, mode)))
                probe_ms.append(ms_of(lambda: launch(probed, inputs["z"], images, mode)))
            probe_sums(read)
            launch(probed, inputs["z"], images, mode)
            torch.cuda.synchronize()
            sums = probe_sums(read)
            steps = max(sums[-1], 1)
            rec = dict(device=torch.cuda.get_device_name(0), mode=mode, ms=ms, probe_ms=probe_ms,
                       max_abs_err=err, row_steps=sums[-1],
                       cycles_per_row_step={ph: sums[k] / steps for k, ph in enumerate(PHASES)})
            print(json.dumps(rec), flush=True)
            records.append(rec)
            del inputs, ref
    return records


if __name__ == "__main__":
    main()
