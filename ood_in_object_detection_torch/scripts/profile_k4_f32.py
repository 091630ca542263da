"""Where K4's f32 kernel spends its cycles, per phase, on the card.

    python -m ood_in_object_detection_torch.scripts.profile_k4_f32

Builds a copy of ``csrc/fused_stem.cu`` with five ``clock64()`` probes in
``fused_stem_f32_kernel`` (thread 0 of every block: start, image patch
staged, conv1 tile done, conv2 done, output stored), runs it at yolov8l's
stem (C1 64, C2 128) on (8, 3, 640, 640) seeded images and prints one JSON
line: the kernel's time (CUDA events) and the mean, 10th and 90th
percentile of each phase's cycles per block. The sum of all blocks' cycles
over the SMs, against the kernel's time in cycles, says how many blocks ran
at once. The probes anchor on the source's own lines; the script raises if
one is not found (the kernel changed): update the anchors with it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import stem as S
from ..ops.kernels import _build
from .bench_k1_k4 import cuda_ms, stem_params

PHASES = ("patch", "conv1", "conv2", "epilogue")
_PROBES = [  # (anchor in fused_stem_f32_kernel, probe inserted after it)
    ("  const int ry0 = 2 * oy0 - 1, rx0 = 2 * ox0 - 1;  // conv1 origin of the tile\n",
     "  long long* pr_ = g_prof + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 5;\n"
     "  if (tid == 0) pr_[0] = clock64();\n"),
    ("    cp_async_wait_all();\n    __syncthreads();\n  }\n\n  // conv1 + BN + SiLU -> h1",
     "\n  if (tid == 0) pr_[1] = clock64();\n"),
    ("  __syncthreads();  // h1 complete; the patch and w1 are dead\n",
     "  if (tid == 0) pr_[2] = clock64();\n"),
    ("    __syncthreads();  // every thread is done with chunk q's buffer\n  }\n",
     "  if (tid == 0) pr_[3] = clock64();\n"),
    ("      if (oy0 + p < H4) ocol[static_cast<size_t>(oy0 + p) * W4] = "
     "silu_fast(acc[p][j] + bias);\n  }\n", "  if (tid == 0) pr_[4] = clock64();\n"),
]


def instrumented_source(max_blocks: int) -> str:
    src = (_build.CSRC_DIR / "fused_stem.cu").read_text()
    kernel = src.index("fused_stem_f32_kernel(")
    head, body = src[:kernel], src[kernel:]
    for anchor, probe in _PROBES:
        if body.count(anchor) != 1:
            raise RuntimeError(f"profile_k4_f32: anchor not found once in the f32 kernel: "
                               f"{anchor!r}")
        if anchor.endswith("-> h1"):  # the probe goes before the comment line
            body = body.replace(anchor, anchor[:-len("\n\n  // conv1 + BN + SiLU -> h1")] + probe
                                + "\n  // conv1 + BN + SiLU -> h1")
        else:
            body = body.replace(anchor, anchor + probe)
    decl = head.rindex("template <")  # the kernel's template head
    head = head[:decl] + f"__device__ long long g_prof[{max_blocks} * 5];\n" + head[decl:]
    return head + body + (
        '\nextern "C" int profile_read(long long* host, int n) {\n'
        "  return static_cast<int>(\n"
        "      cudaMemcpyFromSymbol(host, g_prof, sizeof(long long) * n));\n}\n")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_k4_f32: needs a CUDA card")
    b, h, w, c1, c2 = 8, 640, 640, 64, 128
    blocks = b * ((h // 4 + 7) // 8) * ((w // 4 + 7) // 8)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "fused_stem_f32_profile.cu"
    lib_path = _build.BUILD_DIR / "fused_stem_f32_profile.so"
    src.write_text(instrumented_source(blocks))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fused_stem_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P, P]
    lib.fused_stem_launch.restype = I
    lib.profile_read.argtypes = [P, I]
    lib.profile_read.restype = I

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    w1, bn1, w2, bn2 = stem_params(rng, c1, c2, dev)
    x = torch.tensor(rng.uniform(0, 1, (b, 3, h, w)), dtype=torch.float32, device=dev)
    ops = S.k4_operands(w1, bn1, w2, bn2, torch.float32)
    out = torch.empty((b, c2, h // 4, w // 4), device=dev)

    def call():
        code = lib.fused_stem_launch(x.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(),
                                     ops[2].data_ptr(), ops[3].data_ptr(), b, h, w, c1, c2, 0,
                                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")

    ms = cuda_ms(call, 20)
    call()
    torch.cuda.synchronize()
    buf = np.zeros(blocks * 5, np.int64)
    if lib.profile_read(buf.ctypes.data, buf.size):
        raise RuntimeError("profile_read failed")
    t = buf.reshape(blocks, 5).astype(np.float64)
    d = np.diff(t, axis=1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), shape=[b, 3, h, w], c1=c1, c2=c2, kernel_ms=ms,
        cycles_per_block={n: dict(mean=float(d[:, i].mean()), p10=float(np.percentile(d[:, i], 10)),
                                  p90=float(np.percentile(d[:, i], 90)))
                          for i, n in enumerate(PHASES)},
        block_cycles_mean=float((t[:, 4] - t[:, 0]).mean()),
        block_cycles_per_sm=float((t[:, 4] - t[:, 0]).sum()) / sms)), flush=True)


if __name__ == "__main__":
    main()
