"""Build the port's CUDA kernels on first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/<name>-<hash>.so`` at the
repository root. The hash covers the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here runs
at import time: the CPU tests import every module of the port without nvcc.

Launch convention (shared by the kernel wrappers): the C function
enqueues its kernels on the stream it is given, allocates nothing, and
returns ``cudaGetLastError()``; :func:`check_launch` raises on a non-zero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (entry point, argtypes); every entry point returns a cudaError_t
KERNELS = {
    "nms_keep": ("nms_keep_launch", [P, P, F, I, I, P, P, P]),
    "roi_contract": ("roi_contract_launch", [P, P, P, I, I, I, I, I, I, I, P, P]),
    "min_group_distance": ("min_group_distance_launch", [P, P, P, I, I, I, I, I, I, I, P, P]),
    "fused_stem": ("fused_stem_launch", [P, P, P, P, P, I, I, I, I, I, I, P, P]),
    "stem_parts_copy": ("stem_parts_copy_launch", [P, P, I, I, I, I, I, I, I, P]),
    "stem_parts_shift": ("stem_parts_shift_launch", [P, P, I, I, I, I, I, I, P]),
    "stem_parts_mm": ("stem_parts_mm_launch", [P, P, P, I, I, I, I, I, P, P]),
}

_LIBS: dict = {}
_BUILDS: list = []
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed (set CUDA_HOME)")
    return found


def _compile(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)
    _BUILDS.append({"name": name, "seconds": round(seconds, 3), "cmd": " ".join(cmd)})
    print(f"[torch_kernels] built {name} in {seconds:.2f} s: {' '.join(cmd)}\n"
          f"{proc.stderr.strip()}", file=sys.stderr, flush=True)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            entry, argtypes = KERNELS[name]
            lib = ctypes.CDLL(str(_compile(name)))
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launcher(name: str):
    """The C entry point of kernel ``name`` (argtypes and restype declared)."""
    return getattr(library(name), KERNELS[name][0])


def check_launch(name: str, code: int) -> None:
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code} ({msg})")


def build_all() -> list:
    """Build every kernel, one nvcc process per source, all started
    together, then load them; -> one record per kernel compiled by this call
    ({name, seconds, cmd}); kernels already built are not listed."""
    from concurrent.futures import ThreadPoolExecutor

    start = len(_BUILDS)
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(_compile, KERNELS))
    for name in KERNELS:
        library(name)
    return list(_BUILDS[start:])


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``.
    ``torch._C._cuda_getCurrentRawStream`` (the getter Triton's launcher
    uses) takes 0.3 us on the host; building the ``torch.cuda.Stream``
    object takes ~10 us, more than some of the kernels it launches."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def count_launch(wrapper, attr: str = "launches", device=None) -> None:
    """Add one to a kernel wrapper's launch counter ``wrapper.<attr>`` and,
    given a card index, to ``wrapper.<attr>_by_device[device]``, under a
    lock: the shards of an ``sp`` group launch from several threads
    (parallel/spatial.py), and ``+=`` on an attribute is no atomic step."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
        if device is not None:
            getattr(wrapper, attr + "_by_device")[device] += 1


def require_cuda(name: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel needs CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
