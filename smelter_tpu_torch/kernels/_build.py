"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). Libraries go to `build/smelter_tpu_torch/` at the root of
the checkout, named by a hash of their sources and flags, and are built at
first use. `build()` starts one `nvcc` per source, all at once, and waits
for them together.

Nothing here runs at import time: the CPU tests import every module, and a
machine without `nvcc` never reaches this code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "smelter_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Element-type codes of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int32: 3}

# name -> the C entry point's argument types (pointers and the stream are
# c_void_p, so ctypes never cuts them to 32 bits).
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "dequant_matmul": ("smelter_dequant_matmul",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "int8_matmul": ("smelter_int8_matmul",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for p in (src, CSRC / "common.cuh"):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, all
    `nvcc` processes at once. Returns each built kernel's compiler log
    (`-Xptxas -v`: registers, shared memory, spills)."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.smelter_error_string.argtypes = [ctypes.c_int]
            lib.smelter_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.smelter_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}): {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
