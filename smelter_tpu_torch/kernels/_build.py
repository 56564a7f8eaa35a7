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
               torch.int32: 3, torch.int8: 4}

# name -> the C entry point's argument types (pointers and the stream are
# c_void_p, so ctypes never cuts them to 32 bits).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "dequant_matmul": ("smelter_dequant_matmul", [_P] * 4 + [_I] * 10 + [_P]),
    "int8_matmul": ("smelter_int8_matmul", [_P] * 5 + [_I] * 8 + [_P]),
    "int8_matmul_fused": ("smelter_int8_matmul_fused", [_P] * 5 + [_I] * 11 + [_P]),
    "int4_matmul": ("smelter_int4_matmul", [_P] * 6 + [_I] * 9 + [_P]),
    "paged_decode_attention": ("smelter_paged_decode_attention",
                               [_P] * 9 + [_I] * 9 + [_F, _I, _I, _I, _P]),
    "ragged_decode_attention": ("smelter_ragged_decode_attention",
                                [_P] * 8 + [_I] * 7 + [_F, _I, _I, _I, _P]),
    "layer_norm": ("smelter_layer_norm", [_P] * 6 + [_I, _I, _F, _I, _I, _P]),
    "vit_block": ("smelter_vit_block", [_P] * 13 + [_I] * 7 + [_F] * 3 + [_I] * 10 + [_P]),
    "pixel_conv": ("smelter_pixel_conv",
                   [_P] * 5 + [_I] * 5 + [_L] * 6 + [_I] * 3 + [_F, _I, _F] + [_I] * 6 + [_P]),
    "max_unpool": ("smelter_max_unpool2x2", [_P] * 3 + [_I] * 3 + [_P]),
    "flash_attention": ("smelter_flash_attention", [_P] * 4 + [_I] * 17 + [_F, _I, _I, _P]),
    "attention_short": ("smelter_short_attention",
                        [_P] * 4 + [_I] * 16 + [_F] + [_I] * 5 + [_P]),
    "mlp_block": ("smelter_mlp_block", [_P] * 10 + [_I] * 6 + [_F] + [_I] * 6 + [_P]),
    "convnext_block": ("smelter_convnext_block",
                       [_P] * 13 + [_I] * 5 + [_F, _I, _I] + [_I] * 4 + [_P]),
    "cross_attn_block": ("smelter_cross_attn_block", [_P] * 7 + [_I] * 6 + [_F] + [_I] * 3 + [_P]),
    "qlinear_conv": ("smelter_qlinear_conv", [_P] * 5 + [_I] * 18 + [_P]),
    "int8_join": ("smelter_int8_join", [_P] * 3 + [_L] + [_F] * 3 + [_I] * 2 + [_P]),
    "dequant_conv": ("smelter_dequant_conv", [_P] * 4 + [_I] * 15 + [_P]),
    "collective_matmul": ("smelter_collective_matmul", [_P] * 4 + [_I] * 11 + [_P]),
    "ring_attention": ("smelter_ring_attention_step", [_P] * 7 + [_I] * 4 + [_F] + [_I] * 3 + [_P]),
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
    """Where kernel `name` is built: named by a hash of its source, of
    every header under csrc/ (so an edited header never loads a stale
    library) and of the flags."""
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
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


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary (what a TMA
    tensor map needs of its base)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


_sms: dict = {}


def sms(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once a device."""
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def vmapped(*tensors) -> bool:
    """Whether any operand is a tensor batched by `torch.func.vmap`: a
    wrapper then calls its custom op, whose vmap rule folds the batch into
    one launch; otherwise it calls the kernel directly. The custom op's
    dispatch costs the host about 51 us a call, more than the launch itself
    (`experiments/torch_custom_op_cost.py` on an H100 host: 92 against 41
    us, about 9 ms on an eager llama_1b decode step's 169 int4 calls)."""
    return any(isinstance(t, torch.Tensor) and torch._C._functorch.is_batchedtensor(t)
               for t in tensors)
