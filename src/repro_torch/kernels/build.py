"""Build the CUDA kernels from kernels/csrc at first use and bind them.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``:
one object per source, all compiled at once, linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library goes
to ``build/repro_torch_kernels/`` at the root of the checkout, named by a
digest of the sources and flags, so a changed source builds anew and an
unchanged one loads at once.  Nothing is built when a module is imported:
the CPU never needs the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "library", "build", "dtype_code", "stream_of",
           "check_launch", "last_build_seconds", "packed_rows_fit", "aligned"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every launcher returns cudaGetLastError() after its launch
_SIGNATURES = {
    # x, dtype, M, K, keep, norm scale, eps, mask, values, indices, dense,
    # normed, stream
    "tenet_das_topk": [_P, _I, _I, _I, _I, _P, _F, _P, _P, _P, _P, _P, _P],
    # values, dtype, indices, packed, w_scale, out, M, Kc, keep, block, R, N,
    # stream
    "tenet_das_ternary_gemm": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
    # x, dtype, packed, w_scale, x_scale, out, M, K, R, N, stream
    "tenet_ternary_gemm": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, q_pos, k_pos, out, dtype, kv dtype, B, Lq, Lk, Hq, Hkv, D,
    # sink, window, softcap, scale, round_scores, stream
    "tenet_sparse_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _F, _I, _P],
    # packed, out, R, K, N, stream
    "tenet_twd_decode": [_P, _P, _I, _I, _I, _P],
    # values, dtype, indices (or null), trits, w_scale, out, M, Kc, keep,
    # block, K, N, stream
    "tenet_das_gemv": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda"
                       "/bin): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels unless a library of these sources exists.

    ``verbose`` prints what ``-Xptxas -v`` reports (registers, shared
    memory, spills) for every kernel."""
    global _build_seconds
    so = BUILD_DIR / f"libtenet_kernels_{_digest()}.so"
    if so.exists():
        return so
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}{err}")
            elif verbose and (out or err):
                print(f"[build] {src.name}\n{out}{err}", flush=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / so.name
        link = [nvcc, *ARCH_FLAGS, "-shared", *(str(o) for _, o, _ in jobs),
                "-o", str(tmp_so)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, so)   # atomic: concurrent builds agree
    _build_seconds = time.perf_counter() - t0
    return so


def last_build_seconds() -> float | None:
    """Seconds the last build in this process took (None: nothing built)."""
    return _build_seconds


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# the GEMM core's decode class (csrc/common.cuh): M <= 4 rows, K in windows
# of 32 packed rows (groups of 5 lanes), at most 8 windows a block and 16
# blocks (one cluster) a column tile
WIN_ROWS, DECODE_ROWS = 32, 4
DECODE_MAX_ROWS = WIN_ROWS * 8 * 16


def packed_rows_fit(m: int, r: int) -> bool:
    """Whether the GEMM core takes R = r packed rows (or ceil(K / 5) groups
    of int8 trit rows) for M = m rows: any R above the decode class, R <=
    4096 (K <= 20480) within it."""
    return m > DECODE_ROWS or r <= DECODE_MAX_ROWS


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data is not 16-byte aligned: the kernels'
    vector loads and copies need it, and the route a call takes depends on
    its shapes only, never on where a tensor happens to start."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPE_CODES[t.dtype]


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
