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
from typing import NamedTuple

import torch

__all__ = ["BUILD_DIR", "library", "build", "dtype_code", "stream_of",
           "check_launch", "last_build_seconds", "packed_rows_fit", "aligned",
           "windows", "dec_subs", "mma_parts", "das_mma_route", "dense_mma_route",
           "LaunchConfig", "gemm_class", "builtin_config", "launch_configs",
           "check_launch_config"]

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
    # subs, parts, stream
    "tenet_das_ternary_gemm": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P],
    # x, dtype, packed, w_scale, x_scale, out, M, K, R, N, subs, parts, stream
    "tenet_ternary_gemm": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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


# The GEMM core's launch structure (csrc/common.cuh), the one Python mirror
# of it: the wrappers check a launch config against it and the cost model
# (core/perfmodel.py) prices it.  Decode class: M <= 4 rows, K in windows of
# 32 packed rows (groups of 5 lanes), ``subs`` windows a block (1, 2, 4, 8),
# 128 columns a block, a column tile's blocks one cluster of at most 16.
# Prefill class: 64 x 64 tiles, on the bf16 tensor-core route split over
# ``parts`` K parts a cluster (at most 8); float32 and int8 rows take the
# FMA route, which has no knob.
WIN_ROWS, DECODE_ROWS = 32, 4
DEC_COLS, MAX_CLUSTER = 128, 16
DEC_MAX_SUBS, DEC_MAX_BLOCKS = 8, 330
MAX_PARTS = 8
DECODE_MAX_ROWS = WIN_ROWS * DEC_MAX_SUBS * MAX_CLUSTER
WIN_LANES = 5 * WIN_ROWS         # a K window's lanes


def packed_rows_fit(m: int, r: int) -> bool:
    """Whether the GEMM core takes R = r packed rows (or ceil(K / 5) groups
    of int8 trit rows) for M = m rows: any R above the decode class, R <=
    4096 (K <= 20480) within it."""
    return m > DECODE_ROWS or r <= DECODE_MAX_ROWS


def windows(packed_rows: int) -> int:
    """K windows of 32 packed rows (common.cuh ``windows``)."""
    return -(-packed_rows // WIN_ROWS)


def dec_subs(packed_rows: int, n: int) -> int:
    """The decode class's built-in windows a block (common.cuh ``dec_subs``):
    the fewest of 1, 2, 4, 8 that keep a column tile's blocks in one cluster
    and the grid within 330 blocks."""
    tiles = -(-n // DEC_COLS)
    subs = 1
    while subs < DEC_MAX_SUBS:
        s = -(-windows(packed_rows) // subs)
        if s <= MAX_CLUSTER and tiles * s <= DEC_MAX_BLOCKS:
            break
        subs *= 2
    return subs


def mma_parts(packed_rows: int) -> int:
    """The tensor-core prefill's built-in K parts a cluster (common.cuh
    ``mma_parts``): about 8 windows a part, at most 8 parts."""
    return max(1, min(MAX_PARTS, (windows(packed_rows) + 7) // 8))


def das_mma_route(dtype: torch.dtype, kc: int, keep: int, block: int, n: int) -> bool:
    """Whether das_ternary_gemm's prefill class takes the tensor-core route
    (das_gemm.cu): bf16 values, Kc and a window's entries multiples of 8, N
    of 4."""
    return (dtype == torch.bfloat16 and kc % 8 == 0
            and (WIN_LANES // block * keep) % 8 == 0 and n % 4 == 0)


def dense_mma_route(dtype: torch.dtype, k: int, n: int) -> bool:
    """Whether ternary_gemm's prefill class takes the tensor-core route
    (ternary_gemm.cu): bf16 rows, K and N multiples of 4."""
    return dtype == torch.bfloat16 and k % 4 == 0 and n % 4 == 0


class LaunchConfig(NamedTuple):
    """A packed GEMM's launch config: ``subs``, the decode class's windows
    a block, or ``parts``, the tensor-core prefill's K parts a cluster; 0 =
    the kernel's built-in choice (``dec_subs`` / ``mma_parts``).  Either
    changes the order of a row's sums, so a config is chosen by (K, N,
    dtype, DAS, class) alone, never by M within a class."""
    subs: int = 0
    parts: int = 0


DEFAULT_CONFIG = LaunchConfig()


def gemm_class(m: int) -> str:
    """The GEMM core's class of M rows: "decode" (M <= 4) or "prefill"."""
    return "decode" if m <= DECODE_ROWS else "prefill"


def builtin_config(m: int, r: int, n: int, mma: bool) -> LaunchConfig:
    """The explicit config the kernel picks for itself (DEFAULT_CONFIG on
    the FMA prefill, which has no knob)."""
    if gemm_class(m) == "decode":
        return LaunchConfig(subs=dec_subs(r, n))
    return LaunchConfig(parts=mma_parts(r)) if mma else DEFAULT_CONFIG


def launch_configs(m: int, r: int, n: int, mma: bool) -> list[LaunchConfig]:
    """Every explicit launch config the GEMM core takes for M rows of R
    packed rows x N columns: the decode class's ``subs`` whose column tile
    fits one cluster, or the tensor-core prefill's ``parts`` up to 8 and
    the windows (``mma``: the bf16 route)."""
    w = windows(r)
    if gemm_class(m) == "decode":
        return [LaunchConfig(subs=s) for s in (1, 2, 4, 8) if -(-w // s) <= MAX_CLUSTER]
    if not mma:
        return []
    return [LaunchConfig(parts=p) for p in range(1, min(MAX_PARTS, w) + 1)]


def check_launch_config(m: int, r: int, n: int, mma: bool, config: LaunchConfig) -> None:
    """Raise ValueError for a config the kernel would refuse (never replaced
    by another)."""
    if config == DEFAULT_CONFIG:
        return
    if config not in launch_configs(m, r, n, mma):
        route = ("decode" if gemm_class(m) == "decode"
                 else "tensor-core prefill" if mma else "FMA prefill")
        raise ValueError(
            f"launch config {tuple(config)} (subs, parts) is not feasible for the "
            f"{route} class at M={m}, R={r} ({windows(r)} windows), N={n}: "
            f"it takes {[tuple(c) for c in launch_configs(m, r, n, mma)] or 'only the default'}")


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
