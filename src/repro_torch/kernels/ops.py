"""Kernel entry points: dispatch by the tensors' device, the kernel mode,
and launch counts.

A CPU tensor goes to the kernel's plain PyTorch version (kernels/ref.py),
and so does a meta tensor (the dry run, launch/dryrun.py: shapes only).
A CUDA tensor launches the hand-written kernel or raises — there is no
fallback from a kernel that fails to build, refuses a shape or fails to
launch.  The packed GEMMs take an optional launch config
(``build.LaunchConfig``), checked on either device and never replaced.

Kernel modes (``KernelMode``; ``ServeConfig.kernel_mode``,
``--kernel-mode``) take every name and alias of the JAX package's and map
each to one of the port's three behaviours, set for a block of calls by
``kernel_mode(mode, cache)`` (a context variable: the engine sets it around
its own model calls):

  * "auto" (the default; and "pallas", "compiled", "interpret",
    "sharded"): the kernels at their built-in launch configs on CUDA, the
    plain versions on the CPU;
  * "tuned": the packed GEMMs and the attention take the config the
    autotune cache holds for their shape (kernels/autotune.py): a CUDA
    kernel at a launch config or a native implementation
    (kernels/native_gemm.py, the chunked ``flash_masked``); the plain
    versions and the native ones on the CPU;
  * "ref": the plain versions, on CPU tensors only — a CUDA tensor raises
    ValueError, since no mode runs a plain version on the card.

"sharded" is the engine's SPMD path: under a Topology every rank runs the
kernels on its shard (the engine forces it there, as the JAX package
forces its GSPMD mode); on one device it is "auto".

``launches`` counts each kernel's launches (plain ints, bumped once per
successful launch) so a run can show that it went through the kernels;
``reset_launches`` zeroes them.  A CUDA graph capture records launches
without running them: ``launches_recorded`` takes what a capture counted out
of ``launches``, and ``add_launches`` counts them once for each replay.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
from typing import NamedTuple

import torch

from . import build, ref
from .das_gemm import compacted_lanes, das_ternary_gemm_cuda
from .das_gemv import das_gemv_cuda, gemv_compaction
from .ref import DasTopK
from .sparse_attn import sparse_attention_cuda
from .ternary_gemm import ternary_gemm_cuda
from .topk_mask import das_topk_cuda
from .twd_decode import twd_decode_cuda

__all__ = ["KernelMode", "KERNEL_MODES", "Dispatch", "kernel_mode", "current_dispatch",
           "KERNELS", "launches", "reset_launches", "launches_recorded",
           "add_launches", "DasTopK", "das_topk",
           "das_ternary_gemm", "ternary_gemm", "sparse_attention",
           "twd_decode", "twd_decode_stack", "das_gemv"]

class KernelMode(str, enum.Enum):
    """The JAX package's kernel-mode selector, name for name; ``behaviour``
    is what the port does under it ("auto", "tuned" or "ref")."""
    REF = "ref"
    INTERPRET = "interpret"
    PALLAS = "pallas"
    COMPILED = "compiled"
    TUNED = "tuned"
    AUTO = "auto"
    SHARDED = "sharded"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def parse(cls, value) -> "KernelMode":
        """Accept a member, canonical name, or alias; reject anything else
        with a ValueError that lists the valid modes."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            v = _KERNEL_MODE_ALIASES.get(value.strip().lower(), value.strip().lower())
            try:
                return cls(v)
            except ValueError:
                pass
        raise ValueError(
            f"unknown kernel mode {value!r}: valid modes are "
            f"{', '.join(m.value for m in cls)} (aliases: "
            f"{', '.join(f'{a}->{b}' for a, b in sorted(_KERNEL_MODE_ALIASES.items()))})")

    @property
    def behaviour(self) -> str:
        if self in (KernelMode.TUNED, KernelMode.REF):
            return self.value
        return "auto"


_KERNEL_MODE_ALIASES = {
    "reference": "ref", "jnp": "ref", "xla": "ref",
    "interp": "interpret", "emulate": "interpret", "emulated": "interpret",
    "mosaic": "pallas",
    "autotune": "tuned", "autotuned": "tuned",
    "spmd": "sharded", "gspmd": "sharded",
}

KERNEL_MODES = tuple(m.value for m in KernelMode)


class Dispatch(NamedTuple):
    """The behaviour in force ("auto", "tuned" or "ref") and, under
    "tuned", the autotune cache (kernels/autotune.AutotuneCache) its
    lookups read."""
    mode: str = "auto"
    cache: object = None


_dispatch: contextvars.ContextVar[Dispatch] = contextvars.ContextVar(
    "repro_torch_kernel_mode", default=Dispatch())


def current_dispatch() -> Dispatch:
    return _dispatch.get()


@contextlib.contextmanager
def kernel_mode(mode, cache=None):
    """Run the block under ``mode`` (a KernelMode or any of its names);
    "tuned" reads ``cache``, an autotune.AutotuneCache (default: a cache
    loaded from the default path)."""
    behaviour = KernelMode.parse(mode).behaviour
    if behaviour == "tuned" and cache is None:
        from . import autotune
        cache = autotune.AutotuneCache()
    token = _dispatch.set(Dispatch(behaviour, cache if behaviour == "tuned" else None))
    try:
        yield
    finally:
        _dispatch.reset(token)


KERNELS = ("das_topk", "das_ternary_gemm", "ternary_gemm", "sparse_attention",
           "twd_decode", "das_gemv")

launches: dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


@contextlib.contextmanager
def launches_recorded():
    """Yield a dict that, after the block, holds the launches the block
    counted, which are taken back out of ``launches``: a graph capture
    launches nothing, its replays do (``add_launches``)."""
    before = dict(launches)
    rec: dict[str, int] = {}
    try:
        yield rec
    finally:
        for name in KERNELS:
            rec[name] = launches[name] - before[name]
            launches[name] = before[name]


def add_launches(counts: dict[str, int]) -> None:
    """Count ``counts`` launches, e.g. one replay of a captured graph."""
    for name, n in counts.items():
        launches[name] += n


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU and meta ones (the dry run's:
    the plain version then computes shapes only); mixed devices raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        if _dispatch.get().mode == "ref":
            raise ValueError("kernel_mode 'ref' runs the plain versions, on CPU tensors "
                             "only: a CUDA tensor launches its kernel")
        return True
    if dev.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel for device {dev}")


def _scale(s, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32, device=like.device)


def das_topk(x: torch.Tensor, *, keep: int, block: int = 32,
             norm_scale: torch.Tensor | None = None, eps: float = 1e-6,
             with_mask: bool = True, with_normed: bool = False,
             with_dense: bool = False, with_compact: bool = True) -> DasTopK:
    """(..., K) -> DasTopK over the flattened rows (M, K) of x, or of
    ``rmsnorm(norm_scale, x, eps)`` (models/layers.py) when a norm scale
    (K,) is given; the mask (M, K), the normed rows and, when the block
    divides K, the masked dense rows beside the compaction only on request.
    ``with_compact=False`` writes neither the compaction nor the masked
    dense rows (the training step's call: the mask alone)."""
    if with_normed and norm_scale is None:
        raise ValueError("normed rows need a norm scale")
    x2 = x.reshape(-1, x.shape[-1])
    kw = dict(keep=keep, block=block, norm_scale=norm_scale, eps=eps,
              with_mask=with_mask, with_normed=with_normed, with_dense=with_dense,
              with_compact=with_compact)
    if not _on_cuda(x2, norm_scale):
        return ref.das_topk_ref(x2, **kw)
    out = das_topk_cuda(x2.contiguous(), **kw)
    launches["das_topk"] += 1
    return out


def das_ternary_gemm(values: torch.Tensor, indices: torch.Tensor,
                     packed: torch.Tensor, w_scale, *, keep: int,
                     block: int = 32,
                     config: build.LaunchConfig = build.DEFAULT_CONFIG) -> torch.Tensor:
    """(M, Kc) activations compacted to ``keep`` of every ``block`` lanes x
    packed (R, N) -> (M, N) float32; Kc must be K / block * keep.
    ``config``: the launch config, checked on either device (the plain
    version computes the same function at every config)."""
    w_scale = _scale(w_scale, packed)
    if not _on_cuda(values, indices, packed):
        kc, (r, n) = values.shape[-1], packed.shape
        compacted_lanes(kc, keep, block, r)
        build.check_launch_config(values.shape[0], r, n,
                                  build.das_mma_route(values.dtype, kc, keep, block, n), config)
        return ref.das_ternary_gemm_ref(values, indices, packed, w_scale)
    out = das_ternary_gemm_cuda(values, indices, packed, w_scale, keep=keep,
                                block=block, config=config)
    launches["das_ternary_gemm"] += 1
    return out


def ternary_gemm(x: torch.Tensor, packed: torch.Tensor, w_scale,
                 x_scale: torch.Tensor | None = None, *,
                 config: build.LaunchConfig = build.DEFAULT_CONFIG) -> torch.Tensor:
    """(M, K) x packed (R, N), 5R >= K -> (M, N) float32 at the launch
    config ``config`` (checked on either device)."""
    w_scale = _scale(w_scale, packed)
    if not _on_cuda(x, packed, x_scale):
        (m, k), (r, n) = x.shape, packed.shape
        build.check_launch_config(m, r, n, build.dense_mma_route(x.dtype, k, n), config)
        return ref.ternary_gemm_ref(x, packed, w_scale, x_scale)
    out = ternary_gemm_cuda(x, packed, w_scale, x_scale, config=config)
    launches["ternary_gemm"] += 1
    return out


def sparse_attention(q, k, v, q_pos, k_pos, *, sink: int, window: int,
                     softcap: float | None = None,
                     round_scores: bool = False) -> torch.Tensor:
    """LPSA attention; q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D), int32
    positions (B, Lq) / (B, Lk), -1 = empty slot.  ``round_scores`` rounds
    q.k to q's dtype before the scale (ref.sparse_attention_ref)."""
    if not _on_cuda(q, k, v, q_pos, k_pos):
        return ref.sparse_attention_ref(q, k, v, q_pos, k_pos, sink=sink,
                                        window=window, softcap=softcap,
                                        round_scores=round_scores)
    out = sparse_attention_cuda(q, k, v, q_pos, k_pos, sink=sink,
                                window=window, softcap=softcap,
                                round_scores=round_scores)
    launches["sparse_attention"] += 1
    return out


def twd_decode(packed: torch.Tensor, k: int) -> torch.Tensor:
    """base-3 packed (R, N) uint8 -> int8 trits (k, N), k <= 5R."""
    if not _on_cuda(packed):
        return ref.twd_decode_ref(packed, k)
    out = twd_decode_cuda(packed, k)
    launches["twd_decode"] += 1
    return out


def twd_decode_stack(packed: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous stack of base-3 packed weights (E, R, N) uint8 -> int8
    trits (E, k, N), k <= 5R, in one launch of ``twd_decode``: the stack
    viewed as (E*R, N) decodes to 5*E*R trit rows, expert e's at [5Re, 5R(e
    + 1)), of which each expert's first k are returned (a view)."""
    if packed.ndim != 3:
        raise ValueError(f"want a packed stack (E, R, N); got {tuple(packed.shape)}")
    e, r, n = packed.shape
    if not 1 <= k <= 5 * r:
        raise ValueError(f"twd_decode_stack needs 1 <= k <= 5R; got R={r}, k={k}")
    if not _on_cuda(packed):
        return ref.twd_decode_stack_ref(packed, k)
    if not packed.is_contiguous():
        raise ValueError("twd_decode_stack needs a contiguous packed stack")
    out = twd_decode_cuda(packed.view(e * r, n), 5 * e * r)
    launches["twd_decode"] += 1
    return out.view(e, 5 * r, n)[:, :k]


def das_gemv(values: torch.Tensor, indices: torch.Tensor | None,
             trits: torch.Tensor, w_scale, *, keep: int = 16,
             block: int = 32) -> torch.Tensor:
    """(M, Kc) values at absolute lanes ``indices`` (None: dense rows, Kc ==
    K) x int8 trits (K, N) -> (M, N) float32; compacted rows must be
    ``keep`` of every ``block`` lanes, Kc == K / block * keep."""
    w_scale = _scale(w_scale, trits)
    if not _on_cuda(values, indices, trits):
        if indices is not None:
            gemv_compaction(values.shape[-1], trits.shape[0], keep, block)
        return ref.das_gemv_ref(values, indices, trits, w_scale)
    out = das_gemv_cuda(values, indices, trits, w_scale, keep=keep, block=block)
    launches["das_gemv"] += 1
    return out
