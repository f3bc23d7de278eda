"""Kernel autotuner: perfmodel ranking + timed confirmation, the JAX
package's ``kernels/autotune.py`` over the port's own candidates.

Per (op, device, shape) it

  1. enumerates candidate configs — on the card the hand-written CUDA
     kernel at each feasible launch config (``subs`` windows a block in the
     decode class, ``parts`` K parts a cluster in the tensor-core prefill;
     kernels/build.py ``LaunchConfig``) and the native implementations
     (kernels/native_gemm.py; the chunked ``flash_masked`` at kv chunks of
     128, 256, 512 and Lk for the attention, the JAX package's
     ``xla_flash``); on the CPU the plain versions and the native ones;
  2. ranks them with :func:`repro_torch.core.perfmodel.kernel_cost`;
  3. confirms the top ``budget`` candidates with real timed runs on random
     operands (CUDA events on the card, the L2 flushed before each call;
     the host clock on the CPU); and
  4. persists the winner, with every timed candidate's µs, to an on-disk
     JSON cache.

The key.  A GEMM's key is (op, device, K, N, dtype, keep, block, class),
class "decode" for M <= 4 and "prefill" above, and never M within a class:
a launch config changes the order of a row's sums, so a choice keyed by M
would let a row's result depend on its batch, which the GEMM core's
batch-invariance rule forbids.  This differs on purpose from the JAX
package's key, which holds ``m``.  A class is timed and ranked at one M
(``CLASS_M``), so the choice is a function of the key alone.  The native
impls leave their products to ``torch.matmul``, whose sum order is the
library's choice for the shape: the engine's shapes are fixed within a
class (``max_slots`` rows a decode step, a pack a streaming prefill).  The
attention's key is the JAX package's ``attn_dims`` with the dtype and
whether the scores are rounded (the streaming prefill's packs): the batch
is not in it.

Tuning happens EAGERLY (``tune``): ``ServeEngine`` tunes its shapes at
construction, before it captures the decode step's CUDA graph, which bakes
in the config chosen at capture; a populated cache makes a later warmup
free (zero timed runs).  Dispatch goes through ``lookup`` — a pure cache
read that never times anything.  A miss runs what kernel mode "auto" runs:
the hand-written kernel at its built-in config on the card, its plain
version on the CPU.  The perfmodel only orders the candidates that
``tune`` times: its estimates are not a choice (it prices the native impls
as the JAX package does, at the int8 peak, far below what they take on the
card).  Re-tune (or delete the cache file) before building engines, not
after.

Cache location: ``$TENET_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/tenet-repro-torch/autotune-<device>.json``, ``<device>`` naming
the card (``NVIDIA_H100_80GB_HBM3-sm90``) or "cpu".  Format: ``{"version":
1, "package": "repro_torch", "entries": {key: {impl, subs, parts, kv_chunk,
us, timed}}}``; a file without the package mark (the JAX package's cache,
``$TENET_AUTOTUNE_CACHE``) is not read, and neither package reads the
other's.  Keys look like
``das_ternary_gemm|NVIDIA_H100_80GB_HBM3-sm90|block32|clsdecode|dtypebfloat16|k2048|keep16|n2048``.

CLI (bounded):
    PYTHONPATH=src python -m repro_torch.kernels.autotune --device cpu \
        --budget 2 --cache /tmp/autotune.json
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import perfmodel, twd
from repro_torch.kernels import build, native_gemm, ops

__all__ = [
    "TileConfig", "AutotuneCache", "default_cache_path", "device_name",
    "shape_key", "gemm_dims", "attn_dims", "candidates", "tune", "lookup",
    "takes_dense", "run_gemm", "run_das_gemm", "run_attention", "main", "CLASS_M",
]

CLASS_M = {"decode": build.DECODE_ROWS, "prefill": 256}   # the M a class is timed at
ENV_VAR = "TENET_TORCH_AUTOTUNE_CACHE"
_PACKAGE = "repro_torch"
_FLASH_CHUNKS = (128, 256, 512)
_SPIN_CYCLES = 5_000_000     # ~3 ms of the H100's clock ahead of a timed call
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclass(frozen=True)
class TileConfig:
    """One candidate configuration.

    ``impl``: "cuda" (the hand-written kernel, at ``subs`` / ``parts``, 0 =
    its built-in choice), "plain" (its plain version, CPU only), one of
    ``native_gemm.NATIVE_GEMM_IMPLS`` or "native_gather", or "native_flash"
    (the chunked ``flash_masked`` at ``kv_chunk`` keys a chunk).
    """
    impl: str
    subs: int = 0
    parts: int = 0
    kv_chunk: int = 0

    @property
    def launch(self) -> build.LaunchConfig:
        return build.LaunchConfig(self.subs, self.parts)

    @property
    def name(self) -> str:
        knobs = [f"{k}={v}" for k, v in (("subs", self.subs), ("parts", self.parts),
                                         ("kv_chunk", self.kv_chunk)) if v]
        return " ".join([self.impl, *knobs])


def device_name(device) -> str:
    """"cpu", or the card's name and compute capability,
    ``NVIDIA_H100_80GB_HBM3-sm90``: the cache is kept per device."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    return _card_name(dev)


@functools.lru_cache(maxsize=16)
def _card_name(dev: torch.device) -> str:
    major, minor = torch.cuda.get_device_capability(dev)
    return f"{torch.cuda.get_device_name(dev).replace(' ', '_')}-sm{major}{minor}"


def default_cache_path(device=None) -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "tenet-repro-torch",
                        f"autotune-{device_name(resolve_device(device))}.json")


class AutotuneCache:
    """On-disk shape+device -> TileConfig map with write-through persist.

    ``timed_runs`` counts real timed candidate executions over this object's
    lifetime — a populated cache keeps it at zero.  A missing, unreadable
    or foreign file loads as empty (the next ``put`` rewrites it)."""

    def __init__(self, path: str | None = None, device=None):
        self.path = path or default_cache_path(device)
        self.entries: dict[str, dict] = {}
        self.timed_runs = 0
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return
        if (isinstance(payload, dict) and payload.get("version") == 1
                and payload.get("package") == _PACKAGE
                and isinstance(payload.get("entries"), dict)):
            self.entries = payload["entries"]

    def save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "package": _PACKAGE, "entries": self.entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def get(self, key: str) -> TileConfig | None:
        e = self.entries.get(key)
        if e is None:
            return None
        return TileConfig(e["impl"], e.get("subs", 0), e.get("parts", 0),
                          e.get("kv_chunk", 0))

    def put(self, key: str, cfg: TileConfig, us: float,
            timed: dict[str, float] | None = None) -> None:
        self.entries[key] = {**asdict(cfg), "us": round(float(us), 2),
                             "timed": {k: round(float(v), 2) for k, v in (timed or {}).items()}}
        self.save()


def shape_key(op: str, device: str, **dims) -> str:
    return "|".join([op, device] + [f"{k}{v}" for k, v in sorted(dims.items())])


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def gemm_dims(*, m: int, k: int, n: int, keep: int = 0, block: int = 0, dtype) -> dict:
    """Canonical GEMM cache dims: M enters only as its class."""
    return dict(cls=build.gemm_class(m), k=k, n=n, keep=keep, block=block,
                dtype=_dtype_name(dtype))


def attn_dims(*, hq: int, hkv: int, lq: int, lk: int, d: int, sink: int, window: int,
              dtype, round_scores: bool = False) -> dict:
    """Canonical `sparse_attn` cache dims.  sink/window are clamped to the
    cache length so the full-causal sentinel (sink = 2**30) keys stay sane
    and masks that behave identically share one entry.  Use this on BOTH
    sides (warmup tune + dispatch-time lookup) so keys always match."""
    return dict(hq=hq, hkv=hkv, lq=lq, lk=lk, d=d, sink=min(sink, lk),
                window=min(window, lk), dtype=_dtype_name(dtype), rs=int(round_scores))


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------

def _gemm_route(op: str, dims: dict) -> tuple[int, bool]:
    """(packed rows of an export, whether the prefill class takes the
    tensor-core route) of a GEMM key."""
    k, n, keep, block = dims["k"], dims["n"], dims["keep"], dims["block"]
    dtype = _DTYPES[dims["dtype"]]
    r = twd.packed_rows(k, twd.ROW_ALIGN)
    if op == "das_ternary_gemm":
        return r, build.das_mma_route(dtype, k // block * keep, keep, block, n)
    return r, build.dense_mma_route(dtype, k, n)


def candidates(op: str, device, **dims) -> list[TileConfig]:
    """Feasible configs for `op` on `device` at the canonical dims
    (``gemm_dims`` / ``attn_dims``)."""
    cuda = torch.device(device).type == "cuda"
    if op == "sparse_attn":
        return _attn_candidates(cuda, **dims)
    if op not in ("ternary_gemm", "das_ternary_gemm"):
        raise ValueError(f"candidates: unknown op {op!r}")
    k, keep, block = dims["k"], dims["keep"], dims["block"]
    das = op == "das_ternary_gemm"
    if das and not (0 < keep <= block and k % block == 0 and build.WIN_LANES % block == 0):
        raise ValueError(f"das_ternary_gemm takes whole blocks dividing {build.WIN_LANES} "
                         f"lanes; got K={k}, keep={keep}, block={block}")
    out: list[TileConfig] = []
    if cuda:
        r, mma = _gemm_route(op, dims)
        m = CLASS_M[dims["cls"]]
        if build.packed_rows_fit(m, r):
            out += [TileConfig("cuda", c.subs, c.parts)
                    for c in build.launch_configs(m, r, dims["n"], mma)] or [TileConfig("cuda")]
    else:
        out.append(TileConfig("plain"))
    f32_ok = k % twd.TRITS_PER_BYTE == 0
    if das:
        if f32_ok:
            out.append(TileConfig("native_dense_f32dec"))
        out += [TileConfig("native_dense_plain"), TileConfig("native_gather")]
    else:
        if f32_ok:
            out.append(TileConfig("native_f32dec"))
        out.append(TileConfig("native_plain"))
    return out


def _attn_candidates(cuda: bool, *, hq, hkv, lq, lk, d, sink, window, dtype,
                     rs) -> list[TileConfig]:
    out = [TileConfig("cuda" if cuda else "plain")]
    # flash_masked keeps float32 scores: it computes a rounded-scores call's
    # function only in float32, where the rounding is the identity
    if not rs or dtype == "float32":
        chunks = {c if lk % c == 0 else lk for c in (*_FLASH_CHUNKS, lk) if c <= lk}
        out += [TileConfig("native_flash", kv_chunk=c) for c in sorted(chunks)]
    return out


def _model_cost(hw, op: str, cfg: TileConfig, dims: dict) -> float:
    if op == "sparse_attn":
        kd = {k: dims[k] for k in ("hq", "hkv", "lq", "lk", "d")}
        return perfmodel.kernel_cost(hw, op, cfg.impl, block_k=cfg.kv_chunk, **kd)
    _, mma = _gemm_route(op, dims)
    return perfmodel.kernel_cost(
        hw, op, cfg.impl, m=CLASS_M[dims["cls"]], k=dims["k"], n=dims["n"],
        keep=dims["keep"], block=dims["block"], subs=cfg.subs, parts=cfg.parts, mma=mma)


# ---------------------------------------------------------------------------
# config executors (shared by tuned dispatch and timed confirmation)
# ---------------------------------------------------------------------------

def _check_impl(cfg: TileConfig, t: torch.Tensor) -> None:
    """A config runs only on the device it was chosen for: "plain" never on
    the card, "cuda" never on the CPU."""
    if (cfg.impl == "plain" and t.device.type == "cuda") or \
            (cfg.impl == "cuda" and t.device.type != "cuda"):
        raise ValueError(f"config {cfg.name!r} does not run on {t.device}")


def run_gemm(x, packed, w_scale, x_scale=None, *, cfg: TileConfig | None = None):
    """Dense rows (M, K) x packed (R, N) -> (M, N) float32 under a tuned (or
    given) config."""
    if cfg is None:
        m, k = x.shape
        cfg = lookup("ternary_gemm", device=x.device, cache=ops.current_dispatch().cache,
                     **gemm_dims(m=m, k=k, n=packed.shape[1], dtype=x.dtype))
    _check_impl(cfg, x)
    if cfg.impl in ("cuda", "plain"):
        return ops.ternary_gemm(x, packed, w_scale, x_scale, config=cfg.launch)
    return native_gemm.decode_matmul(x, packed, w_scale, impl=cfg.impl, x_scale=x_scale)


def run_das_gemm(values, indices, packed, w_scale, *, keep: int, block: int,
                 cfg: TileConfig | None = None, dense=None):
    """DAS-compacted (M, Kc) rows x packed (R, N) -> (M, N) float32 under a
    config; ``dense``: the same rows masked and dense (M, K), where the DAS
    step wrote them (else the native dense impls scatter the compaction)."""
    m, kc = values.shape
    k = kc // keep * block
    if cfg is None:
        cfg = lookup("das_ternary_gemm", device=values.device,
                     cache=ops.current_dispatch().cache,
                     **gemm_dims(m=m, k=k, n=packed.shape[1], keep=keep, block=block,
                                 dtype=values.dtype))
    _check_impl(cfg, values)
    if cfg.impl in ("cuda", "plain"):
        return ops.das_ternary_gemm(values, indices, packed, w_scale, keep=keep,
                                    block=block, config=cfg.launch)
    if cfg.impl == "native_gather":
        return native_gemm.gather_matmul(values, indices, packed, w_scale)
    if dense is None:
        dense = native_gemm.scatter_dense(values, indices, k, keep=keep, block=block)
    return native_gemm.decode_matmul(dense, packed, w_scale, impl=cfg.impl)


def run_attention(q, k, v, q_pos, k_pos, *, sink: int, window: int,
                  softcap: float | None = None, round_scores: bool = False,
                  cfg: TileConfig | None = None):
    """LPSA attention (ops.sparse_attention's layout) under a tuned (or
    given) config: the kernel (its plain version on the CPU) or the chunked
    ``flash_masked``."""
    if cfg is None:
        cfg = lookup("sparse_attn", device=q.device, cache=ops.current_dispatch().cache,
                     **attn_dims(hq=q.shape[2], hkv=k.shape[2], lq=q.shape[1],
                                 lk=k.shape[1], d=q.shape[3], sink=sink, window=window,
                                 dtype=q.dtype, round_scores=round_scores))
    _check_impl(cfg, q)
    if cfg.impl in ("cuda", "plain"):
        return ops.sparse_attention(q, k, v, q_pos, k_pos, sink=sink, window=window,
                                    softcap=softcap, round_scores=round_scores)
    if round_scores and q.dtype != torch.float32:
        raise ValueError("native_flash keeps float32 scores: it takes rounded-score "
                         "calls in float32 only")
    from repro_torch.models.attention import flash_masked   # lazy: no cycle
    return flash_masked(q, k, v, q_pos, k_pos, sink=sink, window=window,
                        softcap=softcap, kv_chunk=cfg.kv_chunk)


# ---------------------------------------------------------------------------
# tune / lookup
# ---------------------------------------------------------------------------

def _time_us(fn, device: torch.device, *, iters: int, warmup: int) -> float:
    """Median µs of ``fn()``: on the card CUDA events around each call,
    after a 64 MiB write that evicts the L2 (a served layer's weights come
    cold from HBM) and a spin of ~3 ms that keeps the card busy while the
    host enqueues the call, so that the events bracket device time alone
    (the decode step replays a CUDA graph: no host time between its
    kernels); the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(_SPIN_CYCLES)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) * 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(ts))


def _gemm_runner(op: str, dims: dict, device: torch.device):
    """cfg -> a call of the GEMM under cfg, on seeded random operands at the
    class's M, as a served layer takes them (packed with the export's row
    padding; DAS rows from the das_topk step, masked dense rows beside)."""
    m, k, n = CLASS_M[dims["cls"]], dims["k"], dims["n"]
    keep, block, dtype = dims["keep"], dims["block"], _DTYPES[dims["dtype"]]
    rng = np.random.default_rng(0)
    x_scale = None
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(device)
        x_scale = torch.ones(m, dtype=torch.float32, device=device)
    else:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(device, dtype)
    trits = torch.from_numpy(rng.integers(-1, 2, (k, n), dtype=np.int8))
    packed = twd.pack_ternary(trits, row_align=twd.ROW_ALIGN).to(device)
    scale = torch.tensor(0.5, dtype=torch.float32, device=device)
    if op == "das_ternary_gemm":
        step = ops.das_topk(x, keep=keep, block=block, with_mask=False, with_dense=True)
        return lambda cfg: run_das_gemm(step.values, step.indices, packed, scale, keep=keep,
                                        block=block, cfg=cfg, dense=step.dense)
    return lambda cfg: run_gemm(x, packed, scale, x_scale, cfg=cfg)


def _attn_runner(dims: dict, device: torch.device):
    """cfg -> an attention call under cfg on seeded random operands: 4 rows
    of one query (a decode step), one sequence of ``lq`` queries otherwise,
    the queries at the last ``lq`` of ``lk`` positions."""
    hq, hkv, lq, lk, d = (dims[x] for x in ("hq", "hkv", "lq", "lk", "d"))
    dtype = _DTYPES[dims["dtype"]]
    b = build.DECODE_ROWS if lq == 1 else 1
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(device, dtype)
    q, k, v = t(b, lq, hq, d), t(b, lk, hkv, d), t(b, lk, hkv, d)
    q_pos = torch.arange(lk - lq, lk, dtype=torch.int32, device=device)[None].expand(b, lq)
    k_pos = torch.arange(lk, dtype=torch.int32, device=device)[None].expand(b, lk)
    q_pos, k_pos = q_pos.contiguous(), k_pos.contiguous()
    return lambda cfg: run_attention(q, k, v, q_pos, k_pos, sink=dims["sink"],
                                     window=dims["window"], round_scores=bool(dims["rs"]),
                                     cfg=cfg)


def tune(op: str, *, device=None, cache: AutotuneCache | None = None,
         budget: int | None = 3, iters: int = 5, warmup: int = 1, **dims) -> TileConfig:
    """Pick (and persist) the best config for one op at canonical dims
    (``gemm_dims`` / ``attn_dims``).

    A cache hit returns at once with ZERO timed runs.  On a miss the
    perfmodel ranks all candidates and the top ``budget`` (None: all) are
    confirmed with real timed runs (each bumps ``cache.timed_runs``).  Call
    eagerly — never while a CUDA graph is being captured.
    """
    dev = resolve_device(device)
    cache = cache if cache is not None else AutotuneCache(device=dev)
    key = shape_key(op, device_name(dev), **dims)
    hit = cache.get(key)
    if hit is not None:
        return hit
    hw = perfmodel.backend_hw(dev)
    ranked = sorted(candidates(op, dev, **dims), key=lambda c: _model_cost(hw, op, c, dims))
    if not ranked:
        raise ValueError(f"no candidate for {key}")
    run = _attn_runner(dims, dev) if op == "sparse_attn" else _gemm_runner(op, dims, dev)
    timed: dict[str, float] = {}
    best, best_us = ranked[0], float("inf")
    for cfg in ranked[:budget] if budget else ranked:
        us = _time_us(lambda: run(cfg), dev, iters=iters, warmup=warmup)
        cache.timed_runs += 1
        timed[cfg.name] = us
        if us < best_us:
            best, best_us = cfg, us
    cache.put(key, best, best_us, timed)
    return best


def lookup(op: str, *, device, cache: AutotuneCache | None = None, **dims) -> TileConfig:
    """Dispatch-time config resolution: a cache read, else what kernel mode
    "auto" runs (the kernel at its built-in config on the card, its plain
    version on the CPU).

    Never times, never persists — safe to call while a CUDA graph is being
    captured.  A miss means the shape wasn't warmed up."""
    dev = torch.device(device)
    cache = cache if cache is not None else AutotuneCache(device=dev)
    hit = cache.get(shape_key(op, device_name(dev), **dims))
    if hit is not None:
        return hit
    return TileConfig("cuda" if dev.type == "cuda" else "plain")


def takes_dense(*, device, cache: AutotuneCache | None = None, m: int, k: int,
                keep: int, block: int, dtype) -> bool:
    """Whether a DAS step of M rows of K lanes feeds a native dense impl:
    the cached ``das_ternary_gemm`` winner at these rows' key, at some N, is
    ``native_dense_*``.  The step then writes the masked dense rows beside
    its compaction; otherwise no call reads them (a miss takes the kernel).
    A function of the key without N, so never of M within a class."""
    dev = torch.device(device)
    cache = cache if cache is not None else AutotuneCache(device=dev)
    rows = gemm_dims(m=m, k=k, n=0, keep=keep, block=block, dtype=dtype)
    want = {f"{f}{v}" for f, v in rows.items() if f != "n"}
    head = ("das_ternary_gemm", device_name(dev))
    for key, e in cache.entries.items():
        f = key.split("|")
        if tuple(f[:2]) == head and want <= set(f[2:]) and e["impl"].startswith("native_dense"):
            return True
    return False


# ---------------------------------------------------------------------------
# CLI: bounded tuning run (smoke + manual re-tuning)
# ---------------------------------------------------------------------------

def _small_shapes(dtype) -> list[tuple[str, dict]]:
    return [
        ("das_ternary_gemm", gemm_dims(m=2, k=320, n=128, keep=16, block=32, dtype=dtype)),
        ("das_ternary_gemm", gemm_dims(m=256, k=640, n=256, keep=16, block=32, dtype=dtype)),
        ("ternary_gemm", gemm_dims(m=4, k=320, n=128, dtype=dtype)),
        ("sparse_attn", attn_dims(hq=4, hkv=2, lq=1, lk=64, d=64, sink=4, window=60,
                                  dtype=dtype)),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Bounded autotune run: rank + time candidates for a "
                    "small shape set and persist the winners.")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--budget", type=int, default=2,
                    help="max timed candidates per shape (0: all)")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--cache", default=None,
                    help=f"cache path (default: ${ENV_VAR} or "
                         f"~/.cache/tenet-repro-torch/autotune-<device>.json)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cache = AutotuneCache(args.cache, device=dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    for op, dims in _small_shapes(dtype):
        t0 = time.perf_counter()
        cfg = tune(op, device=dev, cache=cache, budget=args.budget or None,
                   iters=args.iters, **dims)
        key = shape_key(op, device_name(dev), **dims)
        print(f"{key} -> {cfg.name} ({cache.entries[key]['us']:.1f}us, "
              f"{time.perf_counter() - t0:.1f}s to tune)")
    print(f"cache: {cache.path} ({len(cache.entries)} entries, "
          f"{cache.timed_runs} timed runs this invocation)")


if __name__ == "__main__":
    main()
