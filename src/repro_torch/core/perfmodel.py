"""Analytic roofline performance / power model (paper Secs. IV-D, V-C).

A copy of the JAX package's ``core/perfmodel.py`` (the port imports nothing
of that package), plus the NVIDIA H100 profile ``H100_SXM``, a
``backend_hw`` that reads the device, and a ``kernel_cost`` that also
prices the port's own candidates: the CUDA kernels at a launch config, and
the plain versions on the CPU.

Two uses:
  1. Reproduce the paper's hardware numbers (TENET-ASIC/FPGA vs A100/CPU:
     Figs 12-15, Table IV) from first principles — operator-level FLOP and
     byte counts with the optimizations (TWD / DAS / LPSA) toggled, pushed
     through a max(compute, memory) roofline and a power-integral energy model.
  2. Drive the TPU-facing DSE (core/dse.py) and sanity-check the dry-run
     roofline terms in EXPERIMENTS.md.

Everything is a pure function of dataclasses, so the numbers are
reproducible on any host; only ``backend_hw`` asks torch which device it
has.  The CUDA kernels' launch structure comes from kernels/build.py, its
one Python mirror.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

from repro_torch.kernels import build as launch

__all__ = [
    "HardwareSpec", "ModelShape", "TenetOpt",
    "TENET_ASIC", "TENET_FPGA", "A100_NAIVE", "A100_OPT", "CPU_I7", "TPU_V5E",
    "CPU_HOST", "H100_SXM",
    "LLAMA_1B3", "LLAMA_3B", "LLAMA_7B",
    "linear_cost", "attention_cost", "stage_cost", "e2e",
    "StageCost", "E2EReport",
    "backend_hw", "kernel_cost",
]

Stage = Literal["prefill", "decode"]


# ---------------------------------------------------------------------------
# Hardware
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_tops_low: float     # TOPS on the low-precision (ternary/int8) path
    peak_tops_high: float    # TOPS on the high-precision (fp16/bf16) path
    hbm_gbps: float          # off-chip bandwidth, GB/s
    power_w: float           # average board/chip power while busy
    onchip_mb: float = 8.0   # SRAM/VMEM capacity driving fusion legality
    flop_util: float = 1.0   # achieved/peak compute at one-batch inference
    bw_util: float = 1.0     # achieved/peak DRAM bandwidth, ditto


# TENET-ASIC (Table IV): 16 STL cores + 4 HP cores, each 32x64 MAC @ 500 MHz.
#   STL: 16*32*64*2 ops/cyc * 0.5 GHz = 32.8 TOPS ternary
#   HP :  4*32*64*2 ops/cyc * 0.5 GHz =  8.2 TOPS fp16
# Utilization factors model the paper's one-batch reality (Fig 2): commodity
# GPUs reach a fraction of peak at batch 1 (launch overheads, unfused
# attention, GEMV-shaped matmuls); TENET's dataflow sustains ~85-90%.
TENET_ASIC = HardwareSpec("tenet-asic", 32.8, 8.2, 512.0, 5.7, onchip_mb=1.4,
                          flop_util=0.85, bw_util=0.85)
# FPGA prototype: same architecture @400 MHz, half the core count (Sec. V-A)
TENET_FPGA = HardwareSpec("tenet-fpga", 13.1, 3.3, 512.0, 45.0, onchip_mb=1.4,
                          flop_util=0.85, bw_util=0.85)
A100_NAIVE = HardwareSpec("a100-naive", 312.0, 312.0, 1555.0, 300.0,
                          onchip_mb=40.0, flop_util=0.10, bw_util=0.22)
A100_OPT = HardwareSpec("a100-opt", 312.0, 312.0, 1555.0, 300.0,
                        onchip_mb=40.0, flop_util=0.35, bw_util=0.30)
CPU_I7 = HardwareSpec("i7-12700", 1.2, 1.2, 30.0, 65.0, onchip_mb=25.0,
                      flop_util=0.55, bw_util=0.80)
# TPU v5e-class chip (roofline constants used throughout EXPERIMENTS.md)
TPU_V5E = HardwareSpec("tpu-v5e", 394.0, 197.0, 819.0, 170.0, onchip_mb=128.0)
# Generic CI-runner host: what a single XLA-CPU thread pool sustains on the
# decode-shaped GEMMs the autotuner ranks (measured ~30 GFLOP/s effective on
# M<=8 matmuls, ~25 GB/s streaming) — coarse on purpose: kernel_cost() only
# has to order candidates, not predict absolute microseconds.
CPU_HOST = HardwareSpec("cpu-host", 0.03, 0.03, 25.0, 65.0, onchip_mb=16.0)
# NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's data sheet, dense
# rates): 1979 TOPS int8 on the low-precision path, 989 TFLOP/s bf16 on the
# high one, 3350 GB/s of HBM3, 50 MB of L2 as the on-chip store.  No
# utilisation factor: kernel_cost() prices the port's kernels from their own
# launch structure, and the paper-level models take the data sheet's peaks.
H100_SXM = HardwareSpec("h100-sxm", 1979.0, 989.0, 3350.0, 700.0, onchip_mb=50.0)

DRAM_PJ_PER_BYTE = 640.0     # HBM2 access energy  (paper cites >300x compute)
MAC_PJ_LOW = 0.2             # ternary MAC energy @28nm
MAC_PJ_HIGH = 1.5            # fp16 MAC energy @28nm


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelShape:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    ffn_kind: str = "swiglu"   # swiglu => 3 mats, mlp => 2 mats

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def linear_params(self) -> int:
        """Ternary-quantizable parameters (QKV/O projections + FFN)."""
        d, f = self.d_model, self.d_ff
        kvd = self.n_kv_heads * self.head_dim
        attn = d * d + 2 * d * kvd + d * d       # Q, K, V, O
        ffn = (3 if self.ffn_kind == "swiglu" else 2) * d * f
        return self.n_layers * (attn + ffn)

    def embed_params(self) -> int:
        return self.vocab * self.d_model


LLAMA_1B3 = ModelShape("bitnet-1.3b", 24, 2048, 32, 32, 5460, 32000)
LLAMA_3B = ModelShape("bitnet-3b", 26, 3200, 32, 32, 8640, 32000)
LLAMA_7B = ModelShape("llama-7b", 32, 4096, 32, 32, 11008, 32000)


@dataclass(frozen=True)
class TenetOpt:
    """Optimization toggles (paper Fig 14 ablation order)."""
    weight_bits: float = 8.0   # 16 fp16 / 8 int8-naive / 2 int2 / 1.6 TWD
    das: bool = False          # activation N:M sparsity on linears
    s_a: float = 0.5           # surviving fraction under DAS
    lpsa: bool = False         # fused sparse attention
    tl_sa: int = 1024          # kept KV per row when lpsa
    act_bytes: int = 1         # int8 activations

    @staticmethod
    def naive_int8() -> "TenetOpt":
        return TenetOpt(weight_bits=8.0)

    @staticmethod
    def twd() -> "TenetOpt":
        return TenetOpt(weight_bits=1.6)

    @staticmethod
    def twd_das() -> "TenetOpt":
        return TenetOpt(weight_bits=1.6, das=True)

    @staticmethod
    def full() -> "TenetOpt":
        return TenetOpt(weight_bits=1.6, das=True, lpsa=True)


# ---------------------------------------------------------------------------
# Operator-level costs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StageCost:
    flops_low: float     # ternary-path ops
    flops_high: float    # fp16-path ops (attention)
    weight_bytes: float
    act_bytes: float     # activation + KV traffic to DRAM

    @property
    def bytes(self) -> float:
        return self.weight_bytes + self.act_bytes

    def __add__(self, o: "StageCost") -> "StageCost":
        return StageCost(self.flops_low + o.flops_low,
                         self.flops_high + o.flops_high,
                         self.weight_bytes + o.weight_bytes,
                         self.act_bytes + o.act_bytes)


def linear_cost(m: ModelShape, tokens: int, opt: TenetOpt) -> StageCost:
    """All ternary linears for `tokens` tokens (QKV/O + FFN + LM head)."""
    p = m.linear_params()
    sa = opt.s_a if opt.das else 1.0
    flops = 2.0 * p * tokens * sa
    wbytes = p * opt.weight_bits / 8.0
    # activations in/out of each linear, int8 (read x, write y), once per token
    d, f = m.d_model, m.d_ff
    nmat = 4 + (3 if m.ffn_kind == "swiglu" else 2)
    abytes = tokens * m.n_layers * (nmat * (d + f) / 2) * opt.act_bytes * 0.5
    # LM head (kept higher precision in BitNet; count fp16)
    head = 2.0 * m.embed_params() * tokens
    return StageCost(flops, head, wbytes + m.embed_params() * 2.0,
                     abytes)


def attention_cost(m: ModelShape, tl: int, new_tokens: int, opt: TenetOpt,
                   fused_onchip: bool) -> StageCost:
    """QK^T + SV for `new_tokens` queries against a TL-long context.

    ``fused_onchip``: LPSA keeps scores/intermediates in SRAM — activation
    traffic reduces to reading X once and writing O once; otherwise Q,K,V,S,O
    round-trip DRAM (the paper's Fig 4a 97% figure).
    """
    dh, h = m.head_dim, m.n_heads
    kv_len = min(tl, opt.tl_sa) if opt.lpsa else tl
    flops = 2.0 * 2.0 * h * dh * kv_len * new_tokens * m.n_layers  # QK + SV
    d = m.d_model
    kvd = m.n_kv_heads * dh
    if fused_onchip:
        act = new_tokens * m.n_layers * (d + d) * 2.0          # X in, O out
        act += new_tokens * m.n_layers * 2 * kvd * 2.0          # KV append
    else:
        # Q,K,V write+read, scores write+read (fp16), O write
        act = new_tokens * m.n_layers * (3 * d * 2 + d * 2) * 2.0
        act += new_tokens * m.n_layers * (2.0 * h * kv_len) * 2.0
        act += m.n_layers * 2 * kvd * kv_len * 2.0 * (1 if new_tokens == 1 else 0)
    if new_tokens == 1:  # decode reads the whole kept KV cache every token
        act += m.n_layers * 2 * kvd * kv_len * 2.0
    return StageCost(0.0, flops, 0.0, act)


def stage_cost(m: ModelShape, stage: Stage, tl: int, opt: TenetOpt,
               decode_tokens: int = 1) -> StageCost:
    if stage == "prefill":
        lin = linear_cost(m, tl, opt)
        att = attention_cost(m, tl, tl, opt, fused_onchip=opt.lpsa)
        return lin + att
    # decode: per generated token, weights stream once (memory-bound)
    lin = linear_cost(m, decode_tokens, opt)
    att = attention_cost(m, tl, 1, opt, fused_onchip=opt.lpsa)
    att = StageCost(att.flops_low * decode_tokens, att.flops_high * decode_tokens,
                    att.weight_bytes * decode_tokens, att.act_bytes * decode_tokens)
    # weights re-stream for every token
    lin = replace(lin, weight_bytes=lin.weight_bytes * decode_tokens)
    return lin + att


@dataclass(frozen=True)
class E2EReport:
    latency_s: float
    prefill_s: float
    decode_s: float
    energy_j: float
    tokens_per_s: float
    bytes_moved: float
    flops: float

    def ipj(self, ppl: float) -> float:
        from .ipj import ipj
        return ipj(self.tokens_per_s, ppl, self.energy_j
                   / max(self.latency_s, 1e-12))


def _roofline_latency(hw: HardwareSpec, c: StageCost) -> float:
    t_low = c.flops_low / (hw.peak_tops_low * 1e12 * hw.flop_util)
    t_high = c.flops_high / (hw.peak_tops_high * 1e12 * hw.flop_util)
    t_mem = c.bytes / (hw.hbm_gbps * 1e9 * hw.bw_util)
    # low/high engines pipeline (LPSA hides attention under projection) but
    # both contend with DRAM: classic max() roofline.
    return max(t_low + 0.15 * t_high, t_high, t_mem)


# ---------------------------------------------------------------------------
# Kernel-candidate cost model (feeds kernels/autotune.py)
# ---------------------------------------------------------------------------
#
# The DSE machinery above prices whole serving stages; the autotuner needs the
# same roofline logic one level down — "which launch config / implementation
# of ONE kernel call is fastest on THIS device".  kernel_cost() prices a
# single (ternary_gemm | das_ternary_gemm | sparse_attn) invocation for a
# named implementation.  Only the *ordering* matters: autotune ranks
# candidates with this model, then confirms the top few with real timed runs.
#
# The native implementations (kernels/native_gemm.py, the chunked
# flash_masked) keep the JAX package's formulas for its "xla_*" impls, term
# for term, so that both packages price them alike.  The port's CUDA kernels
# ("cuda") are priced from their launch structure (kernels/csrc/common.cuh):
#   * decode class (M <= 4): K in windows of 32 packed rows, ``subs`` windows
#     a block, 128 columns a block, the blocks of a column tile one cluster
#     summed in order (kernels/build.py mirrors this structure); the packed
#     bytes stream at the share of the card's bandwidth that the resident
#     blocks pull;
#   * prefill class: 64 x 64 output tiles, each split over ``parts`` K parts
#     of a cluster; the bf16 tensor-core route pays a calibrated time per
#     window a block, in waves of two blocks an SM; the FMA route (float32
#     and int8 rows) runs at the float32 FMA rate;
#   * a launch overhead on every call.
# The plain versions ("plain", CPU only) are priced as the native impl whose
# arithmetic they repeat.

# effective FLOPs per decoded trit for the base-3 unpack (measured on XLA-CPU:
# the int32 div/mod chain costs ~3x the float divide-free variant)
_DECODE_OPS = {"plain": 8.0, "f32dec": 3.0, "pallas": 6.0}
# intermediate bytes written+read per decoded trit (XLA materializes the int32
# digit stack for "plain"; "f32dec" stays in registers feeding the sub-GEMMs)
_DECODE_BYTES = {"plain": 12.0, "f32dec": 1.6, "pallas": 0.0}
# random-gather effective-bandwidth slowdown vs streaming reads
_GATHER_SLOWDOWN = {"cpu": 15.0, "gpu": 2.0, "tpu": 4.0}
# Pallas interpreter (emulation) penalty: never competitive with a compiled
# path, but still ranked so interpret-only tuning (CI) orders tile shapes
_INTERPRET_PENALTY = 2000.0
_STEP_OVERHEAD_S = 2e-6      # per grid-step / per-chunk dispatch overhead
TRITS_PER_BYTE_F = 5.0

# The costs of the port's CUDA launch structure.  Calibrated from PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700 W):
#   _LAUNCH_S      das_topk 4 x 2048, 6.6 us at a 0.015 us bound: a launch's
#                  floor;
#   _MMA_WIN_S     a window a block of the tensor-core prefill, by row source:
#                  das_ternary_gemm's prefill gate/up (256 x 1024 of 2048 ->
#                  5460, 224.0 us at 2 parts: 3 waves x 7 windows) for the
#                  compacted rows; ternary_gemm's prefill down (256 x 5460 ->
#                  2048, 75.4 us at 5 parts: 3 waves x 7 windows) for dense
#                  rows.
# _DEC_WIN_S and _CLUSTER_S are round guesses: a decode block's time a window
# and a cluster rank's share of the ordered sum.
_MMA_TILE = 64
_N_SM = 132
_BLOCKS_PER_SM = 2
_LAUNCH_S = 6.5e-6
_DEC_WIN_S = 1.0e-6
_CLUSTER_S = 0.1e-6
_MMA_WIN_S = {"compact": 10.7e-6, "dense": 3.6e-6}
_RED_S = 0.5e-6              # a prefill part's share of the cluster sum
_FMA_RATE = 1.0 / 16.0       # float32 FMA rate / the bf16 tensor-core peak
# the plain versions repeat these native impls' arithmetic
_PLAIN_AS = {"ternary_gemm": "xla_plain", "das_ternary_gemm": "xla_gather",
             "sparse_attn": "xla_flash"}


def _cuda_gemm_cost(hw: HardwareSpec, op: str, *, m: int, k: int, n: int,
                    keep: int, block: int, subs: int, parts: int,
                    mma: bool) -> float:
    r = -(-k // 5)
    w = launch.windows(r)
    sa = keep / block if keep else 1.0
    bw = hw.hbm_gbps * 1e9 * hw.bw_util
    bytes_ = r * n + m * k * sa * 4.0 + m * n * 4.0
    if launch.gemm_class(m) == "decode":
        s = subs or launch.dec_subs(r, n)
        per_tile = -(-w // s)
        blocks = -(-n // launch.DEC_COLS) * per_tile
        t_mem = bytes_ / (bw * min(1.0, blocks / _N_SM))
        return _LAUNCH_S + t_mem + s * _DEC_WIN_S + per_tile * _CLUSTER_S
    tiles = -(-m // _MMA_TILE) * -(-n // _MMA_TILE)
    if not mma:
        flops = 2.0 * m * k * n
        return _LAUNCH_S + flops / (hw.peak_tops_high * 1e12 * _FMA_RATE) \
            + bytes_ / bw
    p = parts or launch.mma_parts(r)
    waves = -(-tiles * p // (_N_SM * _BLOCKS_PER_SM))
    t_win = _MMA_WIN_S["compact" if op == "das_ternary_gemm" else "dense"]
    return _LAUNCH_S + waves * -(-w // p) * t_win + p * _RED_S


def backend_hw(device) -> HardwareSpec:
    """HardwareSpec used to rank kernel candidates on a torch device: the
    H100 profile for an H100 (read from ``torch.cuda.get_device_name``),
    the host profile for the CPU.  Another card raises: the kernels are
    built for sm_90a alone."""
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPU_HOST
    if dev.type != "cuda":
        raise ValueError(f"no hardware profile for device {dev}")
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return H100_SXM
    raise ValueError(f"no hardware profile for {name!r}: the port's kernels "
                     f"and its cost model are for the NVIDIA H100")


def kernel_cost(hw: HardwareSpec, op: str, impl: str, *, m: int = 1,
                k: int = 0, n: int = 0, keep: int = 0, block: int = 32,
                block_m: int = 0, block_n: int = 0, block_k: int = 0,
                hq: int = 0, hkv: int = 0, lq: int = 0, lk: int = 0,
                d: int = 0, subs: int = 0, parts: int = 0,
                mma: bool = True) -> float:
    """Estimated seconds for one kernel call under implementation `impl`.

    GEMM ops (`ternary_gemm`, `das_ternary_gemm`): (M, K) x packed (K/5, N).
    `keep`/`block` describe DAS compaction (keep=0 => dense).  `block_*` are
    Pallas tile shapes (0 => kernel defaults).  `sparse_attn`: hq/hkv heads,
    lq queries vs lk keys of head dim d; `block_k` doubles as the flash
    kv-chunk.  Implementations: "pallas"/"interpret" (the JAX package's
    tiled kernels), "xla_plain"/"xla_f32dec" (dense decode-GEMM),
    "xla_dense_plain"/"xla_dense_f32dec" (DAS mask densify + decode-GEMM),
    "xla_gather" (per-row gather of kept lanes), "xla_flash" (chunked
    online-softmax); the port's "native_*" names price as the "xla_*" ones;
    "cuda" is the port's kernel at ``subs`` (decode class) or ``parts``
    (tensor-core prefill; ``mma`` False: the FMA route), 0 = its built-in
    choice; "plain" is a kernel's plain version.
    """
    if impl.startswith("native_"):
        impl = "xla_" + impl[len("native_"):]
    if impl == "plain":
        impl = _PLAIN_AS[op]
        if op == "sparse_attn":
            block_k = lk
    if impl == "cuda":
        if op == "sparse_attn":
            peak = hw.peak_tops_high * 1e12 * hw.flop_util
            bw = hw.hbm_gbps * 1e9 * hw.bw_util
            flops = 4.0 * hq * lq * lk * d
            bytes_ = 2.0 * hkv * lk * d * 2.0 + 2.0 * hq * lq * d * 2.0
            return _LAUNCH_S + flops / peak + bytes_ / bw
        return _cuda_gemm_cost(hw, op, m=m, k=k, n=n, keep=keep, block=block,
                               subs=subs, parts=parts, mma=mma)
    peak = hw.peak_tops_low * 1e12 * hw.flop_util
    bw = hw.hbm_gbps * 1e9 * hw.bw_util
    gather_bw = bw / _GATHER_SLOWDOWN.get(hw.name.split("-")[0], 10.0)

    if op in ("ternary_gemm", "das_ternary_gemm"):
        trits = float(k) * n
        sa = keep / block if keep else 1.0
        flops = 2.0 * m * k * n                      # dense-K slab dot
        bytes_ = trits / TRITS_PER_BYTE_F + m * k * 4.0 + m * n * 4.0
        if impl in ("pallas", "interpret"):
            bm = block_m or min(8, m)
            bn = block_n or min(256, n)
            # decode + scatter re-run once per M-tile x N-tile of the grid
            flops += (_DECODE_OPS["pallas"] * trits + m * k * max(keep, 1)) \
                * max(1, -(-m // bm))
            steps = max(1, -(-m // bm)) * max(1, -(-n // bn)) \
                * max(1, k // (320 * max(block_k, 1)))
            t = flops / peak + bytes_ / bw + steps * _STEP_OVERHEAD_S
            return t * (_INTERPRET_PENALTY if impl == "interpret" else 1.0)
        if impl == "xla_gather":
            # decode everything, then per-row gather of the kept K lanes
            flops = 2.0 * m * (k * sa) * n + _DECODE_OPS["plain"] * trits
            bytes_ += m * (k * sa) * n * 4.0 * (bw / gather_bw)
            return flops / peak + bytes_ / bw
        dec = "plain" if impl.endswith("plain") else "f32dec"
        flops += _DECODE_OPS[dec] * trits
        bytes_ += _DECODE_BYTES[dec] * trits
        if impl.startswith("xla_dense"):             # DAS mask prep
            flops += float(m) * k * block
        return flops / peak + bytes_ / bw

    if op == "sparse_attn":
        flops = 4.0 * hq * lq * lk * d
        bytes_ = 2.0 * hkv * lk * d * 4.0 + 2.0 * hq * lq * d * 4.0
        if impl == "xla_flash":
            chunk = block_k or min(512, lk)
            steps = max(1, -(-lk // chunk))
        else:                                        # pallas / interpret
            bq = min(block_m or 128, max(lq, 1))
            bk = min(block_k or 128, max(lk, 1))
            steps = hq * max(1, -(-lq // bq)) * max(1, -(-lk // bk))
        t = flops / peak + bytes_ / bw + steps * _STEP_OVERHEAD_S
        return t * (_INTERPRET_PENALTY if impl == "interpret" else 1.0)

    raise ValueError(f"kernel_cost: unknown op {op!r}")


def e2e(m: ModelShape, hw: HardwareSpec, opt: TenetOpt, *, prefill_tl: int,
        decode_tokens: int) -> E2EReport:
    cp = stage_cost(m, "prefill", prefill_tl, opt)
    cd = stage_cost(m, "decode", prefill_tl + decode_tokens, opt,
                    decode_tokens=decode_tokens)
    tp = _roofline_latency(hw, cp)
    td = _roofline_latency(hw, cd)
    lat = tp + td
    energy = hw.power_w * lat + DRAM_PJ_PER_BYTE * 1e-12 * (cp.bytes + cd.bytes)
    total = cp + cd
    return E2EReport(latency_s=lat, prefill_s=tp, decode_s=td, energy_j=energy,
                     tokens_per_s=decode_tokens / max(td, 1e-12),
                     bytes_moved=total.bytes,
                     flops=total.flops_low + total.flops_high)
