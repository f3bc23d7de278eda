#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py            # every phase, one card

Phases:
  device   require CUDA; print the card's name and power limit (nvidia-smi)
  build    build the six CUDA kernels from src/repro_torch/kernels/csrc
  kernels  hold each kernel against its plain PyTorch version on the card, at
           the serving paths' shapes and a few small GQA / soft-cap /
           empty-slot / int8 cases, each max error beside its tolerance;
           das_topk also with the mask null, with the mask alone at the
           train phase's 8192 rows (K = 2048, 5460, and the other train
           paths' 2560, 5120, 5632, 8960, 10240) and at a dist trainer rank's
           4096 rows (K = 2048, 1024, 2720, 2740), on unaligned rows, with its
           rmsnorm prologue (normed rows within a step, the DAS step exact)
           and bitwise invariant to M; sparse_attention's bf16 prefill class
           also at LPSA packs of three stream offsets, full causal attention
           over partial tiles, head sizes 16 and 80, and bitwise invariance
           to the batch and to the other queries of a tile; the zoo's shapes:
           sparse_attention at head sizes 100 and 256 in every class (full
           rings of 1024 and 4096, an LPSA pack, local packs of 4352 and 768
           keys, float32), each bitwise batch invariant, and das_topk and the
           packed GEMMs at every K of the zoo and gemma2-2b's and bitnet-3b's
           projections; qwen3-moe-30b-a3b's: twd_decode over a whole
           expert stack (exact), das_topk's MoE call (dense rows beside the
           compaction), sparse_attention at 32 q heads over 4 kv heads of 64;
           the SSM pair's: das_topk (plain and gla's norm-fused) and
           das_ternary_gemm at every rwkv6-3b and gla-1.3b projection at 4
           and 1100 rows, ternary_gemm in float32 at 1 and 512 rows;
           zamba2-2.7b's: das_topk (plain at K = 5120 and 10240, norm-fused
           with the normed rows at 2560; at 5120 the norm-fused call beside
           rmsnorm + das_topk) and das_ternary_gemm at every new projection
           at 4 and 1024 rows, sparse_attention at 32 heads of 80 over 32
           (decode over full rings and an LPSA pack, each bitwise batch
           invariant), and layers.xla_cumsum bitwise the CPU's; the
           stub-frontend models' (float32 rows: their residual stream):
           das_topk at K = 1536, 5120, 6144 and 14336, plain and norm-fused
           with a float32 scale, das_ternary_gemm at every musicgen-medium
           and pixtral-12b projection at 4 and 256 rows, ternary_gemm in
           float32 at their FFN shapes, sparse_attention at 32 heads of 160
           over 8 in every class (bf16 decode, float32 queries over bf16
           rings, also at 24/24 of 64, a bf16 and a float32 LPSA pack), each
           bitwise batch invariant
  tune     the packed GEMMs' launch configs and the tuned kernel mode:
           (1) at bitnet-1.3b's shapes (das_ternary_gemm 2048 -> 2048 and
           -> 5460, ternary_gemm 5460 -> 2048; 4 and 256 rows; bf16, and
           float32 as the DAS-off check (4) serves it) every feasible
           config (``subs`` 1, 2, 4, 8 windows a decode block, ``parts``
           1..8 K parts of a tensor-core prefill tile) against the plain
           version (2e-2 bf16, 1e-4 float32), the default config bitwise
           the explicit built-in one and the call without a config, and
           each config batch invariant within its class (the rows of a
           1-row call bitwise those of a 4-row call; of a 5-row call those
           of a 256-row call); (2) bitnet-1.3b at full width and depth,
           packed, bf16: a ServeEngine with kernel_mode="tuned" tunes its
           shapes into a fresh cache at construction (every candidate
           timed: the kernel at each config, the native impls; CUDA events,
           the L2 flushed), and each key prints its winner, its µs, the
           built-in config's µs and every candidate's; (3) two requests of
           the packed trace (prompts 1100 and 300, 32 new tokens) through
           the tuned engine, launch counts at 0 before and read after (each
           kernel its winners take launched), then the default engine:
           tokens (reported, not gated: DAS turns another sum order into
           other tokens), decode ms/step and the 1100-token admission's
           ms (CUDA events: the eager prefill is host-bound) and device
           busy ms (torch.profiler) under each mode; (4) bitnet-1.3b in
           float32 with DAS off, 2 of its layers, full width: a tuned engine
           (its own float32 keys tuned) and the default engine, request 0
           teacher-forced on the default engine's tokens: logits within
           1e-4 of the max logit; (5) a second tuned engine on the same
           cache does zero timed runs
  serve    full-width bitnet-1.3b (seeded random weights) on six paths, each
           driven with the launch counts at 0 and read after it; every
           engine captures its decode step into a CUDA graph after one
           warm-up step and every decode step must be a replay of it:
             packed      base-3 packed weights: a ServeEngine with 4 slots
                         serves 5 staggered greedy requests (one prompt wraps
                         the 1024-slot ring);
             http        the packed model behind ServeHTTPServer (port 0, in
                         this process, the engine on its own thread), top-k
                         40, the deadline scheduler: the packed trace's five
                         prompts sent at once, two greedy unary requests and
                         three sampled at temperature 0.8 as SSE streams, one
                         with an SLO; it fails unless (a) every request
                         answers 200, (b) each stream carries one chunk a
                         token then [DONE], (c) the greedy tokens are the
                         packed path's, (d) every request's tokens are a fresh
                         engine's run() of the same requests and uids, (e) the
                         sampler's keys, bits and uniforms on the card equal
                         its CPU run bitwise over a grid of (uid, counter),
                         (f) the replayed graphs' sampled tokens equal an
                         eager engine's, (g) /metrics counts what EngineStats
                         counts, (h) the engine thread joins within 10 s of
                         stop(), (i) a policy="wave" replay of the packed
                         trace gives the continuous tokens in more decode
                         steps; it prints the time to first SSE chunk, tok/s
                         end to end through HTTP, and the ms/step of the
                         greedy and the sampling graphs at 4 slots;
             paged-lpsa  the packed model under layout="paged": 5 prompts on
                         one 512-token stem, ring states shared through the
                         trie (prefix hits, fewer prefill tokens, the dense
                         engine's tokens);
             paged-full  the packed model with full caches, every layer a
                         page arena: whole-page donors, a partial boundary
                         page and copy-on-write, tokens equal to a dense
                         full-cache run of the same schedule;
             int8w       serve_format "int8": the trits are twd_decode of the
                         packed weights (checked equal to the int8 export),
                         then the packed path's trace through das_gemv;
             baseline    int8 trits, no DAS, no LPSA (full caches): 2 requests;
           each checks token counts, the kernels' launch counts (a replay
           adds the launches its capture recorded), finite logits and
           bitwise batch invariance; packed and int8w also a reduced-size
           model on the card against the CPU; then the decode step of packed
           and int8w under torch.profiler, replayed and eager in turns, the
           device time of admitting the 1100-token prompt (4 packs) and of
           the int8w model load's twd_decode launches; then the zoo, each
           path a model of its own (seeded random weights, packed, bf16):
             gemma2-2b   full width and depth (26 layers, 8 heads of 256
                         over 4, d_ff 9216, vocab 256000, local window 4096,
                         soft-caps, gelu): 4 slots, 5 requests of 32 new
                         tokens, prompts 4400 (wraps both rings), 1100, 300,
                         40, 700;
             bitnet-3b   full width and depth (26 layers, 32 heads of 100,
                         d_ff 8640): bitnet-1.3b's packed trace;
             gemma3-1b, minicpm-2b, stablelm-1.6b  full width, depth cut to
                         one period of the layer pattern (6, 2, 2 layers): 2
                         requests (prompts 700 and 40) of 16 new tokens;
           each with the packed path's checks; gemma2-2b and bitnet-3b also
           the admission of their first prompt and their decode step under
           the profiler, replayed and eager (the same tokens and launches a
           step), and a 2-layer model at their widths on the card against
           the CPU; then the MoE path:
             qwen3-moe-30b-a3b  full width, 4 of its 48 layers (128 experts of
                         768, top-8, 32 heads of 64 over 4, vocab 151936,
                         untied head), exported layer by layer: the packed
                         trace, each expert stack unpacked by one twd_decode
                         launch a call (3 a layer per decode step and per
                         prefill); the admission's dropped copies per layer,
                         routed copies per expert of 3 layers, and profile,
                         the decode step profiled replayed and eager with
                         device time by MoE class, and a 2-layer model at
                         its widths against the CPU (the same dropped
                         copies), with the experts' fake-quant the identity
                         (2e-4) and as served (2e-3, the int8 values and
                         scales that differ counted)
           then the SSM pair, each a model of its own (seeded random weights
           exported layer by layer, packed, bf16, DAS 16/32, no attention):
             rwkv6-3b    full width, 16 of its 32 layers (SSM_DEPTH; 40
                         heads of 64, d_ff 8960, vocab 65536, untied);
             gla-1.3b    full width and all 24 layers (4 heads of 512, d_ff
                         5632, vocab 32000, untied);
           each serves the packed trace from the CUDA graph with its
           recurrent slot states (every prompt prefilled whole at
           admission): exact launch counts (das_topk / das_ternary_gemm 8 / 8
           a rwkv layer and 4 / 8 a gla layer, per decode step and per
           prefill), every step a replay, finite logits, bitwise batch
           invariance, the slot-state layouts; the admission of the
           1100-token prompt (chunk 55) and of a 997-token one (chunk 1: 997
           chunks a layer) by CUDA events, host clock and device time by SSM
           class; the decode step under the profiler, replayed and eager;
           and a 2-layer model at its widths against the CPU (f32, DAS off:
           ternary_gemm at these shapes)
           then the hybrid:
             zamba2-2.7b full width, 12 of its 54 layers (HYBRID_DEPTH: 10
                         mamba, 2 attention positions sharing one block of
                         32 heads of 80, d_ff 10240, vocab 32000, tied),
                         exported layer by layer,
                         packed, bf16, DAS 16/32, LPSA 128 + 896: the packed
                         trace (pack-aligned prefixes prefilled, tails fed a
                         token a tick), exact launch counts (2 / 3 das_topk /
                         das_ternary_gemm a mamba layer per decode step and
                         per prefill), every step a replay, finite logits,
                         bitwise batch invariance, the slot-state layouts; the
                         1100-token admission (the 1024-token prefill by
                         device class, the 76 tail ticks); the decode step
                         under the profiler, replayed and eager, by class,
                         beside the floor of its bytes; one mamba layer's SSD
                         glue (buffer writes, replay row, fold) under a CUDA
                         graph; a 6-layer model at its widths against the CPU
                         (f32, DAS and LPSA off, 508 tokens: a chunk and a
                         remainder, then 8 steps across the fold at t = 511)
           then the stub-frontend models, each fed float32 embedding prompts
           (seeded), so the residual stream is float32 over bf16 weights and
           rings (the reference's), exported layer by layer, packed, bf16,
           DAS 16/32, LPSA 128 + 896:
             musicgen-medium  full width and all 48 layers (24 heads of 64,
                         the 2-matrix gelu MLP of 6144, vocab 2048, untied);
             pixtral-12b full width, 20 of its 40 layers (FRONTEND_DEPTH;
                         32 heads of 160 over 8, the gated silu FFN of
                         14336, vocab 131072,
                         untied: the logits read a float32 copy of the head
                         made once);
           each the packed trace of embedding rows (pack-aligned prefixes
           prefilled, tails fed a row a tick through forced_x), exact launch
           counts (4 / 6 or 7 / 1 a layer a decode step), every step a
           replay, finite logits, bitwise batch invariance, a bf16 ring on
           every layer; musicgen-medium again under layout="paged" (the same
           tokens, no prefix hit); the 1100-row admission by device class;
           the decode step under the profiler, replayed and eager, by class,
           beside the floor of its bytes; a 2-layer model at its widths on
           the card against the CPU (f32, DAS off, the embedding prompt)
  dist     SPMD serving over ranks spawned on cuda:0 (one card: NCCL refuses
           two ranks on one device) that talk over gloo, each loading the
           kernels the build phase built and launching them on its shard;
           one world of 4 ranks, the parent printing the backend and the
           world size: (a) bitnet-1.3b at full width and depth,
           Topology(dp=2, tp=2), the packed trace: every rank samples the
           same tokens and launches das_topk, das_ternary_gemm and
           sparse_attention, and ternary_gemm where its down shard holds
           d_ff's dense tail (ranks 1 and 3), and only there (each shard
           takes its own K's route); the tokens and request 2 teacher-forced
           beside the packed path's (reported with each first difference and
           the one-rank top-2 margin there: a row-parallel sum rounds in
           another order and a DAS decision at a tie turns on it); the same
           model in float32 with DAS off, requests 0, 2 and 4 teacher-forced
           (each prompt's pack-aligned prefix: 4, 1 and 2 packs, the ring
           wrapped at 1024, then 8 steps), within 1e-4 of the one-rank max;
           ms a step, the card's idle share and the collectives a step over
           8 full decode steps (ranks sharing one card over gloo: not a
           multi-card time); (b) the same with 2 ranks lost before decode
           step 3: one reshard, Topology(dp=1, tp=2), (a)'s tokens exactly;
           (c) qwen3-moe-30b-a3b at full width, 2 of 48 layers,
           Topology(tp=2) on ranks 0 and 1: 64 experts a rank, twd_decode
           on each, the tokens and a teacher-forced request beside a
           one-rank run; requests 0, 2 and 4 in float32 with DAS off as in
           (a), within 1e-4 with the experts' int8 fake-quant the identity
           on both sides, and as served (reported: the fake-quant is a
           discontinuity too); then, in the same world, the distributed
           trainer (bitnet-1.3b at full width, Topology(dp=2, tp=2), ZeRO-1,
           4 x 2048 tokens a step): (d) 1 layer in float32 with DAS off and
           the fake-quants on (the whole-weight absmean over "model", a
           row-parallel input's absmax its max over "model") against one
           rank, each rank taking one rank's int8 value or trit where its
           own differs within 1e-5 of a .5 boundary (another sum order moves
           such ties; tests/torch_ties.py ``Replay``, at most 0.01 % of the
           decisions): step 1's loss within 2e-5, every gradient leaf
           (summed over "dp", gathered over "model") within 1e-4 of its max
           and the params after 2 steps within 1e-4; (g) (d)'s state after
           step 1 gathered and checkpointed, restored onto Topology(dp=1,
           tp=2) (2 ranks lost), step 2 there (one rank's ties again) within
           1e-4 of one rank's; (f) the GPipe pipeline at Topology(pods=2,
           dp=1, tp=2), one block a stage on its tp 2 shard (the ternary
           stack off: float32 sums alone), 4 microbatches of 256 tokens: the
           output within 1e-5 and every gradient within 1e-4 of the
           sequential blocks on one rank, then the int8 error-feedback mean
           of (d)'s gradients over the 2 pods within 2 % of the exact mean,
           the residual nonzero; (e) bitnet-1.3b as trained (bf16, DAS
           16/32, remat), 4 of its 24 layers, 2 steps: every rank launches das_topk once for each
           das_train_mask call (8 a layer a step) and the profiler sees as
           many das_topk kernels; each step's loss beside one rank's, ms a
           step, the collectives a step with their bytes and host seconds,
           the card's idle share (the union of the ranks' device spans),
           peak memory a rank (reported), and beside each rank the dry run's
           record of the same cell computed here on the meta device
           (launch/dryrun.py at the rank's position of a virtual
           Topology(dp=2, tp=2)): its state bytes (params, ZeRO-1 moment
           slices, step) and collective wire bytes a step by kind equal to
           the rank's exactly, memory_allocated after setup reported; (h)
           qwen3-moe-30b-a3b at full width, 1 of 48 layers, Topology(dp=2,
           tp=2): 64 experts and the ZeRO-1 slices a rank, float32, DAS on
           (das_topk gives each rank's masks), the fake-quants on, the
           config's capacity factor 1.25, 2 steps of 2 x 1024 tokens a data
           half: against one rank's run of each half alone (its capacity
           from its own tokens), averaged, computed here and freed: the
           loss within 2e-5, every gradient leaf (the rank's part) and
           every param leaf after the steps within 1e-4 of its max, each
           rank taking its half's recorded rounding, routing and
           expert-scale decisions at near ties (tests/torch_ties.py
           ``Replay``), das_topk launched on every rank, the dropped copies
           reported
  train    QAT training of bitnet-1.3b at full width (d_model 2048, d_ff 5460,
           vocab 32000, bf16 masters from the config, remat on; seeded random
           weights, SyntheticLM batches of 4 x 2048 tokens, so LPSA's sink of
           128 and window of 896 cut keys), through the port's train step
           (models/model.py loss_fn under autograd, the STE fake-quants, the
           DAS mask of every projection's input from das_topk with the mask
           alone, AdamW, warmup 2 + cosine): first on a 2-layer cut, (c) one
           step's DAS masks from the kernel equal the plain das_mask's on the
           card exactly and the loss and every gradient leaf within 2e-2 of
           the leaf's max (bitwise reported), (d) 2 steps, a checkpoint saved
           and restored, 2 more steps equal to 4 straight steps bitwise
           (params, moments, step); then all 24 layers for 4 steps: (a) every
           loss and gradient norm finite, the rate the schedule's, (b)
           das_topk launched 8 times a layer a step (4 forward, 4 in remat's
           recompute) and no other kernel; ms/step (CUDA events), tok/s, peak
           memory, the last step's device time by class under torch.profiler
           (cuBLAS GEMMs of the linears and logits, of the float32 attention,
           das_topk, attention glue, fake-quant and other elementwise, the
           optimizer); das_topk's training calls timed alone; (e) the trained
           model exported packed serves one greedy request of 16 tokens
           through ServeEngine with the serving kernels launched; then the
           other block kinds at full width (TRAIN_PATHS), each 3 steps of
           4 x 2048 tokens, bf16 masters, remat, warmup 2 + cosine, the
           last profiled:
             qwen3-moe-30b-a3b  2 of 48 layers (what one H100 holds:
                         0.61 B parameters a layer, the untied head and
                         embedding 0.62 B), the experts' fake-quant with
                         one scale an expert, the router, the dispatch at
                         the training capacity;
             zamba2-2.7b 12 layers (10 mamba, the shared attention at two
                         positions);
             gla-1.3b, rwkv6-3b  2 layers each;
           each (c) on a cut (2 layers; zamba2 one pattern period of 6):
           the kernel's masks equal the plain das_mask's, and the loss,
           every gradient and every updated param bitwise; (a)
           finite losses and gradient norms, the schedule's rates; (b)
           das_topk launched once a DAS input a layer forward, twice with
           remat (MoE 3 a layer, mamba 2, gla 4, rwkv 8, zamba2's attention
           block 4), no other kernel; ms/step, tok/s, peak memory, busy by
           class (chunk scans and the MoE's dispatch apart); the MoE's
           dropped copies a layer at the training capacity
  times    each kernel at its decode shape: CUDA-event median beside its
           bound, its plain version and one PyTorch call of the same function;
           the packed GEMMs and das_gemv also at their other decode shapes
           and one 256-row prefill pack, sparse_attention's prefill classes
           at packs of three stream offsets and at full causal attention,
           beside their bounds, plain versions and library calls; das_topk's
           serving calls (mask null, norm-fused) at decode and at a pack;
           sparse_attention's decode over a paged-full view, and the gather;
           sparse_attention at head sizes 100 and 256 in every class, and
           das_topk and das_ternary_gemm at gemma2-2b's decode shapes;
           twd_decode over qwen3-moe's expert stacks, sparse_attention at its
           32 over 4 heads of 64; das_ternary_gemm and das_topk at every SSM
           projection at decode and at the 1100-token admission, and the
           MoE's das_topk call at 4 and 1024 rows; zamba2-2.7b's GEMM and
           das_topk shapes at 4 and 1024 rows, sparse_attention at 32 heads
           of 80 (decode, LPSA pack), and ternary_gemm in float32 at the SSM
           pair's projections at 1 and 512 rows; the stub-frontend models'
           float32 shapes (das_ternary_gemm and das_topk at 4 and 256 rows,
           ternary_gemm at 1 and 512), sparse_attention at 32/8 heads of 160
           (bf16 decode, bf16 and float32 LPSA packs) and the float32-query
           decode over bf16 rings (library: SDPA on K/V upcast to float32);
           bitnet-1.3b's tp = 2 shard shapes at a rank's 2 decode rows
           (das_topk, the packed GEMMs, sparse_attention over 16 heads); the
           dist trainer's das_topk calls at a rank's 4096 rows (K = 2048,
           1024, 2720, 2740); das_ternary_gemm's 256-row q/k/v/o beside a
           bf16 matmul, and ternary_gemm on float32 rows with DAS off at
           256 rows (2048 -> 2048, -> 5460, 5460 -> 2048) beside a float32
           matmul with TF32 off
  profile  (only when named) the packed and int8w decode steps and the
           admission under torch.profiler, as the serve phase profiles them
  http     (only when named) the serve phase's packed path, then its http
           path on the same model: ``--phases build,http`` drives (a)-(i)

  python3 chip_smoke.py --parent DIR   # then the times and profile phases on
                                       # DIR's package and on this tree's in
                                       # turns: DIR, this, this, DIR
  python3 chip_smoke.py --src DIR/src  # the phases on another tree's package

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Any failure exits non-zero without them.
The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "tune", "serve", "dist", "train", "times")
OPTIONAL_PHASES = ("profile", "http")   # run only when named

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the TPU kernel each CUDA kernel replaces (the pallas_call line)
KERNEL_INFO = {
    "das_topk": ("src/repro_torch/kernels/csrc/topk_mask.cu",
                 "src/repro/kernels/topk_mask.py:52"),
    "das_ternary_gemm": ("src/repro_torch/kernels/csrc/das_gemm.cu",
                         "src/repro/kernels/das_gemm.py:189"),
    "ternary_gemm": ("src/repro_torch/kernels/csrc/ternary_gemm.cu",
                     "src/repro/kernels/ternary_gemm.py:133"),
    "sparse_attention": ("src/repro_torch/kernels/csrc/sparse_attn.cu",
                         "src/repro/kernels/sparse_attn.py:97"),
    "twd_decode": ("src/repro_torch/kernels/csrc/twd_decode.cu",
                   "src/repro/kernels/ternary_gemm.py:60"),
    "das_gemv": ("src/repro_torch/kernels/csrc/das_gemv.cu",
                 "src/repro/kernels/das_gemm.py:90"),
}

TOL_F32_GEMM, TOL_BF16, TOL_F32_ATTN = 1e-4, 2e-2, 3e-4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048            # the train phase's batch: 4 x 2048 tokens
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
# the K of every DAS input on the train paths: bitnet-1.3b's 2048 and 5460,
# zamba2-2.7b's 2560 / 5120 / 10240, gla-1.3b's 5632, rwkv6-3b's 8960
TRAIN_TOPK_K = (2048, 5460, 2560, 5120, 5632, 8960, 10240)
# a dist trainer rank's DAS inputs (bitnet-1.3b at dp 2 x tp 2): its 2 x 2048
# rows at K = 2048 (q/k/v, gate/up: replicated), 1024 (o: its 16 heads) and
# 2720 / 2740 (down: rank 0's and rank 1's d_ff shard, the dense tail last)
DIST_TRAIN_ROWS = TRAIN_ROWS // 2
DIST_TOPK_K = (2048, 1024, 2720, 2740)
FULL_SINK = 1 << 30                     # the full-cache prefill's sink: every key


def pack_positions(torch, t0, sink=128, window=896, chunk=256):
    """(q_pos (chunk,), k_pos (sink + window + chunk,)) int32 of the LPSA
    streaming prefill's pack at t0, keys [sink | window | pack], -1 for an
    empty slot: core/lpsa.py::pack_positions, copied because the times phase
    also runs on trees whose package predates it (--parent)."""
    slot = torch.arange(sink)
    win = t0 - window + torch.arange(window)
    pack = t0 + torch.arange(chunk)
    k_pos = torch.cat([torch.where(slot < t0, slot, -1),
                       torch.where((win >= sink) & (win >= 0), win, -1), pack])
    return pack.to(torch.int32), k_pos.to(torch.int32)



def ring_positions(torch, t, sink, window):
    """(sink + window,) int32 positions held by a ring cache after token t
    (the sink slots, then slot sink + (p - sink) % window for p >= sink; -1:
    an empty slot)."""
    slot = torch.arange(sink)
    j = torch.arange(window)
    back = t - sink - j
    win = torch.where(back >= 0, sink + j + window * torch.div(back, window, rounding_mode="floor"),
                      -1)
    return torch.cat([torch.where(slot <= t, slot, -1), win]).to(torch.int32)


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch, seed: int):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.seed = seed
        self.errs: dict[str, float] = {}       # kernel -> max error at its timed shape
        self.launches: dict[str, int] = {name: 0 for name in KERNEL_INFO}  # summed over paths
        self.timed: dict[str, dict] = {}

    # -- helpers -----------------------------------------------------------

    def gen(self, seed):
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(seed)
        return g

    def _inputs(self, prompt, device=None):
        """A prompt as a model takes it, batch 1: (1, P) token ids, or (1, P,
        D) float32 embeddings for a stub frontend's (P, D) prompt."""
        torch = self.torch
        dtype = torch.float32 if prompt.ndim == 2 else torch.long
        return torch.as_tensor(prompt, dtype=dtype,
                               device=self.dev if device is None else device)[None]

    def check(self, label: str, got, want, tol: float, exact: bool = False) -> float:
        torch = self.torch
        torch.cuda.synchronize()
        got_f, want_f = got.float().cpu(), want.float().cpu()
        if got_f.shape != want_f.shape:
            raise AssertionError(f"{label}: shape {tuple(got_f.shape)} != "
                                 f"{tuple(want_f.shape)}")
        err = float((got_f - want_f).abs().max()) if got_f.numel() else 0.0
        if exact:
            ok = torch.equal(got_f, want_f)
        else:
            ok = bool(torch.isfinite(got_f).all()) and bool(
                ((got_f - want_f).abs() <= tol + tol * want_f.abs()).all())
        log(f"[kernels] {label}: max_abs_err {err:.3e} "
            f"(tol {'exact' if exact else f'{tol:g} abs+rel'}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version")
        return err

    # -- phases ------------------------------------------------------------

    def phase_build(self):
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.library(verbose=True)
        log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
            f"(nvcc {build.last_build_seconds() or 0.0:.1f} s) -> {build.BUILD_DIR}")

    def _packed(self, g, k, n):
        from repro_torch.core import twd
        trits = self.torch.randint(-1, 2, (k, n), generator=g, device=self.dev)
        return twd.pack_ternary(trits, row_align=16)

    def phase_kernels(self):
        torch = self.torch
        from repro_torch.core import das as das_lib
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.das_gemv import das_gemv_cuda
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        from repro_torch.kernels.twd_decode import twd_decode_cuda
        g = self.gen(self.seed + 1)
        bf16, f32 = torch.bfloat16, torch.float32
        scale = torch.tensor(0.37, device=self.dev)

        self._topk_cases(g)

        # das_ternary_gemm: q/k/v/o (N=2048) and gate/up (N=5460), padded rows
        for m, k, n, dt in ((4, 2048, 2048, bf16), (4, 2048, 5460, bf16),
                            (256, 2048, 2048, bf16), (256, 2048, 5460, bf16),
                            (4, 2048, 2048, f32), (3, 320, 130, f32)):
            x = torch.randn((m, k), generator=g, device=self.dev).to(dt)
            ca = das_lib.das_compact(x, block_size=32, keep=16)
            packed = self._packed(g, k, n)
            got = das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale, keep=16)
            want = ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale)
            tol = TOL_BF16 if dt == bf16 else TOL_F32_GEMM
            err = self.check(f"das_ternary_gemm {dt} ({m},{k})x({packed.shape[0]},{n})",
                             got, want, tol)
            if (m, k, n, dt) == (4, 2048, 5460, bf16):
                self.errs["das_ternary_gemm"] = err

        # ternary_gemm: the down projection (K=5460, DAS-masked dense input)
        for m, k, n, dt in ((4, 5460, 2048, bf16), (256, 5460, 2048, bf16),
                            (4, 5460, 2048, f32), (8, 640, 256, torch.int8)):
            if dt == torch.int8:
                x = torch.randint(-127, 128, (m, k), generator=g, device=self.dev).to(dt)
                xs = torch.rand((m, 1), generator=g, device=self.dev) + 0.5
            else:
                v = torch.randn((m, k), generator=g, device=self.dev).to(dt)
                x = das_lib.das_apply(v, das_lib.das_mask(v, keep=16))
                xs = None
            packed = self._packed(g, k, n)
            got = ternary_gemm_cuda(x, packed, scale, xs)
            want = ref.ternary_gemm_ref(x, packed, scale, xs)
            exact = dt == torch.int8
            tol = TOL_BF16 if dt == bf16 else TOL_F32_GEMM
            err = self.check(f"ternary_gemm {dt} ({m},{k})x({packed.shape[0]},{n})",
                             got, want, tol, exact)
            if (m, k, n, dt) == (4, 5460, 2048, bf16):
                self.errs["ternary_gemm"] = err

        # twd_decode: every projection shape's packed rows -> trits (exact),
        # N = 2048 (16-byte vectors), 5460 (4-byte) and odd (bytes), the
        # export's padding rows past K
        for k, n in ((2048, 2048), (2048, 5460), (5460, 2048), (77, 1001)):
            packed = self._packed(g, k, n)
            err = self.check(f"twd_decode ({packed.shape[0]},{n}) -> ({k},{n})",
                             twd_decode_cuda(packed, k), ref.twd_decode_ref(packed, k),
                             0, True)
            if (k, n) == (2048, 5460):
                self.errs["twd_decode"] = err

        # das_gemv: the int8w projections (compacted rows, dense rows with the
        # 20-lane tail of the down projection) and the baseline's (DAS off),
        # at decode and at a 256-row prefill pack; K = 2048 and 5460 end in a
        # partial 160-lane window
        def gemv_case(form, m, k, n, dt, w):
            x = torch.randn((m, k), generator=g, device=self.dev).to(dt)
            if form == "compact":
                ca = das_lib.das_compact(x, block_size=32, keep=16)
                vals, idx = ca.values, ca.indices
            elif form == "dense":
                vals, idx = das_lib.das_apply(x, das_lib.das_mask(x, keep=16)), None
            else:
                vals, idx = x, None
            tol = TOL_BF16 if dt == bf16 else TOL_F32_GEMM
            return self.check(f"das_gemv {form} {dt} ({m},{vals.shape[1]} of {k})x({k},{n})",
                              das_gemv_cuda(vals, idx, w, scale, keep=16),
                              ref.das_gemv_ref(vals, idx, w, scale), tol)

        def trits(k, n):
            return torch.randint(-1, 2, (k, n), generator=g, device=self.dev).to(torch.int8)

        for form, k, n in (("compact", 2048, 2048), ("compact", 2048, 5460),
                           ("dense", 5460, 2048), ("off", 2048, 5460),
                           ("off", 5460, 2048)):
            w = trits(k, n)
            for m in (4, 256):
                for dt in (f32, bf16):
                    err = gemv_case(form, m, k, n, dt, w)
                    if (form, m, k, n, dt) == ("compact", 4, 2048, 5460, bf16):
                        self.errs["das_gemv"] = err
        # the decode class's edges: N not a multiple of 4 (byte loads), K =
        # 9216 (58 windows: 4 a block, 15 blocks a cluster); a prefill that N
        # sends to the FMA route
        for form, m, k, n, dt in (("compact", 4, 2048, 130, bf16), ("dense", 3, 5460, 130, f32),
                                  ("compact", 4, 9216, 2048, bf16), ("off", 4, 9216, 2048, f32),
                                  ("compact", 256, 9216, 130, bf16)):
            gemv_case(form, m, k, n, dt, trits(k, n))

        # sparse_attention: ring decode, prefill pack, GQA, soft-cap, empty row
        def attn_case(label, b, lq, lk, hq, hkv, d, dt, q_pos, k_pos, sink, window,
                      cap=None, tol=TOL_BF16, rs=False):
            q = torch.randn((b, lq, hq, d), generator=g, device=self.dev).to(dt)
            k_ = torch.randn((b, lk, hkv, d), generator=g, device=self.dev).to(dt)
            v = torch.randn((b, lk, hkv, d), generator=g, device=self.dev).to(dt)
            got = sparse_attention_cuda(q, k_, v, q_pos, k_pos, sink=sink, window=window,
                                        softcap=cap, round_scores=rs)
            want = ref.sparse_attention_ref(q, k_, v, q_pos, k_pos, sink=sink,
                                            window=window, softcap=cap, round_scores=rs)
            return self.check(f"sparse_attention {label}", got, want, tol)

        i32 = torch.int32
        # decode: 4 slots at positions that wrap the 128 + 896 ring differently
        qp = torch.tensor([[1500], [1023], [300], [5]], dtype=i32, device=self.dev)
        ring = []
        for t in qp[:, 0].tolist():
            pos = torch.full((1024,), -1, dtype=torch.int64)
            for p in range(t + 1):
                pos[p if p < 128 else 128 + (p - 128) % 896] = p
            ring.append(pos)
        kp = torch.stack(ring).to(i32).to(self.dev)
        self.errs["sparse_attention"] = attn_case(
            "decode bf16 B=4 H=32 Lk=1024", 4, 1, 1024, 32, 32, 64, bf16, qp, kp, 128, 896)
        # prefill pack 2 of a 3-pack prompt: [sink | window | pack] keys
        t0 = 512
        sink_pos = torch.where(torch.arange(128) < t0, torch.arange(128), -1)
        win = t0 - 896 + torch.arange(896)
        win_pos = torch.where((win >= 128) & (win >= 0), win, -1)
        kp = torch.cat([sink_pos, win_pos, t0 + torch.arange(256)]).to(i32)
        attn_case("prefill bf16 Lq=256 Lk=1280", 1, 256, 1280, 32, 32, 64, bf16,
                  (t0 + torch.arange(256)).to(i32)[None].to(self.dev),
                  kp[None].to(self.dev), 128, 896)
        # the streaming prefill's option: scores rounded to bf16 before the scale
        attn_case("prefill bf16 Lq=256 Lk=1280 round_scores", 1, 256, 1280, 32, 32, 64,
                  bf16, (t0 + torch.arange(256)).to(i32)[None].to(self.dev),
                  kp[None].to(self.dev), 128, 896, rs=True)
        # the decode class's edges (keys split over a cluster by Lk alone): a
        # row with every chunk masked, a full cache of 2500 keys (16 blocks of
        # 157, two tiles each) under GQA 32/8, float32 head_dim 80 with
        # soft-cap (64-key tiles), and scores rounded to bf16
        qp = torch.tensor([[1500], [40], [1023], [7]], dtype=i32, device=self.dev)
        kp = torch.stack(ring[:2] + ring[:2]).to(i32).to(self.dev)
        kp[1] = -1
        attn_case("decode bf16 B=4 Lk=1024 with an empty row", 4, 1, 1024, 32, 32, 64, bf16,
                  qp, kp, 128, 896)
        qp = torch.tensor([[2499], [1200]], dtype=i32, device=self.dev)
        kp = torch.arange(2500, dtype=i32, device=self.dev)[None].repeat(2, 1)
        kp[1, 1201:] = -1
        attn_case("decode bf16 full cache Lk=2500 GQA 32/8", 2, 1, 2500, 32, 8, 64, bf16, qp, kp,
                  1 << 30, 1 << 30)
        qp = torch.tensor([[650], [90]], dtype=i32, device=self.dev)
        kp = torch.arange(700, dtype=i32, device=self.dev)[None].repeat(2, 1)
        attn_case("decode f32 head_dim 80 softcap Lk=700", 2, 1, 700, 8, 4, 80, f32, qp, kp,
                  16, 256, cap=30.0, tol=TOL_F32_ATTN)
        qp = torch.tensor([[1500], [1023], [300], [5]], dtype=i32, device=self.dev)
        attn_case("decode bf16 round_scores", 4, 1, 1024, 32, 32, 64, bf16, qp,
                  torch.stack(ring).to(i32).to(self.dev), 128, 896, rs=True)
        # GQA + soft-cap + an empty row (every slot -1) in float32
        qp = torch.tensor([[40, 41], [7, 8]], dtype=i32, device=self.dev)
        kp = torch.arange(48, dtype=i32, device=self.dev)[None].repeat(2, 1)
        kp[1] = -1
        attn_case("gqa 8/2 softcap f32 + empty row", 2, 2, 48, 8, 2, 64, f32, qp, kp,
                  4, 16, cap=30.0, tol=TOL_F32_ATTN)
        for d in (16, 80):
            qp = torch.tensor([[30]], dtype=i32, device=self.dev)
            kp = torch.arange(32, dtype=i32, device=self.dev)[None]
            attn_case(f"head_dim {d} f32", 1, 1, 32, 4, 2, d, f32, qp, kp, 8, 24,
                      tol=TOL_F32_ATTN)
        self._prefill_cases(g)
        self._zoo_attention_cases(g)
        self._zoo_gemm_cases(g)
        self._moe_cases(g)
        self._ssm_cases(g)
        self._hybrid_cases(g)
        self._frontend_cases(g)

    def _topk_cases(self, g):
        """das_topk against its plain version, exactly: bitnet-1.3b's widths
        at decode and at a pack (K = 5460: 8-byte vectors, odd rows 8 bytes
        past a 16-byte boundary, a 20-lane partial block), tie-heavy float32
        rows, rows from row 1 of a larger tensor, the mask requested and
        not; the rmsnorm prologue (its normed rows within one bf16 step of
        rmsnorm(scale, x), the DAS step of those rows exact); bitwise
        invariance to M (a row alone, among 4, among 256)."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.topk_mask import das_topk_cuda
        from repro_torch.models.layers import rmsnorm
        bf16, f32 = torch.bfloat16, torch.float32

        def rows(m, k, dt):
            if dt == f32:   # tie-heavy integers exercise the lower-lane rule
                return torch.randint(-3, 4, (m, k), generator=g, device=self.dev).to(dt)
            return torch.randn((m, k), generator=g, device=self.dev).to(dt)

        def same(label, got, want):
            err = 0.0
            for name, a, b in zip(ref.DasTopK._fields, got, want):
                if (a is None) != (b is None):
                    raise AssertionError(f"das_topk {label}: {name} is {a is None} vs "
                                         f"{b is None} None")
                if a is not None:
                    err = max(err, self.check(f"das_topk {label} {name}", a, b, 0, True))
            return err

        for m, k, dt in ((4, 2048, bf16), (256, 2048, bf16), (4, 5460, bf16),
                         (256, 5460, bf16), (3, 96, f32)):
            x = rows(m, k, dt)
            err = same(f"{dt} ({m},{k})", das_topk_cuda(x, keep=16, block=32),
                       ref.das_topk_ref(x, keep=16, block=32))
            if (m, k, dt) == (4, 2048, bf16):
                self.errs["das_topk"] = err
            same(f"{dt} ({m},{k}) mask null", das_topk_cuda(x, keep=16, block=32,
                                                           with_mask=False),
                 ref.das_topk_ref(x, keep=16, block=32, with_mask=False))
        x = rows(5, 5460, bf16)[1:]     # starts 8 bytes past a 16-byte boundary
        same("bf16 (4,5460) from row 1", das_topk_cuda(x, keep=16, block=32),
             ref.das_topk_ref(x, keep=16, block=32))
        # the training step's call, the mask alone: one rank, then a dist rank's shards
        for m, k in [(TRAIN_ROWS, k) for k in TRAIN_TOPK_K] + [(DIST_TRAIN_ROWS, k)
                                                              for k in DIST_TOPK_K]:
            x = rows(m, k, bf16)
            got = das_topk_cuda(x, keep=16, block=32, with_compact=False)
            same(f"training, mask only ({m},{k})", got,
                 ref.das_topk_ref(x, keep=16, block=32, with_compact=False))
            if k % 32 and not bool((got.mask[:, k - k % 32:] == 1).all()):
                raise AssertionError("das_topk: the dense tail lanes are not all kept")

        for m, k, dt in ((4, 2048, bf16), (256, 2048, bf16), (4, 5460, bf16),
                         (256, 5460, bf16), (3, 96, f32)):
            x = torch.randn((m, k), generator=g, device=self.dev).to(dt)
            scale = (0.5 * torch.randn((k,), generator=g, device=self.dev)).to(dt)
            got = das_topk_cuda(x, keep=16, block=32, norm_scale=scale, with_normed=True)
            want = rmsnorm(scale, x)
            mant = 7 if dt == bf16 else 23
            step = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -100)))
                              - mant)
            steps = float(((got.normed.float() - want.float()).abs() / step).max())
            tol = 1 if dt == bf16 else 8    # another order of the sum of squares
            log(f"[kernels] das_topk norm {dt} ({m},{k}) normed vs rmsnorm(scale, x): "
                f"{int((got.normed != want).sum())} of {want.numel()} differ, max {steps:.2f} "
                f"steps of {str(dt)[6:]} (tol {tol}) {'ok' if steps <= tol else 'FAIL'}")
            if steps > tol:
                raise AssertionError("das_topk's norm prologue disagrees with rmsnorm")
            same(f"norm {dt} ({m},{k}) vs das_topk_ref(normed)", got[:4],
                 ref.das_topk_ref(got.normed, keep=16, block=32)[:4])

        for k in (2048, 5460):          # batch invariance, bitwise
            x = torch.randn((256, k), generator=g, device=self.dev).to(bf16)
            scale = (0.5 * torch.randn((k,), generator=g, device=self.dev)).to(bf16)
            for sc in (None, scale):
                kw = dict(keep=16, block=32, norm_scale=sc, with_normed=sc is not None)
                full, four = das_topk_cuda(x, **kw), das_topk_cuda(x[:4], **kw)
                for i in (0, 3):
                    one = das_topk_cuda(x[i:i + 1], **kw)
                    for a, b, c in zip(one, four, full):
                        if a is not None and not (torch.equal(a[0], b[i])
                                                  and torch.equal(a[0], c[i])):
                            raise AssertionError(f"das_topk row {i} depends on M")
                log(f"[kernels] das_topk invariance K={k} norm={sc is not None}: rows 0 and 3 "
                    f"alone, among 4 and among 256: bitwise identical")

    def _prefill_cases(self, g):
        """sparse_attention's bf16 prefill class (Lq > 1, tensor cores)
        against its plain version: LPSA packs at three stream offsets (most
        sink and window slots empty at t0 = 0 and 512), full causal
        attention over partial tiles, GQA 32/8, head sizes 16 and 80,
        round_scores with soft-cap, an empty batch row (exact 0); then
        bitwise invariance to the batch and to the other queries of a tile."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        dev, bf16 = self.dev, torch.bfloat16

        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev).to(bf16)

        def attend(q, k, v, qp, kp, sink, window, cap=None, rs=False):
            return sparse_attention_cuda(q, k, v, qp, kp, sink=sink, window=window,
                                         softcap=cap, round_scores=rs)

        def case(label, q, k, v, qp, kp, sink, window, cap=None, rs=False):
            got = attend(q, k, v, qp, kp, sink, window, cap, rs)
            want = ref.sparse_attention_ref(q, k, v, qp, kp, sink=sink, window=window,
                                            softcap=cap, round_scores=rs)
            self.check(f"sparse_attention prefill {label}", got, want, TOL_BF16)
            if not rs:   # a diagnostic: the distance from the exact result, in bf16 steps
                exact = ref.sparse_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                                                 sink=sink, window=window, softcap=cap)
                step = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2 ** -6))) - 7)
                ulps = float(((got.float() - exact).abs() / step).max())
                log(f"[kernels]   {label}: max {ulps:.3f} bf16 steps (of |out| >= 2^-6) from "
                    f"the float32 result (0.5: correctly rounded)")
            return got

        def pack(t0, b=1):
            qp, kp = pack_positions(torch, t0)
            return qp[None].repeat(b, 1).to(dev), kp[None].repeat(b, 1).to(dev)

        h, d = 32, 64
        for t0 in (0, 512, 2000):
            qp, kp = pack(t0)
            case(f"pack t0={t0} bf16 Lq=256 Lk=1280 round_scores", rand(1, 256, h, d),
                 rand(1, 1280, h, d), rand(1, 1280, h, d), qp, kp, 128, 896, rs=True)
        qp, kp = pack(2000)
        case("pack t0=2000 bf16 Lq=256 Lk=1280", rand(1, 256, h, d), rand(1, 1280, h, d),
             rand(1, 1280, h, d), qp, kp, 128, 896)
        pos = torch.arange(300, dtype=torch.int32, device=dev)[None]
        case("full causal Lq=Lk=300 (partial tiles)", rand(1, 300, h, d), rand(1, 300, h, d),
             rand(1, 300, h, d), pos, pos, FULL_SINK, 0)
        qp, kp = pack(512)
        case("pack t0=512 GQA 32/8", rand(1, 256, 32, d), rand(1, 1280, 8, d),
             rand(1, 1280, 8, d), qp, kp, 128, 896, rs=True)
        for dd in (16, 80):
            qp = (100 + torch.arange(100, dtype=torch.int32, device=dev))[None].repeat(2, 1)
            kp = torch.arange(200, dtype=torch.int32, device=dev)[None].repeat(2, 1)
            kp[1, 150:] = -1
            case(f"head_dim {dd} B=2 Lq=100 Lk=200 GQA 8/4", rand(2, 100, 8, dd),
                 rand(2, 200, 4, dd), rand(2, 200, 4, dd), qp, kp, 16, 64)
        qp, kp = pack(512)
        case("pack t0=512 H=8 round_scores + softcap 30", rand(1, 256, 8, d),
             rand(1, 1280, 8, d), rand(1, 1280, 8, d), qp, kp, 128, 896, cap=30.0, rs=True)
        qp, kp = pack(512, 2)
        kp[1] = -1
        out = case("pack t0=512 B=2, row 1 all keys empty", rand(2, 256, h, d),
                   rand(2, 1280, h, d), rand(2, 1280, h, d), qp, kp, 128, 896, rs=True)
        if out[1].any():
            raise AssertionError("a batch row with no allowed key must give exact 0")
        log("[kernels] sparse_attention prefill empty row: exact 0")

        # batch invariance: row 1 of a B = 2 call (rows at t0 = 2000 and 512)
        # is a B = 1 call on it; queries [64, 128) and [37, 101) of a pack are
        # a call on those queries alone
        q, k, v = rand(2, 256, h, d), rand(2, 1280, h, d), rand(2, 1280, h, d)
        qa, ka = pack(2000)
        qb, kb = pack(512)
        qp, kp = torch.cat([qa, qb]), torch.cat([ka, kb])
        full = attend(q, k, v, qp, kp, 128, 896, rs=True)
        one = attend(q[1:], k[1:], v[1:], qp[1:], kp[1:], 128, 896, rs=True)
        checks = [("row 1 of B=2 vs B=1", one, full[1:])]
        for lo, hi in ((64, 128), (37, 101)):
            sub = attend(q[1:, lo:hi].contiguous(), k[1:], v[1:],
                         qp[1:, lo:hi].contiguous(), kp[1:], 128, 896, rs=True)
            checks.append((f"queries [{lo},{hi}) alone vs in the pack", sub, full[1:, lo:hi]))
        for label, got, want in checks:
            self.check(f"sparse_attention prefill invariance, {label}", got, want, 0, True)

    def _zoo_attention_cases(self, g):
        """sparse_attention at the zoo's head sizes against its plain version:
        100 (bitnet-3b, 32/32 heads; bf16 rows of 200 bytes) and 256 (gemma2-2b
        8/4 with soft-cap 50, gemma3-1b 4/1).  The decode class over full
        rings of 1024 (LPSA 128 + 896) and 4096 (gemma2's local window, 16
        blocks a cluster) in bf16, and in float32; the bf16 prefill class at
        an LPSA pack, at a local pack (sink 0, window 4096: 4352 keys) and at
        gemma3's local pack (window 512); the float32 prefill class; then
        each class bitwise invariant to the batch, and the prefill class to
        the other queries of a tile."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        dev, bf16, f32, i32 = self.dev, torch.bfloat16, torch.float32, torch.int32

        def rand(shape, dt):
            return torch.randn(shape, generator=g, device=dev).to(dt)

        def attend(q, k, v, qp, kp, kw):
            return sparse_attention_cuda(q, k, v, qp, kp, **kw)

        def case(label, hq, hkv, d, dt, qp, kp, kw):
            b, lq, lk = qp.shape[0], qp.shape[1], kp.shape[1]
            q, k, v = rand((b, lq, hq, d), dt), rand((b, lk, hkv, d), dt), rand((b, lk, hkv, d), dt)
            got = attend(q, k, v, qp, kp, kw)
            tol = TOL_BF16 if dt == bf16 else TOL_F32_ATTN
            self.check(f"sparse_attention {label}", got,
                       ref.sparse_attention_ref(q, k, v, qp, kp, **kw), tol)
            return q, k, v, got

        decode_rows = (5000, 4095, 700, 5)
        for label, hq, hkv, d, dt, sink, window, cap in (
                ("D=256 GQA 8/4 softcap 50 ring 1024", 8, 4, 256, bf16, 128, 896, 50.0),
                ("D=256 GQA 8/4 softcap 50 local ring 4096", 8, 4, 256, bf16, 0, 4096, 50.0),
                ("D=256 GQA 4/1 ring 1024", 4, 1, 256, bf16, 128, 896, None),
                ("D=100 32/32 ring 1024", 32, 32, 100, bf16, 128, 896, None),
                ("D=100 f32 ring 1024", 8, 8, 100, f32, 128, 896, None),
                ("D=256 f32 GQA 8/4 softcap 50 ring 1024", 8, 4, 256, f32, 128, 896, 50.0)):
            qp = torch.tensor(decode_rows, dtype=i32, device=dev)[:, None]
            kp = torch.stack([ring_positions(torch, t, sink, window)
                              for t in decode_rows]).to(dev)
            kw = dict(sink=sink, window=window, softcap=cap)
            q, k, v, full = case(f"decode {label}", hq, hkv, d, dt, qp, kp, kw)
            for i in (0, 3):
                one = attend(q[i:i + 1], k[i:i + 1], v[i:i + 1], qp[i:i + 1], kp[i:i + 1], kw)
                self.check(f"sparse_attention decode invariance {label}, row {i} alone vs "
                           f"among 4", one, full[i:i + 1], 0, True)

        def pack(t0, sink, window, b=1):
            qp, kp = pack_positions(torch, t0, sink, window)
            return qp[None].repeat(b, 1).to(dev), kp[None].repeat(b, 1).to(dev)

        for label, hq, hkv, d, t0, sink, window, cap in (
                ("D=256 GQA 8/4 softcap 50 LPSA pack t0=2000", 8, 4, 256, 2000, 128, 896, 50.0),
                ("D=256 GQA 8/4 softcap 50 local pack t0=4400 (4352 keys)", 8, 4, 256, 4400, 0,
                 4096, 50.0),
                ("D=256 GQA 4/1 local pack t0=700 window 512", 4, 1, 256, 700, 0, 512, None),
                ("D=100 32/32 LPSA pack t0=2000", 32, 32, 100, 2000, 128, 896, None),
                ("D=100 32/32 LPSA pack t0=0", 32, 32, 100, 0, 128, 896, None)):
            qp, kp = pack(t0, sink, window)
            case(f"prefill bf16 {label} round_scores", hq, hkv, d, bf16, qp, kp,
                 dict(sink=sink, window=window, softcap=cap, round_scores=True))
        for d, hq, hkv in ((100, 8, 8), (256, 8, 4)):
            qp = (40 + torch.arange(16, dtype=i32, device=dev))[None].repeat(2, 1)
            kp = torch.arange(64, dtype=i32, device=dev)[None].repeat(2, 1)
            kp[1, 30:] = -1
            case(f"prefill f32 D={d} B=2 Lq=16 Lk=64 GQA {hq}/{hkv} softcap 50", hq, hkv, d, f32,
                 qp, kp, dict(sink=8, window=24, softcap=50.0))

        # prefill invariance at each new head size: row 1 of a B = 2 call
        # (rows at t0 = 2000 and 512) is a B = 1 call; queries [37, 101) of
        # a pack are a call on them alone
        for d, hq, hkv, cap in ((100, 32, 32, None), (256, 8, 4, 50.0)):
            kw = dict(sink=128, window=896, softcap=cap, round_scores=True)
            qa, ka = pack(2000, 128, 896)
            qb, kb = pack(512, 128, 896)
            qp, kp = torch.cat([qa, qb]), torch.cat([ka, kb])
            q, k, v = rand((2, 256, hq, d), bf16), rand((2, 1280, hkv, d), bf16), rand(
                (2, 1280, hkv, d), bf16)
            full = attend(q, k, v, qp, kp, kw)
            self.check(f"sparse_attention prefill invariance D={d}, row 1 of B=2 vs B=1",
                       attend(q[1:], k[1:], v[1:], qp[1:], kp[1:], kw), full[1:], 0, True)
            sub = attend(q[1:, 37:101].contiguous(), k[1:], v[1:],
                         qp[1:, 37:101].contiguous(), kp[1:], kw)
            self.check(f"sparse_attention prefill invariance D={d}, queries [37,101) alone",
                       sub, full[1:, 37:101], 0, True)

    # (label, M, K, N) of the zoo's projections: gemma2-2b at decode (q, k/v,
    # o, gate/up, down) and a 256-row gate/up pack; bitnet-3b at decode
    # (q/k/v/o, gate/up, down) and a 256-row down pack
    ZOO_GEMMS = (("gemma2-2b q", 4, 2304, 2048), ("gemma2-2b k/v", 4, 2304, 1024),
                 ("gemma2-2b o", 4, 2048, 2304), ("gemma2-2b gate/up", 4, 2304, 9216),
                 ("gemma2-2b down", 4, 9216, 2304), ("gemma2-2b pack gate/up", 256, 2304, 9216),
                 ("bitnet-3b q/k/v/o", 4, 3200, 3200), ("bitnet-3b gate/up", 4, 3200, 8640),
                 ("bitnet-3b down", 4, 8640, 3200), ("bitnet-3b pack down", 256, 8640, 3200))
    # every K of the zoo's DAS steps (d_model, q_dim, d_ff): 1152, 2304 and
    # 3200 end in a partial 1024-lane block of das_topk
    ZOO_TOPK_K = (1152, 1024, 6912, 2304, 2048, 9216, 5760, 3200, 8640, 5632)

    def _zoo_gemm_cases(self, g):
        """das_topk (exact, with and without the rmsnorm before it) at every
        K of the zoo, at decode and at a 256-row pack, bitwise invariant to
        M; das_ternary_gemm at gemma2-2b's and bitnet-3b's shapes; and
        ternary_gemm at gemma2-2b's down (no zoo model takes it: every zoo
        down has 32 | K, so DAS compacts it)."""
        torch = self.torch
        from repro_torch.core import das as das_lib
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        dev, bf16 = self.dev, torch.bfloat16
        scale = torch.tensor(0.37, device=dev)
        for k in self.ZOO_TOPK_K:
            x = torch.randn((256, k), generator=g, device=dev).to(bf16)
            nscale = (0.5 * torch.randn((k,), generator=g, device=dev)).to(bf16)
            for m in (4, 256):
                got = das_topk_cuda(x[:m], keep=16, block=32)
                want = ref.das_topk_ref(x[:m], keep=16, block=32)
                err = max(self.check(f"das_topk bf16 ({m},{k}) {name}", a, b, 0, True)
                          for name, a, b in zip(ref.DasTopK._fields[:4], got, want)
                          if a is not None)
                fused = das_topk_cuda(x[:m], keep=16, block=32, norm_scale=nscale,
                                      with_normed=True)
                for name, a, b in zip(ref.DasTopK._fields[:4], fused,
                                      ref.das_topk_ref(fused.normed, keep=16, block=32)):
                    if a is not None:
                        err = max(err, self.check(f"das_topk norm-fused ({m},{k}) {name} vs "
                                                  f"das_topk_ref(normed)", a, b, 0, True))
            one = das_topk_cuda(x[3:4], keep=16, block=32, norm_scale=nscale, with_mask=False)
            full = das_topk_cuda(x, keep=16, block=32, norm_scale=nscale, with_mask=False)
            if not (torch.equal(one.values[0], full.values[3])
                    and torch.equal(one.indices[0], full.indices[3])):
                raise AssertionError(f"das_topk K={k}: row 3 depends on M")
        log(f"[kernels] das_topk at K = {self.ZOO_TOPK_K}: a row alone and among 256 "
            f"bitwise identical (norm-fused)")
        for label, m, k, n in self.ZOO_GEMMS:
            x = torch.randn((m, k), generator=g, device=dev).to(bf16)
            ca = das_lib.das_compact(x, block_size=32, keep=16)
            packed = self._packed(g, k, n)
            got = das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale, keep=16)
            self.check(f"das_ternary_gemm {label} ({m},{k // 2} of {k})x"
                       f"({packed.shape[0]},{n})", got,
                       ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale), TOL_BF16)
            if m == 256:                 # the prefill class: rows independent of M
                sub = das_ternary_gemm_cuda(ca.values[:200].contiguous(),
                                            ca.indices[:200].contiguous(), packed, scale,
                                            keep=16)
                self.check(f"das_ternary_gemm {label} invariance, 200 rows vs among 256",
                           sub, got[:200], 0, True)
        x = torch.randn((4, 9216), generator=g, device=dev).to(bf16)
        xd = das_lib.das_apply(x, das_lib.das_mask(x, keep=16))
        packed = self._packed(g, 9216, 2304)
        self.check("ternary_gemm gemma2-2b down shape (4,9216)x(1856,2304) dense rows",
                   ternary_gemm_cuda(xd, packed, scale), ref.ternary_gemm_ref(xd, packed, scale),
                   TOL_BF16)

    # qwen3-moe-30b-a3b's expert stacks (E, K, N): gate/up and down
    MOE_STACKS = ((128, 2048, 768), (128, 768, 2048))

    def _moe_cases(self, g):
        """qwen3-moe-30b-a3b's shapes: twd_decode over a whole expert stack in
        one launch (gate/up 128x416 x 768 packed -> 128x2080 x 768 trits,
        down 128x160 x 2048 -> 128x800 x 2048), exactly its plain version,
        which decodes each expert alone; das_topk's MoE call (norm-fused, the
        normed rows and the masked dense rows beside the compaction) exactly
        against das_topk_ref of its normed rows; sparse_attention at 32 q
        heads over 4 kv heads of 64 (GQA 8:1), ring decode and an LPSA
        prefill pack (scores rounded, as the streaming prefill asks)."""
        torch = self.torch
        from repro_torch.core import twd
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        dev, bf16, i32 = self.dev, torch.bfloat16, torch.int32
        for e, k, n in self.MOE_STACKS:
            r = twd.packed_rows(k, 16)
            packed = torch.randint(0, 243, (e, r, n), generator=g, device=dev).to(torch.uint8)
            self.check(f"twd_decode expert stack ({e}x{r},{n}) -> ({e}x{5 * r},{n}), the first "
                       f"{k} rows of each", ops.twd_decode_stack(packed, k),
                       ref.twd_decode_stack_ref(packed, k), 0, True)
        for m in (4, 1024):
            x = torch.randn((m, 2048), generator=g, device=dev).to(bf16)
            nscale = (0.5 * torch.randn((2048,), generator=g, device=dev)).to(bf16)
            got = das_topk_cuda(x, keep=16, block=32, norm_scale=nscale, with_mask=False,
                                with_normed=True, with_dense=True)
            want = ref.das_topk_ref(got.normed, keep=16, block=32, with_mask=False,
                                    with_dense=True)
            for name in ("values", "indices", "dense"):
                self.check(f"das_topk MoE call ({m},2048) {name} vs das_topk_ref(normed)",
                           getattr(got, name), getattr(want, name), 0, True)
        rows = (1500, 1023, 300, 5)
        qp = torch.tensor(rows, dtype=i32, device=dev)[:, None]
        kp = torch.stack([ring_positions(torch, t, 128, 896) for t in rows]).to(dev)

        def case(label, b, lq, lk, q_pos, k_pos, rs):
            q = torch.randn((b, lq, 32, 64), generator=g, device=dev).to(bf16)
            k_ = torch.randn((b, lk, 4, 64), generator=g, device=dev).to(bf16)
            v = torch.randn((b, lk, 4, 64), generator=g, device=dev).to(bf16)
            kw = dict(sink=128, window=896, round_scores=rs)
            self.check(f"sparse_attention GQA 32/4 D=64 {label}",
                       sparse_attention_cuda(q, k_, v, q_pos, k_pos, **kw),
                       ref.sparse_attention_ref(q, k_, v, q_pos, k_pos, **kw), TOL_BF16)

        case("decode bf16 B=4 ring 1024", 4, 1, 1024, qp, kp, False)
        qp1, kp1 = pack_positions(torch, 512)
        case("prefill bf16 LPSA pack t0=512 round_scores", 1, 256, 1280, qp1[None].to(dev),
             kp1[None].to(dev), True)

    # the SSM pair's projections (label, K, N), every K a multiple of 32, so
    # DAS compacts every input: rwkv6-3b's r/k/v/g/o and the channel-mix's
    # r (2560 -> 2560), k (2560 -> 8960) and v (8960 -> 2560); gla-1.3b's
    # q/k/v/g/o (2048 -> 2048), gate/up (2048 -> 5632) and down (5632 -> 2048)
    SSM_GEMMS = (("rwkv6-3b r/k/v/g/o, cr", 2560, 2560), ("rwkv6-3b ck", 2560, 8960),
                 ("rwkv6-3b cv", 8960, 2560), ("gla-1.3b q/k/v/g/o", 2048, 2048),
                 ("gla-1.3b gate/up", 2048, 5632), ("gla-1.3b down", 5632, 2048))
    SSM_PREFILL_M = 1100       # a prefill's rows: the whole prompt at once

    def _ssm_cases(self, g):
        """The SSM pair's shapes, at decode (4 rows) and at the 1100-token
        admission (1100 rows): das_topk exactly against its plain version at
        every K, plain (rwkv's 8 projections, gla's o and down) and
        norm-fused with the normed rows (gla's q/k/v/g and gate/up take it
        at K = 2048); das_ternary_gemm at every projection within the bf16
        tolerance; ternary_gemm in float32 at every projection, at 1 and 512
        rows, the shapes of the DAS-off width check.  The weight scale is
        the one the export gives a projection of fan-in K (the absmean of
        N(0, 1/K) master weights, sqrt(2/pi/K)), so the outputs have the
        model's magnitude: at 0.37 the float32 sums over K = 8960 unit rows
        reach ~30 and two summation orders differ by ~5e-4."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        dev, bf16, f32 = self.dev, torch.bfloat16, torch.float32
        for k in (2560, 8960, 2048, 5632):
            for m in (4, self.SSM_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                got = das_topk_cuda(x, keep=16, block=32, with_mask=False)
                want = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                for name in ("values", "indices"):
                    self.check(f"das_topk SSM ({m},{k}) {name}", getattr(got, name),
                               getattr(want, name), 0, True)
                nscale = (0.5 * torch.randn((k,), generator=g, device=dev)).to(bf16)
                fused = das_topk_cuda(x, keep=16, block=32, norm_scale=nscale,
                                      with_mask=False, with_normed=True)
                plain = ref.das_topk_ref(fused.normed, keep=16, block=32, with_mask=False)
                for name in ("values", "indices"):
                    self.check(f"das_topk norm-fused ({m},{k}) {name} vs das_topk_ref(normed)",
                               getattr(fused, name), getattr(plain, name), 0, True)
        for label, k, n in self.SSM_GEMMS:
            packed = self._packed(g, k, n)
            scale = torch.tensor((2 / math.pi / k) ** 0.5, device=dev)
            for m in (4, self.SSM_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                ca = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                self.check(f"das_ternary_gemm {label} ({m},{k // 2} of {k})x"
                           f"({packed.shape[0]},{n})",
                           das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale, keep=16),
                           ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale),
                           TOL_BF16)
            for m in (1, 512):
                x = torch.randn((m, k), generator=g, device=dev).to(f32)
                self.check(f"ternary_gemm f32 {label} ({m},{k})x({packed.shape[0]},{n})",
                           ternary_gemm_cuda(x, packed, scale),
                           ref.ternary_gemm_ref(x, packed, scale), TOL_F32_GEMM)

    # zamba2-2.7b's projections (label, K, N) beyond the SSM pair's: the
    # mamba block's wz / wx (2560 -> 5120, one DAS step), its wo (5120 ->
    # 2560), the FFN's gate/up (2560 -> 10240) and down (10240 -> 2560); its
    # q/k/v/o are rwkv6-3b's 2560 -> 2560
    HYBRID_GEMMS = (("zamba2-2.7b mamba wz/wx", 2560, 5120), ("zamba2-2.7b mamba wo", 5120, 2560),
                    ("zamba2-2.7b gate/up", 2560, 10240), ("zamba2-2.7b down", 10240, 2560))
    HYBRID_PREFILL_M = 1024    # the 1100-token admission's prefix: mamba and FFN rows at once

    def _hybrid_cases(self, g):
        """zamba2-2.7b's shapes, at decode (4 rows) and at the 1100-token
        admission's 1024-row prefix: das_topk exactly against its plain
        version, plain at K = 5120 (the mamba wo) and 10240 (down) and
        norm-fused with the normed rows at K = 2560 (the mamba block's and
        the attention block's input); at K = 5120 the norm-fused call beside
        rmsnorm + das_topk, which the mamba wo keeps apart (the counts of
        normed values and kept lanes that differ); das_ternary_gemm at every
        new projection within the bf16 tolerance; sparse_attention at 32 q
        heads over 32 kv heads of 80, decode over full 1024-slot rings (each
        row bitwise its B = 1 call) and a bf16 LPSA pack with rounded scores
        (each query row bitwise its row of a call on a sub-range); and
        layers.xla_cumsum on the card bitwise the CPU's."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        from repro_torch.models.layers import rmsnorm, xla_cumsum
        dev, bf16, i32 = self.dev, torch.bfloat16, torch.int32
        for k in (2560, 5120, 10240):
            nscale = (0.5 * torch.randn((k,), generator=g, device=dev)).to(bf16)
            for m in (4, self.HYBRID_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                got = das_topk_cuda(x, keep=16, block=32, with_mask=False)
                want = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                for name in ("values", "indices"):
                    self.check(f"das_topk zamba2 ({m},{k}) {name}", getattr(got, name),
                               getattr(want, name), 0, True)
                if k == 5120:
                    fused = das_topk_cuda(x, keep=16, block=32, norm_scale=nscale,
                                          with_mask=False, with_normed=True)
                    normed = rmsnorm(nscale, x)
                    apart = das_topk_cuda(normed, keep=16, block=32, with_mask=False)
                    log(f"[kernels] das_topk ({m},5120) norm-fused against rmsnorm + das_topk: "
                        f"{int((fused.normed != normed).sum())} of {normed.numel()} normed values "
                        f"and {int((fused.indices != apart.indices).sum())} of "
                        f"{apart.indices.numel()} kept lanes differ (the mamba wo keeps the two "
                        f"apart)")
                if k == 2560:
                    fused = das_topk_cuda(x, keep=16, block=32, norm_scale=nscale,
                                          with_mask=False, with_normed=True)
                    plain = ref.das_topk_ref(fused.normed, keep=16, block=32, with_mask=False)
                    for name in ("values", "indices"):
                        self.check(f"das_topk norm-fused zamba2 ({m},{k}) {name} vs "
                                   f"das_topk_ref(normed)", getattr(fused, name),
                                   getattr(plain, name), 0, True)
        for label, k, n in self.HYBRID_GEMMS:
            packed = self._packed(g, k, n)
            scale = torch.tensor((2 / math.pi / k) ** 0.5, device=dev)
            for m in (4, self.HYBRID_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                ca = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                self.check(f"das_ternary_gemm {label} ({m},{k // 2} of {k})x"
                           f"({packed.shape[0]},{n})",
                           das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale, keep=16),
                           ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale),
                           TOL_BF16)
        rows = (1500, 1023, 2000, 1100)              # every ring full
        qp = torch.tensor(rows, dtype=i32, device=dev)[:, None]
        kp = torch.stack([ring_positions(torch, t, 128, 896) for t in rows]).to(dev)
        q = torch.randn((4, 1, 32, 80), generator=g, device=dev).to(bf16)
        k_ = torch.randn((4, 1024, 32, 80), generator=g, device=dev).to(bf16)
        v = torch.randn((4, 1024, 32, 80), generator=g, device=dev).to(bf16)
        kw = dict(sink=128, window=896)
        full = sparse_attention_cuda(q, k_, v, qp, kp, **kw)
        self.check("sparse_attention zamba2 D=80 32/32 decode bf16 B=4 full rings of 1024", full,
                   ref.sparse_attention_ref(q, k_, v, qp, kp, **kw), TOL_BF16)
        for i in range(4):
            self.check(f"sparse_attention zamba2 D=80 decode row {i} alone vs among 4",
                       sparse_attention_cuda(q[i:i + 1], k_[i:i + 1], v[i:i + 1], qp[i:i + 1],
                                             kp[i:i + 1], **kw), full[i:i + 1], 0, True)
        qp1, kp1 = (p[None].to(dev) for p in pack_positions(torch, 512))
        q = torch.randn((1, 256, 32, 80), generator=g, device=dev).to(bf16)
        k_ = torch.randn((1, 1280, 32, 80), generator=g, device=dev).to(bf16)
        v = torch.randn((1, 1280, 32, 80), generator=g, device=dev).to(bf16)
        kw = dict(sink=128, window=896, round_scores=True)
        full = sparse_attention_cuda(q, k_, v, qp1, kp1, **kw)
        self.check("sparse_attention zamba2 D=80 32/32 prefill bf16 LPSA pack t0=512 "
                   "round_scores", full, ref.sparse_attention_ref(q, k_, v, qp1, kp1, **kw),
                   TOL_BF16)
        for lo, hi in ((0, 64), (100, 137)):
            self.check(f"sparse_attention zamba2 D=80 prefill queries [{lo},{hi}) alone vs in "
                       f"the pack", sparse_attention_cuda(q[:, lo:hi], k_, v, qp1[:, lo:hi],
                                                          kp1, **kw), full[:, lo:hi], 0, True)
        for shape in ((4, 256, 80), (1, 1024, 80), (2, 37, 8)):
            x = torch.randn(shape, generator=g, device=dev)
            self.check(f"layers.xla_cumsum {shape} along dim 1, card vs CPU",
                       xla_cumsum(x, 1), xla_cumsum(x.cpu(), 1), 0, True)

    # the stub-frontend models' projections: (label, K, N)
    FRONTEND_GEMMS = (("musicgen-medium q/k/v/o", 1536, 1536),
                      ("musicgen-medium w_in", 1536, 6144),
                      ("musicgen-medium w_out", 6144, 1536),
                      ("pixtral-12b q/o", 5120, 5120), ("pixtral-12b k/v", 5120, 1280),
                      ("pixtral-12b gate/up", 5120, 14336), ("pixtral-12b down", 14336, 5120))
    FRONTEND_PREFILL_M = 256   # a prefill pack's rows (q/k/v; o and the FFN take 1024)

    def _frontend_cases(self, g):
        """musicgen-medium's and pixtral-12b's shapes, float32 rows (their
        residual stream), at decode (4 rows) and at a 256-row pack: das_topk
        exactly against its plain version at K = 1536, 5120, 6144 and 14336,
        plain and norm-fused with a float32 scale (the normed rows within 8
        float32 steps of rmsnorm, the DAS step of them exact); das_ternary_gemm
        on the float32 compaction at every projection (1e-4; the decode
        class and the FMA prefill class); ternary_gemm in float32 at the
        width checks' FFN shapes at 1 and 512 rows; sparse_attention at 32 q
        heads over 8 of 160: bf16 decode over full 1024-slot rings, the
        float32-query decode over bfloat16 rings (also at 24 over 24 of 64,
        musicgen's), a bf16 and a float32 LPSA pack, each row bitwise its B =
        1 call."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        from repro_torch.models.layers import rmsnorm
        dev, bf16, f32, i32 = self.dev, torch.bfloat16, torch.float32, torch.int32
        for k in (1536, 5120, 6144, 14336):
            nscale = 0.5 * torch.randn((k,), generator=g, device=dev)
            for m in (4, self.FRONTEND_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev)
                got = das_topk_cuda(x, keep=16, block=32, with_mask=False)
                want = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                for name in ("values", "indices"):
                    self.check(f"das_topk f32 ({m},{k}) {name}", getattr(got, name),
                               getattr(want, name), 0, True)
                fused = das_topk_cuda(x, keep=16, block=32, norm_scale=nscale,
                                      with_mask=False, with_normed=True)
                normed = rmsnorm(nscale, x)
                step = torch.exp2(torch.floor(torch.log2(normed.abs().clamp_min(2.0 ** -100)))
                                  - 23)
                steps = float(((fused.normed - normed).abs() / step).max())
                log(f"[kernels] das_topk f32 norm-fused ({m},{k}): normed rows within "
                    f"{steps:.1f} float32 steps of rmsnorm (tol 8) "
                    f"{'ok' if steps <= 8 else 'FAIL'}")
                if steps > 8:
                    raise AssertionError(f"das_topk f32 norm-fused ({m},{k}): normed rows off")
                plain = ref.das_topk_ref(fused.normed, keep=16, block=32, with_mask=False)
                for name in ("values", "indices"):
                    self.check(f"das_topk f32 norm-fused ({m},{k}) {name} vs "
                               f"das_topk_ref(normed)", getattr(fused, name),
                               getattr(plain, name), 0, True)
        for label, k, n in self.FRONTEND_GEMMS:
            packed = self._packed(g, k, n)
            scale = torch.tensor((2 / math.pi / k) ** 0.5, device=dev)
            for m in (4, self.FRONTEND_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev)
                ca = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                want = ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale)
                if not bool(want.abs().max() > 0):
                    raise AssertionError(f"das_ternary_gemm f32 {label}: an all-zero reference")
                self.check(f"das_ternary_gemm f32 {label} ({m},{k // 2} of {k})x"
                           f"({packed.shape[0]},{n}), |want| <= {float(want.abs().max()):.1f}",
                           das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale, keep=16),
                           want, TOL_F32_GEMM)
            if n > k or k > 5120:                  # the FFN's: the width checks' DAS-off path
                for m in (1, 512):
                    x = torch.randn((m, k), generator=g, device=dev)
                    self.check(f"ternary_gemm f32 {label} ({m},{k})x({packed.shape[0]},{n})",
                               ternary_gemm_cuda(x, packed, scale),
                               ref.ternary_gemm_ref(x, packed, scale), TOL_F32_GEMM)
        rows = (1500, 1023, 2000, 1100)              # every ring full
        qp = torch.tensor(rows, dtype=i32, device=dev)[:, None]
        kp = torch.stack([ring_positions(torch, t, 128, 896) for t in rows]).to(dev)
        kw = dict(sink=128, window=896)
        for hq, hkv, d, q_dt in ((32, 8, 160, bf16), (32, 8, 160, f32), (24, 24, 64, f32)):
            q = torch.randn((4, 1, hq, d), generator=g, device=dev).to(q_dt)
            k_ = torch.randn((4, 1024, hkv, d), generator=g, device=dev).to(bf16)
            v = torch.randn((4, 1024, hkv, d), generator=g, device=dev).to(bf16)
            label = (f"sparse_attention D={d} {hq}/{hkv} decode "
                     f"{'bf16' if q_dt == bf16 else 'f32 q over bf16 K/V'}")
            full = sparse_attention_cuda(q, k_, v, qp, kp, **kw)
            if full.dtype != q_dt:
                raise AssertionError(f"{label}: output {full.dtype}, want {q_dt}")
            self.check(f"{label} B=4 full rings of 1024", full,
                       ref.sparse_attention_ref(q, k_, v, qp, kp, **kw),
                       TOL_BF16 if q_dt == bf16 else TOL_F32_ATTN)
            for i in range(4):
                self.check(f"{label} row {i} alone vs among 4",
                           sparse_attention_cuda(q[i:i + 1], k_[i:i + 1], v[i:i + 1],
                                                 qp[i:i + 1], kp[i:i + 1], **kw),
                           full[i:i + 1], 0, True)
        packs = [pack_positions(torch, t0) for t0 in (2000, 512)]
        qp2 = torch.stack([p[0] for p in packs]).to(dev)
        kp2 = torch.stack([p[1] for p in packs]).to(dev)
        for dt, lq, hq, hkv in ((bf16, 256, 32, 8), (f32, 256, 32, 8)):
            q = torch.randn((2, lq, hq, 160), generator=g, device=dev).to(dt)
            k_ = torch.randn((2, 1280, hkv, 160), generator=g, device=dev).to(dt)
            v = torch.randn((2, 1280, hkv, 160), generator=g, device=dev).to(dt)
            kw = dict(sink=128, window=896, round_scores=True)
            name = f"sparse_attention D=160 {hq}/{hkv} prefill {'bf16' if dt == bf16 else 'f32'}"
            full = sparse_attention_cuda(q, k_, v, qp2[:, :lq], kp2, **kw)
            self.check(f"{name} LPSA packs t0=2000, 512 round_scores", full,
                       ref.sparse_attention_ref(q, k_, v, qp2[:, :lq], kp2, **kw),
                       TOL_BF16 if dt == bf16 else TOL_F32_ATTN)
            self.check(f"{name} pack t0=512 alone vs beside t0=2000",
                       sparse_attention_cuda(q[1:], k_[1:], v[1:], qp2[1:, :lq], kp2[1:], **kw),
                       full[1:], 0, True)

    PROMPT_LENS, GEN_LEN = (1100, 300, 256, 40, 700), 32

    # -- tune ----------------------------------------------------------------

    # bitnet-1.3b's packed GEMMs: (op, K, N) at 4 and 256 rows
    TUNE_SHAPES = (("das_ternary_gemm", 2048, 2048), ("das_ternary_gemm", 2048, 5460),
                   ("ternary_gemm", 5460, 2048))
    TUNE_CUT = 2             # check (4)'s depth: float32, DAS off

    def _gemm_call(self, op, x, packed, scale):
        """(the kernel at a config (None: no config argument), its plain
        version) of one packed GEMM call on rows x: das_ternary_gemm on x's
        DAS compaction, ternary_gemm on its masked dense rows (the down
        projection's route)."""
        from repro_torch.kernels import ops, ref
        step = ops.das_topk(x, keep=16, with_mask=False, with_dense=True)
        if op == "das_ternary_gemm":
            def run(c):
                kw = {} if c is None else {"config": c}
                return ops.das_ternary_gemm(step.values, step.indices, packed, scale, keep=16,
                                            **kw)
            return run, lambda: ref.das_ternary_gemm_ref(step.values, step.indices, packed,
                                                         scale)

        def run(c):
            kw = {} if c is None else {"config": c}
            return ops.ternary_gemm(step.dense, packed, scale, **kw)
        return run, lambda: ref.ternary_gemm_ref(step.dense, packed, scale)

    def _config_checks(self, g):
        """(1): every feasible launch config against the plain version, the
        default bitwise the built-in one, batch invariance within a class."""
        torch = self.torch
        from repro_torch.kernels import build
        scale = torch.tensor(0.37, device=self.dev)
        n_cfg = 0
        for dt in (torch.bfloat16, torch.float32):
            tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32_GEMM
            for op, k, n in self.TUNE_SHAPES:
                packed = self._packed(g, k, n)
                r = packed.shape[0]
                mma = (build.das_mma_route(dt, k // 32 * 16, 16, 32, n)
                       if op == "das_ternary_gemm" else build.dense_mma_route(dt, k, n))
                x_all = torch.randn((256, k), generator=g, device=self.dev).to(dt)
                for m in (4, 256):
                    run, plain = self._gemm_call(op, x_all[:m], packed, scale)
                    want, base = plain(), run(None)
                    label = f"{op} {dt} ({m},{k})x({r},{n})"
                    self.check(f"{label}: the default config vs no config", run(
                        build.DEFAULT_CONFIG), base, 0, True)
                    builtin = build.builtin_config(m, r, n, mma)
                    if builtin != build.DEFAULT_CONFIG:
                        self.check(f"{label}: the built-in {tuple(builtin)} vs no config",
                                   run(builtin), base, 0, True)
                    small = 1 if m <= 4 else 5
                    run_small, _ = self._gemm_call(op, x_all[:small], packed, scale)
                    for c in build.launch_configs(m, r, n, mma):
                        got = run(c)
                        self.check(f"{label} subs={c.subs} parts={c.parts}", got, want, tol)
                        self.check(f"{label} subs={c.subs} parts={c.parts}: a {small}-row "
                                   f"call's rows", run_small(c), got[:small], 0, True)
                        n_cfg += 1
        log(f"[tune] {n_cfg} launch configs held against the plain versions, each batch "
            f"invariant within its class")

    def _tune_trace(self, prompts):
        from repro_torch.serve import Request
        return [Request(uid=i, prompt=prompts[i], max_new_tokens=self.GEN_LEN, arrival=2 * i)
                for i in range(2)]

    def phase_tune(self):
        """(1)-(5) of the header: the launch configs, then the tuned engine
        against the default one at bitnet-1.3b's full width."""
        import os
        import tempfile

        import numpy as np
        torch = self.torch
        from repro_torch.kernels import autotune, ops
        from repro_torch.launch.serve import teacher_forced
        from repro_torch.models import model as MD
        from repro_torch.serve import Request, ServeEngine

        t0 = time.perf_counter()
        self._config_checks(self.gen(self.seed + 29))
        t0 = _took("launch configs", t0, "tune")
        cfg, _, model, prompts, sc = self._packed_model()
        (ROOT / "build").mkdir(exist_ok=True)
        cache_dir = Path(tempfile.mkdtemp(prefix="tune_", dir=ROOT / "build"))
        os.environ[autotune.ENV_VAR] = str(cache_dir / "autotune.json")
        try:
            tuned = ServeEngine(model, sc.with_updates(kernel_mode="tuned"), device=self.dev)
            t0 = _took(f"tuned engine ({tuned.stats.autotune_timed_runs} timed candidate "
                       f"runs, then the graph captured)", t0, "tune")
            self._print_winners(tuned.autotune_cache)
            runs = {}
            for label in ("tuned", "default"):
                eng = tuned if label == "tuned" else ServeEngine(model, sc, device=self.dev)
                if label == "tuned":
                    ops.reset_launches()           # the tuned path starts here, after its
                                                   # tuning runs and its graph capture
                for r in self._tune_trace(prompts):
                    eng.submit(r)
                res = eng.run()
                torch.cuda.synchronize()
                if label == "tuned":
                    self._tuned_counts(tuned.autotune_cache, dict(ops.launches))  # ... ends
                st = eng.stats
                runs[label] = (res, 1e3 * st.decode_seconds / st.decode_steps,
                               self._admission_ms(eng, prompts[0]))
                adm_ms, adm_busy = runs[label][2]
                log(f"[tune] {label} engine: decode {runs[label][1]:.3f} ms/step (host clock, "
                    f"{sc.max_slots} slots, {st.decode_steps} steps), admission of the "
                    f"{len(prompts[0])}-token prompt {adm_ms:.3f} ms (CUDA events), device busy "
                    f"{adm_busy:.3f} ms (torch.profiler); tokens "
                    + "; ".join(f"req {u}: {res[u].tokens[:8].tolist()}..." for u in sorted(res)))
            same = all(runs["tuned"][0][u].tokens.tolist() == runs["default"][0][u].tokens.tolist()
                       for u in runs["tuned"][0])
            log(f"[tune] tuned vs default: tokens {'equal' if same else 'DIFFERENT'} (reported, "
                f"not gated: another sum order moves a DAS tie); decode {runs['tuned'][1]:.3f} vs "
                f"{runs['default'][1]:.3f} ms/step, admission device busy "
                f"{runs['tuned'][2][1]:.3f} vs {runs['default'][2][1]:.3f} ms; {_nvidia_smi()}")
            t0 = _took("tuned vs default serving", t0, "tune")

            # (4) float32, DAS off, TUNE_CUT layers: teacher-forced logits
            cfg32 = dataclasses.replace(cfg, n_layers=self.TUNE_CUT, dtype="float32",
                                        ternary=dataclasses.replace(cfg.ternary, das=None))
            m32 = MD.init_serving(cfg32, seed=self.seed, device=self.dev)
            sc32 = sc.with_updates(max_slots=1)
            default32 = ServeEngine(m32, sc32, device=self.dev)
            default32.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=8))
            toks = default32.run()[0].tokens.tolist()
            t32 = ServeEngine(m32, sc32.with_updates(kernel_mode="tuned"), device=self.dev)
            self._print_winners(t32.autotune_cache, "float32 engine", "float32")
            n = len(prompts[0]) // cfg.lpsa.chunk * cfg.lpsa.chunk
            feed = [int(t) for t in prompts[0][n:]] + toks[:-1]
            want = teacher_forced(m32, prompts[0][:n], feed, max_len=sc.max_len)
            with t32._mode_scope():
                got = teacher_forced(m32, prompts[0][:n], feed, max_len=sc.max_len)
            err = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, want))
            log(f"[tune] float32, DAS off, {self.TUNE_CUT} layers: tuned vs default "
                f"teacher-forced logits over {len(want)} steps ({n} prompt tokens prefilled; "
                f"{t32.stats.autotune_timed_runs} timed runs for the float32 keys): "
                f"{err:.3e} of the max logit (tol {TOL_F32_GEMM:g})")
            if not err <= TOL_F32_GEMM:
                raise AssertionError("tuned float32 logits disagree with the default engine's")

            # (5) a second engine on the populated cache
            again = ServeEngine(model, sc.with_updates(kernel_mode="tuned"), device=self.dev)
            log(f"[tune] a second tuned engine: {again.stats.autotune_timed_runs} timed runs "
                f"({len(again.autotune_cache.entries)} cached keys)")
            if again.stats.autotune_timed_runs:
                raise AssertionError("a populated cache was tuned again")
            _took("float32 check and a second engine", t0, "tune")
        finally:
            os.environ.pop(autotune.ENV_VAR, None)
            for f in cache_dir.iterdir():
                f.unlink()
            cache_dir.rmdir()

    def _print_winners(self, cache, what="packed engine", dtype="bfloat16"):
        """Each key of ``cache`` at ``dtype``: its winner, its µs, the
        built-in config's µs and every timed candidate's."""
        for key, e in sorted(cache.entries.items()):
            if f"|dtype{dtype}|" not in key:
                continue
            builtin = [us for name, us in e["timed"].items() if self._is_builtin(key, name)]
            log(f"[tune] {what} {key}: winner {e['impl']} subs={e['subs']} parts={e['parts']} "
                f"kv_chunk={e['kv_chunk']} {e['us']:.1f} us; built-in config "
                f"{builtin[0] if builtin else 'n/a'} us; timed {e['timed']}")

    @staticmethod
    def _is_builtin(key, name):
        """Whether the timed candidate ``name`` ("cuda subs=2", "cuda
        parts=5", "cuda") of a cache key is the kernel's built-in config.
        A GEMM key's fields: op, device, then block, cls, dtype, k, keep, n
        (autotune.shape_key sorts them)."""
        from repro_torch.core import twd
        from repro_torch.kernels import build
        f = key.split("|")
        if f[0] == "sparse_attn":
            return name == "cuda"
        cls, k, n = f[3][len("cls"):], int(f[5][len("k"):]), int(f[7][len("n"):])
        r = twd.packed_rows(k, twd.ROW_ALIGN)
        c = build.builtin_config(build.DECODE_ROWS if cls == "decode" else 256, r, n, mma=True)
        return name in ("cuda", f"cuda subs={c.subs}", f"cuda parts={c.parts}")

    def _tuned_counts(self, cache, counts):
        """The tuned path's launches: each kernel that one of its winners
        takes was launched."""
        want = {"das_topk"}
        for key, e in cache.entries.items():
            op = key.split("|")[0]
            if e["impl"] == "cuda":
                want.add({"sparse_attn": "sparse_attention"}.get(op, op))
            elif e["impl"] in ("native_plain", "native_dense_plain", "native_gather"):
                want.add("twd_decode")
        log(f"[tune] tuned launches on the path: {counts} (each of {sorted(want)} > 0)")
        missing = [k for k in sorted(want) if not counts.get(k)]
        if missing:
            raise AssertionError(f"the tuned path never launched {missing}")
        for name, n in counts.items():
            self.launches[name] += n

    def _admission_ms(self, eng, prompt):
        """(CUDA-event ms, device busy ms under torch.profiler) of the
        engine's prefill of ``prompt``'s whole packs under its kernel mode,
        after one warm-up prefill: the eager prefill is host-bound, so the
        events bracket host gaps that the busy time leaves out."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import model as MD
        n = len(prompt) // eng.cfg.lpsa.chunk * eng.cfg.lpsa.chunk
        tok = self._inputs(prompt[:n])
        with eng._mode_scope():
            MD.prefill(eng.model, tok, max_len=eng.max_len)
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            ev0.record()
            MD.prefill(eng.model, tok, max_len=eng.max_len)
            ev1.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                MD.prefill(eng.model, tok, max_len=eng.max_len)
                torch.cuda.synchronize()
        busy = sum(_Trace(prof).device_times().values()) / 1e3
        return ev0.elapsed_time(ev1), busy

    def _packed_model(self):
        """Full-width bitnet-1.3b, seeded random weights, base-3 packed, with
        the trace's prompts and serve config: (cfg, master params, model,
        prompts, ServeConfig); built once, shared by the tune and serve
        phases."""
        if getattr(self, "_packed_cache", None) is None:
            self._packed_cache = self._build_packed_model()
        return self._packed_cache

    def _build_packed_model(self):
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as MD
        from repro_torch.serve import ServeConfig

        cfg = get_config("bitnet-1.3b")
        t0 = time.perf_counter()
        params = MD.init_params(cfg, seed=self.seed, device=self.dev)
        model = MD.export_serving(params, cfg)
        torch.cuda.synchronize()
        log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
            f"{cfg.d_ff}, packed rows {model.layers[0].attn.wq.packed.shape[0]}/"
            f"{model.layers[0].ffn.w_out.packed.shape[0]}; init+export "
            f"{time.perf_counter() - t0:.1f} s")
        rng = torch.Generator().manual_seed(self.seed)
        prompts = [torch.randint(0, cfg.vocab, (p,), generator=rng).numpy()
                   for p in self.PROMPT_LENS]
        sc = ServeConfig(max_slots=4, max_len=max(self.PROMPT_LENS) + self.GEN_LEN,
                         seed=self.seed)
        return cfg, params, model, prompts, sc

    def phase_profile(self):
        """The decode step of the packed and the int8w model and the
        admission of the 1100-token prompt under torch.profiler, as the serve
        phase profiles them: what --parent's turns compare."""
        from repro_torch.models import model as MD
        cfg, _, model, prompts, sc = self._packed_model()
        self._profile_decode("packed", model, sc, prompts)
        cfg8 = dataclasses.replace(cfg, ternary=dataclasses.replace(
            cfg.ternary, serve_format="int8"))
        self._profile_decode("int8w", MD.trits_from_packed(model, cfg8), sc, prompts)
        self._profile_admission(model, prompts[0], sc.max_len)

    def _serve_packed(self, cfg, model, prompts, sc):
        """Path "packed": the trace through the packed model, launch counts
        exact -> (trace, packs, engine, results)."""
        from repro_torch.serve import Request
        chunk = cfg.lpsa.chunk
        trace = [Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                 for i, p in enumerate(prompts)]
        packs = [p // chunk for p in self.PROMPT_LENS if p >= chunk]

        # per decode step (the warm-up before the capture and every replay)
        # 4/6/1/1 launches per layer; per prefill of n packs, per layer
        # n+3 / 3n+3 / 1 / n (q/k/v per pack; o, gate/up, down once)
        def want_packed(st):
            return _packed_counts(cfg.n_layers, st.decode_steps + st.warmup_steps, packs)

        _, eng, res = self._serve_path("packed", lambda: model, trace, sc, want_packed)
        self.packed_tokens = {uid: r.tokens.tolist() for uid, r in res.items()}  # dist's reference
        return trace, packs, eng, res

    def phase_http(self):
        """The packed path, then the http path on the same model, without
        the rest of the serve phase (``--phases build,http``)."""
        cfg, _, model, prompts, sc = self._packed_model()
        trace, packs, eng, res = self._serve_packed(cfg, model, prompts, sc)
        self._serve_http(model, trace, sc, res, eng.stats.decode_steps, packs)

    def phase_serve(self):
        torch = self.torch
        from repro_torch.models import model as MD
        from repro_torch.serve import Request, ServeConfig

        cfg, params, model, prompts, sc = self._packed_model()
        gen_len, chunk, n_l = self.GEN_LEN, cfg.lpsa.chunk, cfg.n_layers
        prompt_lens = self.PROMPT_LENS
        zero = {name: 0 for name in KERNEL_INFO}

        t0 = time.perf_counter()
        trace, packs, eng, res = self._serve_packed(cfg, model, prompts, sc)
        packed_steps = eng.stats.decode_steps      # before the re-served requests
        lg_packed = self._finite_logits("packed", model, prompts[2][:chunk], sc.max_len)
        self._batch_invariance("packed", eng, trace, res, (0, 3))
        del eng
        self._profile_admission(model, prompts[0], sc.max_len)
        self._reduced_parity("packed", cfg, prompts[0])
        t0 = _took("packed", t0)
        self._serve_http(model, trace, sc, res, packed_steps, packs)
        t0 = _took("http", t0)
        self._paged_lpsa(cfg, model)
        t0 = _took("paged-lpsa", t0)
        self._paged_full(cfg, model)
        t0 = _took("paged-full", t0)

        # path "int8w": the trits come from twd_decode of the packed weights
        # (7 per layer, in the path's count); per decode step 4/7/1 launches
        # of das_topk/das_gemv/sparse_attention per layer, per prefill of n
        # packs n+3 / 3n+4 / n; the packed GEMMs never launch
        cfg8 = dataclasses.replace(cfg, ternary=dataclasses.replace(
            cfg.ternary, serve_format="int8"))

        def want_int8(st):
            steps = st.decode_steps + st.warmup_steps
            return {**zero, "twd_decode": 7 * n_l,
                    "das_topk": n_l * (4 * steps + sum(n + 3 for n in packs)),
                    "das_gemv": n_l * (7 * steps + sum(3 * n + 4 for n in packs)),
                    "sparse_attention": n_l * (steps + sum(packs))}

        model8, eng, res = self._serve_path(
            "int8w", lambda: MD.trits_from_packed(model, cfg8), trace, sc, want_int8)
        exported = MD.export_serving(params, cfg8).state_dict()
        for name, buf in model8.state_dict().items():
            if not torch.equal(buf, exported[name]):
                raise AssertionError(f"int8w: {name} differs from the int8 export")
        n_trits = sum(b.numel() for k, b in exported.items() if k.endswith(".trits"))
        log(f"[serve] int8w: {n_trits / 1e9:.3f} G trits from twd_decode equal the int8 "
            f"export of the same master weights exactly")
        del exported, params
        lg8 = self._finite_logits("int8w", model8, prompts[2][:chunk], sc.max_len)
        log(f"[serve] int8w vs packed prefill logits at full width: max abs diff "
            f"{(lg8 - lg_packed).abs().max().item():.3e} (a diagnostic, not a gate)")
        self._batch_invariance("int8w", eng, trace, res, (0, 3))
        del eng
        self._reduced_parity("int8w", cfg8, prompts[0])
        self._profile_load(model, cfg8)
        t0 = _took("int8w", t0)

        # path "baseline": int8 trits, DAS off, full attention (no LPSA): a
        # whole prompt prefills at admission; per decode step 7 das_gemv and
        # 1 sparse_attention per layer, per prefill the same once
        cfgb = dataclasses.replace(cfg8, ternary=dataclasses.replace(cfg8.ternary, das=None),
                                   lpsa=None)
        trace_b = [Request(uid=i, prompt=prompts[i][:16], max_new_tokens=16, arrival=i)
                   for i in range(2)]
        sc_b = ServeConfig(max_slots=4, max_len=32, seed=self.seed)

        def want_base(st):
            steps = st.decode_steps + st.warmup_steps
            return {**zero, "twd_decode": 7 * n_l,
                    "das_gemv": n_l * 7 * (steps + len(trace_b)),
                    "sparse_attention": n_l * (steps + len(trace_b))}

        model_b, eng, res = self._serve_path(
            "baseline", lambda: MD.trits_from_packed(model, cfgb), trace_b, sc_b, want_base)
        self._finite_logits("baseline", model_b, prompts[2][:16], sc_b.max_len)
        self._batch_invariance("baseline", eng, trace_b, res, (1,))
        del eng, model_b
        t0 = _took("baseline", t0)

        # where a decode step's time goes: packed and int8w, each replayed
        # from its captured graph and stepped eagerly, in turns; the second
        # eager turn is timed but not profiled (aggregating an eager trace's
        # events takes ~1 min)
        turns = []
        for label, m in (("packed", model), ("int8w", model8)):
            runs = []
            for graph, profiled in ((True, True), (False, True), (False, False), (True, True)):
                name = f"{label} {'graph' if graph else 'eager'}"
                runs.append(self._profile_decode(name, m, sc, prompts, graph, profiled))
                turns.append((name, runs[-1]))
            # the replayed step against the eager one: the same tokens bit for
            # bit, and a replay counts one eager step's kernel launches
            if any(r["tokens"] != runs[1]["tokens"] or r["per_step"] != runs[1]["per_step"]
                   for r in runs):
                raise AssertionError(f"{label}: the replayed decode step differs from the "
                                     f"eager one in tokens or launches a step")
            log(f"[profile] {label}: replayed and eager decode steps give the same tokens "
                f"bitwise and the same launches a step {runs[1]['per_step']}")
        log("[profile] turns (decode ms/step by CUDA events, device busy ms/step under "
            "the profiler, idle share of the former, host launches per step): " + ", ".join(
                f"{name} {r['ms_step']:.3f} / {r['busy_ms_step']} / {r['idle']} / "
                f"{r['launches']}" for name, r in turns))
        _took("profile turns", t0)
        del model, model8
        torch.cuda.empty_cache()
        for arch, (lens, gen, depth) in self.ZOO_PATHS.items():
            self._serve_zoo(arch, lens, gen, depth)
        self._serve_moe()
        for arch in self.SSM_ARCHS:
            self._serve_ssm(arch)
        self._serve_hybrid()
        for arch in self.FRONTEND_ARCHS:
            self._serve_frontend(arch)

    # the zoo's serve paths: arch -> (prompt lengths, new tokens, depth; None:
    # the arch's own).  gemma2-2b's 4400-token prompt wraps both its 4096-slot
    # local ring and its 1024-slot global ring; the depth-cut models keep one
    # period of their layer pattern and serve 2 requests, so every width of
    # theirs launches on the card (gemma3-1b's 700 wraps its 512-slot ring)
    ZOO_PATHS = {"gemma2-2b": ((4400, 1100, 300, 40, 700), 32, None),
                 "bitnet-3b": (PROMPT_LENS, 32, None),
                 "gemma3-1b": ((700, 40), 16, 6),
                 "minicpm-2b": ((700, 40), 16, 2),
                 "stablelm-1.6b": ((700, 40), 16, 2)}

    def _serve_zoo(self, arch, prompt_lens, gen_len, depth):
        """Path ``arch``: the model at full width (depth cut to ``depth``
        layers where given), seeded random weights, base-3 packed, bf16,
        served from a CUDA graph: 4 slots, greedy requests 2 steps apart,
        with the packed path's checks (token counts, exact launch counts,
        finite logits, bitwise batch invariance).  At full depth also the
        admission of the first prompt and the decode step under the
        profiler, replayed and eager (the same tokens and launches a step),
        and a 2-layer model at the real widths on the card against the CPU."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as MD
        from repro_torch.serve import Request, ServeConfig
        t_path = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        t0 = time.perf_counter()
        params = MD.init_params(cfg, seed=self.seed, device=self.dev)
        model = MD.export_serving(params, cfg)
        del params
        torch.cuda.synchronize()
        lin = model.layers[0]
        cut = "" if depth is None else (f" (cut from {get_config(arch).n_layers}: one period "
                                        f"of the pattern)")
        log(f"[serve] {arch}: {cfg.n_layers} layers{cut}, "
            f"kinds {''.join(k[0] for k in cfg.layer_kinds())}, d_model {cfg.d_model}, "
            f"{cfg.n_heads} heads of {cfg.head_dim_} over {cfg.n_kv_heads}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab}, act {cfg.act}, window {cfg.window}, softcaps "
            f"{cfg.attn_softcap}/{cfg.logit_softcap}, {'tied' if cfg.tie_embeddings else 'untied'}"
            f", embedding scale {model.embed_scale}; packed rows q {lin.attn.wq.packed.shape}, "
            f"down {lin.ffn.w_out.packed.shape}; init+export {time.perf_counter() - t0:.1f} s")
        chunk, n_l = cfg.lpsa.chunk, cfg.n_layers
        rng = torch.Generator().manual_seed(self.seed + 11)
        prompts = [torch.randint(0, cfg.vocab, (p,), generator=rng).numpy() for p in prompt_lens]
        trace = [Request(uid=i, prompt=p, max_new_tokens=gen_len, arrival=2 * i)
                 for i, p in enumerate(prompts)]
        sc = ServeConfig(max_slots=4, max_len=max(prompt_lens) + gen_len, seed=self.seed)
        packs = [p // chunk for p in prompt_lens if p >= chunk]
        dense_down = cfg.d_ff % cfg.ternary.das.block != 0

        def want(st):
            return _packed_counts(n_l, st.decode_steps + st.warmup_steps, packs, dense_down)

        _, eng, res = self._serve_path(arch, lambda: model, trace, sc, want)
        route = ("ternary_gemm on masked dense rows" if dense_down
                 else "das_ternary_gemm on compacted rows")
        log(f"[serve] {arch}: the down projection (K = {cfg.d_ff}) takes {route}")
        self._finite_logits(arch, model, prompts[0][:chunk], sc.max_len)
        self._batch_invariance(arch, eng, trace, res, (0, 3) if len(trace) > 3 else (0, 1))
        del eng
        if depth is None:
            self._profile_admission(model, prompts[0], sc.max_len)
            # the eager step only for its tokens and launches (its profile
            # would take ~1 min of the run to aggregate)
            runs = [self._profile_decode(f"{arch} {'graph' if graph else 'eager'}", model, sc,
                                         prompts, graph, profiled=graph)
                    for graph in (True, False)]
            if runs[0]["tokens"] != runs[1]["tokens"] or runs[0]["per_step"] != runs[1]["per_step"]:
                raise AssertionError(f"{arch}: the replayed decode step differs from the eager "
                                     f"one in tokens or launches a step")
            log(f"[profile] {arch}: replayed and eager decode steps give the same tokens bitwise "
                f"and the same launches a step {runs[0]['per_step']}; ms/step "
                f"{runs[0]['ms_step']:.3f} / {runs[1]['ms_step']:.3f} (graph / eager), device "
                f"busy {runs[0]['busy_ms_step']} ms/step, idle share {runs[0]['idle']} (graph)")
            self._width_parity(arch, cfg, prompts[0])
        del model
        torch.cuda.empty_cache()
        _took(arch, t_path)

    # -- dist: SPMD serving over ranks that share the card ------------------

    DIST_TEACHER = 2        # the packed trace's request teacher-forced: prompt 256, one pack
    DIST_EXACT = (0, 2, 4)  # the requests teacher-forced in float32, DAS off: 4, 1 and 2 packs
    DIST_MOE_DEPTH = 2      # qwen3-moe-30b-a3b's depth in the dist phase, of 48
    DIST_EXACT_STEPS = 8    # decode steps of the float32, DAS-off teacher-forced checks
    # what every rank of (a) and of (c) must launch; each shard takes the
    # DAS route of its own K, so (a)'s ranks launch ternary_gemm (masked
    # dense rows) where their down shard holds d_ff's dense tail, and only
    # there
    DIST_KERNELS = ("das_topk", "das_ternary_gemm", "sparse_attention")
    DIST_TAIL_KERNELS = ("ternary_gemm",)
    DIST_MOE_KERNELS = ("twd_decode",)

    @staticmethod
    def _smooth(cfg):
        """``cfg`` in float32 with DAS off: no discontinuity between the
        sharded sums and the one-rank ones (a DAS top-k decision is one)."""
        return dataclasses.replace(cfg, dtype="float32",
                                   ternary=dataclasses.replace(cfg.ternary, das=None))

    def phase_dist(self):
        """SPMD serving: ranks spawned on cuda:0 (one card: NCCL refuses two
        ranks on one device) over gloo, each loading the kernels the build
        phase built and serving its shard through them.  (a) bitnet-1.3b at
        full width and depth, Topology(dp=2, tp=2), 4 ranks, the packed
        trace: every rank samples the same tokens and launches das_topk,
        das_ternary_gemm and sparse_attention, and ternary_gemm where its
        down shard holds the dense tail, and only there; its tokens and a
        teacher-forced request (2) are set beside the packed path's, with
        the first difference and the one-rank top-2 margin there (reported:
        a row-parallel sum rounds in another order, and a DAS top-k decision
        at a tie turns on that, so bf16 with DAS on need not follow the one
        rank token for token); the same model in float32 with DAS off
        (no discontinuity), requests DIST_EXACT teacher-forced over their
        pack-aligned prefixes and 8 steps, within 1e-4 of the one-rank max;
        ms a step and the card's idle share over 8 full decode steps.  (b) the same with a loss of 2 ranks before
        decode step 3: one reshard, Topology(dp=1, tp=2), (a)'s tokens
        exactly.  (c) qwen3-moe-30b-a3b at full width, DIST_MOE_DEPTH
        layers, Topology(tp=2): each rank 64 of the 128 experts, twd_decode
        on each rank, tokens and logits beside a one-rank run, and in
        float32 with DAS off as in (a), within 1e-4 with the experts' int8
        fake-quant the identity (reported as served).  Then, in the same
        world, the distributed trainer (``_dist_train_jobs``): (d) bitnet-1.3b
        at full width, DIST_TRAIN_CUT layers, float32, DAS off, the
        fake-quants on with one rank's ties, dp 2 x tp 2 with ZeRO-1
        against one rank; (g) its checkpoint after step 1 restored onto dp
        1 x tp 2 (2 ranks lost) and step 2 taken there; (f) the GPipe
        pipeline over 2 pods of tp 2 ranks, then the int8
        cross-pod mean of (d)'s gradients; (e) bitnet-1.3b at full width
        and DIST_TRAIN_DEPTH layers, bf16, DAS on, as trained, 2 steps of 4
        x 2048 tokens at dp 2 x tp 2."""
        import shutil
        import tempfile

        torch = self.torch
        from repro_torch.distributed.launch import run_ranks
        from repro_torch.distributed.plan import Topology
        from repro_torch.launch import serve as cli
        from repro_torch.models import model as MD
        from repro_torch.serve import Request
        cfg, params, model, prompts, sc = self._packed_model()
        ref = getattr(self, "packed_tokens", None)
        if ref is None:                      # the serve phase did not run here
            self._serve_packed(cfg, model, prompts, sc)
            ref = self.packed_tokens
        trace = tuple(Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                      for i, p in enumerate(prompts))
        (ROOT / "build").mkdir(exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="dist_", dir=ROOT / "build"))
        try:
            t0 = time.perf_counter()
            path, path32 = str(tmp / "bitnet.pt"), str(tmp / "bitnet_f32.pt")
            torch.save(model.state_dict(), path)
            teach = self.DIST_TEACHER
            forced = ref[teach][:-1]
            one_rank = cli.teacher_forced(model, prompts[teach], forced, max_len=sc.max_len)
            del model, params
            cfg32 = self._smooth(cfg)
            m32 = MD.init_serving(cfg32, seed=self.seed, device=self.dev)
            torch.save(m32.state_dict(), path32)
            feeds = self._exact_feeds(cfg32, prompts)
            one32 = {u: cli.teacher_forced(m32, *f, max_len=sc.max_len) for u, f in feeds.items()}
            del m32
            torch.cuda.empty_cache()
            topo = Topology(dp=2, tp=2)
            sc_d = dataclasses.replace(sc, topology=topo)
            dev = self.dev.type
            jobs = [cli.RankJob(cfg, sc_d, dev, path, trace,
                                teachers=((prompts[teach], forced),), profile_steps=8),
                    cli.RankJob(cfg, sc_d, dev, path, trace, fail_at=(3,), lost=2)]
            jobs.append(cli.RankJob(cfg32, sc_d, dev, path32, teachers=tuple(feeds.values())))
            log(f"[dist] {cfg.name}: Topology(dp=2, tp=2); d_ff {cfg.d_ff} cut "
                f"{[hi - lo for lo, hi in MD.model_bounds(cfg, 2)['ff']]}; references and "
                f"weights in {time.perf_counter() - t0:.1f} s")
            moe_jobs, moe_check = self._dist_moe_jobs(tmp)
            train_jobs, train_check = self._dist_train_jobs(tmp)
            mt_jobs, mt_check = self._dist_moe_train_jobs(tmp)
            t0 = time.perf_counter()
            self._packed_cache = None        # a later phase that needs it builds it again
            gc.collect()                     # engines and graphs left in reference cycles
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            log(f"[dist] {topo.n_devices} ranks spawned on cuda:0, backend gloo, world size "
                f"{topo.n_devices}: first (h) (each rank ~11-13 GB at its peak: it runs while "
                f"the ranks hold nothing else), then (a), (b), (a) in float32 (requests "
                f"{self.DIST_EXACT}), (c) on ranks 0 and 1, the trainer's (d), (g), (f), (e); "
                f"the card's used before the spawn {(total - free) / 1e9:.2f} GB (this "
                f"process's tensors {torch.cuda.memory_allocated() / 1e9:.2f} GB, its cache "
                f"{torch.cuda.memory_reserved() / 1e9:.2f} GB); the ranks' allocator with "
                f"expandable segments")
            alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
            try:
                with _card_peak(torch) as card:
                    outs = run_ranks(_dist_world, topo.n_devices,
                                     mt_jobs + [(j, False) for j in jobs] + moe_jobs
                                     + train_jobs, backend="gloo")
            finally:
                if alloc is None:
                    os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
                else:
                    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
            mt_outs = [o[:len(mt_jobs)] for o in outs]
            outs = [o[len(mt_jobs):] for o in outs]
            log(f"[dist] the ranks' world took {time.perf_counter() - t0:.1f} s (spawn, CUDA "
                f"init, every job's load, cut and run); the card's most used "
                f"{card['peak'] / 1e9:.2f} of {total / 1e9:.2f} GB (every process, sampled "
                f"every 20 ms), at {card['at']:.1f} s into the world")
            tails = [(hi - lo) % cfg.ternary.das.block != 0
                     for lo, hi in MD.model_bounds(cfg, topo.tp)["ff"]]
            need = [self.DIST_KERNELS + self.DIST_TAIL_KERNELS * tails[r % topo.tp]
                    for r in range(topo.n_devices)]
            self._dist_report("a", cfg, trace, ref, [o[0] for o in outs], one_rank, need,
                              path, sc.max_len)
            n = len(jobs)
            self._dist_exact("a", f"{cfg.name} in float32, DAS off, {cfg.n_layers} layers",
                             {u: (len(f[0]), [o[2]["teachers"][i] for o in outs],
                                  one32[u]) for i, (u, f) in enumerate(feeds.items())})
            prof = [o[0]["profile"] for o in outs]
            wall = max(p["ms_step"] for p in prof)
            busy = sum(p["busy_ms_step"] for p in prof)
            log(f"[dist] (a) ranks sharing one card, gloo: {prof[0]['steps']} decode steps of 4 "
                f"active rows, {wall:.3f} ms a step (host clock, the slowest rank), device busy "
                f"{busy:.3f} ms a step over the 4 ranks "
                f"({[round(p['busy_ms_step'], 3) for p in prof]}), card idle share "
                f"{max(0.0, 1 - busy / wall):.3f}; collectives a step on rank 0: "
                f"{prof[0]['all_reduce_step']:.1f} all-reduces, {prof[0]['collective_ms_step']:.3f}"
                f" ms on the host clock, {prof[0]['wait_ms_step']:.3f} of it waiting for the "
                f"rank's kernels ({_nvidia_smi()}; not a multi-card time)")
            a_tokens = outs[0][0]["tokens"]
            for rank, o in enumerate(outs):
                b = o[1]
                if rank >= 2:
                    if b is not None:
                        raise AssertionError(f"(b) rank {rank} served on after its loss")
                    continue
                if (b["stats"]["reshards"], b["topology"]) != (1, Topology(dp=1, tp=2)) \
                        or b["tokens"] != a_tokens:
                    raise AssertionError(f"(b) rank {rank}: reshards {b['stats']['reshards']}, "
                                         f"{b['topology']}, tokens equal to (a)'s "
                                         f"{b['tokens'] == a_tokens}")
            st = outs[0][1]["stats"]
            log(f"[dist] (b) a loss of 2 ranks before decode step 3: reshards "
                f"{st['reshards']}, topology after {outs[0][1]['topology']}, recovery_seconds "
                f"{st['recovery_seconds']:.3f} (rank 0; {outs[1][1]['stats']['recovery_seconds']:.3f}"
                f" rank 1), the tokens (a)'s exactly; ranks 2 and 3 retired; rank 0's host "
                f"seconds {self._secs(outs[0][1])}")
            m = n + len(moe_jobs)
            k = m + len(train_jobs)
            moe_check([o[n:m] for o in outs])
            train_check([o[m:k] for o in outs])
            mt_check(mt_outs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    @staticmethod
    def _secs(out):
        return {k: round(v, 1) for k, v in out["seconds"].items()}

    def _dist_report(self, label, cfg, trace, ref, outs, one_rank, kernels, path, max_len):
        """Every rank sampled the same tokens and launched each of its
        ``kernels[rank]``, and none of DIST_TAIL_KERNELS outside them
        (checked); the tokens and the teacher-forced logits
        beside the one-rank run's, with the first difference of each request
        and the one-rank top-2 margin there (reported)."""
        torch = self.torch
        from repro_torch.launch import serve as cli
        from repro_torch.models import model as MD
        for rank, o in enumerate(outs):
            if o["tokens"] != outs[0]["tokens"]:
                raise AssertionError(f"({label}) rank {rank} sampled other tokens than rank 0")
        got, chunk = outs[0]["tokens"], cfg.lpsa.chunk
        model = None
        for r in trace:
            a, b = ref[r.uid], got[r.uid]
            if a == b:
                continue
            if model is None:
                model = MD.TernaryLM(cfg, self.dev)
                model.load_state_dict(torch.load(path, map_location=self.dev))
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            prefix = r.prompt_len // chunk * chunk
            feed = [int(t) for t in r.prompt[prefix:]] + a[:j]
            lg = torch.from_numpy(cli.teacher_forced(model, r.prompt[:prefix], feed,
                                                     max_len=max_len)[-1])
            top = torch.topk(lg, 2)
            margin, bar = float(top.values[0] - top.values[1]), TOL_BF16 * max(
                1.0, abs(float(top.values[0])))
            log(f"[dist] ({label}) req {r.uid}: first difference from the one-rank tokens at "
                f"token {j} ({a[j]} one rank, {b[j]} sharded); the one-rank top-2 margin there "
                f"{margin:.4g} ({'within' if margin <= bar else 'beyond'} the bf16 tolerance "
                f"{bar:.4g}), the sharded token's one-rank logit {float(lg[b[j]]):.4g} against "
                f"{float(top.values[0]):.4g}")
        del model
        log(f"[dist] ({label}) tokens: {sum(ref[u] == got[u] for u in ref)} of {len(ref)} "
            f"requests token for token the one-rank run's; every rank the same")
        rels = [float(abs(g - w).max() / abs(w).max()) for g, w in zip(outs[0]["teachers"][0],
                                                                     one_rank)]
        log(f"[dist] ({label}) teacher-forced request: max |diff| / one-rank max |logit| by "
            f"step {[round(v, 4) for v in rels]} (bf16 tolerance {TOL_BF16})")
        for rank, o in enumerate(outs):
            n = o["launches"]
            log(f"[dist] ({label}) rank {rank}: launches {n}; host seconds {self._secs(o)}; "
                f"{o['stats']['decode_steps']} decode steps, "
                f"{1e3 * o['stats']['decode_seconds'] / max(1, o['stats']['decode_steps']):.1f} "
                f"ms a step; collectives {o['collectives']}")
            missing = [k for k in kernels[rank] if n[k] <= 0]
            stray = [k for k in self.DIST_TAIL_KERNELS if k not in kernels[rank] and n[k]]
            if missing or stray:
                raise AssertionError(f"({label}) rank {rank} never launched {missing}, and "
                                     f"launched {stray} off its shard's route")
            for name, c in n.items():
                self.launches[name] += c

    def _exact_feeds(self, cfg, prompts):
        """{uid: (prompt, tokens)} of the DIST_EXACT requests for
        ``teacher_forced``: the pack-aligned prefix of the request's prompt,
        then DIST_EXACT_STEPS tokens, the rest of its prompt and then
        request 3's."""
        chunk, n = cfg.lpsa.chunk, self.DIST_EXACT_STEPS
        out = {}
        for u in self.DIST_EXACT:
            p = prompts[u]
            prefix = len(p) // chunk * chunk
            out[u] = (p[:prefix], [int(t) for t in list(p[prefix:]) + list(prompts[3])][:n])
        return out

    def _dist_exact(self, label, what, runs, tol=TOL_F32_GEMM):
        """The float32 teacher-forced logits of every rank within ``tol``
        (the float32 GEMM tolerance) of the one-rank max at every step, for
        each request of ``runs`` {uid: (its prefix's tokens, each rank's
        logits, the one-rank logits)}; ``tol`` None: reported only."""
        bad = []
        for uid, (prefix, outs, one_rank) in runs.items():
            worst = max(float(abs(g - w).max() / abs(w).max())
                        for o in outs for g, w in zip(o, one_rank))
            log(f"[dist] ({label}) {what}, request {uid}: a prefill of {prefix} tokens and "
                f"{len(one_rank) - 1} steps teacher-forced on {len(outs)} ranks, max |diff| / "
                f"one-rank max |logit| {worst:.3e} ({'reported' if tol is None else f'bar {tol}'})")
            if tol is not None and not worst <= tol:
                bad.append(f"request {uid}: {worst:.3g}")
        if bad:
            raise AssertionError(f"({label}) float32 sharded logits off the one-rank run's "
                                 f"max by {bad}")

    def _dist_moe_jobs(self, tmp):
        """(c): qwen3-moe-30b-a3b at DIST_MOE_DEPTH layers, Topology(tp=2):
        its one-rank references and weights, the ranks' jobs (ranks 0 and 1
        serve them, 2 and 3 sit outside the mesh) as (job, smooth) pairs for
        ``_dist_world``, and the check of their outputs -> (jobs, check(each
        rank's outputs of these jobs)).  In float32 with DAS off the
        experts' int8 fake-quant is still a discontinuity: the DIST_EXACT
        requests are held within 1e-4 with it the identity on both sides,
        and reported as served."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.distributed.plan import Topology
        from repro_torch.launch import serve as cli
        from repro_torch.models import model as MD
        from repro_torch.serve import Request, ServeConfig, ServeEngine
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(self.MOE_ARCH), n_layers=self.DIST_MOE_DEPTH)
        rng = torch.Generator().manual_seed(self.seed + 13)
        prompts = [torch.randint(0, cfg.vocab, (p,), generator=rng).numpy()
                   for p in self.PROMPT_LENS]
        trace = tuple(Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                      for i, p in enumerate(prompts))
        sc = ServeConfig(max_slots=4, max_len=max(self.PROMPT_LENS) + self.GEN_LEN,
                         seed=self.seed)
        teach = self.DIST_TEACHER
        model = MD.init_serving(cfg, seed=self.seed, device=self.dev)
        path, path32 = str(tmp / "moe.pt"), str(tmp / "moe_f32.pt")
        torch.save(model.state_dict(), path)
        eng = ServeEngine(model, sc, device=self.dev)
        for r in trace:
            eng.submit(r)
        ref = {uid: r.tokens.tolist() for uid, r in eng.run().items()}
        del eng
        forced = ref[teach][:-1]
        one_rank = cli.teacher_forced(model, prompts[teach], forced, max_len=sc.max_len)
        del model
        cfg32 = self._smooth(cfg)
        m32 = MD.init_serving(cfg32, seed=self.seed, device=self.dev)
        torch.save(m32.state_dict(), path32)
        feeds = self._exact_feeds(cfg32, prompts)
        one32 = {u: cli.teacher_forced(m32, *f, max_len=sc.max_len) for u, f in feeds.items()}
        from repro_torch.core import ternary as tq
        quant = tq.int8_fake_quant
        try:
            tq.int8_fake_quant = lambda x: x
            smooth = {u: cli.teacher_forced(m32, *f, max_len=sc.max_len)
                      for u, f in feeds.items()}
        finally:
            tq.int8_fake_quant = quant
        del m32
        torch.cuda.empty_cache()
        sc_t = dataclasses.replace(sc, topology=Topology(tp=2))
        dev = self.dev.type
        jobs = [(cli.RankJob(cfg, sc_t, dev, path, trace, teachers=((prompts[teach], forced),)),
                 False)]
        jobs += [(cli.RankJob(cfg32, sc_t, dev, path32, teachers=tuple(feeds.values())), ident)
                 for ident in (True, False)]
        log(f"[dist] (c) {cfg.name} at {cfg.n_layers} of {get_config(self.MOE_ARCH).n_layers} "
            f"layers, Topology(tp=2): references and weights in "
            f"{time.perf_counter() - t0:.1f} s")

        def check(outs):
            if any(o is not None for o in outs[2] + outs[3]):
                raise AssertionError("(c) ranks 2 and 3 served outside Topology(tp=2)")
            outs = outs[:2]
            self._dist_report("c", cfg, trace, ref, [o[0] for o in outs], one_rank,
                              [self.DIST_MOE_KERNELS] * 2, path, sc.max_len)
            for off, one, what, tol in (
                    (1, smooth, "the experts' int8 fake-quant the identity", TOL_F32_GEMM),
                    (2, one32, "as served", None)):
                self._dist_exact("c", f"{cfg.name} in float32, DAS off, {cfg.n_layers} layers, "
                                 f"{what}", {u: (len(f[0]), [o[off]["teachers"][i]
                                                             for o in outs], one[u])
                                             for i, (u, f) in enumerate(feeds.items())}, tol)
            e = cfg.moe.n_experts
            for rank, o in enumerate(outs):
                o = o[0]
                e0, e1 = o["experts"]
                if (e0, e1) != (rank * e // 2, (rank + 1) * e // 2):
                    raise AssertionError(f"(c) rank {rank} holds experts {o['experts']}")
                log(f"[dist] (c) rank {rank}: experts [{e0}, {e1}), so each twd_decode launch "
                    f"decodes {e1 - e0} of the {e} stacks one rank decodes "
                    f"({o['launches']['twd_decode']} launches)")
        return jobs, check

    # the dist phase's trainer: (d) and (g) at DIST_TRAIN_CUT layers in
    # float32 with DAS off, (e) at DIST_TRAIN_DEPTH in bf16 with DAS on (as
    # trained), each DIST_TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    # tokens; (f) 2 stages of one block, DIST_PIPE_MB microbatches of one
    # DIST_PIPE_SEQ-token row.  (e) is cut to 4 of bitnet-1.3b's 24 layers:
    # with 24 the whole script read 1326 s of its 1200 on a slow host (a step
    # ~30 s of host round trips), with 12 up to ~1188 s (PERF.md §5); (d) and
    # (g) to 1 layer (2 before (h) joined the phase: PERF.md §6)
    DIST_TRAIN_CUT, DIST_TRAIN_DEPTH, DIST_TRAIN_STEPS = 1, 4, 2
    DIST_PIPE_MB, DIST_PIPE_SEQ = 4, 256
    DIST_TRAIN_TOL = {"loss": 2e-5, "grad": TOL_F32_GEMM, "param": TOL_F32_GEMM,
                      "pipe_fwd": 1e-5, "pipe_grad": TOL_F32_GEMM, "crosspod": 0.02}

    @staticmethod
    def _unquantized(cfg):
        """``cfg`` with the ternary stack off: the weights and activations
        unquantized, so no rounding decision (an int8 value or a trit at a
        .5 boundary, which another sum order can move across) sits between
        the sharded sums and one rank's."""
        return dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary, enabled=False,
                                                                    das=None))

    def _dist_train_jobs(self, tmp):
        """(d)-(g): the one-rank references computed here on the card (then
        freed) and written with the weights and batches under ``tmp``; the
        ranks' jobs (``_TrainJob``, run by ``_dist_world``) and the check of
        their outputs -> (jobs, check(each rank's outputs of these jobs)).
        (d) and (g) run bitnet-1.3b in float32 with DAS off, its one-rank
        rounding decisions recorded here (``torch_ties.Replay``) for the
        ranks to take at near ties; (f) with the ternary stack off
        (``_unquantized``); each held to DIST_TRAIN_TOL."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.launch import train as TR
        from repro_torch.models import model as MD
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw
        from repro_torch.tree import leaves, tree_map, unflatten
        t0 = time.perf_counter()
        base = get_config(self.TRAIN_ARCH)
        host = lambda tree: tree_map(lambda x: x.detach().cpu(), tree)  # noqa: E731
        path = lambda name: str(tmp / f"{name}.pt")  # noqa: E731

        def batches(seed, name):
            data = SyntheticLM(vocab=base.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=seed)
            bs = [data.batch_at(s) for s in range(self.DIST_TRAIN_STEPS)]
            torch.save(bs, path(name))
            return bs

        def one_rank(cfg, p, bs, before=lambda s: None):
            step = TR.make_train_step(cfg, TR.make_runtime(), peak_lr=self.TRAIN_LR,
                                      warmup=self.TRAIN_WARMUP, total=self.DIST_TRAIN_STEPS)
            o, losses = adamw.adamw_init(p), []
            for s, b in enumerate(bs):
                before(s)
                p, o, m = step(p, o, b)
                losses.append(float(m["loss"]))
            return p, losses

        # (d), (g): float32, DAS off; the params before, the step-1 gradients,
        # the params after the steps on one rank and its rounding decisions
        # (one record for the gradients and step 1, one for step 2)
        cfg_d = dataclasses.replace(base, n_layers=self.DIST_TRAIN_CUT, dtype="float32",
                                    ternary=dataclasses.replace(base.ternary, das=None))
        cfg_s = self._unquantized(cfg_d)
        bs = batches(self.seed + 21, "batches")
        refs = {}
        p = MD.init_params(cfg_d, seed=self.seed + 21, device=self.dev)
        torch.save(host(p), path("d_params"))
        ties, recs = _torch_ties().Replay(), []
        try:
            recs.append(ties.record())
            _, aux, g = TR.loss_and_grads(p, cfg_d, bs[0], TR.make_runtime())
            torch.save({"loss": float(aux["loss"]), "grads": host(g)}, path("d_ref"))
            del g

            def new_pass(s):          # step 1 repeats the gradients' decisions
                if s:
                    recs.append(ties.record())
            p, refs["d"] = one_rank(cfg_d, p, bs, new_pass)
        finally:
            ties.restore()
        torch.save(recs, path("d_ties"))
        n_rec = sum(len(v) for r in recs for v in r.values())
        torch.save(host(p), path("d_params2"))
        del p, recs
        # (f): two blocks of the same widths, sequential on one rank
        blocks = MD.init_params(dataclasses.replace(cfg_s, n_layers=2), seed=self.seed + 22,
                                device=self.dev)["layers"]["tail"]
        gen = self.gen(self.seed + 22)
        x = torch.randn((self.DIST_PIPE_MB, self.DIST_PIPE_SEQ, base.d_model), generator=gen,
                        device=self.dev)
        ct = torch.randn(x.shape, generator=gen, device=self.dev)
        flat = [t.requires_grad_() for t in leaves(blocks)]
        y = x
        for bp in unflatten(blocks, flat):
            y = T.block_train(bp, cfg_s, y, "attn", None, T.Runtime())
        grads = torch.autograd.grad((y * ct).sum(), flat)
        torch.save({"blocks": host(blocks), "x": x.cpu(), "ct": ct.cpu(), "y": y.detach().cpu(),
                    "grads": host(unflatten(blocks, list(grads)))}, path("pipe"))
        del blocks, flat, grads, x, ct, y
        # (e): bf16, DAS on, as trained
        cfg_e = dataclasses.replace(base, n_layers=self.DIST_TRAIN_DEPTH)
        bs_e = batches(self.seed + 23, "e_batches")
        p = MD.init_params(cfg_e, seed=self.seed + 23, device=self.dev)
        torch.save(host(p), path("e_params"))
        p, refs["e"] = one_rank(cfg_e, p, bs_e)
        del p
        torch.cuda.empty_cache()
        kw = dict(steps=self.DIST_TRAIN_STEPS, lr=self.TRAIN_LR, warmup=self.TRAIN_WARMUP)
        d_files = {"params": path("d_params"), "ref": path("d_ref"), "params2": path("d_params2"),
                   "batches": path("batches"), "ties": path("d_ties"), "ckpt": str(tmp / "ckpt")}
        jobs = [_TrainJob("d", cfg_d, d_files, **kw), _TrainJob("g", cfg_d, d_files, **kw),
                _TrainJob("f", cfg_s, {"pipe": path("pipe"), "params": path("d_params"),
                                       "batches": path("batches")}, **kw),
                _TrainJob("e", cfg_e, {"params": path("e_params"), "batches": path("e_batches")},
                          **kw)]
        log(f"[dist] the trainer's references on one rank and their files in "
            f"{time.perf_counter() - t0:.1f} s: (d) {cfg_d.n_layers} layers float32, DAS off, "
            f"the fake-quants on ({n_rec} distinct int8 and trit decisions recorded), losses "
            f"{[round(v, 6) for v in refs['d']]}; (e) "
            f"{cfg_e.n_layers} layers {cfg_e.dtype} DAS "
            f"{cfg_e.ternary.das.keep}/{cfg_e.ternary.das.block}, losses "
            f"{[round(v, 6) for v in refs['e']]}")

        def check(outs):
            self._dist_train_check(outs, cfg_e, refs)
        return [(j, False) for j in jobs], check

    def _dist_train_check(self, outs, cfg_e, refs):
        """(d), (g) (each rank's ties within the tie rule) and (f) against
        DIST_TRAIN_TOL; (e)'s launches against the path's structure, its
        costs reported."""
        tol, smi, bad = self.DIST_TRAIN_TOL, _nvidia_smi(), []
        for rank, (d, g, f, e) in enumerate(outs):
            rel = abs(d["loss"] - d["ref_loss"]) / abs(d["ref_loss"])
            log(f"[dist] (d) rank {rank}: step 1 loss {d['loss']:.6f} vs one rank "
                f"{d['ref_loss']:.6f} (rel {rel:.2e}, tol {tol['loss']}); worst gradient leaf "
                f"{d['grad_err']:.3e} of its max (tol {tol['grad']}); params after "
                f"{len(d['losses'])} steps worst |diff| {d['param_err']:.3e} (tol {tol['param']}; "
                f"{d['param_rel']:.3e} of a leaf's max); losses "
                f"{[round(v, 6) for v in d['losses']]} vs one rank "
                f"{[round(v, 6) for v in refs['d']]}; ties: {d['ties'][1]}; {d['seconds']:.1f} s")
            if not (rel <= tol["loss"] and d["grad_err"] <= tol["grad"]
                    and d["param_err"] <= tol["param"] and d["ties"][0]):
                bad.append(f"(d) rank {rank}")
            if rank >= 2:
                if g is not None:
                    bad.append(f"(g) rank {rank} trained after its loss")
            else:
                log(f"[dist] (g) rank {rank}: step {g['restored']} restored onto "
                    f"{g['topology']}, moment shapes {g['moments']}; step 2 loss {g['loss']:.6f} "
                    f"vs one rank {refs['d'][-1]:.6f}; params worst |diff| {g['param_err']:.3e} "
                    f"(tol {tol['param']}) against the uninterrupted one-rank step 2; ties: "
                    f"{g['ties'][1]}; {g['seconds']:.1f} s")
                if not (g["restored"] == 1 and g["param_err"] <= tol["param"] and g["ties"][0]):
                    bad.append(f"(g) rank {rank}")
            log(f"[dist] (f) rank {rank} (pod {f['pod']}): {self.DIST_PIPE_MB} microbatches "
                f"through 2 stages of tp 2, {f['ticks']} ticks: output {f['y_err']:.3e} of its "
                f"max (tol {tol['pipe_fwd']}), worst gradient leaf of its stage {f['g_err']:.3e} "
                f"(tol {tol['pipe_grad']}); {f['hops']} sends; int8 cross-pod mean of the "
                f"gradients of (d)'s weights and batch {f['crosspod']:.3e} of a leaf's max from the exact mean (tol "
                f"{tol['crosspod']}), residual max {f['residual']:.3e}; {f['seconds']:.1f} s")
            if not (f["y_err"] <= tol["pipe_fwd"] and f["g_err"] <= tol["pipe_grad"]
                    and f["crosspod"] <= tol["crosspod"] and f["residual"] > 0):
                bad.append(f"(f) rank {rank}")
        per = sum(_das_inputs(cfg_e, k) for k in cfg_e.layer_kinds()) * (2 if cfg_e.remat else 1)
        es = [o[-1] for o in outs]
        for rank, e in enumerate(es):
            for s, st in enumerate(e["steps"]):
                n = st["launches"]
                others = {k: v for k, v in n.items() if k != "das_topk" and v}
                prof = (f", profiled: {e['profiled_topk']} das_topk kernels"
                        if s == len(e["steps"]) - 1 else "")
                log(f"[dist] (e) rank {rank} step {s}: loss {st['loss']:.6f} (one rank "
                    f"{refs['e'][s]:.6f}; reported: bf16 and DAS ties part in sum order), "
                    f"{st['ms']:.1f} ms on the host clock; das_topk {n['das_topk']} launches, "
                    f"das_train_mask {st['mask_calls']} calls (expected {per}: "
                    f"{per // cfg_e.n_layers} a layer with remat){prof}; collectives "
                    f"{st['collectives']}")
                if n["das_topk"] != per or st["mask_calls"] != per or others:
                    bad.append(f"(e) rank {rank} step {s}: launches {n}, mask calls "
                               f"{st['mask_calls']}")
                self.launches["das_topk"] += n["das_topk"]
            if e["profiled_topk"] != e["steps"][-1]["launches"]["das_topk"]:
                bad.append(f"(e) rank {rank}: {e['profiled_topk']} das_topk kernels profiled")
        bad += self._dryrun_against(cfg_e, es)
        wall = max(e["steps"][-1]["ms"] for e in es)
        busy = _union_ms([sp for e in es for sp in e["spans"]])
        log(f"[dist] (e) {cfg_e.name}, {cfg_e.n_layers} layers, dp 2 x tp 2, ZeRO-1: the profiled "
            f"step {wall:.1f} ms (the slowest rank, host clock); the card busy {busy:.1f} ms (the "
            f"union of the 4 ranks' device spans: their kernels and copies time-slice one card, so "
            f"their summed durations, {[round(e['busy_ms'], 1) for e in es]} ms of which copies "
            f"{[round(e['copy_ms'], 1) for e in es]}, overlap), idle share "
            f"{max(0.0, 1 - busy / wall):.3f}; peak memory a rank "
            f"{[round(e['peak'] / 1e9, 2) for e in es]} GB, the card's used "
            f"{max(e['card_used'] for e in es) / 1e9:.2f} GB (mem_get_info); "
            f"{smi}; ranks sharing one card over gloo, not a multi-card time")
        if bad:
            raise AssertionError(f"dist trainer: {bad}")

    def _dryrun_against(self, cfg_e, es) -> list:
        """The dry run's record of (e)'s cell, computed here on the meta
        device (``launch.dryrun.make_cell`` at each rank's position of a
        virtual Topology(dp=2, tp=2), the batch of TRAIN_BATCH x TRAIN_SEQ):
        its state bytes and its collective wire bytes by kind a step must
        equal each (e) rank's exactly; the ranks' memory_allocated after
        setup is reported beside the state (the allocator rounds)."""
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.distributed.plan import Topology
        from repro_torch.launch import dryrun
        t0 = time.perf_counter()
        topo, shape = Topology(dp=2, tp=2), ShapeSpec("dist_e", "train", TRAIN_SEQ, TRAIN_BATCH)
        bad, cells = [], {}
        for rank, e in enumerate(es):
            pos = e["position"] % topo.tp    # the data ranks are symmetric: one record a
            if pos not in cells:             # "model" position
                cell = dryrun.make_cell(cfg_e, shape, topo.virtual_mesh(pos))
                cells[pos] = (cell, dryrun.measure(cell.run))
            cell, m = cells[pos]
            ok = cell.state_bytes == e["state"] and all(st["wire"] == m["collectives"]
                                                        for st in e["steps"])
            log(f"[dist] (e) rank {rank} beside the dry run on meta (position {e['position']}, "
                f"model index {pos}): state {e['state']} B, the dry run's {cell.state_bytes} B "
                f"(memory_allocated after setup {e['allocated']} B, reported); collective wire "
                f"bytes a step {e['steps'][-1]['wire']}, the dry run's {m['collectives']}: "
                f"{'equal' if ok else 'DIFFERENT'}; the dry run's FLOPs {m['flops']:.4e}, "
                f"op-level bytes {m['bytes']:.4e} a step")
            if not ok:
                bad.append(f"(e) rank {rank} against the dry run")
        log(f"[dist] (e)'s dry run on meta: {time.perf_counter() - t0:.1f} s (host)")
        return bad

    # (h): qwen3-moe-30b-a3b at full width and DIST_MOE_TRAIN_DEPTH layer,
    # Topology(dp=2, tp=2), float32, DAS on, the fake-quants on, the config's
    # capacity factor; DIST_TRAIN_STEPS steps, each data half
    # DIST_MOE_TRAIN_ROWS x DIST_MOE_TRAIN_SEQ tokens.  One layer is ~1.23 B
    # parameters (0.60 B of experts, a 311 M embedding, a 311 M untied head):
    # ~20 GB of float32 state on one rank, ~7.5 GB a rank at dp 2 x tp 2
    DIST_MOE_TRAIN_DEPTH, DIST_MOE_TRAIN_ROWS, DIST_MOE_TRAIN_SEQ = 1, 2, 1024

    def _dist_moe_train_jobs(self, tmp):
        """(h): the one-rank reference computed here on the card (then freed)
        and dumped under ``tmp``: the JAX package's mesh semantics, each data
        half alone (its capacity from its own 2 x 1024 tokens) through the
        loss and gradients, the halves averaged, AdamW on the average; each
        half's rounding and routing decisions recorded (``torch_ties.
        Replay``) for the ranks of that half to take at near ties.  ->
        (jobs, check(each rank's outputs of these jobs))."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.launch import train as TR
        from repro_torch.models import model as MD
        from repro_torch.optim import adamw, schedule
        from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten
        t0 = time.perf_counter()
        base = get_config(self.MOE_ARCH)
        cfg = dataclasses.replace(base, n_layers=self.DIST_MOE_TRAIN_DEPTH, dtype="float32")
        rows, n = self.DIST_MOE_TRAIN_ROWS, self.DIST_TRAIN_STEPS
        data = SyntheticLM(vocab=base.vocab, seq_len=self.DIST_MOE_TRAIN_SEQ, batch=2 * rows,
                           seed=self.seed + 24)
        bs = [data.batch_at(s) for s in range(n)]
        files = {"batches": str(tmp / "h_batches.pt"), "ties": str(tmp / "h_ties.pt"),
                 "params": str(tmp / "h_params.bin"), "params2": str(tmp / "h_params2.bin"),
                 "grads": [str(tmp / f"h_grads{h}.bin") for h in (0, 1)],
                 "maxes": str(tmp / "h_maxes.pt")}
        torch.save(bs, files["batches"])
        p = MD.init_params(cfg, seed=self.seed + 24, device=self.dev)
        _dump(p, files["params"])
        ties, drops = _torch_ties().Replay(), []

        def halves(p, batch, per_half=None):
            """(mean loss, mean gradients (a list), each half's records); each
            half's own part of the mean appended to ``per_half``."""
            losses, total, recs = [], None, []
            for h in (0, 1):
                recs.append(ties.record())
                half = {k: v[h * rows:(h + 1) * rows] for k, v in batch.items()}
                with _counting_drops(drops):
                    _, aux, g = TR.loss_and_grads(p, cfg, half, TR.make_runtime())
                losses.append(float(aux["loss"]))
                g = [x.float() / 2 for x in leaves(g)]
                if per_half is not None:
                    per_half.append(g)
                total = g if total is None else [a + b for a, b in zip(total, g)]
            return sum(losses) / 2, total, recs

        try:
            parts = []
            first = halves(p, bs[0], parts)   # the gradients' pass is step 1's too
            loss, grad_recs = first[0], first[2]
            maxes = {"grads": [], "params2": None}
            for h, g in enumerate(parts):
                _dump(g, files["grads"][h])
                maxes["grads"].append([float(x.abs().max()) for x in g])
            del parts
            o, step_recs, step_losses = adamw.adamw_init(p), [], []
            for s, b in enumerate(bs):
                sl, g, recs = first if s == 0 else halves(p, b)
                first = None
                lr = schedule.cosine_schedule(o.step, peak_lr=self.TRAIN_LR,
                                              warmup=self.TRAIN_WARMUP, total=n)
                p, o, _ = adamw.adamw_step(p, unflatten(p, g), o, lr=lr, weight_decay=0.1)
                step_recs.append(recs)
                step_losses.append(sl)
                del g
        finally:
            ties.restore()
        _dump(p, files["params2"])
        # a norm's scale leaf is an offset (``layers.rmsnorm`` scales by 1 +
        # scale, zeros at init), so after the steps it holds nothing but the
        # AdamW updates: its params are held against the weight the model
        # applies, 1 + scale (each other leaf against its own max)
        maxes["params2"] = [float((x + 1 if _norm_offset(path) else x).abs().max())
                            for path, x in leaves_with_paths(p)]
        torch.save(maxes, files["maxes"])
        torch.save({"grad": grad_recs, "steps": step_recs}, files["ties"])
        n_rec = sum(len(v) for r in grad_recs for v in r.values())
        del p, o
        torch.cuda.empty_cache()
        kw = dict(steps=n, lr=self.TRAIN_LR, warmup=self.TRAIN_WARMUP)
        job = _TrainJob("h", cfg, files, **kw)
        ref = {"loss": loss, "losses": step_losses, "drops": drops}
        log(f"[dist] (h) the reference on one rank and its files in "
            f"{time.perf_counter() - t0:.1f} s: {cfg.name} at full width, {cfg.n_layers} "
            f"layer, float32, DAS {cfg.ternary.das.keep}/{cfg.ternary.das.block}, capacity "
            f"factor {cfg.moe.capacity_factor}; each data half of {rows} x "
            f"{self.DIST_MOE_TRAIN_SEQ} tokens alone, averaged: loss {loss:.6f}, step losses "
            f"{[round(v, 6) for v in step_losses]}; {n_rec} distinct rounding and routing "
            f"decisions recorded for the gradients; dropped copies a half-pass {drops}")

        def check(outs):
            self._dist_moe_train_check(outs, cfg, ref)
        return [(job, False)], check

    def _dist_moe_train_check(self, outs, cfg, ref):
        """(h): each rank's loss, gradients (its part: half its data half's
        gradient) and params after the steps against the reference, every
        rank's das_topk launched, the ties within the tie rule."""
        tol, bad = self.DIST_TRAIN_TOL, []
        for rank, (h,) in enumerate(outs):
            rel = abs(h["loss"] - ref["loss"]) / abs(ref["loss"])
            steps = [abs(a - b) for a, b in zip(h["losses"], ref["losses"])]
            log(f"[dist] (h) rank {rank} (data half {h['half']}, experts {h['experts']}): "
                f"loss {h['loss']:.6f} vs one rank's halves averaged {ref['loss']:.6f} (rel "
                f"{rel:.2e}, tol {tol['loss']}); worst gradient leaf {h['grad_err']:.3e} of its "
                f"max (tol {tol['grad']}); params after {len(h['losses'])} steps worst "
                f"{h['param_err']:.3e} of a leaf's max, a norm's of 1 + scale (tol "
                f"{tol['param']}); step losses "
                f"{[round(v, 6) for v in h['losses']]} (|diff| {max(steps):.2e}); das_topk "
                f"launches {h['topk']}; dropped copies a pass {h['drops']}; ties: "
                f"{h['ties'][1]}; the worst param element: {h['param_worst']}; state "
                f"{h['state'] / 1e9:.2f} GB, peak memory "
                f"{h['peak'] / 1e9:.2f} GB allocated, {h['peak_reserved'] / 1e9:.2f} GB "
                f"reserved; {h['seconds']:.1f} s (host seconds by stage: "
                f"{h['stages']})")
            if not (rel <= tol["loss"] and h["grad_err"] <= tol["grad"]
                    and h["param_err"] <= tol["param"] and max(steps) <= tol["param"]
                    and h["topk"] > 0 and h["ties"][0]):
                bad.append(f"(h) rank {rank}")
            self.launches["das_topk"] += h["topk"]
        drops = outs[0][0]["drops"]
        none = "" if sum(drops) else " (none: these batches' routing stays under the capacity)"
        log(f"[dist] (h) dropped copies at capacity factor {cfg.moe.capacity_factor}: "
            f"{sum(drops)} over the rank's passes {drops}, the reference's {ref['drops']}{none}")
        if bad:
            raise AssertionError(f"dist MoE trainer: {bad}")

    MOE_ARCH = "qwen3-moe-30b-a3b"
    # the MoE path's depth, cut from 48 to keep the whole run within the
    # time limit beside the SSM paths (with all 48 it read 820 s on an H100),
    # the hybrid (with 16, 884 s) and the stub-frontend models (4 since
    # them); the step unpacks every expert of every layer, so its serving
    # time scales with depth (its width checks, most of its time, do not)
    MOE_DEPTH = 4

    def _serve_moe(self):
        """Path "qwen3-moe-30b-a3b": the MoE model at full width, its depth
        cut to MOE_DEPTH of its 48 layers (128 experts of 768, top-8; 32
        heads of 64 over 4; vocab
        151936, untied head), seeded random weights exported layer by layer,
        base-3 packed, bf16, DAS 16/32, LPSA 128 + 896, served from the CUDA
        graph: bitnet-1.3b's packed trace (4 slots, 5 greedy requests of 32
        new tokens, prompts 1100 / 300 / 256 / 40 / 700, 2 steps apart),
        exact launch counts (twd_decode 3 a layer per decode step and per
        prefill), finite logits, bitwise batch invariance; the dropped copies
        per layer of the 1100-token admission, the routed copies per expert
        of its first, middle and last layer, and its profile; the decode
        step under the profiler, replayed and eager (the same tokens and
        launches a step), with device time by class; a 2-layer model at
        these widths on the card against the CPU (_moe_width_parity)."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as MD
        from repro_torch.models import moe as MOE
        from repro_torch.serve import Request, ServeConfig
        arch = self.MOE_ARCH
        t_path = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=self.MOE_DEPTH)
        e = cfg.moe
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = MD.init_serving(cfg, seed=self.seed, device=self.dev)
        torch.cuda.synchronize()
        nbytes = sum(b.numel() * b.element_size() for b in model.state_dict().values())
        st = model.layers[0].moe
        log(f"[serve] {arch}: {cfg.n_layers} layers (cut from {get_config(arch).n_layers}), "
            f"d_model {cfg.d_model}, {cfg.n_heads} heads "
            f"of {cfg.head_dim_} over {cfg.n_kv_heads}, {e.n_experts} experts of {e.d_expert}, "
            f"top-{e.top_k}, {e.n_shared} shared, vocab {cfg.vocab}, "
            f"{'tied' if cfg.tie_embeddings else 'untied'}; expert stacks packed "
            f"{tuple(st.experts_gate.packed.shape)} / {tuple(st.experts_out.packed.shape)}; "
            f"serving weights {nbytes / 1e9:.3f} GB; init+export layer by layer "
            f"{time.perf_counter() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        chunk, n_l = cfg.lpsa.chunk, cfg.n_layers
        rng = torch.Generator().manual_seed(self.seed + 13)
        prompts = [torch.randint(0, cfg.vocab, (p,), generator=rng).numpy()
                   for p in self.PROMPT_LENS]
        trace = [Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                 for i, p in enumerate(prompts)]
        sc = ServeConfig(max_slots=4, max_len=max(self.PROMPT_LENS) + self.GEN_LEN,
                         seed=self.seed)
        packs = [p // chunk for p in self.PROMPT_LENS if p >= chunk]

        def want(st):
            return _moe_counts(n_l, st.decode_steps + st.warmup_steps, packs)

        _, eng, res = self._serve_path(arch, lambda: model, trace, sc, want)
        self._finite_logits(arch, model, prompts[0][:chunk], sc.max_len)
        self._batch_invariance(arch, eng, trace, res, (0, 3))
        del eng
        n = len(prompts[0]) // chunk * chunk
        MD.prefill(model, torch.as_tensor(prompts[0][:n], dtype=torch.long,
                                          device=self.dev)[None], max_len=sc.max_len)
        drops = [int(bp.moe.dropped) for bp in model.layers]
        cap = MOE.prefill_capacity(cfg, n)
        log(f"[serve] {arch} admission of the {len(prompts[0])}-token prompt: the MoE runs over "
            f"the {n}-token prefix at once, capacity {cap} a expert against a mean load of "
            f"{n * e.top_k / e.n_experts:g}; dropped copies per layer {drops}, {sum(drops)} of "
            f"{n * e.top_k * n_l} in all ({sum(drops) / (n * e.top_k * n_l):.3f})")
        for i in (0, n_l // 2, n_l - 1):
            load = sorted(model.layers[i].moe.load.tolist(), reverse=True)
            log(f"[serve] {arch} admission, layer {i}: routed copies per expert, largest "
                f"first: {load[:16]} ...; experts over capacity {sum(v > cap for v in load)}, "
                f"with no copy {load.count(0)}, the 8 largest hold "
                f"{sum(load[:8]) / sum(load):.3f} of the copies")
        self._profile_admission(model, prompts[0], sc.max_len, classes="moe")
        runs = [self._profile_decode(f"{arch} {'graph' if graph else 'eager'}", model, sc,
                                     prompts, graph, profiled=graph, classes="moe")
                for graph in (True, False)]
        if runs[0]["tokens"] != runs[1]["tokens"] or runs[0]["per_step"] != runs[1]["per_step"]:
            raise AssertionError(f"{arch}: the replayed decode step differs from the eager "
                                 f"one in tokens or launches a step")
        log(f"[profile] {arch}: replayed and eager decode steps give the same tokens bitwise "
            f"and the same launches a step {runs[0]['per_step']}; ms/step "
            f"{runs[0]['ms_step']:.3f} / {runs[1]['ms_step']:.3f} (graph / eager), device "
            f"busy {runs[0]['busy_ms_step']} ms/step, idle share {runs[0]['idle']} (graph)")
        del model
        torch.cuda.empty_cache()
        self._moe_width_parity(arch, cfg, prompts[0])
        _took(arch, t_path)

    SSM_ARCHS = ("rwkv6-3b", "gla-1.3b")
    # (das_topk, das_ternary_gemm) launches a layer, per decode step and per
    # prefill alike: rwkv's 8 projections each take their own DAS step; gla's
    # q/k/v/g share one (the norm inside), o, gate/up (sharing one, the norm
    # inside) and down
    SSM_LAUNCHES = {"rwkv": (8, 8), "gla": (4, 8)}
    SSM_C1_PROMPT = 997        # a prime above 56: the chunk rule's c = 1
    # rwkv6-3b's depth, cut from 32 beside the train phase: with every path
    # at full depth the whole run read 1149 s of its 1200 s limit, rwkv6-3b
    # 120.2 s of it (its 997-token admission, one-token chunks, is
    # host-bound and scales with depth); at 16 layers its path read 68-73 s
    SSM_DEPTH = {"rwkv6-3b": 16}

    def _serve_ssm(self, arch):
        """Path ``arch``: an attention-free model at full width (rwkv6-3b:
        SSM_DEPTH's 16 of its 32 layers, 40 heads of 64, d_ff 8960, vocab
        65536; gla-1.3b: all 24 layers, 4 heads of 512, d_ff 5632, vocab
        32000; both untied), seeded random weights exported layer by layer, base-3
        packed, bf16, DAS 16/32, served from the CUDA graph with its
        recurrent slot states: bitnet-1.3b's packed trace (each prompt
        prefilled whole at admission), exact launch counts, every decode
        step a replay, finite logits, bitwise batch invariance; the
        admission of the 1100-token prompt (chunk 55) and of a 997-token one
        (chunk 1); the decode step under the profiler with device time by
        SSM class, replayed and eager (the same tokens and launches a step);
        a 2-layer model at these widths on the card against the CPU."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as MD
        from repro_torch.serve import Request, ServeConfig
        t_path = time.perf_counter()
        cfg = get_config(arch)
        cut = ""
        if arch in self.SSM_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=self.SSM_DEPTH[arch])
            cut = f" (cut from {get_config(arch).n_layers})"
        kind, n_l = cfg.layer_pattern[0], cfg.n_layers
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = MD.init_serving(cfg, seed=self.seed, device=self.dev)
        torch.cuda.synchronize()
        nbytes = sum(b.numel() * b.element_size() for b in model.state_dict().values())
        state = sum(b.nbytes for b in MD.init_caches(cfg, 1, 1, device="meta")[0].values())
        log(f"[serve] {arch}: {n_l} {kind} layers{cut}, d_model {cfg.d_model}, {cfg.n_heads} "
            f"heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"{'tied' if cfg.tie_embeddings else 'untied'}; serving weights {nbytes / 1e9:.3f} GB, "
            f"recurrent state {state * n_l / 1e6:.1f} MB a slot (float32); init+export layer by "
            f"layer {time.perf_counter() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        rng = torch.Generator().manual_seed(self.seed + 17)
        prompts = [torch.randint(0, cfg.vocab, (p,), generator=rng).numpy()
                   for p in (*self.PROMPT_LENS, self.SSM_C1_PROMPT)]
        trace = [Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                 for i, p in enumerate(prompts[:len(self.PROMPT_LENS)])]
        sc = ServeConfig(max_slots=4, max_len=max(self.PROMPT_LENS) + self.GEN_LEN,
                         seed=self.seed)
        topk, gemm = self.SSM_LAUNCHES[kind]

        def want(st):   # each admission prefills its whole prompt once
            calls = st.decode_steps + st.warmup_steps + len(trace)
            return {**{name: 0 for name in KERNEL_INFO}, "das_topk": n_l * topk * calls,
                    "das_ternary_gemm": n_l * gemm * calls}

        _, eng, res = self._serve_path(arch, lambda: model, trace, sc, want)
        layouts = {(d["kind"], d["layout"]) for d in eng.layout_summary()}
        log(f"[serve] {arch}: slot-state layouts {sorted(layouts)} over {n_l} layers; "
            f"{eng.stats.prefill_tokens} prefill tokens (every prompt whole at admission)")
        if layouts != {(kind, kind)} or eng.stats.prefill_tokens != sum(self.PROMPT_LENS):
            raise AssertionError(f"{arch}: the engine's slot states or prefills are wrong")
        self._finite_logits(arch, model, prompts[2], sc.max_len)
        self._batch_invariance(arch, eng, trace, res, (0, 3))
        del eng
        for prompt in (prompts[0], prompts[-1]):
            self._profile_ssm_admission(arch, model, prompt)
        runs = [self._profile_decode(f"{arch} {'graph' if graph else 'eager'}", model, sc,
                                     prompts, graph, profiled=graph, classes="ssm")
                for graph in (True, False)]
        if runs[0]["tokens"] != runs[1]["tokens"] or runs[0]["per_step"] != runs[1]["per_step"]:
            raise AssertionError(f"{arch}: the replayed decode step differs from the eager "
                                 f"one in tokens or launches a step")
        log(f"[profile] {arch}: replayed and eager decode steps give the same tokens bitwise "
            f"and the same launches a step {runs[0]['per_step']}; ms/step "
            f"{runs[0]['ms_step']:.3f} / {runs[1]['ms_step']:.3f} (graph / eager), device "
            f"busy {runs[0]['busy_ms_step']} ms/step, idle share {runs[0]['idle']} (graph)")
        del model
        torch.cuda.empty_cache()
        self._width_parity(arch, cfg, prompts[0])
        _took(arch, t_path)

    def _profile_ssm_admission(self, arch, model, prompt):
        """The admission of ``prompt`` on an SSM path: one batch-1 prefill of
        the whole prompt, its chunk from the chunk rule; CUDA events and the
        host clock around one prefill, then device busy by SSM class under
        torch.profiler: over the whole prefill when its chunk is above 1,
        else over layer 0's block alone (its tens of thousands of launches
        a layer make a whole-model trace slow to aggregate), times the
        layers for the model."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import layers as L
        from repro_torch.models import model as MD
        from repro_torch.models import transformer as T
        from repro_torch.models.linear_attn import CHUNK, chunk_size
        cfg, n = model.cfg, len(prompt)
        c = chunk_size(n, CHUNK)
        tok = torch.as_tensor(prompt, dtype=torch.long, device=self.dev)[None]
        if c > 1:    # warm the allocator (a c = 1 prefill runs the same ops as
            MD.prefill(model, tok, max_len=n + 1)   # the one before, for ~20 s)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        MD.prefill(model, tok, max_len=n + 1)
        ev1.record()
        torch.cuda.synchronize()
        host, ms = time.perf_counter() - t0, ev0.elapsed_time(ev1)
        if c > 1:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                MD.prefill(model, tok, max_len=n + 1)
                torch.cuda.synchronize()
            scope, times = "the whole prefill", 1
        else:
            x = L.take_embed(model.embed, tok)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                T.block_prefill(model.layers[0], cfg, x, serve_sparse=True, max_len=n + 1)
                torch.cuda.synchronize()
            scope, times = f"layer 0 alone x {cfg.n_layers} layers", cfg.n_layers
        by_name = _Trace(prof).device_times()
        busy_us = sum(by_name.values()) * times
        if not busy_us:
            log(f"[profile] {arch} admission: the profiler recorded no device time: not measured")
            return
        log(f"[profile] {arch} admission of a {n}-token prompt (chunk {c}: {n // c} chunks a "
            f"layer): {ms:.3f} ms (CUDA events), host {host:.3f} s, device busy "
            f"{busy_us / 1e3:.3f} ms under torch.profiler ({scope}), idle share "
            f"{1 - busy_us / 1e3 / ms:.3f}; by SSM class: " + ", ".join(
                f"{cat} {us * times / 1e3:.3f}" for cat, us in _by_class(by_name, "ssm").items()))
        for name, dt in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[profile]   {dt * times / 1e3:8.3f} ms  {name[:90]}")

    HYBRID_ARCH = "zamba2-2.7b"
    # the hybrid path's depth, cut from 54 to two periods of its pattern (10
    # mamba layers, the shared block at 2 positions) since the stub-frontend
    # paths joined the run (with all 54 the hybrid path read 113.7 s)
    HYBRID_DEPTH = 12
    # the width check's prompt (LPSA off, so it prefills whole): one full SSD
    # chunk of 256 and a 252-token remainder; its 8 decode steps cross the
    # fold at t = 511
    HYBRID_PARITY_PROMPT = 508
    # its tolerance: 8.1e-4 read on an H100 at seed 0, peaking at the fold
    # (t = 511; 3.7e-4 at the prefill), where a per-layer reading (card vs
    # CPU) finds layer 0's states within ~1e-6 of their size and the
    # difference growing 3-10x a mamba layer, as float32 sum orders do
    # through the gated rmsnorm; beside it the card's model moves its own
    # logits by 9.2e-4 when its input moves one ulp (``_width_parity``)
    HYBRID_PARITY_TOL = 2e-3

    def _serve_hybrid(self):
        """Path "zamba2-2.7b": the hybrid at full width, its depth cut to
        HYBRID_DEPTH of its 54 layers (mamba blocks of d_inner 5120, 80 SSM
        heads of 64, state 64, chunk 256; attention positions sharing one
        block of 32 heads of 80 over 32, each with its own norms and FFN of
        10240; vocab 32000, tied), seeded random
        weights exported layer by layer, base-3 packed, bf16, DAS 16/32, LPSA
        128 + 896, served from the CUDA graph: bitnet-1.3b's packed trace
        (admission prefills the pack-aligned prefix, the tail fed a token a
        tick), exact launch counts, every decode step a replay, finite
        logits, bitwise batch invariance, the slot-state layouts (mamba on
        the mamba layers, ring on the attention positions); the 1100-token admission (its 1024-token
        prefill by device class, then its 76 tail ticks); the decode step
        under the profiler, replayed and eager (the same tokens and launches
        a step), by class, beside the floor of the bytes a step moves; the
        SSD glue of one mamba layer (buffer writes, replay row, fold) under
        a CUDA graph; a 6-layer model at these widths (5 mamba layers and
        the shared block) on the card against the CPU in float32 with DAS
        and LPSA off, a 508-token prompt and 8 steps across a fold."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as MD
        from repro_torch.serve import Request, ServeConfig
        arch = self.HYBRID_ARCH
        t_path = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=self.HYBRID_DEPTH)
        kinds = cfg.layer_kinds()
        n_m, n_a = kinds.count("mamba"), kinds.count("attn")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = MD.init_serving(cfg, seed=self.seed, device=self.dev)
        torch.cuda.synchronize()
        weights = sum(b.numel() * b.element_size() for b in model.state_dict().values())
        caches = MD.init_caches(cfg, 1, 1, device="meta")
        mamba = sum(b.nbytes for b in caches[kinds.index("mamba")].values())
        ring = sum(b.nbytes for b in caches[kinds.index("attn")].values())
        slot = n_m * mamba + n_a * ring
        floor_ms = (weights + 4 * slot) / HBM_BYTES_PER_S * 1e3
        ssm = cfg.ssm
        log(f"[serve] {arch}: {n_m} mamba + {n_a} attention layers (one shared block), d_model "
            f"{cfg.d_model}, d_inner {ssm.expand * cfg.d_model}, SSM heads of {ssm.head_dim}, "
            f"state {ssm.state_dim}, chunk {ssm.chunk}; attention {cfg.n_heads} heads of "
            f"{cfg.head_dim_} over {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"{'tied' if cfg.tie_embeddings else 'untied'}; serving weights {weights / 1e9:.3f} "
            f"GB; slot state {slot / 1e6:.1f} MB a slot ({mamba / 1e6:.2f} MB a mamba layer, "
            f"float32; {ring / 1e6:.2f} MB a ring); the floor of a 4-slot decode step, weights "
            f"and 4 slots' states read once: {(weights + 4 * slot) / 1e9:.3f} GB, "
            f"{floor_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; init+export layer by "
            f"layer {time.perf_counter() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        rng = torch.Generator().manual_seed(self.seed + 19)
        prompts = [torch.randint(0, cfg.vocab, (p,), generator=rng).numpy()
                   for p in self.PROMPT_LENS]
        trace = [Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                 for i, p in enumerate(prompts)]
        sc = ServeConfig(max_slots=4, max_len=max(self.PROMPT_LENS) + self.GEN_LEN,
                         seed=self.seed)
        chunk = cfg.lpsa.chunk
        packs = [p // chunk for p in self.PROMPT_LENS if p >= chunk]

        def want(st):
            return _hybrid_counts(n_m, n_a, st.decode_steps + st.warmup_steps, packs)

        _, eng, res = self._serve_path(arch, lambda: model, trace, sc, want)
        layouts = {}
        for d in eng.layout_summary():
            layouts[d["kind"], d["layout"]] = layouts.get((d["kind"], d["layout"]), 0) + 1
        log(f"[serve] {arch}: slot-state layouts {layouts}; {eng.stats.prefill_tokens} prefill "
            f"tokens (the pack-aligned prefixes; each tail fed a token a tick)")
        if (layouts != {("mamba", "mamba"): n_m, ("attn", "ring"): n_a}
                or eng.stats.prefill_tokens != chunk * sum(packs)):
            raise AssertionError(f"{arch}: the engine's slot states or prefills are wrong")
        self._finite_logits(arch, model, prompts[0][:chunk], sc.max_len)
        self._batch_invariance(arch, eng, trace, res, (0, 3))
        del eng
        self._profile_admission(model, prompts[0], sc.max_len, classes="hybrid")
        self._profile_tail(arch, model, prompts[0], sc)
        runs = [self._profile_decode(f"{arch} {'graph' if graph else 'eager'}", model, sc,
                                     prompts, graph, profiled=graph, classes="hybrid")
                for graph in (True, False)]
        if runs[0]["tokens"] != runs[1]["tokens"] or runs[0]["per_step"] != runs[1]["per_step"]:
            raise AssertionError(f"{arch}: the replayed decode step differs from the eager "
                                 f"one in tokens or launches a step")
        log(f"[profile] {arch}: replayed and eager decode steps give the same tokens bitwise "
            f"and the same launches a step {runs[0]['per_step']}; ms/step "
            f"{runs[0]['ms_step']:.3f} / {runs[1]['ms_step']:.3f} (graph / eager), device "
            f"busy {runs[0]['busy_ms_step']} ms/step, idle share {runs[0]['idle']} (graph); "
            f"the floor {floor_ms:.3f} ms/step")
        self._ssd_glue_times(model, n_m)
        del model
        torch.cuda.empty_cache()
        self._width_parity(arch, cfg, prompts[0], tol=self.HYBRID_PARITY_TOL,
                           n=self.HYBRID_PARITY_PROMPT, serve_sparse=False)
        _took(arch, t_path)

    FRONTEND_ARCHS = ("musicgen-medium", "pixtral-12b")
    # pixtral-12b's depth, cut from 40 beside the train phase (the whole run
    # read 1149 s of its 1200 s limit with every path at full depth,
    # pixtral-12b 105.9 s of it; its serving, admission and profiles scale
    # with depth, its 2-layer width check does not)
    FRONTEND_DEPTH = {"pixtral-12b": 20}
    FRONTEND_PAGED = "musicgen-medium"      # the one served again under layout="paged"

    def _serve_frontend(self, arch):
        """Path ``arch``, a stub-frontend model at full width (musicgen-medium:
        all 48 layers, 24 heads of 64 over 24, the 2-matrix gelu MLP of 6144,
        vocab 2048; pixtral-12b: FRONTEND_DEPTH's 20 of its 40 layers, 32
        heads of 160 over 8, the gated silu FFN of 14336, vocab 131072, RoPE
        theta 1e6; both untied), seeded random weights exported layer by layer, base-3
        packed, bf16, DAS 16/32, LPSA 128 + 896, served from the CUDA graph
        on prompts of float32 embeddings: the packed trace (pack-aligned
        prefixes prefilled, tails fed a row a tick through ``forced_x``), so
        the residual stream is float32 throughout (the reference's), its
        K/V rounded into bfloat16 rings; exact launch counts, every decode
        step a replay, finite logits, bitwise batch invariance, a ring on
        every layer; for musicgen-medium the same trace again under
        layout="paged" (equal tokens, no prefix hit: embeddings carry no ids);
        the 1100-row admission by device class; the decode step under the
        profiler, replayed and eager (the same tokens and launches a step), by
        class, beside the floor of the bytes a step moves; a 2-layer model at
        these widths against the CPU (f32, DAS off, the embedding prompt)."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as MD
        from repro_torch.models.ternary_linear import TernaryLinear
        from repro_torch.serve import Request, ServeConfig
        t_path = time.perf_counter()
        cfg = get_config(arch)
        cut = ""
        if arch in self.FRONTEND_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=self.FRONTEND_DEPTH[arch])
            cut = f" (cut from {get_config(arch).n_layers})"
        n_l, chunk = cfg.n_layers, cfg.lpsa.chunk
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = MD.init_serving(cfg, seed=self.seed, device=self.dev)
        torch.cuda.synchronize()
        packed = sum(m.packed.nbytes for m in model.modules() if isinstance(m, TernaryLinear))
        ring = sum(b.nbytes for b in MD.init_caches(cfg, 1, 1, device="meta")[0].values())
        head32 = cfg.d_model * cfg.vocab_padded * 4       # the head the float32 logits read
        step_bytes = packed + head32 + 4 * n_l * ring
        floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[serve] {arch}: {n_l} layers{cut}, d_model {cfg.d_model}, {cfg.n_heads} heads "
            f"of {cfg.head_dim_} over {cfg.n_kv_heads}, {cfg.ffn_kind} FFN of {cfg.d_ff} ({cfg.act})"
            f", vocab {cfg.vocab}, untied, frontend {cfg.frontend!r}: prompts of float32 "
            f"embeddings, so the residual stream is float32 over bf16 weights and rings; "
            f"packed ternary weights {packed / 1e9:.3f} GB, head {head32 / 2e9:.3f} GB in bf16 "
            f"({head32 / 1e9:.3f} GB as the float32 copy the logits read), rings "
            f"{n_l * ring / 1e6:.1f} MB a slot; the floor of a 4-slot decode step, those read "
            f"once: {step_bytes / 1e9:.3f} GB, {floor_ms:.3f} ms at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; init+export layer by layer "
            f"{time.perf_counter() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        rng = torch.Generator().manual_seed(self.seed + 23)
        prompts = [torch.randn((p, cfg.d_model), generator=rng).numpy() for p in self.PROMPT_LENS]
        trace = [Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                 for i, p in enumerate(prompts)]
        sc = ServeConfig(max_slots=4, max_len=max(self.PROMPT_LENS) + self.GEN_LEN,
                         seed=self.seed)
        packs = [p // chunk for p in self.PROMPT_LENS if p >= chunk]
        mlp = cfg.ffn_kind == "mlp"

        def want(st):
            return _frontend_counts(n_l, st.decode_steps + st.warmup_steps, packs, mlp)

        _, eng, res = self._serve_path(arch, lambda: model, trace, sc, want)
        layouts = {}
        for d in eng.layout_summary():
            layouts[d["kind"], d["layout"]] = layouts.get((d["kind"], d["layout"]), 0) + 1
        dtypes = {str(c["k"].dtype) for c in eng.caches}
        log(f"[serve] {arch}: slot-state layouts {layouts}, ring dtype {dtypes}; "
            f"{eng.stats.prefill_tokens} prefill rows (the pack-aligned prefixes; each tail fed "
            f"a row a tick), {eng.stats.prefix_hits} prefix hits")
        if (layouts != {("attn", "ring"): n_l} or dtypes != {"torch.bfloat16"}
                or eng.stats.prefill_tokens != chunk * sum(packs)):
            raise AssertionError(f"{arch}: the engine's slot states or prefills are wrong")
        self._finite_logits(arch, model, prompts[0][:chunk], sc.max_len)
        self._batch_invariance(arch, eng, trace, res, (0, 3))
        del eng
        if arch == self.FRONTEND_PAGED:
            # max_len in whole pages (the paged layout's rule; a ring has no pages)
            paged = dataclasses.replace(sc, layout="paged", max_len=-(-sc.max_len // 16) * 16)
            _, eng, res_p = self._serve_path(f"{arch} paged", lambda: model, trace, paged, want)
            log(f"[serve] {arch} paged: prefix_hits {eng.stats.prefix_hits}, pool "
                f"{eng.pool_stats()}")
            if eng.stats.prefix_hits or eng.stats.prefill_tokens != chunk * sum(packs):
                raise AssertionError(f"{arch} paged: a prefix was shared or prefills differ")
            self._same_tokens(f"{arch} paged (the dense engine's)", res_p,
                              {u: r.tokens for u, r in res.items()}, range(len(trace)))
            del eng
        self._profile_admission(model, prompts[0], sc.max_len, classes="frontend")
        runs = [self._profile_decode(f"{arch} {'graph' if graph else 'eager'}", model, sc,
                                     prompts, graph, profiled=graph, classes="frontend")
                for graph in (True, False)]
        if runs[0]["tokens"] != runs[1]["tokens"] or runs[0]["per_step"] != runs[1]["per_step"]:
            raise AssertionError(f"{arch}: the replayed decode step differs from the eager "
                                 f"one in tokens or launches a step")
        log(f"[profile] {arch}: replayed and eager decode steps give the same tokens bitwise "
            f"and the same launches a step {runs[0]['per_step']}; ms/step "
            f"{runs[0]['ms_step']:.3f} / {runs[1]['ms_step']:.3f} (graph / eager), device "
            f"busy {runs[0]['busy_ms_step']} ms/step, idle share {runs[0]['idle']} (graph); "
            f"the floor {floor_ms:.3f} ms/step")
        del model
        torch.cuda.empty_cache()
        self._width_parity(arch, cfg, prompts[0])
        _took(arch, t_path)

    def _profile_tail(self, arch, model, prompt, sc):
        """The admission of ``prompt`` through a graph engine: the prefill of
        its pack-aligned prefix, then its tail fed a token a tick through the
        replayed decode step, each by CUDA events and the host clock (the
        second of two runs; the first warms the allocator)."""
        torch = self.torch
        from repro_torch.serve import Request, ServeEngine
        eng = ServeEngine(model, sc, device="cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        for uid in (0, 1):
            eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            eng._admit_ready()
            ev[1].record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ticks = 0
            while eng.num_active:
                eng.step_decode()
                ticks += 1
            ev[2].record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            eng.drain_results()
        prefill, tail = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        n = len(prompt) - ticks
        log(f"[profile] {arch} admission of the {len(prompt)}-token prompt through the engine: "
            f"the {n}-token prefill {prefill:.3f} ms (CUDA events; host {t1 - t0:.3f} s), then "
            f"{ticks} tail ticks {tail:.3f} ms ({tail / ticks:.3f} ms a tick, replayed; host "
            f"{t2 - t1:.3f} s); first token after {prefill + tail:.3f} ms")

    def _graph_ms(self, fn, reps=50):
        """ms of one replay of ``fn`` captured into a CUDA graph (after a
        warm-up call on a side stream), by CUDA events over ``reps``."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def _ssd_glue_times(self, model, n_m):
        """The SSD glue of one mamba layer's decode step at 4 slots (rows at
        t = 1100, 511, 300, 40: row 1 fills its chunk and folds), each part
        captured into a CUDA graph of its own and replayed: the buffer writes
        (mamba2.ssd_write), the replay row (ssd_row: XLA's cumsum order over
        the chunk, the row's decays, scores and einsums) and the fold
        (ssd_fold: computed for every row, selected, the folded rows'
        buffers cleared), each times the mamba layers for the step."""
        torch = self.torch
        from repro_torch.models import kvcache as KV
        from repro_torch.models import mamba2 as M
        cfg, dev = model.cfg, self.dev
        g = self.gen(self.seed + 23)
        state = KV.init_cache(cfg, KV.CacheSpec("mamba", 4), dev)
        for buf in state.values():
            buf.copy_(0.1 * torch.randn(buf.shape, generator=g, device=dev))
        state["ssd_dt"].abs_()
        step = M.ssd_step_inputs(cfg, torch.tensor([1100, 511, 300, 40], device=dev))
        _, nh = M.mamba_dims(cfg)
        xh = torch.randn((4, nh, cfg.ssm.head_dim), generator=g, device=dev)
        bc = torch.randn((4, cfg.ssm.state_dim), generator=g, device=dev)
        dt = torch.rand((4, nh), generator=g, device=dev)
        a = -torch.exp(model.layers[0].mamba.a_log.float())
        _, cla = M.ssd_row(state, step, a)
        parts = {"buffer writes": lambda: M.ssd_write(state, step, xh, bc, bc, dt),
                 "replay row": lambda: M.ssd_row(state, step, a),
                 "fold": lambda: M.ssd_fold(state, step, cla)}
        times = {name: self._graph_ms(fn) for name, fn in parts.items()}
        log(f"[profile] {self.HYBRID_ARCH} SSD glue of one mamba layer's decode step at 4 slots, "
            f"each part a CUDA graph of its own: " + ", ".join(
                f"{name} {ms * 1e3:.1f} us ({ms * n_m:.3f} ms a step over {n_m} layers)"
                for name, ms in times.items()))

    # the MoE's width parity (2 layers, f32, card vs CPU) with the experts'
    # int8 fake-quant as it serves: 1.57e-3 read on an H100 at seed 0, where
    # the same model with the fake-quant the identity on both sides reads
    # 8.3e-6 (held to the dense models' 2e-4)
    MOE_PARITY_TOL = 2e-3

    def _moe_width_parity(self, arch, cfg, prompt_ids):
        """_width_parity for the MoE, twice on the same weights: with the
        experts' int8 fake-quant made the identity on both sides, within the
        dense models' 2e-4; then as it serves, within MOE_PARITY_TOL, with
        the fake-quant's outputs recorded on both sides and the quantized
        values that differ card vs CPU counted (the grid turns a last-bit
        difference of its input into a whole step)."""
        from repro_torch.core import ternary as tq
        quant = tq.int8_fake_quant
        seen = {"cpu": [], "cuda": []}

        def recording(x):
            y = quant(x)
            seen[x.device.type].append((x.cpu(), y.cpu()))
            return y

        try:
            tq.int8_fake_quant = lambda x: x
            self._width_parity(f"{arch} (the experts' fake-quant the identity)", cfg, prompt_ids)
            tq.int8_fake_quant = recording
            self._width_parity(arch, cfg, prompt_ids, tol=self.MOE_PARITY_TOL)
        finally:
            tq.int8_fake_quant = quant
            if seen["cuda"]:
                self._fake_quant_diff(arch, list(zip(seen["cpu"], seen["cuda"])))

    def _fake_quant_diff(self, arch, pairs):
        """How far the card's fake-quant is from the CPU's, call by call in
        the same order: the int8 values and the row scales that differ
        (int8_quantize of each side's recorded input: its ops are exact, so
        these are the values each side computed), and on the first call
        (layer 0's prefill) the inputs' and the outputs' largest
        difference."""
        from repro_torch.core import ternary as tq
        n_el = n_q = n_rows = n_sc = 0
        for (xc, _), (xg, _) in pairs:
            qc, qg = tq.int8_quantize(xc), tq.int8_quantize(xg)
            n_el, n_q = n_el + qc.values.numel(), n_q + int((qc.values != qg.values).sum())
            n_rows, n_sc = n_rows + qc.scale.numel(), n_sc + int((qc.scale != qg.scale).sum())
        (xc, yc), (xg, yg) = pairs[0]
        qc, qg = tq.int8_quantize(xc), tq.int8_quantize(xg)
        log(f"[serve] {arch} at its widths, the experts' fake-quant card vs CPU over "
            f"{len(pairs)} calls: {n_q} of {n_el} int8 values and {n_sc} of {n_rows} row "
            f"scales differ; layer 0's prefill: inputs differ by at most "
            f"{(xg - xc).abs().max().item():.2e}, {int((qc.values != qg.values).sum())} int8 "
            f"values differ (by at most "
            f"{(qc.values.int() - qg.values.int()).abs().max().item()}) and "
            f"{int((qc.scale != qg.scale).sum())} of {qc.scale.numel()} row scales, the "
            f"outputs by at most {(yg - yc).abs().max().item():.2e}")

    def _width_parity(self, label, cfg, prompt_ids, tol=2e-4, n=None, serve_sparse=True):
        """A model of ``cfg``'s widths (d_model, heads and head size, d_ff or
        the experts, vocab, pattern, soft-caps, activation) at 2 layers or
        one period of its pattern in float32 with DAS off, on the card
        (kernels) against the same weights on the CPU (plain versions): the
        prefill of an ``n``-token prompt (default 2 packs; 512 tokens without
        LPSA) + 8 teacher-forced decode steps within ``tol``, equal greedy
        tokens; ``serve_sparse=False`` turns LPSA off.  DAS is off because at these widths a
        float32 sum order that differs in the last bit flips near-ties of
        the top-16-of-32 (tens of thousands of blocks a run): DAS at these
        widths is held exactly in the kernels phase.  A stub frontend's
        prompt is its first ``n`` embedding rows.  Beside it, the card's
        model with every embedding value (and an embedding prompt's) moved
        one ulp up, teacher-forced on the same tokens: how far a last-bit
        difference moves its logits."""
        torch = self.torch
        from repro_torch.models import model as MD
        small = dataclasses.replace(
            cfg, n_layers=max(2, len(cfg.layer_pattern)), dtype="float32",
            ternary=dataclasses.replace(cfg.ternary, das=None))
        t0 = time.perf_counter()
        m_cpu = MD.init_serving(small, seed=self.seed, device="cpu")
        m_gpu = copy.deepcopy(m_cpu).to(self.dev)
        n = n if n is not None else 2 * (cfg.lpsa.chunk if cfg.lpsa else 256)
        kw = dict(max_len=n + 9, serve_sparse=serve_sparse)
        prompt = self._inputs(prompt_ids[:n], "cpu")
        lg_c, c_c = MD.prefill(m_cpu, prompt, **kw)
        lg_g, c_g = MD.prefill(m_gpu, prompt.to(self.dev), **kw)
        errs = [(lg_g.cpu() - lg_c).abs().max().item()]
        card = [lg_g]
        if cfg.moe is not None:
            drops = [[int(b.moe.dropped) for b in m.layers] for m in (m_cpu, m_gpu)]
            loads = all(torch.equal(a.moe.load, b.moe.load.cpu())
                        for a, b in zip(m_cpu.layers, m_gpu.layers))
            log(f"[serve] {label} at its widths: the {n}-token prefill's dropped copies per "
                f"layer {drops[0]} (CPU) / {drops[1]} (card), per-expert loads "
                f"{'equal' if loads else 'DIFFERENT'}")
            if drops[0] != drops[1]:
                raise AssertionError(f"{label}: the card drops other copies than the CPU")
        toks_c, toks_g = [int(lg_c.argmax())], [int(lg_g.argmax())]
        for i in range(8):
            t = torch.tensor([n + i])
            lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([toks_c[-1]]), t,
                                     serve_sparse=serve_sparse)
            lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([toks_c[-1]], device=self.dev),
                                     t.to(self.dev), serve_sparse=serve_sparse)
            errs.append((lg_g.cpu() - lg_c).abs().max().item())
            card.append(lg_g)
            toks_c.append(int(lg_c.argmax()))
            toks_g.append(int(lg_g.argmax()))
        err = max(errs)
        log(f"[serve] {label} at its widths, {small.n_layers} layers, f32, DAS off"
            f"{'' if serve_sparse else ', LPSA off'}, card vs CPU: "
            f"{n}-token prefill + 8 teacher-forced steps, max logit err {err:.2e} (tol {tol:g}; "
            f"by step {', '.join(f'{e:.1e}' for e in errs)}), greedy tokens "
            f"{'equal' if toks_c == toks_g else 'DIFFERENT'} ({time.perf_counter() - t0:.1f} s)")
        emb = m_gpu.embed
        emb.copy_(torch.nextafter(emb, torch.full_like(emb, math.inf)))
        if prompt.is_floating_point():      # an embedding prompt moves too
            prompt = torch.nextafter(prompt, torch.full_like(prompt, math.inf))
        lg_p, c_p = MD.prefill(m_gpu, prompt.to(self.dev), **kw)
        moved = [(lg_p - card[0]).abs().max().item()]
        for i in range(8):
            lg_p, _ = MD.decode_step(m_gpu, c_p, torch.tensor([toks_c[i]], device=self.dev),
                                     torch.tensor([n + i], device=self.dev),
                                     serve_sparse=serve_sparse)
            moved.append((lg_p - card[i + 1]).abs().max().item())
        log(f"[serve] {label} at its widths, the card's model with every embedding value one "
            f"ulp up against itself: max logit difference {max(moved):.2e} (by step "
            f"{', '.join(f'{e:.1e}' for e in moved)})")
        if err > tol or toks_c != toks_g:
            raise AssertionError(f"{label}: the card's model at its widths disagrees with the "
                                 f"CPU's")

    def _paged_lpsa(self, cfg, model):
        """Path "paged-lpsa": the packed model with LPSA under layout="paged",
        so the ring states are shared through the trie with no page arena.
        Prompts of 700, 600, 540, 760 and 512 tokens share one 512-token stem
        (2 packs): the first prefills it and registers it, every later one
        restores it from an exact entry and prefills nothing, so the path's
        prefills are the fresh admissions' and its tokens equal the dense
        engine's on the same trace."""
        from repro_torch.serve import Request, ServeConfig
        torch, stem_len, n_l = self.torch, 512, cfg.n_layers
        rng = torch.Generator().manual_seed(self.seed + 7)
        stem = torch.randint(0, cfg.vocab, (stem_len,), generator=rng)
        prompts = [torch.cat([stem, torch.randint(0, cfg.vocab, (p - stem_len,),
                                                  generator=rng)]).numpy()
                   for p in (700, 600, 540, 760, 512)]
        trace = [Request(uid=i, prompt=p, max_new_tokens=self.GEN_LEN, arrival=2 * i)
                 for i, p in enumerate(prompts)]
        sc = ServeConfig(max_slots=4, max_len=1024, layout="paged", seed=self.seed)

        def want(st):
            fresh = len(trace) - st.prefix_hits
            if st.prefill_tokens != stem_len * fresh:
                raise AssertionError(f"paged-lpsa: {st.prefill_tokens} prefill tokens, "
                                     f"want the stem once per fresh admission")
            return _packed_counts(n_l, st.decode_steps + st.warmup_steps,
                                  [stem_len // cfg.lpsa.chunk] * fresh)

        _, eng, res = self._serve_path("paged-lpsa", lambda: model, trace, sc, want)
        st = eng.stats
        dense, dense_st = self._dense_tokens(model, trace, 1024, True)
        log(f"[serve] paged-lpsa: prefix_hits {st.prefix_hits} (want >= 3), "
            f"prompt_tokens_reused {st.prompt_tokens_reused}, prefill_tokens "
            f"{st.prefill_tokens} against the dense engine's {dense_st.prefill_tokens} "
            f"(fell by {dense_st.prefill_tokens - st.prefill_tokens}: the reused stem "
            f"packs), pool {eng.pool_stats()}")
        if st.prefix_hits < 3 or dense_st.prefill_tokens - st.prefill_tokens \
                != st.prompt_tokens_reused:
            raise AssertionError("paged-lpsa: the stem was not reused as the trace asks")
        self._same_tokens("paged-lpsa", res, dense, range(len(trace)))
        self._batch_invariance("paged-lpsa", eng, trace, res, (0, 3))

    def _paged_full(self, cfg, model):
        """Path "paged-full": the packed model with full caches
        (serve_sparse=False) under layout="paged", max_len 1024 and pages of
        16, so every layer is a page arena (64 pages a sequence).  Prompts
        share a 300-token stem: the first (360 tokens) prefills and registers
        its whole prompt; a sibling (340) and another (390) take the stem's
        18 whole pages from it as donor and feed the rest through decode; a
        duplicate of the first (360) and an extension of it (410) take its
        entry, whose last page is partial, and copy that page on their first
        write.  Tokens: equal, for every request, to a dense full-cache run
        of the same schedule (the shared head prefilled at batch 1, the rest
        decoded), and to the dense engine's where that schedule is the dense
        engine's own (the first and its duplicate)."""
        from repro_torch.serve import Request, ServeConfig
        torch, n_l, ps = self.torch, cfg.n_layers, 16
        rng = torch.Generator().manual_seed(self.seed + 8)
        tail = lambda n: torch.randint(0, cfg.vocab, (n,), generator=rng)  # noqa: E731
        stem = tail(300)
        first = torch.cat([stem, tail(60)])
        prompts = [first, torch.cat([stem, tail(40)]), first.clone(),
                   torch.cat([first, tail(50)]), torch.cat([stem, tail(90)])]
        absorbed = [360, 288, 360, 360, 288]          # the schedule the trie gives
        trace = [Request(uid=i, prompt=p.numpy(), max_new_tokens=self.GEN_LEN,
                         arrival=2 * i) for i, p in enumerate(prompts)]
        sc = ServeConfig(max_slots=4, max_len=1024, layout="paged", page_size=ps,
                         seed=self.seed)
        zero = {name: 0 for name in KERNEL_INFO}

        # a decode step and a whole-prompt prefill both launch 4/6/1/1 a layer
        def want(st):
            runs = st.decode_steps + st.warmup_steps + len(trace) - st.prefix_hits
            return {**zero, "das_topk": 4 * n_l * runs, "das_ternary_gemm": 6 * n_l * runs,
                    "ternary_gemm": n_l * runs, "sparse_attention": n_l * runs}

        _, eng, res = self._serve_path("paged-full", lambda: model, trace, sc, want,
                                       serve_sparse=False)
        st, pool = eng.stats, eng.pool_stats()
        log(f"[serve] paged-full: prefix_hits {st.prefix_hits}, prompt_tokens_reused "
            f"{st.prompt_tokens_reused}, cow_copies {st.cow_copies} (want >= 1), "
            f"prefill_tokens {st.prefill_tokens}, pool {pool}")
        if (st.prefix_hits, st.prompt_tokens_reused, st.prefill_tokens) != (
                4, sum(absorbed[1:]), 360) or st.cow_copies < 1:
            raise AssertionError("paged-full: the trie did not give the trace's schedule")
        # a page over every layer: K and V rows in the model's dtype, int32
        # positions
        es = getattr(torch, cfg.dtype).itemsize
        if pool["page_bytes"] != n_l * ps * (2 * cfg.n_kv_heads * cfg.head_dim_ * es + 4):
            raise AssertionError(f"paged-full: {pool['page_bytes']} bytes a page")
        want_tokens = {i: self._scheduled_tokens(model, r.prompt, absorbed[i], 1024)
                       for i, r in enumerate(trace)}
        self._same_tokens("paged-full (dense full cache, same schedule)", res, want_tokens,
                          range(len(trace)))
        dense, _ = self._dense_tokens(model, trace, 1024, False)
        self._same_tokens("paged-full (dense engine)", res, dense,
                          [i for i, r in enumerate(trace) if absorbed[i] == r.prompt_len])
        other = [i for i, r in enumerate(trace) if absorbed[i] < r.prompt_len]
        log(f"[serve] paged-full requests {other} (a tail decoded where the dense engine "
            f"prefills it): tokens equal to the dense engine's: "
            f"{[res[i].tokens.tolist() == dense[i].tolist() for i in other]} "
            f"(a diagnostic: the decode and prefill kernels sum in other orders)")
        self._batch_invariance("paged-full", eng, trace, res, (1, 3))

    # the http path's requests: (index into the packed trace, temperature,
    # streamed, slo_steps): two greedy unary, three sampled SSE streams
    HTTP_REQUESTS = ((0, 0.0, False, None), (3, 0.0, False, None), (1, 0.8, True, 400),
                     (2, 0.8, True, None), (4, 0.8, True, None))

    def _serve_http(self, model, trace, sc, packed_res, packed_steps, packs):
        """Path "http": the packed model behind ``ServeHTTPServer`` (port 0,
        this process; the engine on its own thread), top-k 40, the deadline
        scheduler, the packed trace's five prompts sent at once: two greedy
        unary requests, three sampled at temperature 0.8 as SSE streams, one
        with an SLO.  Launch counts at 0 just before, read just after; then
        checks (a)-(i) (see the module docstring) and the greedy and sampling
        graphs' ms/step at 4 slots."""
        import asyncio

        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.serve import Request, ServeEngine
        from repro_torch.serve import sampler as S
        from repro_torch.serve.server import ServeHTTPServer
        cfg, n = model.cfg, self.GEN_LEN

        # (e) the sampler's integer part on the card against its CPU run
        uids = torch.tensor([u for u in (0, 1, 7, 2 ** 31 - 1) for _ in range(3)])
        ctrs = torch.tensor([c for _ in range(4) for c in (0, 1, 31)])
        k_cpu = S.fold_keys(S.prng_key(self.seed), uids, ctrs)
        k_gpu = S.fold_keys(S.prng_key(self.seed, self.dev), uids.to(self.dev),
                            ctrs.to(self.dev))
        w = cfg.vocab_padded
        same = [torch.equal(a.cpu(), b) for a, b in (
            (k_gpu, k_cpu), (S.random_bits(k_gpu, w), S.random_bits(k_cpu, w)),
            (S.uniform(k_gpu, w), S.uniform(k_cpu, w)))]
        g_cpu = S.gumbel(k_cpu, w)
        g_err = ((S.gumbel(k_gpu, w).cpu() - g_cpu).abs() / g_cpu.abs().clamp_min(1)).max()
        log(f"[serve] http (e): sampler keys / bits / uniforms over 12 (uid, counter) x {w} "
            f"lanes, card vs CPU: bitwise {same}; gumbel within "
            f"{g_err / torch.finfo(torch.float32).eps:.2f} ulps of max(|g|, 1)")
        if not all(same):
            raise AssertionError("http: the sampler's keys, bits or uniforms differ card vs CPU")

        sc_h = sc.with_updates(top_k=40, scheduler="deadline")
        torch.cuda.synchronize()
        ops.reset_launches()                   # the path starts here
        eng = ServeEngine(model, sc_h, device="cuda")
        srv = ServeHTTPServer(eng, port=0, max_queue_depth=16)
        bodies = [{"prompt": [int(x) for x in trace[i].prompt], "max_tokens": n,
                   "temperature": temp, "stream": stream,
                   **({} if slo is None else {"slo_steps": slo})}
                  for i, temp, stream, slo in self.HTTP_REQUESTS]

        async def post(body):
            t_send = time.perf_counter()
            reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
            payload = json.dumps(body).encode()
            writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                         f"Content-Type: application/json\r\nContent-Length: "
                         f"{len(payload)}\r\n\r\n".encode() + payload)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            status, first = int(head.split(b" ")[1]), None
            if body["stream"] and status == 200:
                events = []
                while not events or events[-1] != "[DONE]":
                    chunk = (await reader.readuntil(b"\n\n")).decode().strip()
                    first = first if first is not None else time.perf_counter() - t_send
                    events.append(chunk[len("data: "):])
                out = events
            else:
                out = (await reader.read()).decode()
            writer.close()
            return status, out, first, time.perf_counter() - t_send

        async def get(path):
            reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
            writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
            raw = await reader.read()
            writer.close()
            return json.loads(raw.partition(b"\r\n\r\n")[2])

        async def scenario():
            await srv.start()
            t_0 = time.perf_counter()
            answers = await asyncio.gather(*(post(b) for b in bodies))
            wall = time.perf_counter() - t_0
            snap = await get("/metrics")
            t_stop = time.perf_counter()
            await srv.stop()
            return answers, wall, snap, time.perf_counter() - t_stop

        answers, wall, snap, stop_s = asyncio.run(scenario())
        torch.cuda.synchronize()
        counts = dict(ops.launches)            # ... and ends here
        st = eng.stats
        want = _packed_counts(cfg.n_layers, st.decode_steps + st.warmup_steps, packs)
        log(f"[serve] http: {len(answers)} requests, {st.decode_steps} decode steps "
            f"({st.graph_replays} replays of the decode graph, {st.sampling_steps} of them "
            f"with the sampler graph after it), {st.generated_tokens} tokens; launches on "
            f"the path: {counts} (expected {want})")
        if counts != want or st.graph_replays != st.decode_steps or not st.sampling_steps:
            raise AssertionError("http: launch counts or replays differ from the path's "
                                 "structure")
        for name, k in counts.items():
            self.launches[name] += k
        # (a) every request 200; (b) one SSE chunk a token, then [DONE]
        got = {}
        for (i, temp, stream, slo), (status, out, first, secs) in zip(self.HTTP_REQUESTS,
                                                                      answers):
            if status != 200:
                raise AssertionError(f"http (a): request {i} answered {status}: {out}")
            if stream:
                chunks = [json.loads(e) for e in out[:-1]]
                toks = [c["choices"][0]["token_ids"] for c in chunks[:-1]]
                if out[-1] != "[DONE]" or len(toks) != n or any(len(t) != 1 for t in toks) \
                        or chunks[-1]["choices"][0]["finish_reason"] != "stop":
                    raise AssertionError(f"http (b): request {i}'s stream is not one chunk "
                                         f"a token, a finish chunk and [DONE]")
                uid, toks = int(chunks[0]["id"].split("-")[1]), [t[0] for t in toks]
                log(f"[serve] http req {i} (prompt {trace[i].prompt_len}, T {temp}, slo "
                    f"{slo}, SSE): uid {uid}, first chunk {1e3 * first:.1f} ms, done "
                    f"{secs:.3f} s, slo_met {chunks[-1]['usage']['slo_met']}, ids {toks[:8]}...")
            else:
                res = json.loads(out)
                uid, toks = int(res["id"].split("-")[1]), res["choices"][0]["token_ids"]
                log(f"[serve] http req {i} (prompt {trace[i].prompt_len}, greedy, unary): uid "
                    f"{uid}, done {secs:.3f} s, ids {toks[:8]}...")
            got[i] = (uid, temp, slo, toks)
        log(f"[serve] http (a), (b): all 200, every stream one chunk a token then [DONE]; "
            f"{_nvidia_smi()}: end to end {st.generated_tokens / wall:.1f} tok/s through HTTP "
            f"({wall:.3f} s "
            f"for {st.generated_tokens} tokens); time to first SSE chunk "
            f"{[round(1e3 * a[2], 1) for a in answers if a[2] is not None]} ms")
        # (c) greedy tokens: the packed path's
        for i, (_, temp, _, toks) in got.items():
            if temp == 0 and toks != packed_res[i].tokens.tolist():
                raise AssertionError(f"http (c): greedy request {i} differs from the packed path")
        log("[serve] http (c): greedy tokens equal the packed path's")
        # (g) /metrics against EngineStats; (h) the engine thread joined
        tot, eng_m = snap["totals"], snap["engine"]
        if (tot["tokens_out"], tot["requests_finished"], eng_m["decode_steps"],
                eng_m["preemptions"]) != (st.generated_tokens, 5, st.decode_steps,
                                          st.preemptions):
            raise AssertionError(f"http (g): /metrics {tot} {eng_m} disagrees with {st}")
        if srv._thread.is_alive() or stop_s > 10:
            raise AssertionError(f"http (h): the engine thread did not join ({stop_s:.1f} s)")
        log(f"[serve] http (g): /metrics tokens {tot['tokens_out']}, decode steps "
            f"{eng_m['decode_steps']} equal EngineStats; (h) engine thread joined "
            f"{stop_s:.3f} s after stop()")
        del eng, srv
        # (d) a fresh engine's run() of the same requests and uids; (f) eager
        reqs = [Request(uid=uid, prompt=trace[i].prompt, max_new_tokens=n, temperature=temp,
                        slo_steps=slo) for i, (uid, temp, slo, _) in got.items()]
        runs = {}
        for label, kw in (("graph", {}), ("eager", {"cuda_graph": False})):
            fresh = ServeEngine(model, sc_h, device="cuda", **kw)
            for r in reqs:
                fresh.submit(r)
            runs[label] = {u: r.tokens.tolist() for u, r in fresh.run().items()}
            if label == "graph":
                timing_eng = fresh
        want_toks = {uid: toks for uid, _, _, toks in got.values()}
        log(f"[serve] http (d): a fresh engine's run() of the same uids gives the HTTP "
            f"tokens: {runs['graph'] == want_toks}; (f) the eager engine "
            f"(cuda_graph=False) the replayed graphs' sampled tokens: "
            f"{runs['eager'] == runs['graph']}")
        if runs["graph"] != want_toks or runs["eager"] != runs["graph"]:
            raise AssertionError("http (d) or (f): sampled tokens differ")
        # (i) the wave policy on the packed trace
        wave = ServeEngine(model, sc.with_updates(policy="wave"), device="cuda")
        for r in trace:
            wave.submit(r)
        wres = wave.run()
        same = all(wres[r.uid].tokens.tolist() == packed_res[r.uid].tokens.tolist()
                   for r in trace)
        log(f"[serve] http (i): policy=wave on the packed trace: the continuous tokens "
            f"{same}, in {wave.stats.decode_steps} decode steps against "
            f"{packed_steps} continuous")
        if not same or wave.stats.decode_steps <= packed_steps:
            raise AssertionError("http (i): the wave replay differs or takes no more steps")
        del wave
        self._sampling_ms(timing_eng, trace)

    def _sampling_ms(self, eng, trace):
        """ms/step of a 4-slot decode-only trace (40-token prompts admitted
        first, CUDA events around the run) greedy and with every row
        sampled; then the device time of the decode graph's replay alone and
        followed by the sampler graph's (CUDA events over 50 replays), and
        the sampler graph's device kernels a replay."""
        torch = self.torch
        from repro_torch.serve import Request
        ms = {}
        for label, temp in (("greedy", 0.0), ("sampling", 0.8), ("greedy ", 0.0),
                            ("sampling ", 0.8)):
            for r in trace[:4]:
                eng.submit(Request(uid=200 + r.uid, prompt=r.prompt[:40], max_new_tokens=24,
                                   temperature=temp))
            eng._admit_ready()
            steps0 = eng.stats.decode_steps
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            eng.run()
            ev1.record()
            torch.cuda.synchronize()
            ms.setdefault(label.strip(), []).append(
                ev0.elapsed_time(ev1) / (eng.stats.decode_steps - steps0))
        replay = {}
        for label, graphs in (("decode graph", (eng._graph,)),
                              ("decode + sampler graphs", (eng._graph, eng._sample_graph)),
                              ("sampler graph", (eng._sample_graph,))):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(50):
                for g in graphs:
                    g.replay()
            ev1.record()
            torch.cuda.synchronize()
            replay[label] = ev0.elapsed_time(ev1) / 50
        share = replay["sampler graph"] / replay["decode graph"]
        # the sampler graph's device kernels a replay, counted under the profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                eng._sample_graph.replay()
            torch.cuda.synchronize()
        n_kernels = len(_Trace(prof).kernels) / 4
        log(f"[serve] http sampler graph: {n_kernels:g} device kernels a replay "
            f"(torch.profiler over 4 replays)")
        log(f"[serve] http sampling cost ({_nvidia_smi()}): decode-only 4-slot trace, "
            f"ms/step by CUDA events in turns: greedy {[round(x, 3) for x in ms['greedy']]}, "
            f"every row sampled (T 0.8, top-k 40) {[round(x, 3) for x in ms['sampling']]}; "
            f"graph replays, device ms each: " + ", ".join(
                f"{k} {v:.4f}" for k, v in replay.items())
            + f"; the sampler {100 * share:.1f} % of a decode replay")

    def _dense_tokens(self, model, trace, max_len, serve_sparse):
        """The dense (per-slot cache) engine's tokens on ``trace`` and its
        stats."""
        from repro_torch.serve import ServeConfig, ServeEngine
        eng = ServeEngine(model, ServeConfig(max_slots=4, max_len=max_len, seed=self.seed),
                          device=self.dev, serve_sparse=serve_sparse)
        for r in trace:
            eng.submit(r)
        return {uid: r.tokens for uid, r in eng.run().items()}, eng.stats

    def _scheduled_tokens(self, model, prompt, absorbed, max_len):
        """One request's greedy tokens on a paged engine's schedule, without
        the engine: its first ``absorbed`` prompt tokens prefilled at batch 1
        into full caches, the rest fed one a step, then greedy decode."""
        torch = self.torch
        from repro_torch.models import model as MD
        ids = lambda x: torch.tensor([int(x)], device=self.dev)  # noqa: E731
        tok = torch.as_tensor(prompt[:absorbed], dtype=torch.long, device=self.dev)[None]
        logits, caches = MD.prefill(model, tok, max_len=max_len, serve_sparse=False)
        for pos in range(absorbed, len(prompt)):
            logits, _ = MD.decode_step(model, caches, ids(prompt[pos]), ids(pos),
                                       serve_sparse=False)
        out = [int(logits.argmax(-1)[0])]
        while len(out) < self.GEN_LEN:
            logits, _ = MD.decode_step(model, caches, ids(out[-1]),
                                       ids(len(prompt) + len(out) - 1), serve_sparse=False)
            out.append(int(logits.argmax(-1)[0]))
        return out

    @staticmethod
    def _same_tokens(label, res, want, uids):
        """Each request's tokens equal ``want[uid]``, bit for bit."""
        for uid in uids:
            if res[uid].tokens.tolist() != list(want[uid]):
                raise AssertionError(f"{label}: request {uid}'s tokens differ")
        log(f"[serve] {label}: tokens of requests {list(uids)} equal")

    def _serve_path(self, label, load, trace, sc, want_fn, serve_sparse=True):
        """Load a model, build its engine (which captures its decode step)
        and serve ``trace`` with the launch counts set to 0 just before and
        read just after; check the counts against ``want_fn(engine stats)``,
        that every decode step was a graph replay, and every request's token
        count.  Returns (model, engine, results)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.serve import ServeEngine
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                   # the path starts here
        model = load()
        eng = ServeEngine(model, sc, device="cuda", serve_sparse=serve_sparse)
        for r in trace:
            eng.submit(r)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        results = eng.run()
        ev1.record()
        torch.cuda.synchronize()
        counts = dict(ops.launches)            # ... and ends here
        st = eng.stats
        run_ms = ev0.elapsed_time(ev1)
        log(f"[serve] {label}: {len(results)} requests, {st.decode_steps} decode steps, "
            f"{st.generated_tokens} tokens, {st.prefill_tokens} prefill tokens; run "
            f"{run_ms:.1f} ms (CUDA events), decode {1e3 * st.decode_seconds / st.decode_steps:.3f}"
            f" ms/step (host clock, each step ends in a device sync), "
            f"{st.generated_tokens / (run_ms / 1e3):.1f} tok/s end to end, "
            f"{st.active_slot_steps / st.decode_seconds:.1f} tok/s in decode steps; "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        for r in trace:
            got = results[r.uid].tokens
            if len(got) != r.max_new_tokens:
                raise AssertionError(f"{label} request {r.uid}: {len(got)} tokens, "
                                     f"want {r.max_new_tokens}")
            log(f"[serve] {label} req {r.uid}: prompt {r.prompt_len}, ttft "
                f"{results[r.uid].ttft_steps} steps, ids {got[:8].tolist()}...")
        log(f"[serve] {label}: {st.graph_replays} of {st.decode_steps} decode steps "
            f"replayed from the captured graph after {st.warmup_steps} warm-up step; "
            f"launches a replay {eng.launches_per_replay}")
        if st.graph_replays != st.decode_steps or st.warmup_steps != 1:
            raise AssertionError(f"{label}: decode did not run as graph replays")
        want = want_fn(st)
        log(f"[serve] {label} launches on the path: {counts} (expected {want})")
        if counts != want:
            raise AssertionError(f"{label}: launch counts differ from the path's structure")
        for name, n in counts.items():
            self.launches[name] += n
        return model, eng, results

    def _finite_logits(self, label, model, prompt, max_len):
        """Prefill ``prompt`` and decode one step: finite logits of the
        expected shape.  Returns the prefill logits."""
        torch = self.torch
        from repro_torch.models import model as MD
        cfg = model.cfg
        tok = self._inputs(prompt)
        logits, caches = MD.prefill(model, tok, max_len=max_len)
        kw = {}
        if MD.uses_embeds(cfg):     # the engine's decode input: a token in float32
            kw = dict(forced=torch.zeros(1, dtype=torch.bool, device=self.dev),
                      forced_x=torch.zeros((1, cfg.d_model), device=self.dev))
        lg2, _ = MD.decode_step(model, caches, logits.argmax(-1),
                                torch.tensor([tok.shape[1]], device=self.dev), **kw)
        for name, lg in (("prefill", logits), ("decode", lg2)):
            if tuple(lg.shape) != (1, cfg.vocab_padded) or not bool(
                    torch.isfinite(lg[:, :cfg.vocab]).all()):
                raise AssertionError(f"{label} {name} logits: shape {tuple(lg.shape)} "
                                     f"or not finite")
        log(f"[serve] {label} logits finite, shape {tuple(lg2.shape)}")
        return logits

    def _batch_invariance(self, label, eng, trace, batched, uids):
        """Re-served alone, a request gives the same tokens, bit for bit."""
        from repro_torch.serve import Request
        for uid in uids:
            r = trace[uid]
            eng.submit(Request(uid=100 + uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
            alone = eng.run()[100 + uid].tokens
            same = alone.tolist() == batched[uid].tokens.tolist()
            log(f"[serve] {label} req {uid} re-served alone: bitwise "
                f"{'identical' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"{label} request {uid} is not batch invariant")

    def _reduced_parity(self, label, cfg, prompt_ids):
        """A reduced model of ``cfg`` on the card (kernels) against the same
        weights on the CPU (plain versions): prefill + 8 teacher-forced
        decode steps within 2e-4, equal greedy tokens."""
        torch = self.torch
        from repro_torch.configs import reduced
        from repro_torch.models import model as MD
        small = reduced(cfg)
        params = MD.init_params(small, seed=self.seed, device="cpu")
        m_cpu = MD.export_serving(params, small)
        m_gpu = copy.deepcopy(m_cpu).to(self.dev)
        prompt = torch.as_tensor(prompt_ids[:48] % small.vocab, dtype=torch.long)[None]
        lg_c, c_c = MD.prefill(m_cpu, prompt, max_len=64)
        lg_g, c_g = MD.prefill(m_gpu, prompt.to(self.dev), max_len=64)
        err = (lg_g.cpu() - lg_c).abs().max().item()
        toks_c, toks_g = [int(lg_c.argmax())], [int(lg_g.argmax())]
        for i in range(8):
            t = torch.tensor([48 + i])
            lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([toks_c[-1]]), t)
            lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([toks_c[-1]], device=self.dev),
                                     t.to(self.dev))
            err = max(err, (lg_g.cpu() - lg_c).abs().max().item())
            toks_c.append(int(lg_c.argmax()))
            toks_g.append(int(lg_g.argmax()))
        log(f"[serve] {label} reduced {small.name} f32, card vs CPU: prefill + 8 "
            f"teacher-forced steps, max logit err {err:.2e} (tol 2e-4), greedy tokens "
            f"{'equal' if toks_c == toks_g else 'DIFFERENT'}")
        if err > 2e-4 or toks_c != toks_g:
            raise AssertionError(f"{label}: the card's reduced model disagrees with the CPU's")

    def _profile_decode(self, label, model, sc, prompts, graph=True, profiled=True,
                        classes="glue"):
        """A decode-only trace (40-token prompts admitted before the timed
        run, then fed through the decode step; without LPSA admission
        prefills them whole, so the run is their decode steps alone):
        CUDA-event ms/step without the profiler, with that run's tokens and
        kernel launches a step, then the device busy time per step, the idle
        share and the host launches per step under torch.profiler (None:
        not measured; ``profiled=False`` skips that run).  ``graph=False``
        steps eagerly (a tree without the captured step always does);
        ``classes`` names the device-time classes (CLASSES: the glue
        classes, the MoE's or the SSM's)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import ops
        from repro_torch.serve import Request, ServeEngine
        eng = ServeEngine(model, sc, device="cuda", **({} if graph else {"cuda_graph": False}))

        def submit():
            for i in range(4):
                eng.submit(Request(uid=i, prompt=prompts[i][:40], max_new_tokens=24))

        submit()
        eng.run()                                   # warm the allocator
        submit()
        eng._admit_ready()       # admissions outside the timed run: a model
        steps0 = eng.stats.decode_steps    # without LPSA prefills each prompt
        ops.reset_launches()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        res = eng.run()                             # no prefill: decode steps only
        ev1.record()
        torch.cuda.synchronize()
        n_steps = eng.stats.decode_steps - steps0
        ms_step = ev0.elapsed_time(ev1) / n_steps
        tokens = {uid: r.tokens.tolist() for uid, r in res.items()}
        per_step = {k: n / n_steps for k, n in ops.launches.items()}
        log(f"[profile] {label} decode-only trace without the profiler: {ms_step:.3f} "
            f"ms/step (CUDA events around the run), 4 active slots")
        if not profiled:
            return {"ms_step": ms_step, "busy_ms_step": None, "idle": None, "launches": None,
                    "tokens": tokens, "per_step": per_step}
        submit()
        eng._admit_ready()
        steps1 = eng.stats.decode_steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = eng.stats.decode_steps - steps1        # the profiled run's steps
        trace = _Trace(prof)
        by_name = trace.device_times()
        busy_us = sum(by_name.values())
        host = trace.host_self()
        calls = {name: host[name][1] / steps for name in
                 ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch") if name in host}
        n_launch = sum(calls.values())
        if not busy_us:
            log(f"[profile] {label}: the profiler recorded no device time: not measured")
            return {"ms_step": ms_step, "busy_ms_step": None, "idle": None,
                    "launches": n_launch, "tokens": tokens, "per_step": per_step}
        busy_ms = busy_us / 1e3 / steps
        log(f"[profile] {label} decode-only trace, {steps} steps under torch.profiler: wall "
            f"{1e3 * wall / steps:.3f} ms/step, device busy {busy_ms:.3f} ms/step, idle "
            f"share {1 - busy_us / 1e6 / wall:.3f} (against the unprofiled "
            f"{ms_step:.3f} ms/step: {1 - busy_ms / ms_step:.3f})")
        for name, dt in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            log(f"[profile]   {dt / 1e3 / steps:8.4f} ms/step  {name[:90]}")
        log(f"[profile] {label} device ms/step by {classes} class: " + ", ".join(
            f"{cat} {us / 1e3 / steps:.4f}" for cat, us in _by_class(by_name, classes).items()))
        host = sorted(((dt, count, name) for name, (dt, count) in host.items()),
                      reverse=True)[:12]
        log("[profile] host: self CPU time per step, calls per step")
        for dt, count, name in host:
            log(f"[profile]   {dt / 1e3 / steps:8.4f} ms/step {count / steps:7.1f}  {name[:80]}")
        log(f"[profile] {label} host launches per step: " + ", ".join(
            f"{name} {n:.1f}" for name, n in sorted(calls.items())))
        return {"ms_step": ms_step, "busy_ms_step": busy_ms,
                "idle": 1 - busy_ms / ms_step, "launches": n_launch, "tokens": tokens,
                "per_step": per_step}

    def _profile_load(self, model, cfg8):
        """The device time of loading the packed model into the int8-resident
        form: twd_decode's launches (7 a layer) under torch.profiler."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import model as MD
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loaded = MD.trits_from_packed(model, cfg8)
            torch.cuda.synchronize()
        del loaded
        trace = _Trace(prof)
        us = sum(dt for name, dt in trace.device_times().items() if "twd_decode" in name)
        if not us:
            log("[profile] int8w model load: the profiler recorded no twd_decode: not measured")
            return
        n = sum(1 for name, _, _ in trace.kernels if "twd_decode_kernel" in name)
        log(f"[profile] int8w model load: {n} twd_decode launches, {us / 1e3:.3f} ms of "
            f"device time")

    def _profile_admission(self, model, prompt, max_len, classes="glue"):
        """The device time of admitting ``prompt``: the streaming prefill of
        its whole packs (4 for 1100 tokens), CUDA events around one
        prefill, then its kernels under torch.profiler, with
        sparse_attention's share (and for the MoE the time by its class)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import model as MD
        n = len(prompt) // model.cfg.lpsa.chunk * model.cfg.lpsa.chunk
        tok = self._inputs(prompt[:n])
        MD.prefill(model, tok, max_len=max_len)         # warm the allocator
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        MD.prefill(model, tok, max_len=max_len)
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            MD.prefill(model, tok, max_len=max_len)
            torch.cuda.synchronize()
        by_name = _Trace(prof).device_times()
        busy_us = sum(by_name.values())
        if not busy_us:
            log("[profile] admission: the profiler recorded no device time: not measured")
            return
        attn_us = sum(dt for name, dt in by_name.items() if _is_attention(name))
        topk_us = sum(dt for name, dt in by_name.items() if "das_topk" in name)
        log(f"[profile] admission of a {len(prompt)}-token prompt ({n // model.cfg.lpsa.chunk} "
            f"packs of {model.cfg.lpsa.chunk}): {ms:.3f} ms (CUDA events), device busy "
            f"{busy_us / 1e3:.3f} ms under torch.profiler, sparse_attention "
            f"{attn_us / 1e3:.3f} ms of it (share {attn_us / busy_us:.3f}), das_topk "
            f"{topk_us / 1e3:.3f} ms")
        if classes != "glue":
            log(f"[profile] admission device ms by {classes} class: " + ", ".join(
                f"{cat} {us / 1e3:.4f}" for cat, us in _by_class(by_name, classes).items()))
        for name, dt in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[profile]   {dt / 1e3:8.4f} ms  {name[:90]}")

    # -- train ---------------------------------------------------------------

    TRAIN_ARCH = "bitnet-1.3b"
    TRAIN_STEPS = 4          # the cosine schedule's total, the last step profiled
    TRAIN_WARMUP, TRAIN_LR = 2, 3e-4
    TRAIN_CUT = 2            # the depth of checks (c) and (d)
    # the other block kinds, at full width: (arch, depth of the run, depth
    # of check (c)); qwen3-moe-30b-a3b at the depth one H100 holds (~0.61 B
    # parameters a layer), zamba2-2.7b over two positions of its shared
    # attention, its cut one pattern period; gla-1.3b and rwkv6-3b at 2
    # (4 before the dist phase: their host-bound steps scale with depth)
    TRAIN_PATHS = (("qwen3-moe-30b-a3b", 2, 2), ("zamba2-2.7b", 12, 6),
                   ("gla-1.3b", 2, 2), ("rwkv6-3b", 2, 2))
    TRAIN_PATH_STEPS = 3     # each new path's steps, the last profiled
    # the MoE's check (d) at 1 layer: at 2, its 18.5 GB checkpoint (params,
    # m, v) took 77 s to save and restore on the H100's host
    TRAIN_RESUME_MOE = 1

    def phase_train(self):
        """QAT training of bitnet-1.3b at full width (bf16 masters, remat):
        checks (c) and (d) on a 2-layer cut, then all 24 layers for
        TRAIN_STEPS steps of 4 x 2048 tokens (checks (a) and (b), ms/step,
        tok/s, peak memory, device busy by class of the last step under the
        profiler), das_topk's training calls timed alone, and check (e): the
        trained model exported and served; then each of TRAIN_PATHS
        (``_train_path``)."""
        torch = self.torch
        from repro_torch.configs import get_config
        cfg = get_config(self.TRAIN_ARCH)
        cut = dataclasses.replace(cfg, n_layers=self.TRAIN_CUT)
        smi = _nvidia_smi()
        log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab}, {cfg.dtype} masters, remat {cfg.remat}, DAS "
            f"{cfg.ternary.das.keep}/{cfg.ternary.das.block}, LPSA {cfg.lpsa.sink} + "
            f"{cfg.lpsa.window}; batches of {TRAIN_BATCH} x {TRAIN_SEQ} tokens; {smi}")
        t0 = time.perf_counter()
        self._train_parity(cut)
        t0 = _took("cut: kernel vs plain", t0, "train")
        self._train_resume(cut)
        t0 = _took("cut: checkpoint and resume", t0, "train")
        params = self._train_run(cfg, smi, self.TRAIN_STEPS)
        t0 = _took("24 layers", t0, "train")
        self._train_topk_times(smi)
        self._train_serve(cfg, params)
        del params
        torch.cuda.empty_cache()
        _took("the trained model served", t0, "train")
        for arch, depth, cut in self.TRAIN_PATHS:
            self._train_path(arch, depth, cut, smi)

    def _train_batches(self, cfg, steps, seed=None):
        from repro_torch.data.pipeline import SyntheticLM
        data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                           seed=self.seed if seed is None else seed)
        return [{k: self.torch.as_tensor(v, device=self.dev) for k, v in
                 data.batch_at(s).items()} for s in range(steps)]

    def _train_step_fn(self, cfg, total):
        from repro_torch.launch import train as TR
        return TR.make_train_step(cfg, TR.make_runtime(),
                                  peak_lr=self.TRAIN_LR, warmup=self.TRAIN_WARMUP, total=total)

    def _train_parity(self, cut):
        """Check (c): one step with the DAS masks from the das_topk kernel
        and with the plain das_mask on the card: every mask equal, the loss,
        each gradient leaf and each updated param (AdamW at the peak rate)
        within 2e-2 of the leaf's max (bitwise expected).  Launches made here
        do not count."""
        torch = self.torch
        from repro_torch.core import das as das_lib
        from repro_torch.models import model as MD
        from repro_torch.models import ternary_linear as TL
        from repro_torch.optim import adamw
        from repro_torch.tree import leaves, leaves_with_paths, unflatten
        params = MD.init_params(cut, seed=self.seed + 5, device=self.dev)
        batch = self._train_batches(cut, 1)[0]
        masks = {"kernel": [], "plain": []}
        orig = TL.das_train_mask
        fns = {"kernel": orig,
               "plain": lambda x, tc: das_lib.das_mask(x.detach(), block_size=tc.das.block,
                                                       keep=tc.das.keep)}
        runs = {}
        try:
            for mode, fn in fns.items():
                def recorded(x, tc, fn=fn, mode=mode):
                    m = fn(x, tc)
                    masks[mode].append(m.to(torch.int8))
                    return m
                TL.das_train_mask = recorded
                flat = [p.detach().requires_grad_() for p in leaves(params)]
                loss, _ = MD.loss_fn(unflatten(params, flat), cut, batch, MD.Runtime())
                grads = torch.autograd.grad(loss, flat)
                new, _, _ = adamw.adamw_step(params, unflatten(params, list(grads)),
                                             adamw.adamw_init(params), lr=self.TRAIN_LR)
                runs[mode] = (loss.detach(), grads, leaves(new))
                del flat, loss
        finally:
            TL.das_train_mask = orig
        mk, mp = masks["kernel"], masks["plain"]
        if len(mk) != len(mp) or not mk:
            raise AssertionError(f"train parity: {len(mk)} kernel masks, {len(mp)} plain")
        for i, (a, b) in enumerate(zip(mk, mp)):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"train parity: DAS mask {i} {tuple(a.shape)} differs "
                                     f"(kernel vs plain)")
        (lk, gk, nk), (lp, gp, np_) = runs["kernel"], runs["plain"]
        worst, bitwise = 0.0, bool(torch.equal(lk, lp))
        paths = [path for path, _ in leaves_with_paths(params)]
        for path, a, b in zip(paths + [f"{q} (updated)" for q in paths], gk + tuple(nk),
                              gp + tuple(np_)):
            scale = float(b.float().abs().max()) or 1.0
            err = float((a.float() - b.float()).abs().max()) / scale
            worst = max(worst, err)
            bitwise = bitwise and bool(torch.equal(a, b))
            if not (torch.isfinite(a).all() and err <= TOL_BF16):
                raise AssertionError(f"train parity: {path} off by {err:.3e} of its max")
        if abs(float(lk) - float(lp)) > TOL_BF16 * abs(float(lp)):
            raise AssertionError(f"train parity: loss {float(lk)} vs {float(lp)}")
        log(f"[train] (c) {cut.name} {cut.n_layers}-layer cut, one step, kernel vs plain DAS "
            f"masks on the card: {len(mk)} masks "
            f"({', '.join(sorted({str(tuple(m.shape)) for m in mk}))}, the forward and remat's "
            f"recompute) equal exactly; loss {float(lk):.6f} vs {float(lp):.6f}; gradients and "
            f"updated params worst {worst:.3e} of a leaf's max (tol {TOL_BF16}); loss, every "
            f"gradient and every updated param {'bitwise equal' if bitwise else 'NOT bitwise equal'}")
        del runs, params
        torch.cuda.empty_cache()

    def _train_resume(self, cut):
        """Check (d): 2 steps and a checkpoint; the run goes on 2 more steps
        (the straight run); the checkpoint restored, 2 more steps give its
        params and moments bitwise."""
        torch = self.torch
        import shutil
        from repro_torch import checkpoint as ckpt
        from repro_torch.models import model as MD
        from repro_torch.optim import adamw
        from repro_torch.tree import leaves
        step_fn = self._train_step_fn(cut, 4)
        batches = self._train_batches(cut, 4, seed=self.seed + 7)
        d = ROOT / "build" / "train_ckpt"
        shutil.rmtree(d, ignore_errors=True)
        p = MD.init_params(cut, seed=self.seed + 6, device=self.dev)
        o = adamw.adamw_init(p)
        for s in range(2):
            p, o, _ = step_fn(p, o, batches[s])
        t0 = time.perf_counter()
        ckpt.save_checkpoint(str(d), 2, {"params": p, "opt": o})
        t_save = time.perf_counter() - t0
        for s in range(2, 4):
            p, o, _ = step_fn(p, o, batches[s])
        straight = leaves({"params": p, "opt": o})
        del p, o
        t0 = time.perf_counter()
        tree, step = ckpt.restore_checkpoint(str(d), device=self.dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        shutil.rmtree(d, ignore_errors=True)
        n_bytes = sum(x.numel() * x.element_size() for x in leaves(tree))
        p, o = tree["params"], tree["opt"]
        del tree
        for s in range(step, 4):
            p, o, _ = step_fn(p, o, batches[s])
        a, b = straight, leaves({"params": p, "opt": o})
        same = len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
        n_leaves = len(a)
        del p, o, a, b, straight
        torch.cuda.empty_cache()
        log(f"[train] (d) {cut.name} {cut.n_layers}-layer cut: 2 steps, checkpoint at step "
            f"{step} ({n_bytes / 1e9:.2f} GB) saved in {t_save:.1f} s and restored in "
            f"{t_load:.1f} s, 2 more steps vs the run that went on (4 straight): {n_leaves} "
            f"leaves (params, m, v, step) {'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("train resume: the restored run differs from the straight run")

    def _train_run(self, cfg, smi, steps):
        """Checks (a) and (b) over ``steps`` steps of ``cfg``, the launch
        counts at 0 just before and read just after; ms/step (CUDA events,
        the first step and the profiled last step left out), tok/s, peak
        memory; the last step's device time by class; for a MoE, the copies
        each layer dropped at the training capacity in the first step."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.models import model as MD
        from repro_torch.models import moe as MOE
        from repro_torch.optim import adamw
        from repro_torch.tree import leaves
        t0 = time.perf_counter()
        params = MD.init_params(cfg, seed=self.seed, device=self.dev)
        opt = adamw.adamw_init(params)
        n_params = sum(p.numel() for p in leaves(params))
        step_fn = self._train_step_fn(cfg, steps)
        batches = self._train_batches(cfg, steps)
        torch.cuda.synchronize()
        log(f"[train] {cfg.name}: {n_params / 1e9:.3f} B params ({cfg.dtype}), AdamW moments "
            f"float32; init {time.perf_counter() - t0:.1f} s")
        routed = []                             # (counts, capacity) of each MoE call
        dispatch = MOE.dispatch_compute

        def counting(x_tok, x_in, weights, router, cfg_, capacity):
            out, counts = dispatch(x_tok, x_in, weights, router, cfg_, capacity)
            routed.append((counts, capacity))
            return out, counts

        MOE.dispatch_compute = counting
        torch.cuda.reset_peak_memory_stats()
        try:
            ops.reset_launches()                # the path starts here
            ms, metrics, prof = [], [], None
            for s in range(steps):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                last = s == steps - 1
                with (torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU,
                                    torch.profiler.ProfilerActivity.CUDA])
                      if last else contextlib.nullcontext()) as p:
                    ev0.record()
                    params, opt, m = step_fn(params, opt, batches[s])
                    ev1.record()
                    torch.cuda.synchronize()
                prof = p if last else prof
                ms.append(ev0.elapsed_time(ev1))
                metrics.append({k: float(v) for k, v in m.items()})
                log(f"[train] {cfg.name} step {s}: loss {metrics[-1]['loss']:.4f}, lr "
                    f"{metrics[-1]['lr']:.3e}, grad norm {metrics[-1]['grad_norm']:.4f}, "
                    f"{ms[-1]:.1f} ms{' (profiled)' if last else ''}")
            counts = dict(ops.launches)         # ... and ends here
        finally:
            MOE.dispatch_compute = dispatch
        peak = torch.cuda.max_memory_allocated()
        # (a) finite losses and gradient norms; the rate follows warmup + cosine
        for s, m in enumerate(metrics):
            want = self._cosine(s, steps)
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                raise AssertionError(f"train step {s}: loss or grad norm not finite: {m}")
            if abs(m["lr"] - want) > 1e-6 * self.TRAIN_LR:
                raise AssertionError(f"train step {s}: lr {m['lr']} off the schedule's {want}")
        # (b) das_topk once a DAS input a layer forward (_das_inputs), and
        # remat runs every layer's forward again in the backward
        per_step = sum(_das_inputs(cfg, kind) for kind in cfg.layer_kinds())
        per_step *= 2 if cfg.remat else 1
        want = {**{name: 0 for name in KERNEL_INFO}, "das_topk": steps * per_step}
        kinds = sorted(set(cfg.layer_kinds()))
        log(f"[train] {cfg.name} launches on the path: {counts} (expected {want}: das_topk "
            f"{', '.join(f'{_das_inputs(cfg, k)} a {k} layer' for k in kinds)} forward, x "
            f"{2 if cfg.remat else 1} (remat) = {per_step} a step x {steps} steps)")
        if counts != want or counts["das_topk"] <= 0:
            raise AssertionError("train: launch counts differ from the path's structure")
        for name, n in counts.items():
            self.launches[name] += n
        step_ms = statistics.median(ms[1:-1])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        log(f"[train] (a) {cfg.name} losses {[round(m['loss'], 4) for m in metrics]}, grad norms "
            f"{[round(m['grad_norm'], 4) for m in metrics]} finite; lr "
            f"{[round(m['lr'], 8) for m in metrics]} = warmup {self.TRAIN_WARMUP} + cosine "
            f"over {steps}")
        log(f"[train] {cfg.name} step time {step_ms:.1f} ms/step (CUDA events, median of steps "
            f"1-{steps - 2}; step 0 {ms[0]:.1f} ms), {tokens / (step_ms / 1e3):.0f} tok/s, peak "
            f"device memory {peak / 1e9:.2f} GB; {smi}")
        if routed:
            n_moe = sum(1 for k in cfg.layer_kinds() if k in ("attn", "local", "gla"))
            first = routed[:n_moe]              # step 0's forward, layer by layer
            drops = [int((c - cap).clamp(min=0).sum()) for c, cap in first]
            t = TRAIN_BATCH * TRAIN_SEQ
            log(f"[train] {cfg.name} training capacity {first[0][1]} a expert ({t} tokens x "
                f"top-{cfg.moe.top_k} over {cfg.moe.n_experts} experts, capacity factor "
                f"{cfg.moe.capacity_factor}); dropped copies a layer, step 0: {drops} of "
                f"{t * cfg.moe.top_k}")
        self._train_busy(prof, ms[-1], smi, cfg.name)
        return params

    def _train_path(self, arch, depth, cut_depth, smi):
        """One more block kind at full width: check (c) on a cut, (d) for a
        MoE (the dispatch's backward has no atomics, so a resumed run is
        bitwise), then (a), (b) and the costs over TRAIN_PATH_STEPS steps."""
        torch = self.torch
        from repro_torch.configs import get_config
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        cut = dataclasses.replace(cfg, n_layers=cut_depth)
        log(f"[train] {arch}: {depth} of {get_config(arch).n_layers} layers "
            f"({', '.join(f'{cfg.layer_kinds().count(k)} {k}' for k in sorted(set(cfg.layer_kinds())))}), "
            f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype} masters, remat {cfg.remat}, "
            f"DAS {cfg.ternary.das.keep}/{cfg.ternary.das.block}; batches of {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens; {smi}")
        t0 = time.perf_counter()
        self._train_parity(cut)
        t0 = _took(f"{arch} cut: kernel vs plain", t0, "train")
        if cfg.moe is not None:       # a 1-layer cut: its checkpoint is 12.4 GB
            self._train_resume(dataclasses.replace(cfg, n_layers=self.TRAIN_RESUME_MOE))
            t0 = _took(f"{arch} cut: checkpoint and resume", t0, "train")
        params = self._train_run(cfg, smi, self.TRAIN_PATH_STEPS)
        del params
        torch.cuda.empty_cache()
        _took(f"{arch} {depth} layers", t0, "train")

    def _cosine(self, s, total):
        """The warmup + cosine schedule in plain Python (float64)."""
        w, peak = self.TRAIN_WARMUP, self.TRAIN_LR
        if s < w:
            return peak * s / max(w, 1)
        prog = min(max((s - w) / max(total - w, 1), 0.0), 1.0)
        return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))

    def _train_busy(self, prof, step_ms, smi, label):
        """The profiled step's device time by class.  A kernel is placed by
        its name (cuBLAS, das_topk), else by the profiler ranges above the
        op that launched it (``TRAIN_RANGES``: the optimizer, the attention,
        the chunked scans of the linear attention and of the SSD, the MoE's
        dispatch); a backward op takes the ranges of the forward op it
        differentiates (the same sequence number and forward thread).
        Classes with no time are left out."""
        t0 = time.perf_counter()
        trace = _Trace(prof)
        classes = {c: 0.0 for c in TRAIN_CLASSES}
        unlinked: dict = {}           # device events no op launched (as events() leaves them)
        memo: dict = {}
        for name, us, op in trace.kernels:
            launcher = trace.ops.get(op)
            if launcher is None:
                unlinked[name] = unlinked.get(name, 0.0) + us / 1e3
                continue
            ctx = trace.context(launcher, TRAIN_RANGES, memo)
            if "das_topk" in name:
                cls = "das_topk"
            elif _is_gemm(name):
                cls = TRAIN_GEMM_CLASS.get(ctx, "cuBLAS GEMMs, linears and logits")
            else:
                cls = TRAIN_GLUE_CLASS.get(ctx, "fake-quant and other elementwise")
            classes[cls] += us / 1e3
        busy = sum(classes.values())
        n_linked = len(trace.kernels) - sum(1 for _, _, op in trace.kernels if op not in trace.ops)
        top = sorted(unlinked.items(), key=lambda kv: -kv[1])[:3]
        log(f"[train] {label} device busy by class, the profiled step ({n_linked} kernels, "
            f"{busy:.1f} ms busy of {step_ms:.1f} ms, idle share {1 - busy / step_ms:.3f}): "
            + ", ".join(f"{c} {v:.1f} ms" for c, v in classes.items() if v)
            + f"; device events no op launched, left out: {sum(unlinked.values()):.1f} ms "
            + f"({', '.join(f'{n[:40]} {v:.1f}' for n, v in top) or 'none'})"
            + f" (aggregated in {time.perf_counter() - t0:.1f} s); {smi}")

    def _train_topk_times(self, smi, rows=TRAIN_ROWS, ks=TRAIN_TOPK_K, what="training call"):
        """das_topk's training calls (the mask alone) at ``rows`` x every K
        of ``ks``, bf16: CUDA-event median beside the bound (x read, the int8
        mask written) and the plain version."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.topk_mask import das_topk_cuda
        g = self.gen(self.seed + 9)
        for k in ks:
            x = torch.randn((rows, k), generator=g, device=self.dev).to(torch.bfloat16)
            ms = self._t_ms(lambda: das_topk_cuda(x, keep=16, block=32, with_compact=False))
            plain = self._t_ms(lambda: ref.das_topk_ref(x, keep=16, block=32,
                                                       with_compact=False), reps=5)
            bound = rows * k * 3 / HBM_BYTES_PER_S * 1e3
            log(f"[times] das_topk {what}, mask only ({rows},{k}) bf16: "
                f"{ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us (bytes), plain {plain * 1e3:.1f} "
                f"us; {smi}")

    def _train_serve(self, cfg, params):
        """Check (e): the trained masters exported base-3 packed, one greedy
        request of 16 tokens through ServeEngine, the serving kernels
        launched."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.models import model as MD
        from repro_torch.serve import Request, ServeConfig, ServeEngine
        model = MD.export_serving(params, cfg)
        del params
        torch.cuda.empty_cache()
        prompt = torch.randint(0, cfg.vocab, (296,),
                               generator=torch.Generator().manual_seed(self.seed + 13)).numpy()
        sc = ServeConfig(max_slots=1, max_len=len(prompt) + 16, seed=self.seed)
        ops.reset_launches()                   # the path starts here
        eng = ServeEngine(model, sc, device="cuda")
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=16))
        res = eng.run()
        torch.cuda.synchronize()
        counts = dict(ops.launches)            # ... and ends here
        toks = res[0].tokens
        log(f"[train] (e) the trained model, exported packed, served one greedy request "
            f"(prompt {len(prompt)}): {len(toks)} tokens {toks.tolist()}; launches {counts}")
        if len(toks) != 16 or not all(0 <= int(t) < cfg.vocab for t in toks):
            raise AssertionError("train (e): the trained model did not serve 16 tokens")
        for name in ("das_topk", "das_ternary_gemm", "ternary_gemm", "sparse_attention"):
            if counts[name] <= 0:
                raise AssertionError(f"train (e): {name} was not launched while serving")
        for name, n in counts.items():
            self.launches[name] += n
        del eng, model
        torch.cuda.empty_cache()

    def _t_ms(self, fn, reps=25):
        """Median CUDA-event time of one call, L2 flushed before each.

        A spin of ~5 ms queued ahead keeps the card busy while the host
        enqueues the call, so the events bracket device time only."""
        torch = self.torch
        if getattr(self, "_flush", None) is None:
            self._flush = torch.empty(64 << 20, dtype=torch.uint8, device=self.dev)  # > 50 MB L2
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self._flush.zero_()
            torch.cuda._sleep(10_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def phase_times(self):
        torch = self.torch
        from repro_torch.core import das as das_lib
        from repro_torch.core import twd
        from repro_torch.core.lpsa import lpsa_allowed
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.das_gemv import das_gemv_cuda
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        from repro_torch.kernels.twd_decode import twd_decode_cuda
        g = self.gen(self.seed + 2)
        bf16 = torch.bfloat16
        scale = torch.tensor(0.37, device=self.dev)
        t_ms = self._t_ms

        def row(name, fn, plain, library, nbytes, flops, dtype, shape):
            ms, plain_ms = t_ms(fn), t_ms(plain)
            lib_ms = t_ms(library) if library is not None else None
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            self.timed[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                "bound_ms": max(t_bytes, t_ops),
                                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                                "shape": shape}
            log(f"[times] {name} {shape}: {ms * 1e3:.1f} us, bound {max(t_bytes, t_ops) * 1e3:.2f}"
                f" us ({self.timed[name]['bound_by']}), plain {plain_ms * 1e3:.1f} us, "
                f"library {'n/a' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}")

        log(f"[times] an empty launch (torch.cuda._sleep(0)), the floor of this method: "
            f"{t_ms(lambda: torch.cuda._sleep(0)) * 1e3:.1f} us")
        m, k, n, f = 4, 2048, 2048, 5460
        x = torch.randn((m, k), generator=g, device=self.dev).to(bf16)
        kc = k // 2
        row("das_topk", lambda: das_topk_cuda(x, keep=16, block=32),
            lambda: ref.das_topk_ref(x, keep=16, block=32), None,
            m * k * 2 + m * k + m * kc * (2 + 4), 32 * m * k, "bfloat16",
            f"x ({m},{k}) bf16")

        ca = das_lib.das_compact(x, block_size=32, keep=16)
        packed = twd.pack_ternary(torch.randint(-1, 2, (k, f), generator=g,
                                                device=self.dev), row_align=16)
        w_bf16 = (twd.unpack_ternary_arith(packed, packed.shape[0] * 5).float()
                  * 0.37).to(bf16)
        dense = torch.zeros((m, w_bf16.shape[0]), dtype=bf16, device=self.dev)
        dense.scatter_(1, ca.indices.long(), ca.values)
        row("das_ternary_gemm",
            lambda: das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale, keep=16),
            lambda: ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale),
            lambda: torch.matmul(dense, w_bf16),
            m * kc * (2 + 4) + packed.numel() + m * f * 4 + 4, 2 * m * kc * f, "bfloat16",
            f"({m},{kc} of {k}) x packed {tuple(packed.shape)} (gate/up)")

        xd = torch.randn((m, f), generator=g, device=self.dev).to(bf16)
        xd = das_lib.das_apply(xd, das_lib.das_mask(xd, keep=16))
        packed_d = twd.pack_ternary(torch.randint(-1, 2, (f, n), generator=g,
                                                  device=self.dev), row_align=16)
        wd_bf16 = (twd.unpack_ternary_arith(packed_d, f).float() * 0.37).to(bf16)
        nnz = int((xd != 0).sum())
        row("ternary_gemm", lambda: ternary_gemm_cuda(xd, packed_d, scale),
            lambda: ref.ternary_gemm_ref(xd, packed_d, scale),
            lambda: torch.matmul(xd, wd_bf16),
            m * f * 2 + packed_d.numel() + m * n * 4 + 4, 2 * nnz * n, "bfloat16",
            f"x ({m},{f}) bf16 x packed {tuple(packed_d.shape)} (down)")

        # the packed GEMMs at their other main-path shapes: q/k/v/o at decode,
        # and both at one 256-row prefill pack, each beside its bound and its
        # library call (bf16 matmul of the densified rows with the bf16 weight)
        def extra(label, fn, library, nbytes, flops):
            ms, lib_ms = t_ms(fn), t_ms(library)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]) * 1e3
            log(f"[times] {label}: {ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us, "
                f"library {lib_ms * 1e3:.1f} us")

        xq = torch.randn((m, k), generator=g, device=self.dev).to(bf16)
        caq = das_lib.das_compact(xq, block_size=32, keep=16)
        packed_q = twd.pack_ternary(torch.randint(-1, 2, (k, n), generator=g,
                                                  device=self.dev), row_align=16)
        wq_bf16 = (twd.unpack_ternary_arith(packed_q, packed_q.shape[0] * 5).float()
                   * 0.37).to(bf16)
        dense_q = torch.zeros((m, wq_bf16.shape[0]), dtype=bf16, device=self.dev)
        dense_q.scatter_(1, caq.indices.long(), caq.values)
        extra(f"decode das_ternary_gemm ({m},{kc} of {k}) x packed {tuple(packed_q.shape)}"
              f" (q/k/v/o)",
              lambda: das_ternary_gemm_cuda(caq.values, caq.indices, packed_q, scale, keep=16),
              lambda: torch.matmul(dense_q, wq_bf16),
              m * kc * 6 + packed_q.numel() + m * n * 4 + 4, 2 * m * kc * n)
        xp = torch.randn((256, k), generator=g, device=self.dev).to(bf16)
        cap = das_lib.das_compact(xp, block_size=32, keep=16)
        dense_p = torch.zeros((256, w_bf16.shape[0]), dtype=bf16, device=self.dev)
        dense_p.scatter_(1, cap.indices.long(), cap.values)
        extra(f"prefill das_ternary_gemm (256,{kc} of {k}) x packed {tuple(packed.shape)}"
              f" (gate/up)",
              lambda: das_ternary_gemm_cuda(cap.values, cap.indices, packed, scale, keep=16),
              lambda: torch.matmul(dense_p, w_bf16),
              256 * kc * 6 + packed.numel() + 256 * f * 4 + 4, 2 * 256 * kc * f)
        xpd = torch.randn((256, f), generator=g, device=self.dev).to(bf16)
        extra(f"prefill ternary_gemm (256,{f}) x packed {tuple(packed_d.shape)} (down)",
              lambda: ternary_gemm_cuda(xpd, packed_d, scale),
              lambda: torch.matmul(xpd, wd_bf16),
              256 * f * 2 + packed_d.numel() + 256 * n * 4 + 4, 2 * 256 * f * n)
        xpq = torch.randn((256, k), generator=g, device=self.dev).to(bf16)
        capq = das_lib.das_compact(xpq, block_size=32, keep=16)
        dense_pq = torch.zeros((256, wq_bf16.shape[0]), dtype=bf16, device=self.dev)
        dense_pq.scatter_(1, capq.indices.long(), capq.values)
        extra(f"prefill das_ternary_gemm (256,{kc} of {k}) x packed {tuple(packed_q.shape)}"
              f" (q/k/v/o)",
              lambda: das_ternary_gemm_cuda(capq.values, capq.indices, packed_q, scale, keep=16),
              lambda: torch.matmul(dense_pq, wq_bf16),
              256 * kc * 6 + packed_q.numel() + 256 * n * 4 + 4, 2 * 256 * kc * n)
        # ternary_gemm on float32 rows with DAS off (the tune phase's float32
        # gate) at a 256-row prefill, beside a float32 matmul with TF32 off
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for kk, nn, pk in ((k, n, packed_q), (k, f, packed), (f, n, packed_d)):
                x32 = torch.randn((256, kk), generator=g, device=self.dev)
                w32 = twd.unpack_ternary_arith(pk, kk).float() * 0.37
                ms = t_ms(lambda: ternary_gemm_cuda(x32, pk, scale))
                lib_ms = t_ms(lambda: torch.matmul(x32, w32))
                t_b = (256 * kk * 4 + pk.numel() + 256 * nn * 4 + 4) / HBM_BYTES_PER_S * 1e3
                t_o = 2 * 256 * kk * nn / PEAK_FLOPS["float32"] * 1e3
                log(f"[times] prefill ternary_gemm float32 rows, DAS off (256,{kk}) x packed "
                    f"{tuple(pk.shape)} -> {nn}: {ms * 1e3:.2f} us, bound "
                    f"{max(t_b, t_o) * 1e3:.2f} us ({'bytes' if t_b >= t_o else 'operations'}),"
                    f" library {lib_ms * 1e3:.2f} us (float32 matmul, TF32 off)")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

        # the int8w path: the gate/up weight decoded to trits, and das_gemv on
        # them; bytes count the trit rows that the 4 rows' kept lanes touch
        row("twd_decode", lambda: twd_decode_cuda(packed, k),
            lambda: ref.twd_decode_ref(packed, k), None,
            packed.numel() + k * f, 2 * k * f, "float32",
            f"packed {tuple(packed.shape)} -> trits ({k},{f}) (gate/up)")
        trits = twd.unpack_ternary_arith(packed, k).contiguous()
        trits_bf16 = trits.to(bf16)
        dense_k = torch.zeros((m, k), dtype=bf16, device=self.dev)
        dense_k.scatter_(1, ca.indices.long(), ca.values)
        kept = torch.zeros(k, dtype=torch.bool, device=self.dev)
        kept[ca.indices.long().flatten()] = True
        row("das_gemv", lambda: das_gemv_cuda(ca.values, ca.indices, trits, scale, keep=16),
            lambda: ref.das_gemv_ref(ca.values, ca.indices, trits, scale),
            lambda: torch.matmul(dense_k, trits_bf16),
            m * kc * (2 + 4) + int(kept.sum()) * f + m * f * 4 + 4, 2 * m * kc * f,
            "bfloat16", f"({m},{kc} of {k}) x trits ({k},{f}) bf16 (gate/up)")

        # das_gemv at the other shapes of the int8w path, each beside its
        # bound and its library call (bf16 matmul of the densified rows with
        # the bf16 trits): q/k/v/o and down at decode, gate/up and down at a
        # 256-row prefill pack
        trits_q = torch.randint(-1, 2, (k, n), generator=g, device=self.dev).to(torch.int8)
        trits_dn = twd.unpack_ternary_arith(packed_d, f).contiguous()
        dense_qk = torch.zeros((m, k), dtype=bf16, device=self.dev)
        dense_qk.scatter_(1, caq.indices.long(), caq.values)
        dense_pk = torch.zeros((256, k), dtype=bf16, device=self.dev)
        dense_pk.scatter_(1, cap.indices.long(), cap.values)
        trits_q_bf16, trits_dn_bf16 = trits_q.to(bf16), trits_dn.to(bf16)
        extra(f"decode das_gemv ({m},{kc} of {k})x({k},{n}) (q/k/v/o)",
              lambda: das_gemv_cuda(caq.values, caq.indices, trits_q, scale, keep=16),
              lambda: torch.matmul(dense_qk, trits_q_bf16),
              m * kc * 6 + k * n + m * n * 4, 2 * m * kc * n)
        extra(f"decode das_gemv dense ({m},{f})x({f},{n}) (down)",
              lambda: das_gemv_cuda(xd, None, trits_dn, scale),
              lambda: torch.matmul(xd, trits_dn_bf16),
              m * f * 2 + f * n + m * n * 4, 2 * nnz * n)
        extra(f"prefill das_gemv (256,{kc} of {k})x({k},{f}) (gate/up)",
              lambda: das_gemv_cuda(cap.values, cap.indices, trits, scale, keep=16),
              lambda: torch.matmul(dense_pk, trits_bf16),
              256 * kc * 6 + trits.numel() + 256 * f * 4, 2 * 256 * kc * f)
        extra(f"prefill das_gemv dense (256,{f})x({f},{n}) (down)",
              lambda: das_gemv_cuda(xpd, None, trits_dn, scale),
              lambda: torch.matmul(xpd, trits_dn_bf16),
              256 * f * 2 + trits_dn.numel() + 256 * n * 4, 2 * 256 * f * n)
        self._topk_times(t_ms, g, k)

        # twd_decode at the other projections' shapes (q/k/v/o, down)
        for kk, nn in ((k, n), (f, n)):
            pk = twd.pack_ternary(torch.randint(-1, 2, (kk, nn), generator=g,
                                                device=self.dev), row_align=16)
            ms = t_ms(lambda: twd_decode_cuda(pk, kk))
            bound = (pk.numel() + kk * nn) / HBM_BYTES_PER_S
            log(f"[times] twd_decode packed {tuple(pk.shape)} -> trits ({kk},{nn}): "
                f"{ms * 1e3:.1f} us, bound {bound * 1e6:.2f} us")

        b, h, d, s = 4, 32, 64, 1024
        q = torch.randn((b, 1, h, d), generator=g, device=self.dev).to(bf16)
        kk = torch.randn((b, s, h, d), generator=g, device=self.dev).to(bf16)
        vv = torch.randn((b, s, h, d), generator=g, device=self.dev).to(bf16)
        qp = torch.full((b, 1), 2000, dtype=torch.int32, device=self.dev)
        kp = torch.cat([torch.arange(128), 2000 - 895 + torch.arange(896)]).to(
            torch.int32).to(self.dev)[None].repeat(b, 1)
        allowed = (kp >= 0) & (kp <= qp) & ((kp < 128) | (qp - kp < 896))
        qt, kt, vt = q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)
        bmask = allowed[:, None, None, :]
        n_keys = int(allowed.sum())
        row("sparse_attention",
            lambda: sparse_attention_cuda(q, kk, vv, qp, kp, sink=128, window=896),
            lambda: ref.sparse_attention_ref(q, kk, vv, qp, kp, sink=128, window=896),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bmask),
            2 * n_keys * h * d * 2 + b * h * d * 2 * 2 + b * s * 4 + b * 4,
            4 * n_keys * h * d, "bfloat16",
            f"decode q ({b},1,{h},{d}) over a {s}-slot ring bf16")

        # the paged-full decode: 4 rows over the view gathered through their
        # page tables (64 pages of 16 out of a 257-page arena, Lk 1024, full
        # attention), 360 / 340 / 410 / 390 tokens live; built here, not by
        # the package, so a tree without the paged layout times it too
        ps, n_seq = 16, 64
        depth = torch.tensor([360, 340, 410, 390])
        n_live = (depth + ps - 1) // ps
        order = torch.randperm(4 * n_seq, generator=torch.Generator().manual_seed(3)) + 1
        pt = torch.zeros((b, n_seq), dtype=torch.long)
        pos_pages = torch.full((4 * n_seq + 1, ps), -1, dtype=torch.int32)
        for i in range(b):
            pages = order[i * n_seq:i * n_seq + int(n_live[i])]
            pt[i, :len(pages)] = pages
            live = torch.arange(int(depth[i]), dtype=torch.int32)
            pos_pages.view(-1).index_copy_(
                0, (pages[:, None] * ps + torch.arange(ps)).flatten()[:len(live)], live)
        pt, pos_pages = pt.to(self.dev), pos_pages.to(self.dev)
        k_pages = torch.randn((4 * n_seq + 1, ps, h, d), generator=g, device=self.dev).to(bf16)
        v_pages = torch.randn((4 * n_seq + 1, ps, h, d), generator=g, device=self.dev).to(bf16)

        def gather():
            return (k_pages[pt].reshape(b, s, h, d), v_pages[pt].reshape(b, s, h, d),
                    pos_pages[pt].reshape(b, s))

        kg, vg, kpg = gather()
        qpg = depth.to(torch.int32).to(self.dev)[:, None]
        live = (kpg >= 0) & (kpg <= qpg)
        n_keys = int(live.sum())
        row("sparse_attention paged decode",
            lambda: sparse_attention_cuda(q, kg, vg, qpg, kpg, sink=FULL_SINK, window=0),
            lambda: ref.sparse_attention_ref(q, kg, vg, qpg, kpg, sink=FULL_SINK, window=0),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kg.transpose(1, 2), vg.transpose(1, 2), attn_mask=live[:, None, None, :]),
            2 * n_keys * h * d * 2 + b * h * d * 2 * 2 + b * s * 4 + b * 4,
            4 * n_keys * h * d, "bfloat16",
            f"decode q ({b},1,{h},{d}) over the gathered view of {n_seq} pages of {ps} "
            f"({n_keys} live keys) bf16")

        def gathered_attention():
            kg2, vg2, kp2 = gather()
            return sparse_attention_cuda(q, kg2, vg2, qpg, kp2, sink=FULL_SINK, window=0)

        ms_gather, ms_both = t_ms(gather), t_ms(gathered_attention)
        view_bytes = b * s * (2 * h * d * 2 + 4)
        log(f"[times] paged decode, one layer: the gather of the view {ms_gather * 1e3:.1f} us "
            f"({view_bytes / 1e6:.1f} MB written, bound {2 * view_bytes / HBM_BYTES_PER_S * 1e6:.2f}"
            f" us), gather + sparse_attention {ms_both * 1e3:.1f} us")

        # the prefill classes: a pack of 256 queries over [sink | window |
        # pack] = 1280 keys at three stream offsets (the streaming prefill's
        # round_scores), and full causal attention over 1024 tokens; bytes
        # count the keys some query attends, operations the allowed pairs;
        # the library call is SDPA with the same boolean mask
        def attn_row(label, b, hq, hkv, d, dt, qp, kp, sink, window, cap, rs):
            lq, lk = qp.shape[1], kp.shape[1]
            q = torch.randn((b, lq, hq, d), generator=g, device=self.dev).to(dt)
            k = torch.randn((b, lk, hkv, d), generator=g, device=self.dev).to(dt)
            v = torch.randn((b, lk, hkv, d), generator=g, device=self.dev).to(dt)
            allowed = lpsa_allowed(qp[:, :, None], kp[:, None, :], sink, window) & (
                kp >= 0)[:, None, :]              # ref.sparse_attention_ref's mask
            pairs, keys = int(allowed.sum()), int(allowed.any(1).sum())
            es = q.element_size()
            kw = dict(sink=sink, window=window, softcap=cap, round_scores=rs)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            row(f"sparse_attention {label}",
                lambda: sparse_attention_cuda(q, k, v, qp, kp, **kw),
                lambda: ref.sparse_attention_ref(q, k, v, qp, kp, **kw),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=allowed[:, None], enable_gqa=hq != hkv),
                2 * b * lq * hq * d * es + 2 * keys * hkv * d * es + b * (lq + lk) * 4,
                4 * pairs * hq * d, "bfloat16" if dt == bf16 else "float32",
                f"q ({b},{lq},{hq},{d}) over {lk} keys of {hkv} heads ({keys} attended, "
                f"{pairs} pairs) {dt}{'' if cap is None else f', softcap {cap:g}'}")

        def prefill_row(label, dt, qp, kp, sink, window, rs):
            attn_row(f"prefill {label}", 1, h, h, d, dt, qp[None].to(self.dev),
                     kp[None].to(self.dev), sink, window, None, rs)

        for t0 in (0, 512, 2000):
            qp1, kp1 = pack_positions(torch, t0)
            prefill_row(f"t0={t0}", bf16, qp1, kp1, 128, 896, True)
        pos = torch.arange(1024, dtype=torch.int32)
        prefill_row("full causal", bf16, pos, pos, FULL_SINK, 0, False)
        qp1, kp1 = pack_positions(torch, 2000)
        prefill_row("f32 t0=2000", torch.float32, qp1, kp1, 128, 896, False)
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import sparse_attn
        if 256 in sparse_attn.HEAD_DIMS:      # a tree before the zoo (--parent) has no D = 256
            self._zoo_times(t_ms, attn_row, extra, g)
        if hasattr(kops, "twd_decode_stack"):  # nor one before the MoE a stack decode
            self._moe_times(t_ms, attn_row, g)
        self._ssm_times(t_ms, g)
        self._hybrid_times(t_ms, attn_row, g)
        if 160 in sparse_attn.HEAD_DIMS:      # a tree before the frontends has no D = 160
            self._frontend_times(t_ms, attn_row, g)
        self._tp2_times(t_ms, g)
        self._train_topk_times(_nvidia_smi(), DIST_TRAIN_ROWS, DIST_TOPK_K,
                               "dist trainer call (a rank of dp 2 x tp 2)")

    def _tp2_times(self, t_ms, g):
        """bitnet-1.3b's tp = 2 shard shapes at a rank's decode step (2 rows:
        dp 2 halves the 4 slots), each beside its bound, plain version and
        library call: das_topk at the shards' K (2048 the replicated q/k/v
        and gate/up input, 1024 wo's, 2720 / 2740 the down's on rank 0 / 1),
        das_ternary_gemm at q/k/v (2048 -> 1024), o (1024 -> 2048), gate/up
        (2048 -> 2720 / 2740) and rank 0's down (2720 -> 2048), ternary_gemm
        at rank 1's down on masked dense rows (2740, the dense tail, ->
        2048), sparse_attention over 16 heads."""
        torch = self.torch
        from repro_torch.core import das as das_lib
        from repro_torch.core import twd
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        bf16, m, dev = torch.bfloat16, 2, self.dev
        scale = torch.tensor(0.37, device=dev)
        line = self._time_line
        for k in (2048, 1024, 2720, 2740):
            x = torch.randn((m, k), generator=g, device=dev).to(bf16)
            out = m * k // 32 * 16 * 6 if k % 32 == 0 else m * k * 2
            line(t_ms, f"tp2 das_topk ({m},{k}) bf16, mask null",
                 lambda x=x: das_topk_cuda(x, keep=16, block=32, with_mask=False),
                 lambda x=x: ref.das_topk_ref(x, keep=16, block=32, with_mask=False), None,
                 m * k * 2 + out, 32 * m * k)
        for k, n, what in ((2048, 1024, "q/k/v"), (1024, 2048, "o"), (2048, 2720, "gate/up r0"),
                           (2048, 2740, "gate/up r1"), (2720, 2048, "down r0")):
            x = torch.randn((m, k), generator=g, device=dev).to(bf16)
            ca = das_lib.das_compact(x, block_size=32, keep=16)
            packed = twd.pack_ternary(torch.randint(-1, 2, (k, n), generator=g, device=dev),
                                      row_align=16)
            w = (twd.unpack_ternary_arith(packed, packed.shape[0] * 5).float() * 0.37).to(bf16)
            dense = torch.zeros((m, w.shape[0]), dtype=bf16, device=dev)
            dense.scatter_(1, ca.indices.long(), ca.values)
            kc = k // 2
            line(t_ms, f"tp2 das_ternary_gemm ({m},{kc} of {k}) x packed {tuple(packed.shape)} "
                 f"({what})",
                 lambda ca=ca, p=packed: das_ternary_gemm_cuda(ca.values, ca.indices, p, scale,
                                                               keep=16),
                 lambda ca=ca, p=packed: ref.das_ternary_gemm_ref(ca.values, ca.indices, p,
                                                                  scale),
                 lambda d=dense, w=w: torch.matmul(d, w),
                 m * kc * 6 + packed.numel() + m * n * 4 + 4, 2 * m * kc * n)
        for k in (2740,):
            x = torch.randn((m, k), generator=g, device=dev).to(bf16)
            xd = das_lib.das_apply(x, das_lib.das_mask(x, keep=16))
            packed = twd.pack_ternary(torch.randint(-1, 2, (k, 2048), generator=g, device=dev),
                                      row_align=16)
            w = (twd.unpack_ternary_arith(packed, k).float() * 0.37).to(bf16)
            nnz = int((xd != 0).sum())
            line(t_ms, f"tp2 ternary_gemm ({m},{k}) masked dense x packed {tuple(packed.shape)} "
                 f"(down r1)",
                 lambda xd=xd, p=packed: ternary_gemm_cuda(xd, p, scale),
                 lambda xd=xd, p=packed: ref.ternary_gemm_ref(xd, p, scale),
                 lambda xd=xd, w=w: torch.matmul(xd, w),
                 m * k * 2 + packed.numel() + m * 2048 * 4 + 4, 2 * nnz * 2048)
        h, d, s = 16, 64, 1024
        q = torch.randn((m, 1, h, d), generator=g, device=dev).to(bf16)
        kk = torch.randn((m, s, h, d), generator=g, device=dev).to(bf16)
        vv = torch.randn((m, s, h, d), generator=g, device=dev).to(bf16)
        qp = torch.full((m, 1), 2000, dtype=torch.int32, device=dev)
        kp = torch.cat([torch.arange(128), 2000 - 895 + torch.arange(896)]).to(
            torch.int32).to(dev)[None].repeat(m, 1)
        allowed = ((kp >= 0) & (kp <= qp) & ((kp < 128) | (qp - kp < 896)))[:, None, None, :]
        n_keys = int(allowed.sum())
        line(t_ms, f"tp2 sparse_attention decode q ({m},1,{h},{d}) over a {s}-slot ring bf16",
             lambda: sparse_attention_cuda(q, kk, vv, qp, kp, sink=128, window=896),
             lambda: ref.sparse_attention_ref(q, kk, vv, qp, kp, sink=128, window=896),
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=allowed),
             2 * n_keys * h * d * 2 + m * h * d * 2 * 2 + m * s * 4 + m * 4, 4 * n_keys * h * d)
        # qwen3-moe-30b-a3b at tp 2: each rank decodes the stacks of its 64
        # experts in one launch (bytes as _moe_times counts them)
        from repro_torch.kernels.twd_decode import twd_decode_cuda
        for e, k, n in self.MOE_STACKS:
            e //= 2
            r = twd.packed_rows(k, 16)
            packed = torch.randint(0, 243, (e, r, n), generator=g, device=dev).to(torch.uint8)
            flat = packed.view(e * r, n)
            line(t_ms, f"tp2 twd_decode expert stack ({e}x{r},{n}) -> ({e}x{5 * r},{n}) (one "
                 f"launch, 64 of 128 experts)",
                 lambda flat=flat, e=e, r=r: twd_decode_cuda(flat, 5 * e * r),
                 lambda packed=packed, k=k: ref.twd_decode_stack_ref(packed, k), None,
                 e * -(-k // 5) * n + e * k * n, 0)

    def _moe_times(self, t_ms, attn_row, g):
        """qwen3-moe-30b-a3b's shapes beside their bounds: twd_decode over each
        expert stack (one launch; bytes: the ceil(k/5) packed rows of each
        expert that its k returned trit rows need, read once, and those k
        rows written) beside its plain version (no PyTorch call decodes
        base-3); sparse_attention at 32 q heads over 4 kv heads of 64, ring
        decode and an LPSA prefill pack, beside its plain version and SDPA
        with the same mask."""
        torch = self.torch
        from repro_torch.core import twd
        from repro_torch.kernels import ref
        from repro_torch.kernels.twd_decode import twd_decode_cuda
        dev = self.dev
        for e, k, n in self.MOE_STACKS:
            r = twd.packed_rows(k, 16)
            packed = torch.randint(0, 243, (e, r, n), generator=g, device=dev).to(torch.uint8)
            flat = packed.view(e * r, n)
            ms = t_ms(lambda: twd_decode_cuda(flat, 5 * e * r))
            plain_ms = t_ms(lambda: ref.twd_decode_stack_ref(packed, k))
            nbytes = e * -(-k // 5) * n + e * k * n
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            self.timed[f"twd_decode stack {e}x{r}x{n}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": None}
            log(f"[times] twd_decode expert stack ({e}x{r},{n}) -> ({e}x{5 * r},{n}) (one "
                f"launch): {ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us (bytes, "
                f"{nbytes / 1e6:.1f} MB), plain {plain_ms * 1e3:.1f} us, library n/a")
        rows = (1500, 1023, 300, 5)
        qp = torch.tensor(rows, dtype=torch.int32, device=dev)[:, None]
        kp = torch.stack([ring_positions(torch, t, 128, 896) for t in rows]).to(dev)
        attn_row("decode GQA 32/4 D=64 ring 1024", 4, 32, 4, 64, torch.bfloat16, qp, kp, 128,
                 896, None, False)
        qp1, kp1 = pack_positions(torch, 512)
        attn_row("prefill GQA 32/4 D=64 LPSA pack t0=512", 1, 32, 4, 64, torch.bfloat16,
                 qp1[None].to(dev), kp1[None].to(dev), 128, 896, None, True)

    def _ssm_times(self, t_ms, g):
        """The SSM pair's shapes beside their bounds, each with its plain
        version and its library call: das_ternary_gemm at every projection
        at decode (4 rows) and at the 1100-token admission (the library: a
        bf16 matmul of the densified rows with the bf16 weight); das_topk's
        serving calls at every K (plain at decode and admission, gla's
        norm-fused one with the normed rows at K = 2048), no library call
        (no PyTorch call takes a per-block top-k and compacts); and the MoE's
        das_topk call (norm-fused, normed and dense rows beside the
        compaction) at 4 and 1024 rows of 2048.  Bytes: each input once,
        each output once; operations: the kept lanes' products."""
        torch = self.torch
        from repro_torch.core import twd
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        dev, bf16 = self.dev, torch.bfloat16
        scale = torch.tensor(0.37, device=dev)

        def line(*args):
            self._time_line(t_ms, *args)

        for label, k, n in self.SSM_GEMMS:
            packed = twd.pack_ternary(torch.randint(-1, 2, (k, n), generator=g, device=dev),
                                      row_align=16)
            w = (twd.unpack_ternary_arith(packed, packed.shape[0] * 5).float() * 0.37).to(bf16)
            kc = k // 2
            for m in (4, self.SSM_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                ca = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                dense = torch.zeros((m, w.shape[0]), dtype=bf16, device=dev)
                dense.scatter_(1, ca.indices.long(), ca.values)
                line(f"das_ternary_gemm {label} ({m},{kc} of {k}) x packed "
                     f"{tuple(packed.shape)}",
                     lambda: das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale,
                                                   keep=16),
                     lambda: ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale),
                     lambda: torch.matmul(dense, w),
                     m * kc * 6 + packed.numel() + m * n * 4 + 4, 2 * m * kc * n)
        for k in (2560, 8960, 2048, 5632):
            for m in (4, self.SSM_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                out = m * (k // 2) * (2 + 4)              # values and indices
                line(f"das_topk serving, mask null ({m},{k})",
                     lambda: das_topk_cuda(x, keep=16, block=32, with_mask=False),
                     lambda: ref.das_topk_ref(x, keep=16, block=32, with_mask=False), None,
                     m * k * 2 + out, 0)
                if k == 2048:
                    ns = (0.5 * torch.randn((k,), generator=g, device=dev)).to(bf16)
                    line(f"das_topk gla norm-fused with normed rows ({m},{k})",
                         lambda: das_topk_cuda(x, keep=16, block=32, norm_scale=ns,
                                               with_mask=False, with_normed=True),
                         lambda: ref.das_topk_ref(x, keep=16, block=32, norm_scale=ns,
                                                  with_mask=False, with_normed=True), None,
                         m * k * 2 + k * 2 + out + m * k * 2, 0)
        for m in (4, 1024):
            x = torch.randn((m, 2048), generator=g, device=dev).to(bf16)
            ns = (0.5 * torch.randn((2048,), generator=g, device=dev)).to(bf16)
            kw = dict(keep=16, block=32, norm_scale=ns, with_mask=False, with_normed=True,
                      with_dense=True)
            line(f"das_topk MoE call, normed and dense rows ({m},2048)",
                 lambda: das_topk_cuda(x, **kw), lambda: ref.das_topk_ref(x, **kw), None,
                 m * 2048 * 2 + 2048 * 2 + m * 1024 * 6 + 2 * m * 2048 * 2, 0)

    @staticmethod
    def _time_line(t_ms, label, fn, plain, library, nbytes, flops, dtype="bfloat16"):
        """Log one shape's time beside its bound (``nbytes`` at the memory
        rate or ``flops`` at the peak of ``dtype``, the larger), its plain
        version's and its library call's (None: n/a)."""
        ms, plain_ms = t_ms(fn), t_ms(plain)
        lib_ms = t_ms(library) if library is not None else None
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        log(f"[times] {label}: {ms * 1e3:.1f} us, bound {max(t_b, t_o) * 1e3:.2f} us "
            f"({'bytes' if t_b >= t_o else 'operations'}), plain {plain_ms * 1e3:.1f} us, "
            f"library {'n/a' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}")

    def _hybrid_times(self, t_ms, attn_row, g):
        """zamba2-2.7b's shapes beside their bounds, plain versions and
        library calls: das_ternary_gemm at every new projection at decode and
        at the 1024-row prefix (the library: a bf16 matmul of the densified
        rows with the bf16 weight); das_topk norm-fused with the normed rows
        at K = 2560 and plain at 5120 and 10240 (no library call);
        sparse_attention at 32 heads of 80 over 32, decode over full rings
        and an LPSA prefill pack (the library: SDPA with the same mask); and
        ternary_gemm in float32 at every projection of the SSM pair at 1 and
        512 rows, the shapes of their DAS-off width checks (the library: a
        float32 matmul with the float32 weight, TF32 off)."""
        torch = self.torch
        from repro_torch.core import twd
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        dev, bf16, f32 = self.dev, torch.bfloat16, torch.float32
        scale = torch.tensor(0.37, device=dev)

        def line(*args, **kw):
            self._time_line(t_ms, *args, **kw)

        for label, k, n in self.HYBRID_GEMMS:
            packed = twd.pack_ternary(torch.randint(-1, 2, (k, n), generator=g, device=dev),
                                      row_align=16)
            w = (twd.unpack_ternary_arith(packed, packed.shape[0] * 5).float() * 0.37).to(bf16)
            kc = k // 2
            for m in (4, self.HYBRID_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                ca = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                dense = torch.zeros((m, w.shape[0]), dtype=bf16, device=dev)
                dense.scatter_(1, ca.indices.long(), ca.values)
                line(f"das_ternary_gemm {label} ({m},{kc} of {k}) x packed "
                     f"{tuple(packed.shape)}",
                     lambda: das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale,
                                                   keep=16),
                     lambda: ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale),
                     lambda: torch.matmul(dense, w),
                     m * kc * 6 + packed.numel() + m * n * 4 + 4, 2 * m * kc * n)
        for k in (2560, 5120, 10240):
            ns = (0.5 * torch.randn((k,), generator=g, device=dev)).to(bf16)
            kw = dict(keep=16, block=32, with_mask=False)
            if k == 2560:
                kw.update(norm_scale=ns, with_normed=True)
            for m in (4, self.HYBRID_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev).to(bf16)
                out = m * (k // 2) * 6 + (m * k * 2 + k * 2 if k == 2560 else 0)
                line(f"das_topk zamba2 {'norm-fused with normed rows' if k == 2560 else 'plain'}"
                     f" ({m},{k})", lambda: das_topk_cuda(x, **kw),
                     lambda: ref.das_topk_ref(x, **kw), None, m * k * 2 + out, 0)
        rows = (1500, 1023, 2000, 1100)
        qp = torch.tensor(rows, dtype=torch.int32, device=dev)[:, None]
        kp = torch.stack([ring_positions(torch, t, 128, 896) for t in rows]).to(dev)
        attn_row("zamba2 decode D=80 32/32 full rings of 1024", 4, 32, 32, 80, bf16, qp, kp,
                 128, 896, None, False)
        qp1, kp1 = pack_positions(torch, 512)
        attn_row("zamba2 prefill D=80 32/32 LPSA pack t0=512", 1, 32, 32, 80, bf16,
                 qp1[None].to(dev), kp1[None].to(dev), 128, 896, None, True)
        for label, k, n in self.SSM_GEMMS:
            packed = twd.pack_ternary(torch.randint(-1, 2, (k, n), generator=g, device=dev),
                                      row_align=16)
            sc = torch.tensor((2 / math.pi / k) ** 0.5, device=dev)
            w = twd.unpack_ternary_arith(packed, k).float() * sc
            for m in (1, 512):
                x = torch.randn((m, k), generator=g, device=dev)
                line(f"ternary_gemm f32 {label} ({m},{k}) x packed {tuple(packed.shape)}",
                     lambda: ternary_gemm_cuda(x, packed, sc),
                     lambda: ref.ternary_gemm_ref(x, packed, sc), lambda: torch.matmul(x, w),
                     m * k * 4 + packed.numel() + m * n * 4 + 4, 2 * m * k * n, dtype="float32")

    def _frontend_times(self, t_ms, attn_row, g):
        """musicgen-medium's and pixtral-12b's shapes beside their bounds,
        plain versions and library calls, float32 rows: das_ternary_gemm at
        every projection at decode and at a 256-row pack (the library: a
        float32 matmul of the densified rows with the float32 weight, TF32
        off); das_topk plain and norm-fused at K = 1536, 5120, 6144 and 14336
        (no library call); ternary_gemm in float32 at the FFN shapes at 1 and
        512 rows (the width checks' path); sparse_attention at 32 heads of
        160 over 8 (bf16 decode over full rings, a bf16 and a float32 LPSA
        pack: the library SDPA with the same mask) and the float32-query
        decode over bfloat16 rings at 32/8 of 160 and 24/24 of 64 (the
        library: SDPA with the same mask on K/V upcast to float32; the bytes
        count the bf16 rows read, q and the float32 output)."""
        torch = self.torch
        from repro_torch.core import twd
        from repro_torch.core.lpsa import lpsa_allowed
        from repro_torch.kernels import ref
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.sparse_attn import sparse_attention_cuda
        from repro_torch.kernels.ternary_gemm import ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        dev, bf16, f32 = self.dev, torch.bfloat16, torch.float32

        def line(*args, **kw):
            self._time_line(t_ms, *args, dtype="float32", **kw)

        for label, k, n in self.FRONTEND_GEMMS:
            packed = twd.pack_ternary(torch.randint(-1, 2, (k, n), generator=g, device=dev),
                                      row_align=16)
            sc = torch.tensor((2 / math.pi / k) ** 0.5, device=dev)
            w = twd.unpack_ternary_arith(packed, packed.shape[0] * 5).float() * sc
            kc = k // 2
            for m in (4, self.FRONTEND_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev)
                ca = ref.das_topk_ref(x, keep=16, block=32, with_mask=False)
                dense = torch.zeros((m, w.shape[0]), device=dev)
                dense.scatter_(1, ca.indices.long(), ca.values)
                line(f"das_ternary_gemm f32 {label} ({m},{kc} of {k}) x packed "
                     f"{tuple(packed.shape)}",
                     lambda: das_ternary_gemm_cuda(ca.values, ca.indices, packed, sc, keep=16),
                     lambda: ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, sc),
                     lambda: torch.matmul(dense, w),
                     m * kc * 8 + packed.numel() + m * n * 4 + 4, 2 * m * kc * n)
            if n > k or k > 5120:
                wk = w[:k]
                for m in (1, 512):
                    x = torch.randn((m, k), generator=g, device=dev)
                    line(f"ternary_gemm f32 {label} ({m},{k}) x packed {tuple(packed.shape)}",
                         lambda: ternary_gemm_cuda(x, packed, sc),
                         lambda: ref.ternary_gemm_ref(x, packed, sc), lambda: torch.matmul(x, wk),
                         m * k * 4 + packed.numel() + m * n * 4 + 4, 2 * m * k * n)
        for k in (1536, 5120, 6144, 14336):
            ns = 0.5 * torch.randn((k,), generator=g, device=dev)
            for m in (4, self.FRONTEND_PREFILL_M):
                x = torch.randn((m, k), generator=g, device=dev)
                out = m * (k // 2) * 8
                for fused in (False, True):
                    kw = dict(keep=16, block=32, with_mask=False)
                    if fused:
                        kw["norm_scale"] = ns
                    line(f"das_topk f32 {'norm-fused' if fused else 'plain'} ({m},{k})",
                         lambda: das_topk_cuda(x, **kw), lambda: ref.das_topk_ref(x, **kw), None,
                         m * k * 4 + (k * 4 if fused else 0) + out, 0)
        rows = (1500, 1023, 2000, 1100)
        qp = torch.tensor(rows, dtype=torch.int32, device=dev)[:, None]
        kp = torch.stack([ring_positions(torch, t, 128, 896) for t in rows]).to(dev)
        attn_row("pixtral-12b decode D=160 32/8 full rings of 1024", 4, 32, 8, 160, bf16, qp, kp,
                 128, 896, None, False)
        qp1, kp1 = pack_positions(torch, 512)
        for dt in (bf16, f32):
            attn_row(f"pixtral-12b prefill D=160 32/8 LPSA pack t0=512 "
                     f"{'bf16' if dt == bf16 else 'f32'}", 1, 32, 8, 160, dt,
                     qp1[None].to(dev), kp1[None].to(dev), 128, 896, None, True)
        allowed = lpsa_allowed(qp[:, :, None], kp[:, None, :], 128, 896) & (kp >= 0)[:, None, :]
        keys = int(allowed.sum())
        for hq, hkv, d in ((32, 8, 160), (24, 24, 64)):
            q = torch.randn((4, 1, hq, d), generator=g, device=dev)
            k_ = torch.randn((4, 1024, hkv, d), generator=g, device=dev).to(bf16)
            v = torch.randn((4, 1024, hkv, d), generator=g, device=dev).to(bf16)
            kw = dict(sink=128, window=896)
            qt = q.transpose(1, 2)
            line(f"sparse_attention decode f32 q over bf16 K/V D={d} {hq}/{hkv} B=4 full rings "
                 f"of 1024 ({keys} attended keys)",
                 lambda: sparse_attention_cuda(q, k_, v, qp, kp, **kw),
                 lambda: ref.sparse_attention_ref(q, k_, v, qp, kp, **kw),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qt, k_.float().transpose(1, 2), v.float().transpose(1, 2),
                     attn_mask=allowed[:, None], enable_gqa=hq != hkv),
                 2 * keys * hkv * d * 2 + 2 * 4 * hq * d * 4 + 4 * (1 + 1024) * 4,
                 4 * keys * hq * d)

    def _zoo_times(self, t_ms, attn_row, extra, g):
        """The zoo's shapes beside their bounds: sparse_attention at the head
        sizes 100 and 256 in the decode class (full rings of 1024 and 4096),
        the bf16 prefill class (LPSA pack, local pack of 4352 keys) and the
        float32 prefill class, each beside its plain version and SDPA with
        the same mask (SDPA takes no soft-cap: its time is without one);
        das_topk and das_ternary_gemm at gemma2-2b's decode shapes and a
        256-row pack, beside the bound and the library call (bf16 matmul of
        the densified rows with the bf16 weight)."""
        torch = self.torch
        from repro_torch.core import das as das_lib
        from repro_torch.core import twd
        from repro_torch.kernels.das_gemm import das_ternary_gemm_cuda
        from repro_torch.kernels.topk_mask import das_topk_cuda
        dev, bf16, f32 = self.dev, torch.bfloat16, torch.float32
        rows = (5000, 4095, 700, 2000)
        for label, hq, hkv, d, sink, window, cap in (
                ("decode D=256 GQA 8/4 softcap 50 ring 1024", 8, 4, 256, 128, 896, 50.0),
                ("decode D=256 GQA 8/4 softcap 50 local ring 4096", 8, 4, 256, 0, 4096, 50.0),
                ("decode D=256 GQA 4/1 ring 1024", 4, 1, 256, 128, 896, None),
                ("decode D=100 32/32 ring 1024", 32, 32, 100, 128, 896, None)):
            qp = torch.tensor(rows, dtype=torch.int32, device=dev)[:, None]
            kp = torch.stack([ring_positions(torch, t, sink, window) for t in rows]).to(dev)
            attn_row(label, 4, hq, hkv, d, bf16, qp, kp, sink, window, cap, False)
        for label, hq, hkv, d, dt, t0, sink, window, cap in (
                ("prefill D=256 GQA 8/4 softcap 50 LPSA pack t0=2000", 8, 4, 256, bf16, 2000, 128,
                 896, 50.0),
                ("prefill D=256 GQA 8/4 softcap 50 local pack t0=4400", 8, 4, 256, bf16, 4400, 0,
                 4096, 50.0),
                ("prefill D=100 32/32 LPSA pack t0=2000", 32, 32, 100, bf16, 2000, 128, 896, None),
                ("prefill f32 D=256 GQA 8/4 LPSA pack t0=2000", 8, 4, 256, f32, 2000, 128, 896,
                 None),
                ("prefill f32 D=100 32/32 LPSA pack t0=2000", 32, 32, 100, f32, 2000, 128, 896,
                 None)):
            qp, kp = pack_positions(torch, t0, sink, window)
            attn_row(label, 1, hq, hkv, d, dt, qp[None].to(dev), kp[None].to(dev), sink, window,
                     cap, dt == bf16)

        scale = torch.tensor(0.37, device=dev)
        for label, m, k, n in self.ZOO_GEMMS[:6]:
            x = torch.randn((m, k), generator=g, device=dev).to(bf16)
            ca = das_lib.das_compact(x, block_size=32, keep=16)
            packed = twd.pack_ternary(torch.randint(-1, 2, (k, n), generator=g, device=dev),
                                      row_align=16)
            w = (twd.unpack_ternary_arith(packed, packed.shape[0] * 5).float() * 0.37).to(bf16)
            dense = torch.zeros((m, w.shape[0]), dtype=bf16, device=dev)
            dense.scatter_(1, ca.indices.long(), ca.values)
            kc = k // 2
            extra(f"das_ternary_gemm {label} ({m},{kc} of {k}) x packed {tuple(packed.shape)}",
                  lambda: das_ternary_gemm_cuda(ca.values, ca.indices, packed, scale, keep=16),
                  lambda: torch.matmul(dense, w),
                  m * kc * 6 + packed.numel() + m * n * 4 + 4, 2 * m * kc * n)
        for m, k in ((4, 2304), (4, 9216), (256, 2304)):
            x = torch.randn((m, k), generator=g, device=dev).to(bf16)
            nscale = (0.5 * torch.randn((k,), generator=g, device=dev)).to(bf16)
            ms = t_ms(lambda: das_topk_cuda(x, keep=16, block=32, norm_scale=nscale,
                                            with_mask=False))
            log(f"[times] das_topk norm-fused serving gemma2-2b ({m},{k}): {ms * 1e3:.1f} us, "
                f"bound {(m * k * 2 + k * 2 + m * (k // 2) * 6) / HBM_BYTES_PER_S * 1e6:.3f} us")

    def _topk_times(self, t_ms, g, k):
        """das_topk's other rows, each beside its bound (x, the norm scale
        and the outputs, once): with the mask at a 256-row pack; the serving
        call (mask null) and the norm-fused serving call at decode and at a
        pack.  A tree whose das_topk has neither option (the parent, under
        --parent) times what its serving path runs instead: das_topk with
        the mask, and rmsnorm followed by das_topk."""
        import inspect
        torch = self.torch
        from repro_torch.kernels.topk_mask import das_topk_cuda
        from repro_torch.models.layers import rmsnorm
        fused = "norm_scale" in inspect.signature(das_topk_cuda).parameters
        scale = (0.5 * torch.randn((k,), generator=g, device=self.dev)).to(torch.bfloat16)

        def timed(label, fn, nbytes):
            ms = t_ms(fn)
            log(f"[times] {label}: {ms * 1e3:.1f} us, bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e6:.3f} us")

        for m in (4, 256):
            x = torch.randn((m, k), generator=g, device=self.dev).to(torch.bfloat16)
            out = m * (k // 2) * (2 + 4)              # values and indices
            if m == 256:
                timed(f"prefill das_topk ({m},{k}) with the mask",
                      lambda: das_topk_cuda(x, keep=16, block=32), m * k * 3 + out)
            if fused:
                timed(f"das_topk serving, mask null ({m},{k})",
                      lambda: das_topk_cuda(x, keep=16, block=32, with_mask=False),
                      m * k * 2 + out)
                timed(f"das_topk norm-fused serving ({m},{k})",
                      lambda: das_topk_cuda(x, keep=16, block=32, norm_scale=scale,
                                            with_mask=False), m * k * 2 + k * 2 + out)
            else:
                timed(f"das_topk serving, mask null ({m},{k}) [mask written]",
                      lambda: das_topk_cuda(x, keep=16, block=32), m * k * 2 + out)
                timed(f"das_topk norm-fused serving ({m},{k}) [rmsnorm, then das_topk]",
                      lambda: das_topk_cuda(rmsnorm(scale, x), keep=16, block=32),
                      m * k * 2 + k * 2 + out)


def _packed_counts(n_l: int, steps: int, packs, dense_down: bool = True) -> dict:
    """The packed model's launches for ``steps`` decode steps and streaming
    prefills of ``packs`` packs each: per decode step 4/6/1/1 a layer, per
    prefill of n packs n+3 / 3n+3 / 1 / n (q/k/v per pack; o, gate/up, down
    once).  ``dense_down=False`` (32 divides d_ff: the down projection's
    rows are compacted) moves the down's launch from ternary_gemm to
    das_ternary_gemm."""
    down = 1 if dense_down else 0
    return {**{name: 0 for name in KERNEL_INFO},
            "das_topk": n_l * (4 * steps + sum(n + 3 for n in packs)),
            "das_ternary_gemm": n_l * ((7 - down) * steps + sum(3 * n + 4 - down for n in packs)),
            "ternary_gemm": n_l * down * (steps + len(packs)),
            "sparse_attention": n_l * (steps + sum(packs))}


def _hybrid_counts(n_m: int, n_a: int, steps: int, packs) -> dict:
    """zamba2's launches for ``steps`` decode steps and prefills of ``packs``
    packs each: a mamba layer 2 / 3 das_topk / das_ternary_gemm per decode
    step and per prefill alike (wz and wx share one DAS step with the norm
    inside, wo takes its own); an attention block the packed model's with
    the down compacted (32 | d_ff: per decode step 4 / 7 / 1 das_topk /
    das_ternary_gemm / sparse_attention, per prefill of n packs n+3 / 3n+4
    / n)."""
    counts = _packed_counts(n_a, steps, packs, dense_down=False)
    calls = steps + len(packs)
    counts["das_topk"] += 2 * n_m * calls
    counts["das_ternary_gemm"] += 3 * n_m * calls
    return counts


def _moe_counts(n_l: int, steps: int, packs) -> dict:
    """The MoE model's launches for ``steps`` decode steps and streaming
    prefills of ``packs`` packs each: per decode step 3 / 4 / 1 / 3
    das_topk / das_ternary_gemm / sparse_attention / twd_decode a layer
    (das_topk for q/k/v, o and the MoE's input; q, k, v, o; the three expert
    stacks); per prefill of n packs n+2 / 3n+1 / n / 3 (q/k/v per pack; o
    and the MoE once over the whole prefix)."""
    return {**{name: 0 for name in KERNEL_INFO},
            "das_topk": n_l * (3 * steps + sum(n + 2 for n in packs)),
            "das_ternary_gemm": n_l * (4 * steps + sum(3 * n + 1 for n in packs)),
            "sparse_attention": n_l * (steps + sum(packs)),
            "twd_decode": 3 * n_l * (steps + len(packs))}


def _frontend_counts(n_l: int, steps: int, packs, mlp: bool) -> dict:
    """A stub-frontend model's launches for ``steps`` decode steps and
    streaming prefills of ``packs`` packs each: the packed model's with the
    down projection compacted (32 | d_ff; per decode step 4 / 7 / 1
    das_topk / das_ternary_gemm / sparse_attention a layer, per prefill of n
    packs n+3 / 3n+4 / n), less one das_ternary_gemm a decode step and a
    prefill for the 2-matrix MLP (w_in alone beside w_out)."""
    counts = _packed_counts(n_l, steps, packs, dense_down=False)
    if mlp:
        counts["das_ternary_gemm"] -= n_l * (steps + len(packs))
    return counts


def _took(label: str, t0: float, phase: str = "serve") -> float:
    """Log the seconds since t0 that a path of a phase took; returns now."""
    now = time.perf_counter()
    log(f"[{phase}] {label} path done in {now - t0:.1f} s")
    return now


# host events that torch's own profiler tables leave out
_HIDDEN_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


class _Trace:
    """A torch.profiler run read once from its raw (kineto) events.

    ``key_averages()`` and ``events()`` build a Python object a record and
    a tree of them: ~1 min for an eager decode trace or a training step of
    ~40000 kernels.  This reads what the script needs in one pass, with the
    same rules: device kernels by (demangled) name with their time and the
    op that launched each (its correlation id), but not the device-side
    spans of ``record_function`` ranges, which ``key_averages()`` counts as
    device time (a range over 20 ms of kernels adds 20 ms); host events nested by
    thread, time inside time (a launch on the thread of the op it serves,
    async events left out), each one's parent and self time (its time less
    its children's), a child that repeats its only-child parent's name
    counted once, as the profiler's tables merge them."""

    def __init__(self, prof):
        import torch
        demangle = getattr(torch._C, "_demangle", lambda n: n)
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        names: dict = {}
        self.kernels = []             # (name, us, the launching op's correlation id)
        self.annotations = 0          # device-side spans of record_function ranges, left out
        host = []                     # records, below
        for e in prof.profiler.kineto_results.events():
            raw = e.name()
            if raw in _HIDDEN_EVENTS:
                continue
            name = names.get(raw)
            if name is None:
                name = names[raw] = demangle(raw) if len(raw) > 1 else raw
            start = e.start_ns()
            end = start + e.duration_ns()
            dev = e.device_type()
            if dev == cuda:
                if e.is_user_annotation():    # a record_function range's span
                    self.annotations += 1
                    continue
                self.kernels.append((name, (end - start) / 1e3, e.linked_correlation_id()))
            elif dev == cpu and not e.is_async() and e.start_thread_id() == e.end_thread_id():
                # name, thread, start, end, sequence nr, forward thread, id,
                # linked id, parent, children's time, children
                host.append([name, e.start_thread_id(), start, end, e.sequence_nr(),
                             e.fwd_thread_id(), e.correlation_id(), e.linked_correlation_id(),
                             None, 0, 0])
        self.ops = {r[6]: r for r in host if r[7] == 0}
        for r in host:
            if r[7] > 0 and r[7] in self.ops:
                r[1] = self.ops[r[7]][1]
        host.sort(key=lambda r: (r[1], r[2], -r[3]))
        stack: list = []
        for r in host:
            while stack and (stack[-1][1] != r[1] or r[2] >= stack[-1][3]
                             or r[3] > stack[-1][3]):
                stack.pop()
            if stack:
                r[8] = stack[-1]
                stack[-1][9] += r[3] - r[2]
                stack[-1][10] += 1
            stack.append(r)
        self.host = host
        self.forward = {}             # (thread, sequence nr) -> the forward op
        for r in sorted(host, key=lambda r: r[2]):
            if r[4] >= 0 and "Backward" not in r[0] and not r[0].startswith("autograd::"):
                self.forward.setdefault((r[1], r[4]), r)

    def device_times(self) -> dict:
        """Device time (us) by kernel name."""
        by_name: dict = {}
        for name, us, _ in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + us
        return by_name

    def host_self(self) -> dict:
        """{host event name: (self time us, count)}."""
        out: dict = {}
        for r in self.host:
            t, n = out.get(r[0], (0.0, 0))
            dup = r[8] is not None and r[8][0] == r[0] and r[8][10] == 1
            out[r[0]] = (t + (r[3] - r[2] - r[9]) / 1e3, n + (0 if dup else 1))
        return out

    def context(self, r, ranges: dict, memo: dict, depth: int = 0) -> str:
        """The context of host record r: the first of ``ranges`` met going up
        from r, a backward op taking its forward op's (the same sequence
        number on the forward thread), else "other"."""
        key = (id(r), depth)
        if key in memo:
            return memo[key]
        chain, out = [], "other"
        while r is not None:
            if (id(r), depth) in memo:
                out = memo[(id(r), depth)]
                break
            chain.append(id(r))
            if r[0] in ranges:
                out = ranges[r[0]]
                break
            if depth < 4 and r[4] >= 0 and ("Backward" in r[0] or r[0].startswith("autograd::")):
                f = self.forward.get((r[5], r[4]))
                if f is not None and f is not r:
                    out = self.context(f, ranges, memo, depth + 1)
                    break
            r = r[8]
        for i in chain:
            memo[(i, depth)] = out
        return out


# device kernels by class: the port's own (namespace tenet) and PyTorch's glue
GLUE_CLASSES = ("tenet kernels", "elementwise", "copy", "index", "reduce", "other")


def _glue_class(kernel_name: str) -> str:
    if "tenet::" in kernel_name:
        return "tenet kernels"
    for cat, keys in (("copy", ("copy",)), ("index", ("index", "gather", "scatter")),
                      ("reduce", ("reduce", "norm")), ("elementwise", ("elementwise",))):
        if any(key in kernel_name for key in keys):
            return cat
    return "other"


# the MoE path's device kernels by class; cuBLAS's matmuls are named by their
# tile configurations (sm90_xmma_gemm_*, nvjet_*, cutlass kernels)
MOE_CLASSES = ("twd_decode", "copy+multiply (dequantising pass)", "cuBLAS matmuls",
               "das_ternary_gemm", "attention", "das_topk", "other glue")


def _moe_class(kernel_name: str) -> str:
    """The class of a device kernel on the MoE path: the expert stacks'
    twd_decode; the copies and multiplies, which are the dequantising pass
    (trits to bf16, times the per-expert scale) but for a few us of glue;
    cuBLAS's matmuls (the experts', the router's and the head's); the
    port's packed GEMMs (q/k/v/o), attention and DAS step; the rest."""
    if "twd_decode" in kernel_name:
        return "twd_decode"
    if _is_attention(kernel_name):
        return "attention"
    if "das_topk" in kernel_name:
        return "das_topk"
    if "tenet::" in kernel_name:
        return "das_ternary_gemm"
    if any(k in kernel_name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")):
        return "cuBLAS matmuls"
    if "copy" in kernel_name or "MulFunctor" in kernel_name:
        return "copy+multiply (dequantising pass)"
    return "other glue"


# the SSM paths' device kernels by class: the packed GEMMs and the DAS step
# (the port's kernels), cuBLAS's matmuls (the float32 LoRAs, the head, the
# linear attention's chunk and state products), the copies (state writes,
# concatenations), and the rest: the linear attention's and the recurrent
# state's elementwise glue, the mixes, the norms
SSM_CLASSES = ("das_ternary_gemm", "das_topk", "cuBLAS matmuls", "copies",
               "linear-attention and state glue")


def _ssm_class(kernel_name: str) -> str:
    if "das_topk" in kernel_name:
        return "das_topk"
    if "tenet::" in kernel_name:
        return "das_ternary_gemm"
    if any(k in kernel_name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")):
        return "cuBLAS matmuls"
    if "copy" in kernel_name:
        return "copies"
    return "linear-attention and state glue"


# the hybrid path's device kernels by class: the port's kernels; cuBLAS's
# matmuls (the SSD einsums of the replay row, the fold and the prefill's
# chunks, wb / wc / wdt, the tied head); the copies (einsum operands
# permuted, casts, the conv's state); the buffer writes and row gathers
# (index kernels); and the rest, the SSD's and the blocks' elementwise glue
HYBRID_CLASSES = ("das_ternary_gemm", "das_topk", "sparse_attention", "cuBLAS matmuls",
                  "copies", "index (buffer writes, row gathers)",
                  "SSD and other elementwise glue")


def _hybrid_class(kernel_name: str) -> str:
    if "das_topk" in kernel_name:
        return "das_topk"
    if _is_attention(kernel_name):
        return "sparse_attention"
    if "tenet::" in kernel_name:
        return "das_ternary_gemm"
    if any(k in kernel_name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")):
        return "cuBLAS matmuls"
    if "copy" in kernel_name:
        return "copies"
    if any(k in kernel_name for k in ("index", "gather", "scatter")):
        return "index (buffer writes, row gathers)"
    return "SSD and other elementwise glue"


# the stub-frontend paths' device kernels by class: the port's kernels (the
# packed GEMMs on float32 values), the head's float32 matmul (cuBLAS: the
# step's only matmul), the copies (the float32 K/V cast into the bf16 rings,
# the norm scales upcast, casts) and the rest of the elementwise glue
FRONTEND_CLASSES = ("das_ternary_gemm", "das_topk", "sparse_attention",
                    "the head (cuBLAS matmul)", "copies", "other glue")


def _frontend_class(kernel_name: str) -> str:
    if "das_topk" in kernel_name:
        return "das_topk"
    if _is_attention(kernel_name):
        return "sparse_attention"
    if "tenet::" in kernel_name:
        return "das_ternary_gemm"
    if any(k in kernel_name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")):
        return "the head (cuBLAS matmul)"
    if "copy" in kernel_name:
        return "copies"
    return "other glue"


CLASSES = {"glue": (_glue_class, GLUE_CLASSES), "moe": (_moe_class, MOE_CLASSES),
           "ssm": (_ssm_class, SSM_CLASSES), "hybrid": (_hybrid_class, HYBRID_CLASSES),
           "frontend": (_frontend_class, FRONTEND_CLASSES)}


def _by_class(by_name: dict, classes: str) -> dict:
    """Device time by class: the port's kernels and PyTorch's glue
    (_glue_class), the MoE path's classes (_moe_class) or the SSM paths'
    (_ssm_class)."""
    cls, cats = CLASSES[classes]
    return {cat: sum(dt for name, dt in by_name.items() if cls(name) == cat) for cat in cats}


# the training step's device kernels by class (Smoke._train_busy)
TRAIN_CLASSES = ("cuBLAS GEMMs, linears and logits", "cuBLAS GEMMs, attention (float32)",
                 "cuBLAS GEMMs, chunk scans (float32)", "cuBLAS GEMMs, experts", "das_topk",
                 "attention glue", "chunk-scan glue", "MoE routing, dispatch and combine",
                 "fake-quant and other elementwise", "optimizer")
# the profiler ranges of the training step (record_function in the port) and
# what they hold: a kernel launched under one, or by the backward of an op
# launched under one, is that context's
TRAIN_RANGES = {"adamw_step": "optimizer", "flash_masked": "attention",
                "chunked_linear_attn": "scan", "mamba_ssd": "scan", "moe_dispatch": "moe"}
TRAIN_GEMM_CLASS = {"attention": "cuBLAS GEMMs, attention (float32)",
                    "scan": "cuBLAS GEMMs, chunk scans (float32)",
                    "moe": "cuBLAS GEMMs, experts"}
TRAIN_GLUE_CLASS = {"optimizer": "optimizer", "attention": "attention glue",
                    "scan": "chunk-scan glue", "moe": "MoE routing, dispatch and combine"}


def _das_inputs(cfg, kind: str) -> int:
    """The DAS inputs of one training block of ``kind``, each one das_topk
    call forward: q/k/v and o, then gate/up and down (a MLP's w_in and
    w_out) or the MoE's experts' input (its shared expert's gate and up
    share it; its down is one more); gla's q/k/v/g and wo, then the same
    FFN or MoE; mamba's wz/wx and wo; rwkv's r, k, v, g, wo, ck, cv, cr."""
    if kind == "mamba":
        return 2
    if kind == "rwkv":
        return 8
    if cfg.moe is None:
        ffn = 2
    else:
        ffn = 1 + (1 if cfg.moe.n_shared else 0)
    return 2 + ffn


def _is_gemm(kernel_name: str) -> bool:
    """Whether a device kernel is one of cuBLAS's matmuls (named by their
    tile configurations: sm90_xmma_gemm_*, nvjet_*, cutlass kernels)."""
    return any(k in kernel_name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK"))


def _is_attention(kernel_name: str) -> bool:
    """Whether a device kernel is one of sparse_attention's classes (or the
    single class of trees before them)."""
    return any(k in kernel_name for k in ("attn_prefill", "split_decode_kernel",
                                          "sparse_attn_kernel"))


def _dist_world(rank: int, jobs) -> list:
    """One rank of the dist phase's world: each (job, smooth) of ``jobs`` in
    turn, a serving job through ``serve_rank`` (the MoE experts' int8
    fake-quant the identity where ``smooth``, as ``Smoke._moe_width_parity``
    makes it), a ``_TrainJob`` through ``_DIST_TRAIN[job.kind]``; the
    card's cache emptied between jobs."""
    import torch

    from repro_torch.core import ternary as tq
    from repro_torch.launch import serve as cli
    quant, out = tq.int8_fake_quant, []
    try:
        for job, smooth in jobs:
            tq.int8_fake_quant = (lambda x: x) if smooth else quant
            if isinstance(job, _TrainJob):
                out.append(_DIST_TRAIN[job.kind](rank, job))
            else:
                out.append(cli.serve_rank(rank, job))
            torch.cuda.empty_cache()
    finally:
        tq.int8_fake_quant = quant
    return out


@dataclasses.dataclass(frozen=True)
class _TrainJob:
    """A job of the dist phase's trainer (``Smoke._dist_train_jobs``):
    ``kind`` (d, e, f or g), the config, the files the parent wrote
    (weights, batches, one-rank references, the checkpoint directory), the
    steps and the schedule."""
    kind: str
    cfg: object
    files: dict
    steps: int
    lr: float
    warmup: int


@contextlib.contextmanager
def _card_peak(torch, every: float = 0.02):
    """Samples the card's used memory (every process's: total less free)
    every ``every`` seconds on a thread while the block runs; yields a dict
    whose "peak" (bytes) and "at" (seconds into the block) it fills."""
    import threading
    out, stop, t0 = {"peak": 0, "at": 0.0}, threading.Event(), time.perf_counter()

    def sample():
        while not stop.is_set():
            free, total = torch.cuda.mem_get_info()
            if total - free > out["peak"]:
                out.update(peak=total - free, at=time.perf_counter() - t0)
            stop.wait(every)
    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield out
    finally:
        stop.set()
        th.join()


def _union_ms(spans) -> float:
    """The length in ms of the union of (start_ns, end_ns) spans."""
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def _rank_setup(rank: int):
    """(torch, this rank's card) with the card made current."""
    import torch

    from repro_torch.distributed.launch import rank_device
    dev = rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    return torch, dev


def _worst(got, want, rel: bool = True) -> float:
    """The largest |got - want| over two trees' leaves (``want`` on the
    host), each relative to its leaf's max |want| where ``rel``."""
    from repro_torch.tree import leaves
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want), strict=True):
        b = b.to(a.device).float()
        err = float((a.float() - b).abs().max())
        worst = max(worst, err / max(float(b.abs().max()), 1e-30) if rel else err)
    return worst


def _torch_ties():
    """tests/torch_ties.py: ``Replay``, the tie rule of the training tests."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.append(str(ROOT / "tests"))
    import torch_ties
    return torch_ties


def _train_d(rank: int, job: _TrainJob) -> dict:
    """(d): bitnet-1.3b at dp 2 x tp 2 with ZeRO-1 from the parent's
    weights: step 1's loss and its gradients (each rank's part summed over
    "dp", gathered over "model") against one rank's, then the steps (the
    state after step 1 gathered and saved by rank 0 for (g)) and the params
    after them against one rank's; each pass takes one rank's rounding
    decisions at near ties (``torch_ties.Replay``)."""
    t0 = time.perf_counter()
    torch, dev = _rank_setup(rank)
    from repro_torch import checkpoint as ckpt
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.plan import Topology
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.tree import leaves, unflatten
    cfg, f = job.cfg, job.files
    mesh = Topology(dp=2, tp=2).build_mesh()
    sh = TR.train_shardings(mesh, torch.load(f["params"], mmap=True), cfg=cfg, device=dev)
    bs = torch.load(f["batches"], weights_only=False)
    rt = TR.make_runtime(mesh, TRAIN_BATCH)
    recs = torch.load(f["ties"], mmap=True)
    ties = _torch_ties().Replay(TR.batch_rows(mesh, TRAIN_BATCH), MD.model_bounds(cfg, 2),
                                mesh.model_index)
    try:
        ties.force(recs[0])
        _, aux, grads = TR.loss_and_grads(sh.params, cfg, sh.batch(bs[0]), rt)
        grads = MD.gather_params(grads, cfg, mesh)
        grads = unflatten(grads, [C.psum(g.float(), mesh, "dp") for g in leaves(grads)])
        ref = torch.load(f["ref"], mmap=True)
        out = {"loss": float(aux["loss"]), "ref_loss": ref["loss"],
               "grad_err": _worst(grads, ref["grads"])}
        del grads, ref
        step = TR.make_train_step(cfg, rt, peak_lr=job.lr, warmup=job.warmup, total=job.steps)
        p, o, losses = sh.params, sh.opt, []
        for s, b in enumerate(bs):
            ties.force(recs[s])
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            if s == 0:
                state = TR.gather_state(mesh, p, o, cfg=cfg)
                if rank == 0:
                    ckpt.save_checkpoint(f["ckpt"], 1, state)
                del state
    finally:
        ties.restore()
    final, want = MD.gather_params(p, cfg, mesh), torch.load(f["params2"], mmap=True)
    out.update(ties=(ties.ok(), ties.summary()), losses=losses,
               param_err=_worst(final, want, rel=False),
               param_rel=_worst(final, want), seconds=time.perf_counter() - t0)
    torch.distributed.barrier()              # the checkpoint is whole before (g) reads it
    return out


def _train_g(rank: int, job: _TrainJob) -> dict | None:
    """(g): (d)'s checkpoint after step 1 restored onto Topology(dp=1,
    tp=2), ranks 2 and 3 lost, and step 2 taken there (one rank's ties
    taken as in (d)): the params against the uninterrupted one-rank step
    2."""
    t0 = time.perf_counter()
    torch, dev = _rank_setup(rank)
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.distributed.plan import ShardingPlan, Topology
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.tree import leaves
    cfg, f = job.cfg, job.files
    topo = Topology(dp=1, tp=2)
    mesh = topo.build_mesh()
    if not mesh.member:
        return None
    full = torch.load(f["params"], mmap=True)
    plan = ShardingPlan.for_tree(full, topo, validate=False, cfg=cfg)
    tree, restored = elastic_restore(f["ckpt"], mesh, plan, device=dev)
    step = TR.make_train_step(cfg, TR.make_runtime(mesh, TRAIN_BATCH), peak_lr=job.lr,
                              warmup=job.warmup, total=job.steps)
    bs = torch.load(f["batches"], weights_only=False)
    ties = _torch_ties().Replay(TR.batch_rows(mesh, TRAIN_BATCH), MD.model_bounds(cfg, 2),
                                mesh.model_index)
    try:
        ties.force(torch.load(f["ties"], mmap=True)[restored])
        p, _, m = step(tree["params"], tree["opt"], bs[restored])
    finally:
        ties.restore()
    return {"restored": restored, "topology": topo, "loss": float(m["loss"]),
            "ties": (ties.ok(), ties.summary()),
            "moments": sorted({tuple(x.shape) for x in leaves(tree["opt"].m)})[:2],
            "param_err": _worst(MD.gather_params(p, cfg, mesh),
                                torch.load(f["params2"], mmap=True), rel=False),
            "seconds": time.perf_counter() - t0}


def _train_f(rank: int, job: _TrainJob) -> dict:
    """(f): the GPipe pipeline over Topology(pods=2, dp=1, tp=2), one block
    a pod on its tp 2 shard: the output and the stage's gradients
    (gathered over "model") against the sequential blocks on one rank;
    then the int8 error-feedback mean over the 2 pods of the gradients of
    (d)'s weights and batch with the ternary stack off (each pod the
    gradient of its batch rows) against the exact mean."""
    t0 = time.perf_counter()
    torch, dev = _rank_setup(rank)
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.plan import Topology
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.models import transformer as T
    from repro_torch.models.ternary_linear import shard_scales
    from repro_torch.optim.grad import compressed_crosspod_mean, zeros_error
    from repro_torch.tree import leaves, unflatten
    cfg, f = job.cfg, job.files
    mesh = Topology(pods=2, dp=1, tp=2).build_mesh()
    ref = torch.load(f["pipe"], mmap=True)
    bp = MD.shard_params(ref["blocks"][mesh.pod_index], cfg, mesh, dev)
    flat = [t.requires_grad_() for t in leaves(bp)]
    lcfg, rt = MD.local_config(cfg, mesh), TR.make_runtime(mesh, TRAIN_BATCH)
    C.reset_counts()
    y = pipeline_apply(lambda p, xm: T.block_train(p, lcfg, xm, "attn", None, rt),
                       shard_scales(bp, mesh), ref["x"].to(dev), mesh=mesh,
                       n_microbatches=ref["x"].shape[0])
    grads = torch.autograd.grad((y * ref["ct"].to(dev)).sum(), flat)
    hops = C.counts["send"]
    out = {"pod": mesh.pod_index, "ticks": ref["x"].shape[0] + 1, "hops": hops,
           "y_err": _worst(y.detach(), ref["y"]),
           "g_err": _worst(MD.gather_params(unflatten(bp, list(grads)), cfg, mesh),
                           ref["grads"][mesh.pod_index])}
    del bp, flat, grads, y, ref
    p = MD.shard_params(torch.load(f["params"], mmap=True), cfg, mesh, dev)
    bs = torch.load(f["batches"], weights_only=False)
    _, _, g = TR.loss_and_grads(p, cfg, {k: v[TR.batch_rows(mesh, TRAIN_BATCH)]
                                         for k, v in bs[0].items()}, rt)
    g = unflatten(g, [x.float() for x in leaves(g)])
    exact = unflatten(g, [C.psum(x, mesh, "pod") / 2 for x in leaves(g)])
    mean, err = compressed_crosspod_mean(g, zeros_error(g), mesh)
    out.update(crosspod=_worst(mean, exact), residual=max(float(e.abs().max())
                                                           for e in leaves(err)),
               seconds=time.perf_counter() - t0)
    return out


def _train_e(rank: int, job: _TrainJob) -> dict:
    """(e): bitnet-1.3b as trained (bf16, DAS on, remat) at dp 2 x tp 2 with
    ZeRO-1, the steps of 4 x 2048 tokens from the parent's weights: each
    step's loss, host ms, kernel launches, das_train_mask's calls and
    collectives; the last step under the profiler (device busy ms, its
    das_topk kernels); peak memory and the card's use."""
    torch, dev = _rank_setup(rank)
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.plan import Topology
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TR
    from repro_torch.models import ternary_linear as TL
    cfg, f = job.cfg, job.files
    mesh = Topology(dp=2, tp=2).build_mesh()
    sh = TR.train_shardings(mesh, torch.load(f["params"], mmap=True), cfg=cfg, device=dev)
    state, allocated = _tree_bytes((sh.params, sh.opt)), torch.cuda.memory_allocated()
    bs = torch.load(f["batches"], weights_only=False)
    step = TR.make_train_step(cfg, TR.make_runtime(mesh, TRAIN_BATCH), peak_lr=job.lr,
                              warmup=job.warmup, total=job.steps)
    calls, orig = [0], TL.das_train_mask

    def counted(x, tc):
        calls[0] += 1
        return orig(x, tc)
    TL.das_train_mask = counted
    p, o, steps, prof = sh.params, sh.opt, [], None
    del sh
    torch.cuda.reset_peak_memory_stats()
    try:
        for s, b in enumerate(bs):
            last = s == len(bs) - 1
            ops.reset_launches()
            C.reset_counts()
            calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                  if last else contextlib.nullcontext()) as pr:
                p, o, m = step(p, o, b)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            prof = pr if last else prof
            steps.append({"loss": float(m["loss"]), "ms": ms, "launches": dict(ops.launches),
                          "mask_calls": calls[0], "wire": dict(C.wire_bytes),
                          "collectives": {k: (round(v, 3) if isinstance(v, float) else v)
                                          for k, v in C.counts.items()}})
    finally:
        TL.das_train_mask = orig
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and not e.is_user_annotation()]
    copies = [e for e in events if e.name().startswith(("Memcpy", "Memset"))]
    free, total = torch.cuda.mem_get_info()
    return {"steps": steps, "busy_ms": sum(e.duration_ns() for e in events) / 1e6,
            "copy_ms": sum(e.duration_ns() for e in copies) / 1e6,
            "spans": sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events),
            "profiled_topk": sum(1 for e in events if "das_topk" in e.name()),
            "peak": torch.cuda.max_memory_allocated(), "card_used": total - free,
            "state": state, "allocated": allocated, "position": mesh.model_index
            + mesh.topology.tp * mesh.dp_index}


def _dump(tree, path: str) -> None:
    """A tree's leaves, in ``leaves`` order, as raw bytes in one file (the
    dist phase's large references: no archive, so the ranks read their cuts
    through ``_load_dump``'s memory map)."""
    from repro_torch.tree import leaves
    with open(path, "wb") as f:
        for x in leaves(tree):
            x.detach().contiguous().cpu().numpy().tofile(f)


def _load_dump(path: str, template):
    """``_dump``'s file as a tree of host tensors mapped from the file, in
    the structure, shapes and dtypes of ``template`` (e.g. the config's
    master tree on the meta device)."""
    import numpy as np
    import torch

    from repro_torch.tree import leaves, unflatten
    flat = np.memmap(path, dtype=np.uint8, mode="r")
    out, off = [], 0
    for t in leaves(template):
        n = t.numel() * t.element_size()
        out.append(torch.from_numpy(flat[off:off + n]).view(t.dtype).view(t.shape))
        off += n
    if off != flat.size:
        raise ValueError(f"{path}: {flat.size} bytes, the template {off}")
    return unflatten(template, out)


@contextlib.contextmanager
def _counting_drops(drops: list):
    """Append each MoE dispatch's dropped copies (over its capacity) to
    ``drops`` while inside."""
    from repro_torch.models import moe as MOE
    orig = MOE.dispatch_compute

    def counted(x_tok, x_in, weights, router, cfg, capacity, *rest):
        out, counts = orig(x_tok, x_in, weights, router, cfg, capacity, *rest)
        drops.append(int((counts - capacity).clamp(min=0).sum()))
        return out, counts
    MOE.dispatch_compute = counted
    try:
        yield drops
    finally:
        MOE.dispatch_compute = orig


def _tree_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def _norm_offset(path: str) -> bool:
    """Whether a master leaf is an rmsnorm scale, which the model applies as
    1 + scale (``layers.rmsnorm``)."""
    parts = path.split("/")
    return len(parts) > 1 and parts[-1] == "scale" and "norm" in parts[-2]


def _worst_of(got, want, maxes) -> dict:
    """The largest |got - want| of a leaf over the trees' leaves, each over
    the leaf's max |.| in ``maxes`` (of the whole leaf, not the cut), as
    {"rel": it, "leaf": the leaf's index and path, "abs": the difference,
    "at": the element's flat index in the rank's cut, "got", "want": the
    values there, "next": the next two leaves}; ``want`` on the host, moved to the device a leaf at a
    time."""
    from repro_torch.tree import leaves, leaves_with_paths
    worst, rels = {"rel": -1.0}, []
    for i, ((path, a), b, m) in enumerate(zip(leaves_with_paths(got), leaves(want), maxes,
                                              strict=True)):
        b = b.to(a.device).float()
        d = (a.float() - b).abs().flatten()
        j = int(d.argmax())
        rels.append((float(d[j]) / max(m, 1e-30), path))
        if rels[-1][0] > worst["rel"]:
            worst = {"rel": rels[-1][0], "leaf": (i, path), "abs": float(d[j]),
                     "at": j, "got": float(a.flatten()[j]), "want": float(b.flatten()[j])}
    worst["next"] = [(p, f"{r:.3e}") for r, p in sorted(rels, reverse=True)[1:3]]
    return worst


def _train_h(rank: int, job: _TrainJob) -> dict:
    """(h): qwen3-moe-30b-a3b at Topology(dp=2, tp=2), each rank its 64
    experts and its ZeRO-1 slices, from the parent's weights: its loss, its
    gradients (its part: half its data half's gradient) against its cut of
    the reference's half, then the steps and its params against the cut of
    the reference's; each pass takes its data half's recorded decisions at
    near ties (``torch_ties.Replay``: rounding, routing, expert scales)."""
    t0 = time.perf_counter()
    torch, dev = _rank_setup(rank)
    from repro_torch.distributed.plan import Topology
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.tree import leaves
    cfg, f = job.cfg, job.files
    mesh = Topology(dp=2, tp=2).build_mesh()
    template = MD.init_params(cfg, device="meta")
    sh = TR.train_shardings(mesh, _load_dump(f["params"], template), cfg=cfg, device=dev)
    state = _tree_bytes((sh.params, sh.opt))
    bs = torch.load(f["batches"], weights_only=False)
    rt = TR.make_runtime(mesh, len(bs[0]["inputs"]))
    half = mesh.dp_index
    recs, maxes = torch.load(f["ties"], mmap=True), torch.load(f["maxes"])
    ties = _torch_ties().Replay(slice(None), MD.model_bounds(cfg, 2), mesh.model_index)
    drops, stages = [], {"load": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        ties.force(recs["grad"][half])
        t1 = time.perf_counter()
        with _counting_drops(drops):
            _, aux, grads = TR.loss_and_grads(sh.params, cfg, sh.batch(bs[0]), rt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = MD.shard_params(_load_dump(f["grads"][half], template), cfg, mesh)
        grad_err = _worst_of(grads, want, maxes["grads"][half])["rel"]
        stages.update(grads=t2 - t1, compare=time.perf_counter() - t2)
        del grads, want
        step = TR.make_train_step(cfg, rt, peak_lr=job.lr, warmup=job.warmup, total=job.steps)
        p, o, losses = sh.params, sh.opt, []
        del sh
        for s, b in enumerate(bs):
            ties.force(recs["steps"][s][half])
            t1 = time.perf_counter()
            with _counting_drops(drops):
                p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            stages[f"step {s}"] = time.perf_counter() - t1
    finally:
        ties.restore()
    want = MD.shard_params(_load_dump(f["params2"], template), cfg, mesh)
    worst = _worst_of(p, want, maxes["params2"])
    i = worst["leaf"][0]
    if tuple(leaves(p)[i].shape) == tuple(leaves(template)[i].shape):   # a whole leaf: the
        g = [leaves(_load_dump(f["grads"][h], template))[i] for h in (0, 1)]  # reference's
        g = (g[0] + g[1]).flatten()                                     # step-0 gradient there
        worst["grad0"] = float(g[worst["at"]].abs() / g.abs().max())
    e0, e1 = MD.model_bounds(cfg, 2)["experts"][mesh.model_index]
    return {"half": half, "experts": (e0, e1), "loss": float(aux["loss"]),
            "grad_err": grad_err, "losses": losses, "param_err": worst["rel"],
            "param_worst": worst,
            "topk": ops.launches["das_topk"], "drops": drops, "state": state,
            "ties": (ties.ok(), ties.summary()), "peak": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved(),
            "stages": {k: round(v, 1) for k, v in stages.items()},
            "seconds": time.perf_counter() - t0}


_DIST_TRAIN = {"d": _train_d, "e": _train_e, "f": _train_f, "g": _train_g, "h": _train_h}


def _nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def turns(parent: Path, seed: int) -> None:
    """This script's times and profile phases on the package of ``parent``
    and of this tree in turns on this card (parent, this, this, parent):
    each turn a process of its own on its tree's package (``--src``) and
    that tree's kernel build, so both run the same shapes; prints each run's
    [times] and [profile] lines."""
    for i, tree in enumerate((parent, ROOT, ROOT, parent), 1):
        label = "parent" if tree == parent else "this"
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--phases",
                              "device,build,times,profile", "--seed", str(seed),
                              "--src", str(tree / "src")],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        if res.returncode:
            raise RuntimeError(f"turn {i} ({label}) failed:\n{res.stdout[-3000:]}"
                               f"{res.stderr[-3000:]}")
        for line in res.stdout.splitlines():
            if line.startswith(("[times]", "[profile]")):
                log(f"[turns] {i} {label}: {line}")
        log(f"[turns] {i} {label} took {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another tree (the parent commit): after the "
                         "phases, time both trees' kernels in turns")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory that holds the repro_torch package to drive "
                         "(default: this tree's src)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(OPTIONAL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    src = args.src.resolve()
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke(torch, args.seed)
    try:
        log(f"[device] {_nvidia_smi()}")
        log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        for phase in phases:
            if phase != "device":
                t0 = time.perf_counter()
                getattr(smoke, f"phase_{phase}")()
                log(f"[{phase}] done in {time.perf_counter() - t0:.1f} s")
        if args.parent is not None:
            turns(args.parent.resolve(), args.seed)
        if set(PHASES) <= set(phases):
            kernels = []
            for name, (source, replaces) in KERNEL_INFO.items():
                kernels.append({"name": name, "route": "cuda", "source": source,
                                "replaces": replaces,
                                "launches": smoke.launches[name],
                                "max_abs_err": smoke.errs[name], **smoke.timed[name]})
            print(json.dumps({"kernels": kernels}), flush=True)
    except Exception:  # a failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
