"""Dry run: every (arch x shape x mesh) cell's step on the ``meta`` device.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's step
under the production mesh from shape stand-ins.  The port runs the step
itself, for one rank, on ``meta`` tensors (shapes and dtypes, no storage,
no kernel) under a virtual mesh (``Topology.virtual_mesh``: the rank's
position with no process group; every collective exchanges nothing and is
counted as the real one is).  For each cell this script:

  1. builds the full-size config (a variant's edits applied) and the
     production topology (16 x 16 on one pod, 2 x 16 x 16 on two),
  2. builds the rank's state on ``meta`` (``init_params`` / ``init_serving``
     draw nothing): for train its master shard and ZeRO-1 moment slices
     (``launch.train.train_shardings``), for prefill and decode its packed
     serving shard (``models.model.shard_model``) and, for decode, its
     caches,
  3. runs the step the JAX package lowers: train one ``make_train_step``
     (forward, backward, the ZeRO-1 AdamW update), prefill
     ``models.model.prefill`` of ``seq_len`` tokens into caches of
     ``seq_len + 1``, decode one ``decode_step`` against caches of
     ``seq_len``,
  4. counts for the rank: FLOPs (``torch.utils.flop_counter.
     FlopCounterMode``: the matmuls, as XLA counts the dots; the plain
     versions the kernel wrappers take for meta tensors are masked-dense,
     like the JAX package's lowered path, so DAS does not discount them),
     op-level bytes (every aten op's inputs plus outputs, views and the
     collectives' own ops left out, ``OpBytes``: like XLA's "bytes
     accessed", an upper bound on the HBM traffic, not a measurement),
     collective bytes by kind under the JAX package's wire convention
     (``distributed.collectives.wire_bytes``), and the rank's exact state
     bytes (train: its params, its ZeRO-1 moment slices and the step;
     prefill: its serving weights; decode: its serving weights and caches),
  5. derives the three roofline terms at an H100's rates
     (``core.perfmodel.H100_SXM``: 989 TFLOP/s dense bf16, 3.35 TB/s) and a
     link rate of 50 GB/s a GPU (InfiniBand NDR, 400 Gb/s: a 16-way "model"
     axis spans two 8-GPU nodes), and ``launch.analytic.cell_analytic``'s
     terms at the same rates,
  6. appends a JSON record (``report.py`` renders them).

Data ranks are symmetric, but the last "model" position holds the dense
tails of the DAS cuts (``plan.shard_bounds``), so every cell runs positions
0 and tp - 1 and records each count's larger value.  The state bytes are
the rank's own, exact (the JAX package records its total over the
devices).  ``scan_corrected`` is False: the port has no layer scan, so
every layer is counted.  ``lower_s`` / ``compile_s`` hold the host seconds
of the meta build and of the meta run.  A cell the port cannot build goes
to ``failures`` with its error: today the SSM, hybrid and frontend archs
under a Topology, and tp 16 over fewer heads, both waiting for ROADMAP
queue 1, item 2.  The exit code is 1 if any cell fails.

Usage:
  python -m repro_torch.launch.dryrun --arch bitnet-1.3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json --jobs 6
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.configs.shapes import SHAPES, shape_by_name
from repro_torch.core.perfmodel import H100_SXM
from repro_torch.distributed import collectives
from repro_torch.distributed.plan import Topology
from repro_torch.launch import analytic
from repro_torch.launch.train import make_runtime, make_train_step, train_shardings
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.tree import leaves

__all__ = ["ALL_ARCHS", "VARIANTS", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "active_param_count",
           "model_flops", "cache_specs", "Cell", "build_cell", "make_cell", "OpBytes", "measure",
           "run_cell", "main"]

# the JAX package's ``--all``: the first 10 archs of its registry's order
ALL_ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "zamba2-2.7b", "musicgen-medium",
             "gemma2-2b", "minicpm-2b", "gemma3-1b", "stablelm-1.6b", "pixtral-12b",
             "rwkv6-3b")
# the variant tokens (comma-joined), the JAX package's:
#   paper     TWD packed + DAS + LPSA (decode_32k keeps full caches)
#   baseline  int8-resident weights, full attention, no DAS
#   lpsa      ring caches on decode_32k too
#   int8w / bf16w  the serve weight format
#   nodas     DAS off
#   noremat   activation checkpointing off (train)
#   dp        params replicated, the batch over every axis (train: ZeRO-1 over
#             all of them; prefill: the batch on "data" only)
#   dpattn    train: a MoE's experts on "model", every other leaf replicated,
#             the batch over "data" only (``Mesh.experts_only``)
VARIANTS = ("paper", "baseline", "lpsa", "int8w", "bf16w", "nodas", "noremat", "dp", "dpattn")

# an NVIDIA H100 SXM5's dense bf16 rate and HBM3 rate (core/perfmodel.py)
PEAK_FLOPS = H100_SXM.peak_tops_high * 1e12
HBM_BW = H100_SXM.hbm_gbps * 1e9
LINK_BW = analytic.LINK_BW


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: routed top_k + shared only)."""
    if cfg.moe is None:
        return cfg.param_count()
    e = cfg.moe
    total = cfg.param_count()
    all_experts = cfg.n_layers * e.n_experts * 3 * cfg.d_model * e.d_expert
    active = cfg.n_layers * (e.top_k + e.n_shared) * 3 * cfg.d_model * e.d_expert
    return total - all_experts + active


def model_flops(cfg, shape) -> float:
    """6*N*D for training, 2*N*D for serving (active params for MoE)."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: per one new token


def _cache_leaf_spec(name: str, shape: tuple, dp) -> tuple:
    """The JAX package's ``_cache_leaf_spec`` on one layer's cache leaf:
    the slot dim over ``dp``, a head-ish dim over "model" where 16 divides
    it."""
    nd = len(shape)

    def axis_div(i):   # sharding requires exact divisibility by model=16
        return shape[i] % 16 == 0

    spec: list = [None] * nd
    if name in ("k", "v") and nd == 4:
        spec[0] = dp or None
        for cand in (2, 3):     # prefer kv-heads, fall back to head_dim
            if axis_div(cand):
                spec[cand] = "model"
                break
    elif name == "conv" and nd == 3:
        spec = [dp or None, None, "model" if axis_div(2) else None]
    elif name in ("ssm", "wkv", "s") and nd == 4:
        spec[0] = dp or None
        for cand in (1, 2, 3):
            if axis_div(cand):
                spec[cand] = "model"
                break
    elif name in ("shift_t", "shift_c") and nd == 3:
        spec = [dp or None, None, None]
    elif name == "pos":
        spec = [None] * nd
    return tuple(spec)


def cache_specs(cfg, caches: list, dp) -> list:
    """The JAX package's ``cache_specs`` over the port's caches (one dict a
    layer): each leaf's spec tuple."""
    del cfg
    return [{k: _cache_leaf_spec(k, tuple(t.shape), dp) for k, t in layer.items()}
            for layer in caches]


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

class Cell(NamedTuple):
    """One rank's step of a cell on ``meta``: ``run()`` runs it once."""
    run: Callable
    cfg: object
    shape: object
    topology: Topology
    position: int
    state_bytes: int
    serve_sparse: bool


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def variant_tokens(variant: str) -> set:
    """The tokens of a comma-joined variant; ValueError for an unknown one."""
    tokens = set(variant.split(","))
    bad = sorted(tokens - set(VARIANTS))
    if bad:
        raise ValueError(f"unknown variant token(s) {bad}; have {list(VARIANTS)}")
    return tokens


def _variant_config(cfg, tokens: set):
    tern = cfg.ternary
    if "baseline" in tokens:
        cfg = dataclasses.replace(cfg, lpsa=None)
        tern = dataclasses.replace(tern, das=None, serve_format="int8")
    if "int8w" in tokens:
        tern = dataclasses.replace(tern, serve_format="int8")
    if "bf16w" in tokens:
        tern = dataclasses.replace(tern, serve_format="bf16")
    if "nodas" in tokens:
        tern = dataclasses.replace(tern, das=None)
    if "noremat" in tokens:
        cfg = dataclasses.replace(cfg, remat=False)
    return dataclasses.replace(cfg, ternary=tern)


def _variant_topology(topo: Topology, shape, tokens: set) -> Topology:
    """"dp": the params replicated, the batch over every axis in training
    (ZeRO-1 then cuts the moments over all of them), over "data" alone in
    prefill (the "model" ranks repeat the work)."""
    if "dp" not in tokens or shape.kind == "decode":
        return topo
    if shape.kind == "train":
        return Topology(dp=topo.dp * topo.tp, tp=1, pods=topo.pods)
    return Topology(dp=topo.dp, tp=1, pods=topo.pods)


def _rows(topo: Topology, batch: int) -> int:
    """A rank's rows of a batch: its share over the dp axes that divide it."""
    n = 1
    for a in topo.dp_axes_for(batch):
        n *= topo.axis_size(a)
    return batch // n


def build_cell(arch: str, shape_name: str, topology: Topology, *, variant: str = "paper",
               override_layers: int | None = None, position: int = 0) -> Cell:
    """The rank at ``position`` of ``topology`` (the variant's): its state on
    ``meta`` and its step of the cell (``Cell.run``).  Raises ValueError for
    a cell the port cannot build (``models.model.check_shardable``)."""
    cfg = get_config(arch)
    if override_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=override_layers, scan_layers=False)
    shape = shape_by_name(shape_name)
    tokens = variant_tokens(variant)
    serve_sparse = not (shape.name == "decode_32k" and "lpsa" not in tokens)
    if "lpsa" in tokens or shape.name == "long_500k":
        serve_sparse = True
    topo = _variant_topology(topology, shape, tokens)
    cfg = _variant_config(cfg, tokens)
    mesh = topo.virtual_mesh(position)
    if "dpattn" in tokens and shape.kind == "train":
        mesh = mesh.experts_alone()
    else:
        MD.check_shardable(cfg, topo.tp, training=shape.kind == "train")
    return make_cell(cfg, shape, mesh, serve_sparse=serve_sparse)


def make_cell(cfg, shape, mesh, *, serve_sparse: bool = True, device="meta",
              seed: int = 0) -> Cell:
    """The state of ``mesh``'s rank for ``cfg`` at ``shape`` on ``device``
    and its step: on ``meta`` under a virtual mesh (the dry run), or the
    same step on real tensors under a built mesh (seeded weights, token ids
    ``i * 7919 % vocab``), which the tests count alike.  A mesh with
    ``experts_only`` (train) cuts a MoE's experts alone over "model"."""
    dev = torch.device(device)
    topo = mesh.topology
    b, s = shape.global_batch, shape.seq_len
    dt = L.torch_dtype(cfg.dtype)

    def ids(*shp):
        n = 1
        for d in shp:
            n *= d
        return (torch.arange(n, device=dev) * 7919 % cfg.vocab).reshape(shp).to(torch.int32)

    if shape.kind == "train":
        shards = train_shardings(mesh, MD.init_params(cfg, seed=seed, device=dev), cfg=cfg)
        step = make_train_step(cfg, make_runtime(mesh, b, serve_sparse=serve_sparse))
        batch = {"inputs": ids(b, s), "labels": ids(b, s)}
        return Cell(lambda: step(shards.params, shards.opt, batch), cfg, shape, topo,
                    mesh.model_index, _nbytes((shards.params, shards.opt)), serve_sparse)

    model = MD.shard_model(MD.init_serving(cfg, seed=seed, device=dev), mesh, dev)
    weights = _nbytes(list(model.state_dict().values()))
    rows = _rows(topo, b)
    if shape.kind == "prefill":
        inputs = ids(rows, s)

        def run():
            return MD.prefill(model, inputs, max_len=s + 1, serve_sparse=serve_sparse)
        return Cell(run, cfg, shape, topo, mesh.model_index, weights, serve_sparse)

    caches = MD.init_caches(model.cfg, rows, s, device=dev, dtype=dt,
                            serve_sparse=serve_sparse)
    tok = ids(rows).long()
    t = torch.full((rows,), s - 1, dtype=torch.int64, device=dev)

    def run():
        return MD.decode_step(model, caches, tok, t, serve_sparse=serve_sparse)
    return Cell(run, cfg, shape, topo, mesh.model_index, weights + _nbytes(caches),
                serve_sparse)


# --------------------------------------------------------------------------
# counting
# --------------------------------------------------------------------------

class OpBytes(TorchDispatchMode):
    """Op-level bytes: for every aten op dispatched, its tensor inputs' and
    outputs' bytes (views, which move nothing, and the ops a collective
    runs inside its exchange, counted apart, left out): the analogue of
    XLA's "bytes accessed", an upper bound on the HBM traffic, not a
    measurement of it."""

    SKIP = ("c10d", "_c10d_functional")

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.namespace not in self.SKIP and not func.is_view
                and not collectives.exchanging()):
            self.ops += 1
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def measure(fn: Callable) -> dict:
    """Run ``fn()`` once under the counters -> {"flops", "bytes", "ops",
    "collectives" (wire bytes by kind), "collective_counts", "seconds"
    (host)}."""
    collectives.reset_counts()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, OpBytes() as ob:
        fn()
    return {"flops": int(fc.get_total_flops()), "bytes": ob.bytes, "ops": ob.ops,
            "collectives": dict(collectives.wire_bytes),
            "collective_counts": {k: v for k, v in collectives.counts.items()
                                  if k in ("all_reduce", "gather", "reduce_scatter",
                                           "all_gather", "send", "recv")},
            "seconds": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, variant: str = "paper",
             verbose: bool = True) -> dict:
    """One cell's record: positions 0 and tp - 1 of the production topology
    (the variant's), each count the larger of the two."""
    topo = Topology.production(multi_pod=multi_pod)
    tp = _variant_topology(topo, shape_by_name(shape_name), variant_tokens(variant)).tp
    per = []
    for pos in sorted({0, tp - 1}):
        t0 = time.perf_counter()
        cell = build_cell(arch, shape_name, topo, variant=variant, position=pos)
        t_build = time.perf_counter() - t0
        m = measure(cell.run)
        per.append((cell, t_build, m))
    cell = per[0][0]
    cfg, shape, vtopo = cell.cfg, cell.shape, cell.topology
    n_dev = vtopo.n_devices
    flops = max(m["flops"] for _, _, m in per)
    bytes_acc = max(m["bytes"] for _, _, m in per)
    coll = {k: max(m["collectives"][k] for _, _, m in per) for k in per[0][2]["collectives"]}
    coll_total = float(max(sum(m["collectives"].values()) for _, _, m in per))
    state = max(c.state_bytes for c, _, _ in per)
    t_compute, t_memory, t_coll = flops / PEAK_FLOPS, bytes_acc / HBM_BW, coll_total / LINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
                   key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    a = analytic.cell_analytic(cfg, shape, n_dev, vtopo.tp, serve_sparse=cell.serve_sparse)
    a_terms = a.terms()
    a_dom = max(zip(("compute", "memory", "collective"), a_terms), key=lambda kv: kv[1])[0]
    rec = dict(
        arch=arch, shape=shape_name, mesh="2x16x16" if multi_pod else "16x16",
        variant=variant, devices=n_dev,
        flops_per_dev=float(flops), bytes_per_dev=float(bytes_acc),
        bytes_kind="op-level (each aten op's inputs + outputs)",
        collective_bytes_per_dev=coll_total, collectives=coll,
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
        dominant=dominant, model_flops=mf,
        useful_flops_frac=mf / (flops * n_dev) if flops else 0.0, scan_corrected=False,
        raw_flops_per_dev=float(flops), state_bytes_per_dev=float(state),
        state_bytes_kind="the rank's own, exact (the larger of positions "
                         f"{[c.position for c, _, _ in per]})",
        lower_s=round(max(t for _, t, _ in per), 1),
        compile_s=round(max(m["seconds"] for _, _, m in per), 1),
        memory_analysis=None,
        a_t_compute=a_terms[0], a_t_memory=a_terms[1], a_t_collective=a_terms[2],
        a_dominant=a_dom, roofline_frac=a_terms[0] / max(a_terms) if max(a_terms) else 0.0,
        rates={"peak_flops": PEAK_FLOPS, "hbm_bytes_s": HBM_BW, "link_bytes_s": LINK_BW,
               "source": "H100 SXM5 data sheet (dense bf16, HBM3); InfiniBand NDR 400 Gb/s "
                         "a GPU"},
        positions=[{"position": c.position, "flops": m["flops"], "bytes": m["bytes"],
                    "collectives": m["collectives"], "state_bytes": c.state_bytes}
                   for c, _, m in per],
    )
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']} ({variant}): OK "
              f"build={rec['lower_s']}s run={rec['compile_s']}s (host seconds)")
        print(f"  flops/dev={flops:.3e} op-bytes/dev={bytes_acc:.3e} coll/dev={coll_total:.3e}")
        print(f"  roofline: compute={t_compute:.4f}s memory={t_memory:.4f}s "
              f"collective={t_coll:.4f}s -> {dominant}-bound")
        print(f"  state/dev={state / 2**30:.2f} GiB  useful-flops={rec['useful_flops_frac']:.2%}")
    return rec


def _cell_or_error(arch: str, shape_name: str, multi_pod: bool, variant: str):
    """``run_cell``'s record, or the repr of the error a cell the port cannot
    build raises (every cell is tried)."""
    try:
        return run_cell(arch, shape_name, multi_pod=multi_pod, variant=variant)
    except Exception as e:  # noqa: BLE001 - recorded as the cell's failure
        return repr(e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Dry run of the port's steps on the meta device.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--variant", default="paper")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own (a cell is one "
                         "host thread: a prefill_32k cell of ~50 layers takes ~20 host minutes)")
    args = ap.parse_args(argv)
    if args.jobs < 1:
        ap.error("--jobs must be >= 1")
    if args.arch is not None and args.arch not in ARCH_MODULES:
        ap.error(f"unknown arch {args.arch!r}; have {sorted(ARCH_MODULES)}")
    if args.shape is not None and args.shape not in [s.name for s in SHAPES]:
        ap.error(f"unknown shape {args.shape!r}; have {[s.name for s in SHAPES]}")
    try:
        variant_tokens(args.variant)
    except ValueError as e:
        ap.error(str(e))

    archs = list(ALL_ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    records, failures = [], []
    done = set()
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        records = prev.get("records", [])
        failures = [tuple(x) for x in prev.get("failures", [])]
        done = {(r["arch"], r["shape"], r["mesh"], r.get("variant", "paper"))
                for r in records}
        print(f"[dryrun] resuming: {len(done)} cells already done")
    todo = [(arch, shape_name, mp) for arch in archs for shape_name in shapes for mp in meshes
            if (arch, shape_name, "2x16x16" if mp else "16x16", args.variant) not in done]

    def save(key, result):
        arch, shape_name, mp = key
        failures[:] = [f for f in failures if tuple(f[:3]) != key]
        if isinstance(result, dict):
            records.append(result)
        else:
            failures.append((arch, shape_name, mp, result[:500]))
            print(f"[dryrun] FAIL {arch} x {shape_name} multi_pod={mp}: {result}"[:600])
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"records": records, "failures": failures}, f, indent=1)

    if args.jobs == 1:
        for key in todo:
            save(key, _cell_or_error(*key, args.variant))
    else:
        import concurrent.futures as cf
        import multiprocessing as mp_lib
        with cf.ProcessPoolExecutor(args.jobs, mp_context=mp_lib.get_context("spawn")) as pool:
            futs = {pool.submit(_cell_or_error, *key, args.variant): key for key in todo}
            for fut in cf.as_completed(futs):
                save(futs[fut], fut.result())
    print(f"[dryrun] {len(records)} cells OK, {len(failures)} failed")
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
