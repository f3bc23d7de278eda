"""Serving CLI of the port: seeded weights, a staggered trace or the HTTP
front door, the engine.

  python -m repro_torch.launch.serve --arch bitnet-1.3b [--reduced] \\
      [--device cpu] --requests 4 --prompt-len 64 --gen 32 --slots 4 --stagger 4 \\
      [--temperature 0.8 --top-k 40] [--scheduler deadline --slo-steps 48 \\
      --preemption] [--layout paged --page-size 16] [--policy wave] \\
      [--kernel-mode tuned]

Runs on the CUDA device unless ``--device cpu``.  Master weights are drawn
from ``--seed`` and exported layer by layer to base-3 packed ternary
weights (``models.model.init_serving``); the summary line reports decode
steps, tokens and tok/s, and each request's first token ids follow (with
its SLO verdict when ``--slo-steps`` is set, then the attainment).  The
stub-frontend models (musicgen-medium, pixtral-12b) take prompts of float32
embeddings (``--prompt-len`` rows of d_model), drawn from the same
generator.  ``--metrics-out`` appends the JSON-lines telemetry.

``--serve-http`` runs the always-on front door (serve/server.py) over the
same engine in place of the trace: ``POST /v1/completions`` (unary or
``"stream": true`` SSE), ``GET /metrics``, ``GET /healthz``; SIGINT or
SIGTERM shuts it down cleanly.  The scheduler then defaults to "deadline"
and ``--slo-steps`` is the default SLO of requests that carry none.

``--tp N --dp M`` serves SPMD over a ``Topology(dp=M, tp=N)``: the CLI
spawns dp * tp ranks (``distributed.launch.run_ranks``: start method
"spawn", a file rendezvous in a temporary directory), each rank draws the
same seeded weights as its host copy and serves its shard, and rank 0
prints the lines a one-device run prints.  ``--dist-backend`` is NCCL on
CUDA and gloo with ``--device cpu``; two ranks on one card under NCCL fail
with NCCL's own error, and nothing switches backend silently.
``--inject-failure STEP`` (repeatable) raises a WorkerFailure before decode
step STEP, losing ``--inject-lost`` ranks: the engine snapshots, shrinks
the topology, cuts its shards anew and replays (on one device it rebuilds
in place), and rank 0 prints a ``[serve] recovery clean: ...`` line.
``--print-plan`` prints the resolved ShardingPlan and the cache specs.
``serve_rank`` / ``RankJob`` run one rank of such a world for a caller that
brings its own weights and trace (the tests, chip_smoke.py).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced as reduced_cfg
from repro_torch.distributed import collectives, fault
from repro_torch.distributed.launch import rank_device, run_ranks
from repro_torch.distributed.plan import Topology
from repro_torch.kernels import ops
from repro_torch.models import model as MD
from repro_torch.models.moe import MoE
from repro_torch.serve import Request, ServeConfig, ServeEngine, Telemetry
from repro_torch.serve.engine import check_serve_config

__all__ = ["build_engine", "make_prompt", "RankJob", "serve_rank", "serve_jobs",
           "teacher_forced", "main"]

# CLI defaults come from the ServeConfig field defaults
_D = {f.name: f.default for f in dataclasses.fields(ServeConfig)}


def build_engine(cfg, config: ServeConfig, device, serve_sparse: bool = True) -> ServeEngine:
    """Seeded master weights -> TWD export -> a ServeEngine on ``device``."""
    model = MD.init_serving(cfg, seed=config.seed, device=device)
    nbytes = sum(b.numel() * b.element_size() for b in model.state_dict().values())
    print(f"[serve] {cfg.name}: serving weights {nbytes / 1e6:.1f} MB on {model.device}")
    return ServeEngine(model, config, device=device, serve_sparse=serve_sparse)


def make_prompt(cfg, rng: np.random.Generator, length: int) -> np.ndarray:
    """A seeded prompt: float32 embeddings (length, d_model) for a stub
    frontend, as the JAX package's CLI draws them, else token ids."""
    if MD.uses_embeds(cfg):
        return rng.standard_normal((length, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, length)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="TENET serving CLI (PyTorch/CUDA port): trace replay or HTTP front door")
    eng = ap.add_argument_group("engine", "model and ServeEngine knobs (defaults: ServeConfig's)")
    eng.add_argument("--arch", default="bitnet-1.3b")
    eng.add_argument("--reduced", action="store_true")
    eng.add_argument("--device", default=None,
                     help="'cpu' runs the kernels' plain versions; default CUDA")
    eng.add_argument("--slots", type=int, default=_D["max_slots"])
    eng.add_argument("--top-k", type=int, default=_D["top_k"])
    eng.add_argument("--no-sparse", action="store_true",
                     help="full attention and full KV caches (no LPSA)")
    eng.add_argument("--layout", choices=["auto", "paged"], default=_D["layout"],
                     help="KV layout: 'auto' keeps per-slot caches; 'paged' shares one "
                          "refcounted page arena per full-attention layer, allocated "
                          "lazily, with radix prefix sharing")
    eng.add_argument("--page-size", type=int, default=_D["page_size"],
                     help="tokens per KV page (paged layout)")
    eng.add_argument("--num-pages", type=int, default=_D["num_pages"],
                     help="pool capacity incl. the null page; 0 sizes it to the "
                          "per-slot worst case")
    eng.add_argument("--no-prefix-sharing", action="store_true",
                     help="no radix-trie prompt-prefix index (paged layout)")
    eng.add_argument("--moe-expert-capacity", type=int, default=_D["moe_expert_capacity"],
                     help="bound the per-expert token load per decode tick by "
                          "deferring admissions (MoE configs only; 0 = unbounded: "
                          "decode itself never drops tokens)")
    eng.add_argument("--seed", type=int, default=_D["seed"])
    eng.add_argument("--kernel-mode", default=_D["kernel_mode"],
                     help="auto (the kernels at their built-in launch configs), tuned "
                          "(per-shape configs from the autotune cache, tuned at engine "
                          "construction; $TENET_TORCH_AUTOTUNE_CACHE), ref (the plain "
                          "versions: --device cpu only), or any JAX-package mode name "
                          "or alias (kernels/ops.py KernelMode)")

    tr = ap.add_argument_group("trace replay", "a synthetic request trace")
    tr.add_argument("--requests", type=int, default=4)
    tr.add_argument("--prompt-len", type=int, default=64)
    tr.add_argument("--gen", type=int, default=32)
    tr.add_argument("--stagger", type=int, default=0,
                    help="virtual decode steps between request arrivals")
    tr.add_argument("--temperature", type=float, default=0.0)
    tr.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append JSON-lines telemetry (a line per finished request "
                         "and periodic tick snapshots) to PATH")

    sched = ap.add_argument_group("scheduler", "admission order and SLOs")
    sched.add_argument("--policy", choices=["continuous", "wave"], default=_D["policy"])
    sched.add_argument("--scheduler", choices=["fifo", "deadline"], default=None,
                       help="admission order: 'fifo' (aged priority then arrival) or "
                            "'deadline' (earliest effective deadline first over "
                            "slo_steps); 'deadline' under --serve-http, else 'fifo'")
    sched.add_argument("--slo-steps", type=int, default=0,
                       help="deadline budget in virtual decode steps (0 = no SLO) of "
                            "every trace request, and the server's default")
    sched.add_argument("--preemption", action="store_true",
                       help="deadline scheduler only: truncate and retire the youngest "
                            "slot over its SLO when the queue head would miss its own")

    http = ap.add_argument_group("HTTP front door", "--serve-http mode")
    http.add_argument("--serve-http", action="store_true",
                      help="run the always-on HTTP front door in place of a trace "
                           "(POST /v1/completions, GET /metrics, GET /healthz; "
                           "SIGINT/SIGTERM shut it down cleanly)")
    http.add_argument("--host", default="127.0.0.1")
    http.add_argument("--port", type=int, default=8080,
                      help="listen port for --serve-http (0 = ephemeral)")
    http.add_argument("--max-queue-depth", type=int, default=64,
                      help="queued requests beyond which the server answers 429")

    dist = ap.add_argument_group(
        "distributed", "SPMD serving over a (dp, tp) mesh of spawned ranks, and elastic "
        "recovery")
    dist.add_argument("--tp", type=int, default=None, metavar="N",
                      help="tensor-parallel ways: shard the packed weights Megatron "
                           "column/row style (and the experts) over the 'model' axis")
    dist.add_argument("--dp", type=int, default=None, metavar="N",
                      help="data-parallel ways: shard the slot rows over the 'data' axis")
    dist.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                      help="torch.distributed backend of the ranks (default: nccl on "
                           "CUDA, gloo with --device cpu)")
    dist.add_argument("--print-plan", action="store_true",
                      help="print the resolved ShardingPlan (per-leaf specs) and the "
                           "cache specs")
    dist.add_argument("--inject-failure", type=int, action="append", default=None,
                      metavar="STEP",
                      help="inject a WorkerFailure before decode step STEP (repeatable): "
                           "exercises snapshot -> mesh shrink -> reshard -> replay")
    dist.add_argument("--inject-lost", type=int, default=1, metavar="N",
                      help="devices lost per injected failure (default 1)")
    return ap


def _check_topology(ap, cfg, args) -> Topology | None:
    """Resolve --tp/--dp into a Topology, rejecting with an argparse error a
    config the port does not shard (``check_shardable``: heads, vocab,
    experts) and, as the JAX CLI does, a d_ff that tp does not divide."""
    if args.tp is None and args.dp is None:
        return None     # one device; --inject-failure still recovers in place
    tp, dp = args.tp or 1, args.dp or 1
    if tp < 1 or dp < 1:
        ap.error("--tp/--dp must be >= 1")
    if args.serve_http:
        ap.error("--serve-http serves on one device; the front door over a topology waits "
                 "for ROADMAP queue 1, item 2")
    try:
        MD.check_shardable(cfg, tp)
    except ValueError as e:
        ap.error(f"config not serveable: {e}")
    if cfg.d_ff % tp:
        ap.error(f"--tp {tp} does not divide {args.arch}'s d_ff={cfg.d_ff}; pick a tp that "
                 f"divides the head/FFN dims (try --reduced, or a smaller --tp)")
    return Topology(dp=dp, tp=tp)


def _dist_backend(ap, args) -> str:
    """--dist-backend, defaulting by the device: NCCL needs CUDA."""
    backend = args.dist_backend or ("gloo" if args.device == "cpu" else "nccl")
    if backend == "nccl" and args.device == "cpu":
        ap.error("--dist-backend nccl needs CUDA; use gloo with --device cpu")
    return backend


def main(argv=None):
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.scheduler is None:
        args.scheduler = "deadline" if args.serve_http else "fifo"
    if args.preemption and args.scheduler != "deadline":
        ap.error("--preemption requires --scheduler deadline")
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e.args[0]))
    if args.reduced:
        cfg = reduced_cfg(cfg)
    topology = _check_topology(ap, cfg, args)
    max_len = args.prompt_len + args.gen
    if args.layout == "paged" and args.page_size > 0 and max_len % args.page_size:
        max_len += args.page_size - max_len % args.page_size
    try:
        device = resolve_device(args.device)
        sc = ServeConfig(max_slots=args.slots, max_len=max_len, layout=args.layout,
                         page_size=args.page_size, num_pages=args.num_pages,
                         prefix_sharing=not args.no_prefix_sharing, top_k=args.top_k,
                         seed=args.seed, policy=args.policy,
                         moe_expert_capacity=args.moe_expert_capacity,
                         scheduler=args.scheduler, preemption=args.preemption,
                         topology=topology, kernel_mode=args.kernel_mode)
        check_serve_config(cfg, sc)
        if ops.KernelMode.parse(sc.kernel_mode).behaviour == "ref" and device.type == "cuda":
            raise ValueError("--kernel-mode ref runs the plain versions: it needs "
                             "--device cpu")
    except (RuntimeError, ValueError) as e:
        ap.error(f"config not serveable: {e}")
    if topology is not None:
        backend = _dist_backend(ap, args)
        print(f"[serve] spawning {topology.n_devices} ranks over {backend}", flush=True)
        return run_ranks(_cli_rank, topology.n_devices, args, cfg, sc,
                         backend=backend)[0]
    eng = build_engine(cfg, sc, device, serve_sparse=not args.no_sparse)
    return _serve_trace(args, cfg, eng, device)


def _cli_rank(rank: int, args, cfg, sc: ServeConfig):
    """One rank of the CLI's world: the seeded weights as a host copy, the
    rank's shard of them in the engine, the trace; rank 0 reports."""
    device = rank_device(rank, "cpu" if args.device == "cpu" else "cuda")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    host = MD.init_serving(cfg, seed=sc.seed, device=device).to("cpu")
    eng = ServeEngine(host, sc, device=device, serve_sparse=not args.no_sparse)
    return _serve_trace(args, cfg, eng, device, report=rank == 0)


def _serve_trace(args, cfg, eng: ServeEngine, device, report: bool = True):
    """The trace (or the front door) through ``eng``; ``report`` prints the
    summary lines (rank 0 of a world, or the one device)."""
    say = print if report else (lambda *a, **k: None)
    if args.inject_failure:
        eng.fault_injector = fault.FaultInjector(fail_at=tuple(sorted(set(args.inject_failure))))
        eng.fault_lost_devices = args.inject_lost
    topology = eng.topology
    if topology is not None:
        say(f"[serve] topology: dp={topology.dp} tp={topology.tp} ({topology.n_devices} "
          f"devices, mesh axes {topology.axis_names})")
    if args.print_plan and topology is not None:
        say(eng.sharding_plan().describe(eng.host_model))
    layouts: dict[str, int] = {}
    for row in eng.layout_summary():
        layouts[row["layout"]] = layouts.get(row["layout"], 0) + 1
    say("[serve] slot-state layouts: " + ", ".join(f"{k} x{v}" for k, v in layouts.items()))
    tele = Telemetry(engine=eng, jsonl_path=args.metrics_out if report else None)
    if args.serve_http:
        return _serve_http(args, eng, tele)

    rng = np.random.default_rng(args.seed)
    slo = args.slo_steps if args.slo_steps > 0 else None
    for i in range(args.requests):
        eng.submit(Request(uid=i, prompt=make_prompt(cfg, rng, args.prompt_len),
                           max_new_tokens=args.gen, temperature=args.temperature,
                           arrival=i * args.stagger, slo_steps=slo))
    ops.reset_launches()
    results = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    if eng.retired:
        return None     # a rank the recovery left out
    st = eng.stats
    say(f"[serve] {st.decode_steps} decode steps, slot utilization "
        f"{st.slot_utilization:.2f}, {st.generated_tokens} tokens in "
        f"{st.wall_seconds:.2f}s ({st.generated_tokens / max(st.wall_seconds, 1e-9):.1f}"
        f" tok/s, {device})")
    say(f"[serve] kernel launches: {dict(ops.launches)}")
    if eng.autotune_cache is not None:
        say(f"[serve] kernel mode {eng.kernel_mode}: {st.autotune_timed_runs} timed "
            f"autotune runs at construction, cache {eng.autotune_cache.path}")
    if args.layout == "paged":
        pool = eng.pool_stats()
        if pool["num_pages"]:
            say(f"[serve] paged pool: {pool['pages_peak']}/{pool['num_pages']} pages "
                f"peak ({pool['bytes_peak'] / 1e6:.2f} MB vs dense "
                f"{pool['dense_equiv_bytes'] / 1e6:.2f} MB), {st.prefix_hits} prefix "
                f"hits ({st.prompt_tokens_reused} tokens reused), {st.cow_copies} "
                f"CoW copies")
        else:
            say("[serve] paged pool: no full-attention layers under this config "
                "(LPSA/ring only) -> no page arenas; pass --no-sparse to page the "
                "global layers")
    if cfg.moe is not None:
        say(f"[serve] moe: {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, "
            f"{cfg.moe.n_shared} shared; admissions deferred by the expert-capacity "
            f"bound: {st.moe_capacity_deferrals}")
    for uid in sorted(results):
        r = results[uid]
        slo_note = "" if r.slo_steps is None else \
            f", slo {'MET' if r.slo_met else 'MISS'} ({r.slo_steps})"
        say(f"[serve] req {uid}: ttft {r.ttft_steps} steps, latency "
            f"{r.latency_steps} steps{slo_note}, ids {r.tokens[:8].tolist()}...")
    if st.reshards:
        t = eng.topology
        topo_note = "" if t is None else f", topology dp={t.dp} tp={t.tp}"
        if len(results) == args.requests:
            say(f"[serve] recovery clean: all {len(results)} in-flight requests completed "
                f"(reshards={st.reshards}, recovery {st.recovery_seconds:.2f}s{topo_note})")
        else:
            say(f"[serve] recovery INCOMPLETE: {len(results)}/{args.requests} requests "
                f"completed after {st.reshards} reshard(s){topo_note}")
    if slo is not None:
        tracked = [r for r in results.values() if r.slo_steps is not None]
        met = sum(r.slo_met for r in tracked)
        say(f"[serve] SLO attainment: {met}/{len(tracked)} "
            f"({met / max(len(tracked), 1):.0%}) at {args.slo_steps} steps, "
            f"{st.preemptions} preemptions")
    if args.metrics_out:
        tele.close()
        say(f"[serve] telemetry JSONL -> {args.metrics_out}")
    return results


def _serve_http(args, eng, tele):
    """The always-on front door: serve until SIGINT/SIGTERM, then shut down
    cleanly (the engine thread joined, the telemetry log closed)."""
    import asyncio
    import contextlib
    import signal

    from repro_torch.serve.server import ServeHTTPServer

    default_slo = args.slo_steps if args.slo_steps > 0 else None
    srv = ServeHTTPServer(eng, args.host, args.port, max_queue_depth=args.max_queue_depth,
                          default_slo_steps=default_slo, telemetry=tele)

    async def _amain():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, stop.set)
        await srv.start()
        print(f"[serve] http front door on http://{srv.host}:{srv.port} "
              f"(scheduler={args.scheduler}, default_slo={default_slo}, "
              f"max_queue_depth={args.max_queue_depth}); POST /v1/completions, "
              f"GET /metrics", flush=True)
        await stop.wait()
        print("[serve] shutting down...", flush=True)
        await srv.stop()
        st = eng.stats
        print(f"[serve] clean shutdown: {st.decode_steps} decode steps, "
              f"{st.generated_tokens} tokens, {tele.requests_finished} requests served",
              flush=True)

    asyncio.run(_amain())
    return None


# --------------------------------------------------------------------------
# one rank of a world that a caller brings its own weights and trace to
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RankJob:
    """What ``serve_rank`` serves: the model config, the ServeConfig (its
    topology), "cpu" or "cuda", the full serving weights (a state dict
    written by ``torch.save``; None: ``init_serving`` from the config's
    seed), the trace, the injected failures and the ranks each costs, the
    teacher-forced requests (``teachers``: (prompt, tokens) pairs, the
    logits of each step fed those tokens), and ``profile_steps`` > 0: a
    full batch of that many decode steps under the profiler after the
    trace."""
    cfg: object
    config: ServeConfig
    device: str = "cpu"
    weights: str | None = None
    trace: tuple = ()
    serve_sparse: bool = True
    fail_at: tuple = ()
    lost: int = 1
    teachers: tuple = ()
    profile_steps: int = 0


def teacher_forced(model, prompt, tokens, *, max_len: int, serve_sparse: bool = True) -> list:
    """A batch-1 prefill of the pack-aligned ``prompt`` (none when it is
    empty) and a decode step a token of ``tokens`` -> the float32 logits
    (V,) after each, as numpy (a rank's shard gathers them over "model")."""
    dev, out = model.device, []
    if len(prompt):
        lg, caches = MD.prefill(model, torch.as_tensor(np.asarray(prompt), device=dev)[None],
                                max_len=max_len, serve_sparse=serve_sparse)
        out.append(lg[0].cpu().numpy())
    else:
        caches = MD.init_caches(model.cfg, 1, max_len, device=dev, serve_sparse=serve_sparse)
    for i, tok in enumerate(tokens):
        lg, caches = MD.decode_step(model, caches, torch.tensor([int(tok)], device=dev),
                                    torch.tensor([len(prompt) + i], device=dev),
                                    serve_sparse=serve_sparse)
        out.append(lg[0].cpu().numpy())
    return out


def _profile(eng: ServeEngine, cfg, steps: int) -> dict:
    """``steps`` decode steps with every slot active (prompts of one token,
    so no prefill) under torch.profiler: host ms a step, this process's
    device busy ms a step (its kernels' time) and the collectives a step."""
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    eng.reset_clock()
    for i in range(eng.max_slots):
        eng.submit(Request(uid=1_000_000 + i, prompt=np.asarray([i % cfg.vocab]),
                           max_new_tokens=steps))
    acts = [torch.profiler.ProfilerActivity.CUDA] if eng.device.type == "cuda" else []
    collectives.reset_counts()
    sync()
    prof = torch.profiler.profile(activities=acts) if acts else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        eng.run()
        sync()
        wall = time.perf_counter() - t0
    busy = 0.0
    if acts:
        cuda = torch.autograd.DeviceType.CUDA
        busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and not e.is_user_annotation()) / 1e6
    n = max(1, eng.stats.decode_steps)
    return {"steps": eng.stats.decode_steps, "ms_step": wall * 1e3 / n,
            "busy_ms_step": busy / n, "all_reduce_step": collectives.counts["all_reduce"] / n,
            "collective_ms_step": collectives.counts["seconds"] * 1e3 / n,
            "wait_ms_step": collectives.counts["wait_seconds"] * 1e3 / n}


def serve_rank(rank: int, job: RankJob) -> dict | None:
    """One rank of a ``run_ranks`` world: load the full weights as the host
    copy, serve ``job.trace`` on the rank's shard, then the teacher-forced
    requests and the profile -> {"tokens" {uid: ids}, "stats", "launches"
    (the trace's kernel launches on this rank), "topology" (after any
    recovery), "teachers" (each teacher-forced request's logits), "profile",
    "experts" (the rank's expert range), "seconds" {part: host seconds}};
    None for a rank the recovery left out."""
    clock = [time.perf_counter()]
    secs = {}

    def took(part):
        now = time.perf_counter()
        secs[part] = now - clock[0]
        clock[0] = now

    device = rank_device(rank, job.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if job.weights is None:
        host = MD.init_serving(job.cfg, seed=job.config.seed, device=device).to("cpu")
    else:
        host = MD.TernaryLM(job.cfg, "cpu")
        host.load_state_dict(torch.load(job.weights, map_location="cpu", mmap=True),
                             assign=True)
    took("load")
    eng = ServeEngine(host, job.config, device=device, serve_sparse=job.serve_sparse)
    took("cut")
    if job.fail_at:
        eng.fault_injector = fault.FaultInjector(fail_at=tuple(job.fail_at))
        eng.fault_lost_devices = job.lost
    for r in job.trace:
        eng.submit(r)
    ops.reset_launches()
    collectives.reset_counts()
    results = eng.run()
    if eng.retired:
        return None
    if device.type == "cuda":
        torch.cuda.synchronize()
    took("run")
    out = {"tokens": {uid: r.tokens.tolist() for uid, r in results.items()},
           "stats": dataclasses.asdict(eng.stats), "launches": dict(ops.launches),
           "collectives": dict(collectives.counts), "topology": eng.topology,
           "experts": None, "teachers": [], "profile": None, "seconds": secs}
    moe = [m for m in eng.model.modules() if isinstance(m, MoE)]
    if moe:
        out["experts"] = moe[0].experts
    if job.teachers:
        out["teachers"] = [teacher_forced(eng.model, prompt, tokens, max_len=job.config.max_len,
                                          serve_sparse=job.serve_sparse)
                           for prompt, tokens in job.teachers]
        took("teacher")
    if job.profile_steps:
        out["profile"] = _profile(eng, job.cfg, job.profile_steps)
        took("profile")
    return out


def serve_jobs(rank: int, jobs) -> list:
    """``serve_rank`` of each job in turn, in one world (``run_ranks``)."""
    return [serve_rank(rank, job) for job in jobs]


if __name__ == "__main__":
    main()
