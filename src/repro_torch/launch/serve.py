"""Serving CLI of the port: seeded weights, a staggered trace or the HTTP
front door, the engine.

  python -m repro_torch.launch.serve --arch bitnet-1.3b [--reduced] \\
      [--device cpu] --requests 4 --prompt-len 64 --gen 32 --slots 4 --stagger 4 \\
      [--temperature 0.8 --top-k 40] [--scheduler deadline --slo-steps 48 \\
      --preemption] [--layout paged --page-size 16] [--policy wave]

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
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced as reduced_cfg
from repro_torch.kernels import ops
from repro_torch.models import model as MD
from repro_torch.serve import Request, ServeConfig, ServeEngine, Telemetry
from repro_torch.serve.engine import check_serve_config

__all__ = ["build_engine", "make_prompt", "main"]

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
    return ap


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
                         scheduler=args.scheduler, preemption=args.preemption)
        check_serve_config(cfg, sc)
    except (RuntimeError, ValueError) as e:
        ap.error(f"config not serveable: {e}")
    eng = build_engine(cfg, sc, device, serve_sparse=not args.no_sparse)
    layouts: dict[str, int] = {}
    for row in eng.layout_summary():
        layouts[row["layout"]] = layouts.get(row["layout"], 0) + 1
    print("[serve] slot-state layouts: " + ", ".join(f"{k} x{v}" for k, v in layouts.items()))
    tele = Telemetry(engine=eng, jsonl_path=args.metrics_out)
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
    st = eng.stats
    print(f"[serve] {st.decode_steps} decode steps, slot utilization "
          f"{st.slot_utilization:.2f}, {st.generated_tokens} tokens in "
          f"{st.wall_seconds:.2f}s ({st.generated_tokens / max(st.wall_seconds, 1e-9):.1f}"
          f" tok/s, {device})")
    print(f"[serve] kernel launches: {dict(ops.launches)}")
    if args.layout == "paged":
        pool = eng.pool_stats()
        if pool["num_pages"]:
            print(f"[serve] paged pool: {pool['pages_peak']}/{pool['num_pages']} pages "
                  f"peak ({pool['bytes_peak'] / 1e6:.2f} MB vs dense "
                  f"{pool['dense_equiv_bytes'] / 1e6:.2f} MB), {st.prefix_hits} prefix "
                  f"hits ({st.prompt_tokens_reused} tokens reused), {st.cow_copies} "
                  f"CoW copies")
        else:
            print("[serve] paged pool: no full-attention layers under this config "
                  "(LPSA/ring only) -> no page arenas; pass --no-sparse to page the "
                  "global layers")
    if cfg.moe is not None:
        print(f"[serve] moe: {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, "
              f"{cfg.moe.n_shared} shared; admissions deferred by the expert-capacity "
              f"bound: {st.moe_capacity_deferrals}")
    for uid in sorted(results):
        r = results[uid]
        slo_note = "" if r.slo_steps is None else \
            f", slo {'MET' if r.slo_met else 'MISS'} ({r.slo_steps})"
        print(f"[serve] req {uid}: ttft {r.ttft_steps} steps, latency "
              f"{r.latency_steps} steps{slo_note}, ids {r.tokens[:8].tolist()}...")
    if slo is not None:
        tracked = [r for r in results.values() if r.slo_steps is not None]
        met = sum(r.slo_met for r in tracked)
        print(f"[serve] SLO attainment: {met}/{len(tracked)} "
              f"({met / max(len(tracked), 1):.0%}) at {args.slo_steps} steps, "
              f"{st.preemptions} preemptions")
    if args.metrics_out:
        tele.close()
        print(f"[serve] telemetry JSONL -> {args.metrics_out}")
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


if __name__ == "__main__":
    main()
