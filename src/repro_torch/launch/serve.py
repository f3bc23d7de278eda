"""Serving CLI of the port: seeded weights, a staggered trace, the engine.

  python -m repro_torch.launch.serve --arch bitnet-1.3b [--reduced] \\
      [--device cpu] --requests 4 --prompt-len 64 --gen 32 --slots 4 --stagger 4 \\
      [--moe-expert-capacity N]

Runs on the CUDA device unless ``--device cpu``.  Master weights are drawn
from ``--seed`` and exported layer by layer to base-3 packed ternary
weights (``models.model.init_serving``), then served greedily; the summary
line reports decode steps, tokens and tok/s, and each request's first token
ids follow.  The stub-frontend models (musicgen-medium, pixtral-12b) take
prompts of float32 embeddings (``--prompt-len`` rows of d_model), drawn
from the same generator.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced as reduced_cfg
from repro_torch.kernels import ops
from repro_torch.models import model as MD
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import check_serve_config

__all__ = ["build_engine", "make_prompt", "main"]


def build_engine(cfg, config: ServeConfig, device) -> ServeEngine:
    """Seeded master weights -> TWD export -> a ServeEngine on ``device``."""
    model = MD.init_serving(cfg, seed=config.seed, device=device)
    nbytes = sum(b.numel() * b.element_size() for b in model.state_dict().values())
    print(f"[serve] {cfg.name}: serving weights {nbytes / 1e6:.1f} MB on {model.device}")
    return ServeEngine(model, config, device=device)


def make_prompt(cfg, rng: np.random.Generator, length: int) -> np.ndarray:
    """A seeded prompt: float32 embeddings (length, d_model) for a stub
    frontend, as the JAX package's CLI draws them, else token ids."""
    if MD.uses_embeds(cfg):
        return rng.standard_normal((length, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, length)


def _build_parser() -> argparse.ArgumentParser:
    d = ServeConfig()
    ap = argparse.ArgumentParser(description="TENET serving CLI (PyTorch/CUDA port)")
    ap.add_argument("--arch", default="bitnet-1.3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; default CUDA")
    ap.add_argument("--slots", type=int, default=d.max_slots)
    ap.add_argument("--seed", type=int, default=d.seed)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--stagger", type=int, default=0,
                    help="virtual decode steps between request arrivals")
    ap.add_argument("--moe-expert-capacity", type=int, default=d.moe_expert_capacity,
                    help="bound the per-expert token load per decode tick by "
                         "deferring admissions (MoE configs only; 0 = unbounded: "
                         "decode itself never drops tokens)")
    return ap


def main(argv=None):
    ap = _build_parser()
    args = ap.parse_args(argv)
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e.args[0]))
    if args.reduced:
        cfg = reduced_cfg(cfg)
    try:
        device = resolve_device(args.device)
        sc = ServeConfig(max_slots=args.slots, max_len=args.prompt_len + args.gen,
                         seed=args.seed, moe_expert_capacity=args.moe_expert_capacity)
        check_serve_config(cfg, sc)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    eng = build_engine(cfg, sc, device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(uid=i, prompt=make_prompt(cfg, rng, args.prompt_len),
                           max_new_tokens=args.gen, arrival=i * args.stagger))
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
    if cfg.moe is not None:
        print(f"[serve] moe: {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, "
              f"{cfg.moe.n_shared} shared; admissions deferred by the expert-capacity "
              f"bound: {st.moe_capacity_deferrals}")
    for uid in sorted(results):
        r = results[uid]
        print(f"[serve] req {uid}: ttft {r.ttft_steps} steps, latency "
              f"{r.latency_steps} steps, ids {r.tokens[:8].tolist()}...")
    return results


if __name__ == "__main__":
    main()
