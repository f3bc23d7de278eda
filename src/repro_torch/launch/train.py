"""Training entry point of the port: the step builder and a runnable main.

``make_train_step`` returns the step (params, opt, batch) -> (params, opt,
metrics): the loss and its gradient by autograd over the master tree
(models/model.py ``loss_fn``), the learning rate from the schedule at the
optimizer's step, then AdamW.  ``main`` runs a training job on seeded
random weights and synthetic data, with checkpoints, fault-tolerant restart
and straggler monitoring, the JAX package's loop.  It trains every arch
of the registry: the dense models, the MoE (qwen3-moe-30b-a3b;
kimi-k2-1t-a32b only ``--reduced``, on the CPU), the recurrent rwkv6-3b and
gla-1.3b, and the hybrid zamba2-2.7b; an unknown arch is refused.

Usage:
  python -m repro_torch.launch.train --arch bitnet-1.3b --reduced --steps 50 \\
      --batch 8 --seq 128 [--device cpu] [--inject-failure 17] [--ckpt-dir DIR]

Runs on the CUDA device unless ``--device cpu``, where the DAS masks come
from the plain PyTorch version of the ``das_topk`` kernel.  On the CPU run
an arch ``--reduced``: a full-size one takes minutes and tens of GB.

Under a Topology (the JAX package's ``make_runtime`` and
``train_shardings``; the CLI has no mesh flag, as the JAX package's has
none): each rank of a ``distributed.plan.Mesh`` holds its tensor-parallel
shard of the master tree (a MoE's experts cut over "model": expert
parallel) and its ZeRO-1 slices of the AdamW moments (``train_shardings``),
takes its rows of every global batch, and the step runs the sharded
``loss_fn`` and the ZeRO-1 update (``optim.adamw``).
``gather_state`` gathers a rank's state back into the global tree that a
checkpoint holds (every rank calls it; ``checkpoint.restore_checkpoint(...,
mesh=, plan=)`` cuts it again, onto any topology).
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import get_config, reduced as reduced_cfg
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import elastic, fault
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedule
from repro_torch.tree import leaves, unflatten

__all__ = ["make_runtime", "TrainShards", "train_shardings", "batch_rows", "loss_and_grads",
           "make_train_step", "gather_state", "main"]


def make_runtime(mesh=None, global_batch: int | None = None, *,
                 serve_sparse: bool = True) -> T.Runtime:
    """The step's Runtime: one device without a mesh; on ``mesh`` (a
    ``distributed.plan.Mesh``) the batch's data-parallel axes
    (``Topology.dp_axes_for(global_batch)``), and a MoE's experts on
    "model" (the JAX package's ``ep_axis="model"``; on a mesh with
    ``experts_only`` they alone, every other leaf whole on each rank: the
    dry run's ``dpattn``).  ``serve_sparse`` puts LPSA on the global layers (the JAX
    package's signature, which the dry run sets per shape)."""
    if mesh is None:
        return T.Runtime(serve_sparse=serve_sparse)
    return T.Runtime(serve_sparse=serve_sparse, mesh=mesh,
                     dp_axes=mesh.topology.dp_axes_for(global_batch))


class TrainShards(NamedTuple):
    """What one rank trains: its params, its AdamW state with ZeRO-1 moment
    slices, and its mesh (``batch`` cuts its rows of a global batch)."""
    params: dict
    opt: adamw.AdamWState
    mesh: object

    def batch(self, batch: dict) -> dict:
        return {k: v[batch_rows(self.mesh, len(v))] for k, v in batch.items()}


def batch_rows(mesh, size: int) -> slice:
    """A rank's rows of a global batch of ``size`` rows: its "dp" share."""
    n = mesh.size("dp")
    if size % n:
        raise ValueError(f"a batch of {size} rows does not split over {n} data ranks")
    i = mesh.dp_index
    return slice(i * size // n, (i + 1) * size // n)


def train_shardings(mesh, params, opt: adamw.AdamWState | None = None, *, cfg,
                    device=None) -> TrainShards:
    """This rank's share of a global training state: ``params`` (a master
    tree, e.g. on the host) cut over "model" (on a mesh with
    ``experts_only`` the expert stacks alone), ``opt`` (global; None: fresh
    zero moments) cut over "model" and then over "data" (ZeRO-1), on
    ``device`` (default: the params')."""
    state, zero = elastic.shard_state({"params": params, "opt": opt}, cfg, mesh, device)
    opt = state["opt"] if opt is not None else adamw.adamw_init(state["params"], zero)
    return TrainShards(state["params"], opt, mesh)


def loss_and_grads(params, cfg, batch: dict, rt: T.Runtime):
    """(loss, aux, gradients in params' tree) of ``MD.loss_fn`` on
    ``batch`` (a rank's rows under ``rt.mesh``: the gradients are then the
    rank's part, not yet summed over "dp"); leaves without a gradient get
    zeros."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    dev = flat[0].device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    loss, aux = MD.loss_fn(unflatten(params, flat), cfg, b, rt)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss, aux, unflatten(params, grads)


def make_train_step(cfg, rt: T.Runtime, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, sched: str = "cosine", weight_decay: float = 0.1):
    """The step (params, opt, batch) -> (params, opt, {"loss", "lr",
    "grad_norm"}); ``batch`` {"inputs", "labels"} may be numpy and is moved
    to the params' device.  Under ``rt.mesh``: params and opt a rank's
    (``train_shardings``), ``batch`` the global batch (the step takes the
    rank's rows), the update ZeRO-1, and "loss" the whole batch's."""
    sched_fn = schedule.wsd_schedule if sched == "wsd" else schedule.cosine_schedule
    mesh = rt.mesh
    if mesh is not None and tuple(rt.dp_axes) != mesh.topology.dp_axes:
        raise ValueError(f"the batch must split over every data axis "
                         f"{mesh.topology.dp_axes}; got dp_axes {rt.dp_axes}")
    zero = []           # the rank's ZeroLayout, resolved at the first step

    def train_step(params, opt: adamw.AdamWState, batch):
        if mesh is not None:
            batch = {k: v[batch_rows(mesh, len(v))] for k, v in batch.items()}
            if not zero:
                zero.append(elastic.zero_layout(params, mesh, cfg))
        _, aux, grads = loss_and_grads(params, cfg, batch, rt)
        lr = sched_fn(opt.step, peak_lr=peak_lr, warmup=warmup, total=total)
        params, opt, info = adamw.adamw_step(params, grads, opt, lr=lr,
                                             weight_decay=weight_decay,
                                             zero=zero[0] if zero else None)
        return params, opt, {"loss": aux["loss"].detach(), "lr": lr, **info}

    return train_step


def gather_state(mesh, params, opt: adamw.AdamWState, *, cfg) -> dict:
    """The global {"params", "opt"} of a rank's ``TrainShards`` state, on
    every rank (the ZeRO-1 slices all-gathered over "data", then every cut
    gathered over "model"): what a checkpoint holds.  Every rank of the
    mesh calls it, in one order."""
    zero = elastic.zero_layout(params, mesh, cfg)

    def moments(t):
        return MD.gather_params(zero.gather(t), cfg, mesh)
    return {"params": MD.gather_params(params, cfg, mesh),
            "opt": adamw.AdamWState(step=opt.step, m=moments(opt.m), v=moments(opt.v))}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a ternary model (repro_torch).")
    ap.add_argument("--arch", default="bitnet-1.3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sched", choices=("cosine", "wsd"), default="cosine")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-failure", type=int, action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: das_topk gives the DAS masks) or cpu (its "
                         "plain version; pair it with --reduced)")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if args.reduced:
        cfg = reduced_cfg(cfg)
    device = resolve_device(args.device)
    # minicpm trains with WSD per its paper
    sched = "wsd" if (args.arch.startswith("minicpm") and args.sched == "cosine") \
        else args.sched
    step_fn = make_train_step(cfg, make_runtime(), peak_lr=args.lr,
                              warmup=10, total=args.steps, sched=sched)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=args.seed)
    params = MD.init_params(cfg, seed=args.seed, device=device)
    opt = adamw.adamw_init(params)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {device}, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}, {sched}")

    monitor = fault.StragglerMonitor()
    injector = fault.FaultInjector(tuple(args.inject_failure))
    losses: list[float] = []

    def one_step(state, step):
        params, opt = state
        params, opt, m = step_fn(params, opt, data.batch_at(step))
        loss = float(m["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"  step {step:5d} loss {loss:.4f} lr {float(m['lr']):.2e} "
                  f"gnorm {float(m['grad_norm']):.3f}")
        return params, opt

    if args.ckpt_dir:
        def save(st, s):
            ckpt_lib.save_checkpoint(args.ckpt_dir, s, {"params": st[0], "opt": st[1]})

        def restore():
            tree, s = ckpt_lib.restore_checkpoint(args.ckpt_dir, device=device)
            print(f"  [fault] restored step {s}")
            return (tree["params"], tree["opt"]), s

        state, stats = fault.resilient_loop(
            init_state=(params, opt), step_fn=one_step, n_steps=args.steps,
            save_fn=save, restore_fn=restore, ckpt_every=args.ckpt_every,
            injector=injector, monitor=monitor)
        print(f"[train] done. restarts={stats['restarts']} "
              f"stragglers={len(stats['stragglers'])}")
    else:
        state = (params, opt)
        for s in range(args.steps):
            state = one_step(state, s)
    print(f"[train] final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
