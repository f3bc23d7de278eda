"""Tensor- and data-parallel QAT training of the port against the JAX
package's single device.

Reduced bitnet-1.3b, float32, on the JAX package's weights (``bridge.
load_master_shard``), in one world of 4 gloo ranks on the CPU (spawned once
for the module) at Topology(dp=2, tp=2) with ZeRO-1:

  * the loss and the gradient of every master leaf (each rank's part summed
    over "dp", its shard gathered over "model") against ``repro``'s jitted
    single-device ``jax.value_and_grad(loss_fn)``: the loss within 2e-5
    (relative) and every leaf within 1e-4 of that leaf's max, with DAS off
    and with DAS on;
  * 2 steps of ``make_train_step`` against ``repro``'s jitted
    ``make_train_step``: each step's loss within 1e-4 and every param leaf,
    gathered, within 1e-4;
  * every rank holds 1/dp of each moment that ZeRO-1 cuts along "data"
    (all of bitnet-1.3b's at dp 2), and the whole of the others.

The ranks sum in another order than one device (the row-parallel partials
over "model", the gradients over "data"), so a DAS or int8 decision at a
near tie can land on the other side; the ranks take the JAX step's decision
there by ``test_torch_train.Decisions``' rule (``torch_ties``): only
within 1e-5 of a tie of the rank's own input, at most 0.01 % of the
decisions.  A rank's input is a slice of the JAX step's (its batch row, and
for wo's and the FFN down's input its "model" cut), so it takes the slice
of the JAX decision.  The ranks run this module's ``train_rank``; JAX and
the JAX package are imported only inside the fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.core import das as tdas
from repro_torch.core import ternary as ttq
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.plan import Topology
from torch_ties import MAX_FORCED, TIE_RTOL, das_gaps, int8_gaps, near_zero

ARCH = "bitnet-1.3b"
TOPO = Topology(dp=2, tp=2)
LOSS_RTOL, GRAD_TOL, STEP_TOL = 2e-5, 1e-4, 1e-4
STEP_KW = dict(peak_lr=3e-4, warmup=2, total=4)


def _cfg(das: bool):
    cfg = tbase.reduced(get_config(ARCH))
    if not das:
        cfg = dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary, das=None))
    return cfg


class RankDecisions:
    """The JAX step's distinct DAS masks and int8 values (in call order, one
    queue a kind), taken by a rank where its own decision differs at a near
    tie: each JAX record is cut to the rank's rows and, where the rank's
    input is a "model" cut of it, to the rank's lanes."""

    def __init__(self, cfg, mesh):
        from repro_torch.models import model as MD
        self.mesh, self.bounds = mesh, MD.model_bounds(cfg, mesh.topology.tp)
        self.forced = self.total = self.zero_ties = 0
        self.worst = 0.0
        self.queue, self.seen = {}, {}
        self._orig = (tdas.das_mask, ttq.int8_quantize)

    def _cut(self, full, like):
        full = torch.from_numpy(np.array(full))
        b = full.shape[0] // self.mesh.size("dp")
        full = full[self.mesh.dp_index * b:(self.mesh.dp_index + 1) * b]
        k, big = like.shape[-1], full.shape[-1]
        if k != big:
            r = self.mesh.model_index
            lo, hi = next(c[r] for c in self.bounds.values()
                          if c[-1][1] == big and c[r][1] - c[r][0] == k)
            full = full[..., lo:hi]
        return full.reshape(like.shape)

    def _want(self, kind, x, like):
        key = (kind, x.detach().numpy().tobytes())
        if key not in self.seen:
            v = next(self.queue[kind], None)
            assert v is not None, f"the rank made a {kind} decision JAX did not"
            self.seen[key] = self._cut(v, like)
        return self.seen[key]

    def _at_tie(self, kind, gaps):
        worst = float(gaps.max())
        assert worst <= TIE_RTOL, f"a {kind} decision differs {worst:.2e} away from a tie"
        self.worst = max(self.worst, worst)

    def force(self, records):
        """Take ``records`` ({kind: [decision, ...]}) in the calls from now on."""
        self.queue = {k: iter(v) for k, v in records.items()}
        self.seen = {}
        orig_mask, orig_q = self._orig

        def mask(x, *, block_size=tdas.DEFAULT_BLOCK, keep=tdas.DEFAULT_BLOCK // 2):
            own = orig_mask(x, block_size=block_size, keep=keep)
            w = self._want("das", x, own)
            diff = own != w
            if diff.any():
                self._at_tie("DAS", das_gaps(x, diff, block_size, keep))
            main = x.shape[-1] - x.shape[-1] % block_size
            zero = torch.zeros_like(diff)
            zero[..., :main] = near_zero(x, block_size).reshape(zero[..., :main].shape)
            self.forced += int((diff & ~zero).sum())
            self.zero_ties += int((diff & zero).sum())
            self.total += diff.numel()
            return w

        def quant(x, **kw):
            own = orig_q(x, **kw)
            w = self._want("int8", x, own.values)
            diff = own.values != w
            if diff.any():
                self._at_tie("int8", int8_gaps(x, own.scale, diff))
            self.forced += int(diff.sum())
            self.total += diff.numel()
            return ttq.QuantizedActivation(w, own.scale)

        tdas.das_mask, ttq.int8_quantize = mask, quant

    def restore(self):
        tdas.das_mask, ttq.int8_quantize = self._orig

    def leftover(self) -> int:
        return sum(1 for q in self.queue.values() for _ in q)


def train_rank(rank: int, jobs) -> list:
    """Each job {"das", "tree", "batch", "records", "steps", "step_records"}
    on this rank at TOPO: the loss and the global gradients of ``batch``,
    then the steps (each with its JAX decisions) and the global params."""
    from repro_torch.bridge import load_master_shard, load_master_tree
    from repro_torch.distributed import collectives
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.tree import leaves
    mesh = TOPO.build_mesh()
    out = []
    for job in jobs:
        cfg = _cfg(job["das"])
        params = load_master_shard(job["tree"], cfg, mesh, "cpu")
        rt = TR.make_runtime(mesh, len(job["batch"]["inputs"]))
        dec = RankDecisions(cfg, mesh)
        try:
            dec.force(job["records"])
            rows = TR.batch_rows(mesh, len(job["batch"]["inputs"]))
            _, aux, grads = TR.loss_and_grads(
                params, cfg, {k: v[rows] for k, v in job["batch"].items()}, rt)
            left = dec.leftover()
            grads = [collectives.psum(g.float(), mesh, "dp")
                     for g in leaves(MD.gather_params(grads, cfg, mesh))]
            res = {"loss": float(aux["loss"]), "grads": [g.numpy() for g in grads],
                   "leftover": [left]}
            shards = TR.train_shardings(mesh, load_master_tree(job["tree"], cfg, "cpu"),
                                        cfg=cfg)
            res["moments"] = [(tuple(m.shape), tuple(p.shape)) for m, p in
                              zip(leaves(shards.opt.m), leaves(shards.params))]
            step = TR.make_train_step(cfg, rt, **STEP_KW)
            p, o, losses = shards.params, shards.opt, []
            for s, batch in enumerate(job["steps"]):
                dec.force(job["step_records"][s])
                p, o, m = step(p, o, batch)
                res["leftover"].append(dec.leftover())
                losses.append(float(m["loss"]))
            state = TR.gather_state(mesh, p, o, cfg=cfg)
            res["step_losses"] = losses
            res["params"] = [x.detach().numpy() for x in leaves(state["params"])]
            res["opt_step"] = int(o.step)
        finally:
            dec.restore()
        res.update(forced=dec.forced, total=dec.total, zero_ties=dec.zero_ties,
                   worst=dec.worst)
        out.append(res)
    return out


@pytest.fixture(scope="module")
def runs():
    """{das: (the JAX package's single-device results, each rank's)}."""
    import jax
    import jax.numpy as jnp

    from repro.launch import train as jtrain
    from repro.models import model as JMD
    from repro.models.transformer import Runtime as JRuntime
    from repro.optim import adamw as jadamw
    from repro_torch.data.pipeline import SyntheticLM
    from test_torch_train import Decisions, cfg_pair, jax_params, make_batch
    torch.set_num_threads(1)
    want, jobs = {}, []
    with pytest.MonkeyPatch.context() as mp:
        dec = Decisions(mp)
        dec.record_jax()

        def recorded():
            jax.effects_barrier()
            out = {k: list(v) for k, v in dec._distinct().items()}
            dec.records = []
            return out

        for das in (False, True):
            jcfg, _ = cfg_pair(ARCH, das=das)
            jp = jax_params(jcfg)
            batch = make_batch(jcfg)
            (jl, _), jg = jax.jit(jax.value_and_grad(
                lambda p, b: JMD.loss_fn(p, jcfg, b, JRuntime()), has_aux=True))(
                jp, jax.tree.map(jnp.asarray, batch))
            records = recorded()
            data = SyntheticLM(vocab=jcfg.vocab, seq_len=64, batch=2, seed=1)
            steps = [data.batch_at(s) for s in range(2)]
            jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.make_runtime(None, jcfg, 2),
                                                   **STEP_KW))
            p, o, losses, step_records = jp, jadamw.adamw_init(jp), [], []
            for b in steps:
                p, o, m = jstep(p, o, jax.tree.map(jnp.asarray, b))
                losses.append(float(m["loss"]))
                step_records.append(recorded())
            tree = jax.tree.map(np.asarray, jp)
            want[das] = {"loss": float(jl), "grads": [np.asarray(g) for g in
                                                      jax.tree.leaves(jg)],
                         "step_losses": losses,
                         "params": [np.asarray(x) for x in jax.tree.leaves(p)]}
            jobs.append({"das": das, "tree": tree, "batch": batch, "records": records,
                         "steps": steps, "step_records": step_records})
    got = run_ranks(train_rank, TOPO.n_devices, jobs)
    return {das: (want[das], [g[i] for g in got]) for i, das in enumerate((False, True))}


def _leaf_err(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("das", [False, True], ids=["dense", "das"])
def test_loss_and_grads_match_jax(runs, das):
    want, got = runs[das]
    for rank, res in enumerate(got):
        assert abs(res["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), rank
        assert len(res["grads"]) == len(want["grads"])
        worst = max(_leaf_err(g, w) for g, w in zip(res["grads"], want["grads"]))
        assert worst <= GRAD_TOL, f"rank {rank}: a gradient off by {worst:.2e} of its max"


@pytest.mark.parametrize("das", [False, True], ids=["dense", "das"])
def test_decisions_follow_jax_at_ties_only(runs, das):
    """Every JAX decision was met by the rank's own, and the ones the rank
    took from JAX lie at near ties (checked as they were taken)."""
    _, got = runs[das]
    for rank, res in enumerate(got):
        assert res["total"] > 0
        assert res["leftover"] == [0, 0, 0], f"rank {rank}: JAX made decisions the rank did not"
        assert res["forced"] <= MAX_FORCED * res["total"], rank
        print(f"das={das} rank {rank}: {res['forced']} of {res['total']} decisions taken from "
              f"JAX (+{res['zero_ties']} lanes at a tie with zero), each within "
              f"{res['worst']:.2e} of a tie")


@pytest.mark.parametrize("das", [False, True], ids=["dense", "das"])
def test_two_adamw_steps_match_jax(runs, das):
    want, got = runs[das]
    for rank, res in enumerate(got):
        assert res["opt_step"] == 2
        for s, (a, b) in enumerate(zip(res["step_losses"], want["step_losses"])):
            assert abs(a - b) <= STEP_TOL, f"rank {rank} step {s}: loss {a} vs {b}"
        worst = max(float(np.abs(g - w).max()) for g, w in zip(res["params"], want["params"]))
        assert worst <= STEP_TOL, f"rank {rank}: a param off by {worst:.2e}"


def test_ranks_hold_their_zero1_slices(runs):
    """bitnet-1.3b at dp 2: every moment is cut along "data" to half of its
    rank's param shard along one dim (zero1 finds a dim dp divides in each)."""
    _, got = runs[False]
    for rank, res in enumerate(got):
        for m, p in res["moments"]:
            assert len(m) == len(p)
            diff = [i for i, (a, b) in enumerate(zip(m, p)) if a != b]
            assert len(diff) == 1 and m[diff[0]] * TOPO.dp == p[diff[0]], (rank, m, p)
