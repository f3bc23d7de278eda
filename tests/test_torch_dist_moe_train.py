"""Expert- and data-parallel MoE training of the port against the JAX
package.

Reduced qwen3-moe-30b-a3b (8 experts, top-2, capacity factor 1.0, so the
busiest experts drop copies) and reduced kimi-k2-1t-a32b (with its shared
expert), float32, on the JAX package's weights (``bridge.load_master_tree``
cut by ``models.model.shard_params``), in one world of 4 gloo ranks on the CPU (spawned once for the
module), at Topology(tp=2) and Topology(dp=2, tp=2), DAS on and off,
reduced qwen3-moe with one kv head at Topology(tp=2) (the head replicated
on both ranks), and reduced qwen3-moe at dp 2 x tp 2 with the experts alone
cut over "model" (``Mesh.experts_alone()``, the dry run's ``dpattn``):

  * a rank holds the stacks of its experts [e0, e1) and routes its rows
    over all of them with the replicated router, at the capacity of its
    own rows (the JAX package's ``t_local``).  So the reference is the JAX
    package's mesh semantics: its single-device jitted ``value_and_grad(
    loss_fn)`` on each data half alone, the halves' losses and gradients
    averaged (every label is valid, so the halves count alike): the loss
    within 2e-5 (relative) and the gradient of every master leaf (each
    rank's part summed over "dp", its shard gathered over "model") within
    1e-4 of that leaf's max;
  * 2 steps of ``make_train_step`` (ZeRO-1) against the same reference
    stepped by the JAX package's ``adamw_step`` at the schedule's rate:
    each step's loss and every param leaf, gathered, within 1e-4;
  * each rank holds its experts' stacks and its ZeRO-1 slices of their
    moments (cut along the stack's dim 1, the first that "data" divides);
  * the state after the steps, gathered and checkpointed at dp 2 x tp 2,
    restores onto Topology(dp=1, tp=2) as the same shards and onto one
    device as the saved tree, bitwise.

The ranks sum in another order than one device (the partial combines and
the row-parallel partials over "model"), so a DAS, int8 or expert-trit
decision at a near tie can land on the other side; the ranks take the JAX
run's decision there (``test_torch_train.Decisions``' rule, ``torch_ties``:
only within 1e-5 of a tie of the rank's own input, at most 0.01 % of the
decisions), each JAX record cut to the rank's "model" lanes and experts.
The ranks run this module's ``moe_train_rank``; JAX and the JAX package
are imported only inside the fixture.
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

QWEN, KIMI = "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"
LOSS_RTOL, GRAD_TOL, STEP_TOL = 2e-5, 1e-4, 1e-4
STEP_KW = dict(peak_lr=3e-4, warmup=2, total=4)
ROWS, SEQ = 2, 64        # a data half's rows and their length
# (arch, topology, DAS on, one kv head, the experts alone over "model")
CASES = [(QWEN, Topology(tp=2), True, False, False),
         (QWEN, Topology(tp=2), False, False, False),
         (QWEN, Topology(dp=2, tp=2), True, False, False),
         (QWEN, Topology(dp=2, tp=2), False, False, False),
         (KIMI, Topology(tp=2), True, False, False),
         (KIMI, Topology(dp=2, tp=2), True, False, False),
         (KIMI, Topology(dp=2, tp=2), False, False, False),
         (QWEN, Topology(tp=2), True, True, False),
         (QWEN, Topology(dp=2, tp=2), True, False, True)]
IDS = [f"{a.split('-')[0]}-dp{t.dp}-{'das' if d else 'dense'}{'-kv1' if k else ''}"
       f"{'-experts_only' if e else ''}" for a, t, d, k, e in CASES]


def _edit(cfg, das: bool, kv1: bool):
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    if not das:
        cfg = dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary, das=None))
    return dataclasses.replace(cfg, n_kv_heads=1) if kv1 else cfg


def _cfg(arch, das, kv1):
    return _edit(tbase.reduced(get_config(arch)), das, kv1)


class RankDecisions:
    """The JAX runs' distinct DAS masks, int8 values and expert-stack trits
    (in call order, one queue a kind), taken by a rank where its own
    decision differs at a near tie: a record of the rank's data half, cut
    to the rank's lanes where its input is a "model" cut (wo's, the shared
    expert's down) and to its experts for a stack's trits."""

    def __init__(self, cfg, mesh):
        from repro_torch.models import model as MD
        self.mesh, self.bounds = mesh, MD.model_bounds(cfg, mesh.topology.tp)
        self.forced = self.total = self.zero_ties = 0
        self.worst = 0.0
        self.queue, self.seen = {}, {}
        self._orig = (tdas.das_mask, ttq.int8_quantize, ttq.ternary_fake_quant_stacked)

    def _cut(self, kind, full, like):
        full = torch.from_numpy(np.array(full))
        r = self.mesh.model_index
        if kind == "ternary":
            lo, hi = self.bounds["experts"][r]
            return full[lo:hi].reshape(like.shape)
        k, big = like.shape[-1], full.shape[-1]
        if k != big:
            lo, hi = next(c[r] for c in self.bounds.values()
                          if c[-1][1] == big and c[r][1] - c[r][0] == k)
            full = full[..., lo:hi]
        return full.reshape(like.shape)

    def _want(self, kind, x, like):
        key = (kind, x.detach().numpy().tobytes())
        if key not in self.seen:
            v = next(self.queue[kind], None)
            assert v is not None, f"the rank made a {kind} decision JAX did not"
            self.seen[key] = self._cut(kind, v, like)
        return self.seen[key]

    def _count(self, kind, diff, gaps):
        if diff.any():
            worst = float(gaps().max())
            assert worst <= TIE_RTOL, f"a {kind} decision differs {worst:.2e} away from a tie"
            self.worst = max(self.worst, worst)
        self.forced += int(diff.sum())
        self.total += diff.numel()

    def force(self, records):
        """Take ``records`` ({kind: [decision, ...]}) in the calls from now on."""
        from test_torch_train import _Forced, ternary_gaps
        self.queue = {k: iter(v) for k, v in records.items()}
        self.seen = {}
        orig_mask, orig_q, orig_t = self._orig

        def mask(x, *, block_size=tdas.DEFAULT_BLOCK, keep=tdas.DEFAULT_BLOCK // 2):
            own = orig_mask(x, block_size=block_size, keep=keep)
            w = self._want("das", x, own)
            diff = own != w
            main = x.shape[-1] - x.shape[-1] % block_size
            zero = torch.zeros_like(diff)
            zero[..., :main] = near_zero(x, block_size).reshape(zero[..., :main].shape)
            self.zero_ties += int((diff & zero).sum())
            self._count("DAS", diff & ~zero, lambda: das_gaps(x, diff, block_size, keep))
            return w

        def quant(x, **kw):
            own = orig_q(x, **kw)
            w = self._want("int8", x, own.values)
            diff = own.values != w
            self._count("int8", diff, lambda: int8_gaps(x, own.scale, diff))
            return ttq.QuantizedActivation(w, own.scale)

        def stacked(w):
            own = orig_t(w)
            gamma = w.detach().abs().mean(dim=tuple(range(1, w.ndim)), keepdim=True,
                                          dtype=torch.float32).to(w.dtype) + ttq.EPS
            q = torch.sign(own.detach())
            q_want = self._want("ternary", w, q).to(q.dtype)
            diff = q != q_want
            self._count("trit", diff, lambda: ternary_gaps(w, gamma, diff))
            return own if not diff.any() else _Forced.apply(w, (q_want * gamma).to(w.dtype))

        tdas.das_mask, ttq.int8_quantize, ttq.ternary_fake_quant_stacked = mask, quant, stacked

    def restore(self):
        tdas.das_mask, ttq.int8_quantize, ttq.ternary_fake_quant_stacked = self._orig

    def leftover(self) -> int:
        return sum(1 for q in self.queue.values() for _ in q)


def _ckpt_check(rank, cfg, state, tmp) -> dict:
    """Save ``state`` (global) from rank 0, restore onto dp 1 x tp 2 and onto
    one device: each must give the saved tree's cuts bitwise."""
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import elastic
    from repro_torch.distributed.plan import ShardingPlan
    from repro_torch.tree import leaves
    if rank == 0:
        ckpt.save_checkpoint(tmp, 2, state)
    dist.barrier()
    small = Topology(dp=1, tp=2)
    mesh = small.build_mesh()
    out = {}
    if mesh.member:
        plan = ShardingPlan.for_tree(state["params"], small, cfg=cfg)
        got, step = elastic.elastic_restore(tmp, mesh, plan, device="cpu")
        want, _ = elastic.shard_state(state, cfg, mesh, "cpu")
        out["dp1"] = step == 2 and all(
            torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    whole, _ = ckpt.restore_checkpoint(tmp, device="cpu")
    out["one"] = all(torch.equal(a, b) for a, b in zip(leaves(whole), leaves(state)))
    dist.barrier()
    return out


def moe_train_rank(rank: int, jobs, tmp: str) -> list:
    """Each job {"case", "tree", "batch", "records", "step_records"} on this
    rank: the loss and the global gradients of the rank's rows, then 2
    steps (each with its JAX decisions) and the global params; the last
    dp 2 job also checkpoints its state and restores it elsewhere."""
    from repro_torch.bridge import load_master_tree
    from repro_torch.distributed import collectives
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    from repro_torch.tree import leaves, leaves_with_paths
    meshes = {}
    for topo in dict.fromkeys(c[1] for c in CASES):
        meshes[topo] = topo.build_mesh()
    out = []
    for j, job in enumerate(jobs):
        arch, topo, das, kv1, ep = CASES[job["case"]]
        cfg, mesh = _cfg(arch, das, kv1), meshes[topo]
        if ep:
            mesh = mesh.experts_alone()
        if not mesh.member:
            out.append(None)
            continue
        half = mesh.dp_index
        params = MD.shard_params(load_master_tree(job["tree"], cfg, "cpu"), cfg, mesh)
        batch = job["batch"]
        rt = TR.make_runtime(mesh, len(batch["inputs"]))
        dec = RankDecisions(cfg, mesh)
        try:
            dec.force(job["records"][half])
            rows = TR.batch_rows(mesh, len(batch["inputs"]))
            _, aux, grads = TR.loss_and_grads(params, cfg, {k: v[rows] for k, v in batch.items()},
                                              rt)
            left = [dec.leftover()]
            grads = [collectives.psum(g.float(), mesh, "dp")
                     for g in leaves(MD.gather_params(grads, cfg, mesh))]
            res = {"loss": float(aux["loss"]), "grads": [g.numpy() for g in grads]}
            shards = TR.train_shardings(mesh, load_master_tree(job["tree"], cfg, "cpu"), cfg=cfg)
            res["held"] = [(path, tuple(p.shape), tuple(m.shape)) for (path, p), m in
                           zip(leaves_with_paths(shards.params), leaves(shards.opt.m))]
            step = TR.make_train_step(cfg, rt, **STEP_KW)
            p, o, losses = shards.params, shards.opt, []
            for s in range(2):
                dec.force(job["step_records"][s][half])
                p, o, m = step(p, o, batch)
                left.append(dec.leftover())
                losses.append(float(m["loss"]))
            state = TR.gather_state(mesh, p, o, cfg=cfg)
            res.update(step_losses=losses, leftover=left, opt_step=int(o.step),
                       params=[x.detach().numpy() for x in leaves(state["params"])])
        finally:
            dec.restore()
        res.update(forced=dec.forced, total=dec.total, zero_ties=dec.zero_ties,
                   worst=dec.worst)
        if job.get("ckpt"):
            res["restored"] = _ckpt_check(rank, cfg, state, tmp)
        out.append(res)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """[(the JAX package's per-half averaged results, each rank's)] a case."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.configs import get_config as jget_config
    from repro.models import model as JMD
    from repro.models.transformer import Runtime as JRuntime
    from repro.optim import adamw as jadamw
    from repro.optim import schedule as jsched
    from test_torch_train import Decisions
    torch.set_num_threads(1)
    want, jobs = [], []
    grad_fns = {}
    with pytest.MonkeyPatch.context() as mp:
        dec = Decisions(mp)
        dec.record_jax()

        def recorded():
            jax.effects_barrier()
            out = {k: list(v) for k, v in dec._distinct().items()}
            dec.records = []
            return out

        for i, (arch, topo, das, kv1, _) in enumerate(CASES):
            jcfg = _edit(jbase.reduced(jget_config(arch)), das, kv1)
            if (arch, das, kv1) not in grad_fns:
                grad_fns[arch, das, kv1] = jax.jit(jax.value_and_grad(
                    lambda p, b, jcfg=jcfg: JMD.loss_fn(p, jcfg, b, JRuntime()), has_aux=True))
            vg = grad_fns[arch, das, kv1]
            jp = JMD.init_params(jax.random.PRNGKey(i), jcfg)
            rng = np.random.default_rng(i)
            n = topo.dp
            toks = rng.integers(0, jcfg.vocab, (n * ROWS, SEQ + 1)).astype(np.int32)
            batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:].copy()}

            def halves(p):
                """(mean loss, mean grads, each half's records) over the data halves."""
                ls, gs, recs = [], [], []
                for h in range(n):
                    hb = {k: jnp.asarray(v[h * ROWS:(h + 1) * ROWS]) for k, v in batch.items()}
                    (loss, _), g = vg(p, hb)
                    ls.append(float(loss))
                    gs.append(g)
                    recs.append(recorded())
                return sum(ls) / n, jax.tree.map(lambda *x: sum(x) / n, *gs), recs

            loss, grads, records = halves(jp)
            p, o, losses, step_records = jp, jadamw.adamw_init(jp), [], []
            for _ in range(2):
                sl, sg, recs = halves(p)
                lr = jsched.cosine_schedule(o.step, **STEP_KW)
                p, o, _ = jadamw.adamw_step(p, sg, o, lr=lr, weight_decay=0.1)
                losses.append(sl)
                step_records.append(recs)
            want.append({"loss": loss, "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
                         "step_losses": losses,
                         "params": [np.asarray(x) for x in jax.tree.leaves(p)]})
            jobs.append({"case": i, "tree": jax.tree.map(np.asarray, jp), "batch": batch,
                         "records": records, "step_records": step_records,
                         "ckpt": i == 5})
    got = run_ranks(moe_train_rank, 4, jobs, str(tmp_path_factory.mktemp("moe_ckpt")))
    return [(want[i], [g[i] for g in got if g[i] is not None]) for i in range(len(CASES))]


def _leaf_err(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_loss_and_grads_match_jax_per_data_half(runs, case):
    want, got = runs[case]
    assert len(got) == CASES[case][1].n_devices
    for rank, res in enumerate(got):
        assert abs(res["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), \
            (rank, res["loss"], want["loss"])
        assert len(res["grads"]) == len(want["grads"])
        worst = max(_leaf_err(g, w) for g, w in zip(res["grads"], want["grads"]))
        assert worst <= GRAD_TOL, f"rank {rank}: a gradient off by {worst:.2e} of its max"


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_two_steps_match_jax(runs, case):
    want, got = runs[case]
    for rank, res in enumerate(got):
        assert res["opt_step"] == 2
        for s, (a, b) in enumerate(zip(res["step_losses"], want["step_losses"])):
            assert abs(a - b) <= STEP_TOL, f"rank {rank} step {s}: loss {a} vs {b}"
        worst = max(float(np.abs(g - w).max()) for g, w in zip(res["params"], want["params"]))
        assert worst <= STEP_TOL, f"rank {rank}: a param off by {worst:.2e}"


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_decisions_follow_jax_at_ties_only(runs, case):
    """Every JAX decision was met by the rank's own, and the ones the rank
    took from JAX lie at near ties (checked as they were taken)."""
    _, got = runs[case]
    for rank, res in enumerate(got):
        assert res["total"] > 0
        assert res["leftover"] == [0, 0, 0], f"rank {rank}: JAX made decisions the rank did not"
        assert res["forced"] <= MAX_FORCED * res["total"], rank
        print(f"{IDS[case]} rank {rank}: {res['forced']} of {res['total']} decisions taken "
              f"from JAX (+{res['zero_ties']} DAS lanes at a tie with zero), each within "
              f"{res['worst']:.2e} of a tie")


@pytest.mark.parametrize("case", [2, 6], ids=[IDS[2], IDS[6]])
def test_ranks_hold_their_experts_and_zero1_slices(runs, case):
    """At dp 2 x tp 2: an expert stack is the rank's half of the experts, and
    its moments half of that along the stack's dim 1 (the first dim "model"
    leaves whole that "data" divides); every moment is the rank's param
    shard cut along one dim by "data" or, where no dim divides, whole."""
    arch = CASES[case][0]
    cfg = tbase.reduced(get_config(arch))
    e, d = cfg.moe.n_experts, cfg.d_model
    _, got = runs[case]
    for rank, res in enumerate(got):
        stacks = [(p, m) for path, p, m in res["held"] if "experts_" in path]
        assert len(stacks) == 3 * cfg.n_layers
        for p, m in stacks:
            assert p[0] == e // 2 and d in p[1:], (rank, p)
            assert m[0] == p[0] and m[1] * 2 == p[1] and m[2] == p[2], (rank, p, m)
        for path, p, m in res["held"]:
            diff = [i for i, (a, b) in enumerate(zip(m, p)) if a != b]
            assert len(m) == len(p) and len(diff) <= 1, (rank, path, p, m)
            assert all(m[i] * 2 == p[i] for i in diff), (rank, path, p, m)


def test_checkpoint_restores_across_topologies(runs):
    """kimi-k2's state after 2 steps at dp 2 x tp 2, checkpointed, restores
    onto dp 1 x tp 2 as the saved tree's shards and onto one device as the
    saved tree, bitwise."""
    _, got = runs[5]
    for rank, res in enumerate(got):
        assert res["restored"]["one"], rank
        if rank < 2:
            assert res["restored"]["dp1"], rank
