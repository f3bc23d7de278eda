"""The port's optimizer against the JAX package: AdamW, the schedules and
gradient accumulation.

AdamW: 10 steps on a random tree of float32 and bfloat16 leaves (a
NamedTuple-free nesting of dicts and tuples, as the master trees are),
clipping on and off, a changing learning rate: every parameter and moment
within 1e-6 absolute plus 1e-6 relative of the JAX package's (the second
moments grow to ~90, where a float32 ulp is ~8e-6), the step and the
gradient norm too.
The schedules: every step of a run, within 1e-6 of the peak rate (XLA's
cos is not libm's, and 1 + cos cancels late in the decay: 2.8e-7 of the
rate seen).
``accumulate_grads``: 2 microbatches of the reduced bitnet-1.3b's loss
against the JAX package's scan, within 1e-4 of each leaf's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JMD
from repro.models.transformer import Runtime as JRuntime
from repro.optim import adamw as jadamw
from repro.optim import grad as jgrad
from repro.optim import schedule as jschedule
from repro_torch.bridge import load_master_tree, to_torch
from repro_torch.models import model as MD
from repro_torch.optim import adamw, grad, schedule
from repro_torch.tree import leaves
from test_torch_hybrid import one_thread  # noqa: F401
from test_torch_train import cfg_pair, jax_params

ADAMW_TOL = 1e-6


def _tree(rng):
    """A master-like tree: float32 and bfloat16 leaves in dicts and tuples."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": f(16, 8), "layers": {"tail": ({"w": f(8, 12), "scale": f(8)},
                                                   {"w": f(12, 8)}), "stacked": None},
            "b16": {"w": jnp.asarray(f(8, 8)).astype(jnp.bfloat16)}}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, label):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ADAMW_TOL, atol=ADAMW_TOL,
                               err_msg=label)


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
def test_adamw_matches_jax(rng, clip):
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), _to_np(jp))
    jopt, topt = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for step in range(10):
        # gradients large enough that clipping at 1.0 bites
        g = jax.tree.map(lambda p, s=step: (jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * (0.5 + s))).astype(p.dtype), jp)
        lr = 1e-2 * (step + 1) / 10
        jp, jopt, jinfo = jax.jit(lambda p, g, o, lr: jadamw.adamw_step(
            p, g, o, lr=lr, clip_norm=clip))(jp, g, jopt, jnp.float32(lr))
        tg = jax.tree.map(lambda a: to_torch(np.asarray(a)), _to_np(g))
        tp, topt, tinfo = adamw.adamw_step(tp, tg, topt, lr=torch.tensor(lr), clip_norm=clip)
        assert int(topt.step) == int(jopt.step) == step + 1
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]),
                                   rtol=1e-6)
        for name, tt, jt in (("params", tp, jp), ("m", topt.m, jopt.m), ("v", topt.v, jopt.v)):
            for i, (a, b) in enumerate(zip(leaves(tt), jax.tree.leaves(jt))):
                assert a.dtype == to_torch(np.asarray(b)).dtype
                _close(a, b, f"step {step} {name} leaf {i}")
    assert all(m.dtype == torch.float32 for m in leaves(topt.m))


def test_global_norm_in_leaf_order(rng):
    tree = _tree(rng)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = adamw.global_norm(jax.tree.map(lambda a: to_torch(np.asarray(a)), _to_np(tree)))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["cosine_schedule", "wsd_schedule"])
def test_schedules_match_jax_at_every_step(name):
    jf, tf = getattr(jschedule, name), getattr(schedule, name)
    for warmup, total in ((2, 6), (10, 50), (0, 7)):
        kw = dict(peak_lr=3e-4, warmup=warmup, total=total)
        for step in range(total + 2):
            want = float(jax.jit(lambda s: jf(s, **kw))(jnp.int32(step)))
            got = tf(torch.tensor(step, dtype=torch.int32), **kw)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-6 * kw["peak_lr"],
                                       err_msg=f"{name} {kw} step {step}")
            assert float(tf(step, **kw)) == float(got)


def test_accumulate_grads_matches_jax():
    jcfg, tcfg = cfg_pair("bitnet-1.3b")
    jp = jax_params(jcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 2, 33)).astype(np.int32)
    batches = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    jloss, jg, _ = jax.jit(lambda p, b: jgrad.accumulate_grads(
        lambda p_, mb: JMD.loss_fn(p_, jcfg, mb, JRuntime()), p, b, 2))(
        jp, jax.tree.map(jnp.asarray, batches))
    tp = load_master_tree(_to_np(jp), tcfg, "cpu")
    tloss, tg, err = grad.accumulate_grads(
        lambda p_, mb: MD.loss_fn(p_, tcfg, mb), tp,
        {k: torch.from_numpy(v) for k, v in batches.items()}, 2)
    assert err is None
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
        assert a.dtype == torch.float32
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
