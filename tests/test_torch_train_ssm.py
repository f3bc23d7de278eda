"""The port's training passes of the SSM pair, rwkv6-3b and gla-1.3b,
against the JAX package, and the layers they run under autograd.

``gla.gla_train`` (q/k/v/g on one DAS mask and int8 fake-quant, the gate
LoRA in float32) and ``rwkv6.time_mix_train`` / ``channel_mix_train`` (the
token shift from a zero past, four mixes into four projections, the decay
LoRA clipped to [-8, 4]) run the serving code's ``chunked_linear_attn``
under autograd.  Reduced models (d_model 64, 2 layers, B = 2): the loss
within 1e-5 relative and every master leaf's gradient within 1e-4 of that
leaf's max against the jitted JAX step, at 60 tokens (the chunk rule cuts
60 to chunks of 30) and at 48 (one chunk of 48), DAS on and off at 64; the
decisions at a tie taken from JAX (``test_torch_train.Decisions``).

The pieces: ``chunked_linear_attn``'s gradients (both modes, from a
carried state, at a decay floor tie) within 2e-5; the gradients of
``layers.sigmoid``, ``softplus``, ``log_sigmoid`` and ``xla_cumsum`` against
JAX's, finite where autograd through the formulas is not; rwkv's clip,
whose gradient splits at a tie as ``jnp.clip``'s.  bfloat16 gla-1.3b
against eager ``repro`` within 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_attn as JLA
from repro.models import rwkv6 as JR
from repro_torch.models import layers as L
from repro_torch.models import linear_attn as LA
from repro_torch.models import rwkv6 as R
from test_torch_hybrid import one_thread  # noqa: F401
from test_torch_train import bf16_matches_eager_jax, matches_jax

ARCHS = ("rwkv6-3b", "gla-1.3b")


@pytest.mark.parametrize("seq", [60, 48], ids=["cut-to-30", "one-chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_loss_and_grads_match_jax(monkeypatch, arch, seq):
    assert LA.chunk_size(seq, LA.CHUNK) == {60: 30, 48: 48}[seq]
    dec = matches_jax(arch, monkeypatch, seq=seq)
    print(f"{arch} at {seq}: {dec.forced} of {dec.total} decisions taken from JAX, each "
          f"within {dec.worst_gap:.2e} of a tie, and {dec.zero_ties} DAS lanes near zero")


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_without_das_matches_jax(monkeypatch, arch):
    matches_jax(arch, monkeypatch, das=False)


@pytest.mark.parametrize("mode", ["gla", "rwkv"])
def test_chunked_linear_attn_grads_match_jax(rng, mode):
    """The gradients of q, k, v, log a, u and the carried state through 40
    tokens in chunks of 8, some log decays exactly at the floor (where
    ``jnp.maximum`` halves the gradient), within 2e-5 of each one's max."""
    b, l, h, d = 2, 40, 3, 8
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    la = (-np.logaddexp(rng.standard_normal((b, l, h, d)), 0) * 0.5).astype(np.float32)
    la[0, 3, 1, :4] = LA.LOG_A_MIN
    la[1, 17, 0, 2] = -3.0
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.5).astype(np.float32)
    go = rng.standard_normal((b, l, h, d)).astype(np.float32)
    gs = rng.standard_normal((b, h, d, d)).astype(np.float32)
    uu = u if mode == "rwkv" else np.zeros_like(u)

    def jf(q, k, v, la, u, s0):
        return JLA.chunked_linear_attn(q, k, v, la, chunk=8, mode=mode,
                                       u=u if mode == "rwkv" else None, s0=s0)

    _, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v, la, uu, s0)))
    want = vjp((jnp.asarray(go), jnp.asarray(gs)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, la, uu, s0)]
    o, s = LA.chunked_linear_attn(*ts[:4], chunk=8, mode=mode,
                                  u=ts[4] if mode == "rwkv" else None, s0=ts[5])
    got = torch.autograd.grad((o, s), ts, (torch.from_numpy(go), torch.from_numpy(gs)),
                              allow_unused=True)
    for name, g, w in zip(("q", "k", "v", "log_a", "u", "s0"), got, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.abs(g - w).max() <= 2e-5 * max(np.abs(w).max(), 1e-30), name


def test_activation_grads_match_jax():
    """sigmoid, softplus and log_sigmoid: their gradients within 1e-6 of
    JAX's (softplus's 0.5 at 0 included), and finite where autograd through
    the formula gives nan (sigmoid below -88: inf * 0)."""
    x = np.concatenate([np.random.default_rng(0).standard_normal(4000) * 8,
                        [-200.0, -100.0, -89.0, -20.0, 0.0, 20.0, 100.0]]).astype(np.float32)
    for name, jf in (("sigmoid", jax.nn.sigmoid), ("softplus", jax.nn.softplus),
                     ("log_sigmoid", jax.nn.log_sigmoid)):
        want = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(x)))
        tx = torch.from_numpy(x).requires_grad_()
        (got,) = torch.autograd.grad(getattr(L, name)(tx).sum(), tx)
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=name)
    tx = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(L.softplus(tx).sum(), tx)
    assert torch.equal(g, torch.full((3,), 0.5))


def test_xla_cumsum_grad_matches_jax(rng):
    """``xla_cumsum`` under autograd (its blocked scan writes in place on
    the CPU) against ``jnp.cumsum``'s vjp, along a middle axis."""
    x = rng.standard_normal((2, 300, 5)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jnp.cumsum(a, axis=1), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(L.xla_cumsum(tx, 1), tx, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-4)


def test_rwkv_decay_clip_grad_matches_jax(rng):
    """The decay LoRA's clip to [-8, 4] with w0 putting lanes exactly at
    both bounds: half the gradient there, as ``jnp.clip`` (max, then min)
    gives, where ``torch.clamp`` would pass it whole; every gradient within
    1e-5 of its max."""
    d, n = 16, 8
    xr = rng.standard_normal((3, d)).astype(np.float32)
    w1 = rng.standard_normal((d, R.DECAY_LORA)).astype(np.float32) * 0.1
    w2 = np.zeros((R.DECAY_LORA, n), np.float32)
    w0 = np.array([-8.0, 4.0, -9.0, 5.0, 0.0, -2.0, 3.9, -7.9], np.float32)
    p = {"w_decay1": w1, "w_decay2": w2, "w0": w0}
    _, vjp = jax.vjp(lambda p: JR._decay_log(p, jnp.asarray(xr)), jax.tree.map(jnp.asarray, p))
    g = np.ones((3, n), np.float32)
    want = vjp(jnp.asarray(g))[0]
    ts = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    la = R._decay_log(ts["w_decay1"], ts["w_decay2"], ts["w0"], torch.from_numpy(xr))
    got = torch.autograd.grad(la, list(ts.values()), torch.from_numpy(g))
    for (name, _), a in zip(ts.items(), got):
        w = np.asarray(want[name])
        assert np.abs(a.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name
    w0 = ts["w0"].detach().requires_grad_()
    whole = -torch.exp(torch.clamp(w0 + 0 * la.detach()[:1], -8.0, 4.0))
    (g_whole,) = torch.autograd.grad(whole.sum(), w0)
    g_w0 = got[2] / 3                           # three rows, each at the bound
    assert torch.equal(g_w0[:2], g_whole[:2] / 2) and (got[2][2:4] == 0).all()


def test_bf16_gla_matches_eager_jax():
    bf16_matches_eager_jax("gla-1.3b", seq=40)
