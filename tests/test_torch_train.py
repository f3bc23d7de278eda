"""The port's training forward and gradients against the JAX package.

The same master weights (``bridge.load_master_tree`` of the JAX package's
``init_params``) and the same batch go through ``repro``'s jitted
``jax.value_and_grad(loss_fn)`` and the port's ``loss_fn`` under autograd:
the loss within 1e-5 relative and the gradient of every master leaf
within 1e-4 of that leaf's max |grad| (float32, reduced configs: d_model
64, 2 layers a period, B = 2 x 64 tokens, so LPSA's 8 + 24 and the local
window of 32 cut keys).

Where the two packages land on opposite sides of a rounding or ranking tie
(an int8 fake-quant value at a .5 boundary, a DAS rank at equal
magnitudes), the difference is not a fault of either: a float32 ulp of the
input moves it.  A whole lane's gradient then flows on one side and not on
the other, far beyond 1e-4.  The tanh GELU makes such ties common: 1 +
tanh(u) cancels as u saturates, so XLA's and libm's tanh (each within an
ulp) give a negative input's GELU ~1e-5 apart relatively, and exact zeros
on one side only.  So ``Decisions`` records every DAS mask and int8 value
the jitted JAX step decided (``jax.debug.callback``) and the port takes
those decisions where its own differ, but only at a near tie of the port's
own input: a DAS block whose keep-th and next largest |x| lie within 1e-5
of each other (relative), an int8 value whose |x / scale| lies within
1e-5 (relative) of a .5 boundary.  Any other difference fails, as does a
count above 0.01 % of the decisions.  Seen: 11 of 163840 on
musicgen-medium, 2 on gemma2-2b, 1 int8 value on bitnet-1.3b with DAS off,
0 with it on; the farthest from its tie 7.6e-6 (|x / scale| = 3.50003,
bitnet-1.3b with DAS and LPSA off).  ``Decisions`` also replays the MoE's
expert-stack trits and takes a DAS lane within 1e-5 of zero (relative to
its row's max) as a tie with zero (tests/test_torch_train_moe.py,
_ssm.py).  Everything else is compared at the tolerances above.

Also: the STE fake-quants (forward equal, identity backward), remat on and
off bitwise, a scan-stacked tree, ``flash_masked`` alone (chunks, GQA,
soft-cap, LPSA) within 1e-5, and a bfloat16 model against eager ``repro``
within 2e-2 of each leaf's max (its roundings taken as they come).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.core import das as jdas
from repro.core import ternary as jtq
from repro.models import attention as JA
from repro.models import model as JMD
from repro.models.transformer import Runtime as JRuntime
from repro_torch.bridge import load_master_tree, to_torch
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.core import das as tdas
from repro_torch.core import ternary as ttq
from repro_torch.models import attention as TA
from repro_torch.models import model as MD
from repro_torch.tree import leaves, leaves_with_paths
from test_torch_hybrid import one_thread  # noqa: F401
from torch_ties import MAX_FORCED, TIE_RTOL, das_gaps, int8_gaps, near_zero

B, S = 2, 64
LOSS_RTOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2


def cfg_pair(arch, *, das=True, moe=None, **kw):
    """(jax cfg, port cfg) of the reduced arch, ``kw`` replaced on both, and
    the fields in ``moe`` on both MoE configs."""
    out = []
    for base, get in ((jbase, jget_config), (tbase, get_config)):
        cfg = base.reduced(get(arch))
        if not das:
            cfg = dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary, das=None))
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        out.append(dataclasses.replace(cfg, **kw))
    return tuple(out)


def make_batch(cfg, seed=0, seq=S):
    """Token ids (or float32 embeddings for a stub frontend) and next-token
    labels, a few of them -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    if JMD.uses_embeds(cfg):
        inputs = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
    else:
        inputs = toks[:, :-1]
    return {"inputs": inputs, "labels": labels}


def jax_params(jcfg, seed=0):
    return JMD.init_params(jax.random.PRNGKey(seed), jcfg)


def port_loss_grads(tcfg, tparams, batch, rt=None):
    loss, _ = MD.loss_fn(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                         rt or MD.Runtime())
    flat = leaves(tparams)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return float(loss.detach()), grads


def ternary_gaps(w, gamma, diff):
    """Per differing trit, how far |w / gamma| lies from the .5 boundary,
    relative to |w / gamma| (the one boundary the clip to [-1, 1] keeps)."""
    r = (w.detach().float() / gamma.float()).abs()[diff]
    return (r - 0.5).abs() / r


class _Forced(torch.autograd.Function):
    """A fake-quant's forced value forward, the identity backward (the STE)."""

    @staticmethod
    def forward(ctx, w, value):
        return value

    @staticmethod
    def backward(ctx, g):
        return g, None


class Decisions:
    """The DAS masks, int8 values and expert-stack trits that jitted JAX
    steps decided, replayed into the port's next step where the port decides
    otherwise at a near tie of its own input (``at_tie``).  Records are kept
    in call order, one queue a kind, one record per distinct input (its
values, whatever its shape: the MoE's shared expert masks the rows the
routed experts' dispatch masked, in another shape): the JAX
    package masks and quantizes the shared input of q/k/v and of gate/up
    once per projection, the port once; and where the port meets an input
    again (rwkv's four token-shift mixes are equal while the mix weights
    are), it takes the decision it took the first time.  The trits of an
    expert stack (``ternary_fake_quant_stacked``) are a decision too: its
    per-expert absmean scale is a float32 mean whose summation order differs
    by an ulp between XLA and torch, which moves a |w / scale| at .5."""

    KINDS = ("das", "int8", "ternary")

    def __init__(self, monkeypatch):
        self.mp, self.records, self.forced, self.total = monkeypatch, [], 0, 0
        self.zero_ties = 0          # DAS lanes near zero taken from JAX (``near_zero``)
        self.queue, self.seen = {}, {}
        self._orig = (tdas.das_mask, ttq.int8_quantize, ttq.ternary_fake_quant_stacked)
        self._forcing = False
        self.worst_gap = 0.0

    def record_jax(self):
        """Record from every JAX step traced from now on."""
        def tap(kind, fn):
            def wrapped(x, **kw):
                out = fn(x, **kw)
                val = {"das": lambda o: o, "int8": lambda o: o.values,
                       "ternary": jnp.sign}[kind](out)
                jax.debug.callback(lambda xv, v: self.records.append(
                    (kind, np.asarray(xv), np.asarray(v))), x, val, ordered=True)
                return out
            return wrapped
        self.mp.setattr(jdas, "das_mask", tap("das", jdas.das_mask))
        self.mp.setattr(jtq, "int8_quantize", tap("int8", jtq.int8_quantize))
        self.mp.setattr(jtq, "ternary_fake_quant_stacked",
                        tap("ternary", jtq.ternary_fake_quant_stacked))

    def _distinct(self):
        out, seen = {k: [] for k in self.KINDS}, set()
        for kind, x, v in self.records:
            key = (kind, x.dtype.str, x.tobytes())
            if key not in seen:
                seen.add(key)
                out[kind].append(v)
        return out

    def force_port(self):
        """The port's next step takes the decisions recorded since the last
        call."""
        jax.effects_barrier()
        self.queue = {k: iter(v) for k, v in self._distinct().items()}
        self.records, self.seen = [], {}
        if self._forcing:
            return
        self._forcing = True
        orig_mask, orig_q, orig_t = self._orig

        def want(kind, x, like):
            """JAX's decision for the port's call on x; a call on an input
            the port met before in this step takes that decision again, as
            the records keep one per distinct input."""
            x = x.detach().numpy()
            key = (kind, x.dtype.str, x.tobytes())
            if key not in self.seen:
                v = next(self.queue[kind], None)
                assert v is not None, f"the port made a {kind} decision JAX did not"
                self.seen[key] = torch.from_numpy(np.array(v)).reshape(like.shape)
            return self.seen[key]

        def count(kind, diff, gaps):
            if diff.any():
                self.at_tie(kind, gaps())
            self.forced += int(diff.sum())
            self.total += diff.numel()

        def mask(x, *, block_size=tdas.DEFAULT_BLOCK, keep=tdas.DEFAULT_BLOCK // 2):
            own = orig_mask(x, block_size=block_size, keep=keep)
            w = want("das", x, own)
            diff = own != w
            if diff.any():
                self.at_tie("DAS", das_gaps(x, diff, block_size, keep))
            # a lane near zero kept or dropped leaves x * mask within 1e-5
            # of its row's scale: counted apart
            main = x.shape[-1] - x.shape[-1] % block_size
            zero = torch.zeros_like(diff)
            zero[..., :main] = near_zero(x, block_size).reshape(zero[..., :main].shape)
            self.forced += int((diff & ~zero).sum())
            self.zero_ties += int((diff & zero).sum())
            self.total += diff.numel()
            return w

        def quant(x, **kw):
            own = orig_q(x, **kw)
            w = want("int8", x, own.values)
            diff = own.values != w
            count("int8", diff, lambda: int8_gaps(x, own.scale, diff))
            return ttq.QuantizedActivation(w, own.scale)

        def stacked(w):
            own = orig_t(w)
            gamma = w.detach().abs().mean(dim=tuple(range(1, w.ndim)), keepdim=True,
                                          dtype=torch.float32).to(w.dtype) + ttq.EPS
            q = torch.sign(own.detach())
            q_want = want("ternary", w, q).to(q.dtype)
            diff = q != q_want
            count("ternary", diff, lambda: ternary_gaps(w, gamma, diff))
            if not diff.any():
                return own
            return _Forced.apply(w, (q_want * gamma).to(w.dtype))

        self.mp.setattr(tdas, "das_mask", mask)
        self.mp.setattr(ttq, "int8_quantize", quant)
        self.mp.setattr(ttq, "ternary_fake_quant_stacked", stacked)

    def at_tie(self, kind, gaps):
        """Every decision that differs lies at a near tie of the port's input."""
        worst = float(gaps.max())
        assert worst <= TIE_RTOL, \
            f"a {kind} decision differs from JAX's {worst:.2e} (relative) away from a tie"
        self.worst_gap = max(self.worst_gap, worst)

    def check(self):
        assert self.total > 0
        assert all(next(q, None) is None for q in self.queue.values()), \
            "JAX made a decision the port did not"
        assert self.forced <= MAX_FORCED * self.total, \
            f"{self.forced} of {self.total} DAS / int8 / trit decisions differ from JAX's"


def compare(label, jloss, jgrads, tloss, tgrads, tparams, loss_rtol=LOSS_RTOL, tol=GRAD_TOL):
    assert abs(tloss - jloss) <= loss_rtol * abs(jloss), f"{label}: loss {tloss} vs {jloss}"
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(tgrads)
    for (path, _), g, j in zip(leaves_with_paths(tparams), tgrads, jflat):
        j = np.asarray(j, np.float32)
        g = g.float().numpy()
        scale = max(float(np.abs(j).max()), 1e-30)
        err = float(np.abs(g - j).max())
        assert err <= tol * scale, f"{label}: {path} off by {err / scale:.2e} of its max"


def matches_jax(arch, monkeypatch, *, das=True, lpsa=True, seq=S, **kw):
    """Loss and every master leaf's gradient of the reduced arch in f32 over
    sequences of ``seq`` tokens, the port's DAS / int8 decisions taken from
    the jitted JAX step where they differ."""
    jcfg, tcfg = cfg_pair(arch, das=das, **kw)
    jp = jax_params(jcfg)
    batch = make_batch(jcfg, seq=seq)
    dec = Decisions(monkeypatch)
    dec.record_jax()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JMD.loss_fn(p, jcfg, b, JRuntime(serve_sparse=lpsa)), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    dec.force_port()
    tp = load_master_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tl, tg = port_loss_grads(tcfg, tp, batch, MD.Runtime(serve_sparse=lpsa))
    dec.check()
    compare(f"{arch} das={das} lpsa={lpsa}", float(jl), jg, tl, tg, tp)
    return dec


# --------------------------------------------------------------------------
# the straight-through fake-quants
# --------------------------------------------------------------------------

STES = {
    "ternary": (jtq.ternary_fake_quant, ttq.ternary_fake_quant),
    "int8": (jtq.int8_fake_quant, ttq.int8_fake_quant),
    "stacked": (jtq.ternary_fake_quant_stacked, ttq.ternary_fake_quant_stacked),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(STES))
def test_ste_forward_matches_jax_and_backward_is_identity(name, dtype, rng):
    jf, tf = STES[name]
    shape = (3, 40, 24) if name == "stacked" else (40, 24)
    x = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = to_torch(np.asarray(jx)).requires_grad_()
    want = np.asarray(jf(jx).astype(jnp.float32))
    got = tf(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=1e-6, atol=0)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tx.dtype)
    (dx,) = torch.autograd.grad(got, tx, g)
    assert torch.equal(dx, g)
    jg = jax.grad(lambda a: jnp.sum(jf(a).astype(jnp.float32) * jnp.asarray(
        g.float().numpy())))(jx)
    np.testing.assert_array_equal(np.asarray(jg.astype(jnp.float32)), g.float().numpy())


@pytest.mark.parametrize("per_channel", [False, True])
def test_absmean_scale_and_dequantize(rng, per_channel):
    w = rng.standard_normal((48, 20)).astype(np.float32)
    jtw = jtq.ternary_quantize(jnp.asarray(w), per_channel=per_channel)
    ttw = ttq.ternary_quantize(torch.from_numpy(w), per_channel=per_channel)
    assert ttw.scale.shape == tuple(jtw.scale.shape)
    np.testing.assert_allclose(ttw.scale.numpy(), np.asarray(jtw.scale), rtol=1e-6)
    np.testing.assert_array_equal(ttw.values.numpy(), np.asarray(jtw.values))
    np.testing.assert_allclose(ttq.ternary_dequantize(ttw).numpy(),
                               np.asarray(jtq.ternary_dequantize(jtw)), rtol=1e-6)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    np.testing.assert_allclose(
        ttq.ternary_matmul_ref(torch.from_numpy(x), ttw.values, ttw.scale).numpy(),
        np.asarray(jtq.ternary_matmul_ref(jnp.asarray(x), jtw.values, jtw.scale)),
        rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# flash_masked alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 50.0], ids=["nocap", "cap50"])
@pytest.mark.parametrize("sink,window,chunk", [(8, 24, 16), (1 << 30, 0, 512), (0, 32, 16)],
                         ids=["lpsa", "full", "local"])
def test_flash_masked_matches_jax(rng, sink, window, chunk, cap):
    """GQA 4 over 2 heads, 64 keys in chunks of 16 (or one), positions
    per sequence with an empty key: the output and the gradients of q, k, v
    within 1e-5 of each one's max."""
    hq, hkv, d = 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, d)).astype(np.float32) * 3 for h in (hq, hkv, hkv))
    g = rng.standard_normal((B, S, hq, d)).astype(np.float32)
    qpos = np.tile(np.arange(S), (B, 1))
    kpos = qpos.copy()
    kpos[1, 3] = -1
    kw = dict(sink=sink, window=window, softcap=cap, kv_chunk=chunk)
    jo, vjp = jax.vjp(lambda a, b, c: JA.flash_masked(a, b, c, jnp.asarray(qpos),
                                                      jnp.asarray(kpos), **kw),
                      *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = TA.flash_masked(tq, tk, tv, torch.from_numpy(qpos), torch.from_numpy(kpos), **kw)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(g))
    for name, got, want in (("out", to.detach(), jo), *zip("qkv", tg, jg)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, f"{name}: {err:.2e} of its max"


# --------------------------------------------------------------------------
# the reduced models in float32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lpsa", [True, False], ids=["lpsa", "full"])
@pytest.mark.parametrize("das", [True, False], ids=["das", "dense"])
def test_bitnet_loss_and_grads_match_jax(monkeypatch, das, lpsa):
    matches_jax("bitnet-1.3b", monkeypatch, das=das, lpsa=lpsa)


@pytest.mark.parametrize("arch", ["gemma2-2b", "musicgen-medium"])
def test_zoo_loss_and_grads_match_jax(monkeypatch, arch):
    """gemma2-2b: both soft-caps, local and global layers, the embedding
    scale, tanh GELU; musicgen-medium: float32 embeddings, the 2-matrix
    GELU MLP, the untied head (the embedding takes no gradient)."""
    dec = matches_jax(arch, monkeypatch)
    print(f"{arch}: {dec.forced} of {dec.total} DAS / int8 decisions taken from JAX, "
          f"each within {dec.worst_gap:.2e} of a tie")


def test_scan_stacked_tree_matches_jax(monkeypatch):
    """A scan-stacked master tree (a leading group axis on every leaf of
    the pattern's positions) runs group by group and takes its gradient
    stacked, as the JAX package's scan does."""
    matches_jax("gemma3-1b", monkeypatch, scan_layers=True, n_layers=6)


def test_remat_gives_the_same_grads():
    """remat (torch.utils.checkpoint per layer, the forward run again in the
    backward) changes nothing: loss and gradients bitwise."""
    jcfg, tcfg = cfg_pair("bitnet-1.3b")
    tree = jax.tree.map(np.asarray, jax_params(jcfg))
    batch = make_batch(jcfg)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        runs.append(port_loss_grads(cfg, load_master_tree(tree, cfg, "cpu"), batch))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# bfloat16
# --------------------------------------------------------------------------

def bf16_matches_eager_jax(arch, *, seq=S, **kw):
    """The reduced arch with bfloat16 masters: loss and gradients against
    the JAX package run eagerly (jitted, XLA skips bfloat16 roundings inside
    its fusions) within 2e-2 of each leaf's max."""
    jcfg, tcfg = cfg_pair(arch, dtype="bfloat16", **kw)
    jp = jax_params(jcfg)
    batch = make_batch(jcfg, seq=seq)
    with jax.disable_jit():
        (jl, _), jg = jax.value_and_grad(lambda p: JMD.loss_fn(
            p, jcfg, jax.tree.map(jnp.asarray, batch), JRuntime()), has_aux=True)(jp)
    tp = load_master_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in leaves(tp))
    tl, tg = port_loss_grads(tcfg, tp, batch)
    assert all(g.dtype == torch.bfloat16 for g in tg)
    compare(f"{arch} bf16", float(jl), jg, tl, tg, tp, loss_rtol=BF16_TOL, tol=BF16_TOL)


def test_bf16_bitnet_matches_eager_jax():
    """Reduced bitnet-1.3b with bfloat16 masters against eager ``repro``."""
    bf16_matches_eager_jax("bitnet-1.3b")
