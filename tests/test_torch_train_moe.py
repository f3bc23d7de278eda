"""The port's MoE training pass against the JAX package.

``moe.moe_train`` is ``repro``'s no-mesh ``moe_apply`` under autograd: the
expert stacks through ``ternary_fake_quant_stacked``, the float32 router,
the experts' input DAS-masked and int8 fake-quantized, the dispatch at the
training capacity.  Its dispatch and combine are gathers through the slot
<-> copy maps whose backward is the inverse gather, with no atomics.

Reduced qwen3-moe-30b-a3b (8 experts, top-2, d_model 64, 2 layers) and
kimi-k2-1t-a32b (with its shared expert): the loss within 1e-5 relative and
every master leaf's gradient within 1e-4 of that leaf's max against the
jitted JAX step, with DAS on and off, and at ``capacity_factor=1.0``, where
copies drop (both sides drop the same ones: the same stable-argsort ranks).
Where the two packages decide on opposite sides of a tie, the port takes
JAX's decision (``test_torch_train.Decisions``, which also covers the
expert stacks' trits: their per-expert absmean scale differs by an ulp
between XLA's and torch's float32 sums).  The dispatch's backward alone:
each token's gradient is the sum of its kept copies' rows in routing order,
bitwise, and a dropped copy adds exactly zero.  bfloat16 masters against
eager ``repro`` within 2e-2.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from test_torch_hybrid import one_thread  # noqa: F401
from test_torch_train import bf16_matches_eager_jax, matches_jax

ARCH = "qwen3-moe-30b-a3b"


@pytest.mark.parametrize("das", [True, False], ids=["das", "dense"])
def test_moe_loss_and_grads_match_jax(monkeypatch, das):
    matches_jax(ARCH, monkeypatch, das=das)


@pytest.mark.parametrize("das", [True, False], ids=["das", "dense"])
def test_moe_with_drops_matches_jax(monkeypatch, das):
    """capacity_factor 1.0: 33 slots an expert for 2 x 64 tokens x top-2,
    so the busiest experts drop copies, in both packages alike."""
    seen = []
    orig = MOE.dispatch_compute

    def counting(x_tok, x_in, weights, router, cfg, capacity):
        out, counts = orig(x_tok, x_in, weights, router, cfg, capacity)
        seen.append(int((counts - capacity).clamp(min=0).sum()))
        return out, counts

    monkeypatch.setattr(MOE, "dispatch_compute", counting)
    matches_jax(ARCH, monkeypatch, das=das, moe={"capacity_factor": 1.0})
    assert len(seen) == 2 and all(n > 0 for n in seen), f"dropped copies a layer: {seen}"


def test_kimi_shared_expert_matches_jax(monkeypatch):
    """kimi-k2-1t-a32b reduced: the routed experts and the shared expert,
    whose gate and up take the experts' masked, int8 fake-quantized rows."""
    matches_jax("kimi-k2-1t-a32b", monkeypatch)


def test_dispatch_backward_has_no_atomics_and_drops_give_zero():
    """The dispatch's and the combine's backward are inverse gathers: a
    token's input gradient is its kept copies' buffer-row gradients added in
    routing order (bitwise), a token whose copies all drop gets exactly zero,
    and an empty buffer row's output gradient is exactly zero."""
    cfg = tbase.reduced(get_config(ARCH))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    e, k, d, t = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, 96
    cap = MOE.prefill_capacity(cfg, t)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((t, d), generator=gen)
    router = torch.randn((d, e), generator=gen)
    r = MOE.route(x, router, cfg, cap)
    dropped = r.slot == e * cap
    assert dropped.any() and (~dropped).any()
    xin = x.clone().requires_grad_()
    buf = MOE._Dispatch.apply(xin, r.source, r.slot, k)
    gbuf = torch.randn(buf.shape, generator=gen)
    (gx,) = torch.autograd.grad(buf, xin, gbuf)
    want = torch.zeros_like(x)
    for tok in range(t):
        acc = None
        for c in range(tok * k, tok * k + k):
            row = gbuf[r.slot[c]] if not dropped[c] else torch.zeros(d)
            acc = row if acc is None else acc + row
        want[tok] = acc
    assert torch.equal(gx, want)
    all_dropped = dropped.view(t, k).all(-1)
    assert torch.equal(gx[all_dropped], torch.zeros_like(gx[all_dropped]))
    y = torch.randn((e * cap, d), generator=gen, requires_grad=True)
    yc = MOE._Combine.apply(y, r.slot, r.copy)
    assert torch.equal(yc[dropped], torch.zeros_like(yc[dropped]))
    gyc = torch.randn(yc.shape, generator=gen)
    (gy,) = torch.autograd.grad(yc, y, gyc)
    empty = r.copy == t * k
    assert empty.any()
    assert torch.equal(gy[empty], torch.zeros_like(gy[empty]))
    assert torch.equal(gy[~empty], gyc[r.copy[~empty]])


def test_bf16_moe_matches_eager_jax():
    bf16_matches_eager_jax(ARCH, seq=40)
