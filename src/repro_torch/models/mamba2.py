"""Mamba2 (SSD), the mixer of zamba2's blocks, in the chunked state-space
duality form.

Per head h with scalar decay a_t = exp(dt_t * A_h), A_h < 0:

    S_t = a_t S_{t-1} + dt_t * x_t (x) B_t        S: (hd, N)
    y_t = S_t C_t + D_h x_t

The prefill (``mamba_prefill``) runs the JAX package's chunk grid: inside
a chunk an attention-like masked product with decay weights
exp(La_t - La_s), across chunks the carried state; a loop over chunks of
float32 einsums with TF32 off, as models/linear_attn.py loops.  The decode
step (``mamba_decode``) replays that grid instead of the stepwise
recurrence: the state holds the carry at the last full chunk boundary plus
one chunk of per-token buffers; each step writes its token's row,
recomputes the row's output from the buffers and the carry, and folds the
buffers into the carry when the chunk fills.  A decode thus stays on the
prefill's float32 grid (the stepwise recurrence drifts by ~1e-7 a step,
which DAS's top-k turns into whole flips).  Every step computes the fold
and selects it per row, with no host branch, and writes the state in
place: the engine's CUDA graph holds its storage.

The projections: wz and wx ternary, fed by one DAS step with the block's
rmsnorm inside it, which also gives the normed rows to the dense wb, wc (in
x's dtype) and wdt (float32); the depthwise causal conv of width 4 in
float32; the gated rmsnorm over d_inner; the ternary wo.  Where XLA fixes a
float32 order the port takes it: the cumulative sums
(``layers.xla_cumsum``), the decode conv's multiply-add a tap
(``_conv_taps``), softplus's formula.  The module's buffers are named as
the JAX tree's leaves.

``mamba_train`` is the training pass over whole sequences on a master tree
(the JAX package's ``mamba_train`` without ``return_state``): the prefill's
conv, chunk grid and gated norm (``_ssd``, ``_gated_norm``: one copy of the
math for both) under autograd, with the projections on master weights
through the STE fake-quants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import RMSNorm, full_f32, rmsnorm, silu, softplus, xla_cumsum
from repro_torch.models.ternary_linear import TernaryLinear, tlin_init, tlin_train, tlin_train_input

__all__ = ["Mamba2", "mamba_dims", "mamba_init", "init_state", "mamba_prefill", "mamba_train",
           "SsdStep", "ssd_step_inputs", "ssd_write", "ssd_row", "ssd_fold", "mamba_decode"]


def mamba_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(d_inner, SSM heads)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        s, d, tc = cfg.ssm, cfg.d_model, cfg.ternary
        di, nh = mamba_dims(cfg)
        self.wz = TernaryLinear(d, di, tc, device)
        self.wx = TernaryLinear(d, di, tc, device)

        def buf(name, shape):
            self.register_buffer(name, torch.zeros(shape, dtype=dtype, device=device))

        buf("wb", (d, s.state_dim))
        buf("wc", (d, s.state_dim))
        buf("wdt", (d, nh))
        buf("dt_bias", (nh,))
        buf("a_log", (nh,))
        buf("d_skip", (nh,))
        buf("conv", (s.conv_width, di))
        self.norm = RMSNorm(di, dtype, device)
        self.wo = TernaryLinear(di, d, tc, device)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Master weights in the JAX package's tree layout, drawn from ``gen`` in
    a fixed order, the constants as the JAX package sets them: A = -(1..nh),
    D ones, the conv N(0, 0.2^2), wo scaled by (d_inner * 2 * layers)^-1/2."""
    s, d, dev = cfg.ssm, cfg.d_model, gen.device
    di, nh = mamba_dims(cfg)

    def dense(d_in, d_out):
        w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
        return w.to(dtype)

    p = {"wz": tlin_init(gen, d, di, dtype), "wx": tlin_init(gen, d, di, dtype),
         "wb": dense(d, s.state_dim), "wc": dense(d, s.state_dim), "wdt": dense(d, nh),
         "dt_bias": torch.zeros(nh, dtype=dtype, device=dev),
         "a_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=dev)).to(dtype),
         "d_skip": torch.ones(nh, dtype=dtype, device=dev)}
    p["conv"] = (torch.randn((s.conv_width, di), generator=gen, device=dev) * 0.2).to(dtype)
    p["norm"] = {"scale": torch.zeros(di, dtype=dtype, device=dev)}
    p["wo"] = tlin_init(gen, di, d, dtype, scale=(di * 2 * cfg.n_layers) ** -0.5)
    return p


def init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The zero decode state of ``batch`` rows, float32 (the ``mamba`` cache
    layout): the conv's last cw - 1 inputs (B, cw - 1, d_inner), the carry
    ``ssm`` (B, nh, hd, N), and one chunk of per-token buffers ``ssd_x``
    (B, chunk, nh, hd), ``ssd_b``, ``ssd_c`` (B, chunk, N), ``ssd_dt`` (B,
    chunk, nh)."""
    s = cfg.ssm
    di, nh = mamba_dims(cfg)

    def zeros(*shape):
        return torch.zeros((batch,) + shape, dtype=torch.float32, device=device)

    return {"conv": zeros(s.conv_width - 1, di), "ssm": zeros(nh, s.head_dim, s.state_dim),
            "ssd_x": zeros(s.chunk, nh, s.head_dim), "ssd_b": zeros(s.chunk, s.state_dim),
            "ssd_c": zeros(s.chunk, s.state_dim), "ssd_dt": zeros(s.chunk, nh)}


def _proj(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, norm_scale: torch.Tensor):
    """The residual x (B, L, D) -> z, xs (B, L, d_inner) and B, C (B, L, N)
    in x's dtype, dt (B, L, nh) float32, all of ``rmsnorm(norm_scale, x)``."""
    b, l, d = x.shape
    das = cfg.ternary.das
    if das is None:
        xin = normed = rmsnorm(norm_scale, x)
        ca = None
    else:
        ca = ops.das_topk(x, keep=das.keep, block=das.block, norm_scale=norm_scale,
                          with_mask=False, with_normed=True)
        xin, normed = x, ca.normed.reshape(b, l, d)
    z, xs = p.wz(xin, ca), p.wx(xin, ca)
    return (z, xs, *_dense_proj(p.wb, p.wc, p.wdt, p.dt_bias, normed))


def _dense_proj(wb, wc, wdt, dt_bias, normed: torch.Tensor):
    """B, C (B, L, N) in the normed rows' dtype and dt = softplus(x Wdt +
    bias) (B, L, nh) float32, TF32 off."""
    with full_f32():
        bmat = normed @ wb.to(normed.dtype)
        cmat = normed @ wc.to(normed.dtype)
        dt = softplus(normed.float() @ wdt.float() + dt_bias.float())
    return bmat, cmat, dt


def _gated_norm(norm_scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated rmsnorm over d_inner, wo's input: y, z (B, L, d_inner) in
    x's dtype."""
    return rmsnorm(norm_scale, y * silu(z))


def _conv_prefill(conv: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv (taps ``conv`` (cw, d_inner)) over xs (B,
    L, d_inner) from a zero past, in float32: the taps' products added one at
    a time, as the JAX package sums them; silu in float32, cast to xs's
    dtype."""
    w = conv.float()
    cw, l = w.shape[0], xs.shape[1]
    xp = F.pad(xs.float(), (0, 0, cw - 1, 0))
    out = xp[:, :l] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + l] * w[i]
    return silu(out).to(xs.dtype)


def _conv_taps(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i xw[:, i] * w[i] over the taps of xw (B, cw, d_inner) float32,
    as XLA's CPU dot computes the decode conv: a fused multiply-add a tap in
    order, emulated with each product exact in float64 and each sum rounded
    to float32 (``torch.einsum`` sums in another order, and differs in ~40 %
    of the values)."""
    prod = xw.double() * w.double()
    acc = prod[:, 0].float()
    for i in range(1, w.shape[0]):
        acc = (prod[:, i] + acc.double()).float()
    return acc


def _ssd_chunk(s_in, xb, bb, cb, dtb, la, causal):
    """One SSD chunk of any width c: xb (B, c, nh, hd), bb, cb (B, c, N),
    dtb, la (B, c, nh), the carry s_in (B, nh, hd, N), all float32 -> (y
    (B, c, nh, hd), the carry after the chunk)."""
    cla = xla_cumsum(la, 1)
    # pairwise decay exp(cla_t - cla_s), the difference clamped at 0 so the
    # masked t < s entries cannot overflow (torch.minimum: the gradient
    # splits at the diagonal's tie, as jnp.minimum's)
    decay = torch.exp(torch.minimum(cla[:, :, None, :] - cla[:, None, :, :],
                                    torch.zeros((), device=cla.device)))
    scores = torch.einsum("btn,bsn->bts", cb, bb)[..., None] * decay
    scores = torch.where(causal[None, :, :, None], scores, 0.0) * dtb[:, None]
    y = torch.einsum("btsh,bshd->bthd", scores, xb)
    y = y + torch.exp(cla)[..., None] * torch.einsum("bhdn,btn->bthd", s_in, cb)
    la_end = cla[:, -1:]
    b_state = (torch.exp(la_end - cla) * dtb)[..., None] * bb[:, :, None, :]
    s_out = (torch.exp(la_end)[:, 0, :, None, None] * s_in
             + torch.einsum("bshd,bshn->bhdn", xb, b_state))
    return y, s_out


def _run_chunks(s, seq, c: int):
    """The chunks of width c over ``seq`` (xh, B, C, dt, log a; each (B,
    n * c, ...)) from the carry s -> (y (B, n * c, nh, hd), the carry after
    the last chunk)."""
    causal = torch.ones((c, c), dtype=torch.bool, device=s.device).tril()
    ys = []
    for i in range(seq[0].shape[1] // c):
        y, s = _ssd_chunk(s, *(t[:, i * c:(i + 1) * c] for t in seq), causal)
        ys.append(y)
    return torch.cat(ys, 1), s


def _chunk_grid(seq, chunk: int, s0: torch.Tensor):
    """The JAX package's chunk grid over ``seq`` (xh, B, C, dt, log a; each
    (B, L, ...) float32) from the carry s0: without a full chunk, or
    without a remainder, one grid of width min(chunk, L); else L // chunk
    full chunks, then one chunk of the remainder.  -> (y (B, L, nh, hd),
    the carry at the last full chunk boundary: s0 when there is none)."""
    l = seq[0].shape[1]
    n_full, rem = divmod(l, chunk)
    with full_f32():
        if n_full == 0 or rem == 0:
            y, s_fin = _run_chunks(s0, seq, min(chunk, l))
            return y, (s_fin if n_full else s0)
        split = n_full * chunk
        y_full, s_bound = _run_chunks(s0, [t[:, :split] for t in seq], chunk)
        y_rem, _ = _run_chunks(s_bound, [t[:, split:] for t in seq], rem)
    return torch.cat([y_full, y_rem], 1), s_bound


def _ssd(cfg: ModelConfig, conv, a_log, d_skip, xs: torch.Tensor, bmat: torch.Tensor,
         cmat: torch.Tensor, dt: torch.Tensor, s0: torch.Tensor):
    """The conv, the chunk grid from the carry s0 and the D skip over a
    sequence -> (y (B, L, d_inner) float32, seq (xh, B, C, dt, log a) float32,
    the carry at the last full chunk boundary)."""
    b, l, di = xs.shape
    s = cfg.ssm
    nh = di // s.head_dim
    with torch.profiler.record_function("mamba_ssd"):
        xh = _conv_prefill(conv, xs).reshape(b, l, nh, s.head_dim)
        a = -torch.exp(a_log.float())
        seq = (xh.float(), bmat.float(), cmat.float(), dt, dt * a)
        y, s_bound = _chunk_grid(seq, s.chunk, s0)
        y = y + d_skip.float()[:, None] * seq[0]
    return y.reshape(b, l, di), seq, s_bound


def mamba_prefill(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, norm_scale: torch.Tensor):
    """The mixer over a prompt from the zero state: the residual x (B, L, D)
    normed by ``norm_scale`` -> (y (B, L, D), the decode state).

    The chunk grid is the JAX package's (``_chunk_grid``).  The state (the
    ``mamba`` cache layout) holds the conv's last cw - 1 inputs (zeros
    before the prompt's start), the carry at the last full chunk boundary,
    and the remainder's rows in the buffers, which is what the decode step
    continues from at position L."""
    s = cfg.ssm
    l = x.shape[1]
    z, xs, bmat, cmat, dt = _proj(p, cfg, x, norm_scale)
    state = init_state(cfg, x.shape[0], x.device)
    y, seq, s_bound = _ssd(cfg, p.conv, p.a_log, p.d_skip, xs, bmat, cmat, dt, state["ssm"])
    state["ssm"].copy_(s_bound)
    out = p.wo(_gated_norm(p.norm.scale, y.to(x.dtype), z))
    tail = min(l, s.conv_width - 1)
    state["conv"][:, s.conv_width - 1 - tail:] = xs[:, l - tail:]
    rem = l % s.chunk
    for key, t in zip(("ssd_x", "ssd_b", "ssd_c", "ssd_dt"), seq):
        state[key][:, :rem] = t[:, l - rem:]
    return out, state


def mamba_train(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The mixer over whole sequences on master weights ``p`` (the JAX
    package's tree), x (B, L, D) already normed -> y (B, L, D): wz and wx
    share one DAS mask and int8 fake-quant of x, wb and wc run in x's
    dtype and wdt in float32, then the prefill's conv, chunk grid (from the
    zero carry), D skip and gated rmsnorm, and wo."""
    tc, (b, l, _) = cfg.ternary, x.shape
    di, nh = mamba_dims(cfg)
    xq = tlin_train_input(x, tc)
    z, xs = tlin_train(p["wz"], xq, tc), tlin_train(p["wx"], xq, tc)
    bmat, cmat, dt = _dense_proj(p["wb"], p["wc"], p["wdt"], p["dt_bias"], x)
    s0 = torch.zeros((b, nh, cfg.ssm.head_dim, cfg.ssm.state_dim), dtype=torch.float32,
                     device=x.device)
    y, _, _ = _ssd(cfg, p["conv"], p["a_log"], p["d_skip"], xs, bmat, cmat, dt, s0)
    h = _gated_norm(p["norm"]["scale"], y.to(x.dtype), z)
    return tlin_train(p["wo"], tlin_train_input(h, tc), tc)


class SsdStep(NamedTuple):
    """What every mamba layer of one decode step shares (ssd_step_inputs)."""
    rows: torch.Tensor     # (B,) int64 batch rows
    slot: torch.Tensor     # (B,) int64 buffer row of position t: max(t, 0) % chunk
    upto: torch.Tensor     # (B, chunk, 1) bool: buffer rows <= slot
    full: torch.Tensor     # (B,) bool: the step fills the chunk (slot == chunk - 1)


def ssd_step_inputs(cfg: ModelConfig, t: torch.Tensor) -> SsdStep:
    """The buffer rows and fold masks of one decode step at positions t (B,),
    computed once for all mamba layers.  An inactive row (t = -1 under the
    paged layout) writes row 0, a don't-care that never folds."""
    c = cfg.ssm.chunk
    slot = torch.clamp(t.to(torch.int64), min=0) % c
    upto = torch.arange(c, device=t.device)[None] <= slot[:, None]
    return SsdStep(torch.arange(t.shape[0], device=t.device), slot, upto[:, :, None],
                   slot == c - 1)


def ssd_write(state: dict, step: SsdStep, xh: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor, dt: torch.Tensor) -> None:
    """Write each row's token, xh (B, nh, hd), B and C (B, N), dt (B, nh),
    into its buffer row, in float32."""
    rows, slot = step.rows, step.slot
    state["ssd_x"][rows, slot] = xh
    state["ssd_b"][rows, slot] = bmat.float()
    state["ssd_c"][rows, slot] = cmat.float()
    state["ssd_dt"][rows, slot] = dt


def ssd_row(state: dict, step: SsdStep, a: torch.Tensor):
    """Each row's output at its buffer row, the row of the prefill's chunk
    einsums, from the buffers (rows past it zero or masked) and the carry
    -> (y (B, nh, hd) float32, the buffers' cumulative log decay (B, chunk,
    nh), which the fold reuses)."""
    rows, slot = step.rows, step.slot
    xb, bb, cb, dtb, s_in = (state[k] for k in ("ssd_x", "ssd_b", "ssd_c", "ssd_dt", "ssm"))
    with full_f32():
        cla = xla_cumsum(dtb * a, 1)
        cla_p, c_p = cla[rows, slot], cb[rows, slot]                 # (B, nh), (B, N)
        decay = torch.exp(torch.clamp(cla_p[:, None, :] - cla, max=0.0))
        scores = torch.einsum("bn,bsn->bs", c_p, bb)[:, :, None] * decay
        scores = torch.where(step.upto, scores, 0.0) * dtb
        y = torch.einsum("bsh,bshd->bhd", scores, xb)
        y = y + torch.exp(cla_p)[:, :, None] * torch.einsum("bhdn,bn->bhd", s_in, c_p)
    return y, cla


def ssd_fold(state: dict, step: SsdStep, cla: torch.Tensor) -> None:
    """Fold every row's buffers into its carry with the chunk formula, keep
    the fold where the step fills the chunk, and clear those rows' buffers;
    computed for every row and selected, with no host branch."""
    xb, bb, cb, dtb, s_in = (state[k] for k in ("ssd_x", "ssd_b", "ssd_c", "ssd_dt", "ssm"))
    with full_f32():
        la_end = cla[:, -1:]
        b_state = (torch.exp(la_end - cla) * dtb)[..., None] * bb[:, :, None, :]
        folded = (torch.exp(la_end)[:, 0, :, None, None] * s_in
                  + torch.einsum("bshd,bshn->bhdn", xb, b_state))
    s_in.copy_(torch.where(step.full[:, None, None, None], folded, s_in))
    for buf in (xb, bb, cb, dtb):
        buf.masked_fill_(step.full.view((-1,) + (1,) * (buf.ndim - 1)), 0.0)


def mamba_decode(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, norm_scale: torch.Tensor,
                 state: dict, step: SsdStep) -> torch.Tensor:
    """One token per row, x (B, 1, D), at the positions of ``step``; the
    state is updated in place, in the JAX package's order: the token's (x,
    B, C, dt) written into its buffer row, the row's output from the
    buffers and the old carry, the fold of every row computed, the carry
    replaced by it where the chunk fills, and those rows' buffers cleared.
    Returns y (B, 1, D)."""
    s = cfg.ssm
    b = x.shape[0]
    di, nh = mamba_dims(cfg)
    z, xs, bmat, cmat, dt = _proj(p, cfg, x, norm_scale)
    conv_in = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)     # (B, cw, d_inner)
    xh = silu(_conv_taps(conv_in.float(), p.conv.float())).reshape(b, nh, s.head_dim)
    state["conv"].copy_(conv_in[:, 1:])
    ssd_write(state, step, xh, bmat[:, 0], cmat[:, 0], dt[:, 0])
    y, cla = ssd_row(state, step, -torch.exp(p.a_log.float()))
    ssd_fold(state, step, cla)
    y = y + p.d_skip.float()[:, None] * xh
    return p.wo(_gated_norm(p.norm.scale, y.reshape(b, 1, di).to(x.dtype), z))
