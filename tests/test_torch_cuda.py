"""The port's CUDA kernels and model on a card, against their plain versions.

Imports neither JAX nor the JAX package, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test takes the ``cuda`` fixture and skips without a card.
Tolerances as in tests/test_kernels.py: 1e-4 for float32 GEMMs, 2e-2 for
bfloat16, 3e-4 for attention, exact for masks and int8; the model 2e-4.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import das, lpsa, twd
from repro_torch.kernels import ops, ref
from repro_torch.models import model as MD
from repro_torch.models.layers import rmsnorm
from repro_torch.serve import Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.cuda
SCALE = 0.37


@pytest.fixture()
def cuda():
    """The CUDA device with float32 matmuls in full precision, or a skip:
    the kernels build and run only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _packed(rng, k, n, device):
    trits = torch.from_numpy(rng.integers(-1, 2, size=(k, n)).astype(np.int8))
    return twd.pack_ternary(trits, row_align=16).to(device)


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def _rows(rng, m, k, dtype, ties, device):
    x = rng.integers(-3, 4, size=(m, k)) if ties else rng.standard_normal((m, k)) * 3
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


# (M, K, dtype, tie-heavy rows, keep): bitnet-1.3b's widths at decode and at a
# pack (K = 5460: 8-byte vectors, odd rows 8 bytes past a 16-byte boundary,
# a 20-lane partial block), an odd K (byte vectors), compacted rows whose
# length is not whole 16-byte chunks (keep 1 and 24)
DAS_TOPK_CASES = [(4, 2048, torch.bfloat16, False, 16), (256, 2048, torch.bfloat16, False, 16),
                  (4, 5460, torch.bfloat16, False, 16), (64, 5460, torch.bfloat16, False, 16),
                  (5, 5460, torch.float32, True, 16), (3, 96, torch.float32, True, 16),
                  (7, 101, torch.bfloat16, True, 24), (3, 4160, torch.bfloat16, False, 1),
                  (4, 96, torch.float32, False, 24), (2, 64, torch.bfloat16, True, 32)]


@pytest.mark.parametrize("m,k,dtype,ties,keep", DAS_TOPK_CASES)
def test_cuda_das_topk(cuda, rng, m, k, dtype, ties, keep):
    """The vector design against its plain version, exactly: with the mask
    requested and not, and on rows that start at an odd row of a larger
    tensor (not 16-byte aligned at K = 5460)."""
    big = _rows(rng, m + 1, k, dtype, ties, cuda)
    for x in (big[:m], big[1:]):
        _assert_same(ops.das_topk(x, keep=keep), ref.das_topk_ref(x, keep=keep, block=32))
        got = ops.das_topk(x, keep=keep, with_mask=False)
        assert got.mask is None
        _assert_same(got, ref.das_topk_ref(x, keep=keep, block=32, with_mask=False))


def _steps(got, want):
    """|got - want| in steps of want's dtype at want's magnitude."""
    mant = 7 if want.dtype == torch.bfloat16 else 23
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -100))) - mant)
    return (got.float() - w).abs() / step


@pytest.mark.parametrize("m,k,dtype", [(4, 2048, torch.bfloat16), (256, 2048, torch.bfloat16),
                                       (4, 5460, torch.bfloat16), (256, 5460, torch.bfloat16),
                                       (3, 96, torch.float32), (4, 2048, torch.float32)])
def test_cuda_das_topk_norm(cuda, rng, m, k, dtype):
    """The rmsnorm prologue: the normed rows within one step of
    rmsnorm(scale, x) in bfloat16 and within 8 steps (1e-6 relative) in
    float32, since the kernel sums the squares in another order than
    F.rms_norm and rounds its rsqrt correctly; the DAS step of those rows
    exact against its plain version."""
    x = _rows(rng, m, k, dtype, False, cuda)
    scale = torch.from_numpy((rng.standard_normal(k) * 0.5).astype(np.float32)).to(cuda, dtype)
    got = ops.das_topk(x, keep=16, norm_scale=scale, with_normed=True)
    want = rmsnorm(scale, x)
    steps = _steps(got.normed, want)
    print(f"normed: {int((got.normed != want).sum())} of {want.numel()} differ, "
          f"max {float(steps.max()):.2f} steps")
    assert float(steps.max()) <= (1 if dtype == torch.bfloat16 else 8)
    plain = ref.das_topk_ref(got.normed, keep=16, block=32)
    _assert_same(got[:4], plain[:4])


@pytest.mark.parametrize("k", [2048, 5460])
@pytest.mark.parametrize("norm", [False, True])
def test_cuda_das_topk_batch_invariance(cuda, rng, k, norm):
    """A row's outputs do not depend on M: rows alone, among 4 and among 256
    give the same bits, with and without the norm."""
    x = _rows(rng, 256, k, torch.bfloat16, False, cuda)
    scale = (torch.from_numpy((rng.standard_normal(k) * 0.5).astype(np.float32))
             .to(cuda, torch.bfloat16) if norm else None)

    def run(rows):
        return ops.das_topk(rows, keep=16, norm_scale=scale, with_normed=norm)

    full, four = run(x), run(x[:4])
    for i in (0, 3):
        one = run(x[i:i + 1])
        for a, b, c in zip(one, four, full):
            if a is not None:
                assert torch.equal(a[0], b[i]) and torch.equal(a[0], c[i]), i


# (M, K, N, dtype): decode (M <= 4: K windows with the ordered reduction)
# and prefill (bf16 on the tensor cores, f32 on FMAs); bitnet-1.3b's shapes,
# R beyond what one block could stage before (K = 16000: 3200 packed rows),
# windows that end past K (K = 2048 in 416 rows; K = 96 in 32), N % 4 != 0
DAS_GEMM_CASES = [(4, 2048, 2048, torch.bfloat16), (4, 2048, 5460, torch.bfloat16),
                  (1, 2048, 2048, torch.float32), (256, 2048, 5460, torch.bfloat16),
                  (9, 2048, 130, torch.float32), (37, 2048, 130, torch.bfloat16),
                  (3, 16000, 64, torch.bfloat16), (70, 16000, 64, torch.bfloat16),
                  (2, 96, 7, torch.float32), (300, 96, 258, torch.bfloat16)]


@pytest.mark.parametrize("m,k,n,dtype", DAS_GEMM_CASES)
def test_cuda_das_ternary_gemm(cuda, rng, m, k, n, dtype):
    p = _packed(rng, k, n, cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    ca = das.das_compact(x, keep=16)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(
        ops.das_ternary_gemm(ca.values, ca.indices, p, SCALE, keep=16),
        ref.das_ternary_gemm_ref(ca.values, ca.indices, p, SCALE), rtol=tol, atol=tol)


TERNARY_GEMM_CASES = [(4, 5460, 2048, torch.bfloat16), (256, 5460, 2048, torch.bfloat16),
                      (5, 640, 256, torch.float32), (4, 5460, 2048, torch.float32),
                      (8, 640, 256, torch.int8), (4, 5460, 130, torch.int8),
                      (3, 16000, 64, torch.float32), (70, 16000, 64, torch.bfloat16),
                      (4, 100, 7, torch.bfloat16), (33, 102, 130, torch.bfloat16),
                      (40, 300, 258, torch.int8)]


@pytest.mark.parametrize("m,k,n,dtype", TERNARY_GEMM_CASES)
def test_cuda_ternary_gemm(cuda, rng, m, k, n, dtype):
    """float32 and bfloat16 within tolerance, int8 exact (int32 sums)."""
    p = _packed(rng, k, n, cuda)
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8)).to(cuda)
        xs = torch.from_numpy((rng.random((m, 1)) + 0.5).astype(np.float32)).to(cuda)
        assert torch.equal(ops.ternary_gemm(x, p, SCALE, xs),
                           ref.ternary_gemm_ref(x, p, SCALE, xs))
        return
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(ops.ternary_gemm(x, p, SCALE),
                               ref.ternary_gemm_ref(x, p, SCALE), rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["ternary_gemm", "das_ternary_gemm", "das_gemv",
                                    "das_gemv_dense"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_packed_gemm_batch_invariance(cuda, rng, kernel, dtype):
    """A row's output does not depend on the other rows of the call: the rows
    of an M = 4 call equal M = 1, 2, 3 calls bit for bit (the decode class),
    and rows of an M = 256 call equal calls of other M > 4 on slices of them
    (the prefill class).  das_gemv runs on the same core with int8 trits:
    compacted rows (K = 2048) and DAS-masked dense rows with a tail (K =
    5460)."""
    k, n = (5460, 2048) if kernel == "das_gemv_dense" else (2048, 5460)
    p = _packed(rng, k, n, cuda)
    w = torch.from_numpy(rng.integers(-1, 2, size=(k, n)).astype(np.int8)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((256, k)).astype(np.float32)).to(cuda, dtype)

    def run(rows):
        rows = rows.contiguous()
        if kernel == "ternary_gemm":
            return ops.ternary_gemm(rows, p, SCALE)
        if kernel == "das_gemv_dense":
            return ops.das_gemv(das.das_apply(rows, das.das_mask(rows, keep=16)), None, w,
                                SCALE)
        ca = das.das_compact(rows, keep=16)
        if kernel == "das_gemv":
            return ops.das_gemv(ca.values, ca.indices, w, SCALE, keep=16)
        return ops.das_ternary_gemm(ca.values, ca.indices, p, SCALE, keep=16)

    dec = run(x[:4])
    for m in (1, 2, 3):
        assert torch.equal(run(x[:m]), dec[:m]), m
        assert torch.equal(run(x[4 - m:4]), dec[4 - m:]), m
    full = run(x)
    for lo, hi in ((0, 5), (0, 64), (100, 137), (190, 256), (3, 203)):
        assert torch.equal(run(x[lo:hi]), full[lo:hi]), (lo, hi)
    assert torch.equal(run(x[:4]), dec)        # and from call to call


@pytest.mark.parametrize("hq,hkv,d,cap", [(8, 2, 64, None), (4, 4, 16, 30.0),
                                          (4, 2, 80, None), (4, 4, 100, None),
                                          (8, 4, 256, 50.0), (4, 1, 256, None)])
def test_cuda_sparse_attention(cuda, rng, hq, hkv, d, cap):
    b, lq, lk = 2, 3, 40
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    q, k, v = mk(b, lq, hq, d), mk(b, lk, hkv, d), mk(b, lk, hkv, d)
    qp = torch.tensor([[37, 38, 39], [5, 6, 7]], dtype=torch.int32, device=cuda)
    kp = torch.arange(lk, dtype=torch.int32, device=cuda)[None].repeat(b, 1)
    kp[1] = -1                                     # an empty batch row
    torch.testing.assert_close(
        ops.sparse_attention(q, k, v, qp, kp, sink=4, window=16, softcap=cap),
        ref.sparse_attention_ref(q, k, v, qp, kp, sink=4, window=16, softcap=cap),
        rtol=3e-4, atol=3e-4)


def _ring_positions(t, sink=128, window=896):
    """The positions in a (sink + window)-slot ring after token t (-1: empty)."""
    pos = torch.full((sink + window,), -1, dtype=torch.int32)
    for p in range(t + 1):
        pos[p if p < sink else sink + (p - sink) % window] = p
    return pos


def test_cuda_sparse_attention_decode_batch_invariance(cuda, rng):
    """The decode class splits each row's keys over a cluster by Lk alone: a
    full 1024-slot ring at B = 4 gives every row the bits of a B = 1 call on
    it.  One row has every chunk masked (all slots empty) and gives 0; one is
    young enough that most chunks hold no allowed key."""
    b, lk, h, d = 4, 1024, 32, 64
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(  # noqa: E731
        cuda, torch.bfloat16)
    q, k, v = mk(b, 1, h, d), mk(b, lk, h, d), mk(b, lk, h, d)
    qp = torch.tensor([[1500], [700], [5], [1023]], dtype=torch.int32, device=cuda)
    kp = torch.stack([_ring_positions(t) for t in (1500, 700, 5, 1023)]).to(cuda)
    kp[1] = -1
    full = ops.sparse_attention(q, k, v, qp, kp, sink=128, window=896)
    torch.testing.assert_close(
        full, ref.sparse_attention_ref(q, k, v, qp, kp, sink=128, window=896),
        rtol=2e-2, atol=2e-2)
    assert not full[1].any()
    for i in range(b):
        one = ops.sparse_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], qp[i:i + 1],
                                   kp[i:i + 1], sink=128, window=896)
        assert torch.equal(one, full[i:i + 1]), i


@pytest.mark.parametrize("d", [64, 80])
def test_cuda_sparse_attention_round_scores(cuda, rng, d):
    """The streaming prefill's option in bfloat16: scores rounded to bfloat16
    before the scale (computed in bfloat16 too: 1/sqrt(80) rounds)."""
    b, lq, lk, hq, hkv = 1, 16, 48, 4, 2
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(  # noqa: E731
        cuda, torch.bfloat16)
    q, k, v = mk(b, lq, hq, d), mk(b, lk, hkv, d), mk(b, lk, hkv, d)
    qp = torch.arange(32, 48, dtype=torch.int32, device=cuda)[None]
    kp = torch.arange(lk, dtype=torch.int32, device=cuda)[None]
    torch.testing.assert_close(
        ops.sparse_attention(q, k, v, qp, kp, sink=4, window=16, round_scores=True),
        ref.sparse_attention_ref(q, k, v, qp, kp, sink=4, window=16, round_scores=True),
        rtol=2e-2, atol=2e-2)


def _pack_positions(t0):
    """q_pos, k_pos (int32) of bitnet-1.3b's streaming prefill pack at t0."""
    return tuple(p.to(torch.int32) for p in lpsa.pack_positions(t0, lpsa.LpsaSpec()))


FULL_SINK = 1 << 30

# the bf16 prefill class (Lq > 1 on the tensor cores): (label, B, Lq, Lk, Hq,
# Hkv, D, positions, sink, window, softcap, round_scores); "pack t0" takes
# _pack_positions(t0), "causal" q_pos = k_pos = arange(Lq)
PREFILL_CASES = [
    ("pack t0=0", 1, 256, 1280, 32, 32, 64, 0, 128, 896, None, True),
    ("pack t0=512", 1, 256, 1280, 32, 32, 64, 512, 128, 896, None, True),
    ("pack t0=2000", 1, 256, 1280, 32, 32, 64, 2000, 128, 896, None, True),
    ("full causal 300, partial tiles", 1, 300, 300, 8, 8, 64, "causal", FULL_SINK, 0,
     None, False),
    ("GQA 32/8", 1, 256, 1280, 32, 8, 64, 512, 128, 896, None, True),
    ("head_dim 16", 2, 100, 100, 8, 4, 16, "causal", 16, 32, None, False),
    ("head_dim 80", 2, 100, 100, 8, 4, 80, "causal", 16, 32, None, False),
    ("head_dim 100 pack t0=512", 1, 256, 1280, 32, 32, 100, 512, 128, 896, None, True),
    ("head_dim 100 causal", 2, 100, 100, 8, 8, 100, "causal", 16, 32, None, False),
    ("head_dim 256 GQA 8/4 softcap 50", 1, 256, 1280, 8, 4, 256, 512, 128, 896, 50.0, True),
    ("head_dim 256 GQA 4/1 causal 300", 1, 300, 300, 4, 1, 256, "causal", FULL_SINK, 0,
     None, False),
    ("head_dim 256 local window 4096", 1, 256, 4352, 8, 4, 256, "local 4400", 0, 4096, 50.0,
     True),
    ("round_scores + softcap", 1, 256, 1280, 8, 8, 64, 512, 128, 896, 30.0, True),
    ("empty batch row", 2, 256, 1280, 8, 8, 64, 512, 128, 896, None, True),
]


def _prefill_inputs(rng, b, lq, lk, hq, hkv, d, where, device):
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(  # noqa: E731
        device, torch.bfloat16)
    if where == "causal":
        qp = kp = torch.arange(lq, dtype=torch.int32)
    elif where == "local 4400":            # gemma2's local pack: no sink, 4096 keys
        qp, kp = (p.to(torch.int32) for p in lpsa.pack_positions(
            4400, lpsa.LpsaSpec(sink=0, window=4096, chunk=256)))
    else:
        qp, kp = _pack_positions(where)
    qp = qp[None].repeat(b, 1).to(device)
    kp = kp[None].repeat(b, 1).to(device)
    return mk(b, lq, hq, d), mk(b, lk, hkv, d), mk(b, lk, hkv, d), qp, kp


@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_cuda_sparse_attention_prefill_class(cuda, rng, case):
    """The bf16 prefill class against the plain version at 2e-2: LPSA packs
    (most sink and window slots empty at t0 = 0 and 512, so whole key tiles
    are skipped), partial tiles, GQA, the head sizes 16 and 80, soft-cap
    with rounded scores, and a batch row with every key empty (exact 0)."""
    label, b, lq, lk, hq, hkv, d, where, sink, window, cap, rs = case
    q, k, v, qp, kp = _prefill_inputs(rng, b, lq, lk, hq, hkv, d, where, cuda)
    if label == "empty batch row":
        kp[1] = -1
    kw = dict(sink=sink, window=window, softcap=cap, round_scores=rs)
    ops.reset_launches()
    got = ops.sparse_attention(q, k, v, qp, kp, **kw)
    assert ops.launches["sparse_attention"] == 1
    want = ref.sparse_attention_ref(q, k, v, qp, kp, **kw)
    print(f"{label}: max abs err {(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    if label == "empty batch row":
        assert not got[1].any()


def test_cuda_sparse_attention_prefill_batch_invariance(cuda, rng):
    """A query's output bits depend on neither the batch nor the other
    queries of its tile (which decide whether a key tile is skipped): row 1
    of a B = 2 call (rows at t0 = 2000 and 512) equals a B = 1 call on it,
    and queries [64, 128) and [37, 101) of a pack equal a call on them alone."""
    q, k, v, qp, kp = _prefill_inputs(rng, 2, 256, 1280, 32, 32, 64, 512, cuda)
    qp0, kp0 = _pack_positions(2000)
    qp[0], kp[0] = qp0.to(cuda), kp0.to(cuda)
    kw = dict(sink=128, window=896, round_scores=True)
    full = ops.sparse_attention(q, k, v, qp, kp, **kw)
    assert torch.equal(ops.sparse_attention(q[1:], k[1:], v[1:], qp[1:], kp[1:], **kw),
                       full[1:])
    for lo, hi in ((64, 128), (37, 101)):
        sub = ops.sparse_attention(q[1:, lo:hi].contiguous(), k[1:], v[1:],
                                   qp[1:, lo:hi].contiguous(), kp[1:], **kw)
        assert torch.equal(sub, full[1:, lo:hi]), (lo, hi)


def _ring(rows, lk, sink, window):
    """Ring positions of the rows' query positions (-1: empty slot)."""
    return torch.stack([_ring_positions(t, sink, window) for t in rows])


# (label, Lq, Lk, Hq, Hkv, D, dtype, sink, window, softcap): the decode class
# over full rings (LPSA 128 + 896; gemma2's 4096-slot local ring, 16 blocks a
# cluster) and the prefill classes at the head sizes 100 and 256
HEAD_SIZE_CASES = [
    ("decode D=256 GQA 8/4 softcap 50 ring 1024", 1, 1024, 8, 4, 256, torch.bfloat16, 128,
     896, 50.0),
    ("decode D=256 GQA 8/4 local ring 4096", 1, 4096, 8, 4, 256, torch.bfloat16, 0, 4096,
     50.0),
    ("decode D=256 GQA 4/1", 1, 1024, 4, 1, 256, torch.bfloat16, 128, 896, None),
    ("decode D=100 32/32", 1, 1024, 32, 32, 100, torch.bfloat16, 128, 896, None),
    ("decode D=100 f32", 1, 1024, 8, 8, 100, torch.float32, 128, 896, None),
    ("decode D=256 f32", 1, 1024, 8, 4, 256, torch.float32, 128, 896, 50.0),
    ("prefill f32 D=100", 16, 64, 4, 4, 100, torch.float32, 8, 24, None),
    ("prefill f32 D=256", 16, 64, 4, 2, 256, torch.float32, 8, 24, 50.0),
]


@pytest.mark.parametrize("case", HEAD_SIZE_CASES, ids=[c[0] for c in HEAD_SIZE_CASES])
def test_cuda_sparse_attention_head_sizes(cuda, rng, case):
    """The head sizes 100 (bitnet-3b: bf16 rows of 200 bytes, so 8-byte
    copies) and 256 (the gemmas: tiles in dynamic shared memory) in the
    decode class and the float32 prefill class, against the plain version
    (2e-2 bf16, 3e-4 float32), and every row bitwise a B = 1 call on it."""
    label, lq, lk, hq, hkv, d, dt, sink, window, cap = case
    b = 4 if lq == 1 else 2
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(  # noqa: E731
        cuda, dt)
    q, k, v = mk(b, lq, hq, d), mk(b, lk, hkv, d), mk(b, lk, hkv, d)
    if lq == 1:
        rows = [5000, 4095, 700, 5][:b]
        qp = torch.tensor(rows, dtype=torch.int32, device=cuda)[:, None]
        kp = _ring(rows, lk, sink, window).to(cuda)
    else:
        qp = (40 + torch.arange(lq, dtype=torch.int32, device=cuda))[None].repeat(b, 1)
        kp = torch.arange(lk, dtype=torch.int32, device=cuda)[None].repeat(b, 1)
        kp[1, 30:] = -1
    kw = dict(sink=sink, window=window, softcap=cap)
    got = ops.sparse_attention(q, k, v, qp, kp, **kw)
    tol = 2e-2 if dt == torch.bfloat16 else 3e-4
    torch.testing.assert_close(got, ref.sparse_attention_ref(q, k, v, qp, kp, **kw),
                               rtol=tol, atol=tol)
    for i in range(b):
        one = ops.sparse_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], qp[i:i + 1],
                                   kp[i:i + 1], **kw)
        assert torch.equal(one, got[i:i + 1]), i


@pytest.mark.parametrize("d,hq,hkv", [(100, 32, 32), (256, 8, 4)])
def test_cuda_sparse_attention_prefill_head_size_invariance(cuda, rng, d, hq, hkv):
    """The bf16 prefill class at the head sizes 100 and 256: row 1 of a B = 2
    call equals a B = 1 call, a query sub-range equals a call on it alone."""
    q, k, v, qp, kp = _prefill_inputs(rng, 2, 256, 1280, hq, hkv, d, 512, cuda)
    qp0, kp0 = _pack_positions(2000)
    qp[0], kp[0] = qp0.to(cuda), kp0.to(cuda)
    kw = dict(sink=128, window=896, round_scores=True)
    full = ops.sparse_attention(q, k, v, qp, kp, **kw)
    assert torch.equal(ops.sparse_attention(q[1:], k[1:], v[1:], qp[1:], kp[1:], **kw),
                       full[1:])
    sub = ops.sparse_attention(q[1:, 37:101].contiguous(), k[1:], v[1:],
                               qp[1:, 37:101].contiguous(), kp[1:], **kw)
    assert torch.equal(sub, full[1:, 37:101])


def test_cuda_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError):
        ops.das_topk(x, keep=8, block=16)             # the kernel ranks 32 lanes
    with pytest.raises(ValueError):                   # 5R = 40 < K = 64
        ops.ternary_gemm(x, torch.zeros((8, 6), dtype=torch.uint8, device=cuda), SCALE)
    with pytest.raises(ValueError):                   # Kc != K / block * keep
        ops.das_ternary_gemm(x, torch.zeros((2, 64), dtype=torch.int32, device=cuda),
                             torch.zeros((64, 8), dtype=torch.uint8, device=cuda), SCALE,
                             keep=12)
    with pytest.raises(ValueError):                   # decode: R > 4096 packed rows
        ops.ternary_gemm(torch.zeros((4, 20485), device=cuda),
                         torch.zeros((4097, 8), dtype=torch.uint8, device=cuda), SCALE)


def test_cuda_model_matches_cpu(cuda):
    """Reduced bitnet-1.3b: prefill + 8 decode steps through the kernels
    agree with the same weights through the plain versions on the CPU, and
    every kernel launched."""
    cfg = reduced(get_config("bitnet-1.3b"))
    m_cpu = MD.export_serving(MD.init_params(cfg, seed=3, device="cpu"), cfg)
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, 48))[None]
    ops.reset_launches()
    lg_c, c_c = MD.prefill(m_cpu, prompt, max_len=64)
    lg_g, c_g = MD.prefill(m_gpu, prompt.to(cuda), max_len=64)
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
    tok = int(lg_c.argmax())
    for i in range(8):
        t = torch.tensor([48 + i])
        lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([tok]), t)
        lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([tok], device=cuda), t.to(cuda))
        torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
        assert int(lg_g.argmax()) == int(lg_c.argmax())
        tok = int(lg_c.argmax())
    # reduced d_ff = 128 divides 32, so the down projection is compacted too
    assert all(ops.launches[k] > 0 for k in ("das_topk", "das_ternary_gemm",
                                             "sparse_attention"))


def test_cuda_engine_batch_invariance(cuda):
    cfg = reduced(get_config("bitnet-1.3b"))
    model = MD.export_serving(MD.init_params(cfg, seed=4, device=cuda), cfg)
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, p), max_new_tokens=6,
                    arrival=i) for i, p in enumerate((40, 16, 9))]
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64), device="cuda")
    for r in reqs:
        eng.submit(r)
    batched = eng.run()
    eng.submit(Request(uid=9, prompt=reqs[2].prompt, max_new_tokens=6))
    assert eng.run()[9].tokens.tolist() == batched[2].tokens.tolist()


# (K, N, row_align): bitnet-1.3b's columns (N = 5460: 4-byte vectors; 2048:
# 16-byte) with the export's padding rows past K (5R > K), odd N (bytes)
@pytest.mark.parametrize("k,n,row_align", [(2048, 5460, 16), (5460, 2048, 16), (2048, 64, 16),
                                           (5460, 40, 16), (300, 7, 1), (77, 1001, 16)])
def test_cuda_twd_decode(cuda, rng, k, n, row_align):
    trits = torch.from_numpy(rng.integers(-1, 2, size=(k, n)).astype(np.int8))
    packed = twd.pack_ternary(trits, row_align=row_align).to(cuda)
    got = ops.twd_decode(packed, k)
    assert torch.equal(got, ref.twd_decode_ref(packed, k))
    assert torch.equal(got.cpu(), trits)


@pytest.mark.parametrize("m,k,n,dtype,form", [
    (4, 2048, 2048, torch.bfloat16, "compact"), (9, 2048, 130, torch.float32, "compact"),
    (4, 5460, 256, torch.bfloat16, "dense"), (9, 5460, 64, torch.float32, "dense"),
    (37, 640, 96, torch.float32, "off"),
    (4, 2048, 5460, torch.bfloat16, "compact"), (3, 5460, 2048, torch.float32, "dense"),
    (2, 2048, 130, torch.bfloat16, "compact"), (4, 5460, 130, torch.bfloat16, "off"),
    (4, 9216, 256, torch.bfloat16, "compact"), (1, 9216, 64, torch.float32, "off"),
    (256, 5460, 2048, torch.bfloat16, "dense"), (70, 9216, 130, torch.bfloat16, "compact")])
def test_cuda_das_gemv(cuda, rng, m, k, n, dtype, form):
    """Compacted rows, DAS-masked dense rows with a tail (K = 5460) and raw
    dense rows on the GEMM core: decode (M <= 4) on the tensor cores (bf16)
    and on FMAs (f32), prefill on either; K = 2048 and 5460 end in a partial
    160-lane window; K = 9216 (the zoo's largest) takes 4 windows a decode
    block; N not a multiple of 4 (byte loads, the FMA prefill)."""
    w = torch.from_numpy(rng.integers(-1, 2, size=(k, n)).astype(np.int8)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    if form == "compact":
        ca = das.das_compact(x, keep=16)
        vals, idx = ca.values, ca.indices
    else:
        vals = das.das_apply(x, das.das_mask(x, keep=16)) if form == "dense" else x
        idx = None
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(ops.das_gemv(vals, idx, w, SCALE, keep=16),
                               ref.das_gemv_ref(vals, idx, w, SCALE), rtol=tol, atol=tol)


def test_cuda_trits_kernels_refuse_what_they_cannot_take(cuda):
    x = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError):
        ops.das_gemv(x, None, torch.zeros((32, 8), dtype=torch.int8, device=cuda), SCALE)
    with pytest.raises(ValueError):                   # Kc != K / block * keep
        ops.das_gemv(x, torch.zeros((2, 64), dtype=torch.int32, device=cuda),
                     torch.zeros((64, 8), dtype=torch.int8, device=cuda), SCALE, keep=12)
    with pytest.raises(ValueError):                   # decode: K > 20480 lanes
        ops.das_gemv(torch.zeros((4, 20485), device=cuda), None,
                     torch.zeros((20485, 8), dtype=torch.int8, device=cuda), SCALE)
    with pytest.raises(ValueError):
        ops.twd_decode(torch.zeros((4, 8), dtype=torch.uint8, device=cuda), 21)


def test_cuda_trits_model_matches_cpu(cuda):
    """Reduced bitnet-1.3b served from int8 trits: the card's trits come from
    twd_decode of the packed export and equal the int8 export; prefill + 8
    decode steps through das_gemv agree with the CPU's plain versions."""
    cfg = reduced(get_config("bitnet-1.3b"))
    cfg8 = dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary,
                                                                serve_format="int8"))
    params = MD.init_params(cfg, seed=6, device="cpu")
    m_cpu = MD.export_serving(params, cfg8)
    ops.reset_launches()
    m_gpu = MD.trits_from_packed(MD.export_serving(params, cfg).to(cuda), cfg8)
    assert ops.launches["twd_decode"] == 7 * cfg.n_layers
    for key, val in m_gpu.state_dict().items():
        assert torch.equal(val.cpu(), m_cpu.state_dict()[key]), key
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, 48))[None]
    ops.reset_launches()
    lg_c, c_c = MD.prefill(m_cpu, prompt, max_len=64)
    lg_g, c_g = MD.prefill(m_gpu, prompt.to(cuda), max_len=64)
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
    tok = int(lg_c.argmax())
    for i in range(8):
        t = torch.tensor([48 + i])
        lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([tok]), t)
        lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([tok], device=cuda), t.to(cuda))
        torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
        assert int(lg_g.argmax()) == int(lg_c.argmax())
        tok = int(lg_c.argmax())
    assert ops.launches["das_gemv"] > 0 and ops.launches["das_ternary_gemm"] == 0


# the engine's captured decode step: (layout, serve_sparse, serve format) on
# reduced bitnet-1.3b; "paged" with LPSA shares ring states through the trie,
# without LPSA every layer is a page arena
GRAPH_CASES = [("auto", True, "packed"), ("auto", True, "int8"), ("auto", False, "packed"),
               ("paged", True, "packed"), ("paged", False, "packed")]


def _graph_model(cuda, fmt):
    cfg = reduced(get_config("bitnet-1.3b"))
    cfg = dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary,
                                                               serve_format=fmt))
    return MD.export_serving(MD.init_params(cfg, seed=5, device=cuda), cfg)


def _stem_requests(cfg, gen=6):
    """A shared 35-token stem: fresh, a sibling tail, a duplicate, an
    extension, and a prompt shorter than a pack; 1 step apart."""
    rng = np.random.default_rng(5)
    stem = rng.integers(0, cfg.vocab, 35)
    first = np.concatenate([stem, rng.integers(0, cfg.vocab, 9)])
    prompts = [first, np.concatenate([stem, rng.integers(0, cfg.vocab, 5)]), first.copy(),
               np.concatenate([first, rng.integers(0, cfg.vocab, 6)]), stem[:7]]
    return [Request(uid=i, prompt=p, max_new_tokens=gen, arrival=i)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("layout,sparse,fmt", GRAPH_CASES)
def test_cuda_graph_engine_matches_eager(cuda, layout, sparse, fmt):
    """Every decode step a replay of the captured step, with the eager
    step's tokens bit for bit; re-served alone, a request keeps them."""
    model = _graph_model(cuda, fmt)
    sc = ServeConfig(max_slots=2, max_len=64, layout=layout, page_size=8)
    graph = ServeEngine(model, sc, device="cuda", serve_sparse=sparse)
    eager = ServeEngine(model, sc, device="cuda", serve_sparse=sparse, cuda_graph=False)
    assert (graph.stats.warmup_steps, eager.stats.warmup_steps) == (1, 0)
    results = []
    for eng in (graph, eager):
        for r in _stem_requests(model.cfg):
            eng.submit(r)
        results.append(eng.run())
    assert graph.stats.graph_replays == graph.stats.decode_steps > 0
    assert eager.stats.graph_replays == 0
    for uid, res in results[1].items():
        assert results[0][uid].tokens.tolist() == res.tokens.tolist(), uid
    if layout == "paged":
        assert graph.stats.prefix_hits == eager.stats.prefix_hits > 0
    graph.submit(Request(uid=9, prompt=_stem_requests(model.cfg)[1].prompt, max_new_tokens=6))
    assert graph.run()[9].tokens.tolist() == results[0][1].tokens.tolist()


@pytest.mark.parametrize("layout,sparse,fmt", GRAPH_CASES)
def test_cuda_graph_launches_per_replay(cuda, layout, sparse, fmt):
    """A replay counts the launches of one eager step, and a run counts the
    warm-up, the replays and the prefills, nothing else."""
    model = _graph_model(cuda, fmt)
    sc = ServeConfig(max_slots=2, max_len=64, layout=layout, page_size=8)
    ops.reset_launches()
    graph = ServeEngine(model, sc, device="cuda", serve_sparse=sparse)
    warm = dict(ops.launches)               # the warm-up step, run eagerly
    assert warm == graph.launches_per_replay and sum(warm.values()) > 0
    eager = ServeEngine(model, sc, device="cuda", serve_sparse=sparse, cuda_graph=False)
    eager.submit(Request(uid=0, prompt=np.arange(3), max_new_tokens=4))
    eager._admit_ready()
    ops.reset_launches()
    eager.step_decode()
    assert dict(ops.launches) == graph.launches_per_replay
    # 3 prompt tokens: fed through decode under LPSA (pack 16); without it
    # one whole-prompt prefill, whose launches are one step's
    graph.submit(Request(uid=0, prompt=np.arange(3), max_new_tokens=4))
    ops.reset_launches()
    graph.run()
    steps, prefills = graph.stats.decode_steps, 0 if sparse else 1
    assert steps == graph.stats.graph_replays == (6 if sparse else 3)
    assert dict(ops.launches) == {k: n * (steps + prefills)
                                  for k, n in graph.launches_per_replay.items()}


# (E, K, N): qwen3-moe-30b-a3b's expert stacks (gate/up 2048 -> 768, down
# 768 -> 2048) at 8 experts, and a reduced stack with padding rows past K
@pytest.mark.parametrize("e,k,n", [(8, 2048, 768), (8, 768, 2048), (3, 61, 40)])
def test_cuda_twd_decode_stack(cuda, rng, e, k, n):
    """One launch decodes the whole stack, exactly its plain version."""
    trits = torch.from_numpy(rng.integers(-1, 2, size=(e, k, n)).astype(np.int8))
    packed = torch.stack([twd.pack_ternary(t, row_align=16) for t in trits]).to(cuda)
    ops.reset_launches()
    got = ops.twd_decode_stack(packed, k)
    assert ops.launches["twd_decode"] == 1
    assert torch.equal(got, ref.twd_decode_stack_ref(packed, k))
    assert torch.equal(got.cpu(), trits)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_cuda_moe_model_matches_cpu(cuda, arch):
    """Reduced MoE models (kimi-k2 with its shared expert): prefill + 8
    decode steps through the kernels agree with the same weights through
    the plain versions on the CPU within 2e-4, equal greedy tokens, and the
    expert stacks decode through twd_decode (3 launches a layer a call)."""
    cfg = reduced(get_config(arch))
    m_cpu = MD.init_serving(cfg, seed=3, device="cpu")
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, 48))[None]
    ops.reset_launches()
    lg_c, c_c = MD.prefill(m_cpu, prompt, max_len=64)
    lg_g, c_g = MD.prefill(m_gpu, prompt.to(cuda), max_len=64)
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
    tok = int(lg_c.argmax())
    for i in range(8):
        t = torch.tensor([48 + i])
        lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([tok]), t)
        lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([tok], device=cuda), t.to(cuda))
        torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
        assert int(lg_g.argmax()) == int(lg_c.argmax())
        tok = int(lg_c.argmax())
    assert ops.launches["twd_decode"] == 3 * cfg.n_layers * 9


def test_cuda_moe_graph_engine_matches_eager(cuda):
    """Reduced qwen3-moe: the captured decode step (routing, dispatch and
    combine with no host sync) gives the eager step's tokens bit for bit,
    and a request re-served alone keeps them."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    model = MD.init_serving(cfg, seed=5, device=cuda)
    sc = ServeConfig(max_slots=2, max_len=64)
    graph = ServeEngine(model, sc, device="cuda")
    eager = ServeEngine(model, sc, device="cuda", cuda_graph=False)
    results = []
    for eng in (graph, eager):
        for r in _stem_requests(cfg):
            eng.submit(r)
        results.append(eng.run())
    assert graph.stats.graph_replays == graph.stats.decode_steps > 0
    for uid, res in results[1].items():
        assert results[0][uid].tokens.tolist() == res.tokens.tolist(), uid
    graph.submit(Request(uid=9, prompt=_stem_requests(cfg)[1].prompt, max_new_tokens=6))
    assert graph.run()[9].tokens.tolist() == results[0][1].tokens.tolist()


# the SSM pair's projections (K, N) beyond bitnet-1.3b's: rwkv6-3b's 2560 ->
# 2560 / 8960 and 8960 -> 2560, gla-1.3b's 2048 -> 5632 and 5632 -> 2048
SSM_SHAPES = [(2560, 2560), (2560, 8960), (8960, 2560), (2048, 5632), (5632, 2048)]


@pytest.mark.parametrize("k,n", SSM_SHAPES)
def test_cuda_ssm_projections(cuda, rng, k, n):
    """das_topk's serving call (exact) and das_ternary_gemm on its
    compaction (bfloat16 tolerance) at the SSM shapes, 4 decode rows and a
    300-row prefill, against their plain versions; the weight scale the
    export gives a fan-in of K."""
    packed = _packed(rng, k, n, cuda)
    scale = (2 / np.pi / k) ** 0.5
    for m in (4, 300):
        x = _rows(rng, m, k, torch.bfloat16, False, cuda)
        ca = ops.das_topk(x, keep=16, with_mask=False)
        _assert_same(ca, ref.das_topk_ref(x, keep=16, block=32, with_mask=False))
        got = ops.das_ternary_gemm(ca.values, ca.indices, packed, scale, keep=16)
        want = ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "gla-1.3b"])
def test_cuda_ssm_model_matches_cpu(cuda, arch):
    """Reduced rwkv6-3b and gla-1.3b in float32: a 61-token prefill (61
    one-token chunks) + 8 decode steps through the kernels agree with the
    same weights on the CPU within 2e-4, with equal greedy tokens."""
    cfg = reduced(get_config(arch))
    m_cpu = MD.init_serving(cfg, seed=3, device="cpu")
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, 61))[None]
    lg_c, c_c = MD.prefill(m_cpu, prompt)
    lg_g, c_g = MD.prefill(m_gpu, prompt.to(cuda))
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
    tok = int(lg_c.argmax())
    for i in range(8):
        t = torch.tensor([61 + i])
        lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([tok]), t)
        lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([tok], device=cuda), t.to(cuda))
        torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
        assert int(lg_g.argmax()) == int(lg_c.argmax())
        tok = int(lg_c.argmax())


@pytest.mark.parametrize("layout", ["auto", "paged"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "gla-1.3b"])
def test_cuda_ssm_graph_engine_matches_eager(cuda, arch, layout):
    """The recurrent slot states inside the captured decode step: every
    step a replay, the eager step's tokens bit for bit (a state rebound in
    place of written would freeze under replay), a request re-served alone
    keeps them, and a replay counts one eager step's launches."""
    cfg = reduced(get_config(arch))
    model = MD.init_serving(cfg, seed=5, device=cuda)
    sc = ServeConfig(max_slots=2, max_len=64, layout=layout, page_size=8)
    graph = ServeEngine(model, sc, device="cuda")
    eager = ServeEngine(model, sc, device="cuda", cuda_graph=False)
    per_layer = {"rwkv": 8, "gla": 4}[cfg.layer_pattern[0]]
    assert graph.launches_per_replay["das_topk"] == per_layer * cfg.n_layers
    assert graph.launches_per_replay["das_ternary_gemm"] == 8 * cfg.n_layers
    results = []
    for eng in (graph, eager):
        for r in _stem_requests(cfg):
            eng.submit(r)
        results.append(eng.run())
    assert graph.stats.graph_replays == graph.stats.decode_steps > 0
    for uid, res in results[1].items():
        assert results[0][uid].tokens.tolist() == res.tokens.tolist(), uid
    if layout == "paged":
        assert graph.stats.prefix_hits == eager.stats.prefix_hits > 0
    graph.submit(Request(uid=9, prompt=_stem_requests(cfg)[1].prompt, max_new_tokens=6))
    assert graph.run()[9].tokens.tolist() == results[0][1].tokens.tolist()


# zamba2-2.7b's projections (K, N): wz / wx 2560 -> 5120, the mamba wo
# 5120 -> 2560, the FFN's gate/up 2560 -> 10240 and down 10240 -> 2560
HYBRID_SHAPES = [(2560, 5120), (5120, 2560), (2560, 10240), (10240, 2560)]


@pytest.mark.parametrize("k,n", HYBRID_SHAPES)
def test_cuda_hybrid_projections(cuda, rng, k, n):
    """das_topk's serving call (exact; norm-fused with the normed rows at
    K = 2560, the mamba and attention blocks' input) and das_ternary_gemm on
    its compaction (bfloat16 tolerance) at zamba2's shapes, 4 decode rows
    and a 256-row pack, against their plain versions."""
    packed = _packed(rng, k, n, cuda)
    scale = (2 / np.pi / k) ** 0.5
    nscale = (0.5 * torch.from_numpy(rng.standard_normal(k).astype(np.float32))).to(
        cuda, torch.bfloat16)
    for m in (4, 256):
        x = _rows(rng, m, k, torch.bfloat16, False, cuda)
        ca = ops.das_topk(x, keep=16, with_mask=False)
        _assert_same(ca, ref.das_topk_ref(x, keep=16, block=32, with_mask=False))
        if k == 2560:
            fused = ops.das_topk(x, keep=16, norm_scale=nscale, with_mask=False,
                                 with_normed=True)
            _assert_same(fused[:4], ref.das_topk_ref(fused.normed, keep=16, block=32,
                                                     with_mask=False)[:4])
            torch.testing.assert_close(fused.normed, rmsnorm(nscale, x), rtol=8e-3, atol=8e-3)
        got = ops.das_ternary_gemm(ca.values, ca.indices, packed, scale, keep=16)
        want = ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rows", [(1500, 700, 5, 1023), (2000,)])
def test_cuda_sparse_attention_hybrid_decode(cuda, rng, rows):
    """zamba2's attention, 32 query heads over 32 kv heads of 80: decode
    over full 1024-slot rings within the bfloat16 tolerance of the plain
    version, and each row bitwise the B = 1 call on it."""
    b, lk, h, d = len(rows), 1024, 32, 80
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(  # noqa: E731
        cuda, torch.bfloat16)
    q, k, v = mk(b, 1, h, d), mk(b, lk, h, d), mk(b, lk, h, d)
    qp = torch.tensor(rows, dtype=torch.int32, device=cuda)[:, None]
    kp = torch.stack([_ring_positions(t) for t in rows]).to(cuda)
    full = ops.sparse_attention(q, k, v, qp, kp, sink=128, window=896)
    torch.testing.assert_close(
        full, ref.sparse_attention_ref(q, k, v, qp, kp, sink=128, window=896),
        rtol=2e-2, atol=2e-2)
    for i in range(b):
        one = ops.sparse_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], qp[i:i + 1],
                                   kp[i:i + 1], sink=128, window=896)
        assert torch.equal(one, full[i:i + 1]), i


def test_cuda_sparse_attention_hybrid_prefill_pack(cuda, rng):
    """zamba2's streaming prefill pack (32 heads of 80 over 32, the pack at
    t0 = 512, rounded scores) within the bfloat16 tolerance, and each query
    row bitwise the same row of a call on a sub-range of the queries."""
    q, k, v, qp, kp = _prefill_inputs(rng, 1, 256, 1280, 32, 32, 80, 512, cuda)
    kw = dict(sink=128, window=896, round_scores=True)
    full = ops.sparse_attention(q, k, v, qp, kp, **kw)
    torch.testing.assert_close(full, ref.sparse_attention_ref(q, k, v, qp, kp, **kw),
                               rtol=2e-2, atol=2e-2)
    for lo, hi in ((0, 64), (100, 137)):
        part = ops.sparse_attention(q[:, lo:hi], k, v, qp[:, lo:hi], kp, **kw)
        assert torch.equal(part, full[:, lo:hi]), (lo, hi)


@pytest.mark.parametrize("shape", [(4, 256, 80), (1, 1024, 80), (2, 37, 8)])
def test_cuda_xla_cumsum_matches_cpu(cuda, rng, shape):
    """XLA's cumsum order on the card is the CPU's bit for bit: the decode
    step's (4 rows of 256 over 80 heads), a prefill's whole prompt and an
    unaligned length."""
    from repro_torch.models.layers import xla_cumsum
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    assert torch.equal(xla_cumsum(x.to(cuda), 1).cpu(), xla_cumsum(x, 1))


def test_cuda_hybrid_model_matches_cpu(cuda):
    """Reduced zamba2 at 12 layers (the shared attention at two positions)
    in float32: a 37-token prefill (2 chunks + 5) + 16 decode steps across a
    fold, LPSA off, agree with the same weights on the CPU within 2e-4, with
    equal greedy tokens."""
    cfg = reduced(get_config("zamba2-2.7b"), n_layers=12)
    m_cpu = MD.init_serving(cfg, seed=3, device="cpu")
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, 37))[None]
    kw = dict(serve_sparse=False)
    lg_c, c_c = MD.prefill(m_cpu, prompt, max_len=64, **kw)
    lg_g, c_g = MD.prefill(m_gpu, prompt.to(cuda), max_len=64, **kw)
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
    tok = int(lg_c.argmax())
    for i in range(16):
        t = torch.tensor([37 + i])
        lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([tok]), t, **kw)
        lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([tok], device=cuda), t.to(cuda), **kw)
        torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
        assert int(lg_g.argmax()) == int(lg_c.argmax())
        tok = int(lg_c.argmax())


@pytest.mark.parametrize("layout", ["auto", "paged"])
def test_cuda_hybrid_graph_engine_matches_eager(cuda, layout):
    """Reduced zamba2 at 12 layers: the mamba states and the shared
    attention inside the captured decode step, every step a replay, the
    eager step's tokens bit for bit (a fold or a buffer write rebound in
    place of written would freeze under replay), a request re-served alone
    keeps them, and a replay counts one eager step's launches (2 das_topk /
    3 das_ternary_gemm a mamba layer, 4 / 7 / 1 sparse_attention an
    attention block)."""
    cfg = reduced(get_config("zamba2-2.7b"), n_layers=12)
    model = MD.init_serving(cfg, seed=5, device=cuda)
    sc = ServeConfig(max_slots=2, max_len=64, layout=layout, page_size=8)
    graph = ServeEngine(model, sc, device="cuda")
    eager = ServeEngine(model, sc, device="cuda", cuda_graph=False)
    assert graph.launches_per_replay == {**{k: 0 for k in ops.KERNELS}, "das_topk": 10 * 2 + 2 * 4,
                                         "das_ternary_gemm": 10 * 3 + 2 * 7,
                                         "sparse_attention": 2}
    results = []
    for eng in (graph, eager):
        for r in _stem_requests(cfg, gen=20):
            eng.submit(r)
        results.append(eng.run())
    assert graph.stats.graph_replays == graph.stats.decode_steps > 0
    for uid, res in results[1].items():
        assert results[0][uid].tokens.tolist() == res.tokens.tolist(), uid
    if layout == "paged":
        assert graph.stats.prefix_hits == eager.stats.prefix_hits > 0
    graph.submit(Request(uid=9, prompt=_stem_requests(cfg)[1].prompt, max_new_tokens=20))
    assert graph.run()[9].tokens.tolist() == results[0][1].tokens.tolist()


# the stub-frontend models' projections (K, N), float32 rows: musicgen-medium's
# q/k/v/o 1536 -> 1536, w_in 1536 -> 6144 and w_out 6144 -> 1536; pixtral-12b's
# q/o 5120 -> 5120 (q_dim 32 x 160), k/v 5120 -> 1280, gate/up 5120 -> 14336,
# down 14336 -> 5120
FRONTEND_SHAPES = [(1536, 1536), (1536, 6144), (6144, 1536), (5120, 5120), (5120, 1280),
                   (5120, 14336), (14336, 5120)]


@pytest.mark.parametrize("k,n", FRONTEND_SHAPES)
def test_cuda_frontend_projections_f32(cuda, rng, k, n):
    """The float32 stream's projections: das_topk on float32 rows (exact),
    plain and norm-fused with a float32 scale (the normed rows within 8
    steps of rmsnorm, the DAS step of them exact), and das_ternary_gemm on
    the float32 compaction (1e-4) at 4 decode rows (the decode class) and a
    256-row pack (the FMA prefill class)."""
    packed = _packed(rng, k, n, cuda)
    scale = (2 / np.pi / k) ** 0.5
    nscale = (0.5 * torch.from_numpy(rng.standard_normal(k).astype(np.float32))).to(cuda)
    for m in (4, 256):
        x = _rows(rng, m, k, torch.float32, False, cuda)
        ca = ops.das_topk(x, keep=16, with_mask=False)
        _assert_same(ca, ref.das_topk_ref(x, keep=16, block=32, with_mask=False))
        fused = ops.das_topk(x, keep=16, norm_scale=nscale, with_mask=False, with_normed=True)
        assert float(_steps(fused.normed, rmsnorm(nscale, x)).max()) <= 8
        _assert_same(fused[:4], ref.das_topk_ref(fused.normed, keep=16, block=32,
                                                 with_mask=False)[:4])
        got = ops.das_ternary_gemm(ca.values, ca.indices, packed, scale, keep=16)
        want = ref.das_ternary_gemm_ref(ca.values, ca.indices, packed, scale)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (label, Lq, Lk, Hq, Hkv, dtype): pixtral-12b's head size 160 (32 over 8) in
# every class: decode over a full ring in bf16 and f32, an LPSA pack on the
# tensor cores in bf16 and on FMAs in f32
HEAD_160_CASES = [("decode bf16 ring 1024", 1, 1024, 32, 8, torch.bfloat16),
                  ("decode f32 ring 1024", 1, 1024, 32, 8, torch.float32),
                  ("prefill bf16 pack", 256, 1280, 32, 8, torch.bfloat16),
                  ("prefill f32 pack", 64, 1280, 8, 2, torch.float32)]


@pytest.mark.parametrize("case", HEAD_160_CASES, ids=[c[0] for c in HEAD_160_CASES])
def test_cuda_sparse_attention_head_160(cuda, rng, case):
    """D = 160 (320-byte bf16 rows: 32-key tiles at decode, no padding on the
    tensor cores) against the plain version (2e-2 bf16, 3e-4 float32), and
    row 1 of a B = 2 call bitwise a B = 1 call on it."""
    label, lq, lk, hq, hkv, dt = case
    b, kw = 2, dict(sink=128, window=896)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(  # noqa: E731
        cuda, dt)
    q, k, v = mk(b, lq, hq, 160), mk(b, lk, hkv, 160), mk(b, lk, hkv, 160)
    if lq == 1:
        rows = [5000, 700]
        qp = torch.tensor(rows, dtype=torch.int32, device=cuda)[:, None]
        kp = _ring(rows, lk, 128, 896).to(cuda)
    else:                   # packs at t0 = 2000 and 512, their first lq queries
        qps, kps = zip(*(_pack_positions(t0) for t0 in (2000, 512)))
        qp = torch.stack([p[:lq] for p in qps]).to(cuda)
        kp = torch.stack(kps).to(cuda)
        kw["round_scores"] = True
    got = ops.sparse_attention(q, k, v, qp, kp, **kw)
    tol = 2e-2 if dt == torch.bfloat16 else 3e-4
    torch.testing.assert_close(got, ref.sparse_attention_ref(q, k, v, qp, kp, **kw),
                               rtol=tol, atol=tol)
    one = ops.sparse_attention(q[1:], k[1:], v[1:], qp[1:], kp[1:], **kw)
    assert torch.equal(one, got[1:])


@pytest.mark.parametrize("d,hq,hkv", [(64, 24, 24), (160, 32, 8)])
def test_cuda_sparse_attention_f32_query_bf16_ring(cuda, rng, d, hq, hkv):
    """The decode class on float32 queries over bfloat16 K/V (the float32
    stream reading its bfloat16 ring: musicgen-medium's 24/24 heads of 64,
    pixtral-12b's 32/8 of 160): a float32 output within 3e-4 of the plain
    version (which upcasts the ring), each row bitwise a B = 1 call, and the
    pair refused at Lq > 1."""
    rows = [5000, 1023, 700, 5]
    b = len(rows)
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, d)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((b, 1024, hkv, d)).astype(np.float32))
            .to(cuda, torch.bfloat16) for _ in range(2))
    qp = torch.tensor(rows, dtype=torch.int32, device=cuda)[:, None]
    kp = _ring(rows, 1024, 128, 896).to(cuda)
    kw = dict(sink=128, window=896)
    got = ops.sparse_attention(q, k, v, qp, kp, **kw)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.sparse_attention_ref(q, k, v, qp, kp, **kw),
                               rtol=3e-4, atol=3e-4)
    for i in range(b):
        one = ops.sparse_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], qp[i:i + 1],
                                   kp[i:i + 1], **kw)
        assert torch.equal(one, got[i:i + 1]), i
    with pytest.raises(ValueError, match="Lq = 1"):
        ops.sparse_attention(q.expand(b, 2, hq, d).contiguous(), k, v,
                             qp.expand(b, 2).contiguous(), kp, **kw)


def _frontend_model(cuda, arch, dtype="bfloat16"):
    return MD.init_serving(dataclasses.replace(reduced(get_config(arch)), dtype=dtype),
                           seed=5, device=cuda)


def _embed_requests(cfg, gen=6):
    """Embedding prompts of 37, 21, 9 and 40 rows, 1 step apart."""
    rng = np.random.default_rng(5)
    return [Request(uid=i, prompt=rng.standard_normal((n, cfg.d_model)).astype(np.float32),
                    max_new_tokens=gen, arrival=i) for i, n in enumerate((37, 21, 9, 40))]


@pytest.mark.parametrize("arch", ["musicgen-medium", "pixtral-12b"])
def test_cuda_frontend_model_matches_cpu(cuda, arch):
    """Reduced musicgen-medium and pixtral-12b in float32: a 32-row
    embedding prefill + 8 decode steps (3 forced rows, then tokens) through
    the kernels agree with the same weights on the CPU within 2e-4, with
    equal greedy tokens."""
    cfg = reduced(get_config(arch))
    m_cpu = MD.init_serving(cfg, seed=3, device="cpu")
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((35, cfg.d_model))
                         .astype(np.float32))
    lg_c, c_c = MD.prefill(m_cpu, x[None, :32], max_len=48)
    lg_g, c_g = MD.prefill(m_gpu, x[None, :32].to(cuda), max_len=48)
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
    tok = int(lg_c.argmax())
    for i in range(8):
        t, row = 32 + i, x[32 + i:33 + i] if 32 + i < 35 else torch.zeros((1, cfg.d_model))
        forced = torch.tensor([32 + i < 35])
        kw = dict(forced=forced, forced_x=row)
        lg_c, _ = MD.decode_step(m_cpu, c_c, torch.tensor([tok]), torch.tensor([t]), **kw)
        lg_g, _ = MD.decode_step(m_gpu, c_g, torch.tensor([tok], device=cuda),
                                 torch.tensor([t], device=cuda),
                                 **{k: v.to(cuda) for k, v in kw.items()})
        torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=0, atol=2e-4)
        assert int(lg_g.argmax()) == int(lg_c.argmax())
        tok = int(lg_c.argmax())


@pytest.mark.parametrize("layout", ["auto", "paged"])
@pytest.mark.parametrize("arch", ["musicgen-medium", "pixtral-12b"])
def test_cuda_frontend_graph_engine_matches_eager(cuda, arch, layout):
    """A bfloat16 config served from float32 embedding prompts: ``forced``
    and ``forced_x`` inside the captured decode step (a buffer rebound in
    place of written would freeze under replay), every step a replay, the
    eager step's tokens bit for bit, a request re-served alone keeps them,
    no prefix hit, and a replay counts one eager step's launches (4 das_topk
    / 6 or 7 das_ternary_gemm / 1 sparse_attention a layer)."""
    model = _frontend_model(cuda, arch)
    cfg = model.cfg
    sc = ServeConfig(max_slots=2, max_len=64, layout=layout, page_size=8)
    graph = ServeEngine(model, sc, device="cuda")
    eager = ServeEngine(model, sc, device="cuda", cuda_graph=False)
    gemms = 6 if cfg.ffn_kind == "mlp" else 7
    assert graph.launches_per_replay == {**{k: 0 for k in ops.KERNELS},
                                         "das_topk": 4 * cfg.n_layers,
                                         "das_ternary_gemm": gemms * cfg.n_layers,
                                         "sparse_attention": cfg.n_layers}
    results = []
    for eng in (graph, eager):
        for r in _embed_requests(cfg):
            eng.submit(r)
        results.append(eng.run())
    assert graph.stats.graph_replays == graph.stats.decode_steps > 0
    assert graph.stats.prefix_hits == 0
    assert all(c["k"].dtype == torch.bfloat16 for c in graph.caches)
    for uid, res in results[1].items():
        assert results[0][uid].tokens.tolist() == res.tokens.tolist(), uid
    graph.submit(Request(uid=9, prompt=_embed_requests(cfg)[0].prompt, max_new_tokens=6))
    assert graph.run()[9].tokens.tolist() == results[0][0].tokens.tolist()


# -- the sampler (serve/sampler.py) -------------------------------------------

@pytest.mark.parametrize("width", [32000, 131072])
def test_cuda_sampler_bits_match_cpu(cuda, width):
    """Keys, random bits and uniforms on the card equal the CPU's bitwise
    over a grid of (uid, counter); the gumbel noise (CUDA's logf against
    the CPU's log) within 4 float32 ulps of max(|g|, 1)."""
    from repro_torch.serve import sampler as S
    uids = torch.tensor([u for u in (0, 1, 7, 2 ** 31 - 1) for _ in range(3)])
    ctrs = torch.tensor([c for _ in range(4) for c in (0, 1, 31)])
    for seed in (0, 2 ** 31 - 1):
        k_cpu = S.fold_keys(S.prng_key(seed), uids, ctrs)
        k_gpu = S.fold_keys(S.prng_key(seed, cuda), uids.to(cuda), ctrs.to(cuda))
        assert torch.equal(k_gpu.cpu(), k_cpu)
        assert torch.equal(S.random_bits(k_gpu, width).cpu(), S.random_bits(k_cpu, width))
        assert torch.equal(S.uniform(k_gpu, width).cpu(), S.uniform(k_cpu, width))
        g_cpu = S.gumbel(k_cpu, width)
        err = ((S.gumbel(k_gpu, width).cpu() - g_cpu).abs() / g_cpu.abs().clamp_min(1)).max()
        assert err <= 4 * torch.finfo(torch.float32).eps, err


def _sampled_requests(cfg, gen=6):
    """Greedy and sampled requests, one a whole pack (its first token drawn
    from the prefill's logits), 1 step apart."""
    rng = np.random.default_rng(7)
    spec = [(20, 0.8), (16, 0.0), (7, 1.3), (33, 0.5)]
    return [Request(uid=100 + 17 * i, prompt=rng.integers(0, cfg.vocab, p), max_new_tokens=gen,
                    arrival=i, temperature=t) for i, (p, t) in enumerate(spec)]


@pytest.mark.parametrize("layout", ["auto", "paged"])
def test_cuda_sampling_graph_matches_eager(cuda, layout):
    """Temperature and top-k sampling from the second captured graph: the
    eager engine's tokens bit for bit, every step a replay of the decode
    graph, a replay still counting one eager step's launches; each request
    served alone on a fresh engine (the same uid) keeps its tokens, since
    its keys depend on (uid, counter) only; a greedy-only run never
    replays the sampler."""
    model = _graph_model(cuda, "packed")
    sc = ServeConfig(max_slots=2, max_len=64, layout=layout, page_size=8, top_k=40, seed=3)
    graph = ServeEngine(model, sc, device="cuda")
    eager = ServeEngine(model, sc, device="cuda", cuda_graph=False)
    probe = ServeEngine(model, sc, device="cuda", cuda_graph=False)
    probe.submit(Request(uid=0, prompt=np.arange(3), max_new_tokens=4, temperature=0.9))
    probe._admit_ready()
    ops.reset_launches()
    probe.step_decode()                      # a sampling step counts no kernel launch
    assert probe.stats.sampling_steps == 1
    assert dict(ops.launches) == graph.launches_per_replay
    results = []
    for eng in (graph, eager):
        for r in _sampled_requests(model.cfg):
            eng.submit(r)
        results.append(eng.run())
    assert graph.stats.graph_replays == graph.stats.decode_steps > 0
    assert graph.stats.sampling_steps == eager.stats.sampling_steps > 0
    for uid, res in results[1].items():
        assert results[0][uid].tokens.tolist() == res.tokens.tolist(), uid
    for r in _sampled_requests(model.cfg):
        solo = ServeEngine(model, sc, device="cuda")
        solo.submit(dataclasses.replace(r, arrival=0))
        assert solo.run()[r.uid].tokens.tolist() == results[0][r.uid].tokens.tolist(), r.uid
    greedy = [dataclasses.replace(r, temperature=0.0) for r in _sampled_requests(model.cfg)]
    for r in greedy:
        graph.submit(r)
    before = graph.stats.sampling_steps
    graph.run()
    assert graph.stats.sampling_steps == before


# --------------------------------------------------------------------------
# training (bitnet-1.3b's QAT step)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2048, 5460, 2560, 5120, 5632, 8960, 10240])
def test_cuda_das_topk_training_mask(cuda, rng, k):
    """The training step's call, the mask alone, at 4 x 2048 rows in bf16
    and every K of the train paths (bitnet-1.3b's, zamba2-2.7b's 2560, 5120
    and 10240, gla-1.3b's 5632, rwkv6-3b's 8960): exact against the plain
    version, nothing else written, and the 20 tail lanes of K = 5460 all
    kept."""
    x = _rows(rng, 8192, k, torch.bfloat16, False, cuda)
    got = ops.das_topk(x, keep=16, block=32, with_compact=False)
    assert got.values is None and got.indices is None and got.dense is None
    want = ref.das_topk_ref(x, keep=16, block=32, with_compact=False)
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.mask, das.das_mask(x, keep=16).to(torch.int8))
    assert bool((got.mask[:, k - k % 32:] == 1).all())
    assert int(got.mask[:, :k - k % 32].sum()) == 8192 * (k // 32) * 16


def test_cuda_train_step_kernel_matches_plain(cuda, monkeypatch):
    """A 2-layer cut of bitnet-1.3b at a reduced width (d_model 256, bf16,
    remat on), one step's loss and gradients with the DAS masks from the
    das_topk kernel and from the plain das_mask: bitwise, and das_topk
    launched 8 times a layer (4 forward, 4 in remat's recompute)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as TR
    from repro_torch.models import ternary_linear as TL
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(reduced(get_config("bitnet-1.3b"), n_layers=2, d_model=256),
                              dtype="bfloat16", remat=True)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=128, batch=2)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in data.batch_at(0).items()}
    plain = lambda x, tc: das.das_mask(x.detach(), block_size=tc.das.block, keep=tc.das.keep)  # noqa: E731
    runs = []
    for mode in ("kernel", "plain"):
        if mode == "plain":
            monkeypatch.setattr(TL, "das_train_mask", plain)
        p = MD.init_params(cfg, seed=3, device=cuda)
        ops.reset_launches()
        step = TR.make_train_step(cfg, TR.make_runtime(), total=4)
        p, o, m = step(p, adamw.adamw_init(p), batch)
        runs.append((dict(ops.launches), m, leaves(p), leaves(o)))
    (lk, mk, pk, ok), (lp, mp, pp, op) = runs
    assert lk["das_topk"] == 2 * 8 and lp["das_topk"] == 0
    assert all(n == 0 for name, n in lk.items() if name != "das_topk")
    assert float(mk["loss"]) == float(mp["loss"]) and torch.isfinite(mk["loss"])
    assert float(mk["grad_norm"]) == float(mp["grad_norm"])
    for a, b in zip(pk + ok, pp + op):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# training, the other block kinds
# --------------------------------------------------------------------------

TRAIN_KINDS = {"qwen3-moe-30b-a3b": (2, 3), "gla-1.3b": (2, 4), "rwkv6-3b": (2, 8),
               "zamba2-2.7b": (6, None)}   # (layers, das_topk a layer forward)


def _train_cfg(arch, n_layers, **moe):
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=n_layers, d_model=256),
                              dtype="bfloat16", remat=True)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _train_batch(cfg, cuda):
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(vocab=cfg.vocab, seq_len=128, batch=2)
    return {k: torch.as_tensor(v, device=cuda) for k, v in data.batch_at(0).items()}


@pytest.mark.parametrize("arch", sorted(TRAIN_KINDS))
def test_cuda_train_step_every_kind_kernel_matches_plain(cuda, monkeypatch, arch):
    """A cut of each other block kind at a reduced width (d_model 256, bf16,
    remat on: the MoE, gla and rwkv 2 layers, zamba2 one pattern period of
    6), one step with the DAS masks from das_topk and from the plain
    das_mask: loss, gradient norm, updated params and moments bitwise, and
    das_topk launched twice a DAS input a layer (zamba2: 2 a mamba layer, 4
    its attention block)."""
    from repro_torch.launch import train as TR
    from repro_torch.models import ternary_linear as TL
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    n_layers, per_layer = TRAIN_KINDS[arch]
    cfg = _train_cfg(arch, n_layers)
    batch = _train_batch(cfg, cuda)
    plain = lambda x, tc: das.das_mask(x.detach(), block_size=tc.das.block, keep=tc.das.keep)  # noqa: E731
    runs = []
    for mode in ("kernel", "plain"):
        if mode == "plain":
            monkeypatch.setattr(TL, "das_train_mask", plain)
        p = MD.init_params(cfg, seed=3, device=cuda)
        ops.reset_launches()
        step = TR.make_train_step(cfg, TR.make_runtime(), total=4)
        p, o, m = step(p, adamw.adamw_init(p), batch)
        runs.append((dict(ops.launches), m, leaves(p), leaves(o)))
    (lk, mk, pk, ok), (lp, mp, pp, op) = runs
    forward = (n_layers * per_layer if per_layer is not None else
               sum(2 if k == "mamba" else 4 for k in cfg.layer_kinds()))
    assert lk["das_topk"] == 2 * forward and lp["das_topk"] == 0
    assert all(n == 0 for name, n in lk.items() if name != "das_topk")
    assert float(mk["loss"]) == float(mp["loss"]) and torch.isfinite(mk["loss"])
    assert float(mk["grad_norm"]) == float(mp["grad_norm"])
    for a, b in zip(pk + ok, pp + op):
        assert torch.equal(a, b)


def test_cuda_moe_train_grads_bitwise_across_runs(cuda):
    """The MoE step's gradients, at capacity factor 1.0 (copies drop), are
    bitwise the same in two runs: the dispatch and the combine sum nothing
    with atomics."""
    from repro_torch.models import moe as MOE
    from repro_torch.tree import leaves
    cfg = _train_cfg("qwen3-moe-30b-a3b", 2, capacity_factor=1.0)
    batch = _train_batch(cfg, cuda)
    drops, runs = [], []
    orig = MOE.dispatch_compute

    def counting(*args):
        out, counts = orig(*args)
        drops.append(int((counts - args[-1]).clamp(min=0).sum()))
        return out, counts

    MOE.dispatch_compute = counting
    try:
        for _ in range(2):
            p = MD.init_params(cfg, seed=4, device=cuda)
            flat = leaves(p)
            for t in flat:
                t.requires_grad_()
            loss, _ = MD.loss_fn(p, cfg, batch)
            runs.append((loss.detach(), torch.autograd.grad(loss, flat)))
    finally:
        MOE.dispatch_compute = orig
    assert any(n > 0 for n in drops), drops
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# tensor parallelism: the kernels on bitnet-1.3b's tp = 2 shards
# --------------------------------------------------------------------------

# (logical dim, its cut at tp 2): q heads (wq's N, wo's K), d_ff on whole
# DAS blocks with the 20-lane dense tail on rank 1 (w_gate / w_in's N,
# w_out's K)
TP2_BOUNDS = {"q": ((0, 1024), (1024, 2048)), "ff": ((0, 2720), (2720, 5460))}


@pytest.mark.parametrize("m", [4, 256])
def test_cuda_packed_gemms_at_tp2_shards(cuda, rng, m):
    """Column-parallel (wq, w_gate): the shards' outputs joined over N equal
    the unsharded kernel's within the GEMM tolerance; row-parallel (wo, and
    w_out by both routes, compacted on rank 0's 2720 lanes and masked dense
    on rank 1's 2740): the shards' K partials summed.  das_topk on each K
    shard gives the unsharded mask's columns exactly (no DAS block
    straddles the cut)."""
    from repro_torch.distributed.plan import shard_bounds
    assert shard_bounds(5460, 2, unit=32) == TP2_BOUNDS["ff"]
    bf16 = torch.bfloat16

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))

    x = torch.from_numpy(rng.standard_normal((m, 2048)).astype(np.float32)).to(cuda, bf16)
    ca = ops.das_topk(x, keep=16)
    for n, bounds in ((2048, TP2_BOUNDS["q"]), (5460, TP2_BOUNDS["ff"])):
        p = _packed(rng, 2048, n, cuda)
        full = ops.das_ternary_gemm(ca.values, ca.indices, p, SCALE, keep=16)
        joined = torch.cat([ops.das_ternary_gemm(ca.values, ca.indices,
                                                 p[:, lo:hi].contiguous(), SCALE, keep=16)
                            for lo, hi in bounds], dim=1)
        close(joined, full)
    for k, bounds in ((2048, TP2_BOUNDS["q"]), (5460, TP2_BOUNDS["ff"])):
        trits = torch.from_numpy(rng.integers(-1, 2, size=(k, 2048)).astype(np.int8))
        p = twd.pack_ternary(trits, row_align=16).to(cuda)
        xk = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, bf16)
        step = ops.das_topk(xk, keep=16, with_dense=True)
        full = (ops.das_ternary_gemm(step.values, step.indices, p, SCALE, keep=16)
                if k % 32 == 0 else ops.ternary_gemm(step.dense, p, SCALE))
        dense_sum = compact_sum = 0
        for lo, hi in bounds:
            shard = twd.pack_ternary(trits[lo:hi], row_align=16).to(cuda)
            s = ops.das_topk(xk[:, lo:hi].contiguous(), keep=16, with_dense=True)
            assert torch.equal(s.mask, step.mask[:, lo:hi])
            dense_sum = dense_sum + ops.ternary_gemm(s.dense, shard, SCALE)
            if (hi - lo) % 32 == 0:
                compact_sum = compact_sum + ops.das_ternary_gemm(s.values, s.indices, shard,
                                                                 SCALE, keep=16)
            else:
                compact_sum = compact_sum + ops.ternary_gemm(s.dense, shard, SCALE)
        close(dense_sum, full)
        close(compact_sum, full)


@pytest.mark.parametrize("lq", [1, 256])
def test_cuda_sparse_attention_at_tp2_heads(cuda, rng, lq):
    """32 heads of 64 (bitnet-1.3b) against each rank's 16, joined over
    heads: the decode class over a full ring and an LPSA pack (rounded
    scores), within the attention tolerance."""
    bf16 = torch.bfloat16
    lk = 1024 if lq == 1 else 128 + 896 + 256

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, bf16)

    q, k, v = t(2, lq, 32, 64), t(2, lk, 32, 64), t(2, lk, 32, 64)
    if lq == 1:
        qp = torch.full((2, 1), 3000, dtype=torch.int32, device=cuda)
        kp = torch.from_numpy(np.stack([np.arange(lk)] * 2).astype(np.int32)).to(cuda)
        kw = dict(sink=128, window=896)
    else:
        qp1, kp1 = (p.to(torch.int32) for p in lpsa.pack_positions(
            2048, lpsa.LpsaSpec(sink=128, window=896, chunk=256)))
        qp, kp = qp1[None].expand(2, -1).to(cuda), kp1[None].expand(2, -1).to(cuda)
        qp, kp = qp.contiguous(), kp.contiguous()
        kw = dict(sink=128, window=896, round_scores=True)
    full = ops.sparse_attention(q, k, v, qp, kp, **kw)
    joined = torch.cat([ops.sparse_attention(q[:, :, h:h + 16].contiguous(),
                                             k[:, :, h:h + 16].contiguous(),
                                             v[:, :, h:h + 16].contiguous(), qp, kp, **kw)
                        for h in (0, 16)], dim=2)
    torch.testing.assert_close(joined.float(), full.float(), rtol=2e-2, atol=2e-2)


def test_cuda_spmd_engine_matches_one_device(cuda, tmp_path):
    """Reduced bitnet-1.3b at Topology(dp=2, tp=2): 4 ranks on this card
    over gloo serve the tokens of the one-device engine on the same weights,
    each rank launching the kernels on its shard."""
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.distributed.plan import Topology
    from repro_torch.launch import serve as cli
    cfg = reduced(get_config("bitnet-1.3b"))
    model = MD.export_serving(MD.init_params(cfg, seed=5, device=cuda), cfg)
    rng = np.random.default_rng(5)
    trace = tuple(Request(uid=i, prompt=rng.integers(0, cfg.vocab, p), max_new_tokens=8,
                          arrival=2 * i) for i, p in enumerate((40, 16, 9, 33)))
    sc = ServeConfig(max_slots=4, max_len=64)
    eng = ServeEngine(model, sc, device="cuda")
    for r in trace:
        eng.submit(r)
    want = {uid: r.tokens.tolist() for uid, r in eng.run().items()}
    path = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), path)
    job = cli.RankJob(cfg, dataclasses.replace(sc, topology=Topology(dp=2, tp=2)), "cuda",
                      path, trace)
    for out in run_ranks(cli.serve_jobs, 4, [job]):
        assert out[0]["tokens"] == want
        assert all(out[0]["launches"][k] > 0 for k in ("das_topk", "das_ternary_gemm",
                                                       "sparse_attention"))


def _dist_train_rank(rank, path, cfg, batches, records, device="cuda"):
    """One rank of Topology(dp=2, tp=2) with ZeRO-1: step 1's gradients
    (summed over "dp", gathered over "model"), then the steps' losses and
    the gathered params, each pass taking one rank's rounding decisions at
    near ties (``records``: ``Replay.record``'s, one for the gradients and
    step 1, one for step 2); the launches a rank made, and the ties'
    (ok, summary)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.launch import rank_device
    from repro_torch.distributed.plan import Topology
    from repro_torch.launch import train as TR
    from repro_torch.tree import leaves, unflatten
    from torch_ties import Replay
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Topology(dp=2, tp=2).build_mesh()
    sh = TR.train_shardings(mesh, torch.load(path), cfg=cfg, device=dev)
    rt = TR.make_runtime(mesh, len(batches[0]["inputs"]))
    rows = TR.batch_rows(mesh, len(batches[0]["inputs"]))
    ties = Replay(rows, MD.model_bounds(cfg, 2), mesh.model_index)
    try:
        ties.force(records[0])
        ops.reset_launches()
        _, aux, g = TR.loss_and_grads(sh.params, cfg, {k: v[rows] for k, v in batches[0].items()},
                                      rt)
        launches = dict(ops.launches)
        g = MD.gather_params(g, cfg, mesh)
        g = unflatten(g, [C.psum(x.float(), mesh, "dp").cpu() for x in leaves(g)])
        step = TR.make_train_step(cfg, rt, total=4)
        p, o, losses = sh.params, sh.opt, []
        for s, b in enumerate(batches):
            if s:
                ties.force(records[s])
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
    finally:
        ties.restore()
    p = [x.cpu() for x in leaves(MD.gather_params(p, cfg, mesh))]
    return float(aux["loss"]), g, losses, p, launches, (ties.ok(), ties.summary())


def dist_train_case(das, device, tmp):
    """Reduced bitnet-1.3b (d_model 256, 2 layers, float32, remat) on
    ``device``: one rank's loss, gradients, step losses and params (its
    rounding decisions recorded), and the 4 ranks' outputs on the same
    weights and batches (``_dist_train_rank``)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.launch import train as TR
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, tree_map
    from torch_ties import Replay
    cfg = dataclasses.replace(reduced(get_config("bitnet-1.3b"), d_model=256), remat=True)
    if not das:
        cfg = dataclasses.replace(cfg, ternary=dataclasses.replace(cfg.ternary, das=None))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=128, batch=4, seed=9)
    batches = [data.batch_at(s) for s in range(2)]
    p = MD.init_params(cfg, seed=9, device=device)
    path = str(tmp / "params.pt")
    torch.save(tree_map(lambda x: x.cpu(), p), path)
    ties, records = Replay(), []
    try:
        records.append(ties.record())
        _, aux, g = TR.loss_and_grads(p, cfg, batches[0], TR.make_runtime())
        step = TR.make_train_step(cfg, TR.make_runtime(), total=4)
        o, losses = adamw.adamw_init(p), []
        for s, b in enumerate(batches):
            if s:
                records.append(ties.record())
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
    finally:
        ties.restore()
    want = (float(aux["loss"]), [x.float().cpu() for x in leaves(g)], losses,
            [x.cpu() for x in leaves(p)])
    return cfg, want, run_ranks(_dist_train_rank, 4, path, cfg, batches, records, device)


@pytest.mark.parametrize("das", [False, True], ids=["quantized", "das"])
def test_cuda_dist_train_matches_one_rank(cuda, tmp_path, das):
    """Reduced bitnet-1.3b (d_model 256, 2 layers, float32, the fake-quants
    on, DAS off or on) at Topology(dp=2, tp=2) with ZeRO-1, 4 ranks on this
    card over gloo, against one rank on the same weights and batches:
    step 1's loss within 2e-5 and every gradient within 1e-4 of its leaf's
    max, the step losses and the params after 2 steps within 1e-4.  The
    ranks sum in another order (the weight scales and row-parallel partials
    over "model", the gradients over "data"), so a DAS, int8 or trit
    decision at a near tie can land on the other side: a rank takes one
    rank's decision there (``torch_ties.Replay``: within 1e-5 of a tie of
    its own input, at most 0.01 % of them).  Every rank launches das_topk
    on its shards with DAS on (8 a layer: 4 forward, 4 in remat's
    recompute)."""
    from repro_torch.tree import leaves
    cfg, (loss0, g0, losses0, p0), outs = dist_train_case(das, cuda, tmp_path)
    for loss, grads, steps, params, launches, (ok, summary) in outs:
        assert launches["das_topk"] == (8 * cfg.n_layers if das else 0)
        assert ok, summary
        assert abs(loss - loss0) <= 2e-5 * abs(loss0)
        for a, b in zip(leaves(grads), g0, strict=True):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert all(abs(a - b) <= 1e-4 for a, b in zip(steps, losses0))
        for a, b in zip(params, p0, strict=True):
            assert float((a - b).abs().max()) <= 1e-4


class _OneProcessMesh:
    """A Mesh stand-in for one model rank of tp ways, in one process: its
    collectives see a group of one, so each row-parallel output is the
    rank's partial, which the test sums itself."""

    def __init__(self, tp, index):
        from repro_torch.distributed.plan import Topology
        self.topology, self.model_index, self.data_index = Topology(tp=tp), index, 0
        self.backend, self.experts_only = "none", False

    def size(self, axis):
        return 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tp2_blocks_match_unsharded(cuda, dtype):
    """bitnet-1.3b's widths, one layer: each rank's attention (a 256-token
    LPSA pack, then a decode step) and FFN on its shard, the row-parallel
    partials summed, against the unsharded block; float32 within the GEMM
    tolerance of the output's max, bf16 within 2e-2 of it."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("bitnet-1.3b"), n_layers=1, dtype=dtype)
    full = MD.init_serving(cfg, seed=6, device=cuda)
    shards = [MD.shard_model(full, _OneProcessMesh(2, r), cuda) for r in (0, 1)]
    dt = full.embed.dtype
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((1, 256, cfg.d_model), generator=g, device=cuda).to(dt)
    tol = 1e-4 if dtype == "float32" else 2e-2

    def close(parts, want):
        got = sum(p.float() for p in parts)
        err = float((got - want.float()).abs().max() / want.float().abs().max())
        assert err <= tol, err

    blk = full.layers[0]
    want, state = A.attn_prefill_streaming(blk.attn, cfg, x, blk.norm1.scale, "attn")
    outs = [A.attn_prefill_streaming(m.layers[0].attn, m.cfg, x, m.layers[0].norm1.scale,
                                     "attn") for m in shards]
    close([o[0] for o in outs], want)
    close([T.ffn_apply(m.layers[0].ffn, m.cfg, x, m.layers[0].norm2.scale) for m in shards],
          T.ffn_apply(blk.ffn, cfg, x, blk.norm2.scale))
    xd = x[:, -1:]
    t = torch.tensor([256], device=cuda)
    step = A.decode_step_inputs(cfg, t, ["attn"], True)
    cache = T.KV.ring_from_stream(cfg, state, sink=cfg.lpsa.sink, window=cfg.lpsa.window)
    want = A.attn_decode(blk.attn, cfg, xd, blk.norm1.scale, cache, step, "attn")
    parts = []
    for m, o in zip(shards, outs):
        c = T.KV.ring_from_stream(m.cfg, o[1], sink=cfg.lpsa.sink, window=cfg.lpsa.window)
        parts.append(A.attn_decode(m.layers[0].attn, m.cfg, xd, m.layers[0].norm1.scale, c,
                                   A.decode_step_inputs(m.cfg, t, ["attn"], True), "attn"))
    close(parts, want)


# bitnet-1.3b's packed GEMMs under their launch configs: (op, K, N), the down
# projection (K = 5460, not whole DAS blocks) on masked dense rows
TUNE_SHAPES = [("das_ternary_gemm", 2048, 2048), ("das_ternary_gemm", 2048, 5460),
               ("ternary_gemm", 5460, 2048)]


def _config_call(op, x, packed):
    """(kernel at a config (None: no config argument), its plain version)
    of one packed GEMM call on the DAS step of rows x."""
    step = ops.das_topk(x, keep=16, with_mask=False, with_dense=True)
    scale = torch.tensor(SCALE, device=x.device)
    if op == "das_ternary_gemm":
        def run(c):
            kw = {} if c is None else {"config": c}
            return ops.das_ternary_gemm(step.values, step.indices, packed, scale, keep=16, **kw)
        return run, ref.das_ternary_gemm_ref(step.values, step.indices, packed, scale)

    def run(c):
        kw = {} if c is None else {"config": c}
        return ops.ternary_gemm(step.dense, packed, scale, **kw)
    return run, ref.ternary_gemm_ref(step.dense, packed, scale)


def _mma(op, dtype, k, n):
    from repro_torch.kernels import build
    if op == "das_ternary_gemm":
        return build.das_mma_route(dtype, k // 32 * 16, 16, 32, n)
    return build.dense_mma_route(dtype, k, n)


@pytest.mark.parametrize("op,k,n", TUNE_SHAPES)
@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_launch_configs(cuda, rng, op, k, n, m, dtype):
    """Every feasible subs (decode class) / parts (tensor-core prefill)
    config against the plain version (2e-2 bf16, 1e-4 float32); the
    default config bitwise the call without one and the explicit built-in
    config (build.dec_subs / mma_parts), so that a call without a
    config launches what it launched before configs existed."""
    from repro_torch.kernels import build
    packed = _packed(rng, k, n, cuda)
    r = packed.shape[0]
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    run, want = _config_call(op, x, packed)
    base = run(None)
    assert torch.equal(run(build.DEFAULT_CONFIG), base)
    mma = _mma(op, dtype, k, n)
    assert torch.equal(run(build.builtin_config(m, r, n, mma)), base)
    configs = build.launch_configs(m, r, n, mma)
    assert configs or (m > 4 and not mma)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for c in configs:
        torch.testing.assert_close(run(c), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("op,k,n", TUNE_SHAPES)
def test_cuda_launch_config_batch_invariance(cuda, rng, op, k, n):
    """Under one config a row's result does not depend on its batch: the
    rows of a 1-row call bitwise those of a 4-row call (decode class), of a
    5-row call those of a 256-row call (prefill class)."""
    from repro_torch.kernels import build
    packed = _packed(rng, k, n, cuda)
    r = packed.shape[0]
    x = torch.from_numpy(rng.standard_normal((256, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    for big, small in ((4, 1), (256, 5)):
        run_big, _ = _config_call(op, x[:big], packed)
        run_small, _ = _config_call(op, x[:small], packed)
        for c in build.launch_configs(big, r, n, _mma(op, torch.bfloat16, k, n)):
            assert torch.equal(run_small(c), run_big(c)[:small]), c


def test_cuda_launch_config_refused(cuda, rng):
    """An infeasible config raises ValueError, never replaced: subs 1 at K
    = 5460 (35 windows, more than a cluster of 16), parts 9, a prefill knob
    at decode, parts on the FMA route of float32 rows."""
    from repro_torch.kernels import build
    packed = _packed(rng, 5460, 2048, cuda)
    scale = torch.tensor(SCALE, device=cuda)
    for m, dtype, c in ((4, torch.bfloat16, build.LaunchConfig(subs=1)),
                        (256, torch.bfloat16, build.LaunchConfig(parts=9)),
                        (4, torch.bfloat16, build.LaunchConfig(parts=2)),
                        (256, torch.float32, build.LaunchConfig(parts=2))):
        x = torch.ones((m, 5460), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="launch config"):
            ops.ternary_gemm(x, packed, scale, config=c)


def test_cuda_tuned_miss_takes_the_kernel(cuda, rng, tmp_path, monkeypatch):
    """Under kernel_mode "tuned", a GEMM or attention shape that no warmup
    tuned dispatches to the hand-written kernel at its built-in config: its
    launch count goes up by one and the result is bitwise the call without
    a mode."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.ENV_VAR, str(tmp_path / "autotune.json"))
    packed = _packed(rng, 2048, 2048, cuda)
    scale = torch.tensor(SCALE, device=cuda)
    x = torch.from_numpy(rng.standard_normal((256, 2048)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    step = ops.das_topk(x, keep=16, with_mask=False)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, h, 64)).astype(np.float32)).to(
        cuda, torch.bfloat16) for n, h in ((1, 32), (700, 32), (700, 32)))
    q_pos = torch.tensor([[699]], dtype=torch.int32, device=cuda)
    k_pos = torch.arange(700, dtype=torch.int32, device=cuda)[None]
    kw = dict(sink=64, window=512)
    calls = {
        "ternary_gemm": (lambda: autotune.run_gemm(x, packed, scale),
                         lambda: ops.ternary_gemm(x, packed, scale)),
        "das_ternary_gemm": (
            lambda: autotune.run_das_gemm(step.values, step.indices, packed, scale, keep=16,
                                          block=32),
            lambda: ops.das_ternary_gemm(step.values, step.indices, packed, scale, keep=16)),
        "sparse_attention": (lambda: autotune.run_attention(q, k, v, q_pos, k_pos, **kw),
                             lambda: ops.sparse_attention(q, k, v, q_pos, k_pos, **kw)),
    }
    cache = autotune.AutotuneCache()
    for name, (tuned, auto) in calls.items():
        want = auto()
        with ops.kernel_mode("tuned", cache):
            before = ops.launches[name]
            got = tuned()
            assert ops.launches[name] == before + 1, name
        assert torch.equal(got, want), name
    assert cache.entries == {} and cache.timed_runs == 0


def test_cuda_tuned_engine_matches_default(cuda, tmp_path, monkeypatch):
    """A reduced bitnet-1.3b engine in float32 under kernel_mode="tuned"
    (every candidate timed on the card) gives the default engine's greedy
    tokens, and a second tuned engine on the same cache times nothing."""
    monkeypatch.setenv("TENET_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    cfg = reduced(get_config("bitnet-1.3b"))
    model = MD.init_serving(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, p) for p in (40, 17)]
    out = {}
    for mode in ("auto", "tuned", "tuned"):
        eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64, kernel_mode=mode),
                          device=cuda)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        res = eng.run()
        out.setdefault(mode, []).append(([res[u].tokens.tolist() for u in sorted(res)],
                                         eng.stats.autotune_timed_runs))
    assert out["tuned"][0][0] == out["auto"][0][0] == out["tuned"][1][0]
    assert out["tuned"][0][1] > 0 and out["tuned"][1][1] == 0
