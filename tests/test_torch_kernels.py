"""The port's kernel entry points against the JAX package's kernels.

On the CPU every entry point takes its kernel's plain PyTorch version; these
tests hold those against the JAX Pallas kernels run in interpret mode (as
the JAX package's own tests run them) or against the JAX oracles
(tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on a card).  Tolerances as in tests/test_kernels.py: 1e-4 for
float32 GEMMs, 2e-2 for bfloat16, 3e-4 for attention, exact for masks and
int8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import das as jdas
from repro.core import twd as jtwd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import ternary_linear as jtlin
from repro_torch.configs import base as tbase
from repro_torch.core import das, lpsa
from repro_torch.kernels import ops
from repro_torch.models.ternary_linear import TernaryLinear

SCALE = 0.37


def _packed(rng, k, n, row_align=1):
    trits = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    return trits, np.array(jtwd.pack_ternary(trits, row_align=row_align))


@pytest.mark.parametrize("m,k,n,dtype", [(8, 320, 128, "float32"),
                                         (16, 640, 256, "bfloat16"),
                                         (1, 320, 256, "float32")])
def test_ternary_gemm_matches_jax_kernel(rng, m, k, n, dtype):
    _, packed = _packed(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = np.asarray(jops.ternary_gemm(jx, jnp.asarray(packed), SCALE, mode="interpret"))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.ternary_gemm(tx, torch.from_numpy(packed), SCALE).numpy()
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_ternary_gemm_int8_exact(rng):
    m, k, n = 8, 640, 256
    _, packed = _packed(rng, k, n)
    xi = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    xs = (rng.random((m, 1)) + 0.5).astype(np.float32)
    want = np.asarray(jops.ternary_gemm(jnp.asarray(xi), jnp.asarray(packed), SCALE,
                                        jnp.asarray(xs), mode="interpret"))
    got = ops.ternary_gemm(torch.from_numpy(xi), torch.from_numpy(packed), SCALE,
                           torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,rows", [(2048, 416), (5460, 1104)])
def test_ternary_gemm_padded_rows(rng, k, rows):
    """The export's padded rows (5R > K): the same function as the oracle."""
    _, packed = _packed(rng, k, 64, row_align=16)
    assert packed.shape[0] == rows
    x = rng.standard_normal((4, k)).astype(np.float32)
    want = np.asarray(jref.ternary_gemm_packed_ref(jnp.asarray(x), jnp.asarray(packed),
                                                   SCALE, k))
    got = ops.ternary_gemm(torch.from_numpy(x), torch.from_numpy(packed), SCALE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n,keep", [(1, 320, 128, 16), (4, 640, 256, 8),
                                        (3, 320, 384, 32), (7, 320, 130, 1)])
def test_das_ternary_gemm_matches_jax_kernel(rng, m, k, n, keep):
    _, packed = _packed(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ca = jdas.das_compact(jnp.asarray(x), block_size=32, keep=keep)
    want = np.asarray(jops.das_ternary_gemm(ca.values, ca.indices, jnp.asarray(packed),
                                            SCALE, keep=keep, mode="interpret"))
    got = ops.das_ternary_gemm(torch.from_numpy(np.array(ca.values)),
                               torch.from_numpy(np.array(ca.indices)),
                               torch.from_numpy(packed), SCALE, keep=keep).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,rows,dtype", [(2048, 416, torch.float32),
                                          (2048, 416, torch.bfloat16)])
def test_das_ternary_gemm_padded_rows(rng, k, rows, dtype):
    """Padded export rows: the port alone, against the JAX oracle applied to
    the densified (DAS-masked) input."""
    _, packed = _packed(rng, k, 96, row_align=16)
    assert packed.shape[0] == rows
    x = torch.from_numpy(rng.standard_normal((4, k)).astype(np.float32)).to(dtype)
    ca = das.das_compact(x, keep=16)
    got = ops.das_ternary_gemm(ca.values, ca.indices, torch.from_numpy(packed),
                               SCALE, keep=16).numpy()
    xm = das.das_apply(x, das.das_mask(x, keep=16)).float().numpy()
    want = np.asarray(jref.ternary_gemm_packed_ref(jnp.asarray(xm), jnp.asarray(packed),
                                                   SCALE, k))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kc,keep,block,rows", [
    (150, 16, 32, 64),    # Kc is not whole blocks of keep
    (176, 16, 32, 16),    # K = 352 lanes > the 80 that 16 packed rows hold
    (64, 16, 64, 64),     # a 64-lane block does not divide a 160-lane window
    (64, 33, 32, 64)])    # keep > block
def test_das_ternary_gemm_refuses_mismatched_compaction(kc, keep, block, rows):
    """Kc must be K / block * keep, as das_compact makes it: the entry
    positions of a K window follow from it.  The check holds on the CPU as
    on the card."""
    vals = torch.zeros((2, kc))
    idx = torch.zeros((2, kc), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.das_ternary_gemm(vals, idx, torch.zeros((rows, 8), dtype=torch.uint8),
                             SCALE, keep=keep, block=block)


F32_STEPS = 3 * 2.0 ** -23

# (M, K, keep, tie-heavy rows, dtype, norm): the plain DAS step, then the
# step with the rmsnorm before it (ops.das_topk norm_scale) in float32 and
# bfloat16, tie-heavy rows (a constant scale keeps their ties), a partial last
# block (340 = 10 * 32 + 20)
DAS_TOPK_CASES = [(64, 512, 16, False, "float32", False),
                  (32, 2048, 24, False, "float32", False),
                  (8, 256, 16, True, "float32", False),
                  (4, 5460, 16, False, "float32", False),
                  (16, 1024, 16, False, "float32", True),
                  (8, 256, 16, True, "float32", True),
                  (16, 2048, 16, False, "bfloat16", True),
                  (8, 256, 16, True, "bfloat16", True),
                  (4, 340, 16, False, "bfloat16", True)]


def _topk_id(case):
    m, k, keep, ties, dtype, norm = case
    return f"{m}-{k}-{keep}-{ties}" + (f"-{dtype}-norm" if norm else "")


@pytest.mark.parametrize("m,k,keep,ties,dtype,norm", DAS_TOPK_CASES,
                         ids=[_topk_id(c) for c in DAS_TOPK_CASES])
def test_das_topk_matches_jax_kernel(rng, m, k, keep, ties, dtype, norm):
    """The DAS step against the Pallas kernel (interpret mode) and das_compact;
    with a norm scale, of the JAX package's rmsnorm (models/layers.py), its
    normed rows bitwise in bfloat16 and within 3 float32 steps (2^-23
    relative each) in float32: the two frameworks sum the squares in
    different orders, which moves the rsqrt by a step, and two roundings
    follow."""
    x = (rng.integers(-3, 4, size=(m, k)) if ties
         else rng.standard_normal((m, k))).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    if norm:
        s = (np.full(k, 0.25) if ties else rng.standard_normal(k) * 0.5).astype(np.float32)
        jx = jlayers.rmsnorm({"scale": jnp.asarray(s, dtype)}, jx)
        got = ops.das_topk(tx, keep=keep, norm_scale=torch.from_numpy(s).to(tx.dtype),
                           with_normed=True)
        want_y = np.asarray(jx.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.normed.float().numpy(), want_y)
        else:
            np.testing.assert_allclose(got.normed.numpy(), want_y, rtol=F32_STEPS, atol=0)
    else:
        got = ops.das_topk(tx, keep=keep)
        assert got.normed is None
    y = np.asarray(jx.astype(jnp.float32))
    if k % 32:   # the Pallas kernel tiles K by 512: the tail against das_mask
        want = np.asarray(jdas.das_mask(jx, block_size=32, keep=keep))
    else:
        want = np.asarray(jops.topk_mask(jx, keep=keep, mode="interpret"))
    np.testing.assert_array_equal(got.mask.numpy(), want)
    tol = dict(rtol=F32_STEPS if norm and dtype == "float32" else 0, atol=0)
    if k % 32:
        assert got.mask.numpy()[:, k - k % 32:].all()          # dense tail
        np.testing.assert_allclose(got.dense.float().numpy(), y * got.mask.numpy(), **tol)
        assert got.values is None
    else:
        ca = jdas.das_compact(jx, block_size=32, keep=keep)
        np.testing.assert_allclose(got.values.float().numpy(),
                                   np.asarray(ca.values.astype(jnp.float32)), **tol)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ca.indices))
    assert ops.das_topk(tx, keep=keep, with_mask=False).mask is None


@pytest.mark.parametrize("hq,hkv,lq,lk,cap", [(4, 2, 64, 64, None), (4, 4, 32, 64, 30.0),
                                              (8, 1, 1, 96, None)])
def test_sparse_attention_matches_jax_kernel(rng, hq, hkv, lq, lk, cap):
    b, d = 2, 16
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    qp = np.broadcast_to(np.arange(lq) + (lk - lq), (b, lq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(lk), (b, lk)).astype(np.int32).copy()
    kp[1, : lk // 2] = -1                 # empty slots in one batch row
    want = np.asarray(jops.sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp), jnp.asarray(kp),
        sink=8, window=24, softcap=cap, mode="interpret"))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.swapaxes(1, 2)))  # noqa: E731
    got = ops.sparse_attention(t(q), t(k), t(v), torch.from_numpy(qp),
                               torch.from_numpy(kp), sink=8, window=24, softcap=cap)
    np.testing.assert_allclose(got.numpy().swapaxes(1, 2), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("pack", [0, 1, 2])
def test_sparse_attention_streaming_packs_match_jax_kernel(rng, pack):
    """The streaming prefill's key layouts (core/lpsa.py::lpsa_prefill):
    sink 8, window 24, packs of 16, keys [sink | window | pack] with -1 for
    the slots the stream has not filled yet, at packs 0, 1 and 2 (the
    traffic the CUDA prefill class skips key tiles on)."""
    sink, window, chunk, b, hq, hkv, d = 8, 24, 16, 2, 4, 2, 16
    pos, k_pos = lpsa.pack_positions(pack * chunk, lpsa.LpsaSpec(sink, window, chunk))
    qp = np.broadcast_to(pos.numpy(), (b, chunk)).astype(np.int32)
    kp = np.broadcast_to(k_pos.numpy(), (b, k_pos.numel())).astype(np.int32)
    lk = kp.shape[1]
    q = rng.standard_normal((b, hq, chunk, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    want = np.asarray(jops.sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp), jnp.asarray(kp),
        sink=sink, window=window, mode="interpret"))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.swapaxes(1, 2)))  # noqa: E731
    got = ops.sparse_attention(t(q), t(k), t(v), torch.from_numpy(qp),
                               torch.from_numpy(kp), sink=sink, window=window)
    np.testing.assert_allclose(got.numpy().swapaxes(1, 2), want, rtol=3e-4, atol=3e-4)


def test_sparse_attention_empty_row_is_zero(rng):
    q = torch.from_numpy(rng.standard_normal((1, 2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    out = ops.sparse_attention(q, k, k, torch.tensor([[3, 4]], dtype=torch.int32),
                               torch.full((1, 8), -1, dtype=torch.int32), sink=4, window=4)
    assert not out.any()


def test_cpu_dispatch_launches_nothing(rng):
    ops.reset_launches()
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    ca = ops.das_topk(x, keep=16)
    ops.das_ternary_gemm(ca.values, ca.indices,
                         torch.zeros((16, 8), dtype=torch.uint8), SCALE, keep=16)
    trits = ops.twd_decode(torch.zeros((16, 8), dtype=torch.uint8), 64)
    ops.das_gemv(ca.values, ca.indices, trits, SCALE)
    ops.das_gemv(x, None, trits, SCALE)
    assert ops.launches == {name: 0 for name in ops.KERNELS}
    assert len(ops.KERNELS) == 6


# -- the int8-resident trits path: twd_decode and das_gemv ------------------

@pytest.mark.parametrize("k,n,row_align", [(320, 128, 1), (640, 256, 1), (1600, 512, 1),
                                           (300, 128, 16), (2048, 64, 16)])
def test_twd_decode_matches_jax_kernel(rng, k, n, row_align):
    """The JAX op slices the kernel's 5R rows to k; row_align=16 is the
    export's padded form (padding bytes decode to zero trits)."""
    trits, packed = _packed(rng, k, n, row_align)
    want = np.asarray(jops.twd_decode(jnp.asarray(packed), k, mode="interpret"))
    got = ops.twd_decode(torch.from_numpy(packed), k).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, trits)
    full = ops.twd_decode(torch.from_numpy(packed), 5 * packed.shape[0]).numpy()
    assert full.shape == (5 * packed.shape[0], n) and not full[k:].any()


def _compact_rows(rng, m, k, keep=16):
    x = rng.standard_normal((m, k)).astype(np.float32)
    ca = jdas.das_compact(jnp.asarray(x), block_size=32, keep=keep)
    return x, np.array(ca.values), np.array(ca.indices)


@pytest.mark.parametrize("k,n", [(512, 256), (1024, 512), (2048, 256)])
def test_das_gemv_matches_jax_kernel(rng, k, n):
    """One token, as the Pallas kernel takes it (tests/test_kernels.py)."""
    _, vals, idx = _compact_rows(rng, 1, k)
    w = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    want = np.asarray(jops.das_gemv(jnp.asarray(vals[0]), jnp.asarray(idx[0]),
                                    jnp.asarray(w), 0.5, keep=16, mode="interpret"))
    got = ops.das_gemv(torch.from_numpy(vals), torch.from_numpy(idx),
                       torch.from_numpy(w), 0.5).numpy()
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("keep", [8, 24])
def test_das_gemv_keep_matches_jax_kernel(rng, keep):
    """The compacted form with another keep, passed to both ops as the JAX
    op takes it."""
    k, n = 1024, 256
    _, vals, idx = _compact_rows(rng, 2, k, keep)
    w = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    got = ops.das_gemv(torch.from_numpy(vals), torch.from_numpy(idx),
                       torch.from_numpy(w), SCALE, keep=keep, block=32).numpy()
    for i in range(2):
        want = np.asarray(jops.das_gemv(jnp.asarray(vals[i]), jnp.asarray(idx[i]),
                                        jnp.asarray(w), SCALE, keep=keep, mode="interpret"))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kc,k,keep,block", [
    (500, 1024, 16, 32),   # Kc is not K / block * keep
    (512, 1024, 8, 32),    # keep 16's entries called keep 8
    (48, 100, 16, 32),     # K is not whole blocks
    (32, 128, 16, 64),     # a 64-lane block does not divide a 160-lane window
    (64, 64, 33, 32)])     # keep > block
def test_das_gemv_refuses_mismatched_compaction(kc, k, keep, block):
    """Compacted rows must be das_compact's: Kc == K / block * keep, as the
    JAX op checks (Kc * BLOCK == K * keep).  The check holds on the CPU as on
    the card."""
    with pytest.raises(ValueError):
        ops.das_gemv(torch.zeros((2, kc)), torch.zeros((2, kc), dtype=torch.int32),
                     torch.zeros((k, 8), dtype=torch.int8), SCALE, keep=keep, block=block)
    with pytest.raises(ValueError):
        jops.das_gemv(jnp.zeros((kc,)), jnp.zeros((kc,), jnp.int32),
                      jnp.zeros((k, 8), jnp.int8), SCALE, keep=keep, mode="interpret")


def test_das_gemv_rows_match_vmapped_jax_kernel(rng):
    """M = 4 rows against the JAX op vmapped over the rows, as its caller
    batches it."""
    k, n = 1024, 256
    _, vals, idx = _compact_rows(rng, 4, k)
    w = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    jw = jnp.asarray(w)
    want = np.asarray(jax.vmap(lambda v, i: jops.das_gemv(
        v, i, jw, SCALE, keep=16, mode="interpret"))(jnp.asarray(vals), jnp.asarray(idx)))
    got = ops.das_gemv(torch.from_numpy(vals), torch.from_numpy(idx),
                       torch.from_numpy(w), SCALE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _trits_linear(rng, k, n, das_on, fmt="int8"):
    """The same int8 trits + scale as a JAX serving leaf and a port
    TernaryLinear, with their TernaryConfigs."""
    w = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    jtc = jbase.TernaryConfig(das=jbase.DasConfig(32, 16) if das_on else None,
                              serve_format=fmt)
    ttc = tbase.TernaryConfig(das=tbase.DasConfig(32, 16) if das_on else None,
                              serve_format=fmt)
    lin = TernaryLinear(k, n, ttc, device="cpu")
    lin.trits.copy_(torch.from_numpy(w))
    lin.scale.fill_(SCALE)
    jp = {"trits": jnp.asarray(w), "scale": jnp.asarray(SCALE, jnp.float32)}
    return jp, jtc, lin


@pytest.mark.parametrize("k,das_on", [(84, True), (340, True), (340, False), (320, True)])
def test_das_gemv_tlin_matches_jax_trits_path(rng, k, das_on):
    """tlin_apply on trits against the JAX package's: compacted rows when 32
    divides K, dense DAS-masked rows with a 20-lane tail when it does not
    (84 = 2*32 + 20, 340 = 10*32 + 20), dense rows with DAS off."""
    jp, jtc, lin = _trits_linear(rng, k, 96, das_on)
    x = rng.standard_normal((4, k)).astype(np.float32)
    want = np.asarray(jtlin.tlin_apply(jp, jnp.asarray(x), jtc))
    got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_trits_bf16_scale_rounds_like_jax(rng, fmt):
    """bfloat16 activations: the JAX package applies the scale rounded to
    bfloat16.  Small integers keep every sum exact in both packages, so the
    outputs are equal bit for bit — and differ with the float32 scale
    (1 + 2**-8 + 2**-10 rounds to 1 + 2**-7)."""
    k, n = 320, 64
    jp, jtc, lin = _trits_linear(rng, k, n, True, fmt)
    s = 1 + 2 ** -8 + 2 ** -10
    jp["scale"] = jnp.asarray(s, jnp.float32)
    lin.scale.fill_(s)
    x = rng.integers(-3, 4, size=(4, k)).astype(np.float32)
    want = np.asarray(jtlin.tlin_apply(jp, jnp.asarray(x, jnp.bfloat16), jtc)
                      .astype(jnp.float32))
    got = lin(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)
    ca = ops.das_topk(torch.from_numpy(x).to(torch.bfloat16), keep=16)
    unrounded = ops.das_gemv(ca.values, ca.indices, lin.trits, s).to(torch.bfloat16)
    assert not np.array_equal(unrounded.float().numpy(), want)
