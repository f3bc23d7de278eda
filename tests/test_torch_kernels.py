"""The port's kernel entry points against the JAX package's kernels.

On the CPU every entry point takes its kernel's plain PyTorch version; these
tests hold those against the JAX Pallas kernels run in interpret mode (as
the JAX package's own tests run them) or against the JAX oracles
(tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on a card).  Tolerances as in tests/test_kernels.py: 1e-4 for
float32 GEMMs, 2e-2 for bfloat16, 3e-4 for attention, exact for masks and
int8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import das as jdas
from repro.core import twd as jtwd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import das
from repro_torch.kernels import ops

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
                               torch.from_numpy(packed), SCALE).numpy()
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
                               SCALE).numpy()
    xm = das.das_apply(x, das.das_mask(x, keep=16)).float().numpy()
    want = np.asarray(jref.ternary_gemm_packed_ref(jnp.asarray(xm), jnp.asarray(packed),
                                                   SCALE, k))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,keep,ties", [(64, 512, 16, False), (32, 2048, 24, False),
                                           (8, 256, 16, True), (4, 5460, 16, False)])
def test_das_topk_matches_jax_kernel(rng, m, k, keep, ties):
    x = (rng.integers(-3, 4, size=(m, k)) if ties
         else rng.standard_normal((m, k))).astype(np.float32)
    got = ops.das_topk(torch.from_numpy(x), keep=keep)
    if k % 32:   # the Pallas kernel tiles K by 512: the tail against das_mask
        want = np.asarray(jdas.das_mask(jnp.asarray(x), block_size=32, keep=keep))
    else:
        want = np.asarray(jops.topk_mask(jnp.asarray(x), keep=keep, mode="interpret"))
    np.testing.assert_array_equal(got.mask.numpy(), want)
    if k % 32:
        assert got.mask.numpy()[:, k - k % 32:].all()          # dense tail
        np.testing.assert_array_equal(got.dense.numpy(), x * got.mask.numpy())
        assert got.values is None
    else:
        ca = jdas.das_compact(jnp.asarray(x), block_size=32, keep=keep)
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(ca.values))
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ca.indices))


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
                         torch.zeros((16, 8), dtype=torch.uint8), SCALE)
    assert ops.launches == {name: 0 for name in ops.KERNELS}
