"""The port's core semantics against the JAX package's, on the same inputs.

TWD packing, ternary quantization, DAS masks and compaction, LPSA masks and
ring slots: numpy inputs from a seed go through both, and the outputs must
be equal (exactly, except the float32 quantization scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import das as jdas
from repro.core import lpsa as jlpsa
from repro.core import ternary as jternary
from repro.core import twd as jtwd
from repro_torch.core import das, lpsa, ternary, twd


@pytest.mark.parametrize("k,n,row_align", [(320, 7, 1), (2048, 3, 16), (5460, 2, 16),
                                           (13, 5, 16)])
def test_pack_unpack_match_jax(rng, k, n, row_align):
    trits = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    want = np.asarray(jtwd.pack_ternary(trits, row_align=row_align))
    got = twd.pack_ternary(torch.from_numpy(trits), row_align=row_align)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[0] == twd.packed_rows(k, row_align)
    for fn, jfn in ((twd.unpack_ternary, jtwd.unpack_ternary),
                    (twd.unpack_ternary_arith, jtwd.unpack_ternary_arith)):
        out = fn(got, k).numpy()
        np.testing.assert_array_equal(out, np.asarray(jfn(jnp.asarray(want), k)))
        np.testing.assert_array_equal(out, trits)
    # export padding decodes to zero trits
    full = twd.unpack_ternary_arith(got, got.shape[0] * 5).numpy()
    assert not full[k:].any()
    np.testing.assert_array_equal(twd.decode_lut().numpy(), np.asarray(jtwd.decode_lut()))


@pytest.mark.parametrize("shape", [(64, 48), (2048, 32)])
def test_ternary_quantize_matches_jax(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    jw = jternary.ternary_quantize(jnp.asarray(w))
    tw = ternary.ternary_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale), rtol=1e-6)


def _das_inputs(rng, m, k, ties):
    if ties:   # few distinct magnitudes: many ties per 32-lane block
        return rng.integers(-3, 4, size=(m, k)).astype(np.float32)
    return rng.standard_normal((m, k)).astype(np.float32)


@pytest.mark.parametrize("m,k,keep,ties", [(4, 128, 16, False), (6, 256, 8, True),
                                           (3, 84, 16, True), (2, 5460, 16, False),
                                           (5, 64, 32, True), (2, 96, 1, True)])
def test_das_mask_matches_jax(rng, m, k, keep, ties):
    x = _das_inputs(rng, m, k, ties)
    want = np.asarray(jdas.das_mask(jnp.asarray(x), block_size=32, keep=keep))
    got = das.das_mask(torch.from_numpy(x), block_size=32, keep=keep)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        das.das_apply(torch.from_numpy(x), got).numpy(),
        np.asarray(jdas.das_apply(jnp.asarray(x), jnp.asarray(want))))


@pytest.mark.parametrize("m,k,keep,ties", [(4, 128, 16, False), (6, 256, 8, True),
                                           (5, 64, 32, True), (2, 96, 1, True),
                                           (3, 2048, 16, True)])
def test_das_compact_matches_jax(rng, m, k, keep, ties):
    x = _das_inputs(rng, m, k, ties)
    want = jdas.das_compact(jnp.asarray(x), block_size=32, keep=keep)
    got = das.das_compact(torch.from_numpy(x), block_size=32, keep=keep)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    # the compaction holds exactly the mask's lanes
    mask = das.das_mask(torch.from_numpy(x), block_size=32, keep=keep)
    dense = np.zeros_like(x, dtype=bool)
    np.put_along_axis(dense, got.indices.numpy().astype(np.int64), True, axis=1)
    np.testing.assert_array_equal(dense, mask.numpy())


def test_das_compact_rejects_tail():
    with pytest.raises(ValueError):
        das.das_compact(torch.zeros(2, 84), block_size=32, keep=16)


@pytest.mark.parametrize("sink,window", [(8, 24), (128, 896), (0, 32)])
def test_lpsa_allowed_and_decode_slot_match_jax(sink, window):
    q = np.arange(-2, 1100, 7)[:, None]
    k = np.arange(-1, 1100, 5)[None, :]
    want = np.asarray(jlpsa.lpsa_allowed(jnp.asarray(q), jnp.asarray(k), sink, window))
    got = lpsa.lpsa_allowed(torch.from_numpy(q), torch.from_numpy(k), sink, window)
    np.testing.assert_array_equal(got.numpy(), want)
    pos = np.arange(0, 3000, 3)
    np.testing.assert_array_equal(
        lpsa.decode_slot(torch.from_numpy(pos), sink, window).numpy(),
        np.asarray(jlpsa.decode_slot(jnp.asarray(pos), sink, window)))
