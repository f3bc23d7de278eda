"""The port's STL core oracle (core/stl.py) against the JAX package's: the
9-entry (GIdx, DIdx, SIdx) encoding, the precompute table, the STL matmul
(exactly x @ w on integer-valued inputs) and the Table I complexity model.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stl as jstl
from repro_torch.core import stl

torch.set_num_threads(1)

PAIRS = np.array(list(itertools.product((-1, 0, 1), repeat=2)), dtype=np.int8)   # (9, 2)


def test_encode_every_pair_matches():
    """All 9 weight pairs, as one (2, 9) weight whose column j is pair j."""
    w = PAIRS.T.copy()
    got = stl.stl_encode(torch.from_numpy(w))
    want = jstl.stl_encode(jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.gidx.dtype == torch.bool and got.sidx.dtype == torch.bool
    # the table of the module docstring: the zero pair alone is gated
    assert got.gidx[0].tolist() == [p == (0, 0) for p in map(tuple, PAIRS.tolist())]


@pytest.mark.parametrize("m,k,n", [(1, 2, 9), (3, 130, 17)])
def test_stl_matmul_is_exact_on_integers(rng, m, k, n):
    x = rng.integers(-128, 128, size=(m, k)).astype(np.float32)
    w = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    got = stl.stl_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    want = jstl.stl_matmul_ref(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x @ w.astype(np.float32))
    enc = stl.stl_encode(torch.from_numpy(w))
    np.testing.assert_array_equal(stl.stl_decode_dot(torch.from_numpy(x), enc).numpy(),
                                  got.numpy())


def test_precompute_table_matches(rng):
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(stl._precompute_table(torch.from_numpy(x)).numpy(),
                                  np.asarray(jstl._precompute_table(jnp.asarray(x))))


def test_odd_k_raises():
    with pytest.raises(ValueError, match="multiple of the STL group size"):
        stl.stl_encode(torch.zeros((3, 4), dtype=torch.int8))


@pytest.mark.parametrize("core", ["add_only", "general_lut", "ternary_lut", "stl"])
def test_core_complexity_matches(core):
    for n_t, g_total, s_a in ((64, 16, 1.0), (128, 512, 0.5), (32, 7, 0.25)):
        assert stl.core_complexity(core, n_t=n_t, g_total=g_total, s_a=s_a) == \
            jstl.core_complexity(core, n_t=n_t, g_total=g_total, s_a=s_a)
    with pytest.raises(ValueError):
        stl.core_complexity("nope", n_t=1, g_total=1)
