"""The port's int8 gradient exchange and ZeRO-1 collectives against the
JAX package's.

``int8_compress`` / ``int8_decompress`` are bitwise ``repro``'s (eager) on
the same arrays.  In one world of 4 gloo ranks on the CPU (spawned once
for the module):

  * ``compressed_psum`` over an axis of 4 (Topology(dp=4)'s "data") and of
    2 ("model" at dp 2 x tp 2): the sum within 1e-6 (of its max) of
    ``repro``'s quantize-then-``tensordot`` of the ranks' shards, the error
    feedback bitwise ``repro``'s ``target - int8_decompress(q, scale)``;
  * ``psum_scatter_mean`` and ``reduce_scatter`` against numpy, an int8
    ``all_gather``, a MAX ``pmax``;
  * ``compressed_crosspod_mean`` over Topology(pods=2, dp=1, tp=2) with the
    same gradients on both pods (``repro``'s check, tests/test_multidevice.py):
    within 2 % of them, the error-feedback residual nonzero; with different
    gradients a pod, within 2 % of the exact mean.

The ranks run this module's ``collectives_rank``; JAX and the JAX package
are imported only in the tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.plan import Topology

SHAPE = (6, 40)


def _shards(n, seed=0):
    """n float32 shards and n error trees, one a rank."""
    rng = np.random.default_rng(seed)
    x = [(rng.standard_normal(SHAPE) * (1 + r)).astype(np.float32) for r in range(n)]
    e = [(rng.standard_normal(SHAPE) * 1e-3).astype(np.float32) for r in range(n)]
    return x, e


def collectives_rank(rank: int) -> dict:
    from repro_torch.optim.grad import compressed_crosspod_mean, zeros_error
    out = {}
    t = torch.from_numpy
    for name, topo, axis in (("data4", Topology(dp=4), "data"),
                             ("model2", Topology(dp=2, tp=2), "model")):
        mesh = topo.build_mesh()
        i, n = mesh.index(axis), mesh.size(axis)
        x, e = _shards(n)
        out[name] = C.compressed_psum(t(x[i]), mesh, axis, t(e[i]))
    mesh = Topology(dp=4).build_mesh()
    rows = np.arange(8 * 5, dtype=np.float32).reshape(8, 5) * (rank + 1)
    out["scatter_mean"] = C.psum_scatter_mean(t(rows), mesh, "data")
    out["scatter"] = C.reduce_scatter(t(rows), mesh, "data")
    out["gather_int8"] = C.all_gather(torch.full((2, 3), rank - 2, dtype=torch.int8), mesh)
    out["pmax"] = C.pmax(t(np.float32([rank, -rank, 0.5])), mesh, "data")
    mesh = Topology(pods=2, dp=1, tp=2).build_mesh()
    rng = np.random.default_rng(5)
    same = {"w": t(rng.standard_normal((64, 64)).astype(np.float32)),
            "b": t(rng.standard_normal(64).astype(np.float32))}
    out["crosspod_same"] = compressed_crosspod_mean(same, zeros_error(same), mesh)
    own = {k: v * (1 + mesh.pod_index) for k, v in same.items()}
    out["crosspod_own"] = compressed_crosspod_mean(own, zeros_error(own), mesh)
    out["pod"] = mesh.pod_index
    return out


@pytest.fixture(scope="module")
def got():
    torch.set_num_threads(1)
    return run_ranks(collectives_rank, 4)


def test_int8_compress_is_bitwise_repro():
    import jax.numpy as jnp

    from repro.distributed import collectives as J
    for x in _shards(3, seed=1)[0] + [np.zeros(SHAPE, np.float32)]:
        jq, js = J.int8_compress(jnp.asarray(x))
        q, s = C.int8_compress(torch.from_numpy(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(C.int8_decompress(q, s).numpy(),
                                      np.asarray(J.int8_decompress(jq, js)))


@pytest.mark.parametrize("name,n,axis", [("data4", 4, "data"), ("model2", 2, "model")])
def test_compressed_psum_matches_repro(got, name, n, axis):
    """Each rank's sum within 1e-6 of repro's quantize-then-tensordot of
    the n shards; its error feedback bitwise repro's."""
    import jax.numpy as jnp

    from repro.distributed import collectives as J
    x, e = _shards(n)
    qs, ss, errs = [], [], []
    for xi, ei in zip(x, e):
        target = jnp.asarray(xi) + jnp.asarray(ei)
        q, s = J.int8_compress(target)
        qs.append(q)
        ss.append(s)
        errs.append(np.asarray(target - J.int8_decompress(q, s, target.dtype)))
    want = np.asarray(jnp.tensordot(jnp.stack(ss), jnp.stack(qs).astype(jnp.float32), axes=1))
    topo = Topology(dp=4) if n == 4 else Topology(dp=2, tp=2)
    for rank, res in enumerate(got):
        i = rank if axis == "data" else rank % topo.tp
        summed, err = res[name]
        assert np.abs(summed.numpy() - want).max() <= 1e-6 * np.abs(want).max()
        np.testing.assert_array_equal(err.numpy(), errs[i])


def test_scatter_gather_and_max_against_numpy(got):
    rows = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    total = rows * sum(r + 1 for r in range(4))
    for rank, res in enumerate(got):
        np.testing.assert_allclose(res["scatter"].numpy(), total[2 * rank:2 * rank + 2])
        np.testing.assert_allclose(res["scatter_mean"].numpy(),
                                   total[2 * rank:2 * rank + 2] / 4)
        want = np.repeat(np.arange(-2, 2, dtype=np.int8), 2)[:, None].repeat(3, 1)
        assert res["gather_int8"].dtype == torch.int8
        np.testing.assert_array_equal(res["gather_int8"].numpy(), want)
        np.testing.assert_array_equal(res["pmax"].numpy(), np.float32([3, 0, 0.5]))


def test_compressed_crosspod_mean(got):
    rng = np.random.default_rng(5)
    same = {"w": rng.standard_normal((64, 64)).astype(np.float32),
            "b": rng.standard_normal(64).astype(np.float32)}
    assert sorted(r["pod"] for r in got) == [0, 0, 1, 1]
    for res in got:
        mean, err = res["crosspod_same"]
        for k, g in same.items():
            assert np.abs(mean[k].numpy() - g).max() / np.abs(g).max() < 0.02
            assert np.abs(err[k].numpy()).max() > 0
        mean, _ = res["crosspod_own"]
        for k, g in same.items():       # pods hold g and 2 g: the exact mean 1.5 g
            assert np.abs(mean[k].numpy() - 1.5 * g).max() / np.abs(1.5 * g).max() < 0.02
