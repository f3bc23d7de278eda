"""The port's training pass of the hybrid zamba2-2.7b against the JAX
package.

``mamba2.mamba_train`` runs the prefill's conv, chunk grid and gated norm
(one copy of the math, ``mamba2._ssd``) under autograd, its projections on
master weights through the STE fake-quants; zamba2's one shared attention
runs at every attention position, and autograd sums its gradient over them.

The mixer alone (d_model 64, d_inner 128, 8 heads of 16, state 16, chunk
16), DAS off, against the JAX package's ``mamba_train`` under ``jax.vjp``: output and
every gradient within 2e-5 of its max, at L = 40 (two chunks, then a chunk
of 8) and 12 (below one chunk).  Reduced zamba2 at 12 layers (5 mamba, the
shared attention, 5 mamba, the shared attention again): the loss within
1e-5 relative and every master leaf's gradient within 1e-4 of that leaf's
max against the jitted JAX step at the same two lengths, DAS and LPSA on;
the decisions at a tie taken from JAX
(``test_torch_train.Decisions``).  bfloat16 at 6 layers against eager
``repro`` within 2e-2, at 24 tokens (a chunk and a remainder; eager JAX
compiles every primitive, and runs the chunk scan op by op).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import mamba2 as JM
from repro_torch.bridge import to_torch
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as M
from repro_torch.tree import leaves, leaves_with_paths
from test_torch_hybrid import one_thread  # noqa: F401
from test_torch_train import bf16_matches_eager_jax, matches_jax

ARCH = "zamba2-2.7b"
N_LAYERS = 12        # two attention positions share the block


@pytest.mark.parametrize("l", [40, 12], ids=["chunks+rem", "below-chunk"])
def test_mamba_train_matches_jax(rng, l):
    cfgs = [dataclasses.replace(base.reduced(get(ARCH), n_layers=N_LAYERS),
                                ternary=dataclasses.replace(base.reduced(get(ARCH)).ternary,
                                                            das=None))
            for base, get in ((jbase, jget_config), (tbase, get_config))]
    jcfg, tcfg = cfgs
    jp = JM.mamba_init(jax.random.PRNGKey(1), jcfg)
    x = rng.standard_normal((2, l, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def fwd_bwd(p, x, g):
        y, vjp = jax.vjp(lambda p, x: JM.mamba_train(p, jcfg, x)[0], p, x)
        return y, vjp(g)

    jy, (jgp, jgx) = jax.jit(fwd_bwd)(jp, jnp.asarray(x), jnp.asarray(g))
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)).requires_grad_(), jp)
    tx = torch.from_numpy(x).requires_grad_()
    ty = M.mamba_train(tp, tcfg, tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=2e-5 * np.abs(np.asarray(jy)).max())
    got = torch.autograd.grad(ty, leaves(tp) + [tx], torch.from_numpy(g))
    paths = [p for p, _ in leaves_with_paths(tp)] + ["x"]
    for path, a, w in zip(paths, got, jax.tree.leaves(jgp) + [jgx]):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 2e-5 * np.abs(w).max(), path


@pytest.mark.parametrize("seq", [40, 12], ids=["chunks+rem", "below-chunk"])
def test_zamba2_loss_and_grads_match_jax(monkeypatch, seq):
    matches_jax(ARCH, monkeypatch, seq=seq, n_layers=N_LAYERS)


def test_bf16_zamba2_matches_eager_jax():
    bf16_matches_eager_jax(ARCH, seq=24, n_layers=6)
