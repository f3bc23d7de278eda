"""The port's hybrid zamba2-2.7b against the JAX package.

The pieces: ``layers.xla_cumsum`` bitwise against ``jnp.cumsum`` (XLA's
blocked scan of base 16) and ``layers.softplus`` against
``jax.nn.softplus``.  The Mamba2 mixer (``models/mamba2.py``) at reduced
size (d_model 64, d_inner 128, 8 heads of 16, state 16, chunk 16) on the
JAX package's serving weights: the prefill at L = 10 (no full chunk), 32
(whole chunks) and 37 (two chunks, then a chunk of 5), then 16 decode steps
that cross a fold, outputs and states within 2e-5 of ``mamba_train`` /
``mamba_decode``; the prefill's state handed to decode below, at and past a
chunk boundary continues the full sequence's outputs.  The model: reduced
zamba2 at 12 layers (5 mamba, the shared attention, 5 mamba, the shared
attention again) through the bridge, every leaf loaded and the shared block
held once; prefill + 16 decode steps teacher-forced on the JAX greedy
tokens within 2e-4 with equal greedy tokens, LPSA on (a 32-token prompt)
and off (37), base-3 packed and int8 trits (both against the JAX package's
packed model, run once a setting: its jitted compiles take most of the
file's time); the layer-by-layer export.
bfloat16: tests/test_torch_hybrid_bf16.py; the engine:
tests/test_torch_hybrid_engine.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import model as JMD
from repro.models.transformer import Runtime
from repro_torch.bridge import load_serving_tree
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import model as MD
from test_torch_model import _trits

ARCH = "zamba2-2.7b"
N_LAYERS = 12        # two attention positions share the block
MAX_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's intra-op threads at 1 for the module: the reduced model's
    ops are tiny, and with test workers sharing the cores more threads only
    contend (a 12-layer decode step takes ~1 s with 8 threads under load,
    ~50 ms with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hybrid_pair(dtype=None, n_layers=N_LAYERS, scan=False):
    """(jax cfg, jax serving params, port model on the CPU) of reduced
    zamba2 at ``n_layers`` on the same base-3 packed weights; ``scan``
    stacks the JAX side's layers into scanned groups (it compiles one
    group), which the bridge splits per layer."""
    jcfg, tcfg = (base.reduced(get(ARCH), n_layers=n_layers)
                  for base, get in ((jbase, jget_config), (tbase, get_config)))
    if dtype is not None:
        jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    jcfg = dataclasses.replace(jcfg, scan_layers=scan)
    sparams = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, sparams, load_serving_tree(jax.tree.map(np.asarray, sparams), tcfg, "cpu")


@pytest.fixture(scope="module")
def pairs():
    """hybrid_pair per serve format, on one draw of master weights."""
    jcfg = jbase.reduced(jget_config(ARCH), n_layers=N_LAYERS)
    params = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    cache = {}

    def get(fmt="packed"):
        if fmt not in cache:
            jc, tc = _trits(jcfg, fmt), _trits(tbase.reduced(get_config(ARCH),
                                                             n_layers=N_LAYERS), fmt)
            sparams = JMD.export_serving(params, jc)
            cache[fmt] = jc, sparams, load_serving_tree(jax.tree.map(np.asarray, sparams),
                                                        tc, "cpu")
        return cache[fmt]
    return get


@pytest.fixture(scope="module")
def reference(pairs):
    """The JAX package's packed model, jitted, over the prompt of each LPSA
    setting (32 tokens on, 37 off) and 16 greedy decode steps: (prompt,
    [logits], caches after the last step).  Both serve formats of the port
    are held against it: the int8 trits and the packed weights are the same
    ternary values, and the JAX package applies both in float32."""
    jcfg, sparams, _ = pairs()
    cache = {}

    def get(serve_sparse):
        if serve_sparse not in cache:
            rt = Runtime(kernel_mode="ref", serve_sparse=serve_sparse)
            n = 32 if serve_sparse else 37
            prompt = np.random.default_rng(n).integers(0, jcfg.vocab, n).astype(np.int32)
            jlg, jc = jax.jit(lambda sp, x: JMD.prefill(sp, jcfg, x, rt, max_len=MAX_LEN))(
                sparams, jnp.asarray(prompt)[None])
            jdecode = jax.jit(lambda sp, c, tok, t: JMD.decode_step(sp, jcfg, c, tok, t, rt))
            logits = [np.asarray(jlg)]
            for i in range(16):
                tok = jnp.asarray([int(np.argmax(logits[-1][0]))], jnp.int32)
                jlg, jc = jdecode(sparams, jc, tok, jnp.asarray([n + i], jnp.int32))
                logits.append(np.asarray(jlg))
            cache[serve_sparse] = prompt, logits, jc
        return cache[serve_sparse]
    return get


@pytest.mark.parametrize("n", [10, 17, 76, 256, 300])
def test_xla_cumsum_bitwise(n):
    """XLA's cumsum order, bitwise, along a middle and the last axis; and
    torch.cumsum, which the port does not use for it, is not (from 17 on)."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((3, n, 5)).astype(np.float32)
    for x, axis in ((a, 1), (a.transpose(0, 2, 1).copy(), 2)):
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=axis))
        np.testing.assert_array_equal(L.xla_cumsum(torch.from_numpy(x), axis).numpy(), want)
    if n > 16:
        assert (torch.cumsum(torch.from_numpy(a), 1).numpy()
                != np.asarray(jnp.cumsum(jnp.asarray(a), axis=1))).any()


def test_softplus_matches_jax():
    """jax.nn.softplus's formula, logaddexp(x, 0), within 3 ulps in float32
    (XLA's CPU exp and log1p are its own approximations)."""
    x = np.concatenate([np.random.default_rng(0).standard_normal(100_000) * 8,
                        [-100.0, -20.0, 0.0, 20.0, 100.0]]).astype(np.float32)
    got = L.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    flushed = np.where(np.abs(got) < np.finfo(np.float32).tiny, np.float32(0), got)
    np.testing.assert_array_max_ulp(flushed, want, maxulp=3)


@pytest.fixture(scope="module")
def mixer(pairs):
    """Layer 0 of the reduced model on the JAX package's serving weights:
    (jax cfg, jax mamba params, jax norm1, the jitted JAX decode step, port
    cfg, port mixer, port norm1 scale)."""
    jcfg, sparams, model = pairs()
    jp = sparams["layers"]["tail"][0]
    jstep = jax.jit(lambda xs, st, t: JM.mamba_decode(jp["mamba"], jcfg, xs, st, t))
    return jcfg, jp["mamba"], jp["norm1"], jstep, model.cfg, model.layers[0].mamba, \
        model.layers[0].norm1.scale


def _states_close(jst, tst, msg):
    assert sorted(jst) == sorted(tst)
    for key in tst:
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key], np.float32),
                                   rtol=2e-5, atol=2e-5, err_msg=f"{msg}: {key}")


@pytest.mark.parametrize("l", [10, 32, 37])
def test_mamba_prefill_then_decode_matches_jax(mixer, l):
    """The prefill on the JAX chunk grid (one grid of 10; two chunks of 16;
    two chunks, then one of 5), its outputs and state within 2e-5; then 16
    decode steps at batch 2, row 1 six positions behind row 0 (each row
    folds at its own step), each step's outputs and state within 2e-5."""
    jcfg, jp, jn, jstep, tcfg, mod, norm = mixer
    rng = np.random.default_rng(l)
    x = (rng.standard_normal((2, l + 16, jcfg.d_model)) * 0.5).astype(np.float32)
    xn = JL.rmsnorm(jn, jnp.asarray(x))
    y_j, st_j = jax.jit(lambda xs: JM.mamba_train(jp, jcfg, xs, return_state=True))(xn[:, :l])
    y_t, st_t = M.mamba_prefill(mod, tcfg, torch.from_numpy(x[:, :l]), norm)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5, atol=2e-5)
    _states_close(st_j, st_t, "prefill")
    for i in range(16):
        t = np.array([l + i, l + i - 6], np.int32)
        y_j, st_j = jstep(xn[:, l + i:l + i + 1], st_j, jnp.asarray(t))
        y_t = M.mamba_decode(mod, tcfg, torch.from_numpy(x[:, l + i:l + i + 1]), norm, st_t,
                             M.ssd_step_inputs(tcfg, torch.from_numpy(t)))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5, atol=2e-5,
                                   err_msg=f"step {i}")
        _states_close(st_j, st_t, f"step {i}")


def test_mamba_prefill_state_handoff(mixer):
    """tests/test_linear_attn.py::test_mamba_prefill_state_handoff in the
    port: a prefill below, at and past a chunk boundary hands decode the
    boundary carry and the buffered remainder, and decode continues the
    full sequence's outputs (within 2e-4, as the JAX package holds its
    own)."""
    *_, tcfg, mod, norm = mixer
    c = tcfg.ssm.chunk
    x = torch.from_numpy((np.random.default_rng(1).standard_normal((2, 2 * c, tcfg.d_model))
                          * 0.5).astype(np.float32))
    y_seq, _ = M.mamba_prefill(mod, tcfg, x, norm)
    for pre in (c // 2, c, c + c // 2):
        y_pre, st = M.mamba_prefill(mod, tcfg, x[:, :pre], norm)
        ys = [y_pre]
        for t in range(pre, 2 * c):
            ys.append(M.mamba_decode(mod, tcfg, x[:, t:t + 1], norm, st,
                                     M.ssd_step_inputs(tcfg, torch.tensor([t, t]))))
        np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_seq.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"pre={pre}")


def test_bridge_loads_every_leaf_and_one_shared_block(pairs):
    """Every leaf of the JAX package's serving tree has its buffer and the
    reverse; the shared attention is one set of buffers (``shared.*``, none
    under the blocks), the attention blocks keep their own norms and FFN,
    and a mamba block has no norm2 and no FFN."""
    jcfg, sparams, model = pairs()
    sd = model.state_dict()
    assert len(sd) == len(jax.tree.leaves(sparams))
    assert [bp.kind for bp in model.layers] == list(jcfg.layer_kinds())
    shared = sorted(k for k in sd if k.startswith("shared."))
    assert shared == sorted(f"shared.w{n}.{leaf}" for n in "qkvo" for leaf in ("packed", "scale"))
    assert not any(".attn." in k for k in sd)
    attn = [i for i, k in enumerate(jcfg.layer_kinds()) if k == "attn"]
    assert attn == [5, 11]
    for i in attn:
        assert {n for n, _ in model.layers[i].named_children()} == {"norm1", "norm2", "ffn"}
    assert {n for n, _ in model.layers[0].named_children()} == {"norm1", "mamba"}
    jsh = sparams["layers"]["shared"]
    np.testing.assert_array_equal(model.shared.wq.packed.numpy(), np.asarray(jsh["wq"]["packed"]))
    jm = sparams["layers"]["tail"][1]["mamba"]
    for leaf in ("wb", "wdt", "a_log", "conv"):
        np.testing.assert_array_equal(getattr(model.layers[1].mamba, leaf).numpy(),
                                      np.asarray(jm[leaf]))


@pytest.mark.parametrize("fmt", ["packed", "int8"])
@pytest.mark.parametrize("serve_sparse", [True, False])
def test_hybrid_prefill_and_decode_match_jax(pairs, reference, serve_sparse, fmt):
    """LPSA on: the 32-token prompt streams through the ring in 2 packs and
    the mamba layers prefill 2 whole chunks; LPSA off: 37 tokens, full
    caches, the mamba grid split 2 chunks + 5.  16 decode steps
    teacher-forced on the JAX greedy tokens cross a fold (t = 47).  Logits
    within 2e-4, equal greedy tokens, every state and cache leaf within
    2e-4 (relative for the attention caches' large keys)."""
    _, _, model = pairs(fmt)
    prompt, want, jc = reference(serve_sparse)
    n = len(prompt)
    tlg, tc = MD.prefill(model, torch.as_tensor(prompt, dtype=torch.long)[None],
                         max_len=MAX_LEN, serve_sparse=serve_sparse)
    got = [tlg.numpy()]
    for i in range(16):
        tok = int(np.argmax(want[i][0]))
        tlg, tc = MD.decode_step(model, tc, torch.tensor([tok]), torch.tensor([n + i]),
                                 serve_sparse=serve_sparse)
        got.append(tlg.numpy())
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=f"logits of step {step}")
        assert int(np.argmax(g)) == int(np.argmax(w)), f"greedy token {step}"
    for i, (jl, tl) in enumerate(zip(jc["tail"], tc)):
        assert sorted(jl) == sorted(tl), i
        for key in tl:
            np.testing.assert_allclose(tl[key].float().numpy(), np.asarray(jl[key], np.float32),
                                       rtol=2e-4, atol=2e-4, err_msg=f"layer {i} {key}")


def test_init_serving_equals_export():
    """The layer-by-layer export, the shared block drawn once after the
    blocks, is bitwise export_serving(init_params); the shared block is one
    set of buffers that every attention position runs."""
    cfg = tbase.reduced(get_config(ARCH), n_layers=N_LAYERS)
    a = MD.init_serving(cfg, seed=4, device="cpu").state_dict()
    b = MD.export_serving(MD.init_params(cfg, seed=4, device="cpu"), cfg).state_dict()
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert sum(k.startswith("shared.") for k in a) == 8
