"""The dense zoo in bfloat16 and through the engine, against the JAX package.

gemma2-2b (gelu, the sqrt(d) embedding scale, both soft-caps, local and
global layers) and stablelm-1.6b (the untied head), reduced with their real
head sizes (tests/test_torch_zoo.py::zoo_cfg), DAS on, base-3 packed:
prefill + 8 teacher-forced decode steps bitwise equal to the JAX package run
op by op (the Model-parity rule of ROADMAP: jitted, XLA skips bfloat16
roundings in its fusions).  The engine: tests/test_torch_zoo_engine.py.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import model as MD
from test_torch_model import _teacher_forced
from test_torch_zoo import _prompt, zoo_pair


def _port_forced(model, prompt, tokens, serve_sparse, max_len):
    """The port's logits over prefill + one decode step per token of
    ``tokens`` (teacher-forced)."""
    lg, caches = MD.prefill(model, torch.as_tensor(prompt, dtype=torch.long)[None],
                            max_len=max_len, serve_sparse=serve_sparse)
    out = [lg.numpy()]
    for i, tok in enumerate(tokens):
        lg, caches = MD.decode_step(model, caches, torch.tensor([tok]),
                                    torch.tensor([len(prompt) + i]),
                                    serve_sparse=serve_sparse)
        out.append(lg.numpy())
    return out


@pytest.mark.parametrize("serve_sparse", [True, False], ids=["lpsa", "full"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "stablelm-1.6b"])
def test_zoo_bf16_matches_eager_jax(arch, serve_sparse):
    """Bitwise equal logits.  The last float32 step of gemma2-2b, the logit
    soft-cap's tanh, is libm's in the port and XLA's rational approximation
    in the reference (they differ by a few float32 ulps), so there the
    port's logits before the cap, put through the reference's own soft-cap,
    are held bitwise to the reference's; the port's capped logits are held
    within 1e-6 and to the same greedy tokens."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    jcfg, sparams, model = zoo_pair(arch, dtype="bfloat16")
    prompt = _prompt(jcfg)
    logits, _ = _teacher_forced(jcfg, sparams, model, "ref", prompt,
                                serve_sparse=serve_sparse, eager=True)
    want = [w.astype(np.float32) for w, _ in logits]
    if jcfg.logit_softcap is None:
        for step, (w, (_, got)) in enumerate(zip(want, logits)):
            np.testing.assert_array_equal(got, w, err_msg=f"logits of step {step}")
        return
    for step, (w, (_, got)) in enumerate(zip(want, logits)):
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(w)), f"greedy token {step}"
    uncapped = copy.copy(model)                    # the same buffers and blocks
    uncapped.cfg = dataclasses.replace(model.cfg, logit_softcap=None)
    tokens = [int(np.argmax(w[0])) for w in want[:-1]]
    pre = _port_forced(uncapped, prompt, tokens, serve_sparse, len(prompt) + len(tokens) + 1)
    vocab_pad = np.arange(jcfg.vocab_padded) >= jcfg.vocab
    for step, (w, p) in enumerate(zip(want, pre)):
        capped = np.array(JL.softcap(jnp.asarray(p), jcfg.logit_softcap))
        capped[:, vocab_pad] = p[:, vocab_pad]     # padding rows: -1e30, masked after the cap
        np.testing.assert_array_equal(capped, w, err_msg=f"pre-cap logits of step {step}")
