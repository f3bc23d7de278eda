"""The SSM pair in bfloat16 against the JAX package run op by op.

Reduced rwkv6-3b and gla-1.3b (tests/test_torch_ssm.py::ssm_pair), base-3
packed, DAS on, bfloat16: a 64-token prefill (two chunks of 32) + 8 decode
steps teacher-forced on the JAX greedy tokens, against the JAX package under
jax.disable_jit() (jitted, XLA skips bfloat16 roundings inside its fusions:
the Model-parity rule of ROADMAP).  It rests on the port rounding where the
reference rounds: the token-shift mixes, relu(k)^2, sigmoid(r) * kv and
silu(g) step by step in bfloat16 (models/layers.py ``sigmoid``, ``silu``),
the head norm cast back to bfloat16 once, the rmsnorm before gla's
q/k/v/g inside its DAS step.

gla-1.3b is bitwise.  rwkv6-3b is held within 1e-5 (read: 7.6e-6, one
logit one bfloat16 step apart, at decode step 1 of 9), with equal greedy
tokens: its decay LoRA and the linear attention take float32 tanh and exp,
which XLA's CPU backend computes with its own approximations (they differ
from torch's in ~10 % of float32 values by an ulp; 1225 of the 4096 decay
logs of layer 0's prefill differ, by up to 9e-8), so a state value can land
on the other side of a bfloat16 rounding.
"""
import numpy as np
import pytest

from test_torch_model import _teacher_forced
from test_torch_ssm import ssm_pair

TOL = {"gla-1.3b": 0.0, "rwkv6-3b": 1e-5}


@pytest.mark.parametrize("arch", sorted(TOL))
def test_ssm_bf16_matches_eager_jax(arch):
    jcfg, sparams, model = ssm_pair(arch, dtype="bfloat16")
    assert model.embed.dtype == model.layers[0].norm1.scale.dtype
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, 64).astype(np.int32)
    logits, (jc, tc) = _teacher_forced(jcfg, sparams, model, "ref", prompt, eager=True)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=0, atol=TOL[arch],
                                   err_msg=f"logits of step {step}")
        assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy token {step}"
    if arch == "rwkv6-3b":   # the token shifts: bfloat16 values, held in float32
        for jl, tl in zip(jc["tail"], tc):
            for key in ("shift_t", "shift_c"):
                np.testing.assert_array_equal(tl[key].numpy(),
                                              np.asarray(jl[key]).astype(np.float32))
