"""Reduced zamba2 in bfloat16 against the JAX package run op by op.

Reduced zamba2-2.7b at its default 6 layers (5 mamba, then the shared
attention), base-3 packed, DAS on, bfloat16, LPSA off: a 10-token prefill
(one grid of 10 on the mamba layers) + 8 decode steps teacher-forced on the
JAX greedy tokens, which cross a fold at t = 15, against the JAX package
under jax.disable_jit() (jitted, XLA skips bfloat16 roundings inside its
fusions).  It rests on the port rounding where the reference rounds:
silu(z) and y * silu(z) step by step in bfloat16 (``layers.silu``), the
conv's output cast once, wb and wc in bfloat16, the SSD in float32 with
XLA's cumsum order and the decode conv's multiply-add a tap, the conv's
inputs held exactly in the float32 state.
"""
import numpy as np

from test_torch_hybrid import hybrid_pair, one_thread  # noqa: F401
from test_torch_model import _teacher_forced


def test_hybrid_bf16_matches_eager_jax():
    jcfg, sparams, model = hybrid_pair(dtype="bfloat16", n_layers=None)
    assert model.embed.dtype == model.layers[0].mamba.wb.dtype
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, 10).astype(np.int32)
    logits, (jc, tc) = _teacher_forced(jcfg, sparams, model, "ref", prompt, eager=True,
                                       serve_sparse=False)
    for step, (want, got) in enumerate(logits):
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=f"logits of step {step}")
    for i, (jl, tl) in enumerate(zip(jc["tail"], tc)):
        if "conv" in tl:    # the conv's inputs: bfloat16 values, held in float32
            np.testing.assert_array_equal(tl["conv"].numpy(),
                                          np.asarray(jl["conv"]).astype(np.float32))
