"""The gemma3-1b engine of the port against the JAX package's ServeEngine:
the 5 local : 1 global pattern with a 2-layer tail, reduced with its real
head size and GQA ratio (tests/test_torch_zoo.py::zoo_cfg); and the
serving CLI on every dense arch of the zoo."""
import numpy as np
import pytest

from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.launch import serve as cli
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_engine import _trace
from test_torch_zoo import zoo_pair


def test_gemma3_engine_tokens_match_jax():
    """gemma3-1b reduced to 8 layers (one 5 local : 1 global period and a
    2-layer tail, scan-stacked on the JAX side) through both engines on the
    staggered 3-request trace: equal tokens and virtual times.  The 40-token
    prompt wraps the 32-slot local ring."""
    jcfg, sparams, model = zoo_pair("gemma3-1b", n_layers=8, scan_layers=True)
    assert sparams["layers"]["stacked"] is not None and len(sparams["layers"]["tail"]) == 2
    assert [bp.kind for bp in model.layers] == ["local"] * 5 + ["attn"] + ["local"] * 2
    jeng = JServeEngine(jcfg, sparams, Runtime(),
                        config=JServeConfig(max_slots=2, max_len=64, kernel_mode="ref"))
    for r in _trace(jcfg, JRequest):
        jeng.submit(r)
    want = jeng.run()
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64), device="cpu")
    for r in _trace(jcfg, Request):
        eng.submit(r)
    got = eng.run()
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime


@pytest.mark.parametrize("arch", ["gemma2-2b", "bitnet-3b", "gemma3-1b", "minicpm-2b",
                                  "stablelm-1.6b"])
def test_cli_serves_zoo_reduced_on_cpu(capsys, arch):
    """The CLI takes every dense arch of the zoo (reduced, on the CPU)."""
    res = cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                    "--prompt-len", "20", "--gen", "3", "--slots", "2", "--stagger", "1"])
    assert sorted(res) == [0, 1] and all(len(r.tokens) == 3 for r in res.values())
    assert f"{arch}-smoke" in capsys.readouterr().out
