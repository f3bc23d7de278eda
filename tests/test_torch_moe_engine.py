"""The port's engine on a MoE model against the JAX package's ServeEngine,
and the MoE's config and CLI surface.

Reduced qwen3-moe (8 experts, top-2, DAS and LPSA on, base-3 packed) through
both engines on the staggered 3-request trace of tests/test_torch_engine.py:
equal tokens and virtual times; with ``moe_expert_capacity=1`` also the same
admission deferrals.  Then the validation errors and the CLI serving both
MoE archs reduced on the CPU.
"""
import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import model as JMD
from repro.models.transformer import Runtime
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import load_serving_tree
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.launch import serve as cli
from repro_torch.models import model as MD
from repro_torch.serve import Request, ServeConfig, ServeEngine
from test_torch_engine import _trace

ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jbase.reduced(jget_config(ARCH)), tbase.reduced(get_config(ARCH))
    sp = JMD.export_serving(JMD.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, sp, load_serving_tree(jax.tree.map(np.asarray, sp), tcfg, "cpu")


@pytest.mark.parametrize("cap", [0, 1], ids=["unbounded", "capacity1"])
def test_moe_engine_matches_jax(pair, cap):
    """Equal tokens, first-token and finish vtimes and deferrals: with an
    expert capacity of 1 the bound serializes the slots."""
    jcfg, sp, model = pair
    jeng = JServeEngine(jcfg, sp, Runtime(), config=JServeConfig(
        max_slots=2, max_len=64, kernel_mode="ref", moe_expert_capacity=cap))
    for r in _trace(jcfg, JRequest):
        jeng.submit(r)
    want = jeng.run()
    eng = ServeEngine(model, ServeConfig(max_slots=2, max_len=64, moe_expert_capacity=cap),
                      device="cpu")
    for r in _trace(jcfg, Request):
        eng.submit(r)
    got = eng.run()
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"request {uid}")
        assert got[uid].first_token_vtime == want[uid].first_token_vtime
        assert got[uid].finish_vtime == want[uid].finish_vtime
    assert eng.stats.moe_capacity_deferrals == jeng.stats.moe_capacity_deferrals
    assert (eng.stats.moe_capacity_deferrals > 0) == (cap == 1)


def test_moe_capacity_errors():
    with pytest.raises(ValueError, match="moe_expert_capacity must be >= 0"):
        ServeConfig(moe_expert_capacity=-1)
    cfg = tbase.reduced(get_config("bitnet-1.3b"))
    model = MD.init_serving(cfg, device="cpu")
    with pytest.raises(ValueError, match="has no MoE layers"):
        ServeEngine(model, ServeConfig(moe_expert_capacity=2), device="cpu")


@pytest.mark.parametrize("argv", [
    ["--arch", "bitnet-1.3b", "--moe-expert-capacity", "2"],
    ["--arch", ARCH, "--moe-expert-capacity", "-1"],
])
def test_cli_moe_capacity_errors(capsys, argv):
    """A bound on a dense arch, or a negative one, is an argparse error."""
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--reduced", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "has no MoE layers" in err or "must be >= 0" in err


@pytest.mark.parametrize("arch", [ARCH, "kimi-k2-1t-a32b"])
def test_cli_serves_moe_reduced_on_cpu(capsys, arch):
    """The CLI takes both MoE archs (reduced, on the CPU), with the bound."""
    res = cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "20", "--gen", "3", "--slots", "2", "--stagger", "0",
                    "--moe-expert-capacity", "1"])
    assert sorted(res) == [0, 1, 2] and all(len(r.tokens) == 3 for r in res.values())
    out = capsys.readouterr().out
    assert f"{arch}-smoke" in out and "admissions deferred by the expert-capacity bound" in out
