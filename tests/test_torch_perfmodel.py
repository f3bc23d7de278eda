"""The port's analytic models against the JAX package's: the roofline
perfmodel (every paper ModelShape x HardwareSpec x TenetOpt toggle, and
``kernel_cost`` of the native impls against the matching ``xla_*`` ones),
IPJ, the DSE, and ``cell_analytic`` over every arch x shape of SHAPES.
Pure arithmetic on both sides: the numbers must be equal, not close.
"""
import dataclasses

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import dse as jdse
from repro.core import ipj as jipj
from repro.core import perfmodel as jpm
from repro.launch.analytic import cell_analytic as jcell
from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.configs.shapes import SHAPES, shape_by_name
from repro_torch.core import dse, ipj, perfmodel as pm
from repro_torch.kernels import build
from repro_torch.launch.analytic import cell_analytic

torch.set_num_threads(1)

SHAPE_NAMES = ("LLAMA_1B3", "LLAMA_3B", "LLAMA_7B")
HW_NAMES = ("TENET_ASIC", "TENET_FPGA", "A100_NAIVE", "A100_OPT", "CPU_I7", "TPU_V5E",
            "CPU_HOST")
OPTS = {"naive_int8": lambda m: m.TenetOpt.naive_int8(), "twd": lambda m: m.TenetOpt.twd(),
        "twd_das": lambda m: m.TenetOpt.twd_das(), "full": lambda m: m.TenetOpt.full(),
        "fp16_lpsa_512": lambda m: m.TenetOpt(weight_bits=16.0, lpsa=True, tl_sa=512),
        "das_quarter": lambda m: m.TenetOpt(weight_bits=1.6, das=True, s_a=0.25)}


def _fields(x):
    return dataclasses.asdict(x)


def test_profiles_are_the_jax_packages():
    for name in HW_NAMES:
        assert _fields(getattr(pm, name)) == _fields(getattr(jpm, name))
    for name in SHAPE_NAMES:
        assert _fields(getattr(pm, name)) == _fields(getattr(jpm, name))
        assert getattr(pm, name).linear_params() == getattr(jpm, name).linear_params()


def test_h100_profile():
    """The data sheet's H100 SXM5 80GB at 700 W, no utilisation factor."""
    h = pm.H100_SXM
    assert (h.peak_tops_high, h.peak_tops_low, h.hbm_gbps, h.power_w, h.onchip_mb) == \
        (989.0, 1979.0, 3350.0, 700.0, 50.0)
    assert (h.flop_util, h.bw_util) == (1.0, 1.0)


def test_backend_hw_reads_the_device(monkeypatch):
    assert pm.backend_hw("cpu") is pm.CPU_HOST
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert pm.backend_hw(torch.device("cuda")) is pm.H100_SXM
    assert pm.backend_hw("cuda:0") is pm.H100_SXM
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4")
    with pytest.raises(ValueError, match="H100"):
        pm.backend_hw("cuda")


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("hw", HW_NAMES + ("H100_SXM",))
def test_e2e_and_stage_costs_match(shape, hw):
    m, jm = getattr(pm, shape), getattr(jpm, shape)
    h = getattr(pm, hw)
    jh = jpm.HardwareSpec(**_fields(h))
    for opt_fn in OPTS.values():
        opt, jopt = opt_fn(pm), opt_fn(jpm)
        assert _fields(pm.e2e(m, h, opt, prefill_tl=1024, decode_tokens=128)) == \
            _fields(jpm.e2e(jm, jh, jopt, prefill_tl=1024, decode_tokens=128))
        for tl in (128, 2048):
            assert _fields(pm.linear_cost(m, tl, opt)) == _fields(jpm.linear_cost(jm, tl, jopt))
            for new, fused in ((1, False), (1, True), (tl, False), (tl, True)):
                assert _fields(pm.attention_cost(m, tl, new, opt, fused)) == \
                    _fields(jpm.attention_cost(jm, tl, new, jopt, fused))
            for stage in ("prefill", "decode"):
                assert _fields(pm.stage_cost(m, stage, tl, opt, decode_tokens=4)) == \
                    _fields(jpm.stage_cost(jm, stage, tl, jopt, decode_tokens=4))
        rep, jrep = (f(mm, hh, oo, prefill_tl=512, decode_tokens=64)
                     for f, mm, hh, oo in ((pm.e2e, m, h, opt), (jpm.e2e, jm, jh, jopt)))
        assert rep.ipj(11.27) == jrep.ipj(11.27)


# (op, m, k, n, keep, block): bitnet-1.3b's decode and prefill shapes, an odd K
KERNEL_SHAPES = [("das_ternary_gemm", 4, 2048, 2048, 16, 32),
                 ("das_ternary_gemm", 256, 2048, 5460, 16, 32),
                 ("ternary_gemm", 4, 5460, 2048, 0, 0), ("ternary_gemm", 256, 5460, 2048, 0, 0),
                 ("ternary_gemm", 5, 337, 96, 0, 0)]
NATIVE_TO_XLA = {"native_plain": "xla_plain", "native_f32dec": "xla_f32dec",
                 "native_dense_plain": "xla_dense_plain",
                 "native_dense_f32dec": "xla_dense_f32dec", "native_gather": "xla_gather"}


@pytest.mark.parametrize("hw", ("CPU_HOST", "A100_OPT", "TPU_V5E", "H100_SXM"))
def test_kernel_cost_of_the_native_impls_is_the_jax_packages(hw):
    """The port prices its native impls exactly as the JAX package prices
    the matching xla_* impls, on the same HardwareSpec (the H100's too)."""
    h = getattr(pm, hw)
    jh = jpm.HardwareSpec(**_fields(h))
    for op, m, k, n, keep, block in KERNEL_SHAPES:
        for impl, ximpl in NATIVE_TO_XLA.items():
            assert pm.kernel_cost(h, op, impl, m=m, k=k, n=n, keep=keep, block=block) == \
                jpm.kernel_cost(jh, op, ximpl, m=m, k=k, n=n, keep=keep, block=block)
    for lq, lk, chunk in ((1, 1024, 128), (1, 1024, 1024), (256, 1280, 256), (64, 64, 0)):
        dims = dict(hq=32, hkv=8, lq=lq, lk=lk, d=64)
        assert pm.kernel_cost(h, "sparse_attn", "native_flash", block_k=chunk, **dims) == \
            jpm.kernel_cost(jh, "sparse_attn", "xla_flash", block_k=chunk, **dims)
        for impl in ("pallas", "interpret"):   # the JAX package's own, kept
            assert pm.kernel_cost(h, "sparse_attn", impl, **dims) == \
                jpm.kernel_cost(jh, "sparse_attn", impl, **dims)


def test_kernel_cost_prices_the_cuda_structure():
    """The port's kernel at a launch config: the built-in config (0) prices
    as the explicit built-in one; at the calibration row (256 x 1024 of 2048
    -> 5460 at 2 parts: 224.0 us on the card) within 10 %; more decode
    windows a block cost more serial time at one cluster's width."""
    h = pm.H100_SXM
    gate = dict(m=256, k=2048, n=5460, keep=16, block=32)
    builtin = pm.kernel_cost(h, "das_ternary_gemm", "cuda", **gate)
    assert builtin == pm.kernel_cost(h, "das_ternary_gemm", "cuda", parts=2, **gate)
    assert abs(builtin - 224.0e-6) < 22.4e-6
    dec = dict(m=4, k=2048, n=2048, keep=16, block=32)
    assert pm.kernel_cost(h, "das_ternary_gemm", "cuda", **dec) == \
        pm.kernel_cost(h, "das_ternary_gemm", "cuda", subs=build.dec_subs(416, 2048), **dec)
    assert build.dec_subs(416, 2048) == 1 and build.dec_subs(416, 5460) == 2
    assert build.dec_subs(1104, 2048) == 4
    assert build.mma_parts(416) == 2 and build.mma_parts(1104) == 5
    # the plain versions price as the native impl whose arithmetic they repeat
    assert pm.kernel_cost(h, "ternary_gemm", "plain", m=4, k=320, n=64) == \
        pm.kernel_cost(h, "ternary_gemm", "native_plain", m=4, k=320, n=64)


def test_ipj_matches():
    for args in ((42.0, 11.27, 5.7), (1000.0, 9.9, 700.0)):
        assert ipj.ipj(*args) == jipj.ipj(*args)
    assert ipj.ipj_from_latency(128, 2.5, 11.3, 300.0) == \
        jipj.ipj_from_latency(128, 2.5, 11.3, 300.0)
    for bad in ((1.0, 0.0, 1.0), (1.0, 1.0, -1.0)):
        with pytest.raises(ValueError):
            ipj.ipj(*bad)


def test_ppl_model_and_dse_match():
    for name in ("bitnet-1.3b", "bitnet-3b"):
        for s_a in (1.0, 0.6, 0.5, 0.3, 0.25):
            for tl in (512, 700, 1024, 1536):
                assert dse.ppl_model(name, s_a, tl) == jdse.ppl_model(name, s_a, tl)
    for shape, name in ((pm.LLAMA_1B3, "bitnet-1.3b"), (pm.LLAMA_3B, "bitnet-3b")):
        jshape = jpm.ModelShape(**_fields(shape))
        got = dse.dse_grid_search(shape, name)
        want = jdse.dse_grid_search(jshape, name)
        assert [_fields(c) for c in got] == [_fields(c) for c in want] and got
        for hw in (pm.TPU_V5E, pm.H100_SXM):
            assert dse.tpu_dse_grid_search(shape, name, hw) == \
                jdse.tpu_dse_grid_search(jshape, name, jpm.HardwareSpec(**_fields(hw)))
    with pytest.raises(KeyError):
        dse.ppl_model("llama-7b", 0.5, 1024)


def test_shapes_match():
    assert [dataclasses.asdict(s) for s in SHAPES] == [dataclasses.asdict(s) for s in JSHAPES]
    assert shape_by_name("decode_32k").seq_len == 32_768
    with pytest.raises(KeyError):
        shape_by_name("nope")


@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_cell_analytic_matches(arch):
    """Every shape of SHAPES at 1 and 256 devices, both packages' configs
    of the arch at full size (configs only: no weights are built).  The
    terms at the JAX package's rates, given to both sides (the port's
    defaults are an H100's)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    rates = dict(peak=197e12, hbm=819e9, link=50e9)   # the JAX package's defaults
    for shape, jshape in zip(SHAPES, JSHAPES):
        for n_dev in (1, 256):
            for kw in ({}, {"serve_sparse": False, "zero1": False}):
                got = cell_analytic(cfg, shape, n_dev, **kw)
                want = jcell(jcfg, jshape, n_dev, **kw)
                assert _fields(got) == _fields(want), (shape.name, n_dev, kw)
                assert got.terms(**rates) == want.terms(**rates)
