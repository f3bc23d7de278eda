"""The port's dry run (``launch.dryrun``, ``launch.report``, ``launch.mesh``)
against the JAX package's and against the real step.

  * ``active_param_count``, ``model_flops`` and the cache specs equal the
    JAX package's ``launch/dryrun.py`` for every arch x shape (configs and
    shapes only: the JAX caches by ``jax.eval_shape``, the port's on
    ``meta``);
  * meta equals real: reduced bitnet-1.3b and reduced qwen3-moe-30b-a3b,
    train and decode, and qwen3-moe's train with the experts alone on
    "model" (``dpattn``), at Topology(dp=2, tp=2) at a small shape: a rank's
    step on a virtual mesh on ``meta`` counts exactly the FLOPs, op-level
    bytes, collective kinds, counts and wire bytes, and state bytes of the
    same step run by that rank of a real world of 4 gloo ranks on CPU
    tensors (one world for the module);
  * full-size cells on ``meta`` at 16 x 16: bitnet-1.3b and qwen3-moe x
    train_4k and decode_32k, kimi-k2-1t-a32b x train_4k.  Each builds the
    rank's whole state at full width and depth and allocates nothing (every
    leaf on ``meta``; the peak RSS grows by under 1 GB); the step runs at
    full width on 2 of the layers (the full depth is the dry run's own
    cells: it only repeats the layer), with nonzero counts of every kind
    the cell has; summed over the 16 "model" positions, a train cell's
    params are the full tree's bytes plus its replicated leaves' once more
    a position (and a replicated kv head's (r - 1) times more, r ranks
    holding it: qwen3-moe's 4 kv heads and kimi-k2's 8 at tp 16);
  * the SSM, hybrid and frontend archs (and tp 16 over fewer heads) are
    recorded as failures naming ROADMAP queue 1, item 2, with exit code 1;
  * ``report.render`` reads ``--out``; ``--resume`` skips cells already
    done; an unknown arch, shape or variant is an argparse error.
"""
import dataclasses
import json
import os
import resource

import pytest
import torch

from repro_torch.configs import ARCH_MODULES, base as tbase, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_by_name
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.plan import Topology
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.launch import report as R
from repro_torch.models import model as MD
from repro_torch.tree import leaves, leaves_with_paths
from repro_torch.distributed.sharding import leaf_spec

TOPO = Topology(dp=2, tp=2)
SMALL = {"train": ShapeSpec("train_small", "train", 32, 4),
         "decode": ShapeSpec("decode_small", "decode", 64, 4)}
REAL = [(a, k, False) for a in ("bitnet-1.3b", "qwen3-moe-30b-a3b") for k in ("train", "decode")]
REAL.append(("qwen3-moe-30b-a3b", "train", True))     # dpattn: the experts alone on "model"
COUNTS = ("flops", "bytes", "ops", "collectives", "collective_counts")


@pytest.fixture(scope="module")
def jdry():
    """The JAX package's dryrun module, imported without its 512-device
    flag reaching this process's JAX (the backend is started first)."""
    import jax
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def _canon(spec) -> tuple:
    """A spec with each one-axis tuple entry as its name (a PartitionSpec's
    canonical form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_copies_match_repro(jdry, arch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.models import model as JMD
    from repro.models.transformer import Runtime as JRuntime
    cfg, jcfg = get_config(arch), jget(arch)
    assert D.active_param_count(cfg) == jdry.active_param_count(jcfg)
    dp = ("data",)
    for shape, jshape in zip(SHAPES, JSHAPES):
        assert D.model_flops(cfg, shape) == jdry.model_flops(jcfg, jshape)
        if shape.kind != "decode":
            continue
        b, s = shape.global_batch, shape.seq_len
        sparse = shape.name == "long_500k"
        jc = jax.eval_shape(lambda: JMD.init_caches(None, jcfg, b, s, JRuntime(serve_sparse=sparse),
                                                    jnp.dtype(jcfg.dtype)))
        jspecs = jdry.cache_specs(jcfg, jc, dp)
        plen, ng = len(jcfg.layer_pattern), 0
        want = {}
        if jc["stacked"] is not None:
            for j, (caches, specs) in enumerate(zip(jc["stacked"], jspecs["stacked"])):
                for key, leaf in caches.items():
                    ng = leaf.shape[0]
                    for g in range(ng):
                        want[g * plen + j, key] = (leaf.shape[1:], tuple(specs[key])[1:])
        for i, (caches, specs) in enumerate(zip(jc["tail"], jspecs["tail"])):
            for key, leaf in caches.items():
                want[ng * plen + i, key] = (leaf.shape, tuple(specs[key]))
        mine = MD.init_caches(cfg, b, s, device="meta", serve_sparse=sparse)
        got = D.cache_specs(cfg, mine, dp)
        compared = 0
        for i, (layer, specs) in enumerate(zip(mine, got)):
            for key, t in layer.items():
                if (i, key) in want and tuple(want[i, key][0]) == tuple(t.shape):
                    assert _canon(specs[key]) == _canon(want[i, key][1]), (arch, shape.name, i,
                                                                           key)
                    compared += 1
        assert compared > 0, (arch, shape.name)


def dry_rank(rank: int, cases) -> list:
    """Each (arch, kind, experts only) case's step on this rank of a real
    4-rank world on CPU tensors, and on its virtual mesh on ``meta``: their
    counts."""
    mesh = TOPO.build_mesh()
    out = []
    for arch, kind, ep in cases:
        cfg = tbase.reduced(get_config(arch))
        res = {}
        for name, m, dev in (("real", mesh, "cpu"), ("meta", TOPO.virtual_mesh(rank), "meta")):
            cell = D.make_cell(cfg, SMALL[kind], m.experts_alone() if ep else m, device=dev)
            got = D.measure(cell.run)
            res[name] = {k: got[k] for k in COUNTS} | {"state": cell.state_bytes}
        out.append(res)
    return out


@pytest.fixture(scope="module")
def real_runs():
    torch.set_num_threads(1)
    return run_ranks(dry_rank, TOPO.n_devices, REAL)


@pytest.mark.parametrize("case", range(len(REAL)),
                         ids=[f"{a}-{k}{'-dpattn' if e else ''}" for a, k, e in REAL])
def test_meta_counts_equal_the_real_ranks(real_runs, case):
    for rank, per in enumerate(real_runs):
        real, meta = per[case]["real"], per[case]["meta"]
        assert real == meta, (rank, real, meta)
        assert real["flops"] > 0 and real["bytes"] > 0 and real["state"] > 0
        kinds = {k for k, v in real["collectives"].items() if v}
        assert "all-reduce" in kinds, kinds
        if REAL[case][1] == "train":
            assert {"reduce-scatter", "all-gather"} <= kinds, kinds


FULL = [("bitnet-1.3b", "train_4k"), ("bitnet-1.3b", "decode_32k"),
        ("qwen3-moe-30b-a3b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
        ("kimi-k2-1t-a32b", "train_4k")]


def _on_meta(x) -> bool:
    return all(t.device.type == "meta" for t in leaves(x))


@pytest.mark.parametrize("arch,shape", FULL)
def test_full_size_cell_on_meta_allocates_nothing(arch, shape):
    topo = Topology.production()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cfg = get_config(arch)
    sh = shape_by_name(shape)
    serve_sparse = sh.name != "decode_32k"
    mesh = topo.virtual_mesh(topo.tp - 1)
    full = D.make_cell(cfg, sh, mesh, serve_sparse=serve_sparse)   # whole depth: the state
    assert full.state_bytes > 0
    cut = D.make_cell(dataclasses.replace(cfg, n_layers=2, scan_layers=False), sh, mesh,
                      serve_sparse=serve_sparse)
    got = D.measure(cut.run)
    rss = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) * 1024
    assert rss < 2**30, f"peak RSS grew by {rss / 2**30:.2f} GiB"
    assert got["flops"] > 0 and got["bytes"] > 0
    assert got["collectives"]["all-reduce"] > 0
    if sh.kind == "train":
        assert got["collectives"]["reduce-scatter"] > 0 and got["collectives"]["all-gather"] > 0
        # the params summed over every "model" position
        tree = MD.init_params(cfg, device="meta")
        assert _on_meta(tree)
        nb = lambda x: x.numel() * x.element_size()  # noqa: E731
        total = sum(nb(x) for x in leaves(tree))
        repl = sum(nb(x) for p, x in leaves_with_paths(tree)
                   if "model" not in leaf_spec(p.replace("/", "."), x.ndim))
        kv = sum(nb(x) for p, x in leaves_with_paths(tree) if p.endswith(("wk/w", "wv/w")))
        r = MD.kv_replicas(cfg, topo.tp)
        summed = sum(sum(nb(x) for x in leaves(MD.shard_params(tree, cfg,
                                                                 topo.virtual_mesh(m))))
                     for m in range(topo.tp))
        assert summed == total + (topo.tp - 1) * repl + (r - 1) * kv, (summed, total, repl, kv)
        assert (r > 1) == (arch != "bitnet-1.3b")


def test_waiting_archs_are_failures_naming_the_roadmap(tmp_path):
    out = tmp_path / "dry.json"
    for arch in ("zamba2-2.7b", "musicgen-medium", "pixtral-12b", "rwkv6-3b", "gemma2-2b"):
        assert D.main(["--arch", arch, "--shape", "train_4k", "--mesh", "both",
                       "--out", str(out)]) == 1
        fails = json.loads(out.read_text())["failures"]
        assert len(fails) == 2 and all("ROADMAP queue 1, item 2" in f[3] for f in fails), fails


def test_report_renders_and_resume_skips_done_cells(tmp_path, monkeypatch, capsys):
    """A cell at full width cut to 2 layers (the record is the same code's)."""
    monkeypatch.setattr(D, "get_config", lambda a: dataclasses.replace(
        get_config(a), n_layers=2, scan_layers=False))
    out = tmp_path / "dry.json"
    argv = ["--arch", "bitnet-1.3b", "--shape", "long_500k", "--out", str(out)]
    assert D.main(argv) == 0
    data = json.loads(out.read_text())
    (rec,) = data["records"]
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["collectives"]["all-reduce"] > 0 and rec["state_bytes_per_dev"] > 0
    assert rec["scan_corrected"] is False and rec["memory_analysis"] is None
    for key in ("a_t_compute", "a_t_memory", "a_t_collective", "a_dominant", "roofline_frac"):
        assert key in rec
    text = R.render(str(out))
    assert "| bitnet-1.3b | long_500k | 16x16 |" in text and "989 TFLOP/s" in text
    assert "197" not in text and "819" not in text

    def no_run(*a, **k):
        raise AssertionError("a done cell ran again")
    monkeypatch.setattr(D, "run_cell", no_run)
    capsys.readouterr()
    assert D.main(argv + ["--resume"]) == 0
    assert "resuming: 1 cells already done" in capsys.readouterr().out
    assert json.loads(out.read_text())["records"] == data["records"]


@pytest.mark.parametrize("argv", [["--arch", "no-such-arch"], ["--shape", "train_1m"],
                                  ["--variant", "paper,nope"], ["--jobs", "0"]])
def test_bad_arguments_are_argparse_errors(argv, capsys):
    with pytest.raises(SystemExit) as e:
        D.main(argv)
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_mesh_helpers_delegate_to_the_topology():
    mesh = LM.make_production_mesh(multi_pod=True, position=5)
    assert mesh.topology == Topology(dp=16, tp=16, pods=2) and mesh.backend == "meta"
    assert LM.mesh_axes(mesh) == ("pod", "data", "model")
    assert LM.dp_axes_for(mesh, 256) == ("pod", "data") and LM.dp_axes_for(mesh, 1) == ()
    assert mesh.model_index == 5 and mesh.dp_index == 0
    with pytest.raises(ValueError, match="position"):
        Topology(dp=2, tp=2).virtual_mesh(4)
