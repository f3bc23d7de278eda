"""The package boundary of the port, checked in a fresh interpreter.

Importing every ``repro_torch`` module (the trainer's too: optim, data,
checkpoint, distributed.fault, launch.train; the distributed layer: plan,
sharding, collectives, elastic, launch) and chip_smoke.py's
module-level imports must pull in neither JAX nor any module of the JAX
package, nor may running the training pass of every block kind (the MoE,
rwkv, gla, mamba and the shared attention) on the CPU, nor a rank that
``distributed.launch.run_ranks`` spawns to serve a shard; and without a CUDA
device the entry points (the serving ones, the train CLI, a checkpoint
restore) must refuse to start unless the caller asks for the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import repro_torch
names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
missing = {"repro_torch.serve." + m for m in ("sampler", "metrics", "server", "scheduler")}
missing |= {"repro_torch." + m for m in (
    "tree", "optim.adamw", "optim.schedule", "optim.grad", "data.pipeline",
    "checkpoint.ckpt", "distributed.fault", "launch.train", "distributed.plan",
    "distributed.sharding", "distributed.collectives", "distributed.elastic",
    "distributed.launch")}
missing -= names
assert not missing, f"not walked: {missing}"
for name in sorted(names):
    importlib.import_module(name)
import chip_smoke  # module-level imports only; main() is not run
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, f"the port imported {leaked}"
assert not torch.cuda.is_available()

from repro_torch.configs import get_config, reduced
from repro_torch.models import model as MD
from repro_torch.serve import ServeEngine
cfg = reduced(get_config("bitnet-1.3b"))
for call in (lambda: MD.TernaryLM(cfg), lambda: MD.init_params(cfg),
             lambda: ServeEngine(MD.TernaryLM(cfg, "cpu"))):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("started without CUDA and without device='cpu'")
from repro_torch.launch import train
from repro_torch.checkpoint import restore_checkpoint
for call in (lambda: train.main(["--reduced", "--steps", "1"]),
             lambda: restore_checkpoint("no-such-dir")):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("started without CUDA and without device='cpu'")
eng = ServeEngine(MD.TernaryLM(cfg, "cpu"), device="cpu")
assert eng.device.type == "cpu"
# the training passes of every block kind, run once (each may import lazily)
from repro_torch.models import gla, mamba2, moe, rwkv6
from repro_torch.tree import leaves
assert all(map(callable, (moe.moe_train, mamba2.mamba_train, gla.gla_train,
                          rwkv6.time_mix_train, rwkv6.channel_mix_train)))
ids = torch.zeros((1, 16), dtype=torch.long)
for arch in ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "rwkv6-3b", "gla-1.3b", "zamba2-2.7b"):
    c = reduced(get_config(arch))
    params = MD.init_params(c, device="cpu")
    for t in leaves(params):
        t.requires_grad_()
    MD.loss_fn(params, c, {"inputs": ids, "labels": ids})[0].backward()
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, f"the port's training passes imported {leaked}"
# a spawned rank (a fresh interpreter of its own) serving its shard
import pathlib, tempfile
probe_dir = tempfile.mkdtemp()
pathlib.Path(probe_dir, "rank_probe.py").write_text(
    "import sys\n"
    "def leaked(rank):\n"
    "    from repro_torch.configs import get_config, reduced\n"
    "    from repro_torch.distributed.plan import Topology\n"
    "    from repro_torch.launch import serve as cli\n"
    "    from repro_torch.serve import ServeConfig\n"
    "    sc = ServeConfig(max_slots=2, max_len=32, topology=Topology(tp=2))\n"
    "    assert cli.serve_rank(rank, cli.RankJob(reduced(get_config('bitnet-1.3b')), sc))\n"
    "    return sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n")
sys.path.insert(0, probe_dir)
import rank_probe
from repro_torch.distributed.launch import run_ranks
leaked = run_ranks(rank_probe.leaked, 2)
assert leaked == [[], []], f"a spawned rank imported {leaked}"
print("BOUNDARY-OK")
"""


def test_port_imports_no_jax_and_needs_cuda_or_cpu_request():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BOUNDARY-OK" in res.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Alone in a directory, or without a card, the smoke script exits
    non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((tmp_path, tmp_path / "chip_smoke.py"),
                        (ROOT, ROOT / "chip_smoke.py")):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
