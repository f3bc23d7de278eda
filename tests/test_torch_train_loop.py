"""The port's training loop against the JAX package: data, checkpoints, the
train step and the CLI.

- ``SyntheticLM`` and ``FileTokens`` batches are bitwise the JAX package's
  (numpy on both sides), at several steps and shards; the prefetcher yields
  them in step order.
- The port's checkpoints: a tree of float32, bfloat16 and int32 leaves with
  an AdamWState round-trips bitwise, async too (a failed async write raised
  by ``wait_pending``); an uncommitted step (a ``.tmp`` directory, or no
  DONE marker) is never taken.
- A checkpoint written by the JAX package's ``save_checkpoint``, bfloat16
  leaves included, restores into the port's tree bitwise.
- 4 steps of ``make_train_step`` from bridged master weights: each step's
  loss within 1e-4 of the JAX package's jitted step's (its DAS / int8
  decisions replayed where the port's differ, as in test_torch_train.py).
- The CLI on ``--device cpu``: the loss falls; with ``--inject-failure`` and
  ``--ckpt-dir`` the run restarts from its checkpoint and ends at the clean
  run's loss exactly; the MoE, recurrent and hybrid archs train reduced for
  2 steps with finite losses; an unknown ``--arch`` is an argparse error.
- The master trees of the MoE, recurrent and hybrid archs load from the JAX
  package's, save and restore bitwise, and restore from its checkpoints.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro_torch import checkpoint as ckpt
from repro_torch.bridge import load_master_tree, to_torch
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw
from repro_torch.tree import leaves
from test_torch_hybrid import one_thread  # noqa: F401
from test_torch_train import Decisions, cfg_pair, jax_params


def _equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2)])
def test_synthetic_batches_bitwise(shard, n_shards):
    kw = dict(vocab=512, seq_len=48, batch=4, seed=7, shard=shard, n_shards=n_shards)
    mine, theirs = pipe.SyntheticLM(**kw), jpipe.SyntheticLM(**kw)
    for step in (0, 1, 5, 123):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b) == ["inputs", "labels"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_file_tokens_bitwise(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(np.uint16).tofile(path)
    for shard in (0, 1):
        kw = dict(path=str(path), vocab=1000, seq_len=31, batch=4, shard=shard, n_shards=2)
        mine, theirs = pipe.FileTokens(**kw), jpipe.FileTokens(**kw)
        for step in (0, 3, 39, 200):
            a, b = mine.batch_at(step), theirs.batch_at(step)
            for k in ("inputs", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_in_step_order():
    src = pipe.SyntheticLM(vocab=100, seq_len=8, batch=2, seed=1)
    pf = pipe.Prefetcher(src, start_step=3, depth=2)
    try:
        for want in (3, 4, 5):
            step, batch = next(pf)
            assert step == want
            np.testing.assert_array_equal(batch["inputs"], src.batch_at(want)["inputs"])
    finally:
        pf.stop()
    assert pipe.make_batch_fn(src)(2)["labels"].shape == (2, 8)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _train_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(16, 8, generator=g).to(torch.bfloat16),
              "layers": {"stacked": None,
                         "tail": ({"w": torch.randn(8, 8, generator=g)},
                                  {"w": torch.randn(8, 4, generator=g).to(torch.bfloat16)})}}
    opt = adamw.adamw_init(params)
    opt = opt._replace(step=torch.tensor(5, dtype=torch.int32))
    return {"params": params, "opt": opt}


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoint_round_trip(tmp_path, async_save):
    tree = _train_tree()
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 5, tree, async_save=async_save)
    ckpt.wait_pending()
    got, step = ckpt.restore_checkpoint(d, device="cpu")
    assert step == 5 and isinstance(got["opt"], adamw.AdamWState)
    assert got["params"]["layers"]["stacked"] is None
    _equal_trees(got, tree)
    assert sorted(os.listdir(os.path.join(d, "step_00000005"))) == \
        ["DONE", "manifest.json", "payload.npz"]


def test_async_save_failure_is_raised(tmp_path):
    blocker = tmp_path / "ck"
    blocker.write_text("a file where the checkpoint directory should be")
    ckpt.save_checkpoint(str(blocker), 1, _train_tree(), async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ckpt.wait_pending()
    ckpt.wait_pending()                  # reported once


def test_uncommitted_steps_are_ignored(tmp_path):
    d = tmp_path / "ck"
    tree = _train_tree()
    ckpt.save_checkpoint(str(d), 2, tree)
    later = _train_tree(seed=1)
    ckpt.save_checkpoint(str(d), 9, later)
    os.remove(d / "step_00000009" / "DONE")          # crashed before its commit
    ckpt.save_checkpoint(str(d), 4, later)
    os.rename(d / "step_00000004", d / "step_00000007.tmp")   # never renamed
    assert ckpt.latest_step(str(d)) == 2
    got, step = ckpt.restore_checkpoint(str(d), device="cpu")
    assert step == 2
    _equal_trees(got, tree)
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_restores_a_jax_checkpoint_with_bf16_leaves(tmp_path):
    """The JAX package's save_checkpoint of {"params", "opt"} (bfloat16
    masters, float32 moments, the int32 step) read from payload.npz alone,
    leaf_i by jax.tree.flatten's order of the port's tree of the same
    structure."""
    jcfg, tcfg = cfg_pair("bitnet-1.3b", dtype="bfloat16")
    jp = jax_params(jcfg)
    jopt = jadamw.adamw_init(jp)
    jopt = jopt._replace(step=jnp.int32(3),
                         m=jax.tree.map(lambda m: m + 0.25, jopt.m))
    d = str(tmp_path / "jck")
    jckpt.save_checkpoint(d, 3, {"params": jp, "opt": jopt})
    jckpt.wait_pending()
    with np.load(os.path.join(d, "step_00000003", "payload.npz")) as payload:
        assert any(payload[k].dtype.kind == "V" for k in payload.files)   # bf16 as |V2
    tp = load_master_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    like = {"params": tp, "opt": adamw.adamw_init(tp)}
    got, step = ckpt.restore_repro_checkpoint(d, like, device="cpu")
    assert step == 3 and int(got["opt"].step) == 3
    want = {"params": tp, "opt": load_master_tree(jax.tree.map(np.asarray, jopt), tcfg, "cpu")}
    _equal_trees(got, jax.tree.map(lambda t: t.detach(), want))
    assert got["params"]["embed"].dtype == torch.bfloat16
    bad = {"params": tp, "opt": adamw.adamw_init(tp)._replace(step=torch.zeros(()))}
    with pytest.raises(ValueError, match="int32"):
        ckpt.restore_repro_checkpoint(d, bad, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "rwkv6-3b",
                                  "gla-1.3b", "zamba2-2.7b"])
def test_moe_and_recurrent_trees_load_save_and_restore(tmp_path, arch):
    """The JAX package's bfloat16 master tree of each kind (expert stacks
    and router, the shared expert, rwkv's mixes and decay LoRA, gla's gate
    LoRA and head norm, mamba's conv and SSM leaves, zamba2's shared
    attention) through the bridge: every leaf bitwise; the port's checkpoint
    of it round-trips bitwise; and the JAX package's own checkpoint of it
    restores into the port's tree bitwise."""
    jcfg, tcfg = cfg_pair(arch, dtype="bfloat16")
    jp = jax_params(jcfg)
    tp = load_master_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        assert torch.equal(a.detach(), to_torch(np.asarray(b)))
    tree = {"params": jax.tree.map(lambda t: t.detach(), tp), "opt": adamw.adamw_init(tp)}
    ckpt.save_checkpoint(str(tmp_path / "ck"), 1, tree)
    got, step = ckpt.restore_checkpoint(str(tmp_path / "ck"), device="cpu")
    assert step == 1
    _equal_trees(got, tree)
    jckpt.save_checkpoint(str(tmp_path / "jck"), 2, {"params": jp})
    jckpt.wait_pending()
    got, step = ckpt.restore_repro_checkpoint(str(tmp_path / "jck"), {"params": tree["params"]},
                                              device="cpu")
    assert step == 2
    _equal_trees(got, {"params": tree["params"]})


# --------------------------------------------------------------------------
# the train step and the CLI
# --------------------------------------------------------------------------

def test_train_steps_match_jax(monkeypatch):
    """Each step's loss within 1e-4 of the jitted JAX step's, the port
    taking the DAS / int8 decisions of the JAX step where its own differ
    at a near tie (tests/test_torch_train.py ``Decisions``: after a few updates one
    decision on the other side of a tie moves the loss by ~1e-4 and the
    gradient norm by ~1e-3 in the steps that follow)."""
    jcfg, tcfg = cfg_pair("bitnet-1.3b")
    jp = jax_params(jcfg)
    data = pipe.SyntheticLM(vocab=jcfg.vocab, seq_len=64, batch=2, seed=0)
    kw = dict(peak_lr=3e-4, warmup=2, total=4)
    dec = Decisions(monkeypatch)
    dec.record_jax()
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.make_runtime(None, jcfg, 2), **kw))
    tstep = ttrain.make_train_step(tcfg, ttrain.make_runtime(), **kw)
    tp = load_master_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jopt, topt = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for s in range(4):
        batch = data.batch_at(s)
        jp, jopt, jm = jstep(jp, jopt, jax.tree.map(jnp.asarray, batch))
        dec.force_port()
        tp, topt, tm = tstep(tp, topt, batch)
        dec.check()
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4, f"step {s}"
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(topt.step) == 4
    assert not any(p.requires_grad for p in leaves(tp))


def test_cli_trains_and_recovers(tmp_path, capsys):
    base = ["--arch", "bitnet-1.3b", "--reduced", "--device", "cpu", "--steps", "12",
            "--batch", "4", "--seq", "64", "--lr", "3e-3", "--log-every", "4"]
    clean = ttrain.main(base)
    assert len(clean) == 12 and np.isfinite(clean).all()
    assert np.mean(clean[-3:]) < np.mean(clean[:3])
    faulty = ttrain.main(base + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3",
                                 "--inject-failure", "5"])
    out = capsys.readouterr().out
    assert "[fault] restored step 3" in out and "restarts=1" in out
    assert faulty[-1] == clean[-1]


@pytest.mark.parametrize("arch", ["no-such-arch"])
def test_cli_refuses_what_it_cannot_train(arch, capsys):
    """Every registered arch trains; an id no registry has is an argparse
    error."""
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1"])
    assert e.value.code == 2
    assert arch in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "rwkv6-3b",
                                  "gla-1.3b", "zamba2-2.7b"])
def test_cli_trains_every_kind(arch, capsys):
    """The MoE (with and without a shared expert), the recurrent pair and
    the hybrid train reduced on the CPU: 2 steps, finite losses."""
    losses = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "48", "--log-every", "1"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"[train] {arch}-smoke" in capsys.readouterr().out


def test_bridge_moves_numpy_trees():
    jcfg, tcfg = cfg_pair("gemma2-2b", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_params(jcfg))
    tp = load_master_tree(tree, tcfg, "cpu")
    assert all(p.requires_grad and p.dtype == torch.bfloat16 for p in leaves(tp))
    assert torch.equal(tp["embed"].detach(), to_torch(tree["embed"]))
    with pytest.raises(ValueError, match="layers"):
        load_master_tree({**tree, "layers": {**tree["layers"], "tail": tree["layers"]["tail"][:1]}},
                         tcfg, "cpu")
