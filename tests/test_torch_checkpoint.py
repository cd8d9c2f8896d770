"""The port's checkpointing (``paddle_tpu_torch.checkpoint``, the train
step's and the optimizer's state, ``framework.io``) against the JAX
package's, on the CPU.

The on-disk format is shared: a tree saved by either package restores
bitwise in the other, bf16 included (the port writes bf16 as its raw
2-byte words under the dtype name ``ml_dtypes`` gives it). The JAX
package's own checkpoint tests (``tests/test_checkpoint.py``) are ported
where they apply to one process. Resume is bitwise within the port, and a
JAX run saved at step k continues in the port within
``tests/test_torch_training.py``'s trajectory tolerances.
"""

import json
import os
import signal
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.framework import io as jfio
from paddle_tpu.models.gpt import gpt_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch import checkpoint as tckpt
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch.checkpoint import (AsyncCheckpointError, AsyncWriter,
                                         CheckpointManager, TrainState,
                                         is_train_state_tree, load_tree,
                                         save_tree)
from paddle_tpu_torch.checkpoint import arrays as ckpt_arrays
from paddle_tpu_torch.distributed import (DeviceMesh, NamedSharding,
                                          PartitionSpec)
from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
from paddle_tpu_torch.framework import io as tfio
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.weights import from_paddle_tpu

B, S = 4, 32
# tests/test_torch_training.py's trajectory tolerances: fp32 losses to
# summation order; parameters to 1% of three AdamW steps' largest move;
# the K third of each qkv bias (true gradient zero) to Adam's bound
LOSS_TOL = 1e-5
PARAM_TOL = 3e-5


def _bits(a):
    """A leaf's dtype name, shape and raw bytes (torch or numpy)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        return name, tuple(t.shape), t.reshape(-1).view(torch.uint8) \
            .numpy().tobytes()
    a = np.asarray(a)
    return str(a.dtype), a.shape, np.ascontiguousarray(a).tobytes()


def _assert_trees_bitwise(want, got):
    if isinstance(want, dict):
        assert set(want) == set(got)
        for k in want:
            _assert_trees_bitwise(want[k], got[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(want) == len(got)
        for a, b in zip(want, got):
            _assert_trees_bitwise(a, b)
    elif isinstance(want, (torch.Tensor, np.ndarray, np.generic)) \
            or hasattr(want, "dtype"):
        assert _bits(want) == _bits(got)
    else:
        assert type(want) is type(got) and want == got


def _mixed_trees():
    """The same tree twice: numpy leaves (bf16 as ``ml_dtypes``, as the JAX
    package holds it, plus a jax array) and torch leaves."""
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4, 6)).astype(np.float32)
    f16 = rng.standard_normal(7).astype(np.float16)
    i32 = rng.integers(-9, 9, (2, 3)).astype(np.int32)
    i64 = rng.integers(0, 2 ** 40, 5).astype(np.int64)
    b = rng.integers(0, 2, (3, 3)).astype(bool)
    scalar = np.float32(0.125)
    jbf = np.asarray(jnp.asarray(bf, dtype=jnp.bfloat16))
    tbf = torch.from_numpy(bf).to(torch.bfloat16)
    assert jbf.view(np.uint16).tobytes() == \
        tbf.view(torch.int16).numpy().tobytes()
    common = {"step": 12, "name": "run", "lr": 1e-3, "flag": True,
              "none": None}
    jtree = {"params": {"w": f32, "emb": jbf, "h": f16},
             "ids": [i32, [i64, {"mask": b}]], "beta_pow": scalar,
             "dev": jnp.asarray(f32), **common}
    ttree = {"params": {"w": torch.from_numpy(f32), "emb": tbf,
                        "h": torch.from_numpy(f16)},
             "ids": [torch.from_numpy(i32),
                     (torch.from_numpy(i64), {"mask": torch.from_numpy(b)})],
             "beta_pow": torch.tensor(0.125, dtype=torch.float32),
             "dev": torch.from_numpy(f32), **common}
    return jtree, ttree


def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path):
    jtree, ttree = _mixed_trees()
    jckpt.save_tree(str(tmp_path), jtree, step=3)
    got = load_tree(str(tmp_path))
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert got["beta_pow"].shape == ()
    _assert_trees_bitwise(ttree, got)


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    jtree, ttree = _mixed_trees()
    save_tree(str(tmp_path), ttree, step=3)
    got = jckpt.load_tree(str(tmp_path))
    assert got["params"]["emb"].dtype == ml_dtypes.bfloat16
    want = {**jtree, "dev": np.asarray(jtree["dev"])}
    want["ids"] = [want["ids"][0], list(want["ids"][1])]
    _assert_trees_bitwise(want, got)


def test_both_packages_write_the_same_files(tmp_path):
    """The manifests are equal and every shard file holds the same bytes."""
    jtree, ttree = _mixed_trees()
    jd, td = tmp_path / "jax", tmp_path / "port"
    jm = jckpt.save_tree(str(jd), jtree, step=5)
    tm = save_tree(str(td), ttree, step=5)
    assert jm == tm
    for d in (jd, td):
        with open(d / "manifest.json") as f:
            assert json.load(f) == jm
    files = sorted(os.listdir(jd))
    assert files == sorted(os.listdir(td))
    for f in files:
        if f.endswith(".bin"):
            assert (jd / f).read_bytes() == (td / f).read_bytes(), f
    assert all(e["sharding"] is None for e in jm["arrays"].values())
    assert "params__emb.o0_0.bin" in files and \
        "beta_pow.scalar.bin" in files


def test_sharded_restore_checks_the_files_it_reads(tmp_path):
    """A block's restore with validation reads every file the block
    overlaps whole and checks its CRC32: a flipped byte inside the block
    raises; without validation only the block's bytes are read, so the
    flip comes back unseen."""
    d = str(tmp_path / "ck")
    w = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    save_tree(d, {"w": w})
    [shard] = [f for f in os.listdir(d) if f.endswith(".bin")]
    with open(os.path.join(d, shard), "r+b") as f:  # row 1: rank 0's
        f.seek(6 * 4 + 1)
        raw = f.read(1)
        f.seek(6 * 4 + 1)
        f.write(bytes([raw[0] ^ 0xFF]))
    split = {"w": NamedSharding(DeviceMesh([0, 1], ("dp",)),
                                PartitionSpec("dp"))}
    with pytest.raises(IOError, match="(?i)checksum"):
        load_tree(d, shardings=split)
    ckpt_arrays.reset_read_stats()
    got = load_tree(d, shardings=split, validate=False)["w"]
    assert ckpt_arrays.read_stats()["bytes"] == 4 * 6 * 4
    assert torch.equal(got.block[0], w[0])
    assert not torch.equal(got.block[1], w[1])


# ---------------- the JAX package's checkpoint tests, one process --------
def test_checksum_validation_detects_corruption(tmp_path):
    d = str(tmp_path / "ck")
    save_tree(d, {"w": torch.arange(8, dtype=torch.float32)})
    [shard] = [f for f in os.listdir(d) if f.endswith(".bin")]
    with open(os.path.join(d, shard), "r+b") as f:
        raw = f.read(1)
        f.seek(0)
        f.write(bytes([raw[0] ^ 0xFF]))
    with pytest.raises(IOError, match="(?i)crc|checksum|corrupt"):
        load_tree(d)
    assert load_tree(d, validate=False)["w"].shape == (8,)


def test_manager_latest_and_already_committed(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_=False)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(1, {"v": np.float32(1.0)})
    mgr.save(5, {"v": torch.tensor(5.0)})
    assert mgr.all_steps() == [1, 5] and mgr.latest_step() == 5
    with pytest.raises(ValueError, match="already committed"):
        mgr.save(5, {"v": np.float32(9.0)})
    mgr.save(5, {"v": np.float32(9.0)}, force=True)
    assert float(mgr.restore(5)["v"]) == 9.0
    with pytest.raises(FileNotFoundError, match="not a committed"):
        mgr.restore(3)
    # a None placement is a host restore (as in the JAX package); a
    # replicated one reads the whole array too; a sharded one gives this
    # rank's block (rank 0 here); a live leaf that is no ShardedTensor is
    # read from the files
    assert float(mgr.restore(shardings={"v": None})["v"]) == 9.0
    two = DeviceMesh([0, 1], ("dp",))
    rep = NamedSharding(two, PartitionSpec())
    assert float(mgr.restore(shardings={"v": rep})["v"]) == 9.0
    mgr.save(6, {"v": torch.arange(4.0)})
    split = NamedSharding(two, PartitionSpec("dp"))
    block = mgr.restore(6, shardings={"v": split})["v"]
    assert block.sharding == split and block.shape == (4,)
    assert torch.equal(block.block, torch.arange(2.0))
    assert float(mgr.restore(5, live_state={"v": torch.zeros(())})["v"]) \
        == 9.0
    mgr.close()


def test_torn_save_invisible_then_gcd(tmp_path):
    """A save killed between its files and COMMIT is invisible; restore
    returns the previous step intact, the failure surfaces on wait, and the
    next manager deletes the torn directory."""
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, async_=True)
    state1 = {"w": torch.arange(6, dtype=torch.float32), "step": 1}
    mgr.save(1, state1)
    mgr.wait_until_finished()

    def killed(sdir, step):
        raise RuntimeError("simulated kill before COMMIT")

    mgr._write_commit = killed
    mgr.save(2, {"w": torch.zeros(6), "step": 2})
    with pytest.raises(AsyncCheckpointError, match="simulated kill"):
        mgr.wait_until_finished()
    torn = mgr.step_path(2)
    assert os.path.isdir(torn)
    assert not os.path.exists(os.path.join(torn, "COMMIT"))
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    back = mgr.restore()
    assert torch.equal(back["w"], state1["w"]) and back["step"] == 1
    mgr.close()
    mgr2 = CheckpointManager(d)
    assert not os.path.exists(torn) and mgr2.all_steps() == [1]
    mgr2.close()


def test_keep_last_n_gc_never_deletes_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=2,
                            async_=False)
    for s in range(1, 5):
        mgr.save(s, {"v": np.float32(s)})
    assert mgr.all_steps() == [3, 4]
    assert not os.path.exists(mgr.step_path(1))
    mgr.close()
    mgr0 = CheckpointManager(str(tmp_path / "ck0"), keep_last_n=0,
                             async_=False)
    mgr0.save(1, {"v": np.float32(1)})
    mgr0.save(2, {"v": np.float32(2)})
    assert mgr0.all_steps() == [2] and float(mgr0.restore()["v"]) == 2.0
    mgr0.close()


def test_async_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_=True)
    real = ckpt_arrays.write_snapshot

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_arrays, "write_snapshot", boom)
    mgr.save(1, {"v": np.float32(1)})
    mgr._writer._queue.join()
    monkeypatch.setattr(ckpt_arrays, "write_snapshot", real)
    with pytest.raises(AsyncCheckpointError, match="disk full"):
        mgr.save(2, {"v": np.float32(2)})
    mgr.save(2, {"v": np.float32(2)})
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]
    mgr.close()


def test_async_writer_ordering_and_close():
    done = []
    w = AsyncWriter(name="t")
    for i in range(8):
        w.submit(lambda i=i: done.append(i))
    w.wait_until_finished()
    assert done == list(range(8))
    w.close()
    with pytest.raises(RuntimeError):
        w.submit(lambda: None)


def test_save_blocks_only_for_snapshot(tmp_path, monkeypatch):
    """A slow disk write does not extend ``save``'s blocking time, and the
    manager records the blocking and total seconds and the bytes."""
    mgr = CheckpointManager(str(tmp_path / "ck"), async_=True)
    real = ckpt_arrays.write_snapshot

    def slow(*a, **k):
        time.sleep(0.25)
        return real(*a, **k)

    monkeypatch.setattr(ckpt_arrays, "write_snapshot", slow)
    t0 = time.perf_counter()
    mgr.save(1, {"v": torch.arange(4, dtype=torch.float32)})
    blocking = time.perf_counter() - t0
    mgr.wait_until_finished()
    total = time.perf_counter() - t0
    assert blocking < 0.2 < total
    rec = mgr.last_save
    assert rec["blocking_s"] < 0.2 <= rec["total_s"] and rec["bytes"] == 16
    assert mgr.latest_step() == 1
    mgr.restore()
    assert mgr.last_restore["bytes"] == 16
    mgr.close()


def test_train_state_tree_roundtrip(tmp_path):
    ts = TrainState(params={"w": torch.ones(3)},
                    opt_state={"w": {"moment1": torch.zeros(3)}},
                    rng={"seed": 7}, step=11, data_position=128)
    tree = ts.to_tree()
    assert is_train_state_tree(tree)
    save_tree(str(tmp_path), tree)
    ts2 = TrainState.from_tree(load_tree(str(tmp_path)))
    assert ts2.step == 11 and ts2.rng == {"seed": 7}
    assert ts2.data_position == 128 and ts2.buffers is None
    assert torch.equal(ts2.params["w"], ts.params["w"])
    with pytest.raises(ValueError, match="__train_state__"):
        TrainState.from_tree({"params": {}})


def test_save_async_failure_raises_and_threads_reaped(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("a regular file, not a directory")
    tfio.save_async({"v": torch.tensor([1.0])},
                    str(blocker / "sub" / "x.pdparams"))
    with pytest.raises(AsyncCheckpointError, match="background save"):
        tfio.wait_async_saves()
    tfio.wait_async_saves()  # consumed, not sticky
    good = str(tmp_path / "ok.pdparams")
    for _ in range(20):
        tfio.save_async({"v": torch.tensor([2.0])}, good)
    tfio.wait_async_saves()
    tfio.save_async({"v": torch.tensor([3.0])}, good)
    assert len(tfio._async_threads) <= 2
    tfio.wait_async_saves()
    assert torch.equal(tframework.load(good)["v"], torch.tensor([3.0]))


def test_enable_auto_checkpoint_directory_mode(tmp_path):
    """A path without an extension is a ``CheckpointManager`` directory;
    SIGTERM publishes the final state under the step count."""
    from paddle_tpu_torch.optimizer import Adam

    net = torch.nn.Linear(4, 2)
    opt = Adam(parameters=net.named_parameters())
    mgr = tframework.enable_auto_checkpoint(
        str(tmp_path / "auto"), layer=net, optimizer=opt, every_n_steps=2,
        keep_last_n=2)
    try:
        assert isinstance(mgr, CheckpointManager)
        for _ in range(4):
            net(torch.ones(2, 4)).sum().backward()
            opt.step()
            opt.clear_grad()
            tframework.auto_checkpoint_step()
        mgr.wait_until_finished()
        assert mgr.all_steps() == [2, 4]
        with pytest.raises(SystemExit):
            signal.raise_signal(signal.SIGTERM)
        state = mgr.restore()
        assert "model" in state and "optimizer" in state
        assert state["optimizer"]["global_step"] == 4
        assert torch.equal(state["model"]["weight"], net.weight.detach())
        assert mgr.latest_step() == 4
    finally:
        tframework.disable_auto_checkpoint()


# ---------------- framework.io pickles -------------------------------------
def test_pickle_is_read_across_the_packages(tmp_path):
    """fp32, int and bool tensors: what either package saves the other
    loads, bit for bit."""
    rng = np.random.default_rng(5)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "ids": rng.integers(0, 99, 6).astype(np.int64),
              "i32": rng.integers(0, 99, 2).astype(np.int32),
              "mask": rng.integers(0, 2, 5).astype(bool)}
    meta = {"epoch": 3, "name": "run"}
    tfio.save({**{k: torch.from_numpy(v) for k, v in arrays.items()},
               "meta": meta}, str(tmp_path / "port.pdparams"))
    got = jfio.load(str(tmp_path / "port.pdparams"), return_numpy=True)
    jfio.save({**{k: paddle.to_tensor(v) for k, v in arrays.items()},
               "meta": meta}, str(tmp_path / "jax.pdparams"))
    back = tfio.load(str(tmp_path / "jax.pdparams"))
    assert got["meta"] == back["meta"] == meta
    for k, v in arrays.items():
        assert _bits(got[k]) == _bits(v), k
        assert isinstance(back[k], torch.Tensor)
        assert _bits(back[k]) == _bits(v), k


def test_pickle_round_trips_bf16_in_the_port(tmp_path):
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    p = torch.nn.Parameter(w.clone())
    tfio.save({"w": w, "p": p, "nested": [w[0]]}, str(tmp_path / "b.pd"))
    back = tfio.load(str(tmp_path / "b.pd"))
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
    assert torch.equal(back["p"], w) and torch.equal(back["nested"][0], w[0])
    raw = tfio.load(str(tmp_path / "b.pd"), return_numpy=True)
    assert raw["w"].dtype == np.uint16


def test_save_sharded_is_the_shared_format(tmp_path):
    _, ttree = _mixed_trees()
    state = {"w": ttree["params"]["w"], "emb": ttree["params"]["emb"]}
    tfio.save_sharded(state, str(tmp_path))
    got = jfio.load_sharded(str(tmp_path))
    assert _bits(got["emb"]) == _bits(
        np.asarray(jnp.asarray(state["emb"].float().numpy(),
                               dtype=jnp.bfloat16)))
    _assert_trees_bitwise(state, tfio.load_sharded(str(tmp_path)))
    # a placement gives this rank's block (rank 0 of two here); anything
    # but the port's NamedSharding is refused
    two = DeviceMesh([0, 1], ("dp",))
    emb = tfio.load_sharded(str(tmp_path), shardings={
        "emb": NamedSharding(two, PartitionSpec(None, "dp"))})["emb"].block
    assert _bits(emb) == _bits(state["emb"].chunk(2, 1)[0])
    with pytest.raises(TypeError, match="NamedSharding"):
        tfio.load_sharded(str(tmp_path), shardings={"w": object()})


# ---------------- Optimizer.state_dict -------------------------------------
def _jax_and_port_optimizers():
    """The same two tensors and three steps of AdamW (with a scheduler) on
    the JAX package's eager optimizer and the port's."""
    from paddle_tpu.core.tensor import Parameter

    rng = np.random.default_rng(11)
    init = {"w": rng.standard_normal((6, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    jp = {k: Parameter(jnp.asarray(v), name=k) for k, v in init.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    jsched = paddle.optimizer.lr.StepDecay(1e-2, step_size=2, gamma=0.5)
    tsched = tlr.StepDecay(1e-2, step_size=2, gamma=0.5)
    jopt = paddle.optimizer.AdamW(learning_rate=jsched,
                                  parameters=list(jp.values()),
                                  weight_decay=0.01)
    topt = AdamW(learning_rate=tsched, parameters=tp, weight_decay=0.01)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in init.items()}
        loss = sum((jp[k] * paddle.to_tensor(g)).sum()
                   for k, g in grads.items())
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        topt.step()
        jsched.step()
        tsched.step()
    return jopt, topt


def test_optimizer_state_dict_matches_the_reference():
    """The same keys; ``global_step`` and the scheduler's state equal; the
    step powers bit for bit; the moments to a few fp32 ulps (2e-6, as
    ``tests/test_torch_training.py`` holds the two AdamWs)."""
    jopt, topt = _jax_and_port_optimizers()
    want, got = jopt.state_dict(), topt.state_dict()
    assert set(want) == set(got)
    assert got["global_step"] == want["global_step"] == 3
    assert got["LR_Scheduler"] == want["LR_Scheduler"]
    for k, v in want.items():
        if k in ("global_step", "LR_Scheduler"):
            continue
        w = np.asarray(v.numpy())
        g = np.asarray(got[k].numpy() if isinstance(got[k], torch.Tensor)
                       else got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, k
        if k.endswith("_pow"):
            assert w.tobytes() == g.tobytes(), k
        else:
            assert float(np.abs(w - g).max()) <= 2e-6, k


def test_optimizer_set_state_dict_round_trips_bitwise():
    """The port's state dict into a fresh optimizer (in place, the step
    powers as fp32 host scalars); the JAX package's state dict loads too."""
    jopt, topt = _jax_and_port_optimizers()
    fresh = {k: torch.nn.Parameter(torch.zeros_like(v))
             for k, v in topt._params.items()}
    other = AdamW(learning_rate=tlr.StepDecay(1e-2, step_size=2, gamma=0.5),
                  parameters=fresh, weight_decay=0.01)
    other.set_state_dict(topt.state_dict())
    assert other._step_count == 3
    assert other._lr.state_dict() == topt._lr.state_dict()
    for name, slots in topt.state.items():
        for k, v in slots.items():
            assert _bits(other.state[name][k]) == _bits(v), (name, k)
            assert type(other.state[name][k]) is type(v)
    jstate = {k: (v.numpy() if hasattr(v, "numpy") else v)
              for k, v in jopt.state_dict().items()}
    other.set_dict(jstate)
    for name, slots in other.state.items():
        for k, v in slots.items():
            assert _bits(v) == _bits(np.asarray(jstate[f"{name}_{k}"])), k


# ---------------- the train step's resume ----------------------------------
def _port_step(seed, dropout=0.0, scaler=False, recompute=False):
    cfg = GPTConfig(**{**GPT_TINY, "num_kv_heads": 2, "dropout": dropout,
                       "use_recompute": recompute, "loss_chunk": 8})
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters(),
                weight_decay=0.01)
    sc = amp.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2) \
        if scaler else None
    return make_sharded_train_step(model, opt, scaler=sc, seed=17,
                                   device="cpu")


def _batch(seed):
    x = np.random.default_rng(seed).integers(0, 128, (B, S)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


@pytest.mark.parametrize("kw", [dict(), dict(dropout=0.1, recompute=True),
                                dict(scaler=True)],
                         ids=["plain", "dropout_recompute", "scaler"])
def test_train_step_resumes_bitwise(tmp_path, kw):
    """Run A: 2 steps, save, 2 more. Run B: a model from another init
    seed, restored from the save, the same 2 steps. Losses, parameters,
    optimizer slots and the scaler's automaton equal bit for bit; with
    dropout the draws follow ``(seed, step)``."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    a = _port_step(0, **kw)
    for i in range(2):
        a(*_batch(i))
    mgr.save(a.step_index, a.state_for_checkpoint().to_tree())
    losses_a = [a(*_batch(2 + i)).item() for i in range(2)]
    b = _port_step(1, **kw)
    tree = mgr.restore()
    assert is_train_state_tree(tree) and tree["rng"] == {"seed": 17}
    b.restore_from_checkpoint(tree)
    assert b.step_index == 2
    losses_b = [b(*_batch(2 + i)).item() for i in range(2)]
    assert losses_a == losses_b
    for name, p in a.params.items():
        assert torch.equal(p, b.params[name]), name
    for name, slots in a.optimizer.state.items():
        for k, v in slots.items():
            assert _bits(v) == _bits(b.optimizer.state[name][k]), (name, k)
    if kw.get("scaler"):
        sa, sb = a._scaler, b._scaler
        assert (sa._scale, sa._good_steps, sa._bad_steps) == \
            (sb._scale, sb._good_steps, sb._bad_steps)
        assert tree["extra"]["scaler_state"][0].dtype == torch.float32
    mgr.close()


def test_dropout_draws_follow_seed_and_step():
    """With dropout, the step's draws are keyed on ``(seed, step)``: the
    same seed repeats a step's loss, another seed changes it, and the
    caller's RNG stream is left untouched."""
    x, y = _batch(7)
    step = _port_step(0, dropout=0.1)
    state = torch.random.get_rng_state()
    la = step(x, y).item()
    assert torch.equal(torch.random.get_rng_state(), state)
    lb = _port_step(0, dropout=0.1)(x, y).item()
    other = _port_step(0, dropout=0.1)
    other._seed = 18
    assert la == lb != other(x, y).item()


def test_adjacent_seeds_draw_apart():
    """Step ``i`` of seed ``s`` is seeded with ``mix_seed(s, i)``, so seed
    17's second step and seed 18's first draw different masks (a plain
    ``seed + step`` would give both 19)."""
    from paddle_tpu_torch import nn as torch_nn
    from paddle_tpu_torch.data import mix_seed

    x, y = _batch(7)
    seen = {}
    for seed, steps in ((17, 2), (18, 1)):
        step = _port_step(0, dropout=0.1)
        step._seed = seed
        drop = next(m for m in step.model.modules()
                    if isinstance(m, torch_nn.Dropout))
        drop.register_forward_pre_hook(
            lambda m, a, s=seed: seen.setdefault(s, []).append(
                torch.initial_seed()))
        for _ in range(steps):
            step(x, y)
    assert seen == {17: [mix_seed(17, 1), mix_seed(17, 2)],
                    18: [mix_seed(18, 1)]}
    assert seen[17][1] != seen[18][0]


def test_restore_rejects_what_the_port_lacks(tmp_path):
    """A gradient reducer's residuals restored into a step without a
    reducer are dropped, as the JAX step drops them; the step's placements
    for a restore are replicated over its mesh and a restore takes them;
    names the step does not hold raise."""
    a = _port_step(0)
    a(*_batch(0))
    tree = a.state_for_checkpoint().to_tree()
    a.restore_from_checkpoint({**tree, "extra": {"grad_reduce_ef": {
        "bucket000": np.ones((2, 256), np.float32)}}})
    assert a.ef_state == {} and "extra" not in \
        a.state_for_checkpoint().to_tree()
    sh = a.checkpoint_shardings()
    assert set(sh) == {"params", "opt_state"}
    assert set(sh["params"]) == set(tree["params"])
    assert all(s.is_replicated and s.mesh == a.mesh
               for s in sh["params"].values())
    mgr = CheckpointManager(str(tmp_path / "ck"), async_=False)
    mgr.save(1, tree)
    _assert_trees_bitwise(tree, mgr.restore(shardings=sh))
    mgr.close()
    bad = {**tree, "params": {**tree["params"], "extra.weight":
                              torch.zeros(1)}}
    with pytest.raises(KeyError, match="names differ"):
        a.restore_from_checkpoint(bad)


def _jax_and_port_models():
    paddle.seed(0)
    jm = gpt_tiny(num_kv_heads=2, dropout=0.0)
    rng = np.random.default_rng(0)
    params = {}
    for name, v in jm.functional_state()[0].items():
        shape = tuple(v.shape)
        scale = 0.2 if len(shape) >= 2 else 0.05
        base = 1.0 if len(shape) == 1 and "bias" not in name else 0.0
        params[name] = (base + scale * rng.standard_normal(shape)) \
            .astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    tm = GPTForCausalLM(GPTConfig(**{**GPT_TINY, "num_kv_heads": 2,
                                     "dropout": 0.0}), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    return jm, tm, params


def test_jax_run_continues_in_the_port(tmp_path):
    """A JAX ``ShardedTrainStep`` trains 2 steps and is saved with
    ``paddle_tpu.checkpoint``; the port's step, built on other weights,
    restores the save (params, AdamW moments and step powers, step count,
    seed) and takes the JAX run's next 3 steps within the trajectory
    tolerances."""
    jm, tm, _ = _jax_and_port_models()
    jstep = j_make_step(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01))
    for i in range(2):
        jstep(*_batch(20 + i))
    mgr = jckpt.CheckpointManager(str(tmp_path / "ck"), async_=False)
    mgr.save(2, jstep.state_for_checkpoint().to_tree())
    mgr.close()
    want = [float(jstep(*_batch(22 + i))) for i in range(3)]
    tstep = make_sharded_train_step(tm, AdamW(
        learning_rate=1e-3, parameters=tm.named_parameters(),
        weight_decay=0.01), device="cpu")
    tstep.restore_from_checkpoint(CheckpointManager(
        str(tmp_path / "ck")).restore())
    assert tstep.step_index == 2
    got = [tstep(*_batch(22 + i)).item() for i in range(3)]
    assert np.abs(np.array(want) - np.array(got)).max() <= LOSS_TOL
    D, Hq, Hkv = tm.cfg.head_dim, tm.cfg.num_heads, tm.cfg.num_kv_heads
    for name, p in tm.named_parameters():
        diff = np.abs(np.asarray(jstep.params[name]) - p.detach().numpy())
        if name.endswith("attn.qkv.bias"):
            k_part = slice(Hq * D, (Hq + Hkv) * D)
            assert float(diff[k_part].max()) <= 2 * 5 * 1e-3, name
            diff[k_part] = 0
        assert float(diff.max()) <= PARAM_TOL, (name, float(diff.max()))


def test_weights_convert_without_ml_dtypes():
    """``weights.from_paddle_tpu`` reads bf16 arrays through their words."""
    a = np.asarray(jnp.asarray(np.linspace(-2, 2, 6, dtype=np.float32),
                               dtype=jnp.bfloat16))
    from paddle_tpu_torch.weights import to_torch

    t = to_torch(a)
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == a.tobytes()
