"""The port's data parallelism against the JAX package, on the CPU.

The JAX package is single-controller: its reference runs in this process on
``tests/conftest.py``'s 8-device CPU mesh, a 2-device ``dp`` mesh or group.
The port runs as two gloo ranks, started by ``test_torch_dist_ranks.Ranks``
(a file store under ``tmp_path``; at most 60 s, then every rank is killed)
from that file, which imports no JAX, while the JAX reference computes;
they write their results to ``tmp_path``. The three spawns here are all
the new tests start:

- collectives: on rank r, each collective's result is slice r of the JAX
  package's per-rank result on the same numpy values (fp32 sums of two
  values: equal); the dp topology equals the JAX package's; the degrees,
  options and models left to later items raise naming them; each rank's
  pipeline batches equal the JAX package's at ``process_index=r,
  process_count=2``, bit for bit;
- the dp step: the JAX ``ShardedTrainStep`` on a ``{"dp": 2}`` mesh and the
  global batch, against the two ranks on their halves, 3 AdamW steps with
  ``ClipGradByGlobalNorm``: losses within 1e-5, parameters within
  ``tests/test_torch_checkpoint.py``'s trajectory tolerances; the same with
  ``accumulate_steps=2``, and with a scaler that overflows on rank 1 only
  (both ranks skip); the replicas bitwise equal after every step; the two
  ranks against one port process on the global batch within fp32 rounding;
  different dropout masks on the two ranks;
- the checkpoint, through the port's launcher: a two-rank save restores
  bitwise in the JAX package (and leaves no manifest part), and a JAX save
  restores bitwise on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.checkpoint import arrays as jarrays
from paddle_tpu.data import build_pretrain_pipeline as j_pipeline
from paddle_tpu.distributed import collective as jcollective
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.models.gpt import gpt_tiny
from paddle_tpu_torch.checkpoint import arrays as tarrays
from paddle_tpu_torch.distributed import CommunicateTopology
from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import from_paddle_tpu

import test_torch_dist_ranks as R

B, S, STEPS = 4, 32, 3
# tests/test_torch_checkpoint.py's trajectory tolerances: fp32 losses to
# summation order, parameters to 1% of three AdamW steps' largest move, the
# K third of each qkv bias (true gradient zero) to Adam's bound
LOSS_TOL, PARAM_TOL = 1e-5, 3e-5
# two ranks against one process: the same sums in another order (the
# local means' average, the halves' gradients' average)
ROUNDING = 2e-6
EOS = 1
NAMES = ["data", "pipe", "sharding", "sep", "expert", "model"]


def _reset_jax_world():
    jcollective.destroy_process_group()
    jmesh.reset_global_mesh()
    jtopology.set_hybrid_communicate_group(None)


@pytest.fixture(autouse=True)
def _fresh_jax_world():
    _reset_jax_world()
    yield
    _reset_jax_world()


def _jax_model():
    """The JAX tiny GPT on random weights (std 0.2) and the port's
    ``state_dict`` of the same weights."""
    paddle.seed(0)
    jm = gpt_tiny(num_kv_heads=2, dropout=0.0)
    rng = np.random.default_rng(0)
    params = {}
    for name, v in jm.functional_state()[0].items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = 0.2 * rng.standard_normal(shape)
        elif "bias" in name:
            a = 0.05 * rng.standard_normal(shape)
        else:
            a = 1 + 0.1 * rng.standard_normal(shape)
        params[name] = a.astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    return jm, from_paddle_tpu(params)


def _batches(seed=7):
    x = np.random.default_rng(seed).integers(0, 128, (STEPS, B, S))
    return x, np.roll(x, -1, axis=2)


def _jax_step(jm, accum=None, scaler=None, mesh=True):
    opt = paddle.optimizer.AdamW(
        learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
    return j_make_step(jm, opt, mesh=Mesh(np.array(jax.devices()[:2]),
                                          ("dp",)) if mesh else None,
                       accumulate_steps=accum, scaler=scaler)


def _assert_trajectory(want, got, steps, tol=PARAM_TOL):
    """Parameters within ``tol``; the qkv bias's K third within Adam's
    bound, 2 * steps * lr."""
    D, Hq, Hkv = 16, 4, 2
    for name, p in got.items():
        diff = np.abs(np.asarray(want[name]) - np.asarray(p))
        if name.endswith("attn.qkv.bias"):
            k_part = slice(Hq * D, (Hq + Hkv) * D)
            assert float(diff[k_part].max()) <= 2 * steps * R.LR, name
            diff[k_part] = 0
        assert float(diff.max()) <= tol, (name, float(diff.max()))


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return str(a.dtype), a.shape, np.ascontiguousarray(a).tobytes()


def _assert_state_bitwise(jtree, ptree):
    """params and opt_state leaf for leaf, the step count and seed."""
    for part in ("params", "opt_state"):
        want, got = R._tree_copy(jtree[part]), ptree[part]
        assert set(want) == set(got), part
        for name in want:
            if isinstance(want[name], dict):
                assert set(want[name]) == set(got[name]), name
                for k in want[name]:
                    assert _bits(want[name][k]) == _bits(got[name][k]), \
                        (name, k)
            else:
                assert _bits(want[name]) == _bits(got[name]), name
    assert int(jtree["step"]) == int(ptree["step"])
    assert jtree["rng"] == ptree["rng"]


# ---------------- collectives, topology, refusals, data ------------------
def _token_shards(tmp_path, n_shards=4, docs=25):
    rng = np.random.RandomState(0)
    paths = []
    for s in range(n_shards):
        parts = []
        for _ in range(docs):
            d = rng.randint(2, 1000, size=rng.randint(6, 40)).astype(np.uint16)
            d[-1] = EOS
            parts.append(d)
        p = tmp_path / f"shard_{s:02d}.bin"
        np.concatenate(parts).tofile(p)
        paths.append(str(p))
    return paths


def _jax_collectives(vals, chunks, scatter):
    """The JAX package's per-rank results on a 2-device group, each
    ``[2, ...]``: slice r is rank r's."""
    g = jdist.new_group([0, 1])

    def per_rank(v):
        return jdist.to_per_rank([v[0], v[1]], group=g)

    def zeros(*shape):
        return paddle.to_tensor(np.zeros(shape, np.float32))

    def val(t):
        return np.asarray(t._value)

    out = {}
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = per_rank(vals)
        jdist.all_reduce(t, op=getattr(jdist.ReduceOp, op), group=g)
        out[f"all_reduce_{op}"] = val(t)
    t = per_rank(vals)
    jdist.reduce(t, dst=0, group=g)
    out["reduce"] = val(t)
    t = per_rank(vals)
    jdist.broadcast(t, src=1, group=g)
    out["broadcast"] = val(t)
    for name in ("all_gather", "gather"):
        got = []
        if name == "all_gather":
            jdist.all_gather(got, per_rank(vals), group=g)
        else:
            jdist.gather(per_rank(vals), got, dst=0, group=g)
        out[name] = np.stack([np.stack([val(x) for x in got])] * 2)
    t = zeros(2, chunks.shape[-1])
    jdist.reduce_scatter(t, per_rank(chunks), group=g)
    out["reduce_scatter"] = val(t)
    t = zeros(2, vals.shape[-1])
    jdist.scatter(t, [scatter[0], scatter[1]], src=0, group=g)
    out["scatter"] = val(t)
    got = []
    jdist.alltoall(per_rank(chunks), got, group=g)
    out["alltoall"] = np.stack([val(x) for x in got])
    t = zeros(2, chunks[0].size)
    jdist.alltoall_single(per_rank(chunks.reshape(2, -1)), t, group=g)
    out["alltoall_single"] = val(t)
    jdist.send(paddle.to_tensor(vals[0]), dst=1, group=g)
    t = zeros(vals.shape[-1])
    jdist.recv(t, src=0, group=g)
    out["recv"] = val(t)
    return out


def _jax_hcg(rank, dims=(2, 1, 1, 1, 1, 1)):
    topo = jtopology.CommunicateTopology(NAMES, list(dims))
    h = jtopology.HybridCommunicateGroup(topo, global_rank=rank)
    return {
        "coords": [h.get_data_parallel_rank(), h.get_stage_id(),
                   h.get_sharding_parallel_rank(), h.get_sep_parallel_rank(),
                   h.get_expert_parallel_rank(), h.get_model_parallel_rank()],
        "groups": {a: g.ranks for a, g in h._groups.items()},
        "axis_sizes": h.axis_sizes(),
        "mode": h.get_parallel_mode(),
        "comm_lists": {n: topo.get_comm_list(n) for n in NAMES},
        "dp_world": h.get_data_parallel_world_size(),
        "ep": [h.get_expert_parallel_rank(),
               h.get_expert_parallel_world_size(),
               h.get_expert_parallel_group().ranks],
        "mesh_shape": tuple(h.get_mesh().devices.shape),
    }


def test_collectives_topology_and_data_match_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((2, 4)).astype(np.float32)
    chunks = rng.standard_normal((2, 2, 3)).astype(np.float32)
    scatter = rng.standard_normal((2, 4)).astype(np.float32)
    jm, params = _jax_model()
    x, _ = _batches()
    paths = _token_shards(tmp_path)
    torch.save({"vals": torch.from_numpy(vals),
                "chunks": torch.from_numpy(chunks),
                "scatter": torch.from_numpy(scatter), "params": params,
                "x": torch.from_numpy(x), "paths": paths, "eos": EOS},
               tmp_path / "inputs.pt")
    with R.Ranks("collectives", tmp_path) as ranks:
        want = _jax_collectives(vals, chunks, scatter)
        hcgs = [_jax_hcg(r) for r in range(2)]
        ep_hcgs = [_jax_hcg(r, (1, 1, 1, 1, 2, 1)) for r in range(2)]
        _reset_jax_world()
        # the GPT-MoE step's first loss at dp 2 is one process's
        moe = GPTForCausalLM(GPTConfig(**{**R.TINY, "moe_num_experts": 4,
                                          "moe_every_k": 2}), device="cpu")
        xm = torch.from_numpy(x[0])
        with torch.no_grad():
            moe_loss = moe.forward_with_loss(xm, torch.roll(xm, -1, 1))
        batches = []
        for r in range(2):
            it = iter(j_pipeline(paths, 2, 24, eos_id=EOS, seed=4,
                                 process_index=r, process_count=2,
                                 shuffle_records=True, device_feed=False))
            batches.append([next(it) for _ in range(3)])
        outs = ranks.results()
    for r, out in enumerate(outs):
        assert (out["rank"], out["world"], out["backend"]) == (r, 2, "GLOO")
        for name, ref in want.items():
            if name == "recv" and r == 0:
                continue
            got = out[name].numpy()
            ref_r = ref if name == "recv" else ref[r]
            assert got.shape == ref_r.shape and np.array_equal(got, ref_r), \
                (name, r, got, ref_r)
        assert out["all_gather_object"] == [0, 1]
        assert out["broadcast_object_list"] == ["from 1"]
        # fleet.init at pp 2 builds the pp group; sep raises naming A5.7
        assert out["refuse_pp_degree"] == "did not raise"
        assert out["pp_hcg"] == [[0, 1], r, r == 0, r == 1, 2]
        assert "NotImplementedError" in out["refuse_sep_degree"] \
            and "A5.7" in out["refuse_sep_degree"], out["refuse_sep_degree"]
        assert abs(out["moe_loss"] - float(moe_loss)) <= ROUNDING, (
            out["moe_loss"], float(moe_loss))
        assert out["refuse_rows"].startswith("ValueError") \
            and "rows" in out["refuse_rows"], out["refuse_rows"]

        for key, refs in (("hcg", hcgs), ("ep_hcg", ep_hcgs)):
            ref = dict(refs[r])
            got = dict(out[key])
            assert tuple(np.shape(got.pop("mesh"))) == ref.pop("mesh_shape")
            assert got == ref, key

        for jb, b in zip(batches[r], out["batches"]):
            assert set(jb) == set(b)
            for k in jb:
                assert str(np.asarray(jb[k]).dtype) == str(b[k].numpy().dtype)
                assert np.array_equal(np.asarray(jb[k]), b[k].numpy()), k
    assert not all(torch.equal(outs[0]["batches"][0][k],
                               outs[1]["batches"][0][k])
                   for k in outs[0]["batches"][0])


@pytest.mark.parametrize("dims", [(2, 1, 1, 1), (2, 2, 1, 2), (1, 3, 2, 1),
                                  (4, 1, 2, 1)])
def test_topology_matches_the_reference(dims):
    names = ["data", "pipe", "sharding", "model"]
    j = jtopology.CommunicateTopology(names, dims)
    t = CommunicateTopology(names, dims)
    assert t.world_size() == j.world_size()
    for n in names:
        assert t.get_dim(n) == j.get_dim(n)
        assert t.get_comm_list(n) == j.get_comm_list(n)
        for i in range(t.get_dim(n)):
            assert t.get_axis_list(n, i) == j.get_axis_list(n, i)
    for r in range(t.world_size()):
        c = t.get_coord(r)
        assert c == j.get_coord(r)
        assert t.get_rank(**dict(zip(names, c))) == r


# ---------------- the dp step ---------------------------------------------
def test_dp_step_matches_the_reference(tmp_path):
    _, params = _jax_model()  # the JAX step consumes its model's arrays
    xs, ys = _batches()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("dp_step", tmp_path) as ranks:
        jsteps, jlosses = {}, {}
        for name, accum in (("plain", None), ("accum", 2)):
            jsteps[name] = _jax_step(_jax_model()[0], accum=accum)
            jlosses[name] = [float(jsteps[name](xs[k], ys[k]))
                             for k in range(STEPS)]
        # the scaler: rank 1's scale is infinite, so step 1 overflows
        # there and both ranks skip it; JAX: an infinite scale on the
        # global batch. Then 2 steps at 2^10 on both sides
        jsc = _jax_step(_jax_model()[0], scaler=paddle.amp.GradScaler(
            init_loss_scaling=float("inf"), incr_every_n_steps=2))
        assert not np.isfinite(float(jsc(xs[0], ys[0])))
        jauto = [tuple(float(v) for v in jsc.scaler_state)]
        jsc.scaler_state = (jnp.float32(2.0 ** 10), *jsc.scaler_state[1:])
        jlosses["scaler"] = []
        for k in (1, 2):
            jlosses["scaler"].append(float(jsc(xs[k], ys[k])))
            jauto.append(tuple(float(v) for v in jsc.scaler_state))
        # one port process on the global batch
        tm = GPTForCausalLM(GPTConfig(**R.TINY), device="cpu")
        tm.load_state_dict(params)
        tstep = make_sharded_train_step(tm, AdamW(
            learning_rate=R.LR, epsilon=R.EPS,
            parameters=tm.named_parameters(), weight_decay=0.01,
            grad_clip=ClipGradByGlobalNorm(R.CLIP)), device="cpu")
        one = [tstep(xs[k], ys[k]).item() for k in range(STEPS)]
        # the global batch's gradients, for the ranks' averaged ones
        gm = GPTForCausalLM(GPTConfig(**R.TINY), device="cpu")
        gm.load_state_dict(params)
        gm.train()
        gm.forward_with_loss(torch.from_numpy(xs[0]),
                             torch.from_numpy(ys[0])).backward()
        outs = ranks.results()

    for name in ("plain", "accum"):
        jstep, want = jsteps[name], jlosses[name]
        for out in outs:
            got = out[name]["losses"]
            assert np.abs(np.array(want) - np.array(got)).max() <= LOSS_TOL
            _assert_trajectory(jstep.params, out[name]["params"][-1], STEPS)
        for a, b in zip(outs[0][name]["params"], outs[1][name]["params"]):
            assert all(torch.equal(a[k], b[k]) for k in a), name

    # without fleet.init the whole world is the dp axis, for a bare model
    # and for one in DataParallel: the same reduction as fleet's dp group
    for out in outs:
        for name in ("world", "wrapped"):
            assert out[name]["losses"] == out["plain"]["losses"], name
            for a, b in zip(out[name]["params"], out["plain"]["params"]):
                assert all(torch.equal(a[k], b[k]) for k in a), name

    # the averaged gradients (no clip) are the global batch's: a sum in
    # place of the average, or a double division, is off by 2x
    for out in outs:
        for k, p in gm.named_parameters():
            assert float((out["grads"][k] - p.grad).abs().max()) \
                <= ROUNDING, k

    assert np.abs(np.array(one) - np.array(outs[0]["plain"]["losses"])
                  ).max() <= ROUNDING
    _assert_trajectory({k: p.detach() for k, p in tm.named_parameters()},
                       outs[0]["plain"]["params"][-1], STEPS, tol=ROUNDING)

    p0 = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    for r, out in enumerate(outs):
        rec = out["scaler"]
        assert not np.isfinite(rec["first_loss"])
        assert all(torch.equal(p0[k], rec["skipped"][k]) for k in p0)
        assert rec["automaton"][0][1:] == jauto[0][1:]
        assert rec["automaton"][0][0] == (jauto[0][0] if r else 2.0 ** 9)
        assert rec["automaton"][1:] == jauto[1:]
        assert np.abs(np.array(jlosses["scaler"]) - np.array(rec["losses"])
                      ).max() <= LOSS_TOL
        _assert_trajectory(jsc.params, rec["params"], 2)
    a, b = outs[0]["scaler"], outs[1]["scaler"]
    for key in ("skipped", "params"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
    for n in a["state"]:
        assert all(torch.equal(a["state"][n][k], b["state"][n][k])
                   for k in a["state"][n])

    # the same rows on both ranks draw different dropout masks
    m0, m1 = outs[0]["dropout_mask"], outs[1]["dropout_mask"]
    assert m0.shape == m1.shape and not torch.equal(m0, m1)


# ---------------- the checkpoint ------------------------------------------
def test_two_rank_checkpoint_crosses_bitwise(tmp_path):
    jm, params = _jax_model()
    xs, ys = _batches()
    jstep = _jax_step(jm, mesh=False)
    for k in range(2):
        jstep(xs[k], ys[k])
    jtree = jstep.state_for_checkpoint().to_tree()
    mgr = jckpt.CheckpointManager(str(tmp_path / "jax_ck"), async_=False)
    mgr.save(2, jtree)
    mgr.close()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("ckpt", tmp_path, launcher=True) as ranks:
        outs = ranks.results()

    assert not list((tmp_path / "port_ck").rglob("manifest.part*"))
    back = jckpt.CheckpointManager(str(tmp_path / "port_ck")).restore()
    assert int(back["step"]) == 2
    for out in outs:
        _assert_state_bitwise(back, out["saved"])
        _assert_state_bitwise(jax.tree_util.tree_map(np.asarray, jtree),
                              out["restored"])
        assert out["restored_step"] == 2


def test_merge_manifests_matches_the_reference(tmp_path):
    """Rank 0's part holds every shard, rank 1's none (the replica-0
    rule), a third part one shard of another array: the port's merge is
    the JAX package's."""
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones(3, np.int32)}
    part0 = tarrays.save_tree(str(tmp_path), tree, step=1, manifest_name="")
    part1 = {**part0, "bytes_written": 0,
             "arrays": {k: {**e, "shards": []}
                        for k, e in part0["arrays"].items()}}
    extra = {**part0["arrays"]["w"], "shards": [
        {**part0["arrays"]["w"]["shards"][0], "file": "x.o1_0.bin"}]}
    part2 = {**part1, "bytes_written": 24, "arrays": {"w": extra, "v": extra}}
    parts = [part0, part1, part2]
    assert tarrays.merge_manifests(parts) == jarrays.merge_manifests(parts)
    merged = tarrays.merge_manifests(parts)
    assert len(merged["arrays"]["w"]["shards"]) == 2
    assert merged["bytes_written"] == part0["bytes_written"] + 24
