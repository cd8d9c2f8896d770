"""The port's tensor parallelism and ZeRO against the JAX package, on the
CPU.

The JAX reference runs in this process on ``tests/conftest.py``'s 8-device
CPU mesh; the port runs as gloo ranks started by
``test_torch_dist_ranks.Ranks`` (at most 60 s, then every rank is killed)
from that file, which imports no JAX, while the reference computes. The
three spawns here are all the new tests start:

- mp 2 (two ranks): the topology equals the JAX package's; each
  ``mp_ops`` function's output and gradients on rank r equal slice r of
  the JAX function's under ``shard_map`` (fp32, within ``OPS_TOL``); 3
  AdamW steps of the tiny GPT with ``ClipGradByGlobalNorm`` against the
  JAX ``ShardedTrainStep`` on ``{"mp": 2}``: losses within 1e-5, the
  assembled global parameters within ``tests/test_torch_checkpoint.py``'s
  trajectory tolerances, the replicated parameters bitwise equal on both
  ranks after every step; the same with ``param_specs`` replicating
  layer 0's qkv weight, and with dropout 0.1 (the ranks' losses and
  replicated parameters bitwise equal to each other); what mp leaves to
  later items raises naming it; a two-rank save restores bitwise in the
  JAX package, and a JAX save restores bitwise on both ranks;
- dp 2 x mp 2 (four ranks) against the JAX step on ``{"dp": 2, "mp":
  2}``;
- ZeRO at sharding 2 (two ranks), levels ``os`` and ``os_g``, against the
  JAX step with ``group_sharded_parallel`` on ``{"sharding": 2}``: the
  same tolerances, and each rank's optimizer-state leaves shaped as
  ``_state_sharding_like`` places them; a stage-2 save restores bitwise
  in the JAX package.

The rest runs in this process: the topology at 2 and 2 x 2, the weight
conversion's round trip, the RNG tracker, and the refusals.
"""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.fleet.meta_parallel import (
    group_sharded_parallel as j_group_sharded_parallel)
from paddle_tpu.distributed.fleet.meta_parallel import mp_ops as jmp
from paddle_tpu.distributed.fleet.utils import _state_sharding_like
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.distributed.fleet.utils import resolve_spec as j_resolve
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch.distributed import topology as ttopology
from paddle_tpu_torch.distributed.collective import Group
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    get_rng_state_tracker, model_parallel_random_seed)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import from_paddle_tpu, to_paddle_tpu

import test_torch_dist_ranks as R
from test_torch_distributed import (LOSS_TOL, NAMES, PARAM_TOL,
                                    _assert_state_bitwise,
                                    _assert_trajectory, _batches, _bits,
                                    _jax_model, _reset_jax_world)

#: an mp_ops function's output and gradients on a rank against the JAX
#: function's slice: fp32 sums over 2 ranks' partial products in another
#: order (at most a few ulps of values of order 10)
OPS_TOL = 2e-6
#: parallel CE on bf16 logits against the same logits in fp32: both run
#: in fp32, so they agree to fp32 rounding
BF16_CE_TOL = 1e-6
#: the mp-2 model's served prefill logits against one process's on the
#: same weights: fp32 partial sums over 2 ranks in another order, logits
#: of order 1
SERVING_TOL = 1e-5
QKV = "gpt.layers.0.attn.qkv.weight"


@pytest.fixture(autouse=True)
def _fresh_jax_world():
    _reset_jax_world()
    yield
    _reset_jax_world()


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_step(mesh, level=None, param_specs=None):
    """The JAX step on the tiny GPT over ``mesh``; with ``level``, its
    optimizer marked by ``group_sharded_parallel`` (the step takes the
    marked optimizer and the model itself)."""
    jm, _ = _jax_model()
    opt = paddle.optimizer.AdamW(
        learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
    if level is not None:
        j_group_sharded_parallel(jm, opt, level=level)
    return j_make_step(jm, opt, mesh=mesh, param_specs=param_specs)


def _jax_run(step, xs, ys):
    return [float(step(xs[k], ys[k])) for k in range(xs.shape[0])]


def _jax_hcg(dims, rank):
    topo = jtopology.CommunicateTopology(NAMES, dims)
    h = jtopology.HybridCommunicateGroup(topo, global_rank=rank)
    return {
        "coords": [h.get_data_parallel_rank(), h.get_stage_id(),
                   h.get_sharding_parallel_rank(), h.get_sep_parallel_rank(),
                   h.get_expert_parallel_rank(), h.get_model_parallel_rank()],
        "groups": {a: g.ranks for a, g in h._groups.items()},
        "axis_sizes": h.axis_sizes(),
        "mode": h.get_parallel_mode(),
        "comm_lists": {n: topo.get_comm_list(n) for n in NAMES},
        "mesh": np.arange(topo.world_size()).reshape(
            h.get_mesh().devices.shape).tolist(),
    }


def _assert_hcg(outs, dims):
    for r, out in enumerate(outs):
        assert out["hcg"] == _jax_hcg(dims, r), r
    _reset_jax_world()


def _assert_parity(jstep, jlosses, outs, name, steps):
    """Losses within 1e-5, the global parameters within the trajectory
    tolerances, and on every rank the replicated parameters bitwise equal
    to rank 0's after every step."""
    for out in outs:
        rec = out[name]
        assert np.abs(np.array(jlosses) - np.array(rec["losses"])).max() \
            <= LOSS_TOL, (name, jlosses, rec["losses"])
        _assert_trajectory(jstep.params, rec["params"], steps)
    _assert_replicas(outs, name)


def _assert_replicas(outs, name):
    for out in outs[1:]:
        for a, b in zip(outs[0][name]["replicated"],
                        out[name]["replicated"]):
            assert set(a) == set(b) and all(
                torch.equal(a[k], b[k]) for k in a), name


# ---------------- mp_ops against shard_map --------------------------------
def _mp_ops_cases():
    rng = np.random.default_rng(11)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    labels = rng.integers(0, 16, 6)
    labels[2] = -100  # an ignored row
    return {"x": f32(3, 8), "W1": f32(8, 12), "b1": f32(12), "w1": f32(3, 12),
            "h": f32(3, 12), "W2": f32(12, 8), "b2": f32(8), "w2": f32(3, 8),
            "table": f32(16, 8), "ids": rng.integers(0, 16, (2, 5)),
            "w3": f32(2, 5, 8), "logits": f32(6, 16), "labels": labels,
            "w4": f32(6)}


def _jax_mp_ops(c):
    """Each function's output and gradients on each of 2 ranks, stacked
    ``[2, ...]``: the local loss ``(w * out).sum()`` differentiated
    inside ``shard_map``, as each rank's backward does. ``gather_output``'s
    backward keeps the rank's chunk of the cotangent (the reference's
    ``_c_concat``), so its gradients are those of the ungathered output
    on that chunk. The functions built on ``lax.psum`` (embedding, CE)
    run with ``check_vma``, the custom-VJP ones without, as each gives
    its true gradients."""
    mesh = _mesh((2,), ("mp",))

    def per_rank(fns, in_specs, vma):
        """One ``shard_map`` over every function of ``fns`` (each taking
        its slice of the inputs), returning each one's stacked
        ``(out, grads)``."""
        def body(*a):
            res, i = [], 0
            for fn, n in fns:
                out, grads = fn(*a[i:i + n])
                res.append((out[None], tuple(g[None] for g in grads)))
                i += n
            return tuple(res)
        return jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                                 out_specs=P("mp"), check_vma=vma))

    def col(x, W, b, w, gather):
        def loss(x, W, b):
            out = jmp.column_parallel_linear(x, W, b, "mp")
            return (jmp.c_split(w, "mp") * out if gather else w * out).sum()
        out = jmp.column_parallel_linear(x, W, b, "mp", gather_output=gather)
        return out, jax.grad(loss, argnums=(0, 1, 2))(x, W, b)

    def row(h, W, b, w):
        out = jmp.row_parallel_linear(h, W, b, "mp")
        return out, jax.grad(lambda h, W, b: (
            w * jmp.row_parallel_linear(h, W, b, "mp")).sum(),
            argnums=(0, 1, 2))(h, W, b)

    def emb(t, ids, w):
        out = jmp.vocab_parallel_embedding(ids, t, "mp")
        return out, (jax.grad(lambda t: (
            w * jmp.vocab_parallel_embedding(ids, t, "mp")).sum())(t),)

    def ce(lg, lb, w):
        out = jmp.parallel_cross_entropy(lg, lb, "mp")
        return out, (jax.grad(lambda lg: (
            w * jmp.parallel_cross_entropy(lg, lb, "mp")).sum())(lg),)

    col_p = P(None, "mp")
    linear = per_rank(
        [(lambda *a: col(*a, False), 4), (lambda *a: col(*a, True), 4),
         (row, 4)],
        (P(), col_p, P("mp"), col_p, P(), col_p, P("mp"), P(),
         col_p, P("mp", None), P(), P()), False)(
        c["x"], c["W1"], c["b1"], c["w1"], c["x"], c["W1"], c["b1"],
        c["w1"], c["h"], c["W2"], c["b2"], c["w2"])
    vocab = per_rank([(emb, 3), (ce, 3)],
                     (P("mp", None), P(), P(), col_p, P(), P()), True)(
        c["table"], c["ids"], c["w3"], c["logits"], c["labels"], c["w4"])
    return dict(zip(("col", "col_gather", "row", "emb", "ce"),
                    linear + vocab))


def _assert_mp_ops(want, outs):
    for r, out in enumerate(outs):
        for name, (jout, jgrads) in want.items():
            got = out["mp_ops"][name]
            err = np.abs(np.asarray(jout)[r] - got["out"].numpy()).max()
            assert err <= OPS_TOL, (name, r, err)
            assert len(jgrads) == len(got["grads"]), name
            for i, (jg, g) in enumerate(zip(jgrads, got["grads"])):
                err = np.abs(np.asarray(jg)[r] - g.numpy()).max()
                assert err <= OPS_TOL, (name, r, i, err)
        assert out["ce_bf16_err"] <= BF16_CE_TOL


# ---------------- the spawns ----------------------------------------------
def test_mp_matches_the_reference(tmp_path):
    _, params = _jax_model()
    xs, ys = _batches()
    cases = _mp_ops_cases()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys),
                "mp_ops": {k: torch.from_numpy(v) for k, v in cases.items()}},
               tmp_path / "inputs.pt")
    with R.Ranks("mp", tmp_path) as ranks:
        mesh = _mesh((2,), ("mp",))
        jplain = _jax_step(mesh)
        lplain = _jax_run(jplain, xs[:2], ys[:2])
        # the JAX save after 2 steps, which the ranks restore at the end of
        # their job (numpy copies: the next step donates the arrays)
        jtree = jplain.state_for_checkpoint().to_tree()
        mgr = jckpt.CheckpointManager(str(tmp_path / "jax_ck"), async_=False)
        mgr.save(2, jtree)
        mgr.close()
        jtree = jax.tree_util.tree_map(np.asarray, jtree)
        (tmp_path / "jax_ck.ready").touch()
        lplain += _jax_run(jplain, xs[2:], ys[2:])
        want_ops = _jax_mp_ops(cases)
        jspec = _jax_step(mesh, param_specs={QKV: P()})
        lspec = _jax_run(jspec, xs, ys)
        outs = ranks.results()
    one = GPTForCausalLM(GPTConfig(**R.TINY), device="cpu")
    one.load_state_dict(params)
    with torch.no_grad():
        one_logits = one.prefill_with_cache(torch.from_numpy(
            xs[0][:1, :8]))[0]
    _assert_hcg(outs, [1, 1, 1, 1, 1, 2])
    _assert_mp_ops(want_ops, outs)
    _assert_parity(jplain, lplain, outs, "plain", 3)
    _assert_parity(jspec, lspec, outs, "spec", 3)
    # the replicated qkv weight is a replica too
    assert all(QKV in rep for rep in outs[0]["spec"]["replicated"])
    a, b = outs[0]["dropout"], outs[1]["dropout"]
    assert a["losses"] == b["losses"]
    assert a["losses"] != outs[0]["plain"]["losses"]
    _assert_replicas(outs, "dropout")
    for out in outs:
        # a MoE block at mp holds every expert on every rank (A5.4c;
        # trained against the JAX step in test_torch_moe_mp.py)
        assert out["moe_w1"] == (4, 64, 256), out["moe_w1"]
        # serving at mp (A5.5b): the whole prefill logits, the same bits
        # on both ranks, within summation order of one process's
        assert torch.equal(out["serving"], outs[0]["serving"])
        assert float((out["serving"] - one_logits).abs().max()) \
            <= SERVING_TOL
        assert out["refuse_kv"].startswith("ValueError") \
            and "num_kv_heads" in out["refuse_kv"], out["refuse_kv"]
    back = jckpt.CheckpointManager(str(tmp_path / "port_ck")).restore()
    for r, out in enumerate(outs):
        _assert_state_bitwise(back, out["saved"])
        _assert_state_bitwise(jtree, out["restored"])
        mine = from_paddle_tpu(jtree["params"], mp_rank=r, mp_degree=2)
        assert all(_bits(mine[k]) == _bits(v)
                   for k, v in out["restored_blocks"].items())


def test_dp_mp_matches_the_reference(tmp_path):
    _, params = _jax_model()
    xs, ys = _batches()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("dp_mp", tmp_path, world=4) as ranks:
        jstep = _jax_step(_mesh((2, 2), ("dp", "mp")))
        losses = _jax_run(jstep, xs, ys)
        outs = ranks.results()
    _assert_hcg(outs, [2, 1, 1, 1, 1, 2])
    _assert_parity(jstep, losses, outs, "plain", 3)


def test_zero_matches_the_reference(tmp_path):
    jm, params = _jax_model()
    xs, ys = _batches()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("zero", tmp_path) as ranks:
        mesh = _mesh((2,), ("sharding",))
        jsteps, jlosses = {}, {}
        for level in ("os", "os_g"):
            jsteps[level] = _jax_step(mesh, level=level)
            jlosses[level] = _jax_run(jsteps[level], xs, ys)
        outs = ranks.results()
    _assert_hcg(outs, [1, 1, 2, 1, 1, 1])
    named = dict(jm.named_parameters())
    for level in ("os", "os_g"):
        _assert_parity(jsteps[level], jlosses[level], outs, level, 3)
        for out in outs:
            for name, slots in out[level]["state_shapes"].items():
                spec = j_resolve(getattr(named[name], "dist_spec", None),
                                 mesh)
                leaf = np.zeros(tuple(named[name].shape), np.float32)
                place = _state_sharding_like(NamedSharding(mesh, spec), leaf,
                                             mesh, "sharding")
                want = place.shard_shape(leaf.shape)
                assert all(shape == want for shape in slots.values()), \
                    (level, name, slots, want)
    back = jckpt.CheckpointManager(str(tmp_path / "zero_ck")).restore()
    for out in outs:
        _assert_state_bitwise(back, out["saved"])


# ---------------- in this process -----------------------------------------
@pytest.mark.parametrize("dims", [[1, 1, 1, 1, 1, 2], [1, 1, 2, 1, 1, 1],
                                  [2, 1, 1, 1, 1, 1], [2, 1, 1, 1, 1, 2],
                                  [1, 1, 2, 1, 1, 2], [2, 1, 2, 1, 1, 1]],
                         ids=["mp2", "sharding2", "dp2", "dp2xmp2",
                              "sharding2xmp2", "dp2xsharding2"])
def test_hybrid_topology_matches_the_reference(dims, monkeypatch):
    """Every rank's coordinates, groups, axis sizes, parallel mode and mesh
    at {dp, sharding, mp} degrees of 2 and 2 x 2 equal the JAX package's
    (the groups' process groups are left out: no world is formed here)."""
    from paddle_tpu_torch.distributed import mesh as tmesh

    topo = ttopology.CommunicateTopology(NAMES, dims)
    monkeypatch.setattr(ttopology, "group_of",
                        lambda ranks, mesh, axis, name: Group(
                            ranks, mesh, axis, name=name))
    monkeypatch.setattr(tmesh, "device_count", topo.world_size)
    for r in range(topo.world_size()):
        h = ttopology.HybridCommunicateGroup(topo, global_rank=r)
        got = R._hcg_record(h)
        got["mesh"] = np.asarray(got["mesh"]).tolist()
        assert got == _jax_hcg(dims, r), (dims, r)
    D.destroy_process_group()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_mp_weight_conversion_round_trips(dtype):
    """``from_paddle_tpu`` at mp 2 then ``to_paddle_tpu`` is the identity;
    rank r's qkv block is its heads of each of the q, k and v thirds."""
    jm, params = _jax_model()
    raw = {k: v.numpy() for k, v in params.items()}
    if dtype == "bfloat16":
        raw = {k: np.asarray(jax.numpy.asarray(v, jax.numpy.bfloat16))
               for k, v in raw.items()}
    blocks = [from_paddle_tpu(raw, mp_rank=r, mp_degree=2) for r in (0, 1)]
    back = to_paddle_tpu(blocks)
    whole = from_paddle_tpu(raw)
    assert set(back) == set(whole)
    assert all(back[k].dtype == whole[k].dtype
               and torch.equal(back[k], whole[k]) for k in whole)
    D_, Hq, Hkv = 16, 4, 2
    qkv = whole[QKV]
    q, k, v = qkv[:, :Hq * D_], qkv[:, Hq * D_:(Hq + Hkv) * D_], \
        qkv[:, (Hq + Hkv) * D_:]
    for r in (0, 1):
        want = torch.cat([q[:, r * 32:(r + 1) * 32], k[:, r * 16:(r + 1) * 16],
                          v[:, r * 16:(r + 1) * 16]], 1)
        assert torch.equal(blocks[r][QKV], want)
    assert blocks[1]["gpt.embeddings.word_embeddings.weight"].shape == (64, 64)
    assert torch.equal(blocks[0]["gpt.layers.0.ln1.weight"],
                       whole["gpt.layers.0.ln1.weight"])


def test_rng_tracker_replays_and_advances():
    """As ``tests/test_distributed.py`` holds the JAX tracker: its stream
    advances between regions and reseeding replays it."""
    model_parallel_random_seed(123, device="cpu")
    tracker = get_rng_state_tracker()
    with tracker.rng_state():
        a = torch.randn(4)
    with tracker.rng_state():
        b = torch.randn(4)
    assert not torch.allclose(a, b)
    model_parallel_random_seed(123, device="cpu")
    with get_rng_state_tracker().rng_state():
        a2 = torch.randn(4)
    assert torch.equal(a, a2)
    outside = torch.randn(4)
    model_parallel_random_seed(123, device="cpu")
    assert torch.equal(torch.randn(4), outside)  # the global stream alone
    with pytest.raises(ValueError, match="already exists"):
        tracker.add("other", 123 + 1024)


def test_options_left_out_raise(monkeypatch):
    """Sequence parallelism (A5.7), a spec the port cannot realise (A7)
    and ring attention's ppermute (A5.7) raise naming their items.
    ``MoELayer(group=)`` takes its rank's experts (``E`` is the group's
    size times theirs); ``grad_reduce`` at an ep degree above 1 over its
    expert modules reduces every expert's gradient under its JAX name, as
    the JAX step, which trains there, holds them (A5.4d; trained against
    it in ``test_torch_moe_mp.py``), and refuses experts that are not
    same-shaped ``ExpertMLP``s; a GPT-MoE model built without the step's
    groups (routing its rank's rows alone) cannot join a step at dp 2."""
    from paddle_tpu_torch.distributed.fleet import utils as tutils
    from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertMLP,
                                                                  MoELayer)

    m = GPTForCausalLM(GPTConfig(**R.TINY), device="cpu")
    opt = AdamW(parameters=m.named_parameters())
    layer = MoELayer(64, [torch.nn.Identity()] * 2, group=Group([0, 1]))
    assert layer.num_experts == 4 and layer.gate_weight.shape == (64, 4)
    assert layer.groups.ep.ranks == layer.groups.data.ranks == [0, 1]
    moe = GPTForCausalLM(GPTConfig(**{**R.TINY, "moe_num_experts": 4,
                                      "moe_every_k": 1}), device="cpu")
    # the dp group's two ranks, without a world: the step refuses first
    monkeypatch.setattr(tutils, "group_of", lambda ranks, mesh=None,
                        axis=None, name=None, backend=None: Group(
                            ranks, mesh, axis, name=name))
    net = torch.nn.Sequential(MoELayer(
        64, [ExpertMLP(64, 32, device="cpu") for _ in range(2)],
        group=Group([0, 1])))
    step = tutils.make_sharded_train_step(
        net, AdamW(parameters=net.named_parameters()),
        loss_fn=lambda o, y: o.square().mean(),
        mesh=D.DeviceMesh([0, 1], ("ep",)), grad_reduce="int8",
        device="cpu")
    assert sorted(step._whole_experts) == sorted(
        f"0.expert_{j}.{k}" for j in range(4)
        for k in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"))
    odd = torch.nn.Sequential(MoELayer(
        64, [ExpertMLP(64, 32, device="cpu"),
             ExpertMLP(64, 16, device="cpu")], group=Group([0, 1])))
    with pytest.raises(NotImplementedError, match="A5.4d"):
        tutils.make_sharded_train_step(
            odd, AdamW(parameters=odd.named_parameters()),
            loss_fn=lambda o, y: o.square().mean(),
            mesh=D.DeviceMesh([0, 1], ("ep",)), grad_reduce="int8",
            device="cpu")
    with pytest.raises(ValueError, match="fleet.init"):
        tutils.make_sharded_train_step(
            moe, AdamW(parameters=moe.named_parameters()),
            mesh=D.DeviceMesh([0, 1], ("dp",)), device="cpu")
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="A5.7"):
        GPTConfig(**R.TINY, sequence_parallel=True)
    with pytest.raises(NotImplementedError, match="A5.7"):
        D.ppermute(torch.zeros(2), "mp", [(0, 1)])
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step

    for spec in ({"gpt.layers.0.ln1.weight": D.PartitionSpec("dp")},
                 {QKV: D.PartitionSpec("dp", None)}):
        with pytest.raises(NotImplementedError, match="A7"):
            make_sharded_train_step(m, opt, device="cpu", param_specs=spec)
