"""The port's pipeline parallelism (ROADMAP A5.6) against the JAX package,
on the CPU.

The pure parts run in one process: the schedule tables and stacking
helpers equal the JAX package's functions over a grid of (pp, v, M), and
every rank's action list of every schedule matches each send with its
receive, in order, with each cell's input made before it runs.

The ranks run as gloo processes (``test_torch_dist_ranks.Ranks``, the
``pp2`` and ``pp4`` jobs of ``tests/torch_dist_jobs.py``, at most 60 s),
one test per spawn, each computing its JAX references on
``tests/conftest.py``'s 8-device CPU mesh while its ranks run (each JAX
configuration once; a module fixture would run again on every xdist
worker that takes one of its tests). The model is the tiny GPT at 4
blocks (GQA 4/2, fp32, random weights of std 0.2), AdamW with the global-
norm clip, 3 steps on 8 x 16 token batches; tolerances are
``tests/test_torch_distributed.py``'s: losses within ``LOSS_TOL`` (1e-5),
every parameter, the stages' joined by ``to_paddle_tpu``, within
``PARAM_TOL`` (3e-5) after the steps (the K third of each qkv bias, whose
true gradient is zero, within Adam's bound). The JAX step gives the same
numbers under every schedule, so the port's gpipe, no-remat and
``virtual_pp_degree=2`` runs are held to the one JAX pp-2 reference and
bitwise to the port's own 1f1b run.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.meta_parallel import \
    pipeline_parallel as jpp
from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as jpl
from paddle_tpu.distributed.fleet.meta_parallel.sharding import \
    group_sharded_parallel as j_group_sharded_parallel
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.distributed import DeviceMesh, fleet
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    pipeline_parallel as tpp
from paddle_tpu_torch.distributed.fleet.meta_parallel import pp_layers as tpl
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM, GPT_TINY
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import to_paddle_tpu

import test_torch_dist_ranks as R
from test_torch_distributed import LOSS_TOL, PARAM_TOL, _reset_jax_world
from test_torch_moe import _params

STEPS = 3
GRID = [(pp, v, M) for pp in (2, 4) for v in (1, 2) for M in (pp, 2 * pp,
                                                              4 * pp)]
SCHEDULES = ("gpipe", "1f1b", "interleaved", "interleaved_1f1b")


# ---------------- the pure parts, one process -------------------------------
@pytest.mark.parametrize("pp,v,M", GRID)
def test_tables_and_stacking_match_the_reference(pp, v, M):
    """``_chunk_order``, ``_simulate_interleaved_ticks``,
    ``_interleaved_1f1b_tables`` and ``stack_block_params``/
    ``unstack_block_params`` (numpy and torch) equal the JAX package's."""
    L = pp * v * 2
    assert tpp._chunk_order(L, pp, v) == jpp._chunk_order(L, pp, v)
    assert tpp._simulate_interleaved_ticks(pp, v, M) == \
        jpp._simulate_interleaved_ticks(pp, v, M)
    assert tpp._interleaved_1f1b_tables(pp, v, M) == \
        jpp._interleaved_1f1b_tables(pp, v, M)
    rng = np.random.default_rng(pp * 100 + v * 10 + M)
    flat = {f"gpt.layers.{i}.{s}": rng.standard_normal(shape).astype(
        np.float32) for i in range(L) for s, shape in (("w", (3, 2)),
                                                       ("b", (2,)))}
    flat["gpt.final_ln.weight"] = np.ones(4, np.float32)
    tspec = tpp.PipelineSpec("gpt.layers", L, None, None, None)
    jspec = jpp.PipelineSpec("gpt.layers", L, None, None, None)
    t_st, t_other = tpp.stack_block_params(flat, tspec, pp, v)
    j_st, j_other = jpp.stack_block_params(flat, jspec, pp, v)
    assert set(t_other) == set(j_other) == {"gpt.final_ln.weight"}
    for k in j_st:
        assert np.array_equal(t_st[k], np.asarray(j_st[k])), k
    back = tpp.unstack_block_params(t_st, tspec, pp, v)
    for k, a in back.items():
        assert np.array_equal(a, flat[k]), k
    tt, _ = tpp.stack_block_params({k: torch.from_numpy(a) for k, a in
                                    flat.items()}, tspec, pp, v)
    assert all(isinstance(a, torch.Tensor) and np.array_equal(
        a.numpy(), t_st[k]) for k, a in tt.items())
    if v > 1:
        with pytest.raises(ValueError, match="not divisible"):
            tpp.stack_block_params(flat, tspec, pp + 1, v)


@pytest.mark.parametrize("seg", ["uniform", "layer:PLLinear"])
def test_segment_bounds_match_the_reference(seg):
    """``SegmentLayers`` cuts the same bounds as the JAX package's."""
    class PLLinear:  # noqa: N801 (named as the descs' class)
        pass

    descs = [type("D", (), {"layer_cls": c})() for c in
             (PLLinear, int, PLLinear, PLLinear, float, PLLinear, PLLinear)]
    for parts in (2, 3, 4):
        assert tpl.SegmentLayers(descs, parts, seg).do_segment() == \
            jpl.SegmentLayers(descs, parts, seg).do_segment()


def _rank_actions(ticks, n, nv, d):
    """Device ``d``'s actions, in order: ``("F"|"B", cell)``, then the
    tick's ``("send"|"recv", peer, tag, cell, tick)`` transfers as the
    engine posts them (``_messages``' order)."""
    out = []
    for t, row in enumerate(ticks):
        f, b = row[d]
        if f is not None:
            out.append(("F", f))
        if b is not None:
            out.append(("B", b))
        for src, dst, tag, cell in tpp._messages(row, n, nv):
            if src == d:
                out.append(("send", dst, tag, cell, t))
            elif dst == d:
                out.append(("recv", src, tag, cell, t))
    return out


def _ticks(kind, n, v, M):
    if kind == "gpipe":
        return tpp._gpipe_ticks(n, M)
    if kind == "1f1b":
        return tpp._1f1b_ticks(n, M)
    return tpp._interleaved_ticks(n, v, M, combined=kind.endswith("1f1b"))


@pytest.mark.parametrize("kind,pp,v,M", [
    (k, pp, v, M) for k in SCHEDULES for pp, v, M in GRID
    if v == 1 or k.startswith("interleaved")])
def test_schedules_are_free_of_deadlock(kind, pp, v, M):
    """Each rank's action list, run tick by tick with every transfer of a
    tick posted together: each send meets its receive at the same tick and
    in the same order on both sides, each cell's input was made at an
    earlier tick, every cell runs forward once and backward once after
    it, each chunk's backward cells run in microbatch order, and 1F1B
    keeps at most ``pp - d`` microbatches in flight on device ``d``."""
    nv = pp * v
    ticks = _ticks(kind, pp, v, M)
    acts = [_rank_actions(ticks, pp, nv, d) for d in range(pp)]
    made = {}  # (kind, cell) -> tick its input was made
    fwd, bwd = {}, {}
    for t, row in enumerate(ticks):
        for d, (f, b) in enumerate(row):
            for kind_, cell, seen in (("F", f, fwd), ("B", b, bwd)):
                if cell is None:
                    continue
                assert cell[1] % pp == d and cell not in seen
                seen[cell] = t
                need = None
                if kind_ == "F" and cell[1] > 0:
                    need = ("act", cell)
                if kind_ == "B" and cell[1] < nv - 1:
                    need = ("grad", cell)
                if need is not None:
                    assert made.get(need, t) < t, (kind_, cell, t)
                if kind_ == "B":
                    assert fwd[cell] <= t
        for src, dst, tag, cell in tpp._messages(row, pp, nv):
            made[("act" if tag == tpp._ACT else "grad", cell)] = t
    cells = {(m, c) for m in range(M) for c in range(nv)}
    assert set(fwd) == set(bwd) == cells
    for c in range(nv):
        order = sorted(range(M), key=lambda m: bwd[(m, c)])
        assert order == list(range(M)), c
    # every send has its receive, in the same order, at the same tick
    for d in range(pp):
        for e in range(pp):
            sent = [a[2:] for a in acts[d] if a[0] == "send" and a[1] == e]
            got = [a[2:] for a in acts[e] if a[0] == "recv" and a[1] == d]
            assert sent == got, (d, e)
    if kind == "1f1b":
        for d in range(pp):
            live = peak = 0
            for a in acts[d]:
                live += {"F": 1, "B": -1}.get(a[0], 0)
                peak = max(peak, live)
            assert peak <= pp - d, (d, peak)


@pytest.mark.parametrize("kind,pp,v,M", [
    (k, pp, v, M) for k in SCHEDULES for pp, v, M in GRID
    if v == 1 or k.startswith("interleaved")])
def test_forward_only_schedules_are_free_of_deadlock(kind, pp, v, M):
    """A run without a loss takes each table's forward cells alone
    (``_forward_only``): every cell runs forward once, each device's in
    the table's order, after its input was made; each send meets its
    receive at the same tick and in the same order on both sides."""
    nv = pp * v
    full = _ticks(kind, pp, v, M)
    ticks = tpp._forward_only(full, pp, nv)
    made, fwd = {}, {}
    for t, row in enumerate(ticks):
        for d, (f, b) in enumerate(row):
            assert b is None
            if f is None:
                continue
            assert f[1] % pp == d and f not in fwd
            fwd[f] = t
            if f[1] > 0:
                assert made.get(f, t) < t, (f, t)
        for src, dst, tag, cell in tpp._messages(row, pp, nv):
            assert tag == tpp._ACT
            made[cell] = t
    assert set(fwd) == {(m, c) for m in range(M) for c in range(nv)}
    for d in range(pp):
        order = [row[d][0] for row in full if row[d][0] is not None]
        assert sorted((c for c in fwd if c[1] % pp == d),
                      key=fwd.get) == order
        for e in range(pp):
            sent = [a[2:] for a in _rank_actions(ticks, pp, nv, d)
                    if a[0] == "send" and a[1] == e]
            got = [a[2:] for a in _rank_actions(ticks, pp, nv, e)
                   if a[0] == "recv" and a[1] == d]
            assert sent == got, (d, e)


@pytest.mark.parametrize("v", [1, 2])
def test_weights_read_the_stacked_names(v):
    """``from_paddle_tpu`` reads the JAX pp step's stacked names (saved at
    ``virtual_pp_degree``) as the flat ones: each stage's blocks bitwise
    equal, and the stages joined by ``to_paddle_tpu`` the whole model."""
    from paddle_tpu_torch.weights import from_paddle_tpu

    _, params = _jax_gpt()
    stacked, other = jpp.stack_block_params(
        params, jpp.PipelineSpec("gpt.layers", 4, None, None, None), 2, v)
    named = {**other, **{f"gpt.layers.__stacked__.{k}": a
                         for k, a in stacked.items()}}
    stages = []
    for r in range(2):
        kw = dict(pp_rank=r, pp_degree=2, virtual_pp_degree=v)
        got, want = from_paddle_tpu(named, **kw), from_paddle_tpu(params,
                                                                   **kw)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        layers = {int(k.split(".")[2]) for k in got
                  if k.startswith("gpt.layers.")}
        assert layers == ({r, r + 2} if v == 2 else {2 * r, 2 * r + 1})
        stages.append(got)
    whole = to_paddle_tpu(stages, pp_degree=2)
    assert set(whole) == set(params)
    assert all(np.array_equal(whole[k].numpy(), params[k]) for k in params)


def test_a_model_without_pipeline_spec_raises():
    """At a pp axis above 1 a model without ``pipeline_spec`` raises the
    JAX package's ValueError; a bad ``pp_schedule`` raises its
    ValueError."""
    lin = torch.nn.Linear(4, 4)
    opt = AdamW(parameters=lin.named_parameters())
    mesh = DeviceMesh(np.arange(2), ("pp",))
    with pytest.raises(ValueError, match="pipeline_spec"):
        fleet.make_sharded_train_step(lin, opt, mesh=mesh, device="cpu")
    model = GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu")
    with pytest.raises(ValueError, match="pp_schedule"):
        fleet.make_sharded_train_step(
            model, AdamW(parameters=model.named_parameters()), mesh=mesh,
            pp_schedule="zb", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        fleet.make_sharded_train_step(
            model, AdamW(parameters=model.named_parameters()),
            mesh=DeviceMesh(np.arange(4), ("pp",)), virtual_pp_degree=2,
            device="cpu")


@pytest.mark.parametrize("case", [
    ((2, 2, 64, 128), {"pp": 2}, ["pp"], {"x": 2}, [None]),
    ((2, 2, 64, 128), {"pp": 2}, ["pp"], {"pp": 2}, [None, "pp"]),
    ((2, 2, 64, 128), {"pp": 2, "mp": 2}, ["pp", None, None, "mp"],
     {"pp": 2, "sharding": 2}, ["pp", None, "sharding"]),
    ((2, 2, 2, 64), {"dp": 2, "pp": 2}, ["pp"], {"pp": 2, "dp": 2},
     ["pp", "dp"]),
])
def test_stacked_moves_plan_as_the_reference(case):
    """A stacked block leaf placed over ``pp`` moves by the JAX planner's
    plans (to one rank, across its own axis, onto mp and sharding)."""
    from paddle_tpu.distributed.resharding import planner as jplanner
    from paddle_tpu.distributed.resharding import spec as jspec
    from paddle_tpu_torch.distributed import resharding as rs

    shape, sa, ss, da, ds = case

    def specs(mod):
        return (mod.ShardingSpec.make(mod.MeshSpec.make(sa), ss, len(shape)),
                mod.ShardingSpec.make(mod.MeshSpec.make(da), ds, len(shape)))

    want = jplanner.plan_reshard(shape, 4, *specs(jspec))
    got = rs.plan_reshard(shape, 4, *specs(rs))
    assert rs.plan_as_dict(got) == jplanner.plan_as_dict(want)
    assert rs.plan_sends(got) == jplanner.plan_sends(want)


def test_a_leaf_over_pp_writes_one_box_a_rank():
    """A stacked leaf placed ``P("pp", None)`` is written by every stage
    (each its own block); over dp x pp by dp coordinate 0 only."""
    from paddle_tpu_torch.checkpoint.arrays import replica_zero
    from paddle_tpu_torch.distributed import NamedSharding, PartitionSpec

    pp = DeviceMesh(np.arange(2), ("pp",))
    assert [replica_zero(NamedSharding(pp, PartitionSpec("pp", None)), r)
            for r in range(2)] == [True, True]
    dp_pp = DeviceMesh(np.arange(4).reshape(2, 2), ("dp", "pp"))
    assert [replica_zero(NamedSharding(dp_pp, PartitionSpec("pp", None)), r)
            for r in range(4)] == [True, True, False, False]


# ---------------- the ranks ---------------------------------------------------
def _jax_gpt(**over):
    paddle.seed(0)
    jm = jgpt.gpt_tiny(**{"num_kv_heads": 2, "dropout": 0.0, "num_layers": 4,
                          **over})
    return jm, _params(jm)


def _jax_moe():
    paddle.seed(0)
    jm = jgpt.gpt_moe_tiny(dropout=0.0, moe_every_k=1, num_layers=2)
    return jm, _params(jm)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_run(jm, mesh, xs, ys, accum=2, level=None, rows=None, save=None):
    """3 JAX steps: the losses and the parameters after them (flat
    names); with ``save``, a checkpoint after step 2 (and ``save.ready``
    once it is written)."""
    _reset_jax_world()
    opt = paddle.optimizer.AdamW(
        learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
    if level is not None:
        j_group_sharded_parallel(jm, opt, level=level)
    step = j_make_step(jm, opt, mesh=mesh, accumulate_steps=accum)
    losses, tree = [], None
    for k in range(STEPS):
        if k == 2 and save is not None:
            tree = step.state_for_checkpoint().to_tree()
            mgr = jckpt.CheckpointManager(str(save), async_=False)
            mgr.save(2, tree)
            mgr.close()
            (save.parent / f"{save.name}.ready").write_text("")
            tree = jax.tree_util.tree_map(np.asarray, tree)
        losses.append(float(step(xs[k], ys[k])))
    step.sync_to_model()
    params = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    return {"losses": losses, "params": params, "tree": tree,
            "stacked": {k: np.asarray(v) for k, v in step.params.items()}}


def _jax_pipeline_layer(x, y):
    """The JAX eager ``PipelineParallel.train_batch`` over the five descs
    at pp 2: the weights before, the losses and the weights after."""
    _reset_jax_world()

    class JHead(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([8, 8])

        def forward(self, h):
            return paddle.matmul(h, self.weight)

    st = jfleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "pp_degree": 2, "sharding_degree": 1,
                         "mp_degree": 1}
    st.pipeline_configs = {"accumulate_steps": 2}
    jfleet.init(is_collective=True, strategy=st)
    paddle.seed(0)
    descs = [jpl.SharedLayerDesc("tied", JHead),
             jpl.LayerDesc(paddle.nn.Linear, 8, 8),
             jpl.LayerDesc(paddle.nn.Tanh),
             jpl.LayerDesc(paddle.nn.Linear, 8, 8),
             jpl.SharedLayerDesc(
                 "tied", JHead, forward_func=lambda layer, h: paddle.matmul(
                     h, layer.weight, transpose_y=True))]
    pl = jpl.PipelineLayer(descs, loss_fn=lambda o, t: ((o - t) ** 2).mean())
    before = {k: np.asarray(v._value) for k, v in pl.state_dict().items()}
    pp = jfleet.distributed_model(pl)
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=pl.parameters())
    losses = [float(pp.train_batch((paddle.to_tensor(x), paddle.to_tensor(y)),
                                   opt)) for _ in range(STEPS)]
    after = {k: np.asarray(v._value) for k, v in pl.state_dict().items()}
    evals = _jax_evals(pp, x, y)
    _reset_jax_world()
    return {"kind": type(pp).__name__, "bounds": pl.segment_bounds,
            "before": before, "losses": losses, "params": after,
            "eval": evals}


def _jax_interleave(x, y):
    """The JAX ``PipelineParallelWithInterleave.train_batch`` over four
    ``Linear(8, 8)`` at pp 2 with 2 virtual stages: the weights before,
    the losses and the weights after."""
    _reset_jax_world()
    st = jfleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "pp_degree": 2, "sharding_degree": 1,
                         "mp_degree": 1}
    st.pipeline_configs = {"accumulate_steps": 2, "virtual_pp_degree": 2}
    jfleet.init(is_collective=True, strategy=st)
    paddle.seed(1)
    pl = jpl.PipelineLayer([jpl.LayerDesc(paddle.nn.Linear, 8, 8)
                            for _ in range(4)],
                           loss_fn=lambda o, t: ((o - t) ** 2).mean())
    before = {k: np.asarray(v._value) for k, v in pl.state_dict().items()}
    pp = jfleet.distributed_model(pl)
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=pl.parameters())
    losses = [float(pp.train_batch((x, y), opt)) for _ in range(STEPS)]
    after = {k: np.asarray(v._value) for k, v in pl.state_dict().items()}
    evals = _jax_evals(pp, x, y)
    _reset_jax_world()
    return {"kind": type(pp).__name__, "before": before, "losses": losses,
            "params": after, "eval": evals}


def _jax_evals(pp, x, y):
    """The JAX ``eval_batch`` with and without ``compute_loss``."""
    return [np.asarray(pp.eval_batch((x, y), compute_loss=c)._value)
            for c in (True, False)]


def _jax_spmd(ws, fx):
    """The JAX ``spmd_pipeline`` of ``tanh(h @ w)`` at pp 2 over chunks
    ``ws[:2]`` (as ``tests/test_distributed.py`` runs it)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP

    def stage_fn(w, h):
        return jax.numpy.tanh(h @ w)

    f = jax.jit(shard_map(
        lambda w, h: jpp.spmd_pipeline(stage_fn, w, h, axis_name="pp",
                                       n_stages=2),
        mesh=_mesh((2,), ("pp",)), in_specs=(JP("pp", None, None),
                                             JP(None, None, None)),
        out_specs=JP(None, None, None), check_vma=False))
    return np.asarray(f(jax.numpy.asarray(ws[:2]), jax.numpy.asarray(fx)))


def _inputs():
    """The weights (numpy, by name) and batches of both spawns."""
    _, params = _jax_gpt()
    _, moe = _jax_moe()
    rs = np.random.RandomState(0)
    xs = rs.randint(0, 128, (STEPS, 8, 16))
    ys = np.roll(xs, -1, axis=2)
    pl = (rs.randn(4, 8).astype(np.float32), rs.randn(4, 8).astype(np.float32))
    fwd = (rs.randn(4, 6, 6).astype(np.float32),
           rs.randn(4, 2, 6).astype(np.float32))
    return params, moe, xs, ys, pl, fwd


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_two_ranks_match_the_reference(tmp_path):
    """The ``pp2`` job (two ranks at pp 2) while the JAX pp-2 step runs at M
    2 (saving at step 2 for the ranks to restore) and M 4, GPT-MoE at pp
    2 and the eager ``PipelineParallel``; then every check of the two
    ranks below."""
    params, moe, xs, ys, (pl_x, pl_y), (fwd_w, fwd_x) = _inputs()
    # the stacked names of a JAX pp-2 step's parameters, as its state holds
    stacked, other = jpp.stack_block_params(
        params, jpp.PipelineSpec("gpt.layers", 4, None, None, None), 2)
    stacked = {**other, **{f"gpt.layers.__stacked__.{k}": v
                           for k, v in stacked.items()}}
    pl_ref = _jax_pipeline_layer(pl_x, pl_y)
    vpp_ref = _jax_interleave(pl_x, pl_y)
    torch.save({"params": _t(params), "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys), "moe_params": _t(moe),
                "stacked": _t(stacked), "pl_params": _t(pl_ref["before"]),
                "vpp_params": _t(vpp_ref["before"]),
                "pl_x": torch.from_numpy(pl_x),
                "pl_y": torch.from_numpy(pl_y),
                "fwd_w": torch.from_numpy(fwd_w),
                "fwd_x": torch.from_numpy(fwd_x)}, tmp_path / "inputs.pt")
    with R.Ranks("pp2", tmp_path) as ranks:
        ref = {"m2": _jax_run(_jax_gpt()[0], _mesh((2,), ("pp",)), xs, ys,
                              save=tmp_path / "jax_ck")}
        ref["m4"] = _jax_run(_jax_gpt()[0], _mesh((2,), ("pp",)), xs, ys,
                             accum=4)
        ref["moe"] = _jax_run(_jax_moe()[0], _mesh((2,), ("pp",)), xs, ys)
        ref["spmd"] = _jax_spmd(fwd_w, fwd_x)
        outs = ranks.results()
    _reset_jax_world()
    ref["pl"], ref["pl_vpp"] = pl_ref, vpp_ref
    _check_topology(outs)
    _check_forwards_alone(ref, outs, fwd_w, fwd_x)
    for run in ("1f1b", "gpipe", "noremat", "vpp2", "from_stacked"):
        _check_pp2(ref, outs, run)
    _check_m4(ref, outs)
    for run in ("moe_1f1b", "moe_gpipe"):
        _check_moe(ref, outs, run)
    _check_dropout(outs)
    _check_infinite_scale(outs)
    _check_port_save(ref, outs, tmp_path)
    _check_reference_save(ref, outs)
    _check_pipeline_layer(ref, outs)
    _check_interleave(ref, outs)


def test_four_ranks_match_the_reference(tmp_path):
    """The ``pp4`` job (four ranks: pp 2 x dp 2, x mp 2, x sharding 2 at
    ``os_g``) while the JAX step runs on the matching meshes; ``p_g_os``
    and an ep axis at pp raise naming A5.6b."""
    params, _, xs, ys, _, _ = _inputs()
    torch.save({"params": _t(params), "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("pp4", tmp_path, world=4) as ranks:
        ref = {"dp": _jax_run(_jax_gpt()[0], _mesh((2, 2), ("dp", "pp")), xs,
                              ys),
               "mp": _jax_run(_jax_gpt()[0], _mesh((2, 2), ("pp", "mp")), xs,
                              ys),
               "sh": _jax_run(_jax_gpt()[0], _mesh((2, 2),
                                                   ("pp", "sharding")),
                              xs, ys, level="os_g")}
        outs = ranks.results()
    _reset_jax_world()
    for run in ("dp", "mp", "sh"):
        _check_composed(ref, outs, run)
    for out in outs:
        for key in ("p_g_os", "ep"):
            assert out[key].startswith("NotImplementedError") \
                and "A5.6b" in out[key], out[key]
            assert out[f"{key}_intact"], key


def _close(want, got, tol=PARAM_TOL, hkv=2, steps=STEPS):
    """Every parameter of ``want`` in ``got`` within ``tol``; each qkv
    bias's K third (true gradient zero) within Adam's bound."""
    assert set(want) == set(got), sorted(set(want) ^ set(got))[:4]
    D, Hq = 16, 4
    for name, w in want.items():
        diff = np.abs(np.asarray(w) - np.asarray(got[name]))
        if name.endswith("attn.qkv.bias"):
            k_part = slice(Hq * D, (Hq + hkv) * D)
            assert float(diff[k_part].max()) <= 2 * steps * R.LR, name
            diff[k_part] = 0
        assert float(diff.max()) <= tol, (name, float(diff.max()))


def _losses_close(want, got):
    assert len(want) == len(got)
    assert max(abs(a - b) for a, b in zip(want, got)) <= LOSS_TOL, (want,
                                                                     got)


def _joined(outs, key, **kw):
    return to_paddle_tpu([o[key]["params"] for o in outs], **kw)


def _check_topology(outs):
    """The pp topology answers as the JAX one; each rank holds its
    stage's blocks only, under their global names, and the non-block
    parameters end bitwise equal on both stages."""
    for r, out in enumerate(outs):
        assert (out["stage"], out["first"], out["last"]) == (r, r == 0,
                                                             r == 1)
        assert out["group"] == [0, 1]
        layers = {int(k.split(".")[2]) for k in out["1f1b"]["params"]
                  if k.startswith("gpt.layers.")}
        assert layers == {2 * r, 2 * r + 1}
    shared = set(outs[0]["1f1b"]["params"]) & set(outs[1]["1f1b"]["params"])
    assert shared == {"gpt.embeddings.word_embeddings.weight",
                      "gpt.embeddings.position_embeddings.weight",
                      "gpt.final_ln.weight", "gpt.final_ln.bias"}
    for k in shared:
        assert torch.equal(outs[0]["1f1b"]["params"][k],
                           outs[1]["1f1b"]["params"][k]), k


def _check_forwards_alone(ref_all, outs, ws, fx):
    """Without a loss every schedule runs its forwards alone: the last
    stage's outputs within 1e-5 of the chunks applied in order (two a
    stage under interleaving), None on stage 0; ``spmd_pipeline``'s on
    both stages within 1e-5 of the JAX one's."""
    def chain(n):
        h = fx
        for w in ws[:n]:
            h = np.tanh(h @ w)
        return h

    for r, out in enumerate(outs):
        for kind in SCHEDULES:
            got = out["fwd"][kind]
            if r == 0:
                assert got is None, kind
                continue
            want = chain(4 if kind.startswith("interleaved") else 2)
            assert float(np.abs(got.numpy() - want).max()) <= 1e-5, kind
        assert float(np.abs(out["fwd"]["spmd"].numpy()
                            - ref_all["spmd"]).max()) <= 1e-5


def _check_evals(ref, out):
    """``eval_batch``'s mean loss and mean output on every rank against
    the JAX ``eval_batch``'s, within ``LOSS_TOL`` and ``PARAM_TOL``."""
    loss, outs = out["eval"]
    assert abs(float(loss) - float(ref["eval"][0])) <= LOSS_TOL
    assert outs.shape == ref["eval"][1].shape
    assert float(np.abs(outs.numpy() - ref["eval"][1]).max()) <= PARAM_TOL


def _check_pp2(ref_all, outs, run):
    """Each schedule's losses and parameters against the JAX pp-2 step
    (M 2); gpipe and no-remat bitwise the port's 1f1b run."""
    ref = ref_all["m2"]
    for out in outs:
        _losses_close(ref["losses"], out[run]["losses"])
    _close(ref["params"], _joined(outs, run, pp_degree=2))
    if run in ("gpipe", "noremat", "from_stacked"):
        for out in outs:
            assert out[run]["losses"] == out["1f1b"]["losses"]
            assert all(torch.equal(v, out["1f1b"]["params"][k])
                       for k, v in out[run]["params"].items()), run


def _check_m4(ref_all, outs):
    ref = ref_all["m4"]
    for out in outs:
        _losses_close(ref["losses"], out["m4"]["losses"])
    _close(ref["params"], _joined(outs, "m4", pp_degree=2))
    # 1F1B holds at most pp - d cells on device d
    assert [o["m4"]["stats"]["peak_stash"] for o in outs] == [2, 1]


def _check_moe(ref_all, outs, run):
    """GPT-MoE with every block MoE at pp 2: the gate's aux term summed
    over the stages and its gradient in each cell's backward."""
    ref = ref_all["moe"]
    for out in outs:
        _losses_close(ref["losses"], out[run]["losses"])
    _close(ref["params"], _joined(outs, run, pp_degree=2), hkv=4)


def _check_dropout(outs):
    """With dropout 0.1 the 1f1b, gpipe and no-remat runs and a repeat are
    bitwise equal, and differ from the run without dropout."""
    for out in outs:
        base = out["drop_1f1b"]
        for name in ("drop_gpipe", "drop_noremat", "drop_again"):
            assert out[name]["losses"] == base["losses"], name
            assert all(torch.equal(v, base["params"][k])
                       for k, v in out[name]["params"].items()), name
        assert base["losses"] != out["1f1b"]["losses"]


def _check_infinite_scale(outs):
    """The non-finite gradients of one stage skip the update on both; a
    finite scale then trains both."""
    for out in outs:
        assert out["inf"]["same"] and out["inf"]["step"] == 1
        assert out["inf"]["good"] == 0 and out["inf"]["moved"]


def _check_port_save(ref_all, outs, directory):
    """A pp-2 save: no tensor collective, each rank's bytes its replica-0
    blocks, the JAX package's stacked names; the JAX ``load_tree`` reads
    every array bitwise as the step holds it, and the third step after
    the save is the JAX run's."""
    ref = ref_all["m2"]
    jnames = sorted(ref["tree"]["params"])
    for out in outs:
        save = out["save"]
        assert save["collectives"] == [] and save["bytes"] == \
            save["expected"], save["collectives"]
        assert save["names"] == jnames
        assert abs(save["third"] - ref["losses"][2]) <= LOSS_TOL
    back = jckpt.load_tree(str(directory / "port_ck" / "step_00000002"))
    gathered = outs[0]["save"]["gathered"]
    for part in ("params", "opt_state"):
        flat_b, flat_g = _flat(back[part]), _flat(gathered[part])
        assert set(flat_b) == set(flat_g), part
        for k, v in flat_g.items():
            assert _bitwise(flat_b[k], v), (part, k)
        assert set(flat_b) == set(_flat(ref["tree"][part])), part


def _check_reference_save(ref_all, outs):
    """The JAX pp-2 save restores into a port step of other weights
    bitwise (each rank reading its stage's rows), and the step it then
    takes is the JAX run's third within ``LOSS_TOL``."""
    ref = ref_all["m2"]
    for out in outs:
        for part in ("params", "opt_state"):
            want, got = _flat(ref["tree"][part]), _flat(out["restored"][part])
            assert set(want) == set(got), part
            for k, v in want.items():
                assert _bitwise(v, got[k]), (part, k)
        assert abs(out["resumed"] - ref["losses"][2]) <= LOSS_TOL


def _check_pipeline_layer(ref_all, outs):
    """``fleet.distributed_model(PipelineLayer(...))`` is a
    ``PipelineParallel``; ``train_batch`` over each rank's segment (the
    tied head on both stages, its gradient summed over them) gives the JAX
    ``train_batch``'s losses and weights, and ``eval_batch`` its
    ``eval_batch``'s."""
    ref = ref_all["pl"]
    assert ref["kind"] == "PipelineParallel"
    assert outs[0]["pl"]["names"] == ["0.weight", "1.bias", "1.weight"]
    assert outs[1]["pl"]["names"] == ["0.weight", "3.bias", "3.weight"]
    for out in outs:
        assert out["pl"]["kind"] == ref["kind"]
        assert out["pl"]["bounds"] == ref["bounds"] == [0, 2, 5]
        _losses_close(ref["losses"], out["pl"]["losses"])
        for k, v in out["pl"]["params"].items():
            assert float(np.abs(ref["params"][k] - v.numpy()).max()) \
                <= PARAM_TOL, k
        _check_evals(ref, out["pl"])


def _check_interleave(ref_all, outs):
    """``PipelineParallelWithInterleave.train_batch`` (through the step at
    two virtual stages, each rank building chunks ``r * 2 + stage``) and
    ``eval_batch`` (the interleaved table's forwards) against the JAX
    class's."""
    ref = ref_all["pl_vpp"]
    assert [o["pl_vpp"]["names"] for o in outs] == [
        ["0.bias", "0.weight", "2.bias", "2.weight"],
        ["1.bias", "1.weight", "3.bias", "3.weight"]]
    for out in outs:
        assert out["pl_vpp"]["kind"] == ref["kind"]
        _losses_close(ref["losses"], out["pl_vpp"]["losses"])
        for k, v in out["pl_vpp"]["params"].items():
            assert float(np.abs(ref["params"][k] - v.numpy()).max()) \
                <= PARAM_TOL, k
        _check_evals(ref, out["pl_vpp"])


def _check_composed(ref_all, outs, run):
    """pp 2 x dp 2, pp 2 x mp 2 and pp 2 x sharding 2 (``os_g``) against
    the JAX step on the matching mesh."""
    ref = ref_all[run]
    for out in outs:
        _losses_close(ref["losses"], out[run]["losses"])
    if run == "mp":  # ranks (pp, mp)
        joined = _joined(outs, run, mp_degree=2, pp_degree=2)
    else:
        # dp: ranks (dp, pp), stage s on ranks s and s + 2; sharding:
        # ranks (pp, sharding), stage s on ranks 2s and 2s + 1
        stages = [(0, 2), (1, 3)] if run == "dp" else [(0, 1), (2, 3)]
        joined = to_paddle_tpu([outs[a][run]["params"] for a, _ in stages],
                               pp_degree=2)
        for a, b in stages:  # the replicas end bitwise equal
            assert all(torch.equal(v, outs[b][run]["params"][k]) for k, v
                       in outs[a][run]["params"].items())
    _close(ref["params"], joined)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _bitwise(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()
