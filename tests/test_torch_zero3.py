"""The port's ZeRO stage 3 (``group_sharded_parallel(level="p_g_os")``,
``GroupShardedStage3``) against the JAX package and against the port's
own stage 2, on the CPU.

The port's ranks run as gloo processes started by
``test_torch_dist_ranks.Ranks`` (the jobs of ``tests/torch_dist_jobs.py``,
at most 60 s, then every rank is killed) while the JAX reference computes
on ``tests/conftest.py``'s CPU devices:

- two ranks at sharding 2 on fleet's mesh: each rank's matrices are its
  slices of the whole arrays where the JAX step places their optimizer
  state (``shard_spec_for``'s for the position table, which the JAX
  package slices too), vectors whole; 3 AdamW
  steps with the clip, each rank on its half of every batch, give losses
  within ``LOSS_TOL`` and whole parameters within
  ``tests/test_torch_checkpoint.py``'s trajectory tolerances of the JAX
  step with ``p_g_os`` on its 2-device mesh, and losses and parameters
  bitwise equal to the port's ``os_g`` run, under
  every recompute policy; the bytes of gathered weights alive at once
  never exceed one block's under recompute and one weight's without (at
  most two blocks' under every policy); each weight is reduce-scattered
  once a step (the tied embedding's two uses summed first); the optimizer
  state is slice-shaped; ``state_dict()`` and ``to_paddle_tpu`` give the
  whole arrays; in a second spawn, ``set_state_dict`` takes them, the
  eager ``model(x).mean().backward(); opt.step()`` moves every parameter and
  keeps the ranks' whole arrays equal, and ``save_group_sharded_model``
  writes the whole arrays; with accumulate_steps=2 each microbatch is
  reduce-scattered into the slices, within ``ACCUM_*`` of ``os_g``; a
  two-rank save restores bitwise into a step in one process and into a
  stage-3 step on other weights;
- four ranks at dp 2 x sharding 2: the gradient reducer over both data
  axes, hierarchical and flat, bitwise the JAX reducer's on its (2, 2)
  mesh; ``p_g_os`` with int8 against the JAX step on its 4-device mesh,
  losses and parameters within ``Z4_*``.
"""

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.meta_parallel import sharding as jsharding
from paddle_tpu.distributed.fleet.utils import _state_sharding_like
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.distributed.fleet.utils import resolve_spec as j_resolve
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.framework import io as fio
from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    GroupShardedStage3, group_sharded_parallel)
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    sharding as tsharding
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

import test_torch_dist_ranks as R
from test_torch_comm_opt import (_assert_reducer_runs, _reducer_inputs,
                                 _update_error)
from test_torch_distributed import (LOSS_TOL, _assert_state_bitwise,
                                    _assert_trajectory, _batches,
                                    _jax_model, _reset_jax_world)
from test_torch_tensor_parallel import _jax_run, _jax_step, _mesh

#: the port against the port: p_g_os against os_g on other schedules
#: (``ACCUM_*``). Against the JAX ``p_g_os`` step the losses are held
#: within ``LOSS_TOL`` (1e-5), as every other parity test of this step
#: holds them: the gap is the two packages' fp32 forwards (MKL against
#: XLA, the order of the local means) and is there before stage 3 runs.
#: The port's plain one-process step reads its first loss, before any
#: update, one fp32 ulp (4.77e-07 at 5.8-6.5) below the JAX step's, two
#: ulps at two ranks; the three steps read 9.537e-07 each against the JAX
#: step on one JAX build, and a third ulp on another failed 1e-6. What
#: stage 3 itself computes is held bitwise to the port's os_g run. The
#: parameters are held to the trajectory tolerances (``PARAM_TOL``):
#: AdamW divides each gradient by its own root mean square, so an entry
#: whose gradient is near its tensor's rounding level moves by up to lr
#: on summation order alone (3.3e-6 on the word embedding here, the same
#: as ``os_g``'s)
Z3_TOL = 1e-6
#: p_g_os against os_g, both with accumulate_steps=2: stage 3 reduce-
#: scatters each microbatch's gradient and sums the slices, os_g sums
#: the whole gradients first; largest reading 4.8e-07 on the losses and
#: 2.3e-06 on the parameters
ACCUM_LOSS_TOL, ACCUM_PARAM_TOL = Z3_TOL, 1e-5
#: dp 2 x sharding 2 at p_g_os with int8 against the JAX step over 3
#: steps: largest readings 1.43e-06 on the losses, 7.5e-05 on a parameter
#: (layer 0's qkv weight), 0.0026 as ``_update_error``; the limits are
#: about 7, 4 and 8 times those, and a step that left the parameters as
#: they were would read 1.0 on the last (each moved at least 2.9e-3)
Z4_LOSS_TOL, Z4_PARAM_TOL, Z4_UPDATE_TOL = 1e-5, 3e-4, 0.02


@pytest.fixture(autouse=True)
def _fresh_jax_world():
    _reset_jax_world()
    yield
    _reset_jax_world()


# ---------------- in this process ----------------------------------------
def test_placement_and_options_match_the_reference():
    """``shard_spec_for`` as the JAX package's; one rank's slices are the
    whole matrices; ``offload`` names its item; ``segment_size`` changes
    nothing."""
    for shape in ((128, 64), (64, 256), (3, 8), (5, 7), (64,), (2, 3, 4),
                  (1, 6)):
        for deg in (2, 4):
            assert tuple(tsharding.shard_spec_for(shape, deg)) \
                == tuple(jsharding.shard_spec_for(shape, deg)), (shape, deg)
    m = GPTForCausalLM(GPTConfig(**R.TINY), device="cpu")
    opt = AdamW(parameters=m.named_parameters())
    before = {k: p.detach().clone() for k, p in m.named_parameters()}
    z, opt2, _ = group_sharded_parallel(m, opt, level="p_g_os")
    assert isinstance(z, GroupShardedStage3) and opt2 is opt
    assert sorted(z.z3) == sorted(k for k, v in before.items()
                                  if v.dim() >= 2)
    assert all(torch.equal(before[k], p) for k, p in m.named_parameters())
    assert all(opt._params[k] is p for k, p in m.named_parameters())
    with pytest.raises(NotImplementedError, match="A8"):
        GroupShardedStage3(m, offload=True)
    with pytest.raises(NotImplementedError, match="A8"):
        group_sharded_parallel(m, opt, level="os", offload=True)
    seg = GroupShardedStage3(GPTForCausalLM(GPTConfig(**R.TINY),
                                            device="cpu"), segment_size=7)
    assert sorted(seg.z3) == sorted(z.z3)


@pytest.mark.parametrize("recompute", [False, True])
def test_one_rank_is_the_plain_step(recompute):
    """At one rank (no mesh) ``p_g_os`` is the plain step bit for bit, as
    the card's one-rank NCCL phase holds it: 2 steps' losses and every
    parameter; a gather per use and a reduce-scatter per matrix a step."""
    _, params = _jax_model()
    xs, ys = _batches()
    runs = []
    for level in (None, "p_g_os"):
        m = GPTForCausalLM(GPTConfig(**{**R.TINY,
                                        "use_recompute": recompute}),
                           device="cpu")
        m.load_state_dict(params)
        m.train()
        opt = AdamW(learning_rate=R.LR, epsilon=R.EPS, weight_decay=0.01,
                    parameters=m.named_parameters(),
                    grad_clip=ClipGradByGlobalNorm(R.CLIP))
        if level:
            m, opt, _ = group_sharded_parallel(m, opt, level=level)
        step = make_sharded_train_step(m, opt, device="cpu")
        losses = [step(xs[k], ys[k]).item() for k in range(2)]
        runs.append((losses, R._snapshot(step), m))
    (l0, p0, _), (l1, p1, z) = runs
    assert l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    # a step: 11 gathers in the forward (the tied embedding twice), 8 more
    # in the recomputed forwards (one rank keeps no note to gather again:
    # the slice is the whole), 10 reduce-scatters
    per = 19 if recompute else 11
    assert (z.stats.gathers, z.stats.reduce_scatters) == (2 * per, 2 * 10)


def _z3_inputs(tmp_path):
    _, params = _jax_model()
    xs, ys = _batches()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    return params, xs, ys


def test_zero3_matches_the_reference(tmp_path):
    params, xs, ys = _z3_inputs(tmp_path)
    with R.Ranks("zero3", tmp_path) as ranks:
        jstep = _jax_step(_mesh((2,), ("sharding",)), level="p_g_os")
        jlosses = _jax_run(jstep, xs, ys)
        outs = ranks.results()
    # the placement: where the JAX step puts each matrix's optimizer state
    # on fleet's mesh (its mp axis of one rank); shard_spec_for's for the
    # position table, the one matrix the JAX package slices itself
    jm, _ = _jax_model()
    fmesh = _mesh((1, 1, 2, 1, 1, 1), ("dp", "pp", "sharding", "sep", "ep",
                                       "mp"))
    named = dict(jm.named_parameters())
    for r, out in enumerate(outs):
        for n in params:
            shape, dim = out["placement"][f"_layers.{n}"]
            leaf = np.zeros(tuple(params[n].shape), np.float32)
            place = _state_sharding_like(NamedSharding(fmesh, j_resolve(
                getattr(named[n], "dist_spec", None), fmesh)), leaf, fmesh,
                "sharding")
            want = [i for i, e in enumerate(place.spec) if e == "sharding"]
            d = want[0] if want and leaf.ndim >= 2 else None
            assert dim == d, (n, dim, place.spec)
            if getattr(named[n], "dist_spec", None) is None and d is not None:
                assert list(tsharding.shard_spec_for(leaf.shape, 2)).index(
                    "sharding") == d
            whole = params[n]
            sl = whole if d is None else whole.chunk(2, d)[r]
            assert torch.equal(out["slices"][f"_layers.{n}"], sl), n
        assert out["state_dict_whole"] and out["to_paddle_tpu"]
        og = out["os_g"]
        for pol, rec in out["policies"].items():
            assert rec["losses"] == og["losses"], pol
            assert all(torch.equal(rec["params"][k], og["params"][k])
                       for k in og["params"]), pol
            assert np.abs(np.array(rec["losses"]) - np.array(jlosses)
                          ).max() <= LOSS_TOL, (pol, rec["losses"], jlosses)
            _assert_trajectory(jstep.params, rec["params"], 3)
            gathers, scatters, peak, live = rec["stats"]
            # per step: 10 sliced weights reduce-scattered once each
            assert scatters == 3 * 10 and live == 0, pol
            assert peak <= 2 * out["block_bytes"], (pol, peak)
            if pol == "none":  # one weight at a time
                assert peak <= 256 * 64 * 4, peak
            for name, slots in rec["state_shapes"].items():
                z = out["placement"][f"_layers.{name}"]
                if z[1] is not None:
                    assert all(s == z[0] for s in slots.values()), name


def test_zero3_eager_accumulation_and_checkpoint(tmp_path):
    _z3_inputs(tmp_path)
    with R.Ranks("zero3_state", tmp_path) as ranks:
        outs = ranks.results()
    for out in outs:
        assert out["set_state_dict"]
        acc = out["accum"]
        # 2 microbatches a step, each reduce-scattered into the slices
        assert acc["reduce_scatters"] == 2 * 2 * 10  # 2 steps
        og, z3 = acc["os_g"], acc["p_g_os"]
        assert np.abs(np.array(og["losses"]) - np.array(z3["losses"])
                      ).max() <= ACCUM_LOSS_TOL, (og["losses"], z3["losses"])
        assert all(float((og["params"][k] - z3["params"][k]).abs().max())
                   <= ACCUM_PARAM_TOL for k in og["params"])
        assert out["eager"]["moved"] == out["eager"]["names"]
    a, b = outs[0]["eager"]["whole"], outs[1]["eager"]["whole"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    # save_group_sharded_model writes the whole arrays, and the whole
    # optimizer slots, once
    saved = fio.load(str(tmp_path / "eager.pdparams"))
    assert set(saved) == set(a) and all(
        torch.equal(torch.as_tensor(saved[k]), a[k]) for k in a)
    opt_saved = fio.load(str(tmp_path / "eager.pdopt"))
    want = outs[0]["eager"]["opt_whole"]
    assert set(opt_saved) == set(want)
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(torch.as_tensor(np.asarray(opt_saved[k])),
                               v), k
    for name in a:  # the moments are the whole parameters' shapes
        for slot in ("moment1", "moment2"):
            assert want[f"{name}_{slot}"].shape == a[name].shape, name
    # the two-rank save restores bitwise into a step in one process
    tm = GPTForCausalLM(GPTConfig(**R.TINY), device="cpu")
    one = make_sharded_train_step(tm, AdamW(
        learning_rate=R.LR, epsilon=R.EPS, parameters=tm.named_parameters(),
        weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(R.CLIP)),
        device="cpu")
    one.restore_from_checkpoint(CheckpointManager(
        str(tmp_path / "z3_ck")).restore())
    back = R._tree_copy(one.state_for_checkpoint().to_tree())
    for out in outs:
        _assert_state_bitwise(out["saved"], back)
        # and the global arrays restore into a stage-3 step's slices
        _assert_state_bitwise(out["saved"], out["restored"])


# ---------------- four ranks: dp 2 x sharding 2 ---------------------------
def test_dp_sharding_p_g_os_int8_matches_the_reference(tmp_path):
    _, params = _jax_model()
    xs, ys = _batches()
    red_inp, red_ref = _reducer_inputs(4)
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys), "reducer": red_inp},
               tmp_path / "inputs.pt")
    with R.Ranks("dp_sharding_4", tmp_path, world=4) as ranks:
        st = jfleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
        jfleet.init(is_collective=True, strategy=st)
        jm, _ = _jax_model()
        opt = paddle.optimizer.AdamW(
            learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
            weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
        jfleet.meta_parallel.group_sharded_parallel(jm, opt, level="p_g_os")
        jstep = j_make_step(jm, opt, grad_reduce="int8")
        jlosses = [float(jstep(xs[k], ys[k])) for k in range(3)]
        jred = jstep._reducer
        outs = ranks.results()
    _reset_jax_world()
    _assert_reducer_runs([o["reducer"] for o in outs], red_ref, 4,
                         ("dp", "sharding"), (2, 2))
    assert not jred.two_region and jred.world == 4
    for out in outs:
        assert out["world"] == 4
        assert out["ef_shapes"] == {k: tuple(np.shape(v)) for k, v in
                                    jstep.ef_state.items()}
        # the ranks quantize other sums of the same gradients (rounding
        # apart), so the trajectories agree to int8's noise (see Z4_*)
        got = np.array(out["step"]["losses"])
        pg = {k: float(np.abs(np.asarray(jstep.params[k]) - v.numpy()).max()) for k, v in out["step"]["params"].items()}
        mv = {k: float(np.abs(params[k].numpy() - v.numpy()).max()) for k, v in out["step"]["params"].items()}
        assert np.abs(got - np.array(jlosses)).max() <= Z4_LOSS_TOL, (
            got, jlosses)
        gap = max(float(np.abs(np.asarray(jstep.params[k]) - v.numpy()).max())
                  for k, v in out["step"]["params"].items())
        assert gap <= Z4_PARAM_TOL, gap
        assert _update_error(jstep.params, out["step"]["params"], params) \
            <= Z4_UPDATE_TOL
    # every rank holds the same whole arrays, and the same unsliced
    # parameters after every step
    sliced = set(outs[0]["z3"])
    assert len(sliced) == 10
    for out in outs[1:]:
        assert all(torch.equal(outs[0]["step"]["params"][k], v)
                   for k, v in out["step"]["params"].items())
        for x, y in zip(outs[0]["step"]["replicated"],
                        out["step"]["replicated"]):
            assert all(torch.equal(x[k], y[k]) for k in x if k not in sliced)
