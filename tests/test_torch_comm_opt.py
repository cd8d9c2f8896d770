"""The port's gradient reduction (``paddle_tpu_torch.distributed.comm_opt``,
``kernels/quant.py`` and the train step's ``grad_reduce=``) against the
JAX package, on the CPU.

In this process: the quantizer's payload and scales bit for bit (NaN,
Inf and all-zero blocks included, bf16, ``fit_block_size``), the config's
every alias and the fleet strategy's mapping, and the plans
(``plan_as_dict`` and ``describe``) of the JAX package's leaf tables at
world 2 and 4, hierarchical and flat, and hybrid.

The port's ranks run as gloo processes started by
``test_torch_dist_ranks.Ranks`` (the jobs of ``tests/torch_dist_jobs.py``,
at most 60 s, then every rank is killed) while the JAX reference computes
on ``tests/conftest.py``'s CPU devices:

- the reducer on two ranks: fp32 is bitwise the exact mean on
  integer-valued gradients; int8 with error feedback, several buckets and
  bf16 give reduced gradients and residuals bitwise equal to the JAX
  ``GradReducer``'s (``make_tree_reducer``) on the same per-rank inputs,
  and int8's 12-step drift keeps the JAX test's bound;
- the tiny GPT at dp 2: ``fp32`` bitwise ``None``'s run, int8 within 1%
  of it at every step, bf16 trains; the residuals' keys and shapes and the
  plan equal the JAX step's; a port save replays its next losses
  bitwise; a JAX int8 save, residuals included, continues in the port
  within ``tests/test_torch_checkpoint.py``'s trajectory tolerances;
  ``overlap`` with ``accumulate_steps=2`` is deterministic and within
  2e-3 of reducing once; a skipped step keeps the residuals; a GPT-MoE
  step at dp 2 with the fp32 reduction is the one without, bit for bit,
  and ``MoELayer(group=)`` takes its rank's experts;
- four ranks at dp 2 x mp 2 with int8 against the JAX step on its
  4-device mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.distributed import comm_opt as jco
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.kernels import quant as jquant
from paddle_tpu_torch.distributed import comm_opt as tco
from paddle_tpu_torch.kernels import quant as tquant

import test_torch_dist_ranks as R
from test_torch_distributed import (LOSS_TOL, _assert_trajectory, _bits,
                                    _jax_model, _reset_jax_world)

#: the JAX package's reducer test leaves (tests/test_comm_opt.py)
SHAPES = {"w1": (40, 33), "b1": (33,), "w2": (7, 5, 11)}
#: the GPT runs: batches of 4 rows of 32 tokens
B, S, STEPS = 4, 32, 6
#: dp 2 x mp 2 with int8 against the JAX step over 3 steps: the largest
#: loss gap read 8.1e-05 and the largest update error (below) 0.106, on
#: layer 1's qkv bias; the limits are about 5 and 2.5 times those. A step
#: that left the parameters as they were would read 1.0
MP4_LOSS_TOL, MP4_UPDATE_TOL = 4e-4, 0.25


@pytest.fixture(autouse=True)
def _fresh_jax_world():
    _reset_jax_world()
    yield
    _reset_jax_world()


# ---------------- in this process ----------------------------------------
@pytest.mark.parametrize("block", [128, 64])
def test_quantizer_matches_the_reference_bitwise(block):
    rng = np.random.default_rng(block)
    v = (rng.standard_normal((4, 512)) * 10).astype(np.float32)
    v[0, 3] = np.nan
    v[1, 200] = np.inf
    v[2, 300] = -np.inf
    v[3, :block] = 0.0  # an all-zero block
    v[3, 256:256 + block] = np.arange(block, dtype=np.float32) - block / 2 \
        + 0.5  # halves: round half to even
    q, s = jquant.quantize_block_scaled(jnp.asarray(v), block)
    tq, ts = tquant.quantize_block_scaled(torch.from_numpy(v), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert _bits(np.asarray(q)) == _bits(tq) and _bits(np.asarray(s)) \
        == _bits(ts)
    back = tquant.dequantize_block_scaled(tq, ts, block)
    want = np.asarray(jquant.dequantize_block_scaled(q, s, block))
    assert _bits(want) == _bits(back)
    # a non-finite value poisons its block (the scaler still trips)
    assert torch.isnan(back[0, :block]).all() and not torch.isfinite(
        back[1, 128:256] if block == 128 else back[1, 192:256]).any()
    assert torch.equal(back[3, :block], torch.zeros(block))
    bq, bs = tquant.quantize_block_scaled(torch.from_numpy(v), block, "bf16")
    jq, js = jquant.quantize_block_scaled(jnp.asarray(v), block, "bf16")
    assert bs is None and js is None and bq.dtype == torch.bfloat16
    # bit for bit but a NaN's own bits: PyTorch's CPU cast writes the
    # canonical 0xFFFF, XLA's keeps the sign and the payload's top bits
    jbits = np.asarray(jq).view(np.uint16)
    tbits = bq.view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(v)
    assert np.array_equal(jbits[~nan], tbits[~nan])
    assert torch.isnan(bq.float()).numpy()[nan].all()
    assert tquant.dequantize_block_scaled(bq, None).dtype == torch.float32
    for C in (64, 96, 128, 300, 7):
        assert tquant.fit_block_size(C, block) \
            == jquant.fit_block_size(C, block)
    with pytest.raises(ValueError, match="multiple of block"):
        tquant.quantize_block_scaled(torch.zeros(100), block)
    with pytest.raises(ValueError, match="int8/bf16"):
        tquant.quantize_block_scaled(torch.zeros(128), 128, "int4")


def test_config_matches_the_reference():
    forms = list(jco.config._ALIASES) + ["INT8", "Hierarchical", None]
    forms += [{"mode": "quant", "block_size": 64, "overlap": False},
              {"mode": "fp32", "hierarchical": False,
               "axis_order": ["dp", "sharding"]}]
    for form in forms:
        assert tco.normalize_grad_reduce(form).__dict__ \
            == jco.normalize_grad_reduce(form).__dict__, form
    assert tco.config._ALIASES == jco.config._ALIASES
    assert (tco.DATA_AXES, tco.QUANT_COMPATIBLE_AXES) \
        == (jco.DATA_AXES, jco.QUANT_COMPATIBLE_AXES)
    for bad, err in (("int4", ValueError), ({"mode": "x"}, ValueError),
                     ({"nope": 1}, ValueError), (3, TypeError)):
        with pytest.raises(err):
            jco.normalize_grad_reduce(bad)
        with pytest.raises(err):
            tco.normalize_grad_reduce(bad)
    c = tco.normalize_grad_reduce("int8")
    assert tco.normalize_grad_reduce(c) is c
    for dgc, fp16 in ((True, False), (False, True), (True, True),
                      (False, False)):
        st = type("S", (), {"dgc": dgc, "fp16_allreduce": fp16})()
        assert tco.from_fleet_strategy(st).__dict__ \
            == jco.from_fleet_strategy(st).__dict__
    cfg = tco.GradReduceConfig(mode="quant", axis_order=("dp",))
    for axes in (("dp", "sharding"), ("sharding", "ep", "dp", "mp")):
        assert cfg.resolved_axis_order(axes) == jco.GradReduceConfig(
            mode="quant", axis_order=("dp",)).resolved_axis_order(axes)


_TABLES = {"reducer": SHAPES,
           "split": {"b": (100,), "a": (300, 3), "c": (7, 11)},
           "one": {"w": (1000,)}}


@pytest.mark.parametrize("table", sorted(_TABLES))
@pytest.mark.parametrize("mesh", [{"dp": 2}, {"dp": 4},
                                  {"dp": 2, "sharding": 2}],
                         ids=["dp2", "dp4", "dp2xsharding2"])
def test_plans_match_the_reference(table, mesh):
    leaves = _TABLES[table]
    for kw in ({"mode": "quant"}, {"mode": "quant", "hierarchical": False},
               {"mode": "quant", "bucket_bytes": 4096},
               {"mode": "quant", "dtype": "bf16"}, {"mode": "fp32"},
               {"mode": "fp32", "hierarchical": False}):
        for groups in (None, {"mp": 2}):
            want = jco.build_plan(leaves, mesh, jco.GradReduceConfig(**kw),
                                  group_axes=groups)
            got = tco.build_plan(leaves, mesh, tco.GradReduceConfig(**kw),
                                 group_axes=groups)
            assert tco.plan_as_dict(got) == jco.plan_as_dict(want), kw
            assert tco.describe(got) == jco.describe(want), kw
            assert [(s.name, s.offset) for b in got.buckets
                    for s in b.leaves] == [(s.name, s.offset)
                                           for b in want.buckets
                                           for s in b.leaves]


# ---------------- the reducer on two ranks --------------------------------
def _stacked(seed, integer=False):
    rng = np.random.RandomState(seed)
    g = {k: rng.randn(2, *s).astype(np.float32) for k, s in SHAPES.items()}
    return {k: np.round(v * 4) for k, v in g.items()} if integer else g


#: name: (config, steps, integer-valued inputs)
_CONFIGS = {
    "fp32_hier": ({"mode": "fp32"}, 1, True),
    "fp32_flat": ({"mode": "fp32", "hierarchical": False}, 1, True),
    "int8_ef": ({"mode": "quant"}, 12, False),
    "int8_ef_flat": ({"mode": "quant", "hierarchical": False}, 2, False),
    "multibucket": ({"mode": "quant", "bucket_bytes": 4096}, 2, False),
    "bf16": ({"mode": "quant", "dtype": "bf16", "error_feedback": False},
             1, False),
}


def _jax_reduce(cfg, gstack, steps, devices=2, axes=("dp",), shape=(2,)):
    mesh = Mesh(np.array(jax.devices()[:devices]).reshape(shape), axes)
    templates = {k: (v.shape[1:], np.dtype(np.float32))
                 for k, v in gstack.items()}
    red = jco.reducer_for_step(jco.GradReduceConfig(**cfg), mesh, axes,
                               templates)
    f = jco.make_tree_reducer(red)
    ef = {k: jnp.asarray(v) for k, v in red.init_ef().items()}
    outs = []
    for _ in range(steps):
        out, ef = f({k: jnp.asarray(v) for k, v in gstack.items()}, ef)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return red, outs, {k: np.asarray(v) for k, v in ef.items()}


def _assert_reducer_runs(got, inp, devices, axes, shape):
    """Every configuration's outputs and residuals bitwise the JAX
    reducer's; fp32 the exact mean; int8's drift bounded."""
    g, ints = inp["grads_np"], inp["ints_np"]
    for name, (cfg, steps, integer) in _CONFIGS.items():
        src = ints if integer else g
        red, want, ef = _jax_reduce(cfg, src, steps, devices, axes, shape)
        for out in got:
            rec = out[name]
            assert rec["plan"] == jco.plan_as_dict(red.plan), name
            assert rec["has_ef"] == red.has_ef
            for k in SHAPES:
                for step in range(steps):
                    assert _bits(want[step][k]) == _bits(
                        rec["outs"][step][k]), (name, k, step)
            assert set(rec["ef"]) == set(ef)
            for k in ef:
                assert _bits(ef[k]) == _bits(rec["ef"][k]), (name, k)
        if integer:
            for k in SHAPES:
                exact = src[k].mean(axis=0)
                assert np.array_equal(got[0][name]["outs"][0][k].numpy(),
                                      exact), (name, k)
    # the JAX test's error-feedback drift bound, on the port's outputs
    for k in SHAPES:
        outs = [o[k].numpy() for o in got[0]["int8_ef"]["outs"]]
        exact = g[k].mean(axis=0)
        per_step = np.abs(outs[-1] - exact).max()
        assert per_step < np.abs(g[k]).max() / 40, (k, per_step)
        drift = np.abs(np.sum(outs, axis=0) - 12 * exact).max()
        assert drift < 12 * per_step, (k, drift, per_step)
    assert len(got[0]["multibucket"]["plan"]["buckets"]) > 1


def _reducer_inputs(devices):
    rng = np.random.RandomState(1)
    g = {k: rng.randn(devices, *s).astype(np.float32)
         for k, s in SHAPES.items()}
    ints = {k: np.round(rng.randn(devices, *s) * 4).astype(np.float32)
            for k, s in SHAPES.items()}
    return {"grads": {k: torch.from_numpy(v) for k, v in g.items()},
            "ints": {k: torch.from_numpy(v) for k, v in ints.items()},
            "configs": _CONFIGS}, {"grads_np": g, "ints_np": ints}


def test_reducer_matches_the_reference(tmp_path):
    inp, ref = _reducer_inputs(2)
    torch.save(inp, tmp_path / "inputs.pt")
    with R.Ranks("reducer", tmp_path) as ranks:
        outs = ranks.results()
    _assert_reducer_runs(outs, ref, 2, ("dp",), (2,))


def _update_error(want, got, init):
    """The largest, over the parameters, of ``|got - want| / |want -
    init|`` (Frobenius norms): how far the port's update is from the JAX
    step's, as a share of that update."""
    return max(float(np.linalg.norm(np.asarray(want[k]) - v.numpy())
                     / np.linalg.norm(np.asarray(want[k]) - init[k].numpy()))
               for k, v in got.items())


# ---------------- the train step at dp 2 ----------------------------------
def _gpt_batches(seed=7):
    x = np.random.default_rng(seed).integers(0, 128, (STEPS, B, S))
    return x, np.roll(x, -1, axis=2)


def _jax_int8_step():
    jm, _ = _jax_model()
    opt = paddle.optimizer.AdamW(
        learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
    return j_make_step(jm, opt, mesh=Mesh(np.array(jax.devices()[:2]),
                                          ("dp",)), grad_reduce="int8")


def test_grad_reduce_step_matches_the_reference(tmp_path):
    _, params = _jax_model()
    xs, ys = _gpt_batches()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("grad_reduce", tmp_path) as ranks:
        jstep = _jax_int8_step()
        for k in range(2):
            jstep(xs[k], ys[k])
        jtree = jstep.state_for_checkpoint().to_tree()
        mgr = jckpt.CheckpointManager(str(tmp_path / "jax_ck"),
                                      async_=False)
        mgr.save(2, jtree)
        mgr.close()
        jef = {k: np.asarray(v) for k, v in
               jtree["extra"]["grad_reduce_ef"].items()}
        (tmp_path / "jax_ck.ready").touch()
        jloss = float(jstep(xs[2], ys[2]))
        jplan = jco.plan_as_dict(jstep._reducer.plan)
        outs = ranks.results()

    for out in outs:
        base, fp32 = out["None"], out["fp32"]
        # the explicit fp32 reduction is the step's all-reduce, bit for bit
        assert fp32["losses"] == base["losses"]
        assert all(torch.equal(fp32["params"][k], base["params"][k])
                   for k in base["params"])
        for b, q in zip(base["losses"], out["int8"]["losses"]):
            assert abs(q - b) / abs(b) < 0.01, (b, q)
        assert all(np.isfinite(out["bf16"]["losses"]))
        assert out["bf16"]["losses"][-1] < out["bf16"]["losses"][0]
        assert out["plan"] == jplan and out["stages"] == ["dp"]
        assert {k: tuple(v.shape) for k, v in out["ef"].items()} \
            == {k: v.shape for k, v in jef.items()}
        assert any(float(v.abs().max()) > 0 for v in out["ef"].values())
        assert out["replayed"] == out["continued"]
        a, b = out["replay_params"]
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert abs(out["from_jax"]["losses"][0] - jloss) <= LOSS_TOL
        _assert_trajectory(jstep.params, out["from_jax"]["params"]["params"],
                           3)
        ov = out["overlap"]
        assert ov[0] == ov[1] and ov[0]["per_step"] == 2
        np.testing.assert_allclose(ov[0]["losses"], out["no_overlap"],
                                   rtol=2e-3)
        sc = out["scaler"]
        assert sc["skip_kept_ef"] and not np.isfinite(sc["first"][0])
        assert all(np.isfinite(sc["losses"]))
        # a GPT-MoE step at dp 2: the fp32 reduction is its all-reduce
        plain, red = out["moe_step"]
        assert plain["losses"] == red["losses"]
        assert all(torch.equal(plain["params"][k], red["params"][k])
                   for k in plain["params"])
        assert out["moe_group"] == 4
    # the residuals are each rank's own row; both ranks write the same
    # arrays
    assert all(torch.equal(outs[0]["ef"][k], outs[1]["ef"][k])
               for k in outs[0]["ef"])


# ---------------- four ranks: dp 2 x mp 2 --------------------------------
def test_dp_mp_int8_matches_the_reference(tmp_path):
    from paddle_tpu.distributed import fleet as jfleet

    _, params = _jax_model()
    xs, ys = _gpt_batches()
    xs, ys = xs[:3], ys[:3]
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("dp_mp_4", tmp_path, world=4) as ranks:
        st = jfleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
        jfleet.init(is_collective=True, strategy=st)
        jm, _ = _jax_model()
        opt = paddle.optimizer.AdamW(
            learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
            weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
        jstep = j_make_step(jm, opt, grad_reduce="int8")
        jlosses = [float(jstep(xs[k], ys[k])) for k in range(3)]
        jred = jstep._reducer
        outs = ranks.results()
    assert jred.two_region and jred.groups == 2
    for out in outs:
        assert out["hybrid"] and out["groups"] == 2 and out["world"] == 2
        assert out["plan"] == jco.plan_as_dict(jred.plan)
        assert out["ef_shapes"] == {k: tuple(np.shape(v)) for k, v in
                                    jstep.ef_state.items()}
        # the qkv projection's block is its heads of q, k and v here and a
        # contiguous column range there, so the scale blocks hold other
        # values: the trajectories agree to int8's noise (see MP4_*)
        got = np.array(out["step"]["losses"])
        assert np.abs(got - np.array(jlosses)).max() <= MP4_LOSS_TOL, (
            got, jlosses)
        assert _update_error(jstep.params, out["step"]["params"], params) \
            <= MP4_UPDATE_TOL
    for a, b in ((0, 1), (2, 3)):  # the replicated params within each dp
        assert all(torch.equal(outs[a]["step"]["params"][k],
                               outs[b]["step"]["params"][k])
                   for k in outs[a]["step"]["params"])
    for out in outs[1:]:  # replicas over dp: bitwise
        for x, y in zip(outs[0]["step"]["replicated"],
                        out["step"]["replicated"]):
            assert all(torch.equal(x[k], y[k]) for k in x)
