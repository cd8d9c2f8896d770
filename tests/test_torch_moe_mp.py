"""GPT-MoE at mp, the explicit gradient reduction at ep, and a
``MoELayer``'s expert modules trained at ep (ROADMAP A5.4c) against the
JAX package, on the CPU.

The port's ranks run as gloo processes (``Ranks``, the ``moe_mp2`` and
``moe_mp4`` jobs of ``tests/torch_dist_jobs.py``, at most 60 s) while the
JAX reference computes on ``tests/conftest.py``'s CPU devices, on the same
weights (``test_torch_moe``'s ``gpt_moe_tiny``: 4 experts, the MoE FFN in
block 1) and batches:

- GPT-MoE at mp 2 (the experts whole on both ranks) and at ep 2 x mp 2,
  3 AdamW steps with the clip, against the JAX step on the matching
  ``(..., "mp")`` mesh;
- ``grad_reduce`` ``"fp32"``, ``"int8"`` and int8 without error feedback
  at ep 2, and fp32 and int8 at dp 2 x ep 2, against the JAX step with
  the same reduction: each rank routes its own rows over the whole
  stacks, as the JAX step's fully-manual region does, so the first loss
  already differs from the unreduced step's; ``moe_dispatch="quant"`` is
  refused there, where the JAX step fails;
- a ``MoELayer(group=)`` with each rank's two experts of four, trained 3
  steps, against the JAX ``MoELayer`` holding all four on the global
  batch: losses, every parameter under the JAX package's checkpoint
  names, and the tree restored into a fresh step;
- the same layer under ``grad_reduce`` ``"fp32"`` and ``"int8"`` at ep 2
  and at dp 2 x ep 2 (A5.4d), against the JAX step with the same
  reduction on the matching ``("dp", "ep")`` mesh, which trains there:
  each device routes its own rows over all four experts.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu_torch.weights import to_paddle_tpu

import test_torch_dist_ranks as R
from test_torch_distributed import LOSS_TOL, PARAM_TOL, _reset_jax_world
from test_torch_expert_parallel import (STEPS, _assert_moe_trajectory,
                                        _batches, _err, _torch_tree)
from test_torch_moe import _jax_model as _moe_jax_model
from test_torch_tensor_parallel import _mesh

#: the int8 reductions against the JAX step's: the same quantizer on
#: gradients equal to fp32 summation order, so a value may cross a
#: rounding boundary of the int8 grid and move its entry by up to lr in
#: the next update; the parameters are held to Adam's bound, 2 * steps *
#: lr, and the losses to 1e-4, the readings being 1.5e-05 at dp 2 x ep 2
#: and below LOSS_TOL at ep 2 (the first loss, before any update, within
#: an fp32 ulp)
INT8_PARAM_TOL, INT8_LOSS_TOL = 2 * STEPS * R.LR, 1e-4
#: the MoELayer layer's batch: [steps, B, S, d] fp32 activations
LAYER_SHAPE = (STEPS, 4, 8, 16)


@pytest.fixture(autouse=True)
def _fresh_jax_world():
    _reset_jax_world()
    yield
    _reset_jax_world()


def _jax_step(mesh, grad_reduce=None):
    jm, _ = _moe_jax_model()
    opt = paddle.optimizer.AdamW(
        learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
    return j_make_step(jm, opt, mesh=mesh, grad_reduce=grad_reduce)


def _jax_run(mesh, xs, ys, grad_reduce=None):
    _reset_jax_world()
    step = _jax_step(mesh, grad_reduce)
    losses = [float(step(xs[k], ys[k])) for k in range(STEPS)]
    return losses, {k: np.asarray(v) for k, v in step.params.items()}


def _jax_layer(x, mesh=None, grad_reduce=None):
    """The JAX ``MoELayer`` (4 ``ExpertMLP``s, its own init) trained
    ``STEPS`` AdamW steps on the mean square of its output (on ``mesh``
    under ``grad_reduce`` when given): its initial weights, the losses and
    the final checkpoint tree."""
    _reset_jax_world()
    paddle.seed(5)
    d, f = x.shape[-1], 32
    layer = jmoe.MoELayer(d, [jmoe.ExpertMLP(d, f) for _ in range(4)])

    def stack(fc, p):
        return np.stack([np.asarray(getattr(getattr(e, fc), p).numpy())
                         for e in layer.experts])

    weights = {"gate": np.asarray(layer.gate_weight.numpy()),
               **{f"{fc}_{p[0]}": stack(fc, p) for fc in ("fc1", "fc2")
                  for p in ("weight", "bias")}}
    model = paddle.nn.Sequential(layer)
    opt = paddle.optimizer.AdamW(learning_rate=R.LR, epsilon=R.EPS,
                                 weight_decay=0.01,
                                 parameters=model.parameters())
    step = j_make_step(model, opt, mesh=mesh, grad_reduce=grad_reduce,
                       loss_fn=lambda o, y: (o.astype("float32") ** 2).mean())
    losses = [float(step(x[k], x[k])) for k in range(STEPS)]
    tree = jax.tree_util.tree_map(np.asarray,
                                  step.state_for_checkpoint().to_tree())
    return weights, losses, tree


def _assert_layer_reduce(got, want, reduced):
    """A rank's ``_layer_reduce`` runs against the JAX layer's under the
    same reduction: losses, and every expert's parameters under its JAX
    name (the int8 runs within Adam's bound, as the GPT-MoE's)."""
    for mode, (_, jl, jtree) in want.items():
        run = got[mode]
        assert run["reduced"] == reduced, run["reduced"]
        assert _err(run["losses"], jl) <= (
            LOSS_TOL if mode == "fp32" else INT8_LOSS_TOL), (
            mode, run["losses"], jl)
        assert set(run["params"]) == set(jtree["params"])
        tol = PARAM_TOL if mode == "fp32" else INT8_PARAM_TOL
        for name, v in jtree["params"].items():
            assert _err(run["params"][name], v) <= tol, (mode, name)


def test_moe_at_mp_and_grad_reduce_and_moe_layer_at_ep(tmp_path):
    _, params = _moe_jax_model()
    xs, ys = _batches()
    lx = np.random.default_rng(5).standard_normal(LAYER_SHAPE).astype(
        np.float32)
    weights, jlayer_losses, jlayer_tree = _jax_layer(lx)
    torch.save({"params": _torch_tree(params), "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys), "layer": _torch_tree(weights),
                "layer_x": torch.from_numpy(lx)}, tmp_path / "inputs.pt")
    with R.Ranks("moe_mp2", tmp_path) as ranks:
        jmp = _jax_run(_mesh((2,), ("mp",)), xs, ys)
        jred = {key: _jax_run(_mesh((2,), ("ep",)), xs, ys, mode)
                for key, mode in (("fp32", "fp32"), ("int8", "int8"),
                                  ("int8_no_ef", {"mode": "quant",
                                                  "error_feedback": False}))}
        jdense = _jax_run(_mesh((2,), ("ep",)), xs, ys)[0]
        outs = ranks.results()
    stacks = ["gpt.layers.1.mlp." + k for k in ("w1", "b1", "w2", "b2")]
    for r, out in enumerate(outs):
        # at mp the experts are whole on every rank
        assert out["w1_shape"] == params[stacks[0]].shape
        assert _err(out["mp"]["losses"], jmp[0]) <= LOSS_TOL, (
            out["mp"]["losses"], jmp[0])
        _assert_moe_trajectory(jmp[1], out["mp"]["params"], STEPS)
        for key, (jl, jp) in jred.items():
            got = out["reduce"][key]
            assert sorted(got["local"]) == sorted(stacks)
            assert _err(got["losses"], jl) <= (
                LOSS_TOL if key == "fp32" else INT8_LOSS_TOL), (
                key, got["losses"], jl)
            _assert_moe_trajectory(jp, got["params"], STEPS,
                                   PARAM_TOL if key == "fp32"
                                   else INT8_PARAM_TOL)
        # local routing: the first loss is not the global route's
        assert abs(out["reduce"]["fp32"]["losses"][0] - jdense[0]) > 1e-4
        # ... and only inside the step: after it, model(x) is the global
        # route's forward of the same parameters, bitwise
        assert out["eval_after_reduce"]
        assert out["refuse_quant"].startswith("ValueError") \
            and "quant" in out["refuse_quant"], out["refuse_quant"]
        lay = out["layer"]
        assert _err(lay["losses"], jlayer_losses) <= LOSS_TOL, (
            lay["losses"], jlayer_losses)
        # every rank's tree holds all four experts under the JAX names
        tree = lay["tree"]
        assert set(tree["params"]) == set(jlayer_tree["params"])
        assert set(tree["opt_state"]) == set(jlayer_tree["opt_state"])
        for name, v in jlayer_tree["params"].items():
            assert _err(tree["params"][name], v) <= PARAM_TOL, name
        assert all(torch.equal(a, lay["restored"]["params"][k])
                   for k, a in tree["params"].items())
        assert all(torch.equal(a, lay["restored"]["opt_state"][k][s])
                   for k, slots in tree["opt_state"].items()
                   for s, a in slots.items() if torch.is_tensor(a))
        assert lay["experts"] == sorted(
            f"0.expert_{i}.{fc}.{p}" for i in range(2)
            for fc in ("fc1", "fc2") for p in ("weight", "bias"))


def _layer_inputs():
    lx = np.random.default_rng(5).standard_normal(LAYER_SHAPE).astype(
        np.float32)
    weights = _jax_layer(lx)[0]
    return lx, weights


#: the MoELayer's four experts' parameters, reduced under their JAX names
LAYER_REDUCED = sorted(f"0.expert_{j}.{k}" for j in range(4)
                       for k in ("fc1.weight", "fc1.bias", "fc2.weight",
                                 "fc2.bias"))


def test_moe_layer_grad_reduce_at_ep(tmp_path):
    """A5.4d at ep 2: the MoELayer's expert modules under grad_reduce fp32
    and int8 against the JAX step on an ``("ep",)`` mesh."""
    lx, weights = _layer_inputs()
    torch.save({"layer": _torch_tree(weights),
                "layer_x": torch.from_numpy(lx)}, tmp_path / "inputs.pt")
    with R.Ranks("moe_layer_ep2", tmp_path) as ranks:
        want = {mode: _jax_layer(lx, _mesh((2,), ("ep",)), mode)
                for mode in ("fp32", "int8")}
        outs = ranks.results()
    for out in outs:
        _assert_layer_reduce(out, want, LAYER_REDUCED)
    # every rank keeps the same whole experts
    for mode in want:
        assert all(torch.equal(v, outs[1][mode]["params"][k])
                   for k, v in outs[0][mode]["params"].items())


def test_four_ranks_ep_mp_and_grad_reduce_at_dp_ep(tmp_path):
    _, params = _moe_jax_model()
    xs, ys = _batches()
    lx, weights = _layer_inputs()
    torch.save({"params": _torch_tree(params), "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys), "layer": _torch_tree(weights),
                "layer_x": torch.from_numpy(lx)}, tmp_path / "inputs.pt")
    with R.Ranks("moe_mp4", tmp_path, world=4) as ranks:
        jepmp = _jax_run(_mesh((2, 2), ("ep", "mp")), xs, ys)
        jred = {mode: _jax_run(_mesh((2, 2), ("dp", "ep")), xs, ys, mode)
                for mode in ("fp32", "int8")}
        jlayer = {mode: _jax_layer(lx, _mesh((2, 2), ("dp", "ep")), mode)
                  for mode in ("fp32", "int8")}
        outs = ranks.results()
    for out in outs:  # A5.4d at dp 2 x ep 2
        _assert_layer_reduce(out["layer"], jlayer, LAYER_REDUCED)
    for out in outs:
        assert _err(out["ep_mp"]["losses"], jepmp[0]) <= LOSS_TOL, (
            out["ep_mp"]["losses"], jepmp[0])
        _assert_moe_trajectory(jepmp[1], out["ep_mp"]["params"], STEPS)
        for mode, (jl, jp) in jred.items():
            got = out[f"dp_ep_{mode}"]
            assert _err(got["losses"], jl) <= (
                LOSS_TOL if mode == "fp32" else INT8_LOSS_TOL), (
                mode, got["losses"], jl)
            _assert_moe_trajectory(jp, got["params"], STEPS,
                                   PARAM_TOL if mode == "fp32"
                                   else INT8_PARAM_TOL)
    # the four ranks' blocks (ep major, mp minor) join into the step's
    # global arrays
    joined = to_paddle_tpu([o["ep_mp"]["block"] for o in outs], mp_degree=2)
    assert all(torch.equal(joined[k], v)
               for k, v in outs[0]["ep_mp"]["params"].items())
