"""The port's expert parallelism (the ``ep`` axis, ``moe_route`` across
ranks, ``MoELayer(group=)``, ``global_scatter``/``global_gather``, the int8
exchanges of ``moe_dispatch="quant"``, and the GPT-MoE train step at ep,
dp x ep and sharding x ep with ``p_g_os``) against the JAX package, on
the CPU.

The port's ranks run as gloo processes started by
``test_torch_dist_ranks.Ranks`` (the ``ep2`` and ``ep4`` jobs of
``tests/torch_dist_jobs.py``, at most 60 s, then every rank is killed)
while the JAX reference computes on ``tests/conftest.py``'s CPU devices.
Same weights on both sides: ``test_torch_moe``'s ``gpt_moe_tiny`` (4
experts, the MoE FFN in block 1) with random numpy weights, each ep rank
taking its experts through ``from_paddle_tpu(ep_rank=, ep_degree=)``.

- ``moe_route`` at ep 2, GShard and Switch, dense and quant: each rank's
  outputs and input gradients are the rows of the JAX route's on the
  whole batch (its gate and quant exchanges under a ``("ep",)`` mesh),
  the aux loss the same on both ranks, each rank's expert-slice
  gradients the JAX gradients' block, and the ranks' gate gradients sum
  to the JAX one (the loss counts the aux term once a rank);
- ``MoELayer(group=)`` with each rank's two experts against the JAX layer
  with all four, and the train step taking it; ``global_scatter``/
  ``global_gather`` bitwise the JAX
  functions' per-rank results, and their round trip;
- the ep topology's accessors against the JAX package's;
- the GPT-MoE step: 3 AdamW steps with the clip at ep 2 (dense and
  quant), at dp 2 x ep 2 and at sharding 2 x ep 2 with ``p_g_os``, each
  rank on its part of every batch, against the JAX step on the same mesh
  and the global batch; a first step's clipped gradients on every rank
  against one port process's on the whole batch, at a clip norm the
  gradients exceed; ``state_for_checkpoint()`` against the JAX step's
  global arrays; a four-rank save restored bitwise by one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.fleet.meta_parallel import \
    group_sharded_parallel as j_group_sharded_parallel
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.models.moe import dispatch as jdispatch
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.collective import Group
from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
from paddle_tpu_torch.incubate.distributed.models.moe import dispatch as tdispatch
from paddle_tpu_torch.incubate.distributed.models.moe import (
    global_gather, global_scatter)
from paddle_tpu_torch.incubate.distributed.models.moe.gate import _route
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
    MoEGroups, moe_groups)
from paddle_tpu_torch.weights import from_paddle_tpu, to_paddle_tpu

import test_torch_dist_ranks as R
import torch_dist_jobs as J
from test_torch_distributed import (LOSS_TOL, NAMES, PARAM_TOL,
                                    _assert_state_bitwise, _reset_jax_world)
from test_torch_moe import _jax_model as _moe_jax_model
from test_torch_tensor_parallel import _mesh

B, S, STEPS = 4, 32, 3
#: fp32 routing of two ranks against the JAX route on the whole batch:
#: the same slots (positions and capacity are integers), outputs and
#: gradients to summation order (XLA's einsums and dots against torch's
#: gathers and bmm), relative to the reference's largest magnitude;
#: largest reading 1.35e-06 (Switch, quant, the input gradient), the
#: others at most 1.3e-06
ROUTE_RTOL = 1e-5
#: the aux loss and the summed gate gradient's share of it: fp32 means
#: over the batch, the all-reduced sums in another order (reading 0)
GATE_TOL = 1e-6
#: the quant route holds ``ROUTE_RTOL`` too where no value crossed a
#: rounding boundary of the int8 grid (none did at these inputs: the
#: readings above include quant). The dispatch's payload is bitwise the
#: JAX one's (the stacks are copies of token rows), but the experts'
#: outputs and their cotangents differ from XLA's in the last fp32 bits,
#: which can move a value across a boundary: one grid step is its
#: block's amax/127. So at most ``QUANT_FLIPS`` of the entries may exceed
#: ``ROUTE_RTOL``, and none two steps of the largest magnitude
QUANT_FLIPS, QUANT_RTOL = 0.01, 2 / 127
#: the quant step against the JAX quant step: the first loss (before any
#: update) to a few flipped int8 values (reading 7.6e-06); over 3 steps
#: AdamW turns the flips into lr-sized moves of the entries whose
#: gradients they touch, so the parameters are held to Adam's bound,
#: 2 * steps * lr (reading 1.2e-03), and the losses to the JAX package's
#: own bound of quant training against dense, 1% (reading 1.0e-03). The
#: gradients of a first step read within 2.6e-03 of the JAX quant step's
#: (relative to each tensor's largest), where quant and dense differ by
#: up to 1.8e-02, alike in both packages
QUANT_LOSS0_TOL, QUANT_LOSS_RTOL = 5e-5, 1e-2
QUANT_PARAM_TOL = 2 * STEPS * R.LR
#: Adam's first moments after 3 steps against the JAX step's: gradients
#: to summation order
MOMENT_TOL = 1e-6
#: the clip case: a clip norm the gradients exceed, so every gradient is
#: scaled by clip / norm; two ranks' against one process's, fp32 rounding
CLIP_NORM, CLIP_TOL = 0.05, 1e-7


@pytest.fixture(autouse=True)
def _fresh_jax_world():
    _reset_jax_world()
    yield
    _reset_jax_world()


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _assert_moe_trajectory(want, got, steps, tol=PARAM_TOL):
    """Parameters within ``tol``; the qkv bias's K third (true gradient
    zero) within Adam's bound, 2 * steps * lr."""
    D, H = 16, 4
    for name, p in got.items():
        diff = np.abs(np.asarray(want[name]) - np.asarray(p))
        if name.endswith("attn.qkv.bias"):
            k_part = slice(H * D, 2 * H * D)
            assert float(diff[k_part].max()) <= 2 * steps * R.LR, name
            diff[k_part] = 0
        assert float(diff.max()) <= tol, (name, float(diff.max()))


def _batches():
    x = np.random.default_rng(7).integers(0, 128, (STEPS, B, S))
    return x, np.roll(x, -1, axis=2)


def _jax_moe_step(mesh, mode="dense", level=None):
    jm, _ = _moe_jax_model(moe_dispatch=mode)
    opt = paddle.optimizer.AdamW(
        learning_rate=R.LR, epsilon=R.EPS, parameters=jm.parameters(),
        weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(R.CLIP))
    if level is not None:
        j_group_sharded_parallel(jm, opt, level=level)
    return j_make_step(jm, opt, mesh=mesh)


def _jax_hcg(dims, rank):
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
        "ep": [h.get_expert_parallel_rank(),
               h.get_expert_parallel_world_size(),
               h.get_expert_parallel_group().ranks],
        "mesh_shape": tuple(h.get_mesh().devices.shape),
    }


def _assert_hcg(got, dims, rank):
    want = _jax_hcg(dims, rank)
    got = dict(got)
    assert tuple(np.shape(got.pop("mesh"))) == want.pop("mesh_shape")
    assert got == want


def _assert_state_like_jax(jstep, got):
    """A port ``state_for_checkpoint()`` tree's params and AdamW moments
    against the JAX step's global arrays: the same names, slots and
    shapes; the values within the trajectory tolerances."""
    want = jstep.state_for_checkpoint().to_tree()
    assert set(got["opt_state"]) == set(want["opt_state"])
    for name, slots in want["opt_state"].items():
        assert set(got["opt_state"][name]) == set(slots), name
        for k, v in slots.items():
            assert tuple(np.shape(got["opt_state"][name][k])) \
                == tuple(np.shape(v)), (name, k)
            if k == "moment1":
                assert _err(v, got["opt_state"][name][k]) <= MOMENT_TOL, \
                    (name, _err(v, got["opt_state"][name][k]))


# ---------------- in this process ----------------------------------------
def test_no_group_routes_as_before():
    """With no group, or a group of one rank, ``_route`` is the one-rank
    routing bit for bit, and ``MoELayer`` and the exchanges take the
    one-rank path (no groups)."""
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (37, 4)).astype(np.float32))
    for k in (1, 2):
        a, b = _route(logits, 5, k), _route(logits, 5, k, group=Group([0]))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert moe_groups(None) is None and moe_groups(Group([0])) is None
    x = torch.ones(3, 4)
    assert global_scatter(x, [1, 2], [1, 2], group=Group([0])) is x
    assert global_gather(x, [1, 2], [1, 2], group=Group([0])) is x


def test_ep_weights_round_trip():
    """``from_paddle_tpu(ep_rank=, ep_degree=)`` gives each rank dim 0's
    block of every expert stack and the rest whole; ``to_paddle_tpu``
    joins them back bit for bit (dicts holding expert stacks are ep
    blocks: a MoE block is never split over mp)."""
    _, params = _moe_jax_model()
    blocks = [from_paddle_tpu(params, ep_rank=r, ep_degree=2)
              for r in range(2)]
    for name, v in params.items():
        stack = name.split(".")[-1] in ("w1", "b1", "w2", "b2")
        for r, b in enumerate(blocks):
            want = v[2 * r:2 * r + 2] if stack else v
            assert np.array_equal(b[name].numpy(), want), name
    back = to_paddle_tpu(blocks)
    assert set(back) == set(params)
    assert all(np.array_equal(back[k].numpy(), v) for k, v in params.items())
    assert all(torch.equal(a, b) for a, b in zip(
        to_paddle_tpu([blocks[0]]).values(), blocks[0].values()))


@pytest.mark.parametrize("E,nep,d,block", [(8, 4, 64, 128), (8, 2, 48, 128),
                                           (6, 4, 64, 128), (8, 2, 4, 128)])
def test_quant_plan_matches_the_reference(E, nep, d, block):
    """``plan_quant_dispatch``'s wire accounting is the JAX plan's on a
    dp 2 x ep mesh; indivisible experts and a block below ``MIN_BLOCK``
    downgrade to dense (None, with a warning) as the JAX plan does; no ep
    exchange is no plan."""
    import warnings

    from jax.sharding import Mesh
    from paddle_tpu.distributed import mesh as jmesh

    T, C = 64, 20
    jmesh.set_global_mesh(Mesh(np.array(jax.devices()[:2 * nep]).reshape(
        2, nep), ("dp", "ep")))
    world = list(range(2 * nep))
    groups = MoEGroups(Group(world), Group(world[:nep]), Group([0, nep]),
                       ("dp", "ep"))
    plans, warned = [], []
    for plan in (lambda: jdispatch.plan_quant_dispatch(T, E, C, d,
                                                       block=block),
                 lambda: tdispatch.plan_quant_dispatch(
                     T // 2, E, C, d, block=block, groups=groups)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            plans.append(plan())
        warned.append(any("falling back" in str(w.message) for w in seen))
    want, got = plans
    assert warned == [want is None] * 2
    if want is None:
        assert got is None
        return
    for key in ("nep", "block", "bytes_wire", "bytes_raw",
                "bytes_wire_train_step", "compression_ratio", "data_axes",
                "other_axes"):
        assert getattr(got, key) == getattr(want, key), key
    alone = MoEGroups(Group(world[:2]), Group([0]), Group(world[:2]), ("dp",))
    assert tdispatch.plan_quant_dispatch(T, E, C, d, groups=alone) is None
    assert tdispatch.plan_quant_dispatch(T, E, C, d) is None


# ---------------- the JAX references --------------------------------------
def _route_inputs(W=2, Tl=24, d=64, E=4, f=32):
    rng = np.random.default_rng(11)

    def n(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    T = W * Tl
    return {"x": n(T, d), "gw": n(d, E), "w1": n(E, d, f, s=0.2),
            "b1": n(E, f, s=0.1), "w2": n(E, f, d, s=0.2),
            "b2": n(E, d, s=0.1), "cot": n(T, d),
            "C": max(1, int(1.25 * T / E)), "c": 0.5}


def _jax_route(ri, gate, mode, W=2):
    """The JAX package's route on the whole batch (its gate, einsums and
    quant exchanges, as ``moe_route`` composes them) under a ``("ep",)``
    mesh of ``W`` devices: the loss ``sum(out * cot) + W * c * aux`` (each
    rank's loss holds the aux term once), its outputs and gradients."""
    gating = jmoe.gshard_gating if gate == "gshard" else jmoe.switch_gating
    T, d = ri["x"].shape
    E, C = ri["gw"].shape[1], ri["C"]

    def loss(x, gw, w1, b1, w2, b2):
        dispatch, combine, aux = gating(x @ gw, C)
        plan = jdispatch.plan_quant_dispatch(T, E, C, d) \
            if mode == "quant" else None
        if plan is not None:
            ein = jdispatch.quant_dispatch(plan, dispatch, x)
        else:
            ein = jnp.einsum("tec,td->ecd", dispatch, x)
        h = jax.nn.gelu(jnp.einsum("ecd,edf->ecf", ein, w1) + b1[:, None],
                        approximate=True)
        eout = jnp.einsum("ecf,efd->ecd", h, w2) + b2[:, None]
        out = jdispatch.quant_combine(plan, combine, eout) \
            if plan is not None else jnp.einsum("tec,ecd->td", combine, eout)
        return (out * ri["cot"]).sum() + W * ri["c"] * aux, (out, aux)

    args = [jnp.asarray(ri[k]) for k in ("x", "gw", "w1", "b1", "w2", "b2")]
    with jax.set_mesh(_mesh((W,), ("ep",))):
        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(6)), has_aux=True))(*args)
    return {"out": np.asarray(out), "aux": float(aux),
            "grads": [np.asarray(g) for g in grads]}


def _assert_route(outs, ri, refs, W=2):
    """Each rank's outputs, input and expert-slice gradients against the
    JAX route's rows and blocks, the aux loss, and the ranks' summed gate
    gradients against the JAX one."""
    Tl = ri["x"].shape[0] // W
    E = ri["gw"].shape[1]
    for key, want in refs.items():
        quant = key.endswith("quant")
        pairs = []
        for r, out in enumerate(outs):
            mine = out["route"][key]
            rows, es = slice(r * Tl, (r + 1) * Tl), slice(
                r * E // W, (r + 1) * E // W)
            pairs += [("out", mine["out"], want["out"][rows]),
                      ("dx", mine["dx"], want["grads"][0][rows])]
            pairs += [(f"d{n}", g, want["grads"][2 + i][es]) for i, (n, g)
                      in enumerate(zip(("w1", "b1", "w2", "b2"),
                                       mine["dw"]))]
            assert abs(float(mine["aux"]) - want["aux"]) <= GATE_TOL, key
        pairs.append(("dgw", sum(out["route"][key]["dgw"] for out in outs),
                      want["grads"][1]))
        for what, a, b in pairs:
            diff = np.abs(np.asarray(a, np.float64) - np.asarray(b))
            scale = float(np.abs(b).max())
            if quant:
                assert (diff > ROUTE_RTOL * scale).mean() <= QUANT_FLIPS \
                    and diff.max() <= QUANT_RTOL * scale, (key, what)
            else:
                assert diff.max() <= ROUTE_RTOL * scale, (
                    key, what, diff.max() / scale)


def _layer_inputs(d=16, f=32, E=4, T=40):
    """The JAX ``MoELayer`` of ``E`` ``ExpertMLP``s (its own init) on
    ``T`` tokens: its weights, input, output and aux loss."""
    paddle.seed(5)
    layer = jmoe.MoELayer(d, [jmoe.ExpertMLP(d, f) for _ in range(E)])
    x = np.random.default_rng(5).standard_normal((T, d)).astype(np.float32)
    y = layer(paddle.to_tensor(x))

    def stack(fc, p):
        return np.stack([np.asarray(getattr(getattr(e, fc), p).numpy())
                         for e in layer.experts])

    inputs = {"gate": np.asarray(layer.gate_weight.numpy()), "x": x,
              **{f"{fc}_{p[0]}": stack(fc, p) for fc in ("fc1", "fc2")
                 for p in ("weight", "bias")}}
    return inputs, np.asarray(y.numpy()), float(layer.aux_loss.numpy())


def _scatter_inputs():
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 4, (2, 4))
    xs = [rng.standard_normal((int(c.sum()), 3)).astype(np.float32)
          for c in counts]
    g = jdist.new_group([0, 1])
    want = jmoe.global_scatter([paddle.to_tensor(v) for v in xs], counts,
                               None, group=g)
    back = jmoe.global_gather(want, counts, None, group=g)
    return ({"xs": [torch.from_numpy(v) for v in xs],
             "counts": torch.from_numpy(counts)},
            [np.asarray(t.numpy()) for t in want],
            [np.asarray(t.numpy()) for t in back], xs)


def _torch_tree(d):
    return {k: torch.from_numpy(np.array(v)) if not isinstance(v, dict)
            else _torch_tree(v) for k, v in d.items()}


# ---------------- two ranks at ep 2 ---------------------------------------
def test_two_ranks_at_ep_match_the_reference(tmp_path):
    _, params = _moe_jax_model()
    xs, ys = _batches()
    ri = _route_inputs()
    li, lout, laux = _layer_inputs()
    gi, sc_want, sc_back, sc_xs = _scatter_inputs()
    torch.save({"params": _torch_tree(params), "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys), "clip": CLIP_NORM,
                "route": {k: torch.from_numpy(np.asarray(v))
                          if isinstance(v, np.ndarray) else v
                          for k, v in ri.items()},
                "layer": _torch_tree(li), "scatter": gi},
               tmp_path / "inputs.pt")
    with R.Ranks("ep2", tmp_path) as ranks:
        refs = {f"{g}_{m}": _jax_route(ri, g, m)
                for g in ("gshard", "switch") for m in ("dense", "quant")}
        jsteps = {m: _jax_moe_step(_mesh((2,), ("ep",)), m)
                  for m in ("dense", "quant")}
        jlosses = {m: [float(s(xs[k], ys[k])) for k in range(STEPS)]
                   for m, s in jsteps.items()}
        outs = ranks.results()
    _assert_route(outs, ri, refs)
    Tl = li["x"].shape[0] // 2
    for r, out in enumerate(outs):
        _assert_hcg(out["hcg"], (1, 1, 1, 1, 2, 1), r)
        # MoELayer(group=): this rank's two experts of four
        lay = out["layer"]
        assert lay["E"] == 4
        want = lout[r * Tl:(r + 1) * Tl]
        assert _err(lay["out"], want) <= ROUTE_RTOL * np.abs(want).max()
        assert abs(float(lay["aux"]) - laux) <= GATE_TOL
        # the step trains its expert modules as ep-split experts (held to
        # the JAX layer's training in test_torch_moe_mp.py)
        assert lay["step"] is None, lay["step"]
        # the count-routed exchange: the JAX per-rank results, bitwise
        sc = out["scatter"]
        assert np.array_equal(sc["out"].numpy(), sc_want[r])
        assert np.array_equal(sc["counted"].numpy(), sc_want[r])
        assert np.array_equal(sc["back"].numpy(), sc_back[r])
        assert np.array_equal(sc["back"].numpy(), sc_xs[r])
        # the steps: losses, global parameters and moments
        assert out["experts"] == ["gpt.layers.1.mlp." + k
                                  for k in ("b1", "b2", "w1", "w2")]
        dense, quant = out["step_dense"], out["step_quant"]
        assert _err(dense["losses"], jlosses["dense"]) <= LOSS_TOL, (
            dense["losses"], jlosses["dense"])
        _assert_moe_trajectory(jsteps["dense"].params, dense["params"],
                               STEPS)
        _assert_state_like_jax(jsteps["dense"], {
            "opt_state": dense["opt_state"]})
        jq = np.array(jlosses["quant"])
        assert abs(quant["losses"][0] - jq[0]) <= QUANT_LOSS0_TOL
        assert (np.abs(np.array(quant["losses"]) - jq) / jq).max() \
            <= QUANT_LOSS_RTOL, (quant["losses"], jlosses["quant"])
        _assert_moe_trajectory(jsteps["quant"].params, quant["params"],
                               STEPS, QUANT_PARAM_TOL)
        # the model's global arrays are the step's
        assert all(torch.equal(out["to_paddle_tpu"][k], v)
                   for k, v in dense["params"].items())
        # a first step's clipped gradients: one process's, rank blocks
        clip = out["clip"]
        for k, g in clip["ep"].items():
            want = clip["ref"][k]
            if k in out["experts"]:
                want = want[2 * r:2 * r + 2]
            assert _err(g, want) <= CLIP_TOL, (k, _err(g, want))
    # the replicas hold the same non-expert parameters after every step
    for a, b in zip(outs[0]["step_dense"]["replicated"],
                    outs[1]["step_dense"]["replicated"]):
        assert all(torch.equal(a[k], b[k]) for k in a
                   if k not in outs[0]["experts"])


# ---------------- four ranks: dp 2 x ep 2, sharding 2 x ep 2 --------------
def test_four_ranks_dp_and_zero3_at_ep_match_the_reference(tmp_path):
    _, params = _moe_jax_model()
    xs, ys = _batches()
    torch.save({"params": _torch_tree(params), "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    runs = {"dp_ep": ((2, 1, 1, 1, 2, 1), (2, 2), ("dp", "ep"), None),
            "sharding_ep": ((1, 1, 2, 1, 2, 1), (2, 2), ("sharding", "ep"),
                            "p_g_os")}
    with R.Ranks("ep4", tmp_path, world=4) as ranks:
        jsteps, jlosses = {}, {}
        for key, (_, shape, names, level) in runs.items():
            jsteps[key] = _jax_moe_step(_mesh(shape, names), level=level)
            jlosses[key] = [float(jsteps[key](xs[k], ys[k]))
                            for k in range(STEPS)]
        outs = ranks.results()
    for r, out in enumerate(outs):
        for key, (dims, _, _, level) in runs.items():
            res = out[key]
            _assert_hcg(res["hcg"], dims, r)
            assert _err(res["losses"], jlosses[key]) <= LOSS_TOL, (
                key, res["losses"], jlosses[key])
            _assert_moe_trajectory(jsteps[key].params, res["params"], STEPS)
            _assert_state_like_jax(jsteps[key], res)
        # stage 3 stores each ep rank's stacks sliced along dim 1 (where
        # the JAX step places a P("ep", None, None) parameter's state)
        z3 = outs[r]["sharding_ep"]["z3"]
        for k in ("w1", "w2", "b1", "b2"):
            shape, dim = z3[f"gpt.layers.1.mlp.{k}"]
            whole = params[f"gpt.layers.1.mlp.{k}"].shape
            assert dim == 1 and shape == (whole[0] // 2, whole[1] // 2) \
                + tuple(whole[2:]), (k, shape, dim)
    # every rank saved the same global arrays; one process restores them
    # bit for bit
    tm, opt = J._moe_model(_torch_tree(params))
    one = make_sharded_train_step(tm, opt, device="cpu")
    one.restore_from_checkpoint(CheckpointManager(
        str(tmp_path / "ep_ck")).restore())
    back = R._tree_copy(one.state_for_checkpoint().to_tree())
    for out in outs:
        _assert_state_bitwise(out["sharding_ep"]["saved"], back)
