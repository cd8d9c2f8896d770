"""The rank jobs of the port's ZeRO-3, gradient-reduction, expert-
parallel, resharding, split-serving, sharded-save and pipeline tests
(``tests/test_torch_zero3.py``, ``tests/test_torch_comm_opt.py``,
``tests/test_torch_expert_parallel.py``, ``tests/test_torch_moe_mp.py``,
``tests/test_torch_resharding.py``, ``tests/test_torch_split_serving.py``,
``tests/test_torch_sharded_save.py``, ``tests/test_torch_pipeline.py``).
Imports no JAX: ``tests/test_torch_dist_ranks.py``, the script each rank
runs, looks a job up here when it is not one of its own.
"""

import numpy as np
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework.io import save_sharded
from paddle_tpu_torch.distributed.comm_opt import (GradReduceConfig,
                                                   plan_as_dict,
                                                   reducer_for_step)
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    group_sharded_parallel, save_group_sharded_model)
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertMLP, MoELayer, global_gather, global_scatter)
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import \
    moe_route
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM, gpt_moe_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.weights import from_paddle_tpu, to_paddle_tpu

import test_torch_dist_ranks as R

#: the recompute policies a stage-3 run goes through
POLICIES = ("none", "full", "save_flash", "dots_saveable")


def _model(params, **cfg):
    """The tiny GPT on ``params`` (whole arrays) and its AdamW."""
    model = GPTForCausalLM(GPTConfig(**{**R.TINY, **cfg}), device="cpu")
    model.load_state_dict(params)
    model.train()
    return model, AdamW(learning_rate=R.LR, epsilon=R.EPS, weight_decay=0.01,
                        parameters=model.named_parameters(),
                        grad_clip=ClipGradByGlobalNorm(R.CLIP))


def _save(step, path, at):
    mgr = CheckpointManager(path)
    mgr.save(at, step.state_for_checkpoint().to_tree())
    mgr.wait_until_finished()
    mgr.close()


# ---------------- the reducer alone ----------------------------------------
def _reduce_runs(inp, mesh, data_axes, pos):
    """Each of ``inp["configs"]`` on this rank's gradients (entry ``pos``
    of every stacked leaf), ``steps`` times: the outputs of every step,
    the residuals after the last (the checkpoint's rows) and the plan."""
    grads = {k: v[pos].clone() for k, v in inp["grads"].items()}
    ints = {k: v[pos].clone() for k, v in inp["ints"].items()}
    templates = {k: (tuple(v.shape), torch.float32) for k, v in grads.items()}
    out = {}
    for name, (cfg, steps, integer) in inp["configs"].items():
        red = reducer_for_step(GradReduceConfig(**cfg), mesh, data_axes,
                               templates)
        ef = red.local_ef(red.init_ef(), "cpu")
        outs = []
        for _ in range(steps):
            r, ef = red.reduce(ints if integer else grads, ef)
            outs.append({k: v.clone() for k, v in r.items()})
        out[name] = {"outs": outs, "ef": red.global_ef(ef),
                     "plan": plan_as_dict(red.plan), "has_ef": red.has_ef,
                     "stages": [list(a) if isinstance(a, tuple) else a
                                for a in red.stage_axes]}
    return out


def job_reducer(directory, inp, rank):
    """The reducer on two dp ranks: every configuration of the inputs."""
    D.init_parallel_env(device="cpu")
    mesh = D.DeviceMesh([0, 1], ("dp",))
    return _reduce_runs(inp, mesh, ("dp",), rank)


# ---------------- the train step with grad_reduce at dp 2 ------------------
def _dp_reduce_step(params, hcg, grad_reduce, **kw):
    model, opt = _model(params)
    return fleet.make_sharded_train_step(
        model, opt, mesh=hcg.get_mesh(), grad_reduce=grad_reduce,
        device="cpu", **kw)


def job_grad_reduce(directory, inp, rank):
    """Two ranks at dp 2: runs of the tiny GPT with grad_reduce None,
    fp32, int8 and bf16 on each rank's half of the batches; the int8
    residuals after 2 steps; a save and the replay of its next steps; the
    JAX package's int8 save continued for a step; overlap with
    accumulate_steps=2 (twice); int8 under a loss scaler whose first step
    overflows on rank 1."""
    hcg = R._dp_init()
    xs, ys, params = inp["x"], inp["y"], inp["params"]
    n = xs.shape[1] // 2
    rows = slice(rank * n, (rank + 1) * n)

    def run(step, k0=0, k1=None):
        return [step(xs[k][rows], ys[k][rows]).item()
                for k in range(k0, k1 if k1 is not None else xs.shape[0])]

    out = {}
    for mode in (None, "fp32", "int8", "bf16"):
        step = _dp_reduce_step(params, hcg, mode)
        out[str(mode)] = {"losses": run(step),
                          "params": R._snapshot(step)}
    step = _dp_reduce_step(params, hcg, "int8")
    out["stages"] = step._reducer.stage_axes
    run(step, 0, 2)
    tree = step.state_for_checkpoint().to_tree()
    out["ef"] = R._tree_copy(tree["extra"]["grad_reduce_ef"])
    out["plan"] = plan_as_dict(step._reducer.plan)
    _save(step, directory / "port_ck", 2)
    out["continued"] = run(step, 2, 5)
    fresh = _dp_reduce_step(
        {k: torch.randn_like(v) for k, v in params.items()}, hcg, "int8")
    fresh.restore_from_checkpoint(CheckpointManager(
        directory / "port_ck").restore())
    out["replayed"] = run(fresh, 2, 5)
    out["replay_params"] = (R._snapshot(step), R._snapshot(fresh))
    R._wait_for(directory / "jax_ck.ready")
    fresh = _dp_reduce_step(
        {k: torch.randn_like(v) for k, v in params.items()}, hcg, "int8")
    fresh.restore_from_checkpoint(CheckpointManager(
        directory / "jax_ck").restore())
    out["from_jax"] = {"losses": run(fresh, 2, 3),
                       "params": R._tree_copy(
                           fresh.state_for_checkpoint().to_tree())}
    out["overlap"] = []
    for _ in range(2):
        step = _dp_reduce_step(params, hcg, "int8", accumulate_steps=2)
        out["overlap"].append({"losses": run(step, 0, 3),
                               "per_step": step._reductions_per_step})
    step = _dp_reduce_step(params, hcg, {"mode": "quant", "overlap": False},
                           accumulate_steps=2)
    out["no_overlap"] = run(step, 0, 3)
    sc = amp.GradScaler(init_loss_scaling=float("inf") if rank else 2.0 ** 10)
    step = _dp_reduce_step(params, hcg, "int8", scaler=sc)
    ef0 = {k: v.clone() for k, v in step.ef_state.items()}
    first = run(step, 0, 1)
    out["scaler"] = {"skip_kept_ef": all(torch.equal(ef0[k], v) for k, v in
                                         step.ef_state.items()),
                     "first": first}
    sc.set_init_loss_scaling(2.0 ** 10)
    out["scaler"]["losses"] = run(step, 1, 3)
    # a GPT-MoE step at dp 2 (no ep axis: the experts are replicated)
    # with the explicit fp32 reduction, and without one; a MoELayer whose
    # experts split over the dp group
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    out["moe_step"] = []
    for mode in (None, "fp32"):
        moe = GPTForCausalLM(GPTConfig(**{**R.TINY, "moe_num_experts": 4,
                                          "moe_every_k": 1}), device="cpu")
        step = fleet.make_sharded_train_step(
            moe, AdamW(parameters=moe.named_parameters()),
            mesh=hcg.get_mesh(), grad_reduce=mode, device="cpu")
        out["moe_step"].append({"losses": run(step, 0, 2),
                                "params": R._snapshot(step)})
    out["moe_group"] = MoELayer(64, [torch.nn.Identity()] * 2,
                                group=hcg.get_data_parallel_group()
                                ).num_experts
    return out


# ---------------- ZeRO stage 3 at sharding 2 -------------------------------
def _z3_step(params, mesh, level="p_g_os", **cfg):
    model, opt = _model(params, **cfg)
    wrapped, opt, _ = group_sharded_parallel(model, opt, level=level)
    return wrapped, fleet.make_sharded_train_step(wrapped, opt, mesh=mesh,
                                                  device="cpu")


def _block_bytes(model):
    """The largest block's stage-3 weights, whole, in bytes."""
    per = {}
    for name, z in model.z3.items():
        if ".layers." in name:
            i = name.split(".layers.")[1].split(".")[0]
            per[i] = per.get(i, 0) + int(np.prod(z.shape)) * 4
    return max(per.values())


def job_zero3(directory, inp, rank):
    """Two ranks at sharding 2 (fleet's mesh, whose mp axis has one rank):
    stage 3's placement; 3 steps at os_g and at p_g_os (plain and under
    every recompute policy) with each rank on its half of the batches, the
    gathers and the live gathered bytes; the whole-array state dicts."""
    mesh = R._hybrid_init({"sharding_degree": 2}).get_mesh()
    xs, ys, params = inp["x"], inp["y"], inp["params"]
    rows = slice(rank * 2, rank * 2 + 2)
    out = {}
    _, step = _z3_step(params, mesh, "os_g")
    out["os_g"] = R._run_global(step, xs, ys, rows)
    model, step = _z3_step(params, mesh)
    out["placement"] = {n: (tuple(p.shape), getattr(p, "zero3_dim", None))
                        for n, p in model.named_parameters()}
    out["slices"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    out["state_dict_whole"] = all(
        torch.equal(v, params[k]) for k, v in model.state_dict().items())
    out["to_paddle_tpu"] = all(torch.equal(v, params[k]) for k, v in
                               to_paddle_tpu(model).items())
    out["block_bytes"] = _block_bytes(model)
    out["policies"] = {}
    for pol in POLICIES:
        cfg = {} if pol == "none" else {
            "use_recompute": True,
            "recompute_policy": None if pol == "full" else pol}
        model, step = _z3_step(params, mesh, **cfg)
        model.stats.reset()
        rec = R._run_global(step, xs, ys, rows)
        rec["stats"] = (model.stats.gathers, model.stats.reduce_scatters,
                        model.stats.peak_bytes, model.live_bytes)
        rec["state_shapes"] = {n: {k: tuple(v.shape) for k, v in s.items()
                                   if torch.is_tensor(v)}
                               for n, s in step.optimizer.state.items()}
        out["policies"][pol] = rec
    return out


def _slice_of(whole, p, rank):
    """This rank's stage-3 slice of ``whole`` for the parameter ``p``."""
    d = getattr(p, "zero3_dim", None)
    return whole if d is None else whole.chunk(2, d)[rank]


def job_zero3_state(directory, inp, rank):
    """Two ranks at sharding 2 (fleet's mesh): 2 steps at os_g and at
    p_g_os with accumulate_steps=2; the eager use and
    ``save_group_sharded_model``; whole arrays into ``set_state_dict``; a
    two-rank save after 2 steps and its restore into a stage-3 step on
    other weights."""
    mesh = R._hybrid_init({"sharding_degree": 2}).get_mesh()
    xs, ys, params = inp["x"], inp["y"], inp["params"]
    rows = slice(rank * 2, rank * 2 + 2)
    out = {}
    # accumulation: each microbatch reduce-scatters into the slices
    out["accum"] = {}
    for level in ("os_g", "p_g_os"):
        model, opt = _model(params)
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        step = fleet.make_sharded_train_step(model, opt, mesh=mesh,
                                             accumulate_steps=2, device="cpu")
        out["accum"][level] = R._run_global(step, xs[:2], ys[:2], rows)
        if level == "p_g_os":
            out["accum"]["reduce_scatters"] = model.stats.reduce_scatters
    # eager: model(x).mean().backward(); opt.step()
    model, opt = _model(params)
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model(xs[0][rows]).mean().backward()
    opt.step()
    out["eager"] = {"moved": sorted(n for n, p in model.named_parameters()
                                    if not torch.equal(before[n], p)),
                    "names": sorted(before),
                    "whole": model.state_dict(),
                    "opt_whole": R._tree_copy(
                        model.whole_optimizer_state(opt))}
    save_group_sharded_model(model, str(directory / "eager"), opt)
    # the wrapper takes whole arrays (the JAX package's, converted) and
    # keeps its slices; a two-rank save after 2 steps, and the save
    # restored into a stage-3 step built on other weights
    model, step = _z3_step({k: torch.randn_like(v)
                            for k, v in params.items()}, mesh)
    model.set_state_dict(from_paddle_tpu(
        {k: v.numpy() for k, v in params.items()}))
    out["set_state_dict"] = all(torch.equal(p, _slice_of(params[n], p, rank))
                                for n, p in model._layers.named_parameters())
    for k in range(2):
        step(xs[k][rows], ys[k][rows])
    _save(step, directory / "z3_ck", 2)
    out["saved"] = R._tree_copy(step.state_for_checkpoint().to_tree())
    model, fresh = _z3_step({k: torch.randn_like(v)
                             for k, v in params.items()}, mesh)
    fresh.restore_from_checkpoint(CheckpointManager(
        directory / "z3_ck").restore())
    out["restored"] = R._tree_copy(fresh.state_for_checkpoint().to_tree())
    return out


# ---------------- four ranks ------------------------------------------------
def job_dp_sharding_4(directory, inp, rank):
    """Four ranks at dp 2 x sharding 2: the reducer over both data axes,
    hierarchical and flat (positions folded as the JAX package orders
    them); then 3 steps of the tiny GPT at p_g_os with int8, each rank on
    its quarter of every batch."""
    hcg = R._hybrid_init({"dp_degree": 2, "sharding_degree": 2})
    mesh = hcg.get_mesh()
    coords = mesh.coords(rank)
    pos = coords["dp"] * 2 + coords["sharding"]
    out = {"reducer": _reduce_runs(inp["reducer"], mesh, ("dp", "sharding"),
                                   pos)}
    model, opt = _model(inp["params"])
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    step = fleet.make_sharded_train_step(model, opt, mesh=mesh,
                                         grad_reduce="int8", device="cpu")
    out["world"], out["z3"] = step._reducer.world, sorted(step._z3)
    out["step"] = R._run_global(step, inp["x"], inp["y"],
                                slice(pos, pos + 1))
    out["ef_shapes"] = {k: tuple(v.shape) for k, v in step.state_for_checkpoint()
                        .to_tree()["extra"]["grad_reduce_ef"].items()}
    return out


def job_dp_mp_4(directory, inp, rank):
    """Four ranks at dp 2 x mp 2: 3 steps of the tiny GPT with int8 (one
    reduction per model shard's data group), each dp rank on its half of
    every batch; a GPT-MoE step at dp 2 and MoELayer(group=) refuse."""
    hcg = R._hybrid_init({"dp_degree": 2, "mp_degree": 2})
    blocks = from_paddle_tpu({k: v.numpy() for k, v in inp["params"].items()},
                             mp_rank=hcg.get_model_parallel_rank(),
                             mp_degree=2)
    model, opt = R._tiny_on(blocks)
    step = fleet.make_sharded_train_step(
        fleet.distributed_model(model), fleet.distributed_optimizer(opt),
        mesh=hcg.get_mesh(), grad_reduce="int8", device="cpu")
    red = step._reducer
    n = inp["x"].shape[1] // 2
    dp = hcg.get_data_parallel_rank()
    out = {"hybrid": red.hybrid, "groups": red.groups, "world": red.world,
           "plan": plan_as_dict(red.plan),
           "step": R._run_global(step, inp["x"], inp["y"],
                                 slice(dp * n, (dp + 1) * n))}
    out["ef_shapes"] = {k: tuple(v.shape) for k, v in step.state_for_checkpoint()
                        .to_tree()["extra"]["grad_reduce_ef"].items()}
    return out


# ---------------- expert parallelism ---------------------------------------
def _moe_model(params, mode="dense", hcg=None, clip=R.CLIP):
    """The tiny GPT-MoE on ``params`` (whole arrays; an ep rank takes its
    experts, an mp rank its blocks) and its AdamW."""
    ep = (hcg.get_expert_parallel_rank(), hcg.get_expert_parallel_world_size()
          ) if hcg is not None else (0, 1)
    mp = (hcg.get_model_parallel_rank(), hcg.get_model_parallel_world_size()
          ) if hcg is not None else (0, 1)
    model = gpt_moe_tiny(dropout=0.0, moe_dispatch=mode, device="cpu")
    model.load_state_dict(from_paddle_tpu(
        {k: v.numpy() for k, v in params.items()}, ep_rank=ep[0],
        ep_degree=ep[1], mp_rank=mp[0], mp_degree=mp[1]))
    model.train()
    return model, AdamW(learning_rate=R.LR, epsilon=R.EPS, weight_decay=0.01,
                        parameters=model.named_parameters(),
                        grad_clip=ClipGradByGlobalNorm(clip))


def _ep_record(hcg):
    return {**R._hcg_record(hcg),
            "ep": [hcg.get_expert_parallel_rank(),
                   hcg.get_expert_parallel_world_size(),
                   hcg.get_expert_parallel_group().ranks]}


def _route_runs(ri, groups, rank, n):
    """``moe_route`` on this rank's rows of ``ri["x"]`` with its experts
    (GShard and Switch, dense and quant): outputs, aux, and the gradients
    of ``sum(out * cot) + c * aux``."""
    Tl = ri["x"].shape[0] // n
    E = ri["gw"].shape[1]
    rows, es = slice(rank * Tl, (rank + 1) * Tl), slice(
        rank * E // n, (rank + 1) * E // n)
    out = {}
    for gate in ("gshard", "switch"):
        for mode in ("dense", "quant"):
            x = ri["x"][rows].clone().requires_grad_()
            gw = ri["gw"].clone().requires_grad_()
            ws = [ri[k][es].clone().requires_grad_()
                  for k in ("w1", "b1", "w2", "b2")]

            def experts(ein):
                h = F.gelu(torch.bmm(ein, ws[0]) + ws[1][:, None],
                           approximate=True)
                return torch.bmm(h, ws[2]) + ws[3][:, None]

            y, aux = moe_route(x, gw, gate, int(ri["C"]), experts,
                               dispatch_mode=mode, groups=groups)
            ((y * ri["cot"][rows]).sum() + float(ri["c"]) * aux).backward()
            out[f"{gate}_{mode}"] = {
                "out": y.detach(), "aux": aux.detach(), "dx": x.grad,
                "dgw": gw.grad, "dw": [w.grad for w in ws]}
    return out


def job_ep2(directory, inp, rank):
    """Two ranks at ep 2: the topology; ``moe_route`` over the ranks
    (GShard and Switch, dense and quant); ``MoELayer(group=)``, and the
    train step built on it; ``global_scatter``/``global_gather``; 3 steps of the tiny GPT-MoE,
    dense and quant, each rank on its half of every batch; the clipped
    gradients of a first step against one process's on the whole batch;
    ``to_paddle_tpu`` of the model."""
    params, xs, ys = inp["params"], inp["x"], inp["y"]
    # one process on the whole batch, before the world forms: its
    # clipped gradients after a first step
    ref, ref_opt = _moe_model(params, clip=inp["clip"])
    ref_step = fleet.make_sharded_train_step(ref, ref_opt, device="cpu")
    ref_step(xs[0], ys[0])
    ref_grads = {k: p.grad.clone() for k, p in ref.named_parameters()}

    hcg = R._hybrid_init({"ep_degree": 2})
    out = {"hcg": _ep_record(hcg)}
    out["route"] = _route_runs(inp["route"], hcg.moe_groups(), rank, 2)

    li = inp["layer"]
    n_loc = li["fc1_w"].shape[0] // 2
    experts = [ExpertMLP(*li["fc1_w"].shape[1:], device="cpu")
               for _ in range(n_loc)]
    layer = MoELayer(li["fc1_w"].shape[1], experts,
                     group=hcg.get_expert_parallel_group(), device="cpu")
    with torch.no_grad():
        layer.gate_weight.copy_(li["gate"])
        for i, e in enumerate(experts):
            for fc in ("fc1", "fc2"):
                getattr(e, fc).weight.copy_(li[f"{fc}_w"][rank * n_loc + i])
                getattr(e, fc).bias.copy_(li[f"{fc}_b"][rank * n_loc + i])
    Tl = li["x"].shape[0] // 2
    out["layer"] = {"out": layer(li["x"][rank * Tl:(rank + 1) * Tl]).detach(),
                    "aux": layer.aux_loss.detach(), "E": layer.num_experts}
    # its experts are modules of their own: the step trains them as this
    # ep rank's experts
    wrapped = torch.nn.Sequential(layer)
    try:
        fleet.make_sharded_train_step(
            wrapped, AdamW(learning_rate=R.LR,
                           parameters=wrapped.named_parameters()),
            loss_fn=lambda o, y: o.float().square().mean(),
            mesh=hcg.get_mesh(), device="cpu")
        out["layer"]["step"] = None
    except NotImplementedError as e:
        out["layer"]["step"] = str(e)

    gi = inp["scatter"]
    g = hcg.get_expert_parallel_group()
    lc = gi["counts"][rank]
    gc = gi["counts"].reshape(2, 2, -1)[:, rank].reshape(-1)
    sc = global_scatter(gi["xs"][rank], lc, gc, group=g)
    out["scatter"] = {"out": sc,
                      "counted": global_scatter(gi["xs"][rank], lc, None,
                                                group=g),
                      "back": global_gather(sc, lc, gc, group=g)}

    rows = slice(rank * xs.shape[1] // 2, (rank + 1) * xs.shape[1] // 2)
    for mode in ("dense", "quant"):
        model, opt = _moe_model(params, mode, hcg)
        step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                             device="cpu")
        out[f"step_{mode}"] = R._run_global(step, xs, ys, rows)
        out[f"step_{mode}"]["opt_state"] = R._tree_copy(
            step.state_for_checkpoint().to_tree()["opt_state"])
        if mode == "dense":
            out["to_paddle_tpu"] = to_paddle_tpu(model)
            out["experts"] = sorted(step._experts)
    model, opt = _moe_model(params, clip=inp["clip"], hcg=hcg)
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                         device="cpu")
    step(xs[0][rows], ys[0][rows])
    out["clip"] = {"ref": ref_grads, "ep": {
        k: p.grad.clone() for k, p in model.named_parameters()}}
    return out


def job_ep4(directory, inp, rank):
    """Four ranks: 3 steps of the tiny GPT-MoE at dp 2 x ep 2 and at
    sharding 2 x ep 2 with ``p_g_os``, each rank on its quarter of every
    batch; the topologies; the ``p_g_os`` run's placements and a save."""
    params, xs, ys = inp["params"], inp["x"], inp["y"]
    out = {}
    for key, dims, level in (
            ("dp_ep", {"dp_degree": 2, "ep_degree": 2}, None),
            ("sharding_ep", {"sharding_degree": 2, "ep_degree": 2},
             "p_g_os")):
        hcg = R._hybrid_init(dims)
        model, opt = _moe_model(params, hcg=hcg)
        if level is not None:
            model, opt, _ = group_sharded_parallel(model, opt, level=level)
        step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                             device="cpu")
        res = R._run_global(step, xs, ys, slice(rank, rank + 1))
        tree = step.state_for_checkpoint().to_tree()
        res["opt_state"] = R._tree_copy(tree["opt_state"])
        res["hcg"] = _ep_record(hcg)
        res["experts"] = sorted(step._experts)
        if level is not None:
            res["z3"] = {k: (tuple(p.shape), p.zero3_dim)
                         for k, p in step.params.items() if k in step._z3}
            _save(step, directory / "ep_ck", 3)
            res["saved"] = R._tree_copy(tree)
        out[key] = res
    return out


# ---------------- GPT-MoE at mp, grad_reduce and MoELayer at ep (A5.4c) ----
def _moe_layer(li, hcg, rank):
    """A ``MoELayer`` over the ep group holding ep rank ``rank``'s experts
    of the JAX layer's weights ``li``, wrapped so the step trains it."""
    n_loc = li["fc1_w"].shape[0] // 2
    experts = [ExpertMLP(*li["fc1_w"].shape[1:], device="cpu")
               for _ in range(n_loc)]
    layer = MoELayer(li["fc1_w"].shape[1], experts,
                     group=hcg.get_expert_parallel_group(), device="cpu")
    with torch.no_grad():
        layer.gate_weight.copy_(li["gate"])
        for i, e in enumerate(experts):
            for fc in ("fc1", "fc2"):
                getattr(e, fc).weight.copy_(li[f"{fc}_w"][rank * n_loc + i])
                getattr(e, fc).bias.copy_(li[f"{fc}_b"][rank * n_loc + i])
    return torch.nn.Sequential(layer)


def job_moe_mp2(directory, inp, rank):
    """Two ranks: 3 steps of the tiny GPT-MoE at mp 2 on the whole batch
    (its experts whole on both ranks); at ep 2 under grad_reduce fp32,
    int8 and int8 without error feedback, each rank on its half of every
    batch, and quant dispatch refused there; a MoELayer(group=) holding
    each rank's two experts trained 3 steps, its checkpoint tree, and the
    tree restored into a fresh step."""
    params, xs, ys = inp["params"], inp["x"], inp["y"]
    out = {}
    hcg = R._hybrid_init({"mp_degree": 2})
    model, opt = _moe_model(params, hcg=hcg)
    out["w1_shape"] = tuple(model.gpt.layers[1].mlp.w1.shape)
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                         device="cpu")
    out["mp"] = R._run_global(step, xs, ys, slice(None))
    hcg = R._hybrid_init({"ep_degree": 2})
    rows = slice(rank * xs.shape[1] // 2, (rank + 1) * xs.shape[1] // 2)
    out["reduce"] = {}
    for key, mode in (("fp32", "fp32"), ("int8", "int8"),
                      ("int8_no_ef", {"mode": "quant",
                                      "error_feedback": False})):
        model, opt = _moe_model(params, hcg=hcg)
        step = fleet.make_sharded_train_step(
            model, opt, mesh=hcg.get_mesh(), grad_reduce=mode, device="cpu")
        res = R._run_global(step, xs, ys, rows)
        res["local"] = [k for k, v in step._whole.items()]
        out["reduce"][key] = res
        if key == "fp32":  # the model routes globally outside the step
            with torch.no_grad():
                after = model(xs[0][rows])
                same, _ = _moe_model(res["params"], hcg=hcg)
                out["eval_after_reduce"] = torch.equal(after,
                                                       same(xs[0][rows]))
    model, opt = _moe_model(params, "quant", hcg=hcg)
    out["refuse_quant"] = R._raises(lambda: fleet.make_sharded_train_step(
        model, opt, mesh=hcg.get_mesh(), grad_reduce="int8", device="cpu"))
    li, lx = inp["layer"], inp["layer_x"]
    half = slice(rank * lx.shape[1] // 2, (rank + 1) * lx.shape[1] // 2)

    def layer_step(weights):
        lay = _moe_layer(weights, hcg, rank)
        return lay, fleet.make_sharded_train_step(
            lay, AdamW(learning_rate=R.LR, epsilon=R.EPS, weight_decay=0.01,
                       parameters=lay.named_parameters()),
            loss_fn=lambda o, y: o.float().square().mean(),
            mesh=hcg.get_mesh(), device="cpu")

    lay, step = layer_step(li)
    out["layer"] = {"losses": [step(lx[k][half], lx[k][half]).item()
                               for k in range(lx.shape[0])],
                    "experts": sorted(step._experts)}
    tree = step.state_for_checkpoint().to_tree()
    out["layer"]["tree"] = R._tree_copy({k: tree[k] for k in
                                         ("params", "opt_state")})
    _, fresh = layer_step({k: torch.randn_like(v) for k, v in li.items()})
    fresh.restore_from_checkpoint(tree)
    back = fresh.state_for_checkpoint().to_tree()
    out["layer"]["restored"] = R._tree_copy({k: back[k] for k in
                                             ("params", "opt_state")})
    return out


def _layer_reduce(li, lx, hcg, rank, rows, modes=("fp32", "int8")):
    """A ``MoELayer(group=)`` holding this ep rank's experts of ``li``,
    trained on ``lx[k][rows]`` under each ``grad_reduce`` mode (A5.4d):
    losses and the checkpoint tree's params, gathered (every expert under
    its JAX name)."""
    out = {}
    e = hcg.get_expert_parallel_rank()
    for mode in modes:
        lay = _moe_layer(li, hcg, e)
        step = fleet.make_sharded_train_step(
            lay, AdamW(learning_rate=R.LR, epsilon=R.EPS, weight_decay=0.01,
                       parameters=lay.named_parameters()),
            loss_fn=lambda o, y: o.float().square().mean(),
            mesh=hcg.get_mesh(), grad_reduce=mode, device="cpu")
        losses = [step(lx[k][rows], lx[k][rows]).item()
                  for k in range(lx.shape[0])]
        out[mode] = {"losses": losses, "reduced": sorted(
            step._whole_experts), "params": R._tree_copy(
                step.state_for_checkpoint().to_tree()["params"])}
    return out


def job_moe_layer_ep2(directory, inp, rank):
    """Two ranks at ep 2: a MoELayer(group=) with each rank's two experts
    of four under grad_reduce fp32 and int8 (A5.4d), each rank on its half
    of every batch."""
    hcg = R._hybrid_init({"ep_degree": 2})
    lx = inp["layer_x"]
    half = slice(rank * lx.shape[1] // 2, (rank + 1) * lx.shape[1] // 2)
    return _layer_reduce(inp["layer"], lx, hcg, rank, half)


def job_moe_mp4(directory, inp, rank):
    """Four ranks: 3 steps of the tiny GPT-MoE at ep 2 x mp 2 (each ep
    rank on its half of every batch, the mp ranks on the same rows) and at
    dp 2 x ep 2 under grad_reduce fp32 and int8 (each rank on its
    quarter); the model's blocks, joined by ``to_paddle_tpu(mp_degree=2)``
    in the test."""
    params, xs, ys = inp["params"], inp["x"], inp["y"]
    out = {}
    hcg = R._hybrid_init({"ep_degree": 2, "mp_degree": 2})
    model, opt = _moe_model(params, hcg=hcg)
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                         device="cpu")
    e = hcg.get_expert_parallel_rank()
    out["ep_mp"] = R._run_global(step, xs, ys, slice(e * 2, e * 2 + 2))
    out["ep_mp"]["block"] = {k: v.detach().clone()
                             for k, v in model.state_dict().items()}
    hcg = R._hybrid_init({"dp_degree": 2, "ep_degree": 2})
    for mode in ("fp32", "int8"):
        model, opt = _moe_model(params, hcg=hcg)
        step = fleet.make_sharded_train_step(
            model, opt, mesh=hcg.get_mesh(), grad_reduce=mode, device="cpu")
        out[f"dp_ep_{mode}"] = R._run_global(step, xs, ys,
                                             slice(rank, rank + 1))
    # A5.4d: a MoELayer's expert modules at dp 2 x ep 2, each rank on its
    # quarter of every batch
    out["layer"] = _layer_reduce(inp["layer"], inp["layer_x"], hcg, rank,
                                 slice(rank, rank + 1))
    return out


# ---------------- resharding (A5.5a) ----------------------------------------
def _mesh_of(axes, reverse=False):
    """A port mesh over the first ranks (in reverse with ``reverse``)."""
    n = int(np.prod(list(axes.values()))) if axes else 1
    ranks = list(range(n))[::-1] if reverse else list(range(n))
    return D.DeviceMesh(np.array(ranks).reshape(tuple(axes.values())),
                        tuple(axes))


def _sharding(axes, spec, reverse=False, segments=None):
    return D.NamedSharding(_mesh_of(axes, reverse),
                           D.PartitionSpec(*[tuple(e) if isinstance(e, list)
                                             else e for e in spec]),
                           segments=segments)


def _block(x, sharding):
    """This rank's block of the global ``x`` under ``sharding`` (None off
    its mesh), by slicing."""
    from paddle_tpu_torch.distributed.resharding import block_of

    flat = sharding.mesh.devices.reshape(-1).tolist()
    me = D.get_rank()
    if me not in flat:
        return None
    return block_of(x.__getitem__, x.shape, sharding, flat.index(me)).clone()


def _moves(cases):
    """Each move of ``cases`` (``{name: (shape, dtype, [(axes, spec,
    reverse, segments), ...])}``: a chain of layouts) on a seeded global
    array: whether every hop's block is bitwise the array's slice, the
    hops' plans (steps' ops, bytes_wire, bytes_naive, as dicts where
    plain) and the bytes this rank received."""
    from paddle_tpu_torch.distributed import resharding as rs

    out = {}
    for name, (shape, dtype, chain) in cases.items():
        g = torch.Generator().manual_seed(len(name))
        x = (torch.randint(-2 ** 40, 2 ** 40, shape, generator=g)
             if dtype == torch.int64 else
             torch.randn(shape, generator=g).to(dtype))
        shs = [_sharding(*hop) for hop in chain]
        cur = rs.ShardedTensor(_block(x, shs[0]), shs[0])
        hops = []
        for dst in shs[1:]:
            rs.reset_stats()
            try:
                plan = rs.plan_for(cur, dst)
            except rs.Unplannable as e:
                plan = str(e)
            nxt = rs.reshard(cur, dst)
            want = _block(x, dst)
            st = rs.stats()
            hops.append({
                "equal": (nxt.block is None and want is None) or (
                    nxt.block.dtype == want.dtype
                    and torch.equal(nxt.block.view(torch.uint8)
                                    if dtype == torch.bfloat16 else
                                    nxt.block, want.view(torch.uint8)
                                    if dtype == torch.bfloat16 else want)),
                "plan": plan if isinstance(plan, str) else (
                    rs.plan_as_dict(plan) if isinstance(plan, rs.ReshardPlan)
                    else [rs.plan_as_dict(p) for p in plan.plans]),
                "received": st["bytes_received"], "wire": st["bytes_wire"],
                "assembled": st["assembled"],
                "assembled_received": st["assembled_bytes_received"]})
            if nxt.block is None:
                break
            cur = nxt
        out[name] = hops
    return out


def job_reshard(directory, inp, rank):
    """The executor on the world's ranks: every chain of moves of
    ``inp["cases"]``."""
    D.init_parallel_env(device="cpu")
    return _moves(inp["cases"])


def job_reshard_ckpt(directory, inp, rank):
    """Two ranks: the tiny GPT trained 2 steps at mp 2 and saved; a
    sharding-2 ``p_g_os`` step restored from it by its placements (the
    bytes read), live from the mp-2 step's blocks through the executor
    (its counters), and continued 2 steps; the JAX package's (2, 2)-mesh
    save restored onto the mp-2 step's placements."""
    from paddle_tpu_torch.checkpoint import arrays as ck_arrays
    from paddle_tpu_torch.distributed import resharding as rs

    params, xs, ys = inp["params"], inp["x"], inp["y"]
    hcg = R._hybrid_init({"mp_degree": 2})
    blocks = from_paddle_tpu({k: v.numpy() for k, v in params.items()},
                             mp_rank=hcg.get_model_parallel_rank(),
                             mp_degree=2)
    model, opt = R._tiny_on(blocks)
    mp_step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                            device="cpu")
    for k in range(2):
        mp_step(xs[k], ys[k])
    _save(mp_step, directory / "port_ck", 2)
    out = {"mp_shardings": _spec_tree(mp_step.checkpoint_shardings())}

    hcg = R._hybrid_init({"sharding_degree": 2})

    def fresh():
        return _z3_step({k: torch.randn_like(v) for k, v in params.items()},
                        hcg.get_mesh())[1]

    step = fresh()
    mgr = CheckpointManager(directory / "port_ck")
    ranged = CheckpointManager(directory / "port_ck",
                               validate_on_restore=False)
    shardings = step.checkpoint_shardings()
    out["shardings"] = _spec_tree(shardings)
    ck_arrays.reset_read_stats()
    tree = ranged.restore(shardings=shardings)
    out["read"] = ck_arrays.read_stats()
    out["placed"] = _placed(tree, shardings)
    out["blocks"] = _blocks(tree)
    # validated: every file a block overlaps read whole, its CRC checked
    ck_arrays.reset_read_stats()
    out["checked"] = _blocks(mgr.restore(shardings=shardings))
    out["checked_read"] = ck_arrays.read_stats()
    rs.reset_stats()
    ck_arrays.reset_read_stats()
    live = mgr.restore(shardings=shardings, live_state=mp_step.live_state())
    out["live_read"] = ck_arrays.read_stats()
    out["live_stats"] = rs.stats()
    out["live_placed"] = _placed(live, shardings)
    out["live"] = _blocks(live)
    step.restore_from_checkpoint(live)
    rows = slice(rank * 2, rank * 2 + 2)
    out["continued"] = [step(xs[k][rows], ys[k][rows]).item()
                        for k in range(2, 4)]
    # blocks of the mp-2 step handed over as they are: resharded in
    # restore_from_checkpoint itself
    again = fresh()
    live_tree = {**mp_step.state_for_checkpoint().to_tree(),
                 **mp_step.live_state()}
    again.restore_from_checkpoint(live_tree)
    back = again.state_for_checkpoint().to_tree()
    out["handed_over"] = R._tree_copy({k: back[k] for k in ("params",
                                                            "opt_state")})
    # the files read onto the mp-2 step's placements, adopted by the
    # stage-3 step: resharded, not taken for its own blocks (the qkv's
    # segmented mp block and its stage-3 slice have one shape); the same
    # blocks as plain tensors are refused
    cross = fresh()
    at_mp = mgr.restore(shardings=mp_step.checkpoint_shardings())
    cross.restore_from_checkpoint(at_mp)
    back = cross.state_for_checkpoint().to_tree()
    out["cross"] = R._tree_copy({k: back[k] for k in ("params",
                                                      "opt_state")})
    out["refuse_plain"] = R._raises(lambda: cross.restore_from_checkpoint(
        {**at_mp, **_blocks(at_mp)}))
    R._wait_for(directory / "jax_ck.ready")
    ck_arrays.reset_read_stats()
    ranged_jax = CheckpointManager(directory / "jax_ck",
                                   validate_on_restore=False)
    jtree = ranged_jax.restore(shardings=mp_step.checkpoint_shardings())
    out["jax_read"] = ck_arrays.read_stats()
    out["jax_blocks"] = _blocks(jtree)
    return out


def _blocks(tree):
    """params and opt_state of a restored tree, each ``ShardedTensor``'s
    block in its place, copied (``R._tree_copy``)."""
    from paddle_tpu_torch.distributed.resharding import ShardedTensor

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(w) for k, w in v.items()}
        return v.block if isinstance(v, ShardedTensor) else v

    return R._tree_copy({k: walk(tree[k]) for k in ("params", "opt_state")})


def _placed(tree, shardings):
    """Whether each leaf ``shardings`` splits came back as a
    ``ShardedTensor`` of that placement, and every other one as a
    tensor."""
    from paddle_tpu_torch.distributed.resharding import ShardedTensor

    def ok(v, sh):
        if isinstance(v, dict):
            return all(ok(v[k], sh[k]) for k in v)
        if sh.is_replicated:
            return isinstance(v, torch.Tensor)
        return isinstance(v, ShardedTensor) and v.sharding == sh

    return all(ok(tree[k], shardings[k]) for k in ("params", "opt_state"))


def _spec_tree(tree):
    """A shardings tree as plain data: ``(mesh axes, spec, segments)``."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (dict(tree.mesh.shape), [list(e) if isinstance(e, tuple) else e
                                    for e in tree.spec],
            dict(tree.segments))


# ---------------- serving a split model (A5.5b) -----------------------------
#: the engines each split model serves the prompts through
ENGINES = {"paged": {}, "dense": {"kv_layout": "dense"},
           "spec": {"prefix_cache": True, "speculative": 3}}
#: the sampled requests' settings
SAMPLED = SamplingParams(max_new_tokens=8, do_sample=True, temperature=0.8,
                         top_k=20)


def _serve(model, weights, prompts, kw, sampling):
    """One engine on ``model`` (``kw`` its config), ``weights`` loaded by
    ``load_weights``, serving ``prompts``: each request's tokens, finish
    reason and prefix hits, the slot table after every step, the page
    table at the end and the speculation counters."""
    eng = Engine(model, EngineConfig(max_batch_size=2, max_seq_len=64, **kw),
                 device="cpu")
    eng.load_weights(weights)
    reqs = [eng.add_request(p, sampling) for p in prompts]
    slots = []
    while eng.has_unfinished:
        eng.step()
        slots.append([None if r is None else reqs.index(r)
                      for r in eng._slots])
    page = getattr(eng.cache, "page_table", None)
    return {"tokens": [r.output_ids for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "hits": [r.prefix_hit_blocks for r in reqs], "slots": slots,
            "pages": None if page is None else torch.from_numpy(page.copy()),
            "spec": [eng.spec_drafted, eng.spec_accepted],
            "captured": eng.captured,
            "eager_steps": sum(st.eager_steps for st in eng.steps.values()),
            "kv_heads": eng.cache.num_kv_heads}


def _serve_all(cfg, weights, inp):
    """The split model of ``cfg`` (built on the current topology) through
    every engine, greedy, and the paged one sampled; ``generate`` greedy
    and sampled (a generator seeded alike on every rank)."""
    model = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    model.eval()
    greedy = SamplingParams(max_new_tokens=8)
    out = {name: _serve(model, weights, inp["prompts"], kw, greedy)
           for name, kw in ENGINES.items()}
    out["sampled"] = _serve(model, weights, inp["prompts"], {}, SAMPLED)
    ids = inp["gen_ids"]
    out["generate"] = model.generate(ids, max_new_tokens=8)
    out["generate_sampled"] = model.generate(
        ids, max_new_tokens=8, do_sample=True, top_k=20,
        generator=torch.Generator().manual_seed(5))
    return model, out


def job_split_mp2(directory, inp, rank):
    """Two ranks: the tiny GPT at mp 2 served through every engine and
    ``generate``; its weights by ``load_weights`` from a live ZeRO-3
    (``p_g_os``) step at sharding 2 and from that step's sharded save,
    against the same weights whole; a placement the model does not hold
    refused."""
    from paddle_tpu_torch.distributed import resharding as rs

    cfg = {**R.TINY, "num_kv_heads": 2}
    out = {}
    # the sharding-2 step on the second weights, one step taken
    hcg = R._hybrid_init({"sharding_degree": 2})
    model, opt = _model(inp["params2"], num_kv_heads=2)
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                         device="cpu")
    step(inp["x"][0][rank * 2:rank * 2 + 2], inp["y"][0][rank * 2:rank * 2 + 2])
    live = step.live_state()["params"]
    whole = R._tree_copy(step.state_for_checkpoint().to_tree()["params"])
    _save(step, directory / "z3_ck", 1)

    hcg = R._hybrid_init({"mp_degree": 2})
    model, out["mp"] = _serve_all(cfg, from_paddle_tpu(inp["params"]), inp)
    greedy = SamplingParams(max_new_tokens=8)
    eng = Engine(model, EngineConfig(max_batch_size=2, max_seq_len=64),
                 device="cpu")
    rs.reset_stats()
    eng.load_weights(live)
    out["live_stats"] = rs.stats()
    out["live"] = eng.generate(inp["prompts"], greedy)
    tree = CheckpointManager(directory / "z3_ck").restore(
        shardings={"params": eng.shardings()})
    eng.load_weights(tree["params"])
    out["from_save"] = eng.generate(inp["prompts"], greedy)
    eng.load_weights(whole)
    out["whole"] = eng.generate(inp["prompts"], greedy)
    qkv = "gpt.layers.0.attn.qkv.weight"
    out["refuse"] = R._raises(lambda: eng.load_weights(whole, shardings={
        qkv: D.NamedSharding(hcg.get_mesh(), D.PartitionSpec())}))
    out["qkv_block"] = model.gpt.layers[0].attn.qkv.weight.detach().clone()
    out["whole_qkv"] = whole[qkv]
    return out


def job_split_ep2(directory, inp, rank):
    """Two ranks: the tiny GPT-MoE at ep 2 served through every engine and
    ``generate``."""
    R._hybrid_init({"ep_degree": 2})
    cfg = {**R.TINY, "num_layers": 2, "moe_num_experts": 4,
           "moe_every_k": 2, "num_kv_heads": None}
    return {"ep": _serve_all(cfg, from_paddle_tpu(inp["moe_params"]),
                             inp)[1]}


def job_split_ep_mp4(directory, inp, rank):
    """Four ranks: the tiny GPT-MoE at ep 2 x mp 2 served through every
    engine and ``generate``."""
    R._hybrid_init({"ep_degree": 2, "mp_degree": 2})
    cfg = {**R.TINY, "num_layers": 2, "moe_num_experts": 4,
           "moe_every_k": 2, "num_kv_heads": None}
    return {"ep_mp": _serve_all(cfg, from_paddle_tpu(inp["moe_params"]),
                                inp)[1]}


# ---------------- the sharded save (A5.5b) ---------------------------------
#: the tensor collectives of torch.distributed (barriers aside)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "all_to_all",
               "broadcast", "send", "recv", "isend", "irecv", "reduce",
               "gather", "scatter", "all_gather_object",
               "broadcast_object_list")


class _CountCollectives:
    """Counts the calls of ``torch.distributed``'s tensor collectives while
    it is entered (every port module looks them up there at call time)."""

    def __enter__(self):
        self.calls, self._saved = [], {}
        dist = torch.distributed
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.calls.append(_name)
                return _fn(*a, **kw)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(torch.distributed, name, fn)


def _leaf_bytes(t):
    return t.numel() * t.element_size()


def _sharded_save(step, path, rank, at):
    """``state_for_checkpoint()`` and a ``CheckpointManager`` save of it,
    the tensor collectives they make counted; this rank's bytes written
    against its replica-0 blocks' (every split leaf is split over all the
    ranks here, so each rank writes its block of each, and rank 0 the
    whole arrays too); the state gathered by the explicit gather."""
    from paddle_tpu_torch.distributed.resharding import ShardedTensor

    mgr = CheckpointManager(path)
    with _CountCollectives() as count:
        tree = step.state_for_checkpoint().to_tree()
        mgr.save(at, tree)
        mgr.wait_until_finished()
    leaves = [v for part in ("params", "opt_state")
              for v in _flat_leaves(tree[part])]
    blocks = sum(_leaf_bytes(v.block) for v in leaves
                 if isinstance(v, ShardedTensor))
    whole = sum(_leaf_bytes(torch.as_tensor(np.asarray(v)))
                for v in leaves if not isinstance(v, ShardedTensor))
    out = {"collectives": count.calls, "bytes": mgr.last_save["bytes"],
           "expected": blocks + (whole if rank == 0 else 0),
           "sharded": sum(isinstance(v, ShardedTensor) for v in leaves),
           "blocking_s": mgr.last_save["blocking_s"],
           "gathered": R._tree_copy({k: tree[k] for k in
                                     ("params", "opt_state")})}
    mgr.close()
    return out


def _flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat_leaves(v)]
    return [tree] if tree is not None and not isinstance(
        tree, (int, float, str)) else []


def job_sharded_save2(directory, inp, rank):
    """Two ranks: the tiny GPT at mp 2 and at ZeRO-3 sharding 2 and the
    tiny GPT-MoE at ep 2, two steps each, saved sharded (no collective;
    each rank its replica-0 blocks; at mp 2 through ``framework.io.
    save_sharded`` too), then restored into a step built on other weights,
    which takes the third step."""
    xs, ys = inp["x"], inp["y"]
    half = slice(rank * xs.shape[1] // 2, (rank + 1) * xs.shape[1] // 2)
    out = {}

    def run(key, make, rows):
        step = make(inp["params"] if key != "ep" else inp["moe_params"])
        for k in range(2):
            step(xs[k][rows], ys[k][rows])
        out[key] = _sharded_save(step, directory / f"{key}_ck", rank, 2)
        if key == "mp":  # the same blocks through framework.io
            save_sharded(step.state_for_checkpoint().to_tree(),
                         str(directory / "mp_io"))
        noise = {k: torch.randn_like(v) for k, v in (
            inp["params"] if key != "ep" else inp["moe_params"]).items()}
        fresh = make(noise)
        fresh.restore_from_checkpoint(CheckpointManager(
            directory / f"{key}_ck").restore(
                shardings=fresh.checkpoint_shardings()))
        out[key]["resumed"] = fresh(xs[2][rows], ys[2][rows]).item()

    hcg = R._hybrid_init({"mp_degree": 2})
    run("mp", lambda w: R._tp_step(
        from_paddle_tpu({k: v.numpy() for k, v in w.items()},
                        mp_rank=rank, mp_degree=2), hcg), slice(None))
    hcg = R._hybrid_init({"sharding_degree": 2})
    run("zero3", lambda w: _z3_step(w, hcg.get_mesh())[1], half)
    hcg = R._hybrid_init({"ep_degree": 2})
    run("ep", lambda w: fleet.make_sharded_train_step(
        *_moe_model(w, hcg=hcg), mesh=hcg.get_mesh(), device="cpu"), half)
    return out


# ---------------- pipeline parallelism ---------------------------------------
class PLHead(torch.nn.Module):
    """The tied head of the pipeline-layer test: ``x @ W``."""

    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(8, 8))

    def forward(self, x):
        return x @ self.weight


class PLLinear(torch.nn.Module):
    """``x @ W + b`` with the JAX package's ``[in, out]`` weight."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.weight + self.bias


def pl_descs():
    """The pipeline-layer test's descs: a shared head used first and last
    (the second time transposed), two linears around a tanh."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, SharedLayerDesc)

    return [SharedLayerDesc("tied", PLHead), LayerDesc(PLLinear, 8, 8),
            LayerDesc(torch.nn.Tanh), LayerDesc(PLLinear, 8, 8),
            SharedLayerDesc("tied", PLHead,
                            forward_func=lambda layer, x: x @ layer.weight.T)]


def _pp_model(params, clip=R.CLIP, **cfg):
    """The 4-block tiny GPT (or ``cfg``'s) on ``params`` (whole or this
    rank's blocks) and its AdamW."""
    base = {**R.TINY, "num_layers": 4, **cfg}
    model = GPTForCausalLM(GPTConfig(**base), device="cpu")
    model.load_state_dict(params, strict=False)
    model.train()
    return model, AdamW(learning_rate=R.LR, epsilon=R.EPS, weight_decay=0.01,
                        parameters=model.named_parameters(),
                        grad_clip=None if clip is None
                        else ClipGradByGlobalNorm(clip))


def _pp_run(params, xs, ys, rows=slice(None), steps=3, cfg=None, wrap=None,
            mesh=None, **kw):
    """``steps`` steps of the pipelined step on ``params``: the losses and
    this rank's parameters after them."""
    model, opt = _pp_model(params, **(cfg or {}))
    if wrap is not None:
        model, opt = wrap(model, opt)
    step = fleet.make_sharded_train_step(model, opt, device="cpu", mesh=mesh,
                                         **kw)
    losses = [step(xs[k][rows], ys[k][rows]).item() for k in range(steps)]
    inner = model._layers if hasattr(model, "_layers") else model
    return {"losses": losses,
            "params": {k: v.detach().clone()
                       for k, v in inner.state_dict().items()},
            "stats": dict(step.pp_stats)}


def _wait_for(path, timeout=45.0):
    import time

    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)


def _forwards_alone(ws, fx, rank):
    """Every schedule without a loss, and ``spmd_pipeline``: ``tanh(h @
    w)`` a chunk, chunk ``c``'s weight ``ws[c]`` (two chunks a stage under
    interleaving), over the microbatches ``fx``."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        pipeline_parallel as P

    def tanh_stage(w, h):
        return torch.tanh(h @ w)

    mine = [ws[rank], ws[2 + rank]]
    return {"gpipe": P.pipeline_schedule(tanh_stage, ws[rank], fx),
            "1f1b": P.pipeline_schedule_1f1b(tanh_stage, ws[rank], fx),
            "interleaved": P.pipeline_schedule_interleaved(
                tanh_stage, mine, fx, virtual_stages=2),
            "interleaved_1f1b": P.pipeline_schedule_interleaved_1f1b(
                tanh_stage, mine, fx, virtual_stages=2),
            "spmd": P.spmd_pipeline(tanh_stage, ws[rank], fx)}


def _evals(pp, x, y):
    """``eval_batch`` with and without ``compute_loss``."""
    return [pp.eval_batch((x, y), compute_loss=c) for c in (True, False)]


def job_pp2(directory, inp, rank):
    """Two ranks at pp 2: the tiny GPT (4 blocks) 3 steps under 1f1b,
    gpipe, no remat, 2 virtual stages and 4 microbatches; the tiny GPT-MoE
    under 1f1b and gpipe; dropout 0.1 under 1f1b, gpipe and no remat, and
    1f1b again; an infinite loss scale; the checkpoint both ways;
    ``PipelineParallel.train_batch`` and ``eval_batch`` over a
    ``PipelineLayer``; and every schedule's forwards alone."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)

    hcg = R._hybrid_init({"pp_degree": 2})
    xs, ys = inp["x"], inp["y"]
    params = inp["params"]
    out = {"stage": hcg.get_stage_id(), "first": hcg.is_first_stage(),
           "last": hcg.is_last_stage(),
           "group": hcg.get_pipe_parallel_group().ranks,
           "fwd": _forwards_alone(inp["fwd_w"], inp["fwd_x"], rank)}
    runs = {"1f1b": {}, "gpipe": {"pp_schedule": "gpipe"},
            "noremat": {"pp_remat": False}, "vpp2": {"virtual_pp_degree": 2},
            "m4": {"accumulate_steps": 4}}
    for name, kw in runs.items():
        out[name] = _pp_run(params, xs, ys, **kw)
    # the stage's blocks are loaded from the JAX package's stacked names
    stacked = {k: v.numpy() for k, v in inp["stacked"].items()}
    out["from_stacked"] = _pp_run(
        from_paddle_tpu(stacked, pp_rank=rank, pp_degree=2), xs, ys)
    for name, kw in (("moe_1f1b", {}), ("moe_gpipe", {"pp_schedule": "gpipe"})):
        out[name] = _pp_run(inp["moe_params"], xs, ys, cfg=dict(
            num_layers=2, moe_num_experts=4, moe_every_k=1,
            num_kv_heads=None), **kw)
    for name, kw in (("1f1b", {}), ("gpipe", {"pp_schedule": "gpipe"}),
                     ("noremat", {"pp_remat": False}), ("again", {})):
        out[f"drop_{name}"] = _pp_run(params, xs, ys, cfg={"dropout": 0.1},
                                      **kw)
    # an infinite loss scale: both stages skip, the scale backs off
    model, opt = _pp_model(params)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    scaler.set_init_loss_scaling(float("inf"))
    step = fleet.make_sharded_train_step(model, opt, scaler=scaler,
                                         device="cpu")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step(xs[0], ys[0])
    out["inf"] = {"same": all(torch.equal(before[k], v) for k, v in
                              model.state_dict().items()),
                  "good": scaler._good_steps, "step": step.step_index}
    scaler.set_init_loss_scaling(2.0 ** 10)  # a finite scale trains again
    step(xs[0], ys[0])
    out["inf"]["moved"] = not all(torch.equal(before[k], v) for k, v in
                                  model.state_dict().items())
    # the checkpoint: this run saved at step 2, then its third step
    model, opt = _pp_model(params)
    step = fleet.make_sharded_train_step(model, opt, device="cpu")
    for k in range(2):
        step(xs[k], ys[k])
    out["save"] = _sharded_save(step, directory / "port_ck", rank, 2)
    out["save"]["names"] = sorted(step.state_for_checkpoint().params)
    out["save"]["third"] = step(xs[2], ys[2]).item()
    # a JAX pp-2 save at step 2 restored into a step of other weights
    _wait_for(directory / "jax_ck.ready")
    model, opt = _pp_model({k: v * 0.5 for k, v in params.items()})
    step = fleet.make_sharded_train_step(model, opt, device="cpu")
    mgr = CheckpointManager(directory / "jax_ck")
    step.restore_from_checkpoint(mgr.restore(
        shardings=step.checkpoint_shardings()))
    mgr.close()
    out["restored"] = R._tree_copy({k: step.state_for_checkpoint().to_tree()[k]
                                    for k in ("params", "opt_state")})
    out["resumed"] = step(xs[2], ys[2]).item()
    # the eager API over a PipelineLayer with a tied layer on both stages
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"pp_degree": 2}
    st.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    pl = PipelineLayer(pl_descs(), loss_fn=lambda o, y: ((o - y) ** 2).mean())
    pl.load_state_dict({k: v for k, v in inp["pl_params"].items()
                        if k in pl.state_dict()})
    pp = fleet.distributed_model(pl)
    opt = AdamW(learning_rate=1e-2, parameters=pl.named_parameters())
    out["pl"] = {"kind": type(pp).__name__, "bounds": pl.segment_bounds,
                 "names": sorted(pl.state_dict()),
                 "losses": [pp.train_batch((inp["pl_x"], inp["pl_y"]),
                                           opt).item() for _ in range(3)],
                 "params": {k: v.detach().clone()
                            for k, v in pl.state_dict().items()},
                 "eval": _evals(pp, inp["pl_x"], inp["pl_y"])}
    # the interleaved eager API: four linears, two virtual stages
    st.pipeline_configs = {"accumulate_steps": 2, "virtual_pp_degree": 2}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    pl = PipelineLayer([LayerDesc(PLLinear, 8, 8) for _ in range(4)],
                       loss_fn=lambda o, y: ((o - y) ** 2).mean(),
                       num_virtual_pipeline_stages=2)
    pl.load_state_dict({k: v for k, v in inp["vpp_params"].items()
                        if k in pl.state_dict()})
    pp = fleet.distributed_model(pl)
    opt = AdamW(learning_rate=1e-2, parameters=pl.named_parameters())
    out["pl_vpp"] = {"kind": type(pp).__name__,
                     "names": sorted(pl.state_dict()),
                     "losses": [pp.train_batch((inp["pl_x"], inp["pl_y"]),
                                               opt).item() for _ in range(3)],
                     "params": {k: v.detach().clone()
                                for k, v in pl.state_dict().items()},
                     "eval": _evals(pp, inp["pl_x"], inp["pl_y"])}
    return out


def _intact(model, opt):
    """Whether a refused step left ``model`` whole (every block there)
    and ``opt`` holding every parameter of it."""
    while hasattr(model, "_layers"):
        model = model._layers
    while not hasattr(opt, "_params"):
        opt = getattr(opt, "_inner_opt", None) or opt._inner
    return all(b is not None for b in model.gpt.layers) \
        and {id(p) for p in opt._params.values()} \
        == {id(p) for p in model.parameters()}


def job_pp4(directory, inp, rank):
    """Four ranks: the tiny GPT (4 blocks) 3 steps at pp 2 x dp 2, pp 2 x
    mp 2 and pp 2 x sharding 2 (``os_g``); ``p_g_os`` and ep at pp raise,
    leaving the model and the optimizer as they were."""
    xs, ys, params = inp["x"], inp["y"], inp["params"]
    out = {}
    hcg = R._hybrid_init({"dp_degree": 2, "pp_degree": 2})
    half = slice(hcg.get_data_parallel_rank() * 4,
                 (hcg.get_data_parallel_rank() + 1) * 4)
    out["dp"] = _pp_run(params, xs, ys, rows=half)
    hcg = R._hybrid_init({"pp_degree": 2, "mp_degree": 2})
    np_params = {k: v.numpy() for k, v in params.items()}
    out["mp"] = _pp_run(from_paddle_tpu(
        np_params, mp_rank=hcg.get_model_parallel_rank(), mp_degree=2),
        xs, ys)
    hcg = R._hybrid_init({"pp_degree": 2, "sharding_degree": 2})
    half = slice(hcg.get_sharding_parallel_rank() * 4,
                 (hcg.get_sharding_parallel_rank() + 1) * 4)

    def zero(level):
        return lambda m, o: group_sharded_parallel(m, o, level=level)[:2]

    out["sh"] = _pp_run(params, xs, ys, rows=half, wrap=zero("os_g"),
                        mesh=hcg.get_mesh())
    model, opt = group_sharded_parallel(*_pp_model(params),
                                        level="p_g_os")[:2]
    out["p_g_os"] = R._raises(lambda: fleet.make_sharded_train_step(
        model, opt, mesh=hcg.get_mesh(), device="cpu"))
    out["p_g_os_intact"] = _intact(model, opt)
    hcg = R._hybrid_init({"pp_degree": 2, "ep_degree": 2})
    model, opt = _pp_model(params, num_layers=2, moe_num_experts=4,
                           moe_every_k=1)
    out["ep"] = R._raises(lambda: fleet.make_sharded_train_step(
        model, opt, mesh=hcg.get_mesh(), device="cpu"))
    out["ep_intact"] = _intact(model, opt)
    return out


JOBS = {"reducer": job_reducer, "grad_reduce": job_grad_reduce,
        "zero3": job_zero3, "zero3_state": job_zero3_state,
        "dp_sharding_4": job_dp_sharding_4,
        "dp_mp_4": job_dp_mp_4, "ep2": job_ep2, "ep4": job_ep4,
        "moe_mp2": job_moe_mp2, "moe_mp4": job_moe_mp4,
        "moe_layer_ep2": job_moe_layer_ep2,
        "split_mp2": job_split_mp2, "split_ep2": job_split_ep2,
        "split_ep_mp4": job_split_ep_mp4,
        "sharded_save2": job_sharded_save2,
        "reshard": job_reshard, "reshard_ckpt": job_reshard_ckpt,
        "pp2": job_pp2, "pp4": job_pp4}
