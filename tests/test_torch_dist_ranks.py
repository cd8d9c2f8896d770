"""The rank jobs of the port's multi-process tests, and the port's data
parallelism in one process. Imports no JAX: this file is also the script
each rank runs.

``Ranks(job, directory)`` starts two ranks of ``python
tests/test_torch_dist_ranks.py <job> <directory>`` (or one launcher,
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``,
that starts them) meeting at a file store in ``directory`` over gloo on
the CPU. Each rank reads ``directory/inputs.pt``, runs the job (one of
this file's, or of ``tests/torch_dist_jobs.py``) and writes
``directory/out.<rank>.pt``. The ranks run in a process group of their
own session and are killed, all of them, when they outlive their
timeout (at most 60 s from their start), so a hung rendezvous fails a
test instead of holding the suite. ``tests/test_torch_distributed.py``
holds the jobs' results against the JAX package.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.resharding import ShardedTensor, gather
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT = 60
#: the dp jobs' model: tiny GPT, GQA 4/2, fp32, no dropout unless asked
TINY = {**GPT_TINY, "num_kv_heads": 2, "dropout": 0.0}
#: AdamW at epsilon 1e-6, as chip_smoke's [9]: at 1e-8 an entry whose
#: gradient is at the fp32 rounding level of its tensor's largest moves by
#: up to lr on rounding noise alone, in the JAX package as in the port
LR, EPS, CLIP = 1e-3, 1e-6, 0.5


# ---------------- spawning ------------------------------------------------
class Ranks:
    """``job`` on ``world`` gloo ranks over a file store in ``directory``,
    started at once (the caller computes its reference meanwhile):
    ``results()`` waits for them, at most ``timeout`` seconds from the
    start, and returns each rank's outputs; it fails, after killing every
    process it started, when a rank fails or they run out of time. Use it
    as a context manager, which kills whatever still runs on the way
    out."""

    def __init__(self, job, directory, world=2, launcher=False,
                 timeout=SPAWN_TIMEOUT):
        self.job, self.dir, self.world = job, Path(directory), world
        self.launcher, self.timeout = launcher, timeout
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
        script = [str(Path(__file__).resolve()), job, str(self.dir)]
        if launcher:
            runs = [([sys.executable, "-m",
                      "paddle_tpu_torch.distributed.launch",
                      "--nproc_per_node", str(world), "--log_dir",
                      str(self.dir / "log"), *script], env)]
        else:
            runs = [([sys.executable, *script],
                     {**env, "PADDLE_TRAINER_ID": str(r),
                      "PADDLE_TRAINERS_NUM": str(world),
                      "PADDLE_MASTER": f"file://{self.dir / 'store'}"})
                    for r in range(world)]
        self.deadline = time.monotonic() + timeout
        # a session each: killing it kills a launcher's workers too
        self.procs = [subprocess.Popen(cmd, env=e, cwd=self.dir, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       start_new_session=True)
                      for cmd, e in runs]

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def results(self):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(
                    timeout=max(self.deadline - time.monotonic(), 0.1))[0])
        except subprocess.TimeoutExpired:
            outs.append(f"still running after {self.timeout} s")
        finally:
            self._kill()
        logs = "".join(f"\n--- {f.name}\n{f.read_text()}" for f in sorted(
            (self.dir / "log").glob("workerlog.*"))) if self.launcher else ""
        codes = [p.returncode for p in self.procs]
        assert codes == [0] * len(self.procs), \
            f"{self.job}: exit codes {codes}\n" + "\n".join(outs) + logs
        return [torch.load(self.dir / f"out.{r}.pt")
                for r in range(self.world)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._kill()


def main(job, directory):
    torch.set_num_threads(1)
    directory = Path(directory)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    fn = JOBS.get(job)
    if fn is None:  # the ZeRO-3 and gradient-reduction jobs
        import torch_dist_jobs

        fn = torch_dist_jobs.JOBS[job]
    out = fn(directory, torch.load(directory / "inputs.pt"), rank)
    torch.save(out, directory / f"out.{rank}.pt")
    if torch.distributed.is_initialized():
        D.barrier()  # no rank leaves while a peer's receive is in flight
    D.destroy_process_group()


# ---------------- the jobs ------------------------------------------------
def _dp_init():
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _tiny_on(params, dropout=0.0, clip=CLIP):
    """The tiny GPT on ``params`` and its AdamW (no clip for None)."""
    model = GPTForCausalLM(GPTConfig(**{**TINY, "dropout": dropout}),
                           device="cpu")
    model.load_state_dict(params)
    model.train()
    return model, AdamW(learning_rate=LR, epsilon=EPS,
                        parameters=model.named_parameters(),
                        weight_decay=0.01, grad_clip=None if clip is None
                        else ClipGradByGlobalNorm(clip))


def _dp_step(params, hcg, accum=None, scaler=None, dropout=0.0, clip=CLIP):
    """The tiny GPT on ``params`` through fleet's wrappers and
    ``make_sharded_train_step(mesh=)`` over the dp mesh."""
    model, opt = _tiny_on(params, dropout, clip)
    return fleet.make_sharded_train_step(
        fleet.distributed_model(model), fleet.distributed_optimizer(opt),
        mesh=hcg.get_mesh(), accumulate_steps=accum, scaler=scaler,
        device="cpu")


def _snapshot(step):
    return {k: p.detach().clone() for k, p in step.params.items()}


def _local(batch, rank, world=2):
    n = batch.shape[0] // world
    return batch[rank * n:(rank + 1) * n]


def _raises(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "did not raise"


def job_collectives(directory, inp, rank):
    """Every collective on per-rank values; then the refusals of what is
    left to later items, the dp topology, and each rank's pipeline."""
    from paddle_tpu_torch.data import build_pretrain_pipeline

    D.init_parallel_env(device="cpu")
    vals, chunks = inp["vals"], inp["chunks"]
    out = {"rank": D.get_rank(), "world": D.get_world_size(),
           "backend": D.get_backend()}

    def mine():
        return D.to_per_rank(list(vals))

    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = mine()
        D.all_reduce(t, op=getattr(D.ReduceOp, op))
        out[f"all_reduce_{op}"] = t
    t = mine()
    D.reduce(t, dst=0)
    out["reduce"] = t
    t = mine()
    D.broadcast(t, src=1)
    out["broadcast"] = t
    got = []
    D.all_gather(got, mine())
    out["all_gather"] = torch.stack(got)
    got = []
    D.gather(mine(), got, dst=0)
    out["gather"] = torch.stack(got)
    t = torch.empty(chunks.shape[-1])
    D.reduce_scatter(t, list(chunks[rank]))
    out["reduce_scatter"] = t
    t = torch.empty(vals.shape[-1])
    D.scatter(t, list(inp["scatter"]) if rank == 0 else None, src=0)
    out["scatter"] = t
    got = []
    D.alltoall(list(chunks[rank]), got)
    out["alltoall"] = torch.stack(got)
    t = torch.empty(chunks[rank].numel())
    D.alltoall_single(chunks[rank].reshape(-1), t)
    out["alltoall_single"] = t
    if rank == 0:
        D.send(vals[0].clone(), dst=1)
    else:
        t = torch.empty(vals.shape[-1])
        D.recv(t, src=0)
        out["recv"] = t
    got = []
    D.all_gather_object(got, {"rank": rank})
    out["all_gather_object"] = [g["rank"] for g in got]
    objs = [f"from {rank}"]
    D.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    D.barrier()

    # a pp degree builds the pp group (A5.6); the sep degree, left to a
    # later item, raises before any group forms
    for key in ("pp_degree", "sep_degree"):
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 1, key: 2}
        out[f"refuse_{key}"] = _raises(lambda: fleet.init(
            is_collective=True, strategy=st, device="cpu"))
        if key == "pp_degree":
            hcg = fleet.get_hybrid_communicate_group()
            out["pp_hcg"] = [hcg.get_pipe_parallel_group().ranks,
                             hcg.get_stage_id(), hcg.is_first_stage(),
                             hcg.is_last_stage(),
                             hcg.get_pipe_parallel_world_size()]

    def record(hcg):
        topo = hcg.topology()
        return {
            "coords": [hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                       hcg.get_sharding_parallel_rank(),
                       hcg.get_sep_parallel_rank(),
                       hcg.get_expert_parallel_rank(),
                       hcg.get_model_parallel_rank()],
            "groups": {a: g.ranks for a, g in hcg._groups.items()},
            "axis_sizes": hcg.axis_sizes(),
            "mode": hcg.get_parallel_mode(),
            "comm_lists": {n: topo.get_comm_list(n)
                           for n in topo.get_hybrid_group_names()},
            "dp_world": hcg.get_data_parallel_world_size(),
            "ep": [hcg.get_expert_parallel_rank(),
                   hcg.get_expert_parallel_world_size(),
                   hcg.get_expert_parallel_group().ranks],
            "mesh": hcg.get_mesh().devices.tolist(),
        }

    out["ep_hcg"] = record(_hybrid_init({"ep_degree": 2}))
    hcg = _dp_init()
    out["hcg"] = record(hcg)
    # a GPT-MoE step at dp 2 routes the global batch: its first loss is
    # one process's on the whole batch
    moe = GPTForCausalLM(GPTConfig(**{**TINY, "moe_num_experts": 4,
                                      "moe_every_k": 2}), device="cpu")
    step = fleet.make_sharded_train_step(
        moe, AdamW(parameters=moe.named_parameters()), mesh=hcg.get_mesh(),
        device="cpu")
    x = inp["x"][0][2 * rank:2 * rank + 2]
    out["moe_loss"] = step(x, torch.roll(x, -1, 1)).item()
    step = _dp_step(inp["params"], hcg)
    x = inp["x"][0][:2 - rank]  # rank 0 two rows, rank 1 one
    out["refuse_rows"] = _raises(lambda: step(x, torch.roll(x, -1, 1)))

    pipe = build_pretrain_pipeline(inp["paths"], 2, 24, eos_id=inp["eos"],
                                   seed=4, shuffle_records=True,
                                   device_feed=False)
    it = iter(pipe)
    out["batches"] = [{k: torch.as_tensor(v) for k, v in next(it).items()}
                      for _ in range(3)]
    return out


def _run(step, xs, ys, rank):
    """Every step on this rank's rows: the losses, the parameters after
    each step."""
    losses, after = [], []
    for k in range(xs.shape[0]):
        losses.append(step(_local(xs[k], rank), _local(ys[k], rank)).item())
        after.append(_snapshot(step))
    return {"losses": losses, "params": after}


def job_dp_step(directory, inp, rank):
    """The dp step without ``fleet.init`` (the world as the dp axis: a bare
    model and one in ``DataParallel``), then through fleet: plain, with
    accumulate_steps=2, without a clip (the averaged gradients of its
    first step), and with a scaler that overflows on rank 1 only; the
    parameters after every step, and the dropout masks of one step on the
    same rows."""
    xs, ys, params = inp["x"], inp["y"], inp["params"]
    D.init_parallel_env(device="cpu")
    out = {}
    for name, wrap in (("world", False), ("wrapped", True)):
        model, opt = _tiny_on(params)
        out[name] = _run(fleet.make_sharded_train_step(
            D.DataParallel(model) if wrap else model, opt, device="cpu"),
            xs, ys, rank)
    hcg = _dp_init()
    for name, accum in (("plain", None), ("accum", 2)):
        out[name] = _run(_dp_step(params, hcg, accum=accum), xs, ys, rank)
    step = _dp_step(params, hcg, clip=None)
    step(_local(xs[0], rank), _local(ys[0], rank))
    out["grads"] = {k: p.grad.clone() for k, p in step.params.items()}

    sc = amp.GradScaler(init_loss_scaling=float("inf") if rank else 2.0 ** 10,
                        incr_every_n_steps=2)
    step = _dp_step(params, hcg, scaler=sc)
    first = step(_local(xs[0], rank), _local(ys[0], rank)).item()
    rec = {"first_loss": first, "skipped": _snapshot(step),
           "state": {n: {k: v.clone() for k, v in s.items()
                         if torch.is_tensor(v)}
                     for n, s in step.optimizer.state.items()},
           "automaton": [(sc._scale, sc._good_steps, sc._bad_steps)],
           "losses": []}
    sc.set_init_loss_scaling(2.0 ** 10)
    for k in (1, 2):
        rec["losses"].append(step(_local(xs[k], rank),
                                  _local(ys[k], rank)).item())
        rec["automaton"].append((sc._scale, sc._good_steps, sc._bad_steps))
    rec["params"] = _snapshot(step)
    out["scaler"] = rec

    step = _dp_step(params, hcg, dropout=0.1)
    masks = []
    drop = next(m for m in step.model.modules()
                if isinstance(m, port_nn.Dropout))
    drop.register_forward_hook(lambda m, a, o: masks.append(o == 0))
    step(xs[0][:2], ys[0][:2])  # the same rows on both ranks
    out["dropout_mask"] = masks[0]
    return out


def job_ckpt(directory, inp, rank):
    """A two-rank async save after 2 dp steps; the JAX package's save
    restored into a step built on other weights."""
    hcg = _dp_init()
    step = _dp_step(inp["params"], hcg)
    for k in range(2):
        step(_local(inp["x"][k], rank), _local(inp["y"][k], rank))
    mgr = CheckpointManager(directory / "port_ck")
    mgr.save(2, step.state_for_checkpoint().to_tree())
    mgr.wait_until_finished()
    mgr.close()
    out = {"saved": _tree_copy(step.state_for_checkpoint().to_tree())}
    other = {k: torch.randn_like(v) for k, v in inp["params"].items()}
    fresh = _dp_step(other, hcg)
    fresh.restore_from_checkpoint(CheckpointManager(
        directory / "jax_ck").restore(shardings=fresh.checkpoint_shardings()))
    out["restored"] = _tree_copy(fresh.state_for_checkpoint().to_tree())
    out["restored_step"] = fresh.step_index
    return out


def _tree_copy(tree):
    """Tensors and numpy leaves as CPU tensors (numpy scalars as 0-d
    tensors of their dtype), ``ShardedTensor`` blocks gathered into their
    whole arrays (``resharding.gather``: collective, so every rank copies
    the same tree), JSON leaves as they are."""
    if isinstance(tree, ShardedTensor):
        return gather(tree).detach().clone()
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


# ---------------- tensor parallelism and ZeRO (A5.3) ----------------------
def _hybrid_init(dims):
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dims
    fleet.init(is_collective=True, strategy=st, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _hcg_record(hcg):
    topo = hcg.topology()
    return {
        "coords": [hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                   hcg.get_sharding_parallel_rank(),
                   hcg.get_sep_parallel_rank(),
                   hcg.get_expert_parallel_rank(),
                   hcg.get_model_parallel_rank()],
        "groups": {a: g.ranks for a, g in hcg._groups.items()},
        "axis_sizes": hcg.axis_sizes(),
        "mode": hcg.get_parallel_mode(),
        "comm_lists": {n: topo.get_comm_list(n)
                       for n in topo.get_hybrid_group_names()},
        "mesh": hcg.get_mesh().devices.tolist(),
    }


def _mp_ops_results(cases, g):
    """Each ``mp_ops`` function on this rank's shards of ``cases``' global
    inputs: its output, and the gradients of ``(w * out).sum()`` (``w``
    this rank's part of the cotangent) for its float inputs."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops

    r, n = g.rank, g.nranks

    def part(t, dim):
        return t.chunk(n, dim)[r].clone()

    def run(fn, args, w):
        args = [a.requires_grad_(True) if a.is_floating_point() else a
                for a in args]
        out = fn(*args)
        (w * out).sum().backward()
        return {"out": out.detach(),
                "grads": [a.grad for a in args if a.is_floating_point()]}

    c = cases
    return {
        "col": run(lambda x, W, b: mp_ops.column_parallel_linear(
            x, W, b, g), [c["x"].clone(), part(c["W1"], 1),
                          part(c["b1"], 0)], part(c["w1"], 1)),
        "col_gather": run(lambda x, W, b: mp_ops.column_parallel_linear(
            x, W, b, g, gather_output=True), [c["x"].clone(),
                                              part(c["W1"], 1),
                                              part(c["b1"], 0)], c["w1"]),
        "row": run(lambda h, W, b: mp_ops.row_parallel_linear(h, W, b, g),
                   [part(c["h"], 1), part(c["W2"], 0), c["b2"].clone()],
                   c["w2"]),
        "emb": run(lambda t, i: mp_ops.vocab_parallel_embedding(i, t, g),
                   [part(c["table"], 0), c["ids"]], c["w3"]),
        "ce": run(lambda lg, lb: mp_ops.parallel_cross_entropy(lg, lb, g),
                  [part(c["logits"], 1), c["labels"]], c["w4"]),
    }


def _tp_step(blocks, hcg, dropout=0.0, mesh=None, **kw):
    """The tiny GPT from this rank's ``blocks`` through fleet's wrappers
    and ``make_sharded_train_step``."""
    model, opt = _tiny_on(blocks, dropout)
    return fleet.make_sharded_train_step(
        fleet.distributed_model(model), fleet.distributed_optimizer(opt),
        mesh=mesh or hcg.get_mesh(), device="cpu", **kw)


def _replicated_bits(step):
    """The parameters every rank holds whole: all of them without mp, the
    replicated ones at mp."""
    return {k: p.detach().clone() for k, p in step.params.items()
            if step._mp.nranks == 1 or not getattr(p, "is_distributed",
                                                   False)}


def _run_global(step, xs, ys, rows):
    """Every step on ``rows`` of each batch: the losses, the global
    parameters after the last step, and the replicated parameters after
    each step."""
    losses, reps = [], []
    for k in range(xs.shape[0]):
        losses.append(step(xs[k][rows], ys[k][rows]).item())
        reps.append(_replicated_bits(step))
    tree = step.state_for_checkpoint().to_tree()
    return {"losses": losses, "params": _tree_copy(tree["params"]),
            "replicated": reps}


def _wait_for(path, seconds=SPAWN_TIMEOUT):
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > seconds:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


def job_mp(directory, inp, rank):
    """Two ranks at mp 2: the topology; each ``mp_ops`` function on this
    rank's shards; 3 steps of the tiny GPT on the whole batch (plain, with
    ``param_specs`` replicating layer 0's qkv weight, with dropout 0.1);
    what mp leaves to later items; a save after 2 steps, and the JAX
    package's save restored into a fresh step."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
    from paddle_tpu_torch.weights import from_paddle_tpu

    hcg = _hybrid_init({"mp_degree": 2})
    mp_rank = hcg.get_model_parallel_rank()
    out = {"hcg": _hcg_record(hcg),
           "mp_ops": _mp_ops_results(inp["mp_ops"],
                                     hcg.get_model_parallel_group())}
    lg = inp["mp_ops"]["logits"].chunk(2, 1)[mp_rank].to(torch.bfloat16)
    labels = inp["mp_ops"]["labels"]
    g = hcg.get_model_parallel_group()
    out["ce_bf16_err"] = float((mp_ops.parallel_cross_entropy(lg, labels, g)
                                - mp_ops.parallel_cross_entropy(
                                    lg.float(), labels, g)).abs().max())
    blocks = from_paddle_tpu(inp["params"], mp_rank=mp_rank, mp_degree=2)
    xs, ys = inp["x"], inp["y"]
    out["plain"] = _run_global(_tp_step(blocks, hcg), xs, ys, slice(None))
    spec = {"gpt.layers.0.attn.qkv.weight": D.PartitionSpec()}
    out["spec"] = _run_global(_tp_step(blocks, hcg, param_specs=spec), xs,
                              ys, slice(None))
    out["dropout"] = _run_global(_tp_step(blocks, hcg, dropout=0.1), xs, ys,
                                 slice(None))
    moe = {**TINY, "moe_num_experts": 4, "moe_every_k": 1}
    out["moe_w1"] = tuple(GPTForCausalLM(GPTConfig(**moe), device="cpu")
                          .gpt.layers[0].mlp.w1.shape)
    out["refuse_kv"] = _raises(lambda: GPTForCausalLM(GPTConfig(
        **{**TINY, "num_kv_heads": 1}), device="cpu"))
    model, _ = _tiny_on(blocks)
    with torch.no_grad():  # serving at mp: the whole logits on every rank
        out["serving"] = model.prefill_with_cache(xs[0][:1, :8])[0]

    step = _tp_step(blocks, hcg)
    for k in range(2):
        step(xs[k], ys[k])
    mgr = CheckpointManager(directory / "port_ck")
    mgr.save(2, step.state_for_checkpoint().to_tree())
    mgr.wait_until_finished()
    mgr.close()
    out["saved"] = _tree_copy(step.state_for_checkpoint().to_tree())
    _wait_for(directory / "jax_ck.ready")
    fresh = _tp_step({k: torch.randn_like(v) for k, v in blocks.items()}, hcg)
    fresh.restore_from_checkpoint(CheckpointManager(directory /
                                                    "jax_ck").restore())
    out["restored"] = _tree_copy(fresh.state_for_checkpoint().to_tree())
    out["restored_blocks"] = {k: p.detach().clone()
                              for k, p in fresh.params.items()}
    return out


def job_dp_mp(directory, inp, rank):
    """Four ranks at dp 2 x mp 2: the topology, and 3 steps of the tiny
    GPT, each dp rank on its half of every batch."""
    from paddle_tpu_torch.weights import from_paddle_tpu

    hcg = _hybrid_init({"dp_degree": 2, "mp_degree": 2})
    blocks = from_paddle_tpu(inp["params"],
                             mp_rank=hcg.get_model_parallel_rank(),
                             mp_degree=2)
    n = inp["x"].shape[1] // 2
    dp = hcg.get_data_parallel_rank()
    return {"hcg": _hcg_record(hcg),
            "plain": _run_global(_tp_step(blocks, hcg), inp["x"], inp["y"],
                                 slice(dp * n, (dp + 1) * n))}


def job_zero(directory, inp, rank):
    """Two ranks at sharding 2, levels ``os`` and ``os_g``: 3 steps of the
    tiny GPT on each rank's half of every batch, on the ``{"sharding":
    2}`` mesh; each rank's optimizer-state shapes; then a stage-2 save
    after 2 steps."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        group_sharded_parallel)

    hcg = _hybrid_init({"sharding_degree": 2})
    mesh = D.DeviceMesh([0, 1], ("sharding",))
    out = {"hcg": _hcg_record(hcg)}
    for level in ("os", "os_g"):
        model, opt = _tiny_on(inp["params"])
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        step = fleet.make_sharded_train_step(
            model, opt, mesh=mesh, device="cpu")
        rec = _run_global(step, inp["x"], inp["y"],
                          slice(rank * 2, rank * 2 + 2))
        rec["state_shapes"] = {n: {k: tuple(v.shape) for k, v in s.items()
                                   if torch.is_tensor(v)}
                               for n, s in step.optimizer.state.items()}
        out[level] = rec
    model, opt = _tiny_on(inp["params"])
    model, opt, _ = group_sharded_parallel(model, opt, level="os_g")
    step = fleet.make_sharded_train_step(model, opt, mesh=mesh,
                                         device="cpu")
    for k in range(2):
        step(inp["x"][k][rank * 2:rank * 2 + 2],
             inp["y"][k][rank * 2:rank * 2 + 2])
    mgr = CheckpointManager(directory / "zero_ck")
    mgr.save(2, step.state_for_checkpoint().to_tree())
    mgr.wait_until_finished()
    mgr.close()
    out["saved"] = _tree_copy(step.state_for_checkpoint().to_tree())
    return out


JOBS = {"collectives": job_collectives, "dp_step": job_dp_step,
        "ckpt": job_ckpt, "mp": job_mp, "dp_mp": job_dp_mp,
        "zero": job_zero}


# ---------------- the port alone, one process --------------------------------
@pytest.fixture
def fresh_world():
    D.destroy_process_group()
    yield
    D.destroy_process_group()


def _tiny(seed=0):
    model = GPTForCausalLM(GPTConfig(**TINY), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    return model, AdamW(learning_rate=LR, epsilon=EPS, weight_decay=0.01,
                        parameters=model.named_parameters(),
                        grad_clip=ClipGradByGlobalNorm(CLIP))


def _batches(n=2, B=4, S=32, seed=3):
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (n, B, S)))
    return x, torch.roll(x, -1, dims=2)


@pytest.mark.parametrize("master", [None, "file"], ids=["no_group",
                                                         "gloo_world_1"])
def test_world_of_one_equals_the_no_mesh_step(master, fresh_world, tmp_path,
                                              monkeypatch):
    """fleet.init at dp 1, with no process group or with a gloo group of
    one rank (whose all-reduces then run): losses and every parameter
    after 2 steps bitwise equal to the step without a mesh."""
    monkeypatch.delenv("PADDLE_TRAINERS_NUM", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    if master:
        monkeypatch.setenv("PADDLE_MASTER", f"file://{tmp_path / 'store'}")
    else:
        monkeypatch.delenv("PADDLE_MASTER", raising=False)
    xs, ys = _batches()
    runs = []
    for use_mesh in (False, True):
        model, opt = _tiny()
        if use_mesh:
            fleet.init(is_collective=True, device="cpu")
            hcg = fleet.get_hybrid_communicate_group()
            assert hcg.get_parallel_mode() == "single"
            assert (hcg.get_data_parallel_group().process_group is None) \
                == (master is None)
            step = fleet.make_sharded_train_step(
                fleet.distributed_model(model),
                fleet.distributed_optimizer(opt), mesh=hcg.get_mesh(),
                device="cpu")
            assert step.axis_sizes()["dp"] == 1
        else:
            step = fleet.make_sharded_train_step(model, opt, device="cpu")
        losses = [step(xs[k], ys[k]) for k in range(2)]
        runs.append((losses, _snapshot(step)))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    # with a group, the gradients stay views into the step's flat buffers
    assert (step._grads is None) == (master is None)
    if master:
        assert all(p.grad.data_ptr() == v.data_ptr()
                   for p, v in zip(step._grads.params, step._grads.views))


def test_mesh_specs_and_groups(fresh_world):
    mesh = D.DeviceMesh(np.arange(8).reshape(2, 2, 2), ("dp", "pp", "mp"))
    assert mesh.shape == {"dp": 2, "pp": 2, "mp": 2} and mesh.size == 8
    assert mesh.coords(5) == {"dp": 1, "pp": 0, "mp": 1}
    assert mesh.groups_along(["mp"]) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups_along(["dp"]) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.groups_along(["dp", "mp"]) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert mesh.groups_along([]) == [[r] for r in range(8)]
    rep = D.NamedSharding(mesh, D.PartitionSpec(None, "pp"))
    assert not rep.is_replicated
    one = D.build_mesh({"dp": 1, "mp": 1})
    assert D.NamedSharding(one, D.PartitionSpec(("dp", "mp"))).is_replicated
    with pytest.raises(ValueError, match="needs 2 ranks"):
        D.build_mesh({"dp": 2})
    assert D.get_global_mesh().shape == {"world": 1}
    D.init_parallel_env(device="cpu")
    assert D.is_initialized() and D.get_backend() == "NONE"
    t = torch.arange(3.0)
    D.all_reduce(t, group=D.new_group([0]))
    assert t.tolist() == [0.0, 1.0, 2.0]
    assert D.to_per_rank([t]).tolist() == t.tolist()
    assert D.rank_slices(t)[0] is t


def test_grad_buffers_layout_and_views(fresh_world):
    """``GradBuffers``: a flat buffer per dtype, every slot 64-byte
    aligned, buckets that tile the buffer within ``bucket_bytes`` (a larger
    gradient alone); ``attach`` zeroes the buffers and the backward
    accumulates into the views in place; ``reduce`` copies a replaced
    gradient in (None as zeros) and points ``.grad`` back at its view."""
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.distributed.parallel import GradBuffers

    gen = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(*shape, generator=gen,
                                             dtype=dtype))
              for shape, dtype in (((3, 10), torch.float32),
                                   ((7,), torch.bfloat16),
                                   ((40,), torch.float32),
                                   ((5, 9), torch.float32),
                                   ((100,), torch.float32))]
    params.append(torch.nn.Parameter(torch.ones(4), requires_grad=False))
    bufs = GradBuffers(params, Group([0]), bucket_bytes=256)
    assert [f.dtype for f in bufs.buffers] == [torch.float32, torch.bfloat16]
    assert len(bufs.params) == 5 and all(
        v.data_ptr() % 64 == 0 and v.shape == p.shape
        for p, v in zip(bufs.params, bufs.views))
    fp32 = bufs.buffers[0]
    cuts = [b for b in bufs.buckets if b.dtype == torch.float32]
    assert sum(b.numel() for b in cuts) == fp32.numel()
    assert cuts[0].data_ptr() == fp32.data_ptr()
    for a, b in zip(cuts, cuts[1:]):
        assert b.data_ptr() == a.data_ptr() + a.numel() * 4
    for b in cuts:
        held = [v for v in bufs.views if v.dtype == torch.float32
                and b.data_ptr() <= v.data_ptr() < b.data_ptr() + b.nbytes]
        assert b.nbytes <= 256 or len(held) == 1
    assert len(cuts) == 4  # 30 | 40 | 45 | 100 elements

    def loss():
        return sum((p.float() ** 2).sum() for p in params)

    loss().backward()
    want = [p.grad.clone() for p in bufs.params]
    for p in params:
        p.grad = torch.full_like(p, 7.0)
    bufs.attach()
    assert all(p.grad is v and not v.any()
               for p, v in zip(bufs.params, bufs.views))
    loss().backward()
    assert all(p.grad.data_ptr() == v.data_ptr() and torch.equal(p.grad, w)
               for p, v, w in zip(bufs.params, bufs.views, want))
    bufs.params[0].grad = None
    bufs.params[2].grad = torch.full_like(bufs.params[2], 3.0)
    bufs.reduce()
    assert all(p.grad.data_ptr() == v.data_ptr()
               for p, v in zip(bufs.params, bufs.views))
    assert not bufs.params[0].grad.any()
    assert bool((bufs.params[2].grad == 3.0).all())
    assert torch.equal(bufs.params[1].grad, want[1])


def test_data_parallel_wrapper_in_one_process(fresh_world):
    """``DataParallel`` forwards to the model and keeps its names;
    ``scale_loss`` is the identity and with one rank
    ``apply_collective_grads`` changes nothing; the optimizer wrapper's
    clip is the hybrid clip and its eager step runs the inner one."""
    model, opt = _tiny()
    dp = D.DataParallel(model)
    x, y = _batches(1)
    loss = dp.forward_with_loss(x[0], y[0])
    assert dp.scale_loss(loss) is loss
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    dp.apply_collective_grads()
    assert all(torch.equal(grads[k], p.grad)
               for k, p in model.named_parameters())
    assert set(dp.state_dict()) == set(model.state_dict())
    hopt = fleet.distributed_optimizer(opt)
    assert isinstance(opt._grad_clip, fleet.HybridParallelClipGrad)
    assert opt._grad_clip.clip_norm == CLIP
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    hopt.step()
    assert any(not torch.equal(before[k], p)
               for k, p in model.named_parameters())


def test_later_items_raise(fresh_world):
    """The in-trace collective of ring attention (A5.7), the planner (A7),
    role makers and parameter-server mode (A8) and the hybrid degrees
    each name their item; the launcher's PS mode (A8) and elastic
    restarts (A5.8) too. Expert parallelism's exchange and axis are
    ported: on one rank the all-to-all is the identity (a new axis moves
    to ``concat_axis`` untiled), and the ``expert`` axis builds."""
    from paddle_tpu_torch.distributed.launch.main import _parse_args, launch

    with pytest.raises(NotImplementedError, match="A5.7"):
        D.ppermute(1, "dp", [])
    x = torch.arange(6.0).view(1, 2, 3)
    assert D.all_to_all_in_trace(x, "ep", 0, 0) is x
    assert torch.equal(D.all_to_all_in_trace(x, "ep", 0, 2, tiled=False),
                       x.movedim(0, 2))
    hcg = D.HybridCommunicateGroup(D.CommunicateTopology(["data", "expert"],
                                                         [1, 1]))
    assert (hcg.get_expert_parallel_world_size(),
            hcg.get_expert_parallel_rank(),
            hcg.get_expert_parallel_group().ranks) == (1, 0, [0])
    assert hcg.moe_groups() is None  # one rank's routing
    with pytest.raises(NotImplementedError, match="A7"):
        fleet.plan_hybrid_configs({})
    st = fleet.DistributedStrategy()
    st.auto_plan = True
    with pytest.raises(NotImplementedError, match="A7"):
        fleet.init(strategy=st, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        fleet.init(is_collective=False, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        fleet.PaddleCloudRoleMaker(is_collective=True)
    # a pipe axis builds (A5.6): of one rank here, while two stages need
    # two ranks, no longer a later item; a sep axis raises naming A5.7
    hcg = D.HybridCommunicateGroup(D.CommunicateTopology(["data", "pipe"],
                                                         [1, 1]))
    assert (hcg.get_pipe_parallel_world_size(), hcg.get_stage_id(),
            hcg.is_first_stage(), hcg.is_last_stage(),
            hcg.get_pipe_parallel_group().ranks) == (1, 0, True, True, [0])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        D.HybridCommunicateGroup(D.CommunicateTopology(["data", "pipe"],
                                                       [1, 2]))
    with pytest.raises(NotImplementedError, match="A5.7"):
        D.HybridCommunicateGroup(D.CommunicateTopology(["data", "sep"],
                                                       [1, 2]))
    for argv, item in ((["--run_mode", "ps", "x.py"], "A8"),
                       (["--max_restart", "2", "x.py"], "A5.8"),
                       (["--nnodes", "1:2", "x.py"], "A5.8")):
        with pytest.raises(NotImplementedError, match=item):
            launch(_parse_args(argv))


def test_launcher_runs_the_workers_and_stops_them_on_a_failure(tmp_path,
                                                              monkeypatch):
    """Each worker gets its rank, the world and a master; the job exits 0
    when every worker does. When one fails, the others are stopped and the
    launcher exits with its code."""
    from paddle_tpu_torch.distributed.launch.main import _parse_args, launch

    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "r = os.environ['PADDLE_TRAINER_ID']\n"
        "open(f'env.{r}', 'w').write(' '.join(os.environ[k] for k in (\n"
        "    'PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM', 'PADDLE_MASTER')))\n"
        "if sys.argv[1] == 'fail':\n"
        "    sys.exit(3) if r == '1' else time.sleep(60)\n")
    monkeypatch.chdir(tmp_path)
    t0 = time.monotonic()
    args = ["--nproc_per_node", "2", "--log_dir", str(tmp_path / "log"),
            str(script)]
    assert launch(_parse_args(args + ["ok"])) == 0
    env = [(tmp_path / f"env.{r}").read_text().split() for r in (0, 1)]
    assert [e[:2] for e in env] == [["0", "2"], ["1", "2"]]
    assert env[0][2] == env[1][2] and env[0][2].startswith("file://")
    assert launch(_parse_args(args + ["fail"])) == 3
    assert time.monotonic() - t0 < 30
    assert sorted(p.name for p in (tmp_path / "log").iterdir()) == [
        "workerlog.0", "workerlog.1"]


if __name__ == "__main__":
    main(*sys.argv[1:])
