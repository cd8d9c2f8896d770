"""fleet: the hybrid-parallel training facade
(``paddle_tpu/distributed/fleet/__init__.py`` analog).

``init`` joins the world (``init_parallel_env``) and builds the
``HybridCommunicateGroup`` from ``strategy.hybrid_configs``, as the JAX
package does: the rank mesh with named data, pipe, sharding, sep, expert
and model axes, and a group per axis; then it seeds the model-parallel RNG
tracker (``tensor_parallel_configs["tensor_init_seed"]``, 1024 by
default). The data, model, sharding and expert axes may exceed 1 (the
others raise naming their ROADMAP items). ``distributed_model`` wraps the model
as the JAX package does: ``TensorParallel`` at mp above 1,
``ShardingParallel`` at sharding, ``DataParallel`` at dp;
``distributed_optimizer`` wraps the optimizer so its clip is the hybrid
global-norm clip. The train step (``make_sharded_train_step``) runs over
the hybrid mesh when it is given none.

Not ported: the cost-model planner (``auto_plan``, ``plan_hybrid_configs``;
ROADMAP queue A item A7), parameter-server mode, the role makers and the
data generators (A8).
"""

from __future__ import annotations

from typing import Optional

from . import meta_parallel  # noqa: F401
from .meta_parallel import (ColumnParallelLinear, RowParallelLinear,
                            TensorParallel, VocabParallelEmbedding,
                            get_rng_state_tracker)
from ..parallel import (DataParallel, get_rank, get_world_size,
                        init_parallel_env)
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        get_hybrid_communicate_group,
                        set_hybrid_communicate_group)
from .distributed_strategy import DistributedStrategy
from .hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                        HybridParallelOptimizer)
from .recompute import recompute, recompute_hybrid, recompute_sequential
from .utils import ShardedTrainStep, make_sharded_train_step

__all__ = ["meta_parallel", "ColumnParallelLinear", "RowParallelLinear",
           "TensorParallel", "VocabParallelEmbedding",
           "get_rng_state_tracker", "recompute", "recompute_sequential",
           "recompute_hybrid", "ShardedTrainStep", "make_sharded_train_step",
           "DistributedStrategy", "HybridParallelClipGrad",
           "HybridParallelOptimizer", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_num", "worker_index", "is_first_worker", "barrier_worker",
           "plan_hybrid_configs", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]

_A7 = "ROADMAP queue A item A7 (the analyzers and planners)"
_A8 = "ROADMAP queue A item A8 (the long tail)"

_strategy: Optional[DistributedStrategy] = None


def plan_hybrid_configs(model=None, batch: Optional[int] = None, cluster=None,
                        zero_stage: int = 0, accumulate_steps: int = 1,
                        enable_sep: bool = False, ep_degree: int = 1,
                        enable_pp: Optional[bool] = None,
                        require=None) -> dict:
    """The cost-model planner's hybrid_configs; not ported yet."""
    raise NotImplementedError(f"plan_hybrid_configs is not ported yet "
                              f"({_A7})")


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, *, device=None):
    """fleet.init: join the world on ``device`` (``cuda`` by default, see
    ``init_parallel_env``) and build the hybrid topology from ``strategy``
    (the JAX package's axes and order). The degrees must multiply to the
    world size."""
    global _strategy
    if role_maker is not None:
        raise NotImplementedError(f"fleet.init(role_maker=): role makers "
                                  f"are not ported yet ({_A8})")
    if not is_collective:
        raise NotImplementedError(f"fleet.init(is_collective=False): "
                                  f"parameter-server mode is not ported yet "
                                  f"({_A8})")
    _strategy = strategy or DistributedStrategy()
    if getattr(_strategy, "auto_plan", False):
        raise NotImplementedError(f"strategy.auto_plan is not ported yet "
                                  f"({_A7})")
    init_parallel_env(device=device)
    cfg = _strategy.hybrid_configs
    # sep = the sequence/context-parallel axis; "cp_degree" aliases it
    sep_d = cfg.get("sep_degree", 1) or 1
    cp_d = cfg.get("cp_degree", 1) or 1
    if sep_d > 1 and cp_d > 1 and sep_d != cp_d:
        raise ValueError(
            f"hybrid_configs sets both sep_degree={sep_d} and "
            f"cp_degree={cp_d}; they alias the same axis — set only one")
    topo = CommunicateTopology(
        hybrid_group_names=["data", "pipe", "sharding", "sep", "expert",
                            "model"],
        dims=[cfg.get("dp_degree", 1), cfg.get("pp_degree", 1),
              cfg.get("sharding_degree", 1), max(sep_d, cp_d),
              cfg.get("ep_degree", 1) or 1, cfg.get("mp_degree", 1)])
    if topo.world_size() != get_world_size():
        raise ValueError(f"hybrid_configs {cfg} multiply to "
                         f"{topo.world_size()} ranks; the world has "
                         f"{get_world_size()}")
    set_hybrid_communicate_group(
        HybridCommunicateGroup(topo, global_rank=get_rank()))
    from .meta_parallel.random import model_parallel_random_seed

    seed = _strategy.tensor_parallel_configs.get("tensor_init_seed", -1)
    model_parallel_random_seed(None if seed in (-1, None) else seed,
                               device=device)


def distributed_model(model):
    """``PipelineParallel`` (``PipelineParallelWithInterleave`` at a
    ``virtual_pp_degree`` above 1) for a ``PipelineLayer`` at pp above 1,
    ``TensorParallel(model)`` at mp above 1, ``ShardingParallel`` in
    the sharding mode, ``DataParallel`` in the data mode (the hybrid
    topology's ``get_parallel_mode()``), else the model itself; at an ep
    degree above 1 without sharding, the model itself too (the train step
    reduces the experts' gradients over their replicas only, which a
    ``DataParallel`` over the data axes would not)."""
    from .meta_parallel import ShardingParallel, TensorParallel

    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return model
    from .meta_parallel import (PipelineLayer, PipelineParallel,
                                PipelineParallelWithInterleave)

    if hcg.get_pipe_parallel_world_size() > 1 \
            and isinstance(model, PipelineLayer):
        vpp = (_strategy.pipeline_configs.get("virtual_pp_degree", 1)
               if _strategy is not None else 1)
        if vpp and vpp > 1:
            return PipelineParallelWithInterleave(model, hcg=hcg,
                                                  strategy=_strategy)
        return PipelineParallel(model, hcg=hcg, strategy=_strategy)
    if hcg.get_expert_parallel_world_size() > 1 \
            and hcg.get_parallel_mode() == "data":
        return model
    if hcg.get_model_parallel_world_size() > 1:
        return TensorParallel(model, hcg=hcg, strategy=_strategy)
    mode = hcg.get_parallel_mode()
    if mode == "sharding":
        return ShardingParallel(model, hcg=hcg, strategy=_strategy)
    if mode == "data":
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """``HybridParallelOptimizer(optimizer)``: its clip becomes the dp
    group's global-norm clip. ``strategy.lars``/``dgc`` substitute
    optimizers the port lacks (A8) and raise."""
    st = strategy or _strategy
    for knob in ("lars", "dgc"):
        if st is not None and getattr(st, knob, False):
            raise NotImplementedError(f"strategy.{knob} substitutes an "
                                      f"optimizer not ported yet ({_A8})")
    return HybridParallelOptimizer(optimizer,
                                   hcg=get_hybrid_communicate_group(),
                                   strategy=st)


def worker_num() -> int:
    return get_world_size()


def worker_index() -> int:
    return get_rank()


def is_first_worker() -> bool:
    return get_rank() == 0


def barrier_worker():
    from ..communication import barrier

    barrier()


class UserDefinedRoleMaker:
    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        raise NotImplementedError(f"role makers are not ported yet ({_A8})")


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=False, **kwargs):
        raise NotImplementedError(f"role makers are not ported yet ({_A8})")


class MultiSlotDataGenerator:
    def __init__(self):
        raise NotImplementedError(f"the slot data generators are not ported "
                                  f"yet ({_A8})")


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    pass
