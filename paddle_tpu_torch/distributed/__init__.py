"""``paddle_tpu.distributed`` analog on ``torch.distributed``: the rank
mesh, process groups, collectives on per-process tensors, the parallel
environment, the hybrid topology, fleet and the launcher.

One process per rank, each on its own device: a multi-process job starts
through the launcher, ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N script.py``, and each process calls ``fleet.init`` (or
``init_parallel_env``). NCCL carries CUDA tensors, gloo the CPU's
(``PADDLE_DISTRI_BACKEND`` overrides). Data, tensor and ZeRO (stages 1
to 3), expert parallelism, the gradient reductions of ``comm_opt`` and
``resharding`` (moves between layouts, and the checkpoint's restore onto
another one) are ported (ROADMAP queue A items A5.2 to A5.5a); the other
parallelisms raise naming their items.
"""

from .collective import (  # noqa: F401
    Group,
    destroy_process_group,
    get_group,
    is_initialized,
    new_group,
)
from .communication import (  # noqa: F401
    ParallelMode,
    ReduceOp,
    Task,
    all_gather,
    all_gather_in_trace,
    all_gather_object,
    all_reduce,
    all_to_all,
    all_to_all_in_trace,
    alltoall,
    alltoall_single,
    axis_index,
    barrier,
    broadcast,
    broadcast_object_list,
    gather,
    get_backend,
    irecv,
    is_available,
    isend,
    pmax,
    pmean,
    pmin,
    ppermute,
    psum,
    rank_slices,
    recv,
    reduce,
    reduce_scatter,
    reduce_scatter_in_trace,
    scatter,
    scatter_object_list,
    send,
    to_per_rank,
    wait,
)
from .mesh import (  # noqa: F401
    DeviceMesh,
    NamedSharding,
    PartitionSpec,
    build_mesh,
    get_global_mesh,
    set_global_mesh,
)
from .parallel import (  # noqa: F401
    DataParallel,
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
)
from .split_api import split  # noqa: F401
from .topology import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    get_hybrid_communicate_group,
    set_hybrid_communicate_group,
)
from . import comm_opt, fleet, launch, resharding  # noqa: F401,E402


def spawn(func, args=(), nprocs=-1, **kwargs):
    """paddle.distributed.spawn as the JAX package keeps it: join the world
    (``init_parallel_env(device=kwargs.get("device"))``) and run ``func``
    once, in this process. A multi-process run starts through the
    launcher."""
    init_parallel_env(device=kwargs.get("device"))
    return func(*args)
