"""Hybrid-parallel topology over the rank mesh
(``paddle_tpu/distributed/topology.py`` analog).

``CommunicateTopology`` is the JAX package's numpy rank grid, copied: a
rank is a coordinate in the named ``[data, pipe, sharding, ..., model]``
grid, the model axis varying fastest. ``HybridCommunicateGroup`` builds the
``DeviceMesh`` over that grid and one ``Group`` per axis through
``collective.group_of`` (a process group for each set of ranks that varies
along the axis; every rank builds all of them, in one order).

Data, tensor (``model``), ZeRO (``sharding``), expert (``expert``) and
pipeline (``pipe``: ``get_stage_id``, ``is_first_stage``,
``is_last_stage`` and the pp group) parallelism are ported; a ``sep``
degree above 1 raises ``NotImplementedError`` naming its ROADMAP item
(A5.7). ``moe_groups()`` gives the groups a MoE block routes over
(``MoEGroups``), built with the axes' groups.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .collective import Group, group_of
from .mesh import DeviceMesh, build_mesh, set_global_mesh
from .sharding_utils import DATA_AXES, EP_AXIS

# paddle axis naming -> mesh axis names
_AXIS_ALIAS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
               "model": "mp", "sep": "sep", "expert": "ep"}

#: the ROADMAP item that ports parallelism over each axis not ported yet,
#: by paddle and by mesh name
LATER_AXES = {"sep": "A5.7 (context parallelism)"}
LATER_AXES.update({_AXIS_ALIAS[k]: v for k, v in list(LATER_AXES.items())})


@dataclass(frozen=True)
class MoEGroups:
    """The groups a MoE block routes over: ``data``, every rank that
    carries rows of the batch (the mesh's ``data_axes``); ``ep``, the
    ranks that split the experts; ``replica``, the ranks holding this
    rank's experts, along the data axes other than ``ep``."""
    data: Group
    ep: Group
    replica: Group
    data_axes: Tuple[str, ...] = (EP_AXIS,)


class CommunicateTopology:
    """N-D cartesian rank grid with named axes (fleet/base/topology.py:54)."""

    def __init__(
        self,
        hybrid_group_names: Sequence[str] = ("data", "pipe", "sharding",
                                             "model"),
        dims: Sequence[int] = (1, 1, 1, 1),
    ):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*(range(d) for d in dims)))
        self._rank2coord = {self._coord_rank(c): c for c in self.coordinate}
        self._coord2rank = {c: r for r, c in self._rank2coord.items()}

    def _coord_rank(self, coord) -> int:
        return int(np.ravel_multi_index(coord, self._dims))

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on `axis_name` equals index."""
        axis = self._parallel_names.index(axis_name)
        return sorted(self._coord2rank[c] for c in self.coordinate
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Groups of ranks that vary only along `axis_name`."""
        axis = self._parallel_names.index(axis_name)
        other = [i for i in range(len(self._dims)) if i != axis]
        groups = {}
        for c in self.coordinate:
            key = tuple(c[i] for i in other)
            groups.setdefault(key, []).append(self._coord2rank[c])
        return [sorted(v) for _, v in sorted(groups.items())]


class HybridCommunicateGroup:
    """The hybrid mesh and one group per axis (fleet/base/topology.py:140):
    ``get_mesh()`` is what ``make_sharded_train_step`` runs over, and
    ``get_data_parallel_group()`` the group its gradients are reduced on."""

    def __init__(self, topology: CommunicateTopology, global_rank: int = 0):
        names = topology.get_hybrid_group_names()
        for name in names:
            if topology.get_dim(name) > 1 and name in LATER_AXES:
                raise NotImplementedError(
                    f"{name} degree {topology.get_dim(name)}: data, tensor, "
                    f"ZeRO, expert and pipeline parallelism are ported "
                    f"(ROADMAP queue A item {LATER_AXES[name]})")
        self._topo = topology
        self.global_rank = global_rank
        self.nranks = topology.world_size()
        self._axes: Dict[str, int] = {
            _AXIS_ALIAS.get(n, n): topology.get_dim(n) for n in names}
        # mesh axes in topology order: data outermost ... model innermost
        self.mesh: DeviceMesh = build_mesh(self._axes)
        set_global_mesh(self.mesh)

        self._dp_degree = self._axes.get("dp", 1)
        self._pp_degree = self._axes.get("pp", 1)
        self._sharding_degree = self._axes.get("sharding", 1)
        self._mp_degree = self._axes.get("mp", 1)
        self._sep_degree = self._axes.get("sep", 1)
        self._ep_degree = self._axes.get("ep", 1)

        self._coord = dict(zip(names, topology.get_coord(global_rank)))
        self._groups: Dict[str, Group] = {}
        for paddle_name in names:
            axis = _AXIS_ALIAS.get(paddle_name, paddle_name)
            # every rank builds every group of the axis, in one order
            for ranks in topology.get_comm_list(paddle_name):
                g = group_of(ranks, self.mesh, axis, name=f"{axis}_group")
                if global_rank in ranks:
                    self._groups[axis] = g
        self._moe = self._build_moe_groups()

    def _build_moe_groups(self) -> Optional[MoEGroups]:
        """``moe_groups()``'s groups, None when the data axes hold one
        rank: an axis's own group where the axes are one, else a group
        over several axes, every rank building every one in one order."""
        data = tuple(a for a in DATA_AXES if self._axes.get(a, 1) > 1)
        if not data:
            return None
        mine = {}
        for key, axes in (("data", data),
                          ("replica", tuple(a for a in data if a != EP_AXIS))):
            if len(axes) == 1:
                mine[key] = self._groups[axes[0]]
                continue
            for ranks in self.mesh.groups_along(axes):
                g = group_of(ranks, self.mesh, ",".join(axes) or None,
                             name=f"moe_{key}_group")
                if self.global_rank in ranks:
                    mine[key] = g
        ep = self._groups.get(EP_AXIS) or group_of(
            [self.global_rank], self.mesh, EP_AXIS)
        return MoEGroups(mine["data"], ep, mine["replica"], data)

    # ---- topology accessors (topology.py:348-404 parity) ----
    def get_parallel_mode(self):
        if self._mp_degree > 1 or self._pp_degree > 1:
            return "hybrid"
        if self._sharding_degree > 1:
            return "sharding"
        return "data" if self._dp_degree > 1 else "single"

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_global_rank(self) -> int:
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self) -> int:
        return self._coord.get("data", 0)

    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_data_parallel_group(self) -> Group:
        return self._groups.get("dp")

    def get_data_parallel_group_src_rank(self) -> int:
        return self._groups["dp"].ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self) -> int:
        return self._coord.get("model", 0)

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_model_parallel_group(self) -> Group:
        return self._groups.get("mp")

    def get_model_parallel_group_src_rank(self) -> int:
        return self._groups["mp"].ranks[0]

    # pipeline parallel
    def get_stage_id(self) -> int:
        return self._coord.get("pipe", 0)

    def get_pipe_parallel_rank(self) -> int:
        return self._coord.get("pipe", 0)

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_pipe_parallel_group(self) -> Group:
        return self._groups.get("pp")

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self) -> int:
        return self._coord.get("sharding", 0)

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sharding_parallel_group(self) -> Group:
        return self._groups.get("sharding")

    def get_sharding_parallel_group_src_rank(self) -> int:
        return self._groups["sharding"].ranks[0]

    # expert parallel
    def get_expert_parallel_rank(self) -> int:
        return self._coord.get("expert", 0)

    def get_expert_parallel_world_size(self) -> int:
        return self._ep_degree

    def get_expert_parallel_group(self) -> Optional[Group]:
        return self._groups.get("ep")

    def moe_groups(self) -> Optional[MoEGroups]:
        """The groups a MoE block routes over: the data axes', the ep
        group, and the ep rank's replicas along dp and sharding; None when
        the data axes hold one rank."""
        return self._moe

    # sep (the sequence-parallel axis)
    def get_sep_parallel_rank(self) -> int:
        return self._coord.get("sep", 0)

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    def get_sep_parallel_group(self) -> Optional[Group]:
        return self._groups.get("sep")

    # mesh accessors
    def get_mesh(self) -> DeviceMesh:
        return self.mesh

    def axis_sizes(self) -> Dict[str, int]:
        return dict(self._axes)


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
