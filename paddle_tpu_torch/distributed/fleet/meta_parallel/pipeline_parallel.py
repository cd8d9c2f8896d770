"""Pipeline parallelism (``paddle_tpu/distributed/fleet/meta_parallel/
pipeline_parallel.py`` analog) on ``torch.distributed``.

The JAX package runs its schedules inside ``shard_map`` over a ``pp`` mesh
axis: every device scans the same ticks and ``lax.ppermute`` rotates the
activations around the ring. Here each stage is a process holding its
stage's blocks, and a schedule is a table of ticks that every rank of the
pp group computes alike: at tick ``t`` device ``d`` runs at most one
forward cell and one backward cell, a cell being ``(m, c)``, microbatch
``m`` through global chunk ``c`` (on device ``c % pp``; chunk ``c`` holds
blocks ``[c * L/(pp*v), (c+1) * L/(pp*v))``, v chunks a device under
interleaving). At the end of the tick the devices that produced an
activation or an input gradient send it to the device of the next (or
previous) chunk, which posts the matching receive at the same tick: each
tick's transfers of a rank are posted together and waited on
(``communication.p2p_exchange``), activations under one tag and gradients
under another, so a stage that sends forward and receives backward in one
tick cannot deadlock, and every send meets its receive in the same tick.
The first transfer along each edge of a run carries a small header with
the shape and dtype.

The tables:

- ``pipeline_schedule`` (GPipe): every forward, then every backward;
- ``pipeline_schedule_1f1b``: device ``d`` runs ``pp - 1 - d`` warm-up
  forwards, then one forward and one backward in turn, then the cool-down
  backwards; at most ``pp - d`` microbatches are in flight on it;
- ``pipeline_schedule_interleaved`` and
  ``pipeline_schedule_interleaved_1f1b``: the JAX package's greedy ring of
  ``_interleaved_1f1b_tables`` (device ``d`` owns chunks ``r * pp + d``);
  the first runs its forward table and then its backward table, the
  second both at once, as the JAX package's combined backward scan does,
  so its in-flight cells are the tables' colouring bound.

Every table runs the backward cells of a chunk in microbatch order, so a
gradient sums its microbatches in one order under every schedule. With
``remat`` a cell's forward runs without a graph, only its input is kept,
and its backward runs the forward again with one; without it the forward's
graph is kept to the backward. ``cell_seed(m, c)`` (a callable) reseeds the
default generators before a cell's forward and before its recompute, so a
recomputed forward draws the same dropout masks and the draws do not
depend on the schedule.

The schedules train when given ``loss_fn(y, m)``: the last chunk's output
of microbatch ``m`` goes through it and each cell's backward follows, the
loss's cotangent being ``grad_scale`` and, ``with_aux``, the cell's aux
term's ``aux_weight * grad_scale``; the gradients accumulate in the
parameters' ``.grad``. They return the per-microbatch losses ``[M]`` on
the last stage (None elsewhere) and, ``with_aux``, the aux summed over
every cell and over pp (the same on every rank). Without ``loss_fn`` they
run the forward cells alone (each device's in the table's order, as a
table of their own) and return the last chunk's outputs stacked
``[M, ...]`` on the last stage (None elsewhere): PyTorch has no transpose
of a schedule to differentiate, so the backward is the schedule's own.

``PipelineSpec`` is the JAX package's protocol with calls on the port's
modules: ``pre(x)``, ``block(layer, h)``, ``block_with_aux(layer, h) ->
(h, aux)`` and ``post_loss(h, y)``. ``stack_block_params`` and
``unstack_block_params`` take torch tensors or numpy arrays.
``PipelineParallel.train_batch`` runs a ``PipelineLayer``'s segment of
this rank through the 1F1B table on contiguous microbatches (the JAX eager
API's split); ``PipelineParallelWithInterleave`` goes through
``make_sharded_train_step(virtual_pp_degree=v)``, as the JAX class does.
"""

from __future__ import annotations

import inspect
import re
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from ...communication import ReduceOp, all_reduce, p2p_exchange

#: the message tags of a tick: activations forward, input gradients back,
#: and the shape headers of each
_ACT, _GRAD, _HEAD = 1, 2, 3
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.uint8, torch.int8)
_HEADER = 12  # ndim, dtype code, up to ten dimensions


@dataclass
class PipelineSpec:
    """How a model pipelines (the JAX package's contract for the train
    step's pp path), with calls on the port's modules.

    block_prefix: the name prefix of the homogeneous block stack (blocks
        named ``f"{prefix}.{i}"``; ``""`` for a ``PipelineLayer``'s bare
        ``"0"``, ``"1"``, ...).
    n_blocks: how many blocks the stack holds.
    pre(x) -> h: what runs before the blocks (the embeddings).
    block(layer, h) -> h: one block.
    post_loss(h, y) -> loss: what runs after them (final norm, head, loss).
    block_with_aux(layer, h) -> (h, aux): a MoE block and its gate's aux.
    """

    block_prefix: str
    n_blocks: int
    pre: Callable
    block: Callable
    post_loss: Callable
    context_parallel: bool = False
    block_with_aux: Optional[Callable] = None
    aux_weight: float = 0.0


def make_layer_stack_pipeline_spec(model, block_layer, block_prefix: str,
                                   n_blocks: int, embed_method: str = "embed",
                                   head_method: str = "head_loss",
                                   context_parallel: bool = False,
                                   aux_attr: Optional[str] = None,
                                   aux_weight: float = 0.0) -> PipelineSpec:
    """The ``PipelineSpec`` of a model with ``embed(x)`` and
    ``head_loss(h, y)`` methods around a stack of ``block_layer``'s kind:
    ``aux_attr`` is the dotted attribute of a block whose value after its
    forward is its gate's aux loss (a MoE block)."""
    embed = getattr(model, embed_method)
    head = getattr(model, head_method)

    def block(layer, h):
        return layer(h)

    block_with_aux = None
    if aux_attr is not None:
        def block_with_aux(layer, h):
            out = layer(h)
            obj = layer
            for part in aux_attr.split("."):
                obj = getattr(obj, part)
            return out, obj.float()

    def post_loss(h, y):
        return head(h, y).float()

    return PipelineSpec(block_prefix=block_prefix, n_blocks=n_blocks,
                        pre=embed, block=block, post_loss=post_loss,
                        context_parallel=context_parallel,
                        block_with_aux=block_with_aux, aux_weight=aux_weight)


def _chunk_order(L: int, pp: int, v: int):
    """Layer order for chunk-major stacking: chunk j (j = r*pp + d) covers
    layers [j*Lpc, (j+1)*Lpc); device d holds its chunks r = 0..v-1 in local
    order, so global index (d, r, i) -> layer (r*pp + d)*Lpc + i."""
    Lpc = L // (pp * v)
    order = []
    for d in range(pp):
        for r in range(v):
            j = r * pp + d
            order.extend(range(j * Lpc, (j + 1) * Lpc))
    return order


def stage_chunks(L: int, stage: int, pp: int, v: int = 1):
    """The chunks pipeline stage ``stage`` holds of an ``L``-block stack,
    ``r * pp + stage`` for ``r`` below ``v``, each a list of its blocks:
    in this order they fill the stage's row of a stacked leaf."""
    if L % (pp * v):
        raise ValueError(f"n_blocks {L} not divisible by pp*virtual {pp}*{v}")
    per = L // (pp * v)
    return [list(range((r * pp + stage) * per, (r * pp + stage + 1) * per))
            for r in range(v)]


def _lead(pp: int, v: int, L: int):
    """The leading dimensions of a stacked leaf: ``[pp, L/pp]``, or ``[pp,
    v, L/(pp*v)]`` under interleaving."""
    return (pp, v, L // (pp * v)) if v > 1 else (pp, L // pp)


def stage_rows(stacked, virtual_stages: int = 1):
    """A stacked leaf's blocks, its leading dimensions flattened: ``[pp,
    L/pp, ...]`` (or ``[pp, v, L/(pp*v), ...]``) as ``[L, ...]``, a whole
    leaf's in ``_chunk_order``, one stage's row in ``stage_chunks``'
    order."""
    lead = 3 if virtual_stages > 1 else 2
    return stacked.reshape((-1,) + tuple(stacked.shape[lead:]))


def stack_stage(blocks, virtual_stages: int = 1):
    """One stage's blocks (``stage_chunks``' order) as its row of a
    stacked leaf, ``[1, L/pp, ...]`` or ``[1, v, L/(pp*v), ...]``."""
    arr = _stack(blocks)
    return arr.reshape(_lead(1, virtual_stages, len(blocks))
                       + tuple(arr.shape[1:]))


def _stack(vals):
    if isinstance(vals[0], torch.Tensor):
        return torch.stack(vals)
    return np.stack([np.asarray(v) for v in vals])


def stack_block_params(params: dict, spec: PipelineSpec, pp: int,
                       virtual_stages: int = 1):
    """Split ``{name: array}`` into ``(stacked, other)``: the blocks' arrays
    stacked to ``[pp, L/pp, ...]`` by suffix (contiguous blocks a stage),
    or ``[pp, v, L/(pp*v), ...]`` chunk-major with ``virtual_stages=v``
    (device d's chunk r is model chunk r*pp + d); the rest untouched."""
    L = spec.n_blocks
    v = virtual_stages
    if L % (pp * v):
        raise ValueError(f"n_blocks {L} not divisible by pp*virtual {pp}*{v}")
    pat = (re.compile(rf"^{re.escape(spec.block_prefix)}\.(\d+)\.(.+)$")
           if spec.block_prefix else re.compile(r"^(\d+)\.(.+)$"))
    by_suffix: dict = {}
    other = {}
    for name, val in params.items():
        m = pat.match(name)
        if m:
            by_suffix.setdefault(m.group(2), {})[int(m.group(1))] = val
        else:
            other[name] = val
    order = _chunk_order(L, pp, v) if v > 1 else list(range(L))
    stacked = {}
    for suffix, by_idx in by_suffix.items():
        if len(by_idx) != L:
            raise ValueError(f"block param {suffix}: have {len(by_idx)} of "
                             f"{L} layers")
        arr = _stack([by_idx[i] for i in order])
        stacked[suffix] = arr.reshape(_lead(pp, v, L) + tuple(arr.shape[1:]))
    return stacked, other


def block_param_name(prefix: str, idx, suffix: str) -> str:
    """Flat parameter name of block ``idx``'s ``suffix`` (``''`` prefix
    supported: a PipelineLayer's sublayers are named bare '0', '1', ...)."""
    return f"{prefix}.{idx}.{suffix}" if prefix else f"{idx}.{suffix}"


def unstack_block_params(stacked: dict, spec: PipelineSpec,
                         pp: Optional[int] = None,
                         virtual_stages: int = 1) -> dict:
    """Inverse of ``stack_block_params``: stacked leaves -> flat layer
    names."""
    out = {}
    for suffix, arr in stacked.items():
        flat = stage_rows(arr, virtual_stages)
        if virtual_stages > 1:
            order = _chunk_order(flat.shape[0], pp if pp is not None
                                 else arr.shape[0], virtual_stages)
        else:
            order = range(flat.shape[0])
        for pos, layer in enumerate(order):
            out[block_param_name(spec.block_prefix, layer, suffix)] = flat[pos]
    return out


def _simulate_interleaved_ticks(n: int, v: int, M: int) -> int:
    """Host-side simulation of the greedy interleaved ring (returning laps
    preempt fresh injections): the exact tick count to finish all M
    microbatches through n*v chunks."""
    slots = [None] * n  # per-device incoming (mb, chunk) or None
    fresh = 0
    done = 0
    t = 0
    while done < M:
        nxt = [None] * n
        for d in range(n):
            work = slots[d]
            if d == 0 and work is None and fresh < M:
                work = (fresh, 0)
                fresh += 1
            if work is None:
                continue
            mb, chunk = work
            if chunk + 1 == n * v:
                done += 1
            else:
                nxt[(d + 1) % n] = (mb, chunk + 1)
        slots = nxt
        t += 1
        if t > (M + n) * n * v + n:  # safety: schedule must have converged
            raise RuntimeError("interleaved schedule failed to converge")
    return t


def _interleaved_1f1b_tables(n: int, v: int, M: int):
    """The interleaved schedule's tables (the JAX package's, copied).

    Returns (fwd_rows, bwd_rows, slot_of, T_f, T_b, C):
    * fwd_rows[t][d] = (m, c) or None — the greedy forward ring (returning
      laps preempt fresh injections).
    * bwd_rows[t][d] — the mirrored backward ring: device n-1 injects
      microbatch m's output cotangent (in order) once its forward of the
      last chunk is done (tick > t_f[m, nv-1]); each hop steps chunk c ->
      c-1 on device d -> d-1. Microbatches drain in arrival order.
    * slot_of[(m, c)] — stash slot per cell from greedy interval colouring
      of [t_f, t_b] per device; C = max slots any device needs.
    """
    import heapq

    nv = n * v
    fwd_rows, t_f = [], {}
    slots = [None] * n
    fresh = done = t = 0
    while done < M:
        row = [None] * n
        nxt = [None] * n
        for d in range(n):
            work = slots[d]
            if d == 0 and work is None and fresh < M:
                work = (fresh, 0)
                fresh += 1
            if work is None:
                continue
            m, c = work
            row[d] = (m, c)
            t_f[(m, c)] = t
            if c + 1 == nv:
                done += 1
            else:
                nxt[(d + 1) % n] = (m, c + 1)
        fwd_rows.append(row)
        slots = nxt
        t += 1
        if t > (M + n) * nv + n:
            raise RuntimeError("interleaved forward schedule failed to "
                               "converge")
    T_f = t

    bwd_rows, t_b = [], {}
    slots = [None] * n
    inject = done = 0
    t = 0
    while done < M:
        row = [None] * n
        nxt = [None] * n
        for d in range(n):
            work = slots[d]
            if d == n - 1 and work is None and inject < M \
                    and t > t_f[(inject, nv - 1)]:
                work = (inject, nv - 1)
                inject += 1
            if work is None:
                continue
            m, c = work
            row[d] = (m, c)
            t_b[(m, c)] = t
            if c == 0:
                done += 1
            else:
                nxt[(d - 1) % n] = (m, c - 1)
        bwd_rows.append(row)
        slots = nxt
        t += 1
        if t > 2 * ((M + n) * nv + n) + nv:
            raise RuntimeError("interleaved backward schedule failed to "
                               "converge")
    T_b = t

    slot_of = {}
    C = 1
    for d in range(n):
        cells = sorted((cl for cl in t_f if cl[1] % n == d),
                       key=lambda cl: t_f[cl])
        free: list = []
        live: list = []  # heap of (t_b, slot)
        next_slot = 0
        for cell in cells:
            while live and live[0][0] < t_f[cell]:
                free.append(heapq.heappop(live)[1])
            if free:
                s = free.pop()
            else:
                s = next_slot
                next_slot += 1
            slot_of[cell] = s
            heapq.heappush(live, (t_b[cell], s))
        C = max(C, next_slot)
    return fwd_rows, bwd_rows, slot_of, T_f, T_b, C


# ---------------- the tick tables -------------------------------------------
def _asap(orders, n: int, nv: int):
    """Ticks from each device's order of cells (``("F"|"B", m, c)``): a
    device runs its next cell at the first tick its input is there (an
    activation or gradient made at an earlier tick; one cell a tick)."""
    pos = [0] * n
    done = {}
    ticks = []
    left = sum(len(o) for o in orders)
    while left:
        t = len(ticks)
        row = [[None, None] for _ in range(n)]
        for d in range(n):
            if pos[d] == len(orders[d]):
                continue
            kind, m, c = orders[d][pos[d]]
            if kind == "F":
                dep = None if c == 0 else ("F", m, c - 1)
            else:
                dep = None if c == nv - 1 else ("B", m, c + 1)
            if dep is not None and done.get(dep, t) >= t:
                continue
            row[d][0 if kind == "F" else 1] = (m, c)
            done[(kind, m, c)] = t
            pos[d] += 1
            left -= 1
        ticks.append([tuple(r) for r in row])
        if len(ticks) > 4 * (sum(len(o) for o in orders) + n):
            raise RuntimeError("pipeline schedule deadlocks")
    return ticks


def _gpipe_ticks(n: int, M: int):
    """GPipe at one chunk a device: every forward, then every backward, in
    microbatch order."""
    return _asap([[("F", m, d) for m in range(M)]
                  + [("B", m, d) for m in range(M)] for d in range(n)], n, n)


def _1f1b_ticks(n: int, M: int):
    """1F1B at one chunk a device: ``n - 1 - d`` warm-up forwards, then a
    forward and a backward in turn, then the cool-down backwards."""
    orders = []
    for d in range(n):
        w = min(n - 1 - d, M)
        o = [("F", m, d) for m in range(w)]
        for i in range(M - w):
            o += [("F", w + i, d), ("B", i, d)]
        o += [("B", m, d) for m in range(M - w, M)]
        orders.append(o)
    return _asap(orders, n, n)


def _interleaved_ticks(n: int, v: int, M: int, combined: bool):
    """The JAX package's interleaved tables as ticks: ``combined`` runs the
    forward and backward tables at once (the 1F1B memory bound), else the
    forward table first and the backward table after it."""
    fwd, bwd, _, T_f, T_b, _ = _interleaved_1f1b_tables(n, v, M)
    if combined:
        T = max(T_f, T_b)
        fwd = fwd + [[None] * n] * (T - T_f)
        bwd = bwd + [[None] * n] * (T - T_b)
        return [list(zip(f, b)) for f, b in zip(fwd, bwd)]
    return ([[(cell, None) for cell in row] for row in fwd]
            + [[(None, cell) for cell in row] for row in bwd])


def _forward_only(ticks, n: int, nv: int):
    """The forward cells of ``ticks``, each device's in its order, as a
    table of their own: a run without a loss has no backward cells."""
    return _asap([[("F",) + row[d][0] for row in ticks
                   if row[d][0] is not None] for d in range(n)], n, nv)


def _messages(row, n: int, nv: int):
    """``[(src, dst, tag, cell)]``: what the devices send at the end of a
    tick, each to the device of the cell it feeds."""
    out = []
    for d, (f, b) in enumerate(row):
        if f is not None and f[1] < nv - 1:
            out.append((d, (f[1] + 1) % n, _ACT, (f[0], f[1] + 1)))
        if b is not None and b[1] > 0:
            out.append((d, (b[1] - 1) % n, _GRAD, (b[0], b[1] - 1)))
    return sorted(out, key=lambda x: (x[2], x[3], x[0]))


# ---------------- running a table on this rank -------------------------------
class _Exchange:
    """The tick transfers of a run over the pp ``group``: the first
    transfer of each edge (tag, chunk) sends its shape and dtype first,
    unless ``shapes`` (``{edge: (shape, dtype)}``, filled in as the run
    goes) holds it from an earlier run on inputs of the same shape."""

    def __init__(self, group, device, shapes=None):
        self.group, self.device = group, device
        self.shapes = {} if shapes is None else shapes

    def __call__(self, sends, recvs):
        ranks = self.group.ranks
        heads_out, heads_in = [], []
        for dst, tag, cell, t in sends:
            edge = (tag, cell[1])
            known = self.shapes.get(edge)
            if known is not None and known != (tuple(t.shape), t.dtype):
                raise ValueError(
                    f"pipeline edge {edge} carried {known} in an earlier run "
                    f"and now {(tuple(t.shape), t.dtype)}: pass edge_shapes "
                    "only across runs whose transfers keep their shapes")
            if known is None:
                self.shapes[edge] = (tuple(t.shape), t.dtype)
                h = torch.zeros(_HEADER, dtype=torch.int64)
                h[0], h[1] = t.dim(), _DTYPES.index(t.dtype)
                h[2:2 + t.dim()] = torch.tensor(t.shape)
                heads_out.append((ranks[dst], h.to(self.device), _HEAD + tag))
        for src, tag, cell in recvs:
            if (tag, cell[1]) not in self.shapes:
                heads_in.append(((tag, cell[1]), (
                    ranks[src], torch.empty(_HEADER, dtype=torch.int64,
                                            device=self.device),
                    _HEAD + tag)))
        if heads_out or heads_in:
            p2p_exchange(heads_out, [h for _, h in heads_in], self.group)
            for edge, (_, h, _) in heads_in:
                h = h.cpu()
                nd = int(h[0])
                self.shapes[edge] = (tuple(int(x) for x in h[2:2 + nd]),
                                     _DTYPES[int(h[1])])
        got = {}
        ins = []
        for src, tag, cell in recvs:
            shape, dtype = self.shapes[(tag, cell[1])]
            t = torch.empty(shape, dtype=dtype, device=self.device)
            got[(tag, cell)] = t
            ins.append((ranks[src], t, tag))
        p2p_exchange([(ranks[dst], t, tag) for dst, tag, _, t in sends], ins,
                     self.group)
        return got


def _run_ticks(ticks, n, nv, me, forward, backward, exchange):
    """Device ``me``'s part of ``ticks``: ``forward(cell, x)`` returns what
    the next chunk takes (None from the last chunk), ``backward(cell, dy)``
    the input gradient for the previous chunk (None from chunk 0); the
    tick's transfers follow its cells."""
    inbox = {}
    for row in ticks:
        f, b = row[me]
        made = {}
        if f is not None:
            y = forward(f, inbox.pop((_ACT, f), None))
            if f[1] < nv - 1:
                made[(_ACT, (f[0], f[1] + 1))] = y
        if b is not None:
            dx = backward(b, inbox.pop((_GRAD, b), None))
            if b[1] > 0:
                made[(_GRAD, (b[0], b[1] - 1))] = dx
        msgs = [x for x in _messages(row, n, nv) if me in (x[0], x[1])]
        if msgs:
            inbox.update(exchange(
                [(dst, tag, cell, made[(tag, cell)])
                 for src, dst, tag, cell in msgs if src == me],
                [(src, tag, cell) for src, dst, tag, cell in msgs
                 if dst == me]))
    if inbox:
        raise RuntimeError(f"pipeline schedule left {sorted(inbox)} unread")


def _takes_chunk(stage_fn) -> bool:
    try:
        kinds = (inspect.Parameter.POSITIONAL_ONLY,
                 inspect.Parameter.POSITIONAL_OR_KEYWORD,
                 inspect.Parameter.VAR_POSITIONAL)
        return sum(1 for p in inspect.signature(stage_fn).parameters.values()
                   if p.kind in kinds) >= 3
    except (TypeError, ValueError):
        return False


class _Cells:
    """The cells of one schedule run on this rank: the forward and the
    backward of ``(m, c)``, the stash between them, the losses of the last
    chunk and the aux terms."""

    def __init__(self, stage_fn, params_of, microbatches, nv, remat,
                 with_aux, loss_fn, aux_weight, grad_scale, cell_seed):
        self.call = stage_fn if _takes_chunk(stage_fn) \
            else (lambda p, x, c: stage_fn(p, x))
        self.params_of, self.mbs, self.nv = params_of, microbatches, nv
        self.remat, self.with_aux, self.loss_fn = remat, with_aux, loss_fn
        self.aux_weight, self.grad_scale = aux_weight, grad_scale
        self.cell_seed = cell_seed
        self.stash = {}
        self.losses = {}
        self.outputs = {}
        self.aux = None
        #: the most cells this rank held between their forward and backward
        self.peak_stash = 0

    def _run(self, m, c, x):
        if self.cell_seed is not None:
            self.cell_seed(m, c)
        if c == 0:
            x = self.mbs[m]
        out = self.call(self.params_of(c), x, c)
        y, aux = out if self.with_aux else (out, None)
        if c == self.nv - 1 and self.loss_fn is not None:
            y = self.loss_fn(y, m)
        return y, aux

    def _note_aux(self, aux):
        if aux is not None:
            a = aux.detach().float()
            self.aux = a if self.aux is None else self.aux + a

    def forward(self, cell, x):
        m, c = cell
        last = c == self.nv - 1
        train = self.loss_fn is not None
        if not train or self.remat:
            with torch.no_grad():
                y, aux = self._run(m, c, x)
            if train:
                self.stash[cell] = x
        else:
            if x is not None:
                x = x.detach().requires_grad_(True)
            y, aux = self._run(m, c, x)
            self.stash[cell] = (x, y, aux)
        self.peak_stash = max(self.peak_stash, len(self.stash))
        self._note_aux(aux)
        if last:
            (self.losses if train else self.outputs)[m] = y.detach()
            return None
        return y.detach()

    def backward(self, cell, dy):
        m, c = cell
        if self.remat:
            x = self.stash.pop(cell)
            if x is not None:
                x = x.detach().requires_grad_(True)
            y, aux = self._run(m, c, x)
        else:
            x, y, aux = self.stash.pop(cell)
        scale = 1.0 if self.grad_scale is None else self.grad_scale
        outs = [y]
        grads = [torch.full((), scale, dtype=y.dtype, device=y.device)
                 if c == self.nv - 1 else dy]
        if aux is not None and self.aux_weight:
            outs.append(aux)
            grads.append(torch.full((), self.aux_weight * scale,
                                    dtype=aux.dtype, device=aux.device))
        torch.autograd.backward(outs, grads)
        return None if x is None else x.grad


def _pp_group(group):
    if group is not None:
        return group
    from ...topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    g = hcg.get_pipe_parallel_group() if hcg is not None else None
    if g is None:
        raise ValueError("a pipeline schedule needs the pp group: pass "
                         "group= or call fleet.init with a pp_degree")
    return g


def _device_of(microbatches, params) -> torch.device:
    for t in list(microbatches) + [p for p in _tensors(params)]:
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _schedule(ticks, stage_fn, stacked_params, microbatches, n, v, remat,
              with_aux, loss_fn, aux_weight, grad_scale, cell_seed, group,
              device, stats, edge_shapes=None):
    g = _pp_group(group)
    if g.nranks != n:
        raise ValueError(f"n_stages {n} but the pp group holds {g.nranks} "
                         "ranks")
    me = g.rank
    nv = n * v
    if loss_fn is None:
        ticks = _forward_only(ticks, n, nv)
    params_of = (lambda c: stacked_params) if v == 1 \
        else (lambda c: stacked_params[c // n])
    mbs = list(microbatches)
    dev = torch.device(device) if device is not None \
        else _device_of(mbs, stacked_params)
    cells = _Cells(stage_fn, params_of, mbs, nv, remat, with_aux, loss_fn,
                   aux_weight, grad_scale, cell_seed)
    _run_ticks(ticks, n, nv, me, cells.forward, cells.backward,
               _Exchange(g, dev, edge_shapes))
    if stats is not None:
        stats["peak_stash"] = cells.peak_stash
        stats["ticks"] = len(ticks)
    M = len(mbs)
    last = me == (nv - 1) % n
    store = cells.losses if loss_fn is not None else cells.outputs
    out = torch.stack([store[m] for m in range(M)]) if last else None
    if not with_aux:
        return out
    aux = cells.aux if cells.aux is not None \
        else torch.zeros((), dtype=torch.float32, device=dev)
    all_reduce(aux, ReduceOp.SUM, group=g)
    return out, aux


def pipeline_schedule(stage_fn: Callable, stacked_params, microbatches,
                      axis_name: str = "pp", n_stages: Optional[int] = None,
                      remat: bool = True, with_aux: bool = False, *,
                      loss_fn: Optional[Callable] = None,
                      aux_weight: float = 0.0, grad_scale=None,
                      cell_seed: Optional[Callable] = None, group=None,
                      device=None, stats: Optional[dict] = None,
                      edge_shapes: Optional[dict] = None):
    """GPipe over the pp group (``group``, by default the hybrid
    topology's): every forward, then every backward in microbatch order.
    ``stage_fn(params, x)`` (or ``(params, x, chunk)``) is this stage's
    compute on ``stacked_params``; ``microbatches`` (a sequence of M
    inputs, consumed by stage 0) gives M on every rank. With ``loss_fn``
    it trains, without it it runs the forwards alone (see the module's
    docstring); ``stats`` (a dict) receives the run's ``peak_stash`` and
    ``ticks``; ``edge_shapes`` (a dict kept by the caller across runs
    whose inputs keep their shapes) spares the later runs the shape
    headers."""
    g = _pp_group(group)
    n = n_stages or g.nranks
    return _schedule(_gpipe_ticks(n, len(microbatches)), stage_fn,
                     stacked_params, microbatches, n, 1, remat, with_aux,
                     loss_fn, aux_weight, grad_scale, cell_seed, g, device,
                     stats, edge_shapes)


def pipeline_schedule_1f1b(stage_fn: Callable, stacked_params, microbatches,
                           axis_name: str = "pp",
                           n_stages: Optional[int] = None, remat: bool = True,
                           with_aux: bool = False, *,
                           loss_fn: Optional[Callable] = None,
                           aux_weight: float = 0.0, grad_scale=None,
                           cell_seed: Optional[Callable] = None, group=None,
                           device=None, stats: Optional[dict] = None,
                           edge_shapes: Optional[dict] = None):
    """1F1B over the pp group: warm-up forwards, then a forward and a
    backward in turn, then the cool-down; at most ``pp - d`` microbatches
    are in flight on stage ``d``. Otherwise as ``pipeline_schedule``."""
    g = _pp_group(group)
    n = n_stages or g.nranks
    return _schedule(_1f1b_ticks(n, len(microbatches)), stage_fn,
                     stacked_params, microbatches, n, 1, remat, with_aux,
                     loss_fn, aux_weight, grad_scale, cell_seed, g, device,
                     stats, edge_shapes)


def pipeline_schedule_interleaved(stage_fn: Callable, stacked_params,
                                  microbatches, axis_name: str = "pp",
                                  n_stages: Optional[int] = None,
                                  virtual_stages: int = 2, remat: bool = True,
                                  with_aux: bool = False, *,
                                  loss_fn: Optional[Callable] = None,
                                  aux_weight: float = 0.0, grad_scale=None,
                                  cell_seed: Optional[Callable] = None,
                                  group=None, device=None,
                                  stats: Optional[dict] = None,
                                  edge_shapes: Optional[dict] = None):
    """Interleaved virtual stages: device d owns chunks ``r * pp + d``
    (``stacked_params[r]`` is chunk r's; a 3-argument ``stage_fn`` gets the
    global chunk index), every microbatch circles the ring ``v`` times.
    The forward table runs first, then the backward table (GPipe-like
    memory; ``remat`` as in ``pipeline_schedule``)."""
    g = _pp_group(group)
    n = n_stages or g.nranks
    return _schedule(_interleaved_ticks(n, virtual_stages, len(microbatches),
                                        combined=False),
                     stage_fn, stacked_params, microbatches, n,
                     virtual_stages, remat, with_aux, loss_fn, aux_weight,
                     grad_scale, cell_seed, g, device, stats,
                     edge_shapes)


def pipeline_schedule_interleaved_1f1b(stage_fn: Callable, stacked_params,
                                       microbatches, axis_name: str = "pp",
                                       n_stages: Optional[int] = None,
                                       virtual_stages: int = 2,
                                       remat: bool = True,
                                       with_aux: bool = False, *,
                                       loss_fn: Optional[Callable] = None,
                                       aux_weight: float = 0.0,
                                       grad_scale=None,
                                       cell_seed: Optional[Callable] = None,
                                       group=None, device=None,
                                       stats: Optional[dict] = None,
                                       edge_shapes: Optional[dict] = None):
    """Interleaved virtual stages with the 1F1B memory bound: the forward
    and backward tables run at once, each cell keeping only its input and
    recomputing its forward in its backward (``remat`` is inert, as in the
    JAX package: this schedule is a recompute stream)."""
    g = _pp_group(group)
    n = n_stages or g.nranks
    return _schedule(_interleaved_ticks(n, virtual_stages, len(microbatches),
                                        combined=True),
                     stage_fn, stacked_params, microbatches, n,
                     virtual_stages, True, with_aux, loss_fn, aux_weight,
                     grad_scale, cell_seed, g, device, stats,
                     edge_shapes)


def _from_last(outs, g, device):
    """The last stage's ``outs`` on every rank of the pp group ``g``."""
    from ...communication import broadcast, broadcast_object_list

    src = g.ranks[-1]
    meta = [None if outs is None else (tuple(outs.shape), outs.dtype)]
    broadcast_object_list(meta, src=src, group=g)
    if outs is None:
        outs = torch.empty(meta[0][0], dtype=meta[0][1], device=device)
    broadcast(outs, src=src, group=g)
    return outs


def spmd_pipeline(stage_fn: Callable, stacked_params, microbatches,
                  axis_name: str = "pp", n_stages: Optional[int] = None, *,
                  group=None, device=None):
    """``pipeline_schedule``'s forward with the last stage's outputs
    broadcast to every stage of the group (the JAX package's psum)."""
    g = _pp_group(group)
    outs = pipeline_schedule(stage_fn, stacked_params, microbatches,
                             axis_name, n_stages, remat=False, group=g,
                             device=device)
    return _from_last(outs, g, torch.device(device) if device is not None
                      else _device_of(list(microbatches), stacked_params))


# ---------------- the eager API ----------------------------------------------
class PipelineParallel(nn.Module):
    """Microbatched training over this rank's segment of a
    ``PipelineLayer`` (reference :32): ``train_batch`` splits the batch
    into ``accumulate_steps`` contiguous microbatches, runs the 1F1B table
    over the pp group (each microbatch's loss scaled by ``1/M`` in its
    backward), sums the gradients of each ``SharedLayerDesc`` layer over
    the stages that hold it, and updates: the optimizer's global-norm clip
    counts each parameter once over the stages, and a scaler's found-inf
    flag is reduced over them, so every stage steps or skips together.
    Every rank passes the whole batch; the returned loss (the mean over
    microbatches) is the last stage's, on every rank."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        from ...topology import get_hybrid_communicate_group

        self._layers = layers
        self._hcg = hcg if hcg is not None else get_hybrid_communicate_group()
        self._strategy = strategy
        cfg = getattr(strategy, "pipeline_configs", {}) \
            if strategy is not None else {}
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", None)
        self.total_loss = None
        self._group = self._hcg.get_pipe_parallel_group()
        self._shared = layers.shared_groups(self._hcg)

    def forward(self, x):
        return self._layers(x)

    def _split_micro(self, data):
        x, y = data
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        m = self.accumulate_steps
        bsz = x.shape[0]
        if bsz % m != 0:
            raise ValueError(f"batch {bsz} not divisible by accumulate_steps "
                             f"{m}")
        mb = bsz // m
        dev = self._layers.device
        return [(x[i * mb:(i + 1) * mb].to(dev), y[i * mb:(i + 1) * mb].to(dev))
                for i in range(m)]

    def _train(self, micro, scale=None):
        layers = self._layers
        ys = [my for _, my in micro]
        lf = layers.loss_fn

        def loss_fn(out, m):
            return (lf(out, ys[m]) if lf is not None else out).float()

        losses = pipeline_schedule_1f1b(
            lambda params, x: layers(x), None, [mx for mx, _ in micro],
            remat=False, loss_fn=loss_fn,
            grad_scale=(1.0 if scale is None else scale) / len(micro),
            group=self._group)
        total = torch.zeros((), dtype=torch.float32, device=layers.device) \
            if losses is None else losses.mean()
        all_reduce(total, ReduceOp.SUM, group=self._group)
        return total

    def forward_backward_pipeline(self, data, scaler=None):
        """The 1F1B table over the microbatches (reference :153): the
        gradients accumulate in ``.grad``, the shared layers' summed over
        their stages; returns the mean loss."""
        scale = scaler._scale if scaler is not None and scaler.is_enable() \
            else None
        self.total_loss = self._train(self._split_micro(data), scale)
        for params, g in self._shared:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                all_reduce(p.grad, ReduceOp.SUM, group=g)
        return self.total_loss

    def _clip(self, optimizer):
        from ..hybrid_parallel_optimizer import hybrid_clip_
        from ....nn.clip import ClipGradByGlobalNorm

        inner = optimizer
        for attr in ("_inner_opt", "_inner"):
            inner = getattr(inner, attr, inner)
        clip = inner._grad_clip
        if clip is None:
            return inner
        if not isinstance(clip, ClipGradByGlobalNorm):
            raise NotImplementedError(f"{type(clip).__name__}: only "
                                      "ClipGradByGlobalNorm is ported")
        owned = self._layers.owned_parameters(self._hcg)
        grads, counted = [], []
        for name, p in inner._params.items():
            if p.grad is not None:
                grads.append(p.grad)
                counted.append(id(p) in owned)
        hybrid_clip_(clip, grads, mp_split=[False] * len(grads),
                     sliced=[False] * len(grads), mp_group=None,
                     sharding_group=None, pp_counted=counted,
                     pp_group=self._group)
        return inner

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """reference :269 — the microbatched step and the update."""
        from ....amp.grad_scaler import nonfinite_flag

        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        inner = optimizer
        for attr in ("_inner_opt", "_inner"):
            inner = getattr(inner, attr, inner)
        skip = False
        if scaler is not None and scaler.is_enable():
            flag = nonfinite_flag([p.grad for p in inner._params.values()],
                                  scaler._scale)
            if flag is None:
                flag = torch.zeros((), device=self._layers.device)
            all_reduce(flag, ReduceOp.MAX, group=self._group)
            skip = bool(flag)
            scaler._found_inf = skip
            scaler._unscaled = True
        if not skip:
            self._clip(optimizer)
            clip, inner._grad_clip = inner._grad_clip, None
            try:
                inner.step()
            finally:
                inner._grad_clip = clip
        if scaler is not None and scaler.is_enable():
            scaler.update()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss: bool = True):
        """reference :271 — the forwards alone through the 1F1B table (the
        interleaved one over a ``PipelineLayer`` of virtual stages), on
        contiguous microbatches; the mean over the microbatches of each
        one's loss (with ``compute_loss`` and a ``loss_fn``) or of its
        outputs, on every rank."""
        layers = self._layers
        layers.eval()
        micro = self._split_micro(data)
        v = layers.num_virtual_pipeline_stages
        mbs = [mx for mx, _ in micro]

        def run(params, x, c):
            return layers(x, chunk=c)

        outs = pipeline_schedule_1f1b(run, None, mbs, group=self._group) \
            if v == 1 else pipeline_schedule_interleaved(
                run, [None] * v, mbs, virtual_stages=v, group=self._group)
        if outs is not None:
            if compute_loss and layers.loss_fn is not None:
                outs = torch.stack([layers.loss_fn(o, my) for o, (_, my)
                                    in zip(outs, micro)])
            outs = outs.mean(0)
        return _from_last(outs, self._group, layers.device)


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved virtual stages (reference :514): ``train_batch`` routes
    through ``make_sharded_train_step(virtual_pp_degree=v)`` over the
    ``PipelineLayer``'s chunks (built with ``num_virtual_pipeline_stages=
    v``), as the JAX class does: the step's microbatches are rows
    ``m::M``, its loss the mean over them."""

    def __init__(self, layers, hcg=None, strategy=None,
                 virtual_pp_degree: Optional[int] = None):
        super().__init__(layers, hcg=hcg, strategy=strategy)
        cfg = getattr(strategy, "pipeline_configs", {}) \
            if strategy is not None else {}
        self._vpp = int(virtual_pp_degree or cfg.get("virtual_pp_degree", 2))
        if layers.num_virtual_pipeline_stages != self._vpp:
            raise ValueError(
                f"virtual_pp_degree {self._vpp} but the PipelineLayer was "
                f"built for {layers.num_virtual_pipeline_stages} chunks a "
                "stage: build it with num_virtual_pipeline_stages="
                f"{self._vpp}")
        self._step = None
        self._opt_id = None

    def _compiled_step(self, optimizer, scaler=None):
        inner = optimizer
        for attr in ("_inner_opt", "_inner"):
            inner = getattr(inner, attr, inner)
        key = (id(inner), id(scaler) if scaler is not None else None)
        if self._step is None or self._opt_id != key:
            from ..utils import make_sharded_train_step

            self._step = make_sharded_train_step(
                self._layers, inner,
                accumulate_steps=max(self.accumulate_steps, 1),
                virtual_pp_degree=self._vpp, scaler=scaler,
                device=self._layers.device)
            self._opt_id = key
        return self._step

    def forward_backward_pipeline(self, data, scaler=None):
        raise NotImplementedError(
            "PipelineParallelWithInterleave runs forward, backward and the "
            "update as one step; use train_batch")

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        self._layers.train()
        x, y = data
        step = self._compiled_step(optimizer, scaler=scaler)
        loss = step(x, y, lr=lr_scheduler.get_lr()
                    if lr_scheduler is not None else None)
        if lr_scheduler is not None:
            lr_scheduler.step()
        self.total_loss = loss
        return loss


__all__: List[str] = [
    "PipelineSpec", "make_layer_stack_pipeline_spec", "stack_block_params",
    "unstack_block_params", "block_param_name", "pipeline_schedule",
    "pipeline_schedule_1f1b", "pipeline_schedule_interleaved",
    "pipeline_schedule_interleaved_1f1b", "spmd_pipeline",
    "PipelineParallel", "PipelineParallelWithInterleave"]
