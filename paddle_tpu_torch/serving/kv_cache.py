"""KV caches: the serving engine's device-resident decode state
(``paddle_tpu/serving/kv_cache.py`` analog), in both layouts.

``KVCache`` is the dense layout, ``[L, B_max, H_kv, S_max, D]`` per K and
V: a slot owns a whole row of ``S_max`` positions. ``PagedKVCache`` is the
block-paged layout: pools of fixed-size pages routed by a per-slot page
table. Both are preallocated at construction. Where the JAX package
donates the buffers to each compiled step and rebinds the returned arrays,
the port writes into them in place on the device (``write_kv``,
``paged_write_kv`` and the prefill writes), and no second copy of a cache
is ever live. ``num_kv_heads`` is the K/V heads the cache's model holds: a
model split at mp holds ``num_kv_heads/mp`` of them, and so does each
rank's cache (the engine passes ``model.local_kv_heads``).

``decode_attend`` is the dense layout's attention, plain PyTorch on every
device as the JAX package's is plain jnp (no TPU kernel corresponds); it
is also the paged-decode kernel's plain version.

``extend_attend``/``paged_extend_attend`` are the multi-query attends of
the suffix prefill after a prefix-cache splice and of the speculative
verify step. As in the JAX package they run no kernel (its ragged kernel
is single-query): a gather of the live table and two products.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..kernels.paged_attention import (NEG_INF, decode_attend,
                                       no_tpu_tier, paged_attention,
                                       paged_gather, prescale_q)

#: page-table entry marking an unallocated block. Device code never branches
#: on it: lookups clamp sentinels to page 0, the reserved trash page the
#: allocator never hands out, and the decode mask (``key_pos <= position``)
#: keeps trash bytes out of the math.
PAGE_SENTINEL = -1

__all__ = ["PAGE_SENTINEL", "write_kv", "paged_write_kv", "paged_gather",
           "decode_attend", "paged_decode_attend", "extend_attend",
           "paged_extend_attend", "KVCache", "PagedKVCache"]


def write_kv(cache, new, positions):
    """Write new K (or V) entries into a ``[B, H_kv, S_max, D]`` cache, in
    place; returns ``cache``.

    ``positions`` a scalar (an int or a 0-d tensor): contiguous write of
    ``new [B, H_kv, T, D]`` starting at that index, clamped so the ``T``
    tokens fit, as ``lax.dynamic_update_slice`` clamps. ``positions``
    ``[B]``: each row's single token of ``new [B, H_kv, 1, D]`` at its own
    index (continuous-batching decode, slots at different positions); the
    indices must lie in ``[0, S_max)``. Neither form reads the card on the
    host, so a CUDA graph can capture both."""
    new = new.to(cache.dtype)
    S, T = cache.shape[2], new.shape[2]
    if isinstance(positions, int):
        start = min(max(positions, 0), S - T)
        cache[:, :, start:start + T] = new
        return cache
    pos = positions.to(cache.device)
    if pos.dim() == 0:
        idx = pos.long().clamp(0, S - T) + torch.arange(T, device=cache.device)
        return cache.index_copy_(2, idx, new)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos.long(), :] = new[:, :, 0, :]
    return cache


def paged_write_kv(pool, new, page_table, positions):
    """Scatter ``T`` tokens' K (or V) per slot into a ``[P, H_kv, ps, D]``
    page pool, in place: token ``t`` of row ``b`` of ``new [B, H_kv, T, D]``
    lands in page ``page_table[b, (positions[b]+t) // ps]`` at offset
    ``(positions[b]+t) % ps``. Sentinel entries clamp to the trash page
    (slots without a live request all write there, which is benign), and
    writes past the table's capacity ``num_blocks * ps`` go to the trash
    page too: a verify step near the end of a sequence drafts past it.
    One indexed write for all ``T`` tokens. Returns ``pool``."""
    ps = pool.shape[2]
    nb = page_table.shape[1]
    p = positions.long()[:, None] \
        + torch.arange(new.shape[2], device=pool.device)    # [B, T]
    block = torch.clamp(p // ps, max=nb - 1)
    pages = torch.gather(page_table.long(), 1, block).clamp(min=0)
    pages = torch.where(p < nb * ps, pages, 0)
    pool[pages, :, p % ps, :] = new.transpose(1, 2).to(pool.dtype)
    return pool


def paged_decode_attend(q, k_pool, v_pool, page_table, positions,
                        impl=None):
    """Single-position cached attention over block-paged pools through the
    ragged paged-decode kernel (its wrapper runs the plain gather +
    ``decode_attend`` version on CPU tensors). ``impl`` must be None: the
    JAX package's TPU tiers raise (``no_tpu_tier``)."""
    no_tpu_tier("impl", impl)
    return paged_attention(q, k_pool, v_pool, page_table, positions)


def extend_attend(q, k_cache, v_cache, positions):
    """Multi-query cached attention: q ``[B, H_q, T, D]``, query ``t`` of
    row ``b`` at position ``positions[b] + t``, attending to
    ``key_pos <= positions[b] + t`` of dense caches ``[B, H_kv, S, D]``.
    ``decode_attend``'s numerics (T = 1 reduces to it): q pre-scaled in its
    own dtype, fp32 scores and softmax, output in v's dtype. The mask is a
    ``masked_fill`` with a host scalar, so a CUDA graph can capture it."""
    rep = q.shape[1] // k_cache.shape[1]
    k = k_cache.repeat_interleave(rep, dim=1) if rep > 1 else k_cache
    v = v_cache.repeat_interleave(rep, dim=1) if rep > 1 else v_cache
    s = torch.einsum("bhqd,bhkd->bhqk", prescale_q(q).float(), k.float())
    qpos = positions.long()[:, None] \
        + torch.arange(q.shape[2], device=q.device)          # [B, T]
    key_pos = torch.arange(k_cache.shape[2], device=q.device)
    valid = key_pos[None, None, None, :] <= qpos[:, None, :, None]
    probs = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1) \
        .to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()) \
        .to(v.dtype)


def paged_extend_attend(q, k_pool, v_pool, page_table, positions,
                        impl=None):
    """``extend_attend`` over block-paged pools: the dense view of each
    slot's table (``paged_gather``), then the two products. Plain PyTorch
    on every device, as in the JAX package. ``impl`` must be None."""
    no_tpu_tier("impl", impl)
    return extend_attend(q, paged_gather(k_pool, page_table),
                         paged_gather(v_pool, page_table), positions)


class _Slots:
    """The decode slots' free list and the K/V buffers' size, shared by
    both layouts (``max_batch_size``, ``k``, ``v`` and ``_free`` set by the
    layout)."""

    @property
    def nbytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()

    def alloc_slot(self) -> Optional[int]:
        """Lowest free slot index, or None when the batch is full."""
        return self._free.pop() if self._free else None

    def free_slot(self, slot: int):
        self._free.append(slot)
        self._free.sort(reverse=True)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.max_batch_size - len(self._free)


class KVCache(_Slots):
    """Dense K/V buffers ``[L, B_max, H_kv, S_max, D]`` on the device, plus
    the slot free list.

    A slot owns row ``b`` of every layer for its whole life: the prefill
    writes positions ``[0, T)``, each decode step one position (bucket
    padding past the prompt holds garbage that the decode mask
    ``key_pos <= position`` never admits before a real token overwrites
    it). A freed slot is reusable at once for the same reason.
    """

    def __init__(self, num_layers: int, max_batch_size: int,
                 num_kv_heads: int, max_seq_len: int, head_dim: int,
                 dtype="float32", *, device=None):
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.max_batch_size = max_batch_size
        self.num_kv_heads = num_kv_heads
        self.max_seq_len = max_seq_len
        self.head_dim = head_dim
        shape = (num_layers, max_batch_size, num_kv_heads, max_seq_len,
                 head_dim)
        dt = resolve_dtype(dtype)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self._free: List[int] = list(range(max_batch_size))[::-1]

    def write_prefill(self, kvs, slots, T: int):
        """Install a ``T``-token prefill's per-layer K/V (each
        ``[n, H_kv, T, D]``) at positions ``[0, T)`` of the rows ``slots``
        (``[n]`` slot indices on the device, which a captured prefill
        reads), in place."""
        slots = slots.to(self.device).long()
        for pool, new in ((self.k, torch.stack([k for k, _ in kvs])),
                          (self.v, torch.stack([v for _, v in kvs]))):
            pool[:, slots, :, :T] = new

    def layer_caches(self, k=None, v=None):
        """Per-layer ``(k, v)`` views ``[B_max, H_kv, S_max, D]`` of the
        buffers (or of the stacked ``k``/``v`` given), as ``decode_step``
        takes them; a step's writes land in the buffers."""
        k = self.k if k is None else k
        v = self.v if v is None else v
        return [(k[l], v[l]) for l in range(self.num_layers)]


class PagedKVCache(_Slots):
    """Block-paged K/V pools ``[L, num_pages, H_kv, page_size, D]`` on the
    device, plus the per-slot page table (host numpy) and slot bookkeeping.

    The page table is host state: the allocator mutates it between steps,
    and the engine copies it into its steps' static table buffer before
    each one (``table_device()`` makes a fresh device copy). Page 0 is the
    trash page; a default-sized pool holds
    ``B_max * S_max/page_size + 1`` pages.
    """

    def __init__(self, num_layers: int, max_batch_size: int,
                 num_kv_heads: int, max_seq_len: int, head_dim: int,
                 dtype="float32", page_size: int = 16,
                 num_pages: Optional[int] = None, *, device=None):
        if max_seq_len % page_size:
            raise ValueError(
                f"max_seq_len {max_seq_len} not divisible by page_size "
                f"{page_size}")
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.max_batch_size = max_batch_size
        self.num_kv_heads = num_kv_heads
        self.max_seq_len = max_seq_len
        self.head_dim = head_dim
        self.page_size = page_size
        self.num_blocks = max_seq_len // page_size
        if num_pages is None:
            num_pages = max_batch_size * self.num_blocks + 1
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (trash page + 1)")
        self.num_pages = num_pages
        shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
        dt = resolve_dtype(dtype)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self.page_table = np.full((max_batch_size, self.num_blocks),
                                  PAGE_SENTINEL, np.int32)
        self._free: List[int] = list(range(max_batch_size))[::-1]

    def table_device(self) -> torch.Tensor:
        """Snapshot of the host page table on the cache's device."""
        return torch.from_numpy(self.page_table).to(self.device)

    def assign_pages(self, slot: int, pages: List[int], start_block: int = 0):
        for j, p in enumerate(pages):
            self.page_table[slot, start_block + j] = p

    def copy_page(self, src: int, dst: int):
        """Copy-on-write: duplicate page ``src`` into page ``dst`` across
        every layer of both pools, in place."""
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]

    def write_prefill(self, kvs, page_row, T: int):
        """Install a ``T``-token prefill's per-layer K/V (each
        ``[1, H_kv, T, D]``) into the pages of ``page_row`` (a slot's table
        row: host numpy, or a device tensor, which a captured prefill
        reads), in place. Full pages go in one indexed copy per pool; a
        partial last block writes only its ``T % ps`` tokens (``T`` is
        static). Blocks whose entry is the sentinel land on the trash
        page; the clamp runs on the device, so nothing is read on the
        host."""
        ps = self.page_size
        knew = torch.stack([k[0] for k, _ in kvs])    # [L, Hkv, T, D]
        vnew = torch.stack([v[0] for _, v in kvs])
        if isinstance(page_row, np.ndarray):
            page_row = torch.from_numpy(page_row)
        pages = page_row[:(T + ps - 1) // ps].to(self.device).long() \
            .clamp(min=0)
        full = T // ps
        L, Hkv, _, D = knew.shape
        for pool, new in ((self.k, knew), (self.v, vnew)):
            new = new.to(pool.dtype)
            if full:
                pool[:, pages[:full]] = new[:, :, :full * ps] \
                    .reshape(L, Hkv, full, ps, D).transpose(1, 2)
            if T % ps:
                # a one-entry index, not a 0-d one: indexing by a 0-d
                # tensor reads it on the host
                pool[:, pages[full:], :, :T % ps] = \
                    new[:, None, :, full * ps:]

    def slot_pages(self, slot: int) -> List[int]:
        row = self.page_table[slot]
        return [int(p) for p in row if p != PAGE_SENTINEL]

    def clear_slot(self, slot: int) -> List[int]:
        """Reset a slot's table row to sentinels; returns the page ids the
        caller must hand back to the allocator."""
        pages = self.slot_pages(slot)
        self.page_table[slot, :] = PAGE_SENTINEL
        return pages

    def layer_caches(self, k=None, v=None,
                     table: Optional[torch.Tensor] = None):
        """Per-layer ``(k_pool, v_pool, page_table)`` triples — views into
        the pools (or into the stacked ``k``/``v`` given), so a step's
        writes land in them. ``table`` is a device table (``[B,
        num_blocks]`` int32); default ``table_device()``."""
        k = self.k if k is None else k
        v = self.v if v is None else v
        if table is None:
            table = self.table_device()
        return [(k[l], v[l], table) for l in range(self.num_layers)]
