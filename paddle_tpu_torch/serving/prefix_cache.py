"""Radix prefix cache: block-granular KV reuse across requests
(``paddle_tpu/serving/prefix_cache.py`` analog).

Two requests whose prompts agree on their first ``page_size * b`` tokens
can map the same ``b`` physical pages and prefill only the differing
suffix. This is the index that finds the agreement: a trie keyed on
page-sized token blocks whose nodes hold page ids.

Sharing is safe because of two invariants kept elsewhere:

* ``PageAllocator`` refcounts pages: the trie holds one reference per
  node, every splice adds one per shared page, and a page returns to the
  free list only when its last reference drops.
* The engine never writes a shared page: matching takes full blocks only,
  capped at ``(len(prompt) - 1) // page_size``, so the suffix prefill has
  at least one token and starts on a block boundary, and decode appends
  after the prompt. ``Engine._ensure_writable`` backs this up with a
  copy-on-write.

Eviction is LRU over trie leaves; releasing a leaf drops only the trie's
reference, so a page still spliced into a live request survives until that
request finishes.

The JAX package's ``serving.prefix.*`` gauges are not ported: they go with
the observability layer (ROADMAP queue A item A6).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

from .scheduler import PageAllocator

_OWNER = "prefix-cache"


class _Node:
    """One cached block: ``key`` (its page_size-token tuple), the physical
    ``page`` holding its K/V, and an LRU stamp. Children are keyed by the
    next block's token tuple."""

    __slots__ = ("key", "page", "last_used", "children", "parent")

    def __init__(self, key: Tuple[int, ...], page: int, parent: "_Node"):
        self.key = key
        self.page = page
        self.last_used = 0
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent


class PrefixCache:
    """Trie index from block-aligned token prefixes to page ids.

    The trie owns one allocator reference per node (taken at ``insert``,
    dropped at eviction or ``clear``); the engine takes its own reference
    per splice (``match`` returns page ids, the engine ``retain``s them).
    A block is shareable only if all ``page_size`` of its tokens match.
    """

    def __init__(self, page_size: int, allocator: PageAllocator):
        if page_size < 1:
            raise ValueError(f"page_size {page_size}")
        self.page_size = page_size
        self.allocator = allocator
        self._root = _Node((), -1, None)  # holds no page
        self._clock = itertools.count(1)
        self.num_nodes = 0

    def _blocks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
                for j in range(len(tokens) // ps)]

    def match(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """The longest cached shareable prefix of ``prompt``:
        ``(hit_blocks, pages)``, ``pages[j]`` backing block ``j``. Capped
        at ``(len(prompt) - 1) // page_size`` blocks, so a block-aligned,
        fully cached prompt leaves its last block to the suffix prefill
        (which produces the first token's logits)."""
        cap = max(0, (len(prompt) - 1) // self.page_size)
        node, pages = self._root, []
        stamp = next(self._clock)
        for key in self._blocks(prompt)[:cap]:
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = stamp
            pages.append(child.page)
            node = child
        return len(pages), pages

    def insert(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Record that ``pages[j]`` holds block ``j`` of ``prompt``'s K/V.
        Blocks already present keep their page (the inserting request's
        duplicate stays private to it); new nodes take a trie-owned
        reference. Returns the number of new nodes."""
        blocks = self._blocks(prompt)
        node, created = self._root, 0
        stamp = next(self._clock)
        for j in range(min(len(blocks), len(pages))):
            key = blocks[j]
            child = node.children.get(key)
            if child is None:
                page = int(pages[j])
                self.allocator.retain([page], owner=_OWNER)
                child = _Node(key, page, node)
                node.children[key] = child
                self.num_nodes += 1
                created += 1
            child.last_used = stamp
            node = child
        return created

    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _evict_node(self, node: _Node):
        del node.parent.children[node.key]
        self.num_nodes -= 1
        self.allocator.free([node.page], owner=_OWNER)

    def evict_lru(self, need_free: int) -> int:
        """Release least-recently-used leaves until the allocator has
        ``need_free`` free pages or nothing is left to evict. A page still
        mapped by a live request stays allocated until that request
        finishes, so this goes on past it. Returns nodes evicted."""
        evicted = 0
        while self.allocator.num_free < need_free:
            leaves = self._leaves()
            if not leaves:
                break
            self._evict_node(min(leaves, key=lambda n: n.last_used))
            evicted += 1
        return evicted

    def clear(self) -> int:
        """Drop every node and the trie's page references. Pages spliced
        into live requests stay allocated; the rest return to the free
        list. Returns nodes dropped."""
        dropped = 0
        for leaf in sorted(self._leaves(), key=lambda n: -n.last_used):
            node = leaf
            while node is not self._root and not node.children:
                parent = node.parent
                self._evict_node(node)
                dropped += 1
                node = parent
        return dropped
