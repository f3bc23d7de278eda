"""Host-side bookkeeping for the block-paged KV pool.

A copy of the JAX package's ``serve/kvpool.py`` (pure Python and numpy; the
port imports nothing of that package).  Two pieces, both on the host: they
run between decode steps and never inside the captured step.

* :class:`PagePool` — refcounted free-list allocator over the device arenas
  created by ``kvcache.CacheSpec(layout="paged")``.  Page 0 is the reserved
  null page (unmapped page-table entries point at it) and is never handed
  out.  A page's refcount is the number of holders: each engine slot whose
  page table maps it counts one, and each radix-trie prefix entry that pins
  it counts one.  ``release`` decrements and returns the pages that dropped
  to zero so the caller can scrub their position maps before reuse.

* :class:`RadixIndex` — a path-compressed radix trie over token-id tuples.
  ``ServeEngine`` registers each freshly prefilled pack-aligned prompt
  prefix here (pages + a snapshot of the non-paged layer states + the
  prefill logits); admission walks the trie to find (a) the deepest
  *registered* ancestor of a new prompt — reusable exactly, states and all —
  and (b) the longest *common* prefix with any registered sequence, whose
  whole pages are reusable on their own for configs where every layer is
  paged (KV at position i depends only on tokens <= i).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

__all__ = ["PagePool", "RadixIndex", "PrefixEntry"]


class PagePool:
    """Refcounted free-list allocator for a paged KV arena.

    Tracks only page *ids* — the device arenas live in the engine's
    caches.  ``num_pages`` includes the reserved null page 0, so the usable
    capacity is ``num_pages - 1``.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PagePool needs num_pages >= 2 (page 0 is the "
                             "reserved null page)")
        if page_size < 1:
            raise ValueError("PagePool needs page_size >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.refs = np.zeros(num_pages, np.int32)
        # LIFO free list keeps recently-freed (cache-warm) pages hot
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self.peak_in_use = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def alloc(self) -> int | None:
        """One fresh page with refcount 1, or None when the pool is empty
        (the caller evicts prefix entries and retries)."""
        if not self._free:
            return None
        p = self._free.pop()
        self.refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return p

    def retain(self, pages) -> None:
        for p in pages:
            if p == 0:
                continue
            if self.refs[p] <= 0:
                raise RuntimeError(f"retain of free page {p}")
            self.refs[p] += 1

    def release(self, pages) -> list[int]:
        """Drop one reference per page; -> the pages that became free (the
        caller must scrub their position maps to -1 before reuse)."""
        freed = []
        for p in pages:
            if p == 0:
                continue
            if self.refs[p] <= 0:
                raise RuntimeError(f"release of free page {p}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                freed.append(int(p))
        return freed


@dataclass
class PrefixEntry:
    """One cached pack-aligned prompt prefix.

    ``pages`` covers positions [0, length) — ceil(length / page_size) ids,
    the last one possibly partial.  ``state`` is a snapshot of the
    non-paged layer states (ring caches) at position ``length``, or None
    when every layer is paged.  ``logits`` is the
    prefill output at position length-1 (so an exact whole-prompt hit can
    sample its first token bitwise-identically to a fresh prefill).
    """
    length: int
    pages: tuple[int, ...]
    state: Any = None
    logits: Any = None
    last_used: int = 0
    hits: int = 0


class _Node:
    __slots__ = ("edges", "entry")

    def __init__(self):
        # first token -> (label tuple, child); path compression keeps one
        # node per branch point / registered prefix, not one per token
        self.edges: dict[int, tuple[tuple, "_Node"]] = {}
        self.entry: PrefixEntry | None = None


class RadixIndex:
    """Path-compressed radix trie keyed by token-id tuples."""

    def __init__(self):
        self._root = _Node()
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def items(self) -> Iterator[tuple[tuple, PrefixEntry]]:
        stack: list[tuple[tuple, _Node]] = [((), self._root)]
        while stack:
            prefix, node = stack.pop()
            if node.entry is not None:
                yield prefix, node.entry
            for label, child in node.edges.values():
                stack.append((prefix + label, child))

    def insert(self, tokens: tuple, entry: PrefixEntry) -> bool:
        """Register ``entry`` at ``tokens``; False if already present."""
        node = self._root
        i = 0
        while i < len(tokens):
            first = tokens[i]
            if first not in node.edges:
                child = _Node()
                node.edges[first] = (tuple(tokens[i:]), child)
                node = child
                i = len(tokens)
                break
            label, child = node.edges[first]
            m = _common(label, tokens[i:])
            if m == len(label):              # consumed the whole edge
                node, i = child, i + m
                continue
            # split the edge at the divergence point
            mid = _Node()
            mid.edges[label[m]] = (label[m:], child)
            node.edges[first] = (label[:m], mid)
            node, i = mid, i + m
        if node.entry is not None:
            return False
        node.entry = entry
        self._count += 1
        return True

    def remove(self, tokens: tuple) -> PrefixEntry | None:
        """Unregister the entry at exactly ``tokens`` (nodes are left in
        place — they are tiny and may be re-registered)."""
        node = self._walk_exact(tokens)
        if node is None or node.entry is None:
            return None
        entry, node.entry = node.entry, None
        self._count -= 1
        return entry

    def _walk_exact(self, tokens: tuple) -> _Node | None:
        node, i = self._root, 0
        while i < len(tokens):
            edge = node.edges.get(tokens[i])
            if edge is None:
                return None
            label, child = edge
            if tuple(tokens[i:i + len(label)]) != label:
                return None
            node, i = child, i + len(label)
        return node

    def lookup(self, tokens) -> tuple[PrefixEntry | None, PrefixEntry | None, int]:
        """-> (deepest_entry, donor_entry, common_len) for a new prompt.

        ``deepest_entry`` is the deepest registered entry whose tokens are a
        prefix of ``tokens`` (exactly reusable: pages + states + logits).
        ``common_len`` is the longest common prefix of ``tokens`` with ANY
        stored sequence, and ``donor_entry`` is some entry below the match
        point — its pages covering [0, common_len) agree with ``tokens``
        token-for-token, so its *whole* pages inside the common prefix are
        reusable by themselves (page-granularity sharing).
        """
        tokens = tuple(int(t) for t in tokens)
        node, i = self._root, 0
        best: PrefixEntry | None = node.entry
        while i < len(tokens):
            edge = node.edges.get(tokens[i])
            if edge is None:
                break
            label, child = edge
            m = _common(label, tokens[i:])
            i += m
            if m < len(label):               # diverged inside the edge
                node = child                 # donor lives below this edge
                break
            node = child
            if node.entry is not None:
                best = node.entry
        donor = self._any_entry(node)
        return best, donor, i

    def _any_entry(self, node: _Node) -> PrefixEntry | None:
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(child for _, child in n.edges.values())
        return None


def _common(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
