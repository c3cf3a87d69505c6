"""Shared-prefix KV cache: a radix tree over token-id page keys that maps
common prompt prefixes to shared physical pages of a :class:`PagedKVPool`.

Edge serving traffic is dominated by requests sharing long prompt prefixes
(voice-assistant system prompts, few-shot headers).  Recomputing and
duplicating their KV per slot wastes exactly the memory and compute the
in-situ setting is short of, so the cache lets every request that shares a
page-aligned token prefix map its leading logical pages to the *same*
physical pages:

* **Tree shape.**  Each node is one full page: a key of ``page_size`` token
  ids plus the physical page holding that page's KV.  A path from the root
  spells out a prompt prefix page by page, so lookup is a chunk-wise radix
  walk — O(prefix pages), independent of how many prompts are cached.
* **Refcounts.**  The tree itself holds one reference per node
  (``pool.pin``), and every slot using a shared page holds another
  (``admit(shared_pages=...)``).  A page returns to the free list only when
  the last reference drops, so cached prefixes survive the requests that
  created them and serve future hits warm.
* **Granularity / copy-on-write.**  Sharing is page-granular: only pages
  fully covered by real prompt tokens enter the tree, and a lookup is
  floored to the caller's alignment grain.  The partial tail page — the one
  a slot keeps appending decode KV into — is never shared; a request whose
  prefix ends mid-page simply recomputes that page into a private copy
  (copy-on-write by recompute: cheaper than a device-side page copy at edge
  page sizes, and the only mutable page stays slot-private, which is why
  decode needs no locking — reads are block-table gathers, each slot writes
  only its own tail page).
* **Admission flow** (driven by ``serving/engine.py``): ``lookup`` the
  prompt → ``pool.admit`` with the hit pages (refcount bump, no allocation)
  → chunked prefill over only the uncached *suffix* → ``insert`` the
  request's newly written full pages so later requests can hit them.
* **Eviction.**  When admission runs out of reservable pages, ``evict``
  unpins least-recently-used *leaves* whose page is held by the tree alone
  (never pages a live slot still reads), cascading up the path while that
  frees capacity.

Pure Python like the pool — property-testable without a device.  The
reference's ``publish(registry)`` (stats into the metrics registry) waits
for the port of ``obs/``; :meth:`PrefixCache.stats` returns the same
numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kvpool import PagedKVPool


@dataclasses.dataclass
class _Node:
    """One cached page: ``key`` is its page_size-token content, ``page`` the
    physical page holding its KV.  Children extend the prefix by one page."""
    key: Tuple[int, ...]
    page: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0


class PrefixCache:
    """Radix-tree prefix index over a :class:`PagedKVPool`.

    grain: alignment of reusable prefix lengths in tokens (the serving
    engine passes its prefill bucketing grain — a multiple of ``page_size``
    — so suffix prefill always starts on a compile-shape boundary).
    """

    def __init__(self, pool: PagedKVPool, grain: Optional[int] = None):
        self.pool = pool
        self.page_size = pool.page_size
        grain = pool.page_size if grain is None else grain
        if grain % pool.page_size:
            raise ValueError(
                f"grain {grain} must be a multiple of page_size {pool.page_size}"
            )
        self.grain = grain
        self._root = _Node(key=(), page=-1, parent=None)
        self._clock = 0
        self._n_nodes = 0
        self._stats = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                       "inserted_pages": 0, "evicted_pages": 0}

    # --- queries --------------------------------------------------------------
    def __len__(self) -> int:
        return self._n_nodes

    def _chunks(self, tokens: Sequence[int]):
        ps = self.page_size
        for j in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    def lookup(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached page-aligned proper prefix of ``prompt``.

        Returns ``(pages, cached_len)``: the shared physical pages covering
        the prefix and its token length — floored to the alignment grain and
        capped at ``len(prompt) - 1`` so at least one suffix token is always
        computed (prefill must produce the last-token logits).
        """
        self._clock += 1
        self._stats["lookups"] += 1
        node = self._root
        matched: List[_Node] = []
        for key in self._chunks(prompt):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            matched.append(child)
            node = child
        limit = len(prompt) - 1
        cached = min(len(matched) * self.page_size, max(limit, 0))
        cached = (cached // self.grain) * self.grain
        pages = [n.page for n in matched[: cached // self.page_size]]
        if pages:
            self._stats["hits"] += 1
            self._stats["hit_tokens"] += cached
        return pages, cached

    # --- growth ---------------------------------------------------------------
    def insert(self, prompt: Sequence[int], block_row: Sequence[int]) -> int:
        """Publish a prefilled request's full prompt pages into the tree.

        ``block_row``: the slot's physical pages (leading entries cover the
        prompt).  Only pages fully covered by real prompt tokens are
        insertable — the partial tail page stays slot-private.  Pages whose
        path already exists are skipped (the first request to finish a
        prefix wins; duplicates stay private to their slot).  Returns the
        number of pages newly pinned into the tree.
        """
        self._clock += 1
        node = self._root
        added = 0
        for j, key in enumerate(self._chunks(prompt)):
            child = node.children.get(key)
            if child is None:
                page = int(block_row[j])
                self.pool.pin(page)
                child = _Node(key=key, page=page, parent=node,
                              last_used=self._clock)
                node.children[key] = child
                self._n_nodes += 1
                added += 1
            else:
                child.last_used = self._clock
            node = child
        self._stats["inserted_pages"] += added
        return added

    # --- shrinkage ------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _drop(self, node: _Node) -> bool:
        """Remove a leaf from the tree; returns True if its page was freed."""
        if node.children:
            raise AssertionError("only a leaf can leave the tree")
        del node.parent.children[node.key]
        self._n_nodes -= 1
        return self.pool.unpin(node.page)

    def evict(self, need_pages: int) -> int:
        """Free up to ``need_pages`` by unpinning LRU leaves whose page is
        held by the tree alone (refcount 1 — no live slot reads it),
        cascading into parents as they become evictable leaves.  Returns
        the number of pages actually freed."""
        freed = 0
        while freed < need_pages:
            idle = [n for n in self._leaves()
                    if self.pool.refcount[n.page] == 1]
            if not idle:
                break
            victim = min(idle, key=lambda n: n.last_used)
            if self._drop(victim):
                freed += 1
                self._stats["evicted_pages"] += 1
        return freed

    def clear(self) -> int:
        """Unpin every node (teardown); returns pages freed."""
        freed = 0
        while self._n_nodes:
            for leaf in self._leaves():
                if self._drop(leaf):
                    freed += 1
                    self._stats["evicted_pages"] += 1
        return freed

    # --- introspection --------------------------------------------------------
    def held_pages(self) -> List[int]:
        """Physical pages currently pinned by tree nodes."""
        out: List[int] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    def stats(self) -> Dict[str, float]:
        s = dict(self._stats)
        s["nodes"] = self._n_nodes
        s["hit_rate"] = (s["hits"] / s["lookups"]) if s["lookups"] else 0.0
        return s

    def publish(self, registry) -> None:
        """Mirror :meth:`stats` into a ``repro_torch.obs.MetricsRegistry``
        (the serving engine calls this at the end of a run)."""
        s = self.stats()
        registry.gauge(
            "prefix_hit_rate", "prefix-cache hits / lookups").set(s["hit_rate"])
        registry.gauge(
            "prefix_nodes", "radix-tree nodes (one full page each)",
        ).set(s["nodes"])
        registry.gauge(
            "prefix_hit_tokens", "prompt tokens served from shared pages",
        ).set(s["hit_tokens"])
