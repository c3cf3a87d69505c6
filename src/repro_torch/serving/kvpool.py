"""Paged KV pool: host-side page bookkeeping for continuous batching.

The pool owns ``num_pages`` fixed-size KV pages and a block table mapping
(slot, logical page) -> physical page.  The page *storage* lives with the
executor (``core/hmp.py:make_kv_cache``); this class only does the
allocation arithmetic, so it is pure numpy.

Page 0 is the **null page**: it is never handed to a request.  Block-table
rows of idle slots (and the unused tail of every row) point at it, so the
decode step can scatter/gather with fixed shapes — writes from idle slots
land in the null page and reads from it are masked out by the per-slot
length mask.

Admission is reservation-based and therefore deadlock-free: a request is
admitted only if the pool can cover its *worst-case* page count (prompt +
max_new_tokens), but pages are physically allocated lazily (prompt pages at
admission, one page at a time as decode crosses page boundaries).  Freed
pages return to the free list on retirement and are reused by later
admissions.

Pages are **refcounted** so prompt-prefix pages can be shared across
requests: ``admit(shared_pages=...)`` attaches already-filled pages to the
front of a slot's row and bumps their refcounts instead of allocating;
``retire`` decrements, and a page returns to the free list only when its
refcount hits zero.  External holders take references through
``pin``/``unpin``, and ``check()`` validates the full refcount algebra:
every page's refcount equals its block-table row occurrences across live
slots plus its pin count.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

NULL_PAGE = 0


class PoolExhausted(RuntimeError):
    """Raised when an allocation violates its reservation (a scheduler bug)."""


class PagedKVPool:
    """Block-table + free-list bookkeeping over a fixed set of KV pages.

    num_pages:  total physical pages, including the reserved null page 0
    page_size:  positions per page
    num_slots:  decode slots (rows of the block table)
    pages_per_slot: block-table width (max logical pages per request)
    """

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 pages_per_slot: int):
        if num_pages < 2:
            raise ValueError("need at least one page beyond the null page")
        if page_size < 1 or num_slots < 1 or pages_per_slot < 1:
            raise ValueError("page_size, num_slots, pages_per_slot must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.pages_per_slot = pages_per_slot
        # LIFO free list, low pages first out (stable for tests)
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        self.block_table = np.full((num_slots, pages_per_slot), NULL_PAGE, np.int32)
        self._allocated: List[List[int]] = [[] for _ in range(num_slots)]
        self._reserved = np.zeros(num_slots, np.int64)
        self.active = np.zeros(num_slots, bool)
        # per-page reference counts: block-table occurrences + pins
        self.refcount = np.zeros(num_pages, np.int64)
        self._pins = np.zeros(num_pages, np.int64)

    # --- capacity -------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Physical pages currently referenced (null page excluded)."""
        return self.num_pages - 1 - len(self._free)

    def occupancy(self) -> float:
        """Fraction of usable pages (null page excluded) currently in use —
        the ``kv_pool_occupancy`` gauge in the engine's metrics registry."""
        return self.used_pages / (self.num_pages - 1)

    @property
    def reserved_backlog(self) -> int:
        """Pages promised to active slots but not yet allocated."""
        return int(sum(
            self._reserved[s] - len(self._allocated[s])
            for s in range(self.num_slots) if self.active[s]
        ))

    @property
    def available(self) -> int:
        """Pages a new admission may reserve against."""
        return self.free_pages - self.reserved_backlog

    def pages_for(self, positions: int) -> int:
        """Pages needed to hold ``positions`` KV entries."""
        return -(-positions // self.page_size)

    def can_admit(self, max_positions: int, shared: int = 0) -> bool:
        """``shared`` prefix pages come from the prefix cache (already
        filled), so only the remainder must be free or reservable."""
        need = self.pages_for(max_positions)
        return need <= self.pages_per_slot and need - shared <= self.available

    def free_slot(self) -> Optional[int]:
        idle = np.flatnonzero(~self.active)
        return int(idle[0]) if idle.size else None

    # --- lifecycle ------------------------------------------------------------
    def _attach(self, slot: int, page: int) -> None:
        row = self._allocated[slot]
        self.block_table[slot, len(row)] = page
        row.append(page)
        self.refcount[page] += 1

    def _take_page(self, slot: int) -> int:
        if not self._free:
            raise PoolExhausted(f"slot {slot}: free list empty")
        page = self._free.pop()
        self._attach(slot, page)
        return page

    def _release(self, page: int) -> bool:
        """Drop one reference; returns True if the page was actually freed."""
        if self.refcount[page] <= 0:
            raise ValueError(f"page {page}: release below zero refcount")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)
            return True
        return False

    def admit(self, slot: int, initial_positions: int, max_positions: int,
              shared_pages: Sequence[int] = ()) -> None:
        """Reserve ``pages_for(max_positions)`` and allocate the prompt pages.

        ``shared_pages`` are prefix-cache hits: already-filled physical pages
        that become this slot's leading logical pages.  They are attached by
        refcount bump (no allocation), so admission only needs
        ``pages_for(max_positions) - len(shared_pages)`` reservable pages.
        """
        if self.active[slot]:
            raise ValueError(f"slot {slot} is already active")
        need = self.pages_for(max_positions)
        k = len(shared_pages)
        if need > self.pages_per_slot:
            raise ValueError(
                f"request needs {need} pages, block table holds {self.pages_per_slot}"
            )
        if initial_positions > max_positions:
            raise ValueError("initial_positions exceeds max_positions")
        if k > self.pages_for(initial_positions):
            raise ValueError(
                f"{k} shared prefix pages exceed the prompt's "
                f"{self.pages_for(initial_positions)} pages"
            )
        if any(p == NULL_PAGE or self.refcount[p] <= 0 for p in shared_pages):
            raise ValueError("shared pages must be live non-null pages")
        if need - k > self.available:
            raise PoolExhausted(
                f"admission needs {need - k} new pages, {self.available} available"
            )
        self.active[slot] = True
        self._reserved[slot] = need
        for page in shared_pages:
            self._attach(slot, int(page))
        for _ in range(self.pages_for(initial_positions) - k):
            self._take_page(slot)

    def ensure(self, slot: int, position: int) -> None:
        """Allocate pages (within the reservation) so ``position`` is writable."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        while len(self._allocated[slot]) * self.page_size <= position:
            if len(self._allocated[slot]) >= self._reserved[slot]:
                raise PoolExhausted(
                    f"slot {slot}: position {position} exceeds reservation "
                    f"of {int(self._reserved[slot])} pages"
                )
            self._take_page(slot)

    def truncate(self, slot: int, positions: int) -> List[int]:
        """Roll a slot back so it holds exactly ``pages_for(positions)``
        pages, releasing the tail pages (speculative-decoding rejection:
        pages ``ensure``-d for draft tokens the verifier refused).  The
        reservation is untouched — it is a worst-case bound and the slot
        may still grow back to it.  Tail pages are always slot-private
        (they lie beyond the prompt, hence beyond any shared prefix), so
        the refcount release frees them immediately unless pinned.
        Returns the pages released."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        keep = self.pages_for(positions)
        row = self._allocated[slot]
        if keep >= len(row):
            return []
        dropped = row[keep:]
        for page in reversed(dropped):
            self._release(page)
        self._allocated[slot] = row[:keep]
        self.block_table[slot, keep:] = NULL_PAGE
        return dropped

    def retire(self, slot: int) -> List[int]:
        """Drop the slot's page references; zero its row.  Returns the pages
        the slot held — each goes back to the free list only if this was its
        last reference (unshared pools: all of them, as before)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        pages = self._allocated[slot]
        for page in reversed(pages):
            self._release(page)
        self._allocated[slot] = []
        self._reserved[slot] = 0
        self.block_table[slot, :] = NULL_PAGE
        self.active[slot] = False
        return pages

    def shared_page_count(self) -> int:
        """Physical pages currently referenced by two or more live slots."""
        counts: dict = {}
        for row in self._allocated:
            for p in row:
                counts[p] = counts.get(p, 0) + 1
        return sum(1 for v in counts.values() if v >= 2)

    # --- external references (prefix cache) -----------------------------------
    def pin(self, page: int) -> None:
        """Add an external (prefix-tree) reference to a live page."""
        if page == NULL_PAGE:
            raise ValueError("cannot pin the null page")
        if self.refcount[page] <= 0:
            raise ValueError(f"page {page}: pin of an unallocated page")
        self.refcount[page] += 1
        self._pins[page] += 1

    def unpin(self, page: int) -> bool:
        """Drop an external reference; returns True if the page was freed."""
        if self._pins[page] <= 0:
            raise ValueError(f"page {page}: unpin without a pin")
        self._pins[page] -= 1
        return self._release(page)

    # --- invariants (tests / sharing admissions) ------------------------------
    def check(self) -> None:
        """Validate the refcount algebra: no page leaked, double-freed, or
        null-aliased, and every refcount equals block-table occurrences
        across live slots plus the prefix-tree pin count.  Raises
        AssertionError explicitly (not via ``assert``) so the guard also
        fires under ``python -O``."""
        def ensure(cond, msg):
            if not cond:
                raise AssertionError(msg)

        held: List[int] = [p for row in self._allocated for p in row]
        ensure(NULL_PAGE not in held, "null page was allocated")
        ensure(NULL_PAGE not in self._free, "null page on the free list")
        ensure(len(set(self._free)) == len(self._free), "free-list duplicate")
        occurrences = np.zeros(self.num_pages, np.int64)
        for p in held:
            occurrences[p] += 1
        expect = occurrences + self._pins
        ensure(np.array_equal(self.refcount, expect),
               f"refcount desync: refcount={self.refcount.tolist()} != "
               f"slots+pins={expect.tolist()}")
        # the satellite invariant: total references == pages held by live
        # slots (with multiplicity) + prefix-tree nodes
        ensure(int(self.refcount.sum()) == len(held) + int(self._pins.sum()),
               "refcount sum != slot holdings + tree pins")
        for p in self._free:
            ensure(self.refcount[p] == 0, f"page {p} free while referenced")
        live = int(np.count_nonzero(self.refcount[1:]))
        ensure(live + len(self._free) == self.num_pages - 1, "page leak")
        for s in range(self.num_slots):
            row = self.block_table[s]
            n = len(self._allocated[s])
            ensure(list(row[:n]) == self._allocated[s], "block table desync")
            ensure(bool(np.all(row[n:] == NULL_PAGE)), "stale block-table tail")
            if not self.active[s]:
                ensure(n == 0 and self._reserved[s] == 0,
                       "idle slot holds pages")
