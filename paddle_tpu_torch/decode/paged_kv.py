"""Block-paged KV storage: host-side allocator + device pool
(``paddle_tpu/decode/paged_kv.py``).

The pool is one preallocated device tensor of ``num_pages`` fixed-size
pages; sequences own page sets named by their page table, so ragged
contexts share the allocation with zero per-sequence reshapes.  The
allocator is pure host bookkeeping (a refcounted free list, page 0
reserved as the null page); exhaustion is an *admission* signal
(``PoolExhausted``) so the scheduler refuses new sequences instead of
corrupting live ones.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.observability import metrics as _metrics

_M_PAGES_IN_USE = _metrics.gauge(
    "decode_pages_in_use", "KV-cache pages currently owned by sequences")
_M_PAGE_ALLOCS = _metrics.counter(
    "decode_page_allocs_total", "pages handed out by the allocator")
_M_PAGE_FREES = _metrics.counter(
    "decode_page_frees_total", "pages returned to the allocator free list")
_M_PAGE_REFS = _metrics.gauge(
    "decode_page_refs", "total references held on allocated pages "
    "(> pages_in_use means copy-on-write sharing is active)")
_M_PAGES_SHARED = _metrics.gauge(
    "decode_pages_shared", "pages with refcount > 1 (aliased by forks, "
    "beams, or the prefix cache)")
_M_COW_COPIES = _metrics.counter(
    "decode_cow_copies_total",
    "shared pages copied before a write (copy-on-write splits)")


class PoolExhausted(RuntimeError):
    """The page pool cannot satisfy an allocation: refuse admission."""


class PageAllocator:
    """Refcounted free-list page allocator.  Pages are ints in
    [0, num_pages).

    Page 0 is reserved as the *null page*: inactive slots' page tables
    point at it, so a fixed-shape gather never indexes freed memory.

    Sharing model (copy-on-write substrate): ``alloc`` hands out pages
    at refcount 1; ``fork`` aliases an existing page run by bumping each
    refcount; ``free`` releases one reference per page and only returns
    a page to the free list when its count hits zero.  A writer must
    check ``is_shared`` first and copy the page before mutating it.
    """

    NULL_PAGE = 0

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        # LIFO free list: a just-freed (still-hot) page is reused first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._refs: dict = {}               # page -> live reference count
        self._in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self._in_use

    @property
    def total_refs(self) -> int:
        return sum(self._refs.values())

    @property
    def pages_shared(self) -> int:
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def is_shared(self, page: int) -> bool:
        return self._refs.get(int(page), 0) > 1

    def _set_gauges(self) -> None:
        _M_PAGES_IN_USE.set(self._in_use)
        _M_PAGE_REFS.set(self.total_refs)
        _M_PAGES_SHARED.set(self.pages_shared)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages (each at refcount 1) or raise
        ``PoolExhausted`` (taking none)."""
        if n > len(self._free):
            raise PoolExhausted(
                f"page pool exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.num_pages - 1} usable")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self._in_use += n
        _M_PAGE_ALLOCS.inc(n)
        self._set_gauges()
        return pages

    def fork(self, pages: Sequence[int]) -> List[int]:
        """Alias an existing page run: bump each page's refcount and
        return the same ids as a fresh list the new owner may mutate
        (list-structurally — the *pages* stay shared until CoW)."""
        out = []
        for p in pages:
            p = int(p)
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"cannot fork unallocated page {p}")
            self._refs[p] += 1
            out.append(p)
        self._set_gauges()
        return out

    def free(self, pages: Sequence[int]) -> List[int]:
        """Release one reference per page; pages whose count hits zero
        return to the free list.  Returns the ids actually freed.
        Releasing a page with no live reference is the double-free
        corruption and raises."""
        freed = []
        for p in pages:
            p = int(p)
            if p == self.NULL_PAGE:
                raise ValueError("cannot free the reserved null page")
            if not (0 < p < self.num_pages) or self._refs.get(p, 0) < 1:
                raise ValueError(f"double free / bad page id {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                self._in_use -= 1
                freed.append(p)
        _M_PAGE_FREES.inc(len(freed))
        self._set_gauges()
        return freed


class PagedPool:
    """Device-resident page pool: ``(num_pages, page_size) + feature``.

    The JAX pool is an immutable array that every write replaces; here
    ``data`` is one torch tensor on ``device`` and every write updates
    it in place (``index_copy_``, indexed assignment), so a write costs
    the rows it writes, not a copy of the pool.
    """

    def __init__(self, num_pages: int, page_size: int,
                 feature_shape: Tuple[int, ...], dtype=torch.float32,
                 device="cpu"):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.feature_shape = tuple(int(d) for d in feature_shape)
        self.allocator = PageAllocator(num_pages)
        self.data = torch.zeros(
            (self.num_pages, self.page_size) + self.feature_shape,
            dtype=dtype, device=device)

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` rows."""
        return max(1, -(-int(length) // self.page_size))

    def write_rows(self, pages: Sequence[int], rows) -> None:
        """Write ``rows`` (T, *feature) into ``pages`` front-to-back,
        zero-padding the final partial page.  ``rows`` may be numpy or a
        tensor; a tensor on the pool's device is copied there, never
        through the host."""
        n = len(pages)
        cap = n * self.page_size
        if not isinstance(rows, torch.Tensor):
            rows = torch.as_tensor(np.asarray(rows))
        rows = rows.to(device=self.data.device, dtype=self.data.dtype)
        if rows.shape[0] > cap:
            raise ValueError(
                f"{rows.shape[0]} rows do not fit {n} pages "
                f"({cap} row capacity)")
        buf = torch.zeros((cap,) + self.feature_shape, dtype=self.data.dtype,
                          device=self.data.device)
        buf[:rows.shape[0]] = rows
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.data.device)
        self.data.index_copy_(0, idx, buf.reshape(
            (n, self.page_size) + self.feature_shape))

    def append_row(self, pages: Sequence[int], position: int, row) -> None:
        """Write one row at logical ``position`` within the sequence's
        pages (the growing-KV decode case)."""
        page = pages[position // self.page_size]
        self.data[page, position % self.page_size] = torch.as_tensor(
            np.asarray(row), dtype=self.data.dtype)

    def copy_page(self, src: int, dst: int) -> None:
        """Device copy of one page's rows (the CoW split)."""
        self.data[dst] = self.data[src]
        _M_COW_COPIES.inc()

    def page_table(self, pages: Sequence[int], width: int) -> np.ndarray:
        """Fixed-width page-table row, null-padded past the owned pages."""
        t = np.full((width,), PageAllocator.NULL_PAGE, np.int32)
        t[:len(pages)] = np.asarray(pages, np.int32)
        return t


class SequencePages:
    """One sequence's page ownership + logical length."""

    __slots__ = ("pages", "length", "capacity")

    def __init__(self, pages: List[int], length: int, page_size: int):
        self.pages = pages
        self.length = int(length)
        self.capacity = len(pages) * page_size

    def grow_needed(self) -> bool:
        return self.length >= self.capacity


def alloc_sequence(pool: PagedPool, length: int,
                   reserve_growth: int = 0) -> SequencePages:
    """Allocate pages for a ``length``-row context (+ optional headroom
    for per-step KV growth).  Raises ``PoolExhausted`` without partial
    allocation."""
    n = pool.pages_for(max(1, length + reserve_growth))
    pages = pool.allocator.alloc(n)
    return SequencePages(pages, length, pool.page_size)


def fork_sequence(pool: PagedPool, seq: SequencePages) -> SequencePages:
    """Alias ``seq``'s pages into a new SequencePages (refcounts bumped);
    the fork diverges from its parent page-by-page via CoW writes."""
    return SequencePages(pool.allocator.fork(seq.pages), seq.length,
                         pool.page_size)


def free_sequence(pool: PagedPool, seq: Optional[SequencePages]) -> None:
    if seq is not None and seq.pages:
        pool.allocator.free(seq.pages)
        seq.pages = []


def cow_split(allocator: PageAllocator, pages: List[int], page_idx: int,
              copiers) -> Optional[int]:
    """Make ``pages[page_idx]`` private before a write: when shared,
    allocate a fresh page, run each ``copier(src, dst)`` device copy,
    release the shared original, and patch the page list in place.
    Returns the new page id (or None when the page was already private).
    Raises ``PoolExhausted`` without touching anything when no page is
    free for the copy."""
    old = pages[page_idx]
    if not allocator.is_shared(old):
        return None
    (new,) = allocator.alloc(1)
    for copy in copiers:
        copy(old, new)
    allocator.free([old])
    pages[page_idx] = new
    return new
