"""Paged-KV bookkeeping (host side) for the serving engines.

Counterpart of ``repro.serve.kvcache``: a LIFO page allocator whose page
0 is the reserved dump page, the per-engine block table, and the
group-local prefill view of a paged cache.  The block table lives on the
host as numpy and is copied to the device whenever it changes — a copy,
never an alias, so host edits can never race a step still reading it.

The pool's geometry depends only on ``(max_batch, max_len, page_size)``,
never on the collaborative cut.  Demand paging (``ensure``) and the
per-tenant accounting come with the overload and fleet slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PageAllocator", "PoolExhausted", "_PagedPool",
           "_paged_prefill_view", "_paged_prefill_merge"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PoolExhausted(RuntimeError):
    """Typed "no free pages" failure of ``PageAllocator.alloc``."""


class PageAllocator:
    """LIFO free-list allocator over a fixed pool of KV-cache pages.

    Page 0 is never handed out: retired/idle slots keep a zeroed block
    table row, so their (masked, harmless) decode writes land in page 0
    instead of corrupting a page re-allocated to a live request."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._live: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def live(self) -> frozenset:
        return frozenset(self._live)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"KV page pool exhausted: need {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._live.update(pages)
        return pages

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p not in self._live:
                raise ValueError(
                    f"free of page {p} which is not live (double free, or "
                    f"a page this allocator never handed out)")
            self._live.remove(p)
            self._free.append(p)


class _PagedPool:
    """Block table + allocator for one engine-side page pool.

    A request's pages are claimed at admission — enough for its padded
    prompt plus its generation budget — and returned the moment the
    scheduler retires the slot.  The collaborative engine shares one
    pool (one block table) across its edge-prefix and cloud-suffix
    caches."""

    def __init__(self, max_batch: int, pages_per_slot: int, num_pages: int,
                 page_size: int, device: torch.device):
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.device = device
        self.allocator = PageAllocator(num_pages)
        self.bt = np.zeros((max_batch, pages_per_slot), np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        self._dev: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, max_batch: int, max_len: int, page_size: int,
              num_pages: Optional[int], device: torch.device
              ) -> "_PagedPool":
        """Standard sizing: ``max_batch`` full-length slots plus the dump
        page.  An explicit ``num_pages`` below that bounds concurrency
        (admission backpressures); one that cannot hold a single
        max-length slot is rejected here."""
        pages_per_slot = _cdiv(max_len, page_size)
        if num_pages is None:
            num_pages = max_batch * pages_per_slot + 1
        elif num_pages < pages_per_slot + 1:
            raise ValueError(
                f"KV page pool num_pages={num_pages} can never admit a "
                f"single max-length slot: max_len={max_len} at "
                f"page_size={page_size} needs pages_per_slot="
                f"{pages_per_slot} plus the reserved dump page "
                f"(>= {pages_per_slot + 1})")
        return cls(max_batch, pages_per_slot, num_pages, page_size, device)

    def pages_needed(self, plen: int, max_new: int, padded_len: int) -> int:
        return _cdiv(max(int(plen) + int(max_new), int(padded_len)),
                     self.page_size)

    def can_admit(self, shapes: Sequence[Tuple[int, int]],
                  padded_len: int) -> bool:
        """Would a prefill group of (plen, max_new) shapes fit now?"""
        return sum(self.pages_needed(p, m, padded_len)
                   for p, m in shapes) <= self.allocator.num_free

    def live_cache_bytes(self, cache: Dict[str, torch.Tensor]) -> int:
        """Bytes resident in currently-allocated pages (+ scales)."""
        kp = cache["k_pages"]
        per_page = int(np.prod(kp.shape[2:])) * kp.element_size()
        scales = sum(v.numel() * v.element_size()
                     for k, v in cache.items() if "scale" in k)
        return 2 * kp.shape[0] * len(self.allocator.live) * per_page + scales

    def _copy(self, rows: np.ndarray) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int32, device=self.device)

    def admit(self, slots: Sequence[int], plens: Sequence[int],
              max_news: Sequence[int], padded_len: int) -> torch.Tensor:
        """Allocate pages for a prefill group; returns its block table
        rows, trimmed to the pages the padded prompt can touch."""
        for s, pl_, mn in zip(slots, plens, max_news):
            pages = self.allocator.alloc(
                self.pages_needed(pl_, mn, padded_len))
            self._slot_pages[int(s)] = pages
            self.bt[s, :] = 0
            self.bt[s, :len(pages)] = pages
        self._dev = None
        return self.rows(slots, padded_len)

    def rows(self, slots: Sequence[int], padded_len: int) -> torch.Tensor:
        """Current block-table rows for ``slots``, trimmed to the pages a
        ``padded_len``-position prefill or replay can touch."""
        width = max(1, _cdiv(int(padded_len), self.page_size))
        return self._copy(self.bt[np.asarray(slots)][:, :width])

    def retire(self, slot: int) -> None:
        pages = self._slot_pages.pop(int(slot), None)
        if pages is not None:
            self.allocator.free(pages)
            self.bt[slot, :] = 0
            self._dev = None

    def table_dev(self) -> torch.Tensor:
        """Block table on the device, trimmed to the pages in use
        (rounded up to a power of two), so a decode read costs
        O(allocated pages), not O(max_len).  Cached until the next
        admit/retire."""
        if self._dev is None:
            used = max((len(p) for p in self._slot_pages.values()),
                       default=1)
            width = 1
            while width < used:
                width *= 2
            width = min(width, self.pages_per_slot)
            self._dev = self._copy(self.bt[:, :width])
        return self._dev


def _paged_prefill_view(cache, n: int):
    """Group-local view of a paged cache for one prefill call: the shared
    page pool plus fresh scale rows for the ``n``-row group (the prefill
    calibrates them; scatter back with ``_paged_prefill_merge``).  A
    tensor-parallel cache (a list of shard caches) gives one view per
    shard."""
    if isinstance(cache, list):
        return [_paged_prefill_view(c, n) for c in cache]
    group = {"k_pages": cache["k_pages"], "v_pages": cache["v_pages"]}
    if "k_scale" in cache:
        n_layers, _, n_kv = cache["k_scale"].shape
        group["k_scale"] = torch.zeros((n_layers, n, n_kv),
                                       dtype=torch.float32,
                                       device=cache["k_scale"].device)
        group["v_scale"] = torch.zeros_like(group["k_scale"])
    return group


def _paged_prefill_merge(cache, group, slots: torch.Tensor):
    """Write the group's calibrated scales into the slots' rows (the
    pages were written in place already), shard by shard for a
    tensor-parallel cache."""
    if isinstance(cache, list):
        return [_paged_prefill_merge(c, g, slots)
                for c, g in zip(cache, group)]
    if "k_scale" in cache:
        rows = slots.to(cache["k_scale"].device).long()
        cache["k_scale"][:, rows] = group["k_scale"]
        cache["v_scale"][:, rows] = group["v_scale"]
    return cache
