"""Cloud-only batched serving engine (the non-collaborative baseline).

Counterpart of ``repro.serve.cloud.ServingEngine``: one KV cache over
the whole stack — dense fp by default (``cache_dtype`` overrides its
storage dtype; ``int8_kv`` stores INT8 with the fixed per-(layer,
kv-head) scales), or with ``paged=True`` the block-table page pool (fp
pages, or INT8 pages with per-slot scales calibrated at prefill for
``int8_kv``).  ``mesh`` splits the whole parameter stack and the page
pool tensor-parallel over its ``model`` shards
(``serve.sharding.place_cloud_engine``; a dense cache on more than one
shard is not ported, ROADMAP A16).  ``timed`` adds each prefill's and
round's wall time to ``stats.prefill_s`` / ``stats.decode_s``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import engine_device
from repro_torch.models import transformer as TF
from repro_torch.serve.kvcache import (_PagedPool, _paged_prefill_merge,
                                       _paged_prefill_view)
from repro_torch.serve.scheduler import _SlotEngine
from repro_torch.serve.sharding import place_cloud_engine

Params = Any

__all__ = ["ServingEngine"]


class ServingEngine(_SlotEngine):
    """Cloud-only batched engine (greedy decode — a sampled request is
    refused at admission, as the reference refuses it — continuous
    batching) on ``device`` (default ``"cuda"``), or tensor-parallel
    over the shards of ``mesh`` (``launch.mesh.make_serve_mesh``; its
    first device is the engine's device)."""

    def __init__(self, params: Params, cfg: TF.LMConfig, *,
                 max_batch: int = 4, max_len: int = 128,
                 paged: bool = False, page_size: int = 16,
                 int8_kv: bool = False, num_pages: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 timed: bool = False, mesh=None,
                 device: DeviceLike = None):
        dev = engine_device(mesh, device)
        super().__init__(cfg, max_batch=max_batch, max_len=max_len,
                         device=dev, timed=timed)
        self.mesh = mesh
        self.params = params
        self.paged = paged
        self.page_size = page_size
        self.int8_kv = int8_kv
        self._pool = None
        if paged:
            self._pool = _PagedPool.build(max_batch, max_len, page_size,
                                          num_pages, dev)
            self._cache = TF.init_cache(
                cfg, max_batch, max_len, cache_dtype, paged=True,
                page_size=page_size, quantized=int8_kv,
                num_pages=self._pool.allocator.num_pages, device=dev)
        else:
            self._cache = TF.init_cache(cfg, max_batch, max_len, cache_dtype,
                                        quantized=int8_kv, device=dev)
        place_cloud_engine(self)

    def _admit(self, toks, plens, max_news, slots, cur, pos, samplings=None):
        if any(s is not None and s.sampled for s in (samplings or [])):
            raise ValueError(
                "cloud-only baseline is greedy; sampled serving lives in "
                "CollaborativeServingEngine (serve.sampling)")
        n = toks.shape[0]
        slots_d = torch.as_tensor(slots, device=self.device).long()
        plens_d = torch.as_tensor(plens, device=self.device)
        if self.paged:
            bt_rows = self._pool.admit(slots, plens, max_news, toks.shape[1])
            group = _paged_prefill_view(self._cache, n)
            logits, group = TF.prefill(self.params, toks, self.cfg,
                                       cache=group, block_tables=bt_rows,
                                       last_pos=plens_d - 1)
            _paged_prefill_merge(self._cache, group, slots_d)
        else:
            # a cache of the group's rows, then its K/V into the slots
            small = TF.init_cache(self.cfg, n, self.max_len,
                                  self._cache["k"].dtype,
                                  quantized=self.int8_kv,
                                  device=self.device)
            logits, small = TF.prefill(self.params, toks, self.cfg,
                                       cache=small, last_pos=plens_d - 1)
            for k in ("k", "v"):
                self._cache[k][:, slots_d] = small[k]
        cur = cur.clone()
        pos = pos.clone()
        cur[slots_d] = torch.argmax(logits, -1).to(torch.int32)
        pos[slots_d] = plens_d
        return cur, pos

    def _decode_all(self, cur, pos, n_active):
        logits, self._cache = TF.decode_step(
            self.params, cur, self._cache, pos, self.cfg,
            block_tables=self._pool.table_dev() if self.paged else None)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        return nxt, torch.clamp(pos + 1, max=self.max_len - 1)

    def _retire(self, slot):
        if self.paged:
            self._pool.retire(slot)

    def _can_admit(self, group_shapes, plen, max_new, bucket):
        if not self.paged:
            return True
        return self._pool.can_admit(group_shapes + [(plen, max_new)], bucket)

    def cache_bytes(self, *, live_only: bool = False) -> int:
        """Cache footprint in bytes; ``live_only`` counts only the pages
        allocated to requests (paged)."""
        if self.paged and live_only:
            return self._pool.live_cache_bytes(self._cache)
        return sum(v.numel() * v.element_size()
                   for c in (self._cache if isinstance(self._cache, list)
                             else [self._cache])
                   for v in c.values())
