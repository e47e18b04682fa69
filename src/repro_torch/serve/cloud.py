"""Cloud-only batched serving engine (the non-collaborative baseline).

Counterpart of ``repro.serve.cloud.ServingEngine`` with its block-table
page pool (the reference's ``paged=True``; fp pages by default, INT8
pages with per-slot scales for ``int8_kv=True``).  The dense per-slot
cache is not ported yet; the JAX suite shows paged fp equals dense
(``tests/test_paged_attention.py::test_paged_fp_engine_matches_dense_engine``),
so the paged fp engine stands in for it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serve.kvcache import (_PagedPool, _paged_prefill_merge,
                                       _paged_prefill_view)
from repro_torch.serve.scheduler import _SlotEngine

Params = Any

__all__ = ["ServingEngine"]


class ServingEngine(_SlotEngine):
    """Cloud-only batched engine (greedy decode, continuous batching)
    over a paged KV cache on ``device`` (default ``"cuda"``)."""

    def __init__(self, params: Params, cfg: TF.LMConfig, *,
                 max_batch: int = 4, max_len: int = 128,
                 page_size: int = 16, int8_kv: bool = False,
                 num_pages: Optional[int] = None,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        super().__init__(cfg, max_batch=max_batch, max_len=max_len,
                         device=dev)
        self.params = params
        self._pool = _PagedPool.build(max_batch, max_len, page_size,
                                      num_pages, dev)
        self._cache = TF.init_cache(
            cfg, max_batch, max_len, paged=True, page_size=page_size,
            quantized=int8_kv, num_pages=self._pool.allocator.num_pages,
            device=dev)

    def _admit(self, toks, plens, max_news, slots, cur, pos):
        bt_rows = self._pool.admit(slots, plens, max_news, toks.shape[1])
        slots_d = torch.as_tensor(slots, device=self.device).long()
        plens_d = torch.as_tensor(plens, device=self.device)
        group = _paged_prefill_view(self._cache, self.cfg.n_layers,
                                    toks.shape[0], self.cfg.n_kv)
        logits, group = TF.prefill(self.params, toks, self.cfg, cache=group,
                                   block_tables=bt_rows,
                                   last_pos=plens_d - 1)
        _paged_prefill_merge(self._cache, group, slots_d)
        cur = cur.clone()
        pos = pos.clone()
        cur[slots_d] = torch.argmax(logits, -1).to(torch.int32)
        pos[slots_d] = plens_d
        return cur, pos

    def _decode_all(self, cur, pos, n_active):
        logits, self._cache = TF.decode_step(
            self.params, cur, self._cache, pos, self.cfg,
            block_tables=self._pool.table_dev())
        nxt = torch.argmax(logits, -1).to(torch.int32)
        return nxt, torch.clamp(pos + 1, max=self.max_len - 1)

    def _retire(self, slot):
        self._pool.retire(slot)

    def _can_admit(self, group_shapes, plen, max_new, bucket):
        return self._pool.can_admit(group_shapes + [(plen, max_new)], bucket)
