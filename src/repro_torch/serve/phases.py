"""The split-cache phases of collaborative serving: the Eq.(1)/(2)
boundary lattice and the edge-prefix / cloud-suffix prefill and decode.

Counterpart of ``repro.serve.phases._SplitPhases`` (greedy phases; the
sampled variants come with the sampling slice).  Anything mixing it in
provides ``cfg``, ``max_len``, ``a_bits``, ``edge_int8``/``cloud_int8``,
``_edge_qctx`` and ``_rope()``.  Each phase updates its paged cache in
place and returns the new per-slot state; the cloud phases take the
engine's tensor-parallel blocks, head and shard caches as they come
(``serve.sharding``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import (QuantParams, compute_qparams, dequantize,
                                    quantize)
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.kvcache import _paged_prefill_merge, _paged_prefill_view

__all__ = ["_SplitPhases"]


class _SplitPhases:
    """See the module docstring."""

    def _quant_boundary(self, h: torch.Tensor,
                        ranged: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, QuantParams]:
        """Per-row Eq.(1) framing of a boundary blob.  ``ranged``
        overrides the tensor the thresholds come from (prefill clamps
        bucket padding out of the min/max).  ``a_bits=None`` is the
        lossless mode: the blob ships as-is under a unit lattice, so
        ``dequantize`` is the identity bit for bit."""
        if self.a_bits is None:
            n = h.shape[0]
            unit = QuantParams(
                scale=torch.ones((n,), dtype=torch.float32, device=h.device),
                zero_point=torch.zeros((n,), dtype=torch.float32,
                                       device=h.device),
                axis=0, bits=8, signed=True)
            return h.to(torch.float32), unit
        qp = compute_qparams(h if ranged is None else ranged, axis=0,
                             bits=self.a_bits)
        return quantize(h, qp), qp

    def _edge_prefill(self, blocks, embed, toks, cache, slots, bt_rows,
                      plens):
        cfg = self.cfg
        s = toks.shape[1]
        x = ML.embed(embed, toks).to(cfg.dtype)
        group = _paged_prefill_view(cache, toks.shape[0])
        h, group = TF.run_blocks(blocks, x, cfg, rope=self._rope(),
                                 cache=group, cache_index=0,
                                 qctx=self._edge_qctx, block_tables=bt_rows,
                                 calibrate_kv=self.edge_int8,
                                 kv_lengths=plens)
        _paged_prefill_merge(cache, group, slots)
        # Eq.(1) per batch row; pad positions are clamped to a real
        # activation before the min/max, so bucket padding never sets a
        # request's range (and never crosses the wire)
        real = (torch.arange(s, device=h.device)[None, :, None]
                < plens[:, None, None])
        ranged = torch.where(real, h, h[:, :1])
        return self._quant_boundary(h, ranged)

    def _cloud_prefill(self, blocks, tail, blob, qp, cache, slots, bt_rows,
                       cur, pos, plens):
        cfg = self.cfg
        h = dequantize(blob, qp).to(cfg.dtype)              # Eq.(2)
        n = h.shape[0]
        group = _paged_prefill_view(cache, n)
        x, group = TF.run_blocks(blocks, h, cfg, rope=self._rope(),
                                 cache=group, cache_index=0,
                                 block_tables=bt_rows,
                                 calibrate_kv=self.cloud_int8,
                                 kv_lengths=plens)
        _paged_prefill_merge(cache, group, slots)
        last = x[torch.arange(n, device=x.device), (plens - 1).long()]
        logits = TF.lm_head(tail, last[:, None])[:, 0]
        # fresh tensors: the scheduler keeps views of the previous ones
        cur, pos = cur.clone(), pos.clone()
        cur[slots] = torch.argmax(logits, -1).to(torch.int32)
        pos[slots] = plens
        return cur, pos

    def _edge_decode(self, blocks, embed, cur, cache, pos, bt):
        cfg = self.cfg
        x = ML.embed(embed, cur[:, None]).to(cfg.dtype)
        h, _ = TF.run_blocks(blocks, x, cfg, rope=self._rope(), cache=cache,
                             cache_index=pos, qctx=self._edge_qctx,
                             block_tables=bt)
        # Eq.(1) per row: stale activations in idle slots must not set
        # the range of live requests' deltas
        return self._quant_boundary(h)                     # [B, 1, D]

    def _cloud_decode(self, blocks, tail, blob, qp, cache, pos, bt):
        cfg = self.cfg
        h = dequantize(blob, qp).to(cfg.dtype)              # Eq.(2)
        x, _ = TF.run_blocks(blocks, h, cfg, rope=self._rope(), cache=cache,
                             cache_index=pos, block_tables=bt)
        logits = TF.lm_head(tail, x)[:, 0]
        nxt = torch.argmax(logits, -1).to(torch.int32)
        return nxt, torch.clamp(pos + 1, max=self.max_len - 1)
