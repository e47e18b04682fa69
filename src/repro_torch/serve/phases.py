"""The split-cache phases of collaborative serving: the Eq.(1)/(2)
boundary lattice and the edge-prefix / cloud-suffix prefill and decode.

Counterpart of ``repro.serve.phases._SplitPhases``.  Anything mixing it
in provides ``cfg``, ``max_len``, ``a_bits``, ``edge_paged``/
``edge_int8``/``cloud_paged``/``cloud_int8``, ``n_edge``/``n_cloud``,
``device``, ``_edge_qctx`` and ``_rope()``.  Each phase updates its
cache in place and returns the new per-slot state.  A prefill over a
paged cache writes the group's pages through its block-table rows; over
a dense cache it fills a cache of the group's ``n`` rows and
``max_len`` positions and copies only its ``k`` and ``v`` into the
slots (a dense INT8 cache keeps its fixed scales; the cloud's dense
cache is fp whatever ``cloud_int8`` says, as in the reference).  The
cloud
phases take the engine's tensor-parallel blocks, head and shard caches
as they come (``serve.sharding``), and see the whole vocabulary's
logits (``transformer.lm_head`` concatenates a split head's shards).

The ``*_sample_impl`` variants are the temperature > 0 cloud phases
(``serve.sampling``): the same suffix math, but the emitted token is a
seeded categorical draw from the row's filtered distribution.  Greedy
rows (``temps <= 0``) in a mixed batch take the argmax of the same
logits, so their streams equal the greedy phases' bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import (QuantParams, compute_qparams, dequantize,
                                    quantize)
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve import sampling as S
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

    def _prefill_blocks(self, blocks, x, cache, slots, bt_rows, plens, *,
                        paged: bool, int8: bool, layers: int, qctx=None
                        ) -> torch.Tensor:
        """One prefill of ``blocks`` over ``x`` into the slots' rows of
        ``cache`` → the blocks' output.  ``paged``: through the group's
        block-table rows, calibrating per-slot INT8 scales when
        ``int8``; else through a dense cache of the group's rows
        (INT8 with the fixed scales when ``int8``), whose ``k`` and
        ``v`` are then copied into the slots."""
        cfg = self.cfg
        n = x.shape[0]
        if paged:
            group = _paged_prefill_view(cache, n)
            y, group = TF.run_blocks(blocks, x, cfg, rope=self._rope(),
                                     cache=group, cache_index=0, qctx=qctx,
                                     block_tables=bt_rows,
                                     calibrate_kv=int8, kv_lengths=plens)
            _paged_prefill_merge(cache, group, slots)
            return y
        small = TF.init_cache(cfg, n, self.max_len, layers=layers,
                              quantized=int8, device=self.device)
        y, small = TF.run_blocks(blocks, x, cfg, rope=self._rope(),
                                 cache=small, cache_index=0, qctx=qctx)
        for k in ("k", "v"):
            cache[k][:, slots] = small[k]
        return y

    def _edge_prefill(self, blocks, embed, toks, cache, slots, bt_rows,
                      plens):
        cfg = self.cfg
        s = toks.shape[1]
        x = ML.embed(embed, toks).to(cfg.dtype)
        h = self._prefill_blocks(blocks, x, cache, slots, bt_rows, plens,
                                 paged=self.edge_paged, int8=self.edge_int8,
                                 layers=self.n_edge, qctx=self._edge_qctx)
        # Eq.(1) per batch row; pad positions are clamped to a real
        # activation before the min/max, so bucket padding never sets a
        # request's range (and never crosses the wire)
        real = (torch.arange(s, device=h.device)[None, :, None]
                < plens[:, None, None])
        ranged = torch.where(real, h, h[:, :1])
        return self._quant_boundary(h, ranged)

    def _cloud_prefill_body(self, blocks, tail, blob, qp, cache, slots,
                            bt_rows, plens) -> torch.Tensor:
        """Shared suffix prefill: fills the cloud cache and returns the
        last-prompt-position logits the first token comes from."""
        cfg = self.cfg
        h = dequantize(blob, qp).to(cfg.dtype)              # Eq.(2)
        n = h.shape[0]
        x = self._prefill_blocks(blocks, h, cache, slots, bt_rows, plens,
                                 paged=self.cloud_paged,
                                 int8=self.cloud_int8 and self.cloud_paged,
                                 layers=self.n_cloud)
        last = x[torch.arange(n, device=x.device), (plens - 1).long()]
        return TF.lm_head(tail, last[:, None])[:, 0]

    @staticmethod
    def _set_rows(cur, pos, slots, tok, plens):
        # fresh tensors: the scheduler keeps views of the previous ones
        cur, pos = cur.clone(), pos.clone()
        cur[slots] = tok
        pos[slots] = plens
        return cur, pos

    def _cloud_prefill(self, blocks, tail, blob, qp, cache, slots, bt_rows,
                       cur, pos, plens):
        logits = self._cloud_prefill_body(blocks, tail, blob, qp, cache,
                                          slots, bt_rows, plens)
        return self._set_rows(cur, pos, slots,
                              torch.argmax(logits, -1).to(torch.int32), plens)

    def _cloud_prefill_sample_impl(self, blocks, tail, blob, qp, cache,
                                   slots, bt_rows, cur, pos, plens, temps,
                                   top_ps, seeds):
        """Sampled prefill: the first token (absolute output index 0) is
        a ``CLOUD``-stream draw from the filtered distribution; greedy
        rows in the group keep the argmax.  ``temps``/``top_ps``/
        ``seeds`` are group-row vectors aligned with ``slots``."""
        logits = self._cloud_prefill_body(blocks, tail, blob, qp, cache,
                                          slots, bt_rows, plens)
        return self._set_rows(cur, pos, slots,
                              self._sample_or_argmax(logits, temps, top_ps,
                                                     seeds,
                                                     torch.zeros_like(seeds)),
                              plens)

    @staticmethod
    def _sample_or_argmax(logits, temps, top_ps, seeds, offsets):
        """The ``CLOUD``-stream draw at output index ``offsets`` for
        sampled rows, the argmax of the same logits for greedy rows."""
        greedy = torch.argmax(logits, -1).to(torch.int32)
        p = S.filtered_probs(logits.to(torch.float32), temps, top_ps)
        draw = S.sample_rows(p, S.token_keys(seeds, offsets, S.CLOUD))
        return torch.where(temps > 0.0, draw, greedy)

    def _edge_decode(self, blocks, embed, cur, cache, pos, bt):
        cfg = self.cfg
        x = ML.embed(embed, cur[:, None]).to(cfg.dtype)
        h, _ = TF.run_blocks(blocks, x, cfg, rope=self._rope(), cache=cache,
                             cache_index=pos, qctx=self._edge_qctx,
                             block_tables=bt)
        # Eq.(1) per row: stale activations in idle slots must not set
        # the range of live requests' deltas
        return self._quant_boundary(h)                     # [B, 1, D]

    def _cloud_decode_logits(self, blocks, tail, blob, qp, cache, pos,
                             bt) -> torch.Tensor:
        cfg = self.cfg
        h = dequantize(blob, qp).to(cfg.dtype)              # Eq.(2)
        x, _ = TF.run_blocks(blocks, h, cfg, rope=self._rope(), cache=cache,
                             cache_index=pos, block_tables=bt)
        return TF.lm_head(tail, x)[:, 0]

    def _cloud_decode(self, blocks, tail, blob, qp, cache, pos, bt):
        logits = self._cloud_decode_logits(blocks, tail, blob, qp, cache,
                                           pos, bt)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        return nxt, torch.clamp(pos + 1, max=self.max_len - 1)

    def _cloud_decode_sample_impl(self, blocks, tail, blob, qp, cache, pos,
                                  bt, temps, top_ps, seeds, offsets):
        """Sampled serial (k = 1) decode: the committed token at absolute
        output index ``offsets[b]`` is a ``CLOUD``-stream draw — the
        reference distribution the speculative verify must match."""
        logits = self._cloud_decode_logits(blocks, tail, blob, qp, cache,
                                           pos, bt)
        nxt = self._sample_or_argmax(logits, temps, top_ps, seeds, offsets)
        return nxt, torch.clamp(pos + 1, max=self.max_len - 1)
