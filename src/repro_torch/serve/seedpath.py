"""Seed (cache-less) recompute path of the collaborative engine.

Counterpart of ``repro.serve.seedpath._SeedPathMixin``.  ``forward`` and
``generate_recompute`` run the whole split stack on the full, growing
sequence at every step — the baseline the incremental cached path is
held against: no KV cache on either side, O(S²·L) work per token, and
the whole boundary blob sent again at every step.  The blob is one
per-tensor Eq.(1) lattice over the batch and the sequence (no ``axis``),
and the wire is charged as raw totals (payload, one scale/zero-point
frame and one message header per step; no prefill/decode split), as
the reference charges it.  Mixed into ``CollaborativeServingEngine``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.quant import compute_qparams, dequantize, quantize
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.transport import _MSG_BYTES, _QP_BYTES

__all__ = ["_SeedPathMixin"]


class _SeedPathMixin:
    """The cache-less split forward and the greedy recompute decode,
    mixed into ``CollaborativeServingEngine`` (which provides cfg, the
    edge and cloud blocks, ``a_bits``, ``_edge_qctx``, the transport and
    the stats)."""

    def _edge_impl(self, blocks, embed, tokens: torch.Tensor
                   ) -> torch.Tensor:
        cfg = self.cfg
        x = ML.embed(embed, tokens).to(cfg.dtype)
        rope = ML.rope_table(tokens.shape[1], cfg.hd, base=cfg.rope_base,
                             dtype=cfg.dtype, device=tokens.device)
        x, _ = TF.run_blocks(blocks, x, cfg, rope=rope,
                             qctx=self._edge_qctx)
        return x

    def _cloud_impl(self, blocks, tail, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        rope = ML.rope_table(h.shape[1], cfg.hd, base=cfg.rope_base,
                             dtype=cfg.dtype, device=h.device)
        h, _ = TF.run_blocks(blocks, h, cfg, rope=rope)
        return TF.lm_head(tail, h)

    def forward(self, tokens: np.ndarray) -> torch.Tensor:
        """Mixed-precision collaborative forward → logits [B, S, V]
        (cache-less: the whole split stack over the whole sequence)."""
        toks = torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)
        h = self._edge_impl(self.edge_blocks, self.embed, toks)
        if self.a_bits is None:
            blob = h.to(torch.float32)
        else:
            # Eq.(1) over the whole blob, then Eq.(2) on the cloud
            qp = compute_qparams(h, bits=self.a_bits)
            blob = quantize(h, qp)
            h = dequantize(blob, qp).to(self.cfg.dtype)
        # raw total bytes (no phase split: the seed path predates it)
        nbytes = blob.numel() * blob.element_size() + _QP_BYTES + _MSG_BYTES
        t = self.transport.channel.transfer_time(nbytes)
        self.telemetry.observe_transfer(nbytes, t)
        self.stats.transmitted_bytes += int(nbytes)
        self.stats.channel_latency_s += t
        return self._cloud_impl(self.cloud_blocks, self.cloud_tail,
                                h.to(self.cfg.dtype))

    def generate_recompute(self, prompts: List[np.ndarray], *,
                           max_new_tokens: int = 8) -> List[List[int]]:
        """Seed greedy decode: the split forward on the full, growing
        sequence at every step (prompts of one length, as the
        reference's ``np.stack`` needs); ``stats.decode_steps`` counts
        the steps."""
        toks = np.stack(prompts).astype(np.int32)
        out: List[List[int]] = [[] for _ in prompts]
        for _ in range(max_new_tokens):
            logits = self.forward(toks)
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for j, t in enumerate(nxt):
                out[j].append(int(t))
            toks = np.concatenate([toks, nxt[:, None].astype(np.int32)], 1)
            self.stats.decode_steps += 1
        return out
