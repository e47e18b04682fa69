"""Speculative draft/verify rounds of the collaborative engine (greedy).

Counterpart of the greedy half of ``repro.serve.spec._SpecDraftMixin``.
With ``spec_k = k > 1`` each decode step becomes a round:

1. **Draft (edge, local).**  From the last committed token the edge runs
   the whole split model k times at low precision: its INT8 prefix over
   the paged INT8 edge cache, then an INT8 copy of the cloud-suffix
   weights over a local *draft* cache that shares the block table.  Each
   step emits the per-row Eq.(1) boundary delta and greedily drafts the
   next token.
2. **Uplink (one message).**  The ``[B, k, D]`` blob, each row framed
   with its own scale / zero point, plus the k-1 graded drafts.
3. **Verify (cloud, one step).**  The cloud suffix runs all k positions
   in one multi-token cached step — ``paged_flash_mq`` at S = k — and
   commits the longest prefix of drafts that match its own greedy
   tokens plus the token at the first divergence: 1 to k tokens.
4. **Rollback.**  Rejected positions are not erased: the per-slot
   position only advances by the committed count; stale page entries
   stay masked by causality until overwritten.
5. **Downlink (one message).**  The accept mask and the corrected token.

The JAX reference jits one ``lax.scan`` per k; here the k draft steps
are a Python loop and every phase updates the paged caches in place.
The sampled twins (rejection-sampling verify) come with ROADMAP A11, the
edge-only degradation and resync phases with A12.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quant import dequantize
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.kvcache import _paged_prefill_merge, _paged_prefill_view
from repro_torch.serve.scheduler import _bucket_len

__all__ = ["_SpecDraftMixin"]


class _SpecDraftMixin:
    """Draft/verify phases, mixed into ``CollaborativeServingEngine``
    (which provides cfg, the caches, the boundary lattice
    ``_quant_boundary``, ``_pool`` and the scheduler hooks).  Every
    phase runs over the full slot axis; idle slots ride along on a
    zeroed block-table row, so their writes land in the dump page."""

    def _spec_fns(self, k: int):
        """(draft, verify) phases for draft length ``k``."""
        return (functools.partial(self._spec_draft_impl, k),
                functools.partial(self._verify_impl, k))

    def _draft_prefill_impl(self, blocks, blob, qp, cache, slots, bt_rows,
                            plens) -> None:
        """Fill the edge's draft cache: the INT8 suffix copy runs the same
        dequantized boundary blob the cloud saw, so the draft model starts
        every round from the committed prefix state."""
        cfg = self.cfg
        h = dequantize(blob, qp).to(cfg.dtype)              # Eq.(2), locally
        group = _paged_prefill_view(cache, h.shape[0])
        _, group = TF.run_blocks(blocks, h, cfg, rope=self._rope(),
                                 cache=group, cache_index=0,
                                 qctx=self._edge_qctx, block_tables=bt_rows,
                                 calibrate_kv=self.edge_int8,
                                 kv_lengths=plens)
        _paged_prefill_merge(cache, group, slots)

    def _spec_draft_impl(self, k, edge_blocks, draft_blocks, embed, tail,
                         cur, e_cache, d_cache, pos, bt
                         ) -> Tuple[torch.Tensor, ...]:
        """k local steps on the edge: INT8 prefix → Eq.(1) delta → INT8
        suffix copy → greedy draft token.  Returns the stacked ``[k, B,
        D]`` boundary blob with per-(position, row) scales and zero
        points ``[k, B]`` — the frames k serial steps would have shipped
        — and the k draft tokens ``[k, B]``."""
        cfg = self.cfg
        rope = self._rope()
        blobs, scales, zps, drafts = [], [], [], []
        tok, p = cur, pos
        for _ in range(k):
            x = ML.embed(embed, tok[:, None]).to(cfg.dtype)
            h, _ = TF.run_blocks(edge_blocks, x, cfg, rope=rope,
                                 cache=e_cache, cache_index=p,
                                 qctx=self._edge_qctx, block_tables=bt)
            blob, qp = self._quant_boundary(h)               # per row
            hq = dequantize(blob, qp).to(cfg.dtype)   # what the cloud sees
            y, _ = TF.run_blocks(draft_blocks, hq, cfg, rope=rope,
                                 cache=d_cache, cache_index=p,
                                 qctx=self._edge_qctx, block_tables=bt)
            logits = TF.lm_head(tail, y)[:, 0]
            tok = torch.argmax(logits, -1).to(torch.int32)
            p = torch.clamp(p + 1, max=self.max_len - 1)
            blobs.append(blob[:, 0])
            scales.append(qp.scale)
            zps.append(qp.zero_point)
            drafts.append(tok)
        return (torch.stack(blobs), torch.stack(scales), torch.stack(zps),
                torch.stack(drafts))

    def _verify_impl(self, k, blocks, tail, blobs, scales, zps, drafts,
                     cache, pos, bt) -> Tuple[torch.Tensor, ...]:
        """One multi-token cloud step over the k drafted positions with
        longest-prefix acceptance: the round commits the cloud's greedy
        tokens ``t_1..t_{j+1}`` where j is the number of leading drafts
        that match them, so every round commits at least one exact
        greedy token.  Returns ``(t [B, k], n_commit [B], new cur, new
        pos)``; rejected positions roll back by the position alone."""
        cfg = self.cfg
        # Eq.(2) per (position, row): the lattice the serial path ships
        h = (blobs.to(torch.float32) - zps[..., None]) * scales[..., None]
        h = h.transpose(0, 1).to(cfg.dtype)                  # [B, k, D]
        x, _ = TF.run_blocks(blocks, h, cfg, rope=self._rope(),
                             cache=cache, cache_index=pos, block_tables=bt)
        logits = TF.lm_head(tail, x)                          # [B, k, V]
        t = torch.argmax(logits, -1).to(torch.int32)          # [B, k]
        d = drafts.transpose(0, 1)                            # [B, k]
        ok = (d[:, :k - 1] == t[:, :k - 1]).to(torch.int32)
        n_commit = 1 + torch.cumprod(ok, dim=1).sum(dim=1)    # [B]
        new_cur = torch.gather(t, 1, (n_commit - 1)[:, None].long())[:, 0]
        new_pos = torch.clamp(pos + n_commit, max=self.max_len - 1)
        return t, n_commit.to(torch.int32), new_cur, new_pos.to(torch.int32)

    def _draft_rebuild_impl(self, edge_blocks, draft_blocks, embed, toks,
                            d_cache, slots, bt_rows, plens) -> None:
        """Recompute the draft suffix K/V of live slots from committed
        prefix state: re-run the committed rows through the edge prefix
        over a throwaway scratch cache (the real edge cache already holds
        these positions and must not be touched), then replay the
        boundary blob through the draft suffix like a draft prefill.
        The reference's scratch is a dense cache; the port's is a paged
        one with its own identity block table (an INT8 scratch calibrates
        its scales from the rows).  Draft contents only steer the
        acceptance rate, never the committed stream."""
        cfg = self.cfg
        n, s = toks.shape
        per = -(-s // self.page_size)
        scratch = TF.init_cache(cfg, n, s, layers=self.n_edge, paged=True,
                                quantized=self.edge_int8,
                                page_size=self.page_size,
                                num_pages=n * per + 1, device=self.device)
        sbt = torch.arange(1, n * per + 1, dtype=torch.int32,
                           device=self.device).reshape(n, per)
        x = ML.embed(embed, toks).to(cfg.dtype)
        h, _ = TF.run_blocks(edge_blocks, x, cfg, rope=self._rope(),
                             cache=scratch, cache_index=0,
                             qctx=self._edge_qctx, block_tables=sbt,
                             calibrate_kv=self.edge_int8, kv_lengths=plens)
        real = (torch.arange(s, device=h.device)[None, :, None]
                < plens[:, None, None])
        blob, qp = self._quant_boundary(h, torch.where(real, h, h[:, :1]))
        self._draft_prefill_impl(draft_blocks, blob, qp, d_cache, slots,
                                 bt_rows, plens)

    def _rebuild_draft_caches(self) -> None:
        """Rebuild the draft K/V of every live slot from its committed
        prefix (prompt + committed tokens minus the not-yet-processed
        last one), bucketing rows like admission — what a warm raise out
        of k = 1 needs, since k = 1 rounds never fill the draft cache."""
        live = self._sched_active
        if not live:
            return
        slots = sorted(live)
        rows = []
        for s in slots:
            r, _c = live[s]
            committed = self._sched_committed(r)
            rows.append(np.concatenate([np.asarray(r.prompt, np.int32),
                                        committed[:-1].astype(np.int32)]))
        order = sorted(range(len(slots)), key=lambda i: len(rows[i]))
        i = 0
        while i < len(order):
            bucket = _bucket_len(len(rows[order[i]]), self.max_len)
            grp = [order[i]]
            i += 1
            while i < len(order) and _bucket_len(
                    len(rows[order[i]]), self.max_len) == bucket:
                grp.append(order[i])
                i += 1
            toks = np.zeros((len(grp), bucket), np.int32)
            for j, g in enumerate(grp):
                toks[j, :len(rows[g])] = rows[g]
            plens = np.asarray([len(rows[g]) for g in grp], np.int32)
            gslots = np.asarray([slots[g] for g in grp], np.int32)
            self._draft_rebuild_impl(
                self.edge_blocks, self.draft_blocks, self.embed,
                torch.tensor(toks, device=self.device), self._draft_cache,
                torch.tensor(gslots, device=self.device).long(),
                self._pool.rows(gslots, bucket),
                torch.tensor(plens, device=self.device))
        self.stats.draft_rebuilds += 1
