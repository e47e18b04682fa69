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

Rounds carrying a temperature > 0 slot run the ``*_sample`` twins: the
draft proposes seeded categorical draws from its filtered distribution
``q`` and ships the graded positions' ``q`` rows beside the blob (priced
as extra uplink by the engine), and the verify grades by **rejection
sampling** (``serve.sampling.grade_and_correct``) instead of argmax
match, keeping the cloud's sampling distribution exact while greedy
rows in the same batch commit the greedy verify's tokens.

The draft length may change between rounds (the adaptive policy): the
draft cache and every slot's page headroom are sized once for the
largest k any controller may pick, and a raise out of k = 1 with live
slots rebuilds their draft K/V from committed state
(``_rebuild_draft_caches``).

Every draft, verify and prefill phase runs over either cache layout
(``edge_paged`` / ``cloud_paged``): over a dense cache a verify block's
positions past ``max_len`` (an idle slot's stale position) are dropped,
as JAX's scatter drops them (``models.layers._write_dense``).

The mixin also hosts the **degradation** phases of the resilient engine
(``serve.resilience``), the draft machinery with the verify removed:
while the cloud is unreachable the edge's INT8 suffix copy stops
drafting and serves.  ``_edge_only_step_impl`` is one whole local step
(prefix, boundary, suffix, token; no wire bytes), and
``_edge_only_prefill_impl`` admits a request on the edge alone; their
sampled twins draw from the ``CLOUD`` stream with the key the cloud's
serial step would use.  On reconnect the two ``_resync_*`` phases replay
the buffered boundary rows through the cloud suffix (the verify's
q-block form, ungraded) to rebuild its paged KV: from each slot's own
resume position, or from position 0 with calibration for a slot
admitted during the outage.  ``phase_calls["edge_only"]`` and
``["resync"]`` count their calls.  These run on the paged layouts only,
as the resilient engine does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quant import dequantize
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve import sampling as S
from repro_torch.serve.scheduler import _bucket_len

__all__ = ["_SpecDraftMixin"]


class _SpecDraftMixin:
    """Draft/verify phases, mixed into ``CollaborativeServingEngine``
    (which provides cfg, the caches, the boundary lattice
    ``_quant_boundary``, ``_pool`` and the scheduler hooks).  Every
    phase runs over the full slot axis; idle slots ride along on a
    zeroed block-table row, so their writes land in the dump page."""

    def _spec_fns(self, k: int):
        """(draft, verify) phases for draft length ``k``.  Nothing is
        compiled per k here (the reference jits one pair per k), so the
        pair is made per round; each looks its phase method up when
        called, so a wrapper installed on the engine (a profiler's, a
        test's) sees every call, and the engine holds no reference to
        itself (a freed engine's weights go at once)."""
        return (lambda *a: self._spec_draft_impl(k, *a),
                lambda *a: self._verify_impl(k, *a))

    def _spec_sample_fns(self, k: int):
        """Sampled twin of ``_spec_fns``: the (draft, rejection-sampling
        verify) pair for rounds carrying at least one temperature > 0
        slot.  Greedy rows ride along on the argmax branch."""
        return (lambda *a: self._spec_draft_sample_impl(k, *a),
                lambda *a: self._verify_sample_impl(k, *a))

    def _draft_prefill_impl(self, blocks, blob, qp, cache, slots, bt_rows,
                            plens) -> torch.Tensor:
        """Fill the edge's draft cache: the INT8 suffix copy runs the same
        dequantized boundary blob the cloud saw, so the draft model starts
        every round from the committed prefix state.  Returns the suffix's
        output rows (the edge-only admission reads its logits off them)."""
        h = dequantize(blob, qp).to(self.cfg.dtype)        # Eq.(2), locally
        return self._prefill_blocks(blocks, h, cache, slots, bt_rows, plens,
                                    paged=self.edge_paged,
                                    int8=self.edge_int8, layers=self.n_cloud,
                                    qctx=self._edge_qctx)

    def _draft_steps(self, k, edge_blocks, draft_blocks, embed, tail, cur,
                     e_cache, d_cache, pos, bt, pick
                     ) -> Tuple[torch.Tensor, ...]:
        """k local steps on the edge: INT8 prefix → Eq.(1) delta → INT8
        suffix copy → ``pick(i, logits)``, the token drafted at step i.
        Returns the stacked ``[k, B, D]`` boundary blob with
        per-(position, row) scales and zero points ``[k, B]`` — the frames
        k serial steps would have shipped — and the k draft tokens
        ``[k, B]``."""
        cfg = self.cfg
        rope = self._rope()
        blobs, scales, zps, drafts = [], [], [], []
        tok, p = cur, pos
        for i in range(k):
            x = ML.embed(embed, tok[:, None]).to(cfg.dtype)
            h, _ = TF.run_blocks(edge_blocks, x, cfg, rope=rope,
                                 cache=e_cache, cache_index=p,
                                 qctx=self._edge_qctx, block_tables=bt)
            blob, qp = self._quant_boundary(h)               # per row
            hq = dequantize(blob, qp).to(cfg.dtype)   # what the cloud sees
            y, _ = TF.run_blocks(draft_blocks, hq, cfg, rope=rope,
                                 cache=d_cache, cache_index=p,
                                 qctx=self._edge_qctx, block_tables=bt)
            tok = pick(i, TF.lm_head(tail, y)[:, 0])
            p = torch.clamp(p + 1, max=self.max_len - 1)
            blobs.append(blob[:, 0])
            scales.append(qp.scale)
            zps.append(qp.zero_point)
            drafts.append(tok)
        return (torch.stack(blobs), torch.stack(scales), torch.stack(zps),
                torch.stack(drafts))

    def _spec_draft_impl(self, k, edge_blocks, draft_blocks, embed, tail,
                         cur, e_cache, d_cache, pos, bt
                         ) -> Tuple[torch.Tensor, ...]:
        """The greedy draft: each step drafts the argmax."""
        return self._draft_steps(
            k, edge_blocks, draft_blocks, embed, tail, cur, e_cache, d_cache,
            pos, bt, lambda i, logits: torch.argmax(logits, -1).to(
                torch.int32))

    def _spec_draft_sample_impl(self, k, edge_blocks, draft_blocks, embed,
                                tail, cur, e_cache, d_cache, pos, bt, temps,
                                top_ps, seeds, offsets
                                ) -> Tuple[torch.Tensor, ...]:
        """The sampled draft: step i proposes a ``DRAFT``-stream draw from
        the local suffix's filtered distribution ``q`` at absolute output
        index ``offsets + i`` (greedy rows keep the argmax of the same
        logits).  Returns ``_draft_steps``' tensors and the stacked
        ``[k, B, V]`` f32 ``q`` rows the verify grades against."""
        qs = []

        def pick(i, logits):
            greedy = torch.argmax(logits, -1).to(torch.int32)
            q = S.filtered_probs(logits.to(torch.float32), temps, top_ps)
            qs.append(q)
            draw = S.sample_rows(q, S.token_keys(seeds, offsets + i,
                                                 S.DRAFT))
            return torch.where(temps > 0.0, draw, greedy)

        out = self._draft_steps(k, edge_blocks, draft_blocks, embed, tail,
                                cur, e_cache, d_cache, pos, bt, pick)
        return (*out, torch.stack(qs))

    def _verify_logits(self, blocks, tail, blobs, scales, zps, cache, pos,
                       bt) -> torch.Tensor:
        """One multi-token cloud step over the k drafted positions
        (``paged_flash_mq`` at S = k): the ``[B, k, V]`` logits."""
        cfg = self.cfg
        # Eq.(2) per (position, row): the lattice the serial path ships
        h = (blobs.to(torch.float32) - zps[..., None]) * scales[..., None]
        h = h.transpose(0, 1).to(cfg.dtype)                  # [B, k, D]
        x, _ = TF.run_blocks(blocks, h, cfg, rope=self._rope(),
                             cache=cache, cache_index=pos, block_tables=bt)
        return TF.lm_head(tail, x)

    def _commit(self, toks, n_commit, pos) -> Tuple[torch.Tensor, ...]:
        """``(toks, n_commit, new cur, new pos)`` of a graded round:
        rejected positions roll back by the position alone."""
        new_cur = torch.gather(toks, 1, (n_commit - 1)[:, None].long())[:, 0]
        new_pos = torch.clamp(pos + n_commit, max=self.max_len - 1)
        return (toks, n_commit.to(torch.int32), new_cur,
                new_pos.to(torch.int32))

    def _verify_impl(self, k, blocks, tail, blobs, scales, zps, drafts,
                     cache, pos, bt) -> Tuple[torch.Tensor, ...]:
        """Longest-prefix acceptance: the round commits the cloud's greedy
        tokens ``t_1..t_{j+1}`` where j is the number of leading drafts
        that match them, so every round commits at least one exact
        greedy token.  Returns ``(t [B, k], n_commit [B], new cur, new
        pos)``."""
        logits = self._verify_logits(blocks, tail, blobs, scales, zps,
                                     cache, pos, bt)          # [B, k, V]
        t = torch.argmax(logits, -1).to(torch.int32)          # [B, k]
        d = drafts.transpose(0, 1)                            # [B, k]
        ok = (d[:, :k - 1] == t[:, :k - 1]).to(torch.int32)
        n_commit = 1 + torch.cumprod(ok, dim=1).sum(dim=1)    # [B]
        return self._commit(t, n_commit, pos)

    def _verify_sample_impl(self, k, blocks, tail, blobs, scales, zps,
                            drafts, qs, cache, pos, bt, temps, top_ps, seeds,
                            offsets) -> Tuple[torch.Tensor, ...]:
        """Rejection-sampling verify: the same multi-token cloud step,
        graded by ``sampling.grade_and_correct`` — sampled rows accept
        draft i with probability ``min(1, p_i(d) / q_i(d))`` and correct
        from the normalized residual (or the bonus draw from ``p``),
        greedy rows grade by argmax match and commit the greedy verify's
        tokens.  Returns what ``_verify_impl`` returns."""
        logits = self._verify_logits(blocks, tail, blobs, scales, zps,
                                     cache, pos, bt)          # [B, k, V]
        t = torch.argmax(logits, -1).to(torch.int32)          # [B, k]
        B, _, V = logits.shape
        p = S.filtered_probs(logits.to(torch.float32).reshape(B * k, V),
                             torch.repeat_interleave(temps, k),
                             torch.repeat_interleave(top_ps, k)
                             ).reshape(B, k, V)
        toks, n_commit = S.grade_and_correct(
            p, qs.transpose(0, 1), drafts.transpose(0, 1), temps > 0.0, t,
            seeds, offsets)
        return self._commit(toks, n_commit, pos)

    def _draft_rebuild_impl(self, edge_blocks, draft_blocks, embed, toks,
                            d_cache, slots, bt_rows, plens) -> None:
        """Recompute the draft suffix K/V of live slots from committed
        prefix state: re-run the committed rows through the edge prefix
        over a throwaway dense scratch cache (the real edge cache already
        holds these positions and must not be touched; the reference's
        scratch is dense too, INT8 at its fixed scales for an INT8 edge),
        then replay the boundary blob through the draft suffix like a
        draft prefill.  Draft contents only steer the acceptance rate,
        never the committed stream."""
        cfg = self.cfg
        n, s = toks.shape
        x = ML.embed(embed, toks).to(cfg.dtype)
        scratch = TF.init_cache(cfg, n, self.max_len, layers=self.n_edge,
                                quantized=self.edge_int8, device=self.device)
        h, _ = TF.run_blocks(edge_blocks, x, cfg, rope=self._rope(),
                             cache=scratch, cache_index=0,
                             qctx=self._edge_qctx)
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
                None if self._pool is None
                else self._pool.rows(gslots, bucket),
                torch.tensor(plens, device=self.device))
        self.stats.draft_rebuilds += 1

    # -- degradation phases (serve.resilience) ------------------------------
    def _edge_only_logits(self, edge_blocks, draft_blocks, embed, tail, cur,
                          e_cache, d_cache, pos, bt
                          ) -> Tuple[torch.Tensor, ...]:
        """One whole local step up to the logits: INT8 prefix → Eq.(1)
        boundary → INT8 suffix copy — one ``_draft_steps`` iteration, which
        is what makes edge-only tokens the cloud's in the lossless mode.
        Returns the ``(blob, qp)`` frame (a round that loses its uplink
        commits the step without re-running it), the dequantized f32
        boundary row ``[B, D]`` the resync replays, and the logits."""
        self.phase_calls["edge_only"] += 1
        cfg = self.cfg
        rope = self._rope()
        x = ML.embed(embed, cur[:, None]).to(cfg.dtype)
        h, _ = TF.run_blocks(edge_blocks, x, cfg, rope=rope, cache=e_cache,
                             cache_index=pos, qctx=self._edge_qctx,
                             block_tables=bt)
        blob, qp = self._quant_boundary(h)
        hq = dequantize(blob, qp)                 # Eq.(2): the cloud's view
        y, _ = TF.run_blocks(draft_blocks, hq.to(cfg.dtype), cfg, rope=rope,
                             cache=d_cache, cache_index=pos,
                             qctx=self._edge_qctx, block_tables=bt)
        return (blob, qp, hq[:, 0].to(torch.float32),
                TF.lm_head(tail, y)[:, 0])

    def _edge_only_step_impl(self, edge_blocks, draft_blocks, embed, tail,
                             cur, e_cache, d_cache, pos, bt
                             ) -> Tuple[torch.Tensor, ...]:
        """One greedy local step: ``(blob, qp, f32 boundary row, token,
        new pos)``."""
        blob, qp, hq, logits = self._edge_only_logits(
            edge_blocks, draft_blocks, embed, tail, cur, e_cache, d_cache,
            pos, bt)
        return (blob, qp, hq, torch.argmax(logits, -1).to(torch.int32),
                torch.clamp(pos + 1, max=self.max_len - 1))

    def _edge_only_step_sample_impl(self, edge_blocks, draft_blocks, embed,
                                    tail, cur, e_cache, d_cache, pos, bt,
                                    temps, top_ps, seeds, offsets
                                    ) -> Tuple[torch.Tensor, ...]:
        """Sampled local step: the committed token is the ``CLOUD``-stream
        draw at output index ``offsets`` from the suffix copy's filtered
        distribution, the key the cloud's serial step would use, so a
        lossless edge-only stream is the cloud's sampled stream bit for
        bit.  Returns what ``_edge_only_step_impl`` returns."""
        blob, qp, hq, logits = self._edge_only_logits(
            edge_blocks, draft_blocks, embed, tail, cur, e_cache, d_cache,
            pos, bt)
        return (blob, qp, hq,
                self._sample_or_argmax(logits, temps, top_ps, seeds,
                                       offsets),
                torch.clamp(pos + 1, max=self.max_len - 1))

    def _edge_only_prefill_logits(self, blocks, tail, blob, qp, cache, slots,
                                  bt_rows, plens) -> torch.Tensor:
        """Admission with the cloud down: the suffix copy plays the
        cloud's part (a draft prefill of the same blob), and the local
        head gives the last prompt position's logits."""
        y = self._draft_prefill_impl(blocks, blob, qp, cache, slots, bt_rows,
                                     plens)
        last = y[torch.arange(y.shape[0], device=y.device),
                 (plens - 1).long()]
        return TF.lm_head(tail, last[:, None])[:, 0]

    def _edge_only_prefill_impl(self, blocks, tail, blob, qp, cache, slots,
                                bt_rows, plens, cur, pos
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy edge-only admission: the slots' first tokens and
        positions, with no wire bytes."""
        logits = self._edge_only_prefill_logits(blocks, tail, blob, qp, cache,
                                                slots, bt_rows, plens)
        return self._set_rows(cur, pos, slots,
                              torch.argmax(logits, -1).to(torch.int32), plens)

    def _edge_only_prefill_sample_impl(self, blocks, tail, blob, qp, cache,
                                       slots, bt_rows, plens, cur, pos,
                                       temps, top_ps, seeds
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sampled edge-only admission: the first token (output index 0)
        is the ``CLOUD``-stream draw the cloud's sampled prefill would
        commit; ``temps``/``top_ps``/``seeds`` are aligned with
        ``slots``."""
        logits = self._edge_only_prefill_logits(blocks, tail, blob, qp, cache,
                                                slots, bt_rows, plens)
        return self._set_rows(cur, pos, slots,
                              self._sample_or_argmax(logits, temps, top_ps,
                                                     seeds,
                                                     torch.zeros_like(seeds)),
                              plens)

    def _resync_replay_impl(self, blocks, h, cache, pos, bt) -> None:
        """Rebuild the cloud suffix KV of slots that were live before the
        outage: one multi-token cached step over the ``[B, R, D]``
        buffered boundary rows at each slot's own resume position (a
        vector ``cache_index``, the verify's q-block form).  Rows outside
        the replay group ride along at position 0 on a zeroed table row,
        so their writes land in the dump page."""
        self.phase_calls["resync"] += 1
        TF.run_blocks(blocks, h.to(self.cfg.dtype), self.cfg,
                      rope=self._rope(), cache=cache, cache_index=pos,
                      block_tables=bt)

    def _resync_prefill_impl(self, blocks, h, cache, slots, bt_rows,
                             lens) -> None:
        """Rebuild the cloud suffix KV of slots admitted *during* the
        outage: prefill-style from position 0, calibrating the per-slot
        INT8 scales the cloud never computed (every buffered row is a
        real token, so ``lens`` spans them all)."""
        self.phase_calls["resync"] += 1
        self._prefill_blocks(blocks, h.to(self.cfg.dtype), cache, slots,
                             bt_rows, lens, paged=True, int8=self.cloud_int8,
                             layers=self.n_cloud)
