"""Collaborative (cloud-edge) LM serving — the paper's mode — in PyTorch.

Counterpart of ``repro.serve.engine.CollaborativeServingEngine`` at a
fixed cut.  The INT8 edge prefix
(the first ``cut_layer + 1`` blocks on the fake-quant lattice) and the
fp cloud suffix each own a paged KV cache covering only their block
sub-range, over **one shared block table**.  Each prefill ships the
prompt's per-row Eq.(1) boundary blob uplink; each decode step ships a
per-row-quantized ``[B, 1, D]`` boundary delta uplink and the token
downlink, charged to ``ServeStats`` byte for byte as the JAX engine
charges them.  ``spec_k = k > 1`` turns each decode step into a
speculative draft/verify round (``serve.spec``); ``spec_k=1`` is the
serial step, bit for bit, and ``spec_k="auto"`` takes the starting k from
``autotune.spec_k_for_lm``.  ``a_bits=None`` with fp pages on both sides
is the lossless configuration, whose greedy stream does not depend on
the cut.  ``mesh`` (``launch.mesh.make_serve_mesh``) runs the cloud
suffix, its head and its page pool tensor-parallel over the mesh's
``model`` shards (``serve.sharding``); the edge half runs once, on the
mesh's first device.  Wire bytes and ``ServeStats`` do not depend on the
mesh.  A request with ``SamplingParams(temperature > 0)`` is sampled
(``serve.sampling``): its prefill, serial steps and rounds run the
``*_sample`` phases, and a sampled round also ships the graded
positions' f32 draft distributions uplink; all-greedy traffic never
enters a sampled phase.

Options the slice does not run raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.core.autotune import spec_k_for_lm
from repro_torch.core.costmodel import Channel
from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import engine_device
from repro_torch.models import layers as ML
from repro_torch.models import transformer as TF
from repro_torch.serve.cloud import ServingEngine
from repro_torch.serve.kvcache import _PagedPool
from repro_torch.serve.phases import _SplitPhases
from repro_torch.serve.policy import _CutBank
from repro_torch.serve.scheduler import _SlotEngine
from repro_torch.serve.sharding import place_collab_engine
from repro_torch.serve.spec import _SpecDraftMixin
from repro_torch.serve.transport import (_MSG_BYTES, _QP_BYTES, _TOK_BYTES,
                                         Transport)

Params = Any

__all__ = ["ServingEngine", "CollaborativeServingEngine"]


def _unported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"CollaborativeServingEngine({option}) is not ported yet "
        f"(ROADMAP {item})")


class CollaborativeServingEngine(_SpecDraftMixin, _SplitPhases,
                                 _SlotEngine):
    """Paper mode with incremental decode over split, shared-table paged
    KV caches (see the module docstring) on ``device`` (default
    ``"cuda"``), its cloud half tensor-parallel over the shards of
    ``mesh`` when one is given (its first device is then the engine's
    device; ``data > 1`` raises, ROADMAP A16).  ``spec_k="auto"`` picks
    the starting k with the cost model at ``spec_acceptance``; the
    reference's self-correction of k from measured acceptance comes with
    the adaptive policy (ROADMAP A12)."""

    def __init__(self, params: Params, cfg: TF.LMConfig, *, cut_layer: int,
                 channel: Optional[Channel] = None, max_len: int = 128,
                 a_bits: Optional[int] = 8, max_batch: int = 4,
                 edge_paged: bool = True, edge_int8: bool = True,
                 cloud_paged: bool = True, cloud_int8: bool = True,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 spec_k: Union[int, str] = 1, spec_acceptance: float = 0.8,
                 policy=None, demand_paged: bool = False,
                 pressure=None, admission=None, mesh=None,
                 device: DeviceLike = None):
        for name, value, item in (("policy", policy, "A12"),
                                  ("demand_paged", demand_paged, "A12"),
                                  ("pressure", pressure, "A12"),
                                  ("admission", admission, "A12")):
            if value:
                raise _unported(f"{name}=...", item)
        if not (edge_paged and cloud_paged):
            raise _unported("edge_paged/cloud_paged=False", "A5")
        if not 0 <= cut_layer < cfg.n_layers:
            raise ValueError(
                f"cut_layer {cut_layer} outside [0, {cfg.n_layers})")
        dev = engine_device(mesh, device)
        super().__init__(cfg, max_batch=max_batch, max_len=max_len,
                         device=dev)
        self.transport = Transport(channel)
        if spec_k == "auto":
            spec_k = spec_k_for_lm(cfg, cut_layer, batch=max_batch,
                                   channel=self.transport.channel,
                                   acceptance=spec_acceptance)[0].k
        if not (isinstance(spec_k, int) and spec_k >= 1):
            raise ValueError(f"spec_k must be an int >= 1 or 'auto', got "
                             f"{spec_k!r}")
        # the draft length is fixed for the engine's life (online k
        # switches come with the adaptive policy, ROADMAP A12), so the
        # draft machinery and the pages' headroom are sized for it
        self.spec_k = spec_k
        self.a_bits = a_bits
        self.edge_int8 = edge_int8
        self.cloud_int8 = cloud_int8
        self.page_size = page_size
        self.mesh = mesh

        params = tree_map(lambda t: t.to(dev), params)
        self.embed = params["embed"]
        # the edge drafts with the whole head; the cloud's may be split
        self.tail = {"final_norm": params["final_norm"],
                     "lm_head": params["lm_head"]}
        self.cloud_tail = self.tail
        # act_axis=0: per-slot activation ranges — a shared-batch range
        # would couple each request's Eq.(1) lattice to its neighbours'
        # (and to stale values in idle slots)
        self._edge_qctx = None if a_bits is None else \
            ML.QuantCtx(a_bits=a_bits, quantize_weights=False, act_axis=0)
        deploy_qctx = None if a_bits is None else ML.QuantCtx(a_bits=a_bits)
        # one shared page pool / block table for both split caches
        self._pool = _PagedPool.build(max_batch, max_len, page_size,
                                      num_pages, dev)
        self._bank = _CutBank(params, cfg, {cut_layer}, deploy_qctx,
                              drafts=spec_k > 1)
        self._set_cut(cut_layer)
        # per-slot sampling state (serve.sampling): host mirrors of each
        # slot's (temperature, top_p, seed), refreshed at admission; the
        # device copies are cached until the slot mix changes
        self._samp_t = np.zeros((max_batch,), np.float32)
        self._samp_p = np.ones((max_batch,), np.float32)
        self._samp_s = np.zeros((max_batch,), np.int64)
        self._samp_dev: Optional[Tuple[torch.Tensor, ...]] = None

    def _set_cut(self, cut: int) -> None:
        """Partition at ``cut``: weights come out of the bank (views), the
        split caches are allocated for the two layer sub-ranges, and on a
        mesh the cloud half is placed on its shards."""
        cfg = self.cfg
        self.cut = cut
        self.n_edge = cut + 1
        self.n_cloud = cfg.n_layers - self.n_edge
        self.edge_blocks, self.cloud_blocks, self.draft_blocks = \
            self._bank.get(cut)
        n_pool = self._pool.allocator.num_pages
        self._edge_cache = TF.init_cache(
            cfg, self.max_batch, self.max_len, layers=self.n_edge,
            paged=True, quantized=self.edge_int8, page_size=self.page_size,
            num_pages=n_pool, device=self.device)
        self._cloud_cache = TF.init_cache(
            cfg, self.max_batch, self.max_len, layers=self.n_cloud,
            paged=True, quantized=self.cloud_int8, page_size=self.page_size,
            num_pages=n_pool, device=self.device)
        if self.spec_k > 1:
            # the edge's draft model: the bank's INT8 copy of the cloud
            # suffix, over a draft cache in the edge's layout that shares
            # the block table
            self._draft_cache = TF.init_cache(
                cfg, self.max_batch, self.max_len, layers=self.n_cloud,
                paged=True, quantized=self.edge_int8,
                page_size=self.page_size, num_pages=n_pool,
                device=self.device)
        place_collab_engine(self)

    def _round_headroom(self) -> int:
        return self.spec_k - 1

    def _round_width(self) -> int:
        return self.spec_k

    def _admit_reserve(self, max_news: np.ndarray) -> np.ndarray:
        """Positions past the prompt that admission reserves pages for:
        the whole generation budget plus the speculative overshoot, so a
        round's rejected tail never spills into another request's
        pages."""
        return max_news + self._round_headroom()

    # -- sampling plumbing (serve.sampling) ---------------------------------
    def _note_samplings(self, slots, samplings) -> None:
        """Refresh the per-slot sampling mirrors at admission (a greedy
        or ``None`` request zeroes its slot, so slot reuse never leaks a
        previous request's temperature)."""
        for i, s in enumerate(slots):
            sp = None if samplings is None else samplings[i]
            sp = sp if (sp is not None and sp.sampled) else None
            self._samp_t[s] = sp.temperature if sp else 0.0
            self._samp_p[s] = sp.top_p if sp else 1.0
            self._samp_s[s] = sp.seed if sp else 0
        self._samp_dev = None

    def _samp_vecs(self) -> Tuple[torch.Tensor, ...]:
        if self._samp_dev is None:
            self._samp_dev = tuple(torch.as_tensor(v, device=self.device)
                                   for v in (self._samp_t, self._samp_p,
                                             self._samp_s))
        return self._samp_dev

    def _offsets(self) -> torch.Tensor:
        """[max_batch] absolute output index each live slot's next round
        starts at: its committed count, exact on the host (the scheduler
        counts commits as rounds report them), so every sampled draw's
        key is pinned to (seed, index, stream)."""
        off = np.zeros((self.max_batch,), np.int64)
        for s, (_r, c) in self._sched_active.items():
            off[s] = c
        return torch.as_tensor(off, device=self.device)

    # -- scheduler hooks ----------------------------------------------------
    def _admit(self, toks, plens, max_news, slots, cur, pos, samplings=None):
        self._note_samplings(slots, samplings)
        bt_rows = self._pool.admit(slots, plens,
                                   self._admit_reserve(max_news),
                                   toks.shape[1])
        slots_d = torch.as_tensor(slots, device=self.device).long()
        plens_d = torch.as_tensor(plens, device=self.device)
        blob, qp = self._edge_prefill(self.edge_blocks, self.embed, toks,
                                      self._edge_cache, slots_d, bt_rows,
                                      plens_d)
        self.transport.account_blob(
            self.stats, blob, phase="prefill",
            row_elems=plens.astype(np.int64) * self.cfg.d_model)
        if (self._samp_t[slots] > 0).any():
            cur, pos = self._cloud_prefill_sample_impl(
                self.cloud_blocks, self.cloud_tail, blob, qp,
                self._cloud_cache, slots_d, bt_rows, cur, pos, plens_d,
                *(torch.as_tensor(v[slots], device=self.device)
                  for v in (self._samp_t, self._samp_p, self._samp_s)))
        else:
            cur, pos = self._cloud_prefill(self.cloud_blocks,
                                           self.cloud_tail, blob, qp,
                                           self._cloud_cache, slots_d,
                                           bt_rows, cur, pos, plens_d)
        if self.spec_k > 1:
            self._draft_prefill_impl(self.draft_blocks, blob, qp,
                                     self._draft_cache, slots_d, bt_rows,
                                     plens_d)
        self.transport.account_downlink(self.stats, toks.shape[0],
                                        phase="prefill")
        return cur, pos

    def _decode_all(self, cur, pos, n_active):
        return self._serial_step(cur, pos, n_active, self._cloud_decode)

    def _decode_all_sample(self, cur, pos, n_active):
        """Serial (k = 1) step with a sampled slot aboard: the same edge
        pass and wire bytes; the committed token is the ``CLOUD``-stream
        draw (greedy rows keep their argmax, bit for bit)."""
        samp = (*self._samp_vecs(), self._offsets())
        return self._serial_step(
            cur, pos, n_active,
            lambda *a: self._cloud_decode_sample_impl(*a, *samp))

    def _serial_step(self, cur, pos, n_active, cloud_step):
        bt = self._pool.table_dev()
        blob, qp = self._edge_decode(self.edge_blocks, self.embed, cur,
                                     self._edge_cache, pos, bt)
        self.transport.account_blob(self.stats, blob, phase="decode",
                                    rows=n_active)
        cur, pos = cloud_step(self.cloud_blocks, self.cloud_tail, blob, qp,
                              self._cloud_cache, pos, bt)
        self.transport.account_downlink(self.stats, n_active)
        return cur, pos

    def _round(self, cur, pos, slots):
        n_samp = int((self._samp_t[slots] > 0).sum())
        # k = 1 is the serial step, which never waits for the device
        if self.spec_k == 1:
            if not n_samp:
                return super()._round(cur, pos, slots)
            cur, pos = self._decode_all_sample(cur, pos, len(slots))
            return cur, pos, cur[:, None], None
        k, n_active = self.spec_k, len(slots)
        bt = self._pool.table_dev()
        args = (self.edge_blocks, self.draft_blocks, self.embed, self.tail,
                cur, self._edge_cache, self._draft_cache, pos, bt)
        if n_samp:
            samp = (*self._samp_vecs(), self._offsets())
            draft_fn, verify_fn = self._spec_sample_fns(k)
            blobs, scales, zps, drafts, qs = draft_fn(*args, *samp)
        else:
            draft_fn, verify_fn = self._spec_fns(k)
            blobs, scales, zps, drafts = draft_fn(*args)
        # one uplink message: k per-row-framed [1, D] deltas + the k-1
        # graded drafts, the header (and the RTT) paid once per round; a
        # sampled row also ships the k-1 graded positions' f32 draft
        # distributions the rejection test needs
        self.transport.charge(
            self.stats,
            n_active * (k * (self.cfg.d_model * blobs.element_size()
                             + _QP_BYTES) + (k - 1) * _TOK_BYTES)
            + _MSG_BYTES + n_samp * (k - 1) * self.cfg.vocab * 4,
            phase="decode")
        vargs = (self.cloud_blocks, self.cloud_tail, blobs, scales, zps,
                 drafts)
        if n_samp:
            toks, n_commit, cur, pos = verify_fn(
                *vargs, qs, self._cloud_cache, pos, bt, *samp)
        else:
            toks, n_commit, cur, pos = verify_fn(
                *vargs, self._cloud_cache, pos, bt)
        # the edge needs the accept counts to schedule the next round, so
        # this sync is part of the protocol, not a host-loop artifact
        counts = n_commit.cpu().numpy()
        self.transport.account_downlink(self.stats, n_active, k=k)
        self.stats.spec_rounds += 1
        hits = int(np.minimum(counts[slots] - 1, k - 1).sum())
        self.stats.drafted_tokens += (k - 1) * n_active
        self.stats.draft_hits += hits
        self.transport.telemetry.observe_round((k - 1) * n_active, hits)
        return cur, pos, toks, counts

    def _retire(self, slot):
        self._pool.retire(slot)

    def _can_admit(self, group_shapes, plen, max_new, bucket):
        shapes = [(p, int(self._admit_reserve(np.int64(m))))
                  for p, m in group_shapes + [(plen, max_new)]]
        return self._pool.can_admit(shapes, bucket)

    def edge_cache_bytes(self, *, live_only: bool = False) -> int:
        """Edge KV footprint; ``live_only`` counts allocated pages only."""
        if live_only:
            return self._pool.live_cache_bytes(self._edge_cache)
        return sum(v.numel() * v.element_size()
                   for v in self._edge_cache.values())
