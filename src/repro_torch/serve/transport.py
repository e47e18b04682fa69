"""Channel framing, wire accounting, and link telemetry for serving.

Counterpart of ``repro.serve.transport``, whole: ``Transport``,
``LinkTelemetry`` (bandwidth, RTT, draft acceptance and the loss rate
the lossy-link pricing reads), ``DriftingChannel``, a channel whose
conditions follow a schedule over simulated time, the message
``checksum``, and ``ReliableTransport``: sequence numbers, deadlines
from the telemetry, seeded backoff and bounded retries, escalating to
``CloudUnreachable`` (the resilient engine's cue, ``serve.resilience``).
Host code throughout: for the same channel and seed its counters and
simulated seconds equal the reference's exactly.  The framing
constants come from ``core.costmodel`` so the engine's accounting and
the cost model's predictions cannot drift apart, and every byte charged
equals the JAX engine's: ``transmitted_bytes`` is the total over the
wire — prefill and decode uplinks plus every cloud→edge downlink, each
message carrying its ``_MSG_BYTES`` header; prefill uplinks are charged
by each request's *true* prompt length (bucket padding never crosses
the wire); ``decode_tokens`` counts committed tokens.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import (Channel, MSG_BYTES, QP_BYTES,
                                        TOK_BYTES)
from repro_torch.serve.stats import ServeStats

__all__ = ["ServeStats", "Transport", "LinkTelemetry", "DriftingChannel",
           "ReliableTransport", "CloudUnreachable", "checksum",
           "_MSG_BYTES", "_QP_BYTES", "_TOK_BYTES"]

# wire framing overhead for one quantized blob: f32 scale + f32 zero-point
_QP_BYTES = int(QP_BYTES)
# wire bytes for one token id (cloud→edge return / edge→cloud draft)
_TOK_BYTES = int(TOK_BYTES)
# per-*message* protocol framing, paid once per channel traversal
_MSG_BYTES = int(MSG_BYTES)


class LinkTelemetry:
    """Online estimates of the link and the draft quality, from the
    traffic the engine sends anyway.

    Every charged message is an ``(nbytes, seconds)`` sample of
    ``seconds = nbytes / bandwidth + rtt`` — a line in ``nbytes`` — so
    an exponentially-weighted least-squares fit over the message stream
    recovers ``1/bandwidth`` (slope) and ``rtt`` (intercept).  Message
    sizes naturally span two orders of magnitude (prefill blobs vs
    per-round deltas vs 4 B token returns), which is what makes the
    regression well-conditioned; when recent traffic degenerates to one
    size the last well-conditioned estimate is held.  EWMA weighting
    makes the estimate track channel drift with a ~``1/alpha``-message
    memory.

    Draft/verify rounds contribute ``(graded, hits)`` samples giving an
    EWMA draft acceptance rate for ``autotune.tune_spec_k``, and every
    delivery attempt a sender reports contributes a delivered/lost
    sample giving an EWMA ``loss_rate`` — the expected-retransmit
    multiplier ``costmodel`` prices lossy links with.
    """

    # no physical last hop beats ~1 TB/s: a degenerate sample pair can
    # otherwise drive the fitted slope to ~0 and the bandwidth estimate
    # to absurdity (see observe_transfer's guard)
    BW_CEILING_BYTES_PER_S = 1e12

    def __init__(self, alpha: float = 0.25, min_samples: int = 4):
        self.alpha = alpha
        self.min_samples = min_samples
        self.n_samples = 0
        self.n_rounds = 0
        self._mx = self._my = self._mxx = self._mxy = 0.0
        self._bw: Optional[float] = None
        self._rtt: Optional[float] = None
        self._acc: Optional[float] = None
        self._loss: Optional[float] = None

    # -- observations -------------------------------------------------------
    def observe_transfer(self, nbytes: float, seconds: float) -> None:
        x, y = float(nbytes), float(seconds)
        # zero-duration samples carry no line information (the idealized
        # infinite channel) and, mixed with real samples, can drag the
        # fitted slope through zero — absurd bandwidth estimates
        if x <= 0 or y <= 0:
            return
        if self.n_samples == 0:
            self._mx, self._my = x, y
            self._mxx, self._mxy = x * x, x * y
        else:
            a = self.alpha
            self._mx += a * (x - self._mx)
            self._my += a * (y - self._my)
            self._mxx += a * (x * x - self._mxx)
            self._mxy += a * (x * y - self._mxy)
        self.n_samples += 1
        var = self._mxx - self._mx * self._mx
        cov = self._mxy - self._mx * self._my
        # refresh the held estimate only while the fit is well-conditioned
        if self.n_samples >= self.min_samples \
                and var > 1e-9 * max(self._mx * self._mx, 1.0) and cov > 0:
            slope = cov / var                       # seconds per byte
            self._bw = min(1.0 / slope, self.BW_CEILING_BYTES_PER_S)
            self._rtt = max(0.0, self._my - slope * self._mx)

    def observe_round(self, graded: int, hits: int) -> None:
        """One verify round's ``(graded drafts, accepted drafts)``.  A
        round that graded drafts and accepted none is a first-class
        ``r = 0.0`` sample; only ``graded <= 0`` (a serial step, which
        grades nothing) is skipped."""
        if graded <= 0:
            return
        r = min(max(hits, 0), graded) / graded
        self._acc = r if self._acc is None \
            else self._acc + self.alpha * (r - self._acc)
        self.n_rounds += 1

    def observe_delivery(self, delivered: bool) -> None:
        """One send attempt's outcome: EWMA of the loss indicator."""
        x = 0.0 if delivered else 1.0
        self._loss = x if self._loss is None \
            else self._loss + self.alpha * (x - self._loss)

    # -- estimates ----------------------------------------------------------
    @property
    def bandwidth_bytes_per_s(self) -> Optional[float]:
        return self._bw

    @property
    def rtt_s(self) -> Optional[float]:
        return self._rtt

    @property
    def loss_rate(self) -> float:
        return 0.0 if self._loss is None else self._loss

    def acceptance(self, prior: float = 0.8) -> float:
        return prior if self._acc is None else self._acc

    def channel(self, fallback: Channel) -> Channel:
        """The estimated channel, or ``fallback`` until the regression
        has locked on.  Carries the measured ``loss_rate`` either way,
        so the policy prices retransmissions even before the bandwidth
        fit converges."""
        if self._bw is None:
            return fallback if self._loss is None else dataclasses.replace(
                fallback, loss_rate=self.loss_rate)
        return Channel(bandwidth_bytes_per_s=self._bw,
                       rtt_s=self._rtt or 0.0, loss_rate=self.loss_rate,
                       name="telemetry")


class DriftingChannel:
    """A channel whose conditions follow a schedule over *simulated*
    time (the cumulative transfer time it has charged, plus waits), e.g.
    ::

        DriftingChannel([(0.0, Channel.from_kbps(2000, rtt_ms=20)),
                         (5.0, Channel.from_kbps(200, rtt_ms=150))])

    Duck-types ``costmodel.Channel`` (``transfer_time``), so engines and
    telemetry are oblivious; it drives the online re-tuning loop through
    a bandwidth/RTT swing."""

    def __init__(self, schedule: Sequence[Tuple[float, Channel]]):
        if not schedule or schedule[0][0] != 0.0:
            raise ValueError("schedule must start at simulated time 0")
        self.schedule = list(schedule)
        self.clock_s = 0.0

    @property
    def phase(self) -> Channel:
        """The conditions at the current simulated time."""
        cur = self.schedule[0][1]
        for t0, ch in self.schedule:
            if self.clock_s >= t0:
                cur = ch
        return cur

    @property
    def name(self) -> str:
        return f"drift[{self.phase.name}]"

    def transfer_time(self, nbytes: float) -> float:
        t = self.phase.transfer_time(nbytes)
        self.clock_s += t
        return t

    def wait(self, seconds: float) -> None:
        """Sender-side time passing (scheduler stalls, arrival gaps) —
        advances the schedule clock, as ``faults.FaultyChannel.wait``
        does."""
        self.clock_s += max(0.0, float(seconds))


class Transport:
    """The collaborative engine's side of the wire: owns the channel and
    the telemetry, charges every message to a ``ServeStats``.

    ``stats`` is passed per call (not owned) so callers can swap in a
    fresh ``ServeStats`` between measurement windows without severing
    the telemetry, which deliberately accumulates across windows — it is
    an estimate of the *link*, not of any one run."""

    def __init__(self, channel: Optional[Channel] = None,
                 telemetry: Optional[LinkTelemetry] = None):
        self.channel = channel or Channel(bandwidth_bytes_per_s=float("inf"))
        self.telemetry = telemetry or LinkTelemetry()

    def _transfer(self, stats: ServeStats, nbytes: int) -> float:
        """Move one message across the channel; returns the seconds the
        sender spent on it.  Every ``charge``/``account_*`` path goes
        through here, so a reliable transport is a subclass swap, not an
        engine change."""
        t = self.channel.transfer_time(nbytes)
        self.telemetry.observe_transfer(nbytes, t)
        return t

    def charge(self, stats: ServeStats, nbytes: int, *, phase: str,
               log: bool = True) -> None:
        """One uplink message of ``nbytes`` (header included by caller
        or via the ``account_*`` wrappers); ``log=False`` keeps it out of
        ``decode_bytes_log`` (a resync replay is not a decode round)."""
        t = self._transfer(stats, nbytes)
        stats.transmitted_bytes += int(nbytes)
        stats.channel_latency_s += t
        if phase == "prefill":
            stats.prefill_bytes += int(nbytes)
        else:
            stats.decode_bytes += int(nbytes)
            if log:
                stats.decode_bytes_log.append(int(nbytes))

    def account_blob(self, stats: ServeStats, blob: torch.Tensor, *,
                     phase: str, rows: Optional[int] = None,
                     row_elems=None) -> None:
        """Charge the wire for the occupied batch rows of ``blob``.

        The decode step always computes the full fixed-shape
        [max_batch, 1, D] delta, but idle slots would never be sent, so
        the simulated wire carries only the active rows — each framed
        with its own Eq.(1) scale/zero-point (per-row quantization).
        ``row_elems`` overrides the per-row payload element count: the
        prefill blob is bucket-padded on device, but only each request's
        true prompt activations cross the wire."""
        itemsize = blob.element_size()
        if row_elems is not None:
            nbytes = int(sum(int(e) * itemsize + _QP_BYTES
                             for e in row_elems))
        else:
            n_rows = blob.shape[0] if rows is None else rows
            per_row = (blob.numel() // blob.shape[0]) * itemsize
            nbytes = n_rows * (per_row + _QP_BYTES)
        self.charge(stats, nbytes + _MSG_BYTES, phase=phase)

    def account_downlink(self, stats: ServeStats, n_rows: int, *,
                         k: int = 1, phase: str = "decode") -> None:
        """The cloud→edge return: the greedy (or corrected) token per live
        request, plus — when a round verified k > 1 drafts — the accept
        mask (one bit per draft, byte-packed).  The edge can't start the
        next round until it arrives, so every round pays this second
        transfer and its channel RTT.  Counted in
        ``transmitted_bytes``/``downlink_bytes``, never in the uplink
        ``decode_bytes`` split."""
        mask = -(-k // 8) if k > 1 else 0
        nbytes = n_rows * (_TOK_BYTES + mask) + _MSG_BYTES
        t = self._transfer(stats, nbytes)
        stats.transmitted_bytes += nbytes
        stats.channel_latency_s += t
        stats.downlink_bytes += nbytes
        if phase == "decode":
            stats.decode_downlink_bytes += nbytes


def checksum(payload) -> int:
    """CRC32 of a boundary blob (a tensor, an array or bytes) — the
    integrity check a receiver runs before acking a message.  The
    simulated ``FaultyChannel`` flags corruption itself, so the hot path
    never copies a device blob to hash it; the mechanism is this one."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return zlib.crc32(payload) & 0xFFFFFFFF
    if isinstance(payload, torch.Tensor):
        payload = payload.detach().cpu().numpy()
    return zlib.crc32(np.ascontiguousarray(payload).tobytes()) & 0xFFFFFFFF


class CloudUnreachable(RuntimeError):
    """Raised by ``ReliableTransport`` when a message exhausts its retry
    budget — the signal on which a resilient engine declares the cloud
    down and degrades to edge-only serving."""


class ReliableTransport(Transport):
    """``Transport`` with sequencing, deadlines and bounded retries.

    Every message gets a sequence number (``seq``); retransmissions
    reuse it, so the receiver can drop duplicates and ack a
    retransmitted copy of an earlier send (which is what makes a
    downlink lost after a committed verify harmless).  A send's deadline
    is ``deadline_margin`` times the telemetry's prediction
    ``nbytes / bandwidth + rtt``, or ``fallback_deadline_s`` until the
    fit locks on.  A miss (a silent drop, an outage, or an arrival past
    the deadline) costs the sender the full deadline of waiting, then a
    backoff of ``min(backoff_max_s, backoff_base_s * 2**attempt)``
    times ``1 + U`` with ``U`` drawn from ``np.random.default_rng(seed)``
    before the retransmit; a checksum failure retransmits at once (after
    the backoff).  All of it is charged: waiting to
    ``channel_latency_s``, events to ``retries`` / ``timeouts`` /
    ``corrupt_msgs``, every attempt to the telemetry's loss EWMA.  After
    ``max_retries`` retransmits the send raises ``CloudUnreachable``.

    A channel without an ``attempt`` method (a plain ``Channel`` or a
    ``DriftingChannel``) takes the base transport's path: reliability is
    free when nothing fails."""

    def __init__(self, channel=None,
                 telemetry: Optional[LinkTelemetry] = None, *,
                 max_retries: int = 3, deadline_margin: float = 3.0,
                 fallback_deadline_s: float = 0.5,
                 min_deadline_s: float = 0.01, backoff_base_s: float = 0.02,
                 backoff_max_s: float = 1.0, seed: int = 0):
        super().__init__(channel, telemetry)
        self.max_retries = max_retries
        self.deadline_margin = deadline_margin
        self.fallback_deadline_s = fallback_deadline_s
        self.min_deadline_s = min_deadline_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._rng = np.random.default_rng(seed)
        self.seq = 0

    def deadline_for(self, nbytes: float) -> float:
        bw, rtt = self.telemetry.bandwidth_bytes_per_s, self.telemetry.rtt_s
        if bw is None:
            return self.fallback_deadline_s
        return max(self.min_deadline_s,
                   self.deadline_margin * (nbytes / bw + (rtt or 0.0)))

    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_max_s, self.backoff_base_s * (2 ** attempt))
        return base * (1.0 + float(self._rng.random()))   # full jitter

    def _wait(self, seconds: float) -> None:
        wait = getattr(self.channel, "wait", None)
        if wait is not None:
            wait(seconds)

    def _transfer(self, stats: ServeStats, nbytes: int) -> float:
        attempt = getattr(self.channel, "attempt", None)
        if attempt is None:
            return super()._transfer(stats, nbytes)
        self.seq += 1
        deadline = self.deadline_for(nbytes)
        spent = 0.0
        for i in range(self.max_retries + 1):
            out = attempt(nbytes)
            ok = out.delivered and not out.corrupt \
                and out.seconds <= deadline
            self.telemetry.observe_delivery(ok)
            if ok:
                self.telemetry.observe_transfer(nbytes, out.seconds)
                return spent + out.seconds
            if out.delivered and out.corrupt:
                stats.corrupt_msgs += 1          # caught at arrival: resend
                spent += out.seconds
            else:
                stats.timeouts += 1              # discovered at the deadline
                pause = max(0.0, deadline - out.seconds) \
                    if out.delivered else deadline
                self._wait(pause)
                spent += out.seconds + pause
            if i < self.max_retries:
                stats.retries += 1
                back = self._backoff(i)
                self._wait(back)
                spent += back
        stats.channel_latency_s += spent
        raise CloudUnreachable(
            f"seq {self.seq}: {nbytes} B undelivered after "
            f"{self.max_retries + 1} attempts ({spent:.3f}s)")

    def probe(self, stats: ServeStats) -> Tuple[bool, float]:
        """One single-attempt heartbeat (a header-only message): is the
        cloud reachable now?  Returns ``(ok, seconds consumed)``; a miss
        costs one deadline of waiting, charged to ``stats``."""
        attempt = getattr(self.channel, "attempt", None)
        if attempt is None:
            return True, 0.0
        deadline = self.deadline_for(_MSG_BYTES)
        out = attempt(_MSG_BYTES)
        ok = out.delivered and not out.corrupt and out.seconds <= deadline
        self.telemetry.observe_delivery(ok)
        spent = out.seconds
        if not ok:
            pause = deadline if not out.delivered \
                else max(0.0, deadline - out.seconds)
            self._wait(pause)
            spent += pause
            stats.timeouts += 1
        stats.channel_latency_s += spent
        return ok, spent
