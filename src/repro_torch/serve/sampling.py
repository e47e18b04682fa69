"""Temperature / top-p sampling for the collaborative engine, including
the speculative **rejection-sampling verify**.

Counterpart of ``repro.serve.sampling``; the distribution contract and
the seed discipline are the reference's.  For a request with
``SamplingParams(temperature=T > 0, top_p=P, seed=s)`` every committed
token is distributed as if the cloud suffix had sampled it serially from
``nucleus(softmax(logits / T), P)``: the verify accepts draft ``d ~ q``
with probability ``min(1, p(d) / q(d))``, resamples the normalized
residual ``max(p - q, 0)`` at the first rejection, and samples the bonus
position of an all-accepted round from ``p``.  ``temperature=0`` (or
``sampling=None``) is the greedy path: engines route it through the
argmax phases untouched.

Every draw uses a key derived only from the request's ``(seed, absolute
output index, stream tag)``:

    ``DRAFT``   the edge's proposal at an output index;
    ``ACCEPT``  the verify's accept/reject uniform for that index;
    ``RESID``   the residual resample on rejection;
    ``CLOUD``   direct cloud draws: the prefill's first token, serial
                (k = 1) steps and the all-accepted bonus token.

So a stream depends on nothing else (slots, batch mix, wall clock), and
a ``k = 4`` stream agrees with a ``k = 1`` one in distribution and at
output index 0 bit for bit, not token for token.

The keys are JAX's threefry2x32 keys, computed here in torch integer
ops so that the port draws the reference's tokens bit for bit and the
card draws the CPU's: ``PRNGKey(seed)``, ``fold_in``, 32-bit
``random_bits``, ``uniform``, the ``"low"``-mode ``gumbel`` and
``categorical`` as ``argmax(gumbel + logits)``
(``jax/_src/prng.py::threefry_seed``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py::
_uniform``, ``_gumbel``, ``categorical``).  The bits follow the
**partitionable** layout (``jax_threefry_partitionable=True``, the
default from jax 0.5 on): element ``j`` of a draw hashes the 64-bit
counter ``j`` split into two 32-bit words and keeps the xor of the two
output words.  jax before 0.5 defaults to the other layout, whose bits
differ; a comparison with such a jax sets the flag first.

No torch random generator is involved.  uint32 arithmetic runs in int64
with 32-bit masks, which every device supports alike, so the card's
bits equal the CPU's.  Keys are ``[n, 2]`` int64 tensors holding uint32
words.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["SamplingParams", "DRAFT", "ACCEPT", "RESID", "CLOUD",
           "token_keys", "uniform_rows", "filtered_probs", "sample_rows",
           "grade_and_correct"]

# stream tags (see module docstring) — folded into every per-token key
DRAFT, ACCEPT, RESID, CLOUD = 0, 1, 2, 3

# log-floor for zeroed (out-of-nucleus) probabilities: low enough that
# the Gumbel noise (bounded by ~16 for 32-bit uniforms) can never
# resurrect a masked token, finite so no NaNs flow through where().  It
# is subnormal in f32: torch's log gives -87.5 where an XLA that flushes
# subnormals gives -inf; a masked token loses either way
_LOG_FLOOR = 1e-38

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode-sampling controls.

    ``temperature=0`` means greedy (argmax): such requests take the
    greedy phases regardless of ``top_p``/``seed``.  ``seed`` is the root
    of every random draw the request consumes."""
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if not self.temperature >= 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0


# -- threefry2x32 and the draws JAX builds on it ----------------------------
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on uint32 words held in int64
    (broadcasting), as ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: hash ``threefry_seed(data)`` —
    the counter pair ``(0, data)`` — under each key."""
    y1, y2 = _threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(data),
                           data & _M32)
    return torch.stack([y1, y2], dim=1)


def _random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[rows, n]`` 32-bit random bits per key row, partitionable
    layout: element ``j`` hashes the counter pair ``(0, j)`` and keeps
    the xor of the two output words (a scalar draw is element 0)."""
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    y1, y2 = _threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(cnt),
                           cnt)
    return y1 ^ y2


def _uniform(bits: torch.Tensor, minval: float = 0.0) -> torch.Tensor:
    """f32 uniforms on ``[minval, 1)`` from 32-bit bits, as ``jax.random.
    uniform``: the top 23 bits as a mantissa of [1, 2), minus 1, times
    ``1 - minval`` plus ``minval`` in f32, floored at ``minval``.  For
    the two minvals used here (0 and the smallest normal f32) ``1 -
    minval`` rounds to 1.0 in f32, so the product is the identity."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (f + minval).clamp_min(minval)


def _gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[rows, n]`` standard Gumbel noise per key row, ``jax.random.
    gumbel``'s "low" mode: ``-log(-log(u))``, u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(_uniform(_random_bits(keys, n),
                                          _F32_TINY)))


# -- the reference's sampling API --------------------------------------------
def token_keys(seeds: torch.Tensor, indices: torch.Tensor,
               stream: int) -> torch.Tensor:
    """[n, 2] keys for (seed, absolute output index, stream) triples:
    ``fold_in(fold_in(PRNGKey(seed), index), stream)``.  Seeds and
    indices are taken modulo 2^32, as the reference's casts to uint32
    take them; ``PRNGKey`` of a 32-bit seed is the pair ``(0, seed)``."""
    seeds = seeds.to(torch.int64) & _M32
    keys = torch.stack([torch.zeros_like(seeds), seeds], dim=1)
    keys = _fold_in(keys, indices.to(torch.int64))
    return _fold_in(keys, torch.full_like(seeds, stream))


def uniform_rows(keys: torch.Tensor) -> torch.Tensor:
    """One U[0, 1) draw per key row."""
    return _uniform(_random_bits(keys, 1)[:, 0])


def filtered_probs(logits: torch.Tensor, temps: torch.Tensor,
                   top_ps: torch.Tensor) -> torch.Tensor:
    """Row-wise temperature + top-p (nucleus) filtered probabilities.

    ``logits [n, V]`` f32, ``temps``/``top_ps`` ``[n]``.  Nucleus keeps
    the smallest prefix of descending-sorted probabilities whose
    *exclusive* cumulative mass is below ``top_p`` (ties at the
    threshold all kept), then renormalizes.  Rows with ``temp <= 0``
    return a one-hot at the argmax."""
    t = temps.clamp_min(1e-6)[:, None]
    p = torch.softmax(logits / t, dim=-1)
    sp = torch.sort(p, dim=-1, descending=True).values
    cs = torch.cumsum(sp, dim=-1)
    keep_sorted = (cs - sp) < top_ps[:, None]
    thresh = torch.where(keep_sorted, sp, torch.inf).amin(dim=-1)
    p = torch.where(p >= thresh[:, None], p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, -1), logits.shape[-1]).to(p.dtype)
    return torch.where((temps > 0.0)[:, None], p, onehot)


def sample_rows(p: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One categorical draw per probability row (``p [n, V]``):
    ``argmax(gumbel + log p)``, ties to the first index as in JAX."""
    logp = torch.log(p.clamp_min(_LOG_FLOOR))
    return torch.argmax(_gumbel(keys, p.shape[-1]) + logp,
                        dim=-1).to(torch.int32)


def grade_and_correct(p: torch.Tensor, q: torch.Tensor, d: torch.Tensor,
                      sampled_row: torch.Tensor, greedy_t: torch.Tensor,
                      seeds: torch.Tensor, offsets: torch.Tensor,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection-sampling verify core, row-mixed with greedy.

    ``p``/``q`` are the cloud/draft filtered probabilities ``[B, k, V]``
    at each drafted position, ``d [B, k]`` the drafts, ``greedy_t`` the
    cloud argmaxes, ``offsets [B]`` each row's absolute output index of
    position 0.  Greedy rows (``~sampled_row``) grade by exact argmax
    match and correct with ``greedy_t``, committing the tokens the
    greedy verify would.  Sampled rows accept position i iff
    ``u_i * q_i(d_i) <= p_i(d_i)`` (``u`` from the ``ACCEPT`` stream);
    the correction at the first rejection samples the normalized
    residual ``max(p - q, 0)`` (``RESID``; a numerically empty residual
    falls back to ``p``), and an all-accepted round's bonus position
    samples ``p`` directly (``CLOUD``).  Returns ``(tokens [B, k],
    n_commit [B])``; positions ``>= n_commit`` are not read."""
    B, k, V = p.shape
    ar = torch.arange(k, device=p.device)[None, :]
    idx = (offsets.to(torch.int64)[:, None] + ar).reshape(-1)
    rep_seeds = torch.repeat_interleave(seeds, k)
    u = uniform_rows(token_keys(rep_seeds, idx, ACCEPT)).reshape(B, k)
    dl = d.long()[..., None]
    p_d = torch.gather(p, 2, dl)[..., 0]
    q_d = torch.gather(q, 2, dl)[..., 0]
    ok_row = torch.where(sampled_row[:, None], u * q_d <= p_d,
                         d == greedy_t)
    ok = ok_row[:, :k - 1].to(torch.int32)
    n_commit = 1 + torch.cumprod(ok, dim=1).sum(dim=1)      # [B] in 1..k
    resid = (p - q).clamp_min(0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(mass > 1e-9, resid / mass.clamp_min(1e-9), p)
    resid_tok = sample_rows(resid.reshape(B * k, V),
                            token_keys(rep_seeds, idx, RESID)).reshape(B, k)
    bonus_tok = sample_rows(p.reshape(B * k, V),
                            token_keys(rep_seeds, idx, CLOUD)).reshape(B, k)
    corr = torch.where(ar == k - 1, bonus_tok, resid_tok)
    corr = torch.where(sampled_row[:, None], corr, greedy_t)
    toks = torch.where(ar == (n_commit - 1)[:, None], corr, d)
    return toks.to(torch.int32), n_commit.to(torch.int32)
