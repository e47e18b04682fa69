"""Port parity: the plain PyTorch paged attention of
``repro_torch.kernels.paged_attention`` against both JAX functions —
the Pallas kernel ``paged_flash_mq`` (run in interpret mode, as the JAX
suite runs it on the CPU) and the gather oracle
``paged_attention_mq_ref``.

Tolerance: atol = rtol = 1e-5 in f32 — the three compute the same
softmax with sums taken in different orders (online over pages in the
kernel, one reduction in the oracles).

A row with no valid position is the one place the JAX oracle differs
from its own kernel: the oracle's softmax over all-masked logits is
uniform (the mean of V), the kernel re-masks its weights and gives 0.
The port follows the kernel, so that row is held against the kernel and
checked to be exactly 0."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as JPA  # noqa: E402
from repro_torch.kernels import paged_attention as TPA  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, *, page_int8, group, s, scales, b=3, n_kv=2, hd=16,
          page=8, pages_per=4):
    rng = np.random.RandomState(seed)
    n_heads = n_kv * group
    n_pages = b * pages_per + 3
    q = rng.randn(b, s, n_heads, hd).astype(np.float32)
    shape = (n_pages, page, n_kv, hd)
    if page_int8:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
    if scales == "none":
        ks = vs = None
        if page_int8:
            # unit scales leave int8 K at ±127: shrink q by the same
            # factor so the logits keep the magnitude a calibrated cache
            # gives them (at ~1e4 the softmax is a near-one-hot whose f32
            # rounding is not what this test is about)
            q = q / 127.0
    elif scales == "per_head":
        ks = rng.uniform(0.01, 0.05, (n_kv,)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (n_kv,)).astype(np.float32)
    else:
        ks = rng.uniform(0.01, 0.05, (b, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (b, n_kv)).astype(np.float32)
    # shuffled block table: every row its own permutation of pages >= 1
    bt = np.stack([rng.choice(np.arange(1, n_pages), pages_per,
                              replace=False)
                   for _ in range(b)]).astype(np.int32)
    span = pages_per * page
    lens = np.array([0, span, rng.randint(1, span)], np.int32)   # ragged
    q0 = np.array([0, span - s, max(int(lens[2]) - s, 0)], np.int32)
    return q, kp, vp, bt, lens, q0, ks, vs


def _jax(fn, args, **kw):
    return np.asarray(fn(*[None if a is None else jnp.asarray(a)
                           for a in args], **kw))


def _torch(fn, args):
    return fn(*[None if a is None else torch.tensor(a)
                for a in args]).numpy()


@pytest.mark.parametrize("scales", ["none", "per_head", "per_slot"])
@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("page_int8", [True, False], ids=["int8", "f32"])
def test_plain_matches_jax_kernel_and_oracle(page_int8, group, s, scales):
    args = _case(7, page_int8=page_int8, group=group, s=s, scales=scales)
    got = _torch(TPA.paged_attention_mq_ref, args)
    kern = _jax(JPA.paged_flash_mq, args, interpret=True)
    oracle = _jax(JPA.paged_attention_mq_ref, args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kern, **TOL)
    lens = args[4]
    live = lens > 0
    np.testing.assert_allclose(got[live], oracle[live], **TOL)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("page_int8", [True, False], ids=["int8", "f32"])
def test_decode_front_door_matches_jax(page_int8):
    """S = 1 front door (``q_start = lengths - 1``) against the JAX
    decode oracle, on rows that all hold at least one position."""
    q, kp, vp, bt, lens, _q0, ks, vs = _case(
        3, page_int8=page_int8, group=2, s=1, scales="per_slot")
    lens = np.maximum(lens, 1)
    args = (q[:, 0], kp, vp, bt, lens, ks, vs)
    got = _torch(TPA.paged_attention, args)
    want = _jax(JPA.paged_attention_ref, args)
    np.testing.assert_allclose(got, want, **TOL)


def test_pages_outside_the_table_do_not_matter():
    """Poisoning every page no row's table names changes nothing."""
    q, kp, vp, bt, lens, q0, ks, vs = _case(
        11, page_int8=True, group=2, s=4, scales="per_slot")
    before = _torch(TPA.paged_attention_mq_ref,
                    (q, kp, vp, bt, lens, q0, ks, vs))
    named = set(bt.reshape(-1).tolist())
    for pg in range(kp.shape[0]):
        if pg not in named:
            kp[pg] = 127
            vp[pg] = 127
    after = _torch(TPA.paged_attention_mq_ref,
                   (q, kp, vp, bt, lens, q0, ks, vs))
    np.testing.assert_array_equal(before, after)


@pytest.mark.parametrize("saved", [True, False])
def test_plain_version_leaves_the_tf32_setting_as_it_was(saved,
                                                         monkeypatch):
    """The oracle switches TF32 matmuls off for its own call on a CUDA
    tensor and restores the caller's setting afterwards; on the CPU it
    leaves it alone.  The helper is driven directly (no card here)."""
    flag = torch.backends.cuda.matmul
    monkeypatch.setattr(flag, "allow_tf32", saved)
    with TPA._full_f32_matmul(True):
        assert flag.allow_tf32 is False
    assert flag.allow_tf32 is saved
    with pytest.raises(RuntimeError):
        with TPA._full_f32_matmul(True):
            raise RuntimeError("inside the oracle")
    assert flag.allow_tf32 is saved
    with TPA._full_f32_matmul(False):
        assert flag.allow_tf32 is saved
    args = _case(4, page_int8=True, group=2, s=3, scales="per_slot")
    _torch(TPA.paged_attention_mq_ref, args)
    assert flag.allow_tf32 is saved


# ---------------------------------------------------------------------------
# The split-KV decode/verify kernel's plan and algorithm, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("batch,n_kv", [(4, 32), (4, 16), (4, 8), (4, 10),
                                        (1, 1), (64, 64)])
def test_plan_splits_covers_the_span_in_whole_pages(batch, n_kv, page):
    """At every span from one page to 4,096 positions: the chunk is a
    whole number of pages and of 32-position tiles, the splits cover the
    span and the last one is not empty, and the grid stays within one
    wave of resident CTAs unless the (b, kv head) pairs alone exceed it."""
    pairs = batch * n_kv
    cap = max(TPA._SMS * TPA._CTAS_PER_SM, pairs)
    for pages_per in range(1, 4096 // page + 1):
        span = pages_per * page
        chunk, n_splits = TPA._plan_splits(batch, n_kv, pages_per, page)
        assert chunk % page == 0 and chunk % 32 == 0 and chunk >= 32
        assert n_splits * chunk >= span > (n_splits - 1) * chunk
        assert n_splits * pairs <= cap


def test_plan_splits_at_the_serving_shapes():
    """deepseek-7b decode (B 4, 32 kv heads, max_len 184 → 12 pages of
    16): one tile a split, 6 x 32 x 4 = 768 CTAs; a tp 2 shard keeps 6
    splits over 16 kv heads; a 4,096-position span grows the chunk."""
    assert TPA._plan_splits(4, 32, 12, 16) == (32, 6)
    assert TPA._plan_splits(4, 16, 12, 16) == (32, 6)
    chunk, n_splits = TPA._plan_splits(4, 32, 256, 16)
    assert chunk > 32 and n_splits * 4 * 32 <= TPA._SMS * TPA._CTAS_PER_SM


def _split_model(q, kp, vp, bt, lens, q0, ks, vs, chunk):
    """The split kernel's algorithm in plain PyTorch: the K scale folded
    into q, per split a partial (m, l, acc) over the raw V (m = -1e30, l =
    0 where a row has no valid position in the split), the partials
    merged in split order over the splits with l > 0, then the V scale."""
    b, s, n_heads, hd = q.shape
    _, page, n_kv, _ = kp.shape
    group = n_heads // n_kv
    span = bt.shape[1] * page
    btl = bt.long()
    k = kp[btl].reshape(b, span, n_kv, hd).to(torch.float32)
    v = vp[btl].reshape(b, span, n_kv, hd).to(torch.float32)
    ks = TPA._norm_scales(ks, b, n_kv, q.device)
    vs = TPA._norm_scales(vs, b, n_kv, q.device)
    qf = (q.reshape(b, s, n_kv, group, hd) * (1.0 / np.sqrt(hd))
          * ks[:, None, :, None, None])
    logits = torch.einsum("bsngd,blnd->bnsgl", qf, k)
    pos = torch.arange(span)
    qpos = q0.long()[:, None] + torch.arange(s)[None]
    mask = ((pos[None, None] <= qpos[:, :, None])
            & (pos[None, None] < lens.long()[:, None, None]))[:, None, :, None]
    parts = []
    for c0 in range(0, span, chunk):
        sl = slice(c0, min(c0 + chunk, span))
        mk = mask[..., sl]
        lg = torch.where(mk, logits[..., sl], torch.tensor(TPA._MASKED))
        m = lg.amax(dim=-1)
        w = torch.where(mk, torch.exp(lg - m[..., None]), torch.tensor(0.0))
        parts.append((m, w.sum(dim=-1),
                      torch.einsum("bnsgl,blnd->bnsgd", w, v[:, sl])))
    m_all = torch.full_like(parts[0][0], TPA._MASKED)
    for m, l, _ in parts:
        m_all = torch.where(l > 0, torch.maximum(m_all, m), m_all)
    den = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                       # split order
        f = torch.where(l > 0, torch.exp(m - m_all), torch.tensor(0.0))
        den = den + l * f
        acc = acc + a * f[..., None]
    out = acc / torch.clamp(den, min=1e-30)[..., None] \
        * vs[:, :, None, None, None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, n_heads, hd)


def _split_case(seed, *, page_int8, group, s, b=5, n_kv=2, hd=16, page=8,
                pages_per=12):
    """Rows over a 96-position span (3 tiles of 32): length 0, the whole
    span, 32 and 8 (page boundaries; later splits hold nothing), and a
    ragged 41."""
    rng = np.random.RandomState(seed)
    n_pages = b * pages_per + 3
    shape = (n_pages, page, n_kv, hd)
    q = rng.randn(b, s, n_kv * group, hd).astype(np.float32)
    if page_int8:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, (b, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (b, n_kv)).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    bt = np.stack([rng.choice(np.arange(1, n_pages), pages_per,
                              replace=False)
                   for _ in range(b)]).astype(np.int32)
    lens = np.array([0, pages_per * page, 32, 8, 41], np.int32)
    q0 = np.maximum(lens - s, 0).astype(np.int32)
    return q, kp, vp, bt, lens, q0, ks, vs


@pytest.mark.parametrize("chunk", ["plan", 64])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("page_int8", [True, False], ids=["int8", "f32"])
def test_split_and_merge_matches_both_plain_versions(page_int8, group, s,
                                                     chunk):
    """The split kernel's split-and-merge, modelled in PyTorch, against
    the port's plain version and the JAX oracle on the same numpy
    inputs: atol = rtol = 1e-5 (f32 sums in another order); the length-0
    row is exactly 0 (held against the port only: the JAX oracle gives
    the mean of V there)."""
    args = _split_case(21 + s + group, page_int8=page_int8, group=group,
                       s=s)
    q, kp, vp, bt, lens = args[:5]
    if chunk == "plan":
        chunk, n_splits = TPA._plan_splits(q.shape[0], kp.shape[2],
                                           bt.shape[1], kp.shape[1])
        assert n_splits == 3
    t = [None if a is None else torch.tensor(a) for a in args]
    got = _split_model(*t, chunk=chunk).numpy()
    port = TPA.paged_attention_mq_ref(*t).numpy()
    oracle = _jax(JPA.paged_attention_mq_ref, args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, port, **TOL)
    live = lens > 0
    np.testing.assert_allclose(got[live], oracle[live], **TOL)
    assert (got[~live] == 0).all() and (port[~live] == 0).all()


def test_kernel_doors_raise_on_cpu_tensors():
    """No fallback: both kernel doors refuse a CPU tensor (the front
    doors send it to the plain version before they are reached)."""
    args = [None if a is None else torch.tensor(a)
            for a in _split_case(2, page_int8=True, group=1, s=1)]
    for door in (TPA.paged_flash_mq, TPA.paged_flash_mq_tiled):
        with pytest.raises(ValueError, match="CUDA"):
            door(*args)


def test_split_workspace_holds_partials_then_counters():
    """A split launch's workspace: [B, n_kv, n_splits, n_rows, hd + 2]
    f32 partials, then one int32 counter per (b, kv head) — the call's
    own, zeroed by the launch on its stream; an unsplit launch needs
    none."""
    assert TPA._split_workspace_numel(4, 32, 6, 1, 128) == \
        4 * 32 * 6 * 1 * 130 + 4 * 32
    assert TPA._split_workspace_numel(4, 10, 3, 16, 12) == \
        4 * 10 * 3 * 16 * 14 + 4 * 10
    assert TPA._split_workspace_numel(4, 32, 1, 4, 128) == 0


def test_split_counters_are_not_module_state():
    """No per-device counter buffer outlives a call (two launches on two
    streams of one card could race on one): the wrapper keeps none."""
    assert not hasattr(TPA, "_COUNTER_BUFS")
    assert not hasattr(TPA, "_counters")
    assert not any(isinstance(v, torch.Tensor) for v in vars(TPA).values())


# ---------------------------------------------------------------------------
# The tensor-core prefill kernel's algorithm, on the CPU
# ---------------------------------------------------------------------------

_TC_ROWS, _TC_WARP_ROWS = 64, 16     # stacked rows per CTA, per warp
KERNEL_TOL = 1e-4                    # |kernel - plain| / max(max|plain|, 1)


def _bf16_split(x):
    """f32 -> bf16 hi + lo, each back in f32 (hi + lo keeps 16 bits)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _hi_only(x):
    """The split with its lo half dropped: one bf16 product per f32 one."""
    return x.to(torch.bfloat16).to(torch.float32), torch.zeros_like(x)


def _tc_model(q, kp, vp, bt, lens, q0, ks, vs, split=_bf16_split):
    """The tensor-core kernel's algorithm in plain PyTorch.  The stacked
    rows of each (b, kv head) go in blocks of 64 (a CTA: it stops after
    the last position any of its rows may attend) of 16-row warps (each
    skips a tile past its own rows' last position); positions in tiles of
    64 (32 for f32 pages), zero past the CTA's last position.  q carries
    sm_scale * log2(e) * k_scale and is split into bf16 hi + lo; int8
    pages are exact in bf16, f32 pages are split too; products of bf16
    values summed in f32 (QK = q_hi K + q_lo K [+ q_hi K_lo]); online
    softmax in base 2 with the finite -1e30 mask and re-masked weights;
    PV = p_hi V + p_lo V [+ p_hi V_lo]; out = acc / max(l, 1e-30) *
    v_scale.  ``split`` turns an f32 tensor into its (hi, lo) bf16
    halves."""
    b, s, n_heads, hd = q.shape
    _, page, n_kv, _ = kp.shape
    group = n_heads // n_kv
    n_rows = s * group
    span = bt.shape[1] * page
    split_kv = kp.dtype == torch.float32
    bn = 32 if split_kv else 64
    btl = bt.long()
    k = kp[btl].reshape(b, span, n_kv, hd).to(torch.float32)
    v = vp[btl].reshape(b, span, n_kv, hd).to(torch.float32)
    ks = TPA._norm_scales(ks, b, n_kv, q.device)
    vs = TPA._norm_scales(vs, b, n_kv, q.device)
    q_scale = torch.tensor(np.log2(np.e) / np.sqrt(hd), dtype=torch.float32)
    masked = torch.tensor(TPA._MASKED)
    out = torch.zeros((b, s, n_heads, hd))
    for bi in range(b):
        lim, qs = min(int(lens[bi]), span), int(q0[bi])
        qpos = qs + torch.arange(n_rows) // group
        for h in range(n_kv):
            # row r of the kv head = query s_ = r // group, head h * group + g
            rows = q[bi, :, h * group:(h + 1) * group].reshape(n_rows, hd)
            q_hi, q_lo = split(rows * (q_scale * ks[bi, h]))
            for r0 in range(0, n_rows, _TC_ROWS):
                last = min(r0 + _TC_ROWS, n_rows) - 1
                n_pos = min(lim, qs + last // group + 1)
                n_tiles = -(-n_pos // bn) if n_pos > 0 else 0
                kt = torch.zeros((n_tiles * bn, hd))
                vt = torch.zeros((n_tiles * bn, hd))
                if n_pos > 0:
                    kt[:n_pos], vt[:n_pos] = k[bi, :n_pos, h], v[bi, :n_pos, h]
                k_hi, k_lo = split(kt) if split_kv else (kt, None)
                v_hi, v_lo = split(vt) if split_kv else (vt, None)
                for w0 in range(r0, last + 1, _TC_WARP_ROWS):
                    wr = slice(w0, min(w0 + _TC_WARP_ROWS, last + 1))
                    n = wr.stop - wr.start
                    m = torch.full((n,), TPA._MASKED)
                    den = torch.zeros(n)
                    acc = torch.zeros((n, hd))
                    for t0 in range(0, n_tiles * bn, bn):
                        if t0 > int(qpos[wr.stop - 1]):
                            continue
                        tl = slice(t0, t0 + bn)
                        pos = torch.arange(t0, t0 + bn)
                        valid = ((pos[None] <= qpos[wr, None])
                                 & (pos[None] < lim))
                        sc = q_hi[wr] @ k_hi[tl].T + q_lo[wr] @ k_hi[tl].T
                        if split_kv:
                            sc = sc + q_hi[wr] @ k_lo[tl].T
                        sc = torch.where(valid, sc, masked)
                        mn = torch.maximum(m, sc.amax(dim=-1))
                        alpha = torch.exp2(m - mn)
                        w = torch.where(valid, torch.exp2(sc - mn[:, None]),
                                        torch.tensor(0.0))
                        den = den * alpha + w.sum(dim=-1)
                        w_hi, w_lo = split(w)
                        pv = w_hi @ v_hi[tl] + w_lo @ v_hi[tl]
                        if split_kv:
                            pv = pv + w_hi @ v_lo[tl]
                        acc = acc * alpha[:, None] + pv
                        m = mn
                    o = acc / torch.clamp(den, min=1e-30)[:, None] * vs[bi, h]
                    for i, r in enumerate(range(wr.start, wr.stop)):
                        out[bi, r // group, h * group + r % group] = o[i]
    return out


def _tc_case(seed, *, page_int8, group, s, hd, b=5, n_kv=2, page=16,
             pages_per=10):
    """Rows over a 160-position span: length 0, the whole span (q_start
    > 0), 64 (a page boundary), a ragged 37, and 130 (q_start > 0 at S =
    17 and 64)."""
    rng = np.random.RandomState(seed)
    n_pages = b * pages_per + 3
    shape = (n_pages, page, n_kv, hd)
    q = rng.randn(b, s, n_kv * group, hd).astype(np.float32)
    if page_int8:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, (b, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (b, n_kv)).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    bt = np.stack([rng.choice(np.arange(1, n_pages), pages_per,
                              replace=False)
                   for _ in range(b)]).astype(np.int32)
    lens = np.array([0, pages_per * page, 64, 37, 130], np.int32)
    q0 = np.maximum(lens - s, 0).astype(np.int32)
    return q, kp, vp, bt, lens, q0, ks, vs


@pytest.mark.parametrize("hd", [12, 128])
@pytest.mark.parametrize("s", [17, 64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("page_int8", [True, False], ids=["int8", "f32"])
def test_tensor_core_model_matches_plain_versions(page_int8, group, s, hd):
    """The tensor-core kernel's arithmetic (bf16 hi/lo splits, 64-row
    blocks of 16-row warps, 64-position tiles, early stops), modelled in
    PyTorch, against the port's plain version, the JAX oracle and the JAX
    Pallas kernel in interpret mode on the same numpy inputs, within the
    card's tolerance 1e-4 x max(max |plain|, 1); the length-0 row is
    exactly 0 (held against the port and the Pallas kernel only: the JAX
    oracle gives the mean of V there)."""
    args = _tc_case(40 + s + group + hd, page_int8=page_int8, group=group,
                    s=s, hd=hd)
    t = [None if a is None else torch.tensor(a) for a in args]
    got = _tc_model(*t).numpy()
    port = TPA.paged_attention_mq_ref(*t).numpy()
    kern = _jax(JPA.paged_flash_mq, args, interpret=True)
    oracle = _jax(JPA.paged_attention_mq_ref, args)
    live = args[4] > 0
    assert np.isfinite(got).all()
    for want in (port, kern, oracle[live]):
        g = got if want.shape == got.shape else got[live]
        tol = KERNEL_TOL * max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(g - want).max()) <= tol
    assert (got[~live] == 0).all() and (port[~live] == 0).all()


@pytest.mark.parametrize("hd", [12, 128])
@pytest.mark.parametrize("page_int8", [True, False], ids=["int8", "f32"])
def test_tensor_core_model_needs_both_bf16_halves(page_int8, hd):
    """Why the kernel issues two bf16 products per f32 product (three for
    f32 pages): with the hi + lo splits its arithmetic stays within 15 %
    of the card's tolerance, 1e-4 x max(max |plain|, 1), of the port's
    plain version at the serving prefill's S 128 (group 4); with the hi
    halves alone it misses the tolerance."""
    args = _tc_case(40 + 128 + 4 + hd, page_int8=page_int8, group=4, s=128,
                    hd=hd)
    t = [None if a is None else torch.tensor(a) for a in args]
    port = TPA.paged_attention_mq_ref(*t).numpy()
    tol = KERNEL_TOL * max(float(np.abs(port).max()), 1.0)
    both = float(np.abs(_tc_model(*t).numpy() - port).max()) / tol
    hi = float(np.abs(_tc_model(*t, split=_hi_only).numpy() - port).max()) / tol
    assert both <= 0.15, f"hi + lo: {both:.3f} of the tolerance"
    assert hi > 1.0, f"hi only: {hi:.3f} of the tolerance"
