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
