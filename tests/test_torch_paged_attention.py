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
