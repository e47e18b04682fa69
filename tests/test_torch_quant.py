"""Port parity: ``repro_torch.core.quant`` against ``repro.core.quant``.

The same numpy inputs go through both packages.  Integer lattices and
zero points must be exactly equal; scales equal to within one f32 ulp
(both divide the same f32 span by 255, but XLA and PyTorch may fuse the
min/max reductions differently); dequantized and fake-quantized values
to 1e-6 relative (f32 products of equal operands)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402


def _inputs(seed, shape=(6, 5, 7)):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 3.0
    x.flat[0] = 0.0                           # an exact zero on the lattice
    return x


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("axis", [None, 0, 2, -1],
                         ids=["tensor", "row", "channel", "neg_axis"])
def test_qparams_and_lattice_match(axis, signed):
    x = _inputs(0)
    jqp = JQ.compute_qparams(jnp.asarray(x), axis=axis, signed=signed)
    tqp = TQ.compute_qparams(torch.tensor(x), axis=axis, signed=signed)
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))
    np.testing.assert_array_max_ulp(tqp.scale.numpy(),
                                    np.asarray(jqp.scale), maxulp=1)
    jq = np.asarray(JQ.quantize(jnp.asarray(x), jqp))
    tq = TQ.quantize(torch.tensor(x), tqp).numpy()
    assert tq.dtype == jq.dtype
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_allclose(
        TQ.dequantize(torch.tensor(tq), tqp).numpy(),
        np.asarray(JQ.dequantize(jnp.asarray(jq), jqp)), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        TQ.fake_quant(torch.tensor(x), tqp).numpy(),
        np.asarray(JQ.fake_quant(jnp.asarray(x), jqp)), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("bits", [8, 16])
def test_symmetric_and_wide_lattices_match(bits):
    x = _inputs(1, (9, 13))
    jqp = JQ.compute_qparams(jnp.asarray(x), axis=1, bits=bits,
                             symmetric=True)
    tqp = TQ.compute_qparams(torch.tensor(x), axis=1, bits=bits,
                             symmetric=True)
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))
    np.testing.assert_array_equal(
        TQ.quantize(torch.tensor(x), tqp).numpy(),
        np.asarray(JQ.quantize(jnp.asarray(x), jqp)))


def test_constant_tensor_keeps_span_floor():
    """A constant tensor hits the 1e-12 span floor on both sides."""
    x = np.zeros((4, 3), np.float32)
    jqp = JQ.compute_qparams(jnp.asarray(x), axis=0)
    tqp = TQ.compute_qparams(torch.tensor(x), axis=0)
    np.testing.assert_array_equal(tqp.scale.numpy(), np.asarray(jqp.scale))
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))


@pytest.mark.parametrize("bits,signed", [(8, True), (8, False), (4, True)])
def test_scale_is_eager_jax_quotient_bit_for_bit(bits, signed):
    """Eq.(1)'s scale and zero point from the same thresholds: the
    port's ``_minmax_to_qparams`` divides the f32 span by a tensor
    Range_LP (``_range_divisor``), which is eager JAX's quotient on
    every span (jitted XLA multiplies by the reciprocal instead, and so
    would torch on the card with a Python divisor)."""
    rng = np.random.RandomState(bits + signed)
    n = 200_000
    lo = -np.abs(rng.randn(n) * rng.lognormal(0.0, 3.0, n)).astype(
        np.float32)
    hi = np.abs(rng.randn(n) * rng.lognormal(0.0, 3.0, n)).astype(np.float32)
    jqp = JQ._minmax_to_qparams(jnp.asarray(lo), jnp.asarray(hi), bits=bits,
                                signed=signed, axis=0)
    tqp = TQ._minmax_to_qparams(torch.tensor(lo), torch.tensor(hi),
                                bits=bits, signed=signed, axis=0)
    np.testing.assert_array_equal(tqp.scale.numpy(), np.asarray(jqp.scale))
    np.testing.assert_array_equal(tqp.zero_point.numpy(),
                                  np.asarray(jqp.zero_point))
    # the product with the reciprocal is another float on some spans:
    # the check above can tell the two apart
    span = np.maximum(hi - lo, np.float32(1e-12))
    recip = span * np.float32(1.0 / (2 ** bits - 1))
    assert (recip != tqp.scale.numpy()).any()
    assert TQ._range_divisor(torch.device("cpu"), bits) is \
        TQ._range_divisor(torch.device("cpu"), bits)


def test_kv_scale_is_jitted_jax_product_bit_for_bit():
    """The INT8 KV pages' symmetric scale of an f32 ``amax``: the JAX
    engines take ``max(amax, 1e-6) / 127.0`` under ``jit``, which XLA
    computes as the product with the f32 reciprocal; the port's
    ``_kv_scale`` gives that float on all 200,000 values (torch's CPU
    quotient differs on some, which the last check can see)."""
    import jax

    from repro_torch.models import layers as TL
    rng = np.random.RandomState(127)
    amax = np.abs(rng.randn(200_000) * rng.lognormal(0.0, 3.0, 200_000)
                  ).astype(np.float32)
    amax[:8] = [0.0, 1e-7, 1e-6, 2e-6, 127.0, 1.0, 3.4e38, 1e-30]
    want = np.asarray(jax.jit(lambda a: jnp.maximum(a, 1e-6) / 127.0)(
        jnp.asarray(amax)))
    got = TL._kv_scale(torch.tensor(amax)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    quotient = (torch.clamp(torch.tensor(amax), min=1e-6) / 127.0).numpy()
    assert (quotient != want).any()
    # a bf16 amax keeps the division: the jitted reference's bits too
    a16 = jnp.asarray(amax[:4096]).astype(jnp.bfloat16)
    want16 = np.asarray(jax.jit(lambda a: jnp.maximum(a, 1e-6) / 127.0)(
        a16).astype(jnp.float32))
    got16 = TL._kv_scale(torch.tensor(amax[:4096]).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), want16)
    assert TL._inv127(torch.device("cpu")) is TL._inv127(torch.device("cpu"))


def test_calibrated_kv_scales_equal_the_jitted_reference_layer():
    """The calibrating paged write itself: the reference's
    ``_paged_cache_attention`` under ``jit`` and the port's
    ``_write_pages`` on the same K/V give the same scales and the same
    INT8 pages, bucket padding masked out of the range."""
    import jax

    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.RandomState(3)
    b, s, n_kv, hd, page = 96, 16, 4, 8, 8
    kh = (rng.randn(b, s, n_kv, hd) * rng.lognormal(0, 2, (b, 1, n_kv, 1))
          ).astype(np.float32)
    vh = (rng.randn(b, s, n_kv, hd) * 0.3).astype(np.float32)
    qh = rng.randn(b, s, n_kv, hd).astype(np.float32)
    lens = rng.randint(1, s + 1, b).astype(np.int32)
    n_pages = b * (s // page) + 1
    bt = np.arange(1, n_pages, dtype=np.int32).reshape(b, s // page)

    def cache(mod):
        z = np.zeros((n_pages, page, n_kv, hd), np.int8)
        sc = np.zeros((b, n_kv), np.float32)
        return {"k_pages": mod(z), "v_pages": mod(z.copy()),
                "k_scale": mod(sc), "v_scale": mod(sc.copy())}

    def ref(c, q, k, v, t, n):
        return JL._paged_cache_attention(
            c, q, k, v, block_tables=t, cache_index=jnp.int32(0),
            vec_index=False, calibrate_kv=True, kv_lengths=n,
            n_heads=n_kv, n_kv=n_kv, q_chunk=None, dtype=jnp.float32)[1]

    jc = jax.jit(ref)(cache(jnp.asarray), jnp.asarray(qh), jnp.asarray(kh),
                      jnp.asarray(vh), jnp.asarray(bt), jnp.asarray(lens))
    tc = cache(torch.tensor)
    ks, vs, _ = TL._write_pages(tc, torch.tensor(kh), torch.tensor(vh),
                                torch.tensor(bt), 0, False, True,
                                torch.tensor(lens))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jc["k_scale"]))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jc["v_scale"]))
    np.testing.assert_array_equal(tc["k_pages"].numpy(),
                                  np.asarray(jc["k_pages"]))
    np.testing.assert_array_equal(tc["v_pages"].numpy(),
                                  np.asarray(jc["v_pages"]))
