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
