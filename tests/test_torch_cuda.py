"""The port on the card: each CUDA kernel against its plain version (the
paged-attention kernel also in its tensor-parallel form, one launch per
shard), and the collaborative engine (serial, speculative, and with its
cloud tensor-parallel over two shards of the card) on CUDA against the
same engine on the CPU.

Marked ``gpu``: each test skips where there is no CUDA device.  This
file imports no JAX, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.quant import (QuantParams, compute_qparams,  # noqa: E402
                                    quantize)
from repro_torch.kernels import int8_matmul as IK  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

CFG = get_arch("deepseek-7b").smoke


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, *, dtype, group, s, b=4, n_kv=4, hd=128, page=16, per=6):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = b * per + 2
    shape = (n_pages, page, n_kv, hd)
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand((b, n_kv), generator=g, device="cuda") * 0.04 + 0.01
        vs = torch.rand((b, n_kv), generator=g, device="cuda") * 0.04 + 0.01
    else:
        kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        ks = vs = None
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    bt = perm[:b * per].reshape(b, per).to(torch.int32)
    span = per * page
    lens = torch.tensor([0, span, 37, 1], dtype=torch.int32, device="cuda")
    q0 = torch.clamp(lens - s, min=0).to(torch.int32)
    q = torch.randn((b, s, n_kv * group, hd), generator=g, device="cuda")
    return q, kp, vp, bt, lens, q0, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 8, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("hd", [128, 12])
def test_kernel_matches_plain(cuda, hd, dtype, group, s):
    """Tolerance 1e-4 of max |plain|: f32 sums in another order.  hd 12
    is no multiple of 16 bytes for int8 and bf16 rows, so those pages
    take the kernel's scalar loads; f32 rows of 12 take 16-byte loads,
    three to a row."""
    args = _case(0, dtype=dtype, group=group, s=s, hd=hd)
    before = PA.paged_flash_mq.launches
    out = PA.paged_multiquery_attention(*args)
    assert PA.paged_flash_mq.launches == before + 1
    want = PA.paged_attention_mq_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert float((out - want).abs().max()) <= tol
    assert (out[0] == 0).all()                  # the length-0 row


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 4, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_kernel_matches_plain(cuda, tp, group, s):
    """The sharded form splits heads over ``tp`` shards of the card and
    launches once per shard: tolerance 1e-4 of max |plain| as for the
    kernel itself; the length-0 row is 0."""
    q, kp, vp, bt, lens, q0, ks, vs = _case(1, dtype=torch.int8,
                                            group=group, s=s)
    calls = PA.paged_flash_mq_sharded.calls
    launches = PA.paged_flash_mq_sharded.launches
    out = PA.paged_flash_mq_sharded(q, kp, vp, bt, lens, q0, ks, vs,
                                    mesh=make_serve_mesh(model=tp))
    assert PA.paged_flash_mq_sharded.calls == calls + 1
    assert PA.paged_flash_mq_sharded.launches == launches + tp
    want = PA.paged_attention_mq_ref(q, kp, vp, bt, lens, q0, ks, vs)
    torch.cuda.synchronize()
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert float((out - want).abs().max()) <= tol
    assert (out[0] == 0).all()


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    params = TT.init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, CFG.vocab, n).astype(np.int32)
               for n in (15, 17, 16, 31, 33, 9)]
    kw = dict(cut_layer=0, max_len=48, a_bits=None, edge_int8=False,
              cloud_int8=False)
    cpu = TE.CollaborativeServingEngine(params, CFG, device="cpu", **kw)
    gpu = TE.CollaborativeServingEngine(params, CFG, device="cuda", **kw)
    assert gpu.generate(prompts, max_new_tokens=6) == \
        cpu.generate(prompts, max_new_tokens=6)


@pytest.mark.gpu
def test_spec_engine_on_card_matches_cpu(cuda):
    params = TT.init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, CFG.vocab, n).astype(np.int32)
               for n in (15, 17, 16, 31, 33, 9)]
    kw = dict(cut_layer=0, max_len=48, a_bits=None, edge_int8=False,
              cloud_int8=False, spec_k=4)
    cpu = TE.CollaborativeServingEngine(params, CFG, device="cpu", **kw)
    gpu = TE.CollaborativeServingEngine(params, CFG, device="cuda", **kw)
    assert gpu.generate(prompts, max_new_tokens=6) == \
        cpu.generate(prompts, max_new_tokens=6)
    assert gpu.stats.draft_hits == cpu.stats.draft_hits
    assert gpu.stats.transmitted_bytes == cpu.stats.transmitted_bytes


def _int8_case(m, k, n, seed, per_channel):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand((m, k), generator=g, device="cuda") * 7 - 4
    w = torch.rand((k, n), generator=g, device="cuda") * 1.9 - 0.8
    qa = compute_qparams(a)
    qw = compute_qparams(w, axis=1 if per_channel else None)
    bias = torch.randn((n,), generator=g, device="cuda")
    return quantize(a, qa), quantize(w, qw), qa, qw, bias


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 33])
@pytest.mark.parametrize("k,n", [(65, 17), (300, 96), (4096, 40)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("act", [None, "gelu", "silu"])
def test_int8_kernel_matches_plain(cuda, m, k, n, per_channel, act):
    """Awkward shapes take the kernel's byte loads (K or N not a multiple
    of 16) and its predicated edges; rtol 1e-5, atol 1e-4 as in the JAX
    suite."""
    a_q, w_q, qa, qw, bias = _int8_case(m, k, n, m + k + n, per_channel)
    before = IK.int8_matmul_cuda.launches
    got = OPS.int8_matmul(a_q, w_q, qa, qw, bias=bias, act=act)
    assert IK.int8_matmul_cuda.launches == before + 1
    want = REF.int8_matmul_ref(a_q, w_q, qa, qw, bias=bias, act=act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,signed", [(8, True), (4, True), (4, False)])
@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
def test_int8_kernel_requant_matches_plain(cuda, act, bits, signed):
    """gelu and silu feed the requant too: a multiply-add contracted in
    the activation would move values across rounding ties."""
    a_q, w_q, qa, qw, _ = _int8_case(33, 300, 96, 5, True)
    out_qp = compute_qparams(REF.int8_matmul_ref(a_q, w_q, qa, qw,
                                                 act=act),
                             bits=bits, signed=signed)
    got = OPS.int8_matmul(a_q, w_q, qa, qw, act=act, out_qp=out_qp)
    want = REF.int8_matmul_ref(a_q, w_q, qa, qw, act=act, out_qp=out_qp)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out_qp.storage_dtype
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01


@pytest.mark.gpu
def test_int8_kernel_identity_epilogue_is_exact(cuda):
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randint(-128, 128, (33, 1000), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (1000, 65), generator=g, device="cuda",
                      dtype=torch.int8)
    one = QuantParams(scale=torch.tensor(1.0, device="cuda"),
                      zero_point=torch.tensor(0.0, device="cuda"))
    got = OPS.int8_matmul(a, b, one, one)
    assert torch.equal(got, REF.int8_matmul_ref(a, b, one, one))


@pytest.mark.gpu
@pytest.mark.parametrize("spec_k", [1, 4])
def test_tp_engine_on_card_matches_cpu(cuda, spec_k):
    """The cloud over two shards of the card, lossless: the same stream
    as the CPU's tp = 2 engine and the card's unsharded one."""
    params = TT.init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, CFG.vocab, n).astype(np.int32)
               for n in (15, 17, 16, 31, 33, 9)]
    kw = dict(cut_layer=0, max_len=48, a_bits=None, edge_int8=False,
              cloud_int8=False, spec_k=spec_k)
    outs = [TE.CollaborativeServingEngine(
        params, CFG, device=dev, mesh=mesh, **kw).generate(
            prompts, max_new_tokens=6)
        for dev, mesh in (("cpu", make_serve_mesh(model=2, device="cpu")),
                          ("cuda", make_serve_mesh(model=2)),
                          ("cuda", None))]
    assert outs[1] == outs[0] == outs[2]
