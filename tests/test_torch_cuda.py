"""The port on the card: each CUDA kernel against its plain version (the
paged-attention kernel also in its tensor-parallel form, one launch per
shard), the collaborative engine (serial, speculative, and with its
cloud tensor-parallel over two shards of the card) on CUDA against the
same engine on the CPU, sampled serving on the card (threefry keys,
uniforms and draws equal to the CPU's, sampled streams deterministic
and equal to the CPU's, ``temperature=0`` equal to the greedy stream),
the collaborative image models: AlexNet's, a SMOKE ResNet's and a
SMOKE ViT's engines on the card against the CPU (through
``chip_smoke._cnn_card_vs_cpu``, the check the script's ``cnn_path``
runs), and the CNN and vision layers' f32 products in true f32 with the
caller's TF32 flags left as they were; Eq.(1)'s scale and the INT8 KV
cache's scale on the card equal to the CPU's bit for bit; the online
control loop (a scripted cut switch and warm k raise) and overload
serving (a demand-paged engine preempting under pool pressure) on the
card against the CPU; the tensor-core kernel at the resync replay's
shape, and the resilient engine through drops and outages on the card
against the CPU; the split kernel at the fleet's verify shape with rows
on the dump page, the fleet on the card against the CPU, and the INT8
fleet's streams equal to solo engines on the card.

Marked ``gpu``: each test skips where there is no CUDA device.  This
file imports no JAX, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import collab as TC  # noqa: E402
from repro_torch.core.quant import (QuantParams, compute_qparams,  # noqa: E402
                                    quantize)
from repro_torch.kernels import int8_matmul as IK  # noqa: E402
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models import legacy as TL  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import vit as TV  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import sampling as SS  # noqa: E402

CFG = get_arch("deepseek-7b").smoke
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, *, dtype, group, s, b=4, n_kv=4, hd=128, page=16, per=6,
          lens=None):
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
    lens = torch.tensor([0, span, 37, 1] if lens is None else lens,
                        dtype=torch.int32, device="cuda")
    q0 = torch.clamp(lens - s, min=0).to(torch.int32)
    q = torch.randn((b, s, n_kv * group, hd), generator=g, device="cuda")
    return q, kp, vp, bt, lens, q0, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 4, 8, 16, 17, 33, 64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("hd", [128, 12, 64, 256])
def test_kernel_matches_plain(cuda, hd, dtype, group, s):
    """Tolerance 1e-4 of max |plain|: f32 sums in another order, and on
    the tensor cores bf16 hi + lo operand splits.  S * group <= 16 takes
    the split-KV kernel (96 positions: 3 splits), more rows the
    tensor-core one (q_start > 0 on the full and ragged rows at S 17 and
    33; hd 12 padded to 16, hd 256 in two column blocks).  hd 12 is no
    multiple of 16 bytes for int8 and bf16 rows, so those pages take the
    kernels' scalar loads; f32 rows of 12 take 16-byte loads, three to a
    row."""
    args = _case(0, dtype=dtype, group=group, s=s, hd=hd)
    before = PA.paged_flash_mq.launches
    tc_before = PA.paged_flash_mq.tc_launches
    out = PA.paged_multiquery_attention(*args)
    assert PA.paged_flash_mq.launches == before + 1
    assert PA.paged_flash_mq.tc_launches == tc_before + (s * group > 16)
    want = PA.paged_attention_mq_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert float((out - want).abs().max()) <= tol
    assert (out[0] == 0).all()                  # the length-0 row


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_kernel_matches_plain_long_context(cuda, dtype, group, s):
    """A 4,096-position span (the split kernel's chunk grows past one
    tile, so its ring of stages turns over): tolerance 1e-4 of max
    |plain|; the length-0 row is 0."""
    args = _case(3, dtype=dtype, group=group, s=s, per=256,
                 lens=[0, 4096, 3000, 1024])
    out = PA.paged_flash_mq(*args)
    want = PA.paged_attention_mq_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert float((out - want).abs().max()) <= tol
    assert (out[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 4])
def test_split_kernel_is_repeatable(cuda, s):
    """Two calls in a row give bitwise-equal output: the splits merge in
    a fixed order, and each launch zeroes its own counters (no counter
    buffer outlives a call)."""
    args = _case(4, dtype=torch.int8, group=1, s=s, per=12,
                 lens=[0, 192, 100, 17])
    first = PA.paged_flash_mq(*args)
    second = PA.paged_flash_mq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not hasattr(PA, "_COUNTER_BUFS")


@pytest.mark.gpu
def test_split_kernel_on_two_streams_at_once(cuda):
    """Split launches on two streams of one card at once, over the same
    (b, kv head) pairs with different inputs, many times: each result
    equals its plain version and, bitwise, the same call run alone (each
    call's counters are its own, zeroed on its stream)."""
    cases = [_case(10 + i, dtype=torch.int8, group=1, s=s, per=12,
                   lens=[0, 192, 100, 17]) for i, s in enumerate((1, 4))]
    solo = [PA.paged_flash_mq(*a) for a in cases]
    for a, o in zip(cases, solo):
        want = PA.paged_attention_mq_ref(*a)
        torch.cuda.synchronize()
        tol = 1e-4 * max(float(want.abs().max()), 1.0)
        assert float((o - want).abs().max()) <= tol
    streams = [torch.cuda.Stream() for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[] for _ in cases]
    for _ in range(64):
        for st, a, o in zip(streams, cases, outs):
            with torch.cuda.stream(st):
                o.append(PA.paged_flash_mq(*a))
    torch.cuda.synchronize()
    for ref, o in zip(solo, outs):
        assert all(torch.equal(x, ref) for x in o)


@pytest.mark.gpu
def test_split_kernel_after_a_smaller_grid(cuda):
    """A call over more (b, kv head) pairs after a small one uses
    counters the small one never touched; both match the plain
    version."""
    for b, n_kv in ((1, 2), (6, 8)):
        args = _case(5, dtype=torch.int8, group=1, s=1, b=b, n_kv=n_kv,
                     per=12, lens=[192, 0, 100, 17, 33, 160][:b])
        out = PA.paged_flash_mq(*args)
        want = PA.paged_attention_mq_ref(*args)
        torch.cuda.synchronize()
        tol = 1e-4 * max(float(want.abs().max()), 1.0)
        assert float((out - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("s,group", [(1, 1), (4, 1), (1, 4), (4, 4)])
def test_split_kernel_matches_tiled_kernel(cuda, s, group):
    """The split kernel against the first port's tiled kernel on the same
    inputs: within 1e-4 of max |tiled|."""
    args = _case(6, dtype=torch.int8, group=group, s=s, per=12,
                 lens=[0, 192, 100, 17])
    before = PA.paged_flash_mq_tiled.launches
    tiled = PA.paged_flash_mq_tiled(*args)
    assert PA.paged_flash_mq_tiled.launches == before + 1
    split = PA.paged_flash_mq(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * max(float(tiled.abs().max()), 1.0)
    assert float((split - tiled).abs().max()) <= tol


@pytest.mark.gpu
def test_split_kernel_replays_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph (workspace and counters from the graph's
    pool, the counters' zeroing captured with the launch), each replay
    equals the eager call."""
    args = _case(7, dtype=torch.int8, group=1, s=1, per=12,
                 lens=[0, 192, 100, 17])
    eager = PA.paged_flash_mq(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = PA.paged_flash_mq(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("s,group", [(17, 1), (128, 1), (33, 4), (128, 4)])
def test_tc_kernel_matches_tiled_kernel(cuda, s, group, dtype):
    """The tensor-core kernel (through ``paged_flash_mq``, one launch)
    against the first port's tiled kernel on the same inputs: within
    1e-4 of max |tiled|; the length-0 row is 0 in both."""
    args = _case(8, dtype=dtype, group=group, s=s, per=12,
                 lens=[0, 192, 100, 17])
    before = PA.paged_flash_mq.tc_launches
    tc = PA.paged_flash_mq(*args)
    assert PA.paged_flash_mq.tc_launches == before + 1
    tiled = PA.paged_flash_mq_tiled(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * max(float(tiled.abs().max()), 1.0)
    assert float((tc - tiled).abs().max()) <= tol
    assert (tc[0] == 0).all() and (tiled[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_tc_kernel_is_repeatable(cuda, dtype):
    """Two calls of the tensor-core kernel give bitwise-equal output."""
    args = _case(9, dtype=dtype, group=4, s=128, per=12,
                 lens=[0, 192, 100, 17])
    first = PA.paged_flash_mq(*args)
    second = PA.paged_flash_mq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_tc_kernel_replays_in_a_cuda_graph(cuda):
    """The tensor-core kernel captured in a CUDA graph: each replay
    equals the eager call."""
    args = _case(11, dtype=torch.bfloat16, group=1, s=128, per=12,
                 lens=[0, 192, 100, 17])
    eager = PA.paged_flash_mq(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = PA.paged_flash_mq(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 4, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_kernel_matches_plain(cuda, tp, group, s):
    """The sharded form splits heads over ``tp`` shards of the card and
    launches once per shard (S 128: the tensor-core kernel per shard):
    tolerance 1e-4 of max |plain| as for the kernel itself; the length-0
    row is 0."""
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


@pytest.mark.gpu
def test_sampling_draws_on_card_equal_cpu(cuda):
    """Threefry keys, random bits, uniforms and categorical draws at
    deepseek-7b's vocabulary: the card's equal the CPU's bit for bit."""
    rng = np.random.RandomState(0)
    seeds = torch.tensor(rng.randint(0, 2 ** 31 - 1, 4096))
    idx = torch.tensor(rng.randint(0, 1 << 20, 4096))
    for stream in (SS.DRAFT, SS.ACCEPT, SS.RESID, SS.CLOUD):
        kc = SS.token_keys(seeds, idx, stream)
        kg = SS.token_keys(seeds.to(cuda), idx.to(cuda), stream)
        assert torch.equal(kg.cpu(), kc)
        assert torch.equal(SS.uniform_rows(kg).cpu().view(torch.int32),
                           SS.uniform_rows(kc).view(torch.int32))
    vocab = 102400
    assert torch.equal(SS._random_bits(kg[:16], vocab).cpu(),
                       SS._random_bits(kc[:16], vocab))
    logits = torch.tensor(rng.randn(16, vocab).astype(np.float32) * 3)
    p = SS.filtered_probs(logits, torch.full((16,), 0.8),
                          torch.full((16,), 0.9))
    assert torch.equal(SS.sample_rows(p.to(cuda), kg[:16]).cpu(),
                       SS.sample_rows(p, kc[:16]))


def _sampled_engine(params, device, k, **kw):
    return TE.CollaborativeServingEngine(params, CFG, device=device,
                                         cut_layer=0, max_len=48, spec_k=k,
                                         **kw)


_SAMPLED_PROMPTS = [np.random.RandomState(2).randint(0, CFG.vocab, n)
                    .astype(np.int32) for n in (15, 17, 16, 31, 33, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_sampled_engine_on_card_is_deterministic(cuda, k):
    """Two fresh INT8 engines on the card draw the same streams, and a
    lossless one draws the CPU engine's."""
    params = TT.init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")
    samps = [SS.SamplingParams(temperature=0.8, top_p=0.9, seed=i)
             for i in range(len(_SAMPLED_PROMPTS))]
    a, b = (_sampled_engine(params, "cuda", k).generate(
        _SAMPLED_PROMPTS, max_new_tokens=6, sampling=samps)
        for _ in range(2))
    assert a == b
    lossless = dict(a_bits=None, edge_int8=False, cloud_int8=False)
    assert _sampled_engine(params, "cuda", k, **lossless).generate(
        _SAMPLED_PROMPTS, max_new_tokens=6, sampling=samps) == \
        _sampled_engine(params, "cpu", k, **lossless).generate(
            _SAMPLED_PROMPTS, max_new_tokens=6, sampling=samps)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_temperature0_on_card_is_the_greedy_stream(cuda, k):
    params = TT.init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")
    eng = _sampled_engine(params, "cuda", k)
    greedy = eng.generate(_SAMPLED_PROMPTS, max_new_tokens=6)
    assert eng.generate(_SAMPLED_PROMPTS, max_new_tokens=6,
                        sampling=SS.SamplingParams(temperature=0.0,
                                                   seed=5)) == greedy


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


def _sk_operands(m, k, n, seed, per_channel=True):
    """Random int8 operands and f32 epilogue tensors in the kernels' own
    layout: za, zb non-zero, so every correction term is exercised."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    if per_channel:
        sb = torch.rand((n,), generator=g, device="cuda") * 1e-3 + 1e-4
        zb = torch.randint(-6, 7, (n,), generator=g, device="cuda").float()
    else:
        sb = torch.full((n,), 5e-4, device="cuda")
        zb = torch.full((n,), 2.0, device="cuda")
    sa = torch.tensor([0.02], device="cuda")
    za = torch.tensor([3.0], device="cuda")
    bias = torch.randn((n,), generator=g, device="cuda")
    qa = QuantParams(scale=sa[0], zero_point=za[0])
    qb = QuantParams(scale=sb, zero_point=zb, axis=1)
    return a, b, sa, za, sb, zb, bias, qa, qb


def _requant(plain_f32, out_dtype):
    """(so, zo, qmin, qmax, out_qp) of a requant to ``out_dtype``."""
    bits, signed = {torch.int8: (8, True), torch.uint8: (8, False),
                    torch.int16: (16, True)}[out_dtype]
    qp = compute_qparams(plain_f32, bits=bits, signed=signed)
    return (qp.scale.reshape(1).float(), qp.zero_point.reshape(1).float(),
            qp.qmin, qp.qmax, qp)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 4, 16, 32])
@pytest.mark.parametrize("k", [300, 4096, 11008])
@pytest.mark.parametrize("n", [96, 4100, 11008])
def test_splitk_kernel_matches_plain_and_tiled(cuda, m, k, n):
    """The front door at M <= 32 launches the split-K kernel (its cluster
    merge, ring and byte-load paths: K 300 and N 4100 are not multiples
    of 16), which equals the plain version to rtol 1e-5, atol 1e-4 and the
    tiled kernel bit for bit: both run one epilogue on exact sums."""
    a, b, sa, za, sb, zb, bias, qa, qb = _sk_operands(m, k, n, m * k + n)
    before = (IK.int8_matmul_cuda.launches,
              IK.int8_matmul_cuda.splitk_launches)
    got = IK.int8_matmul_cuda(a, b, sa, za, sb, zb, bias)
    assert (IK.int8_matmul_cuda.launches,
            IK.int8_matmul_cuda.splitk_launches) == (before[0] + 1,
                                                     before[1] + 1)
    tiled = IK.int8_matmul_tiled(a, b, sa, za, sb, zb, bias)
    want = REF.int8_matmul_ref(a, b, qa, qb, bias=bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, tiled)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int8,
                                       torch.uint8, torch.int16])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_splitk_kernel_epilogues(cuda, act, out_dtype, per_channel):
    """Every activation and requant type, per-tensor and per-channel
    weight scales, with bias: bitwise equal to the tiled kernel; f32
    within 1e-4 of the plain version, integer outputs within one lattice
    step in under 1 % of elements (the plain version rounds its f32
    epilogue in other places)."""
    m, k, n = 4, 4096, 4100
    a, b, sa, za, sb, zb, bias, qa, qb = _sk_operands(
        m, k, n, 11 + per_channel, per_channel)
    kw = dict(act=act, out_dtype=out_dtype)
    ref_kw = dict(bias=bias, act=act)
    if out_dtype != torch.float32:
        so, zo, qmin, qmax, qp = _requant(
            REF.int8_matmul_ref(a, b, qa, qb, **ref_kw), out_dtype)
        kw.update(so=so, zo=zo, qmin=qmin, qmax=qmax)
        ref_kw["out_qp"] = qp
    got = IK.int8_matmul_splitk(a, b, sa, za, sb, zb, bias, **kw)
    tiled = IK.int8_matmul_tiled(a, b, sa, za, sb, zb, bias, **kw)
    want = REF.int8_matmul_ref(a, b, qa, qb, **ref_kw)
    torch.cuda.synchronize()
    assert got.dtype == tiled.dtype == want.dtype == out_dtype
    assert torch.equal(got, tiled)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 16, 32])
def test_splitk_identity_epilogue_is_the_int32_product(cuda, m):
    g = torch.Generator(device="cuda").manual_seed(m)
    a = torch.randint(-128, 128, (m, 4096), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (4096, 4100), generator=g, device="cuda",
                      dtype=torch.int8)
    one = torch.ones(1, device="cuda")
    zero = torch.zeros(1, device="cuda")
    got = IK.int8_matmul_splitk(a, b, one, zero, one.expand(4100).contiguous(),
                                zero.expand(4100).contiguous())
    want = (a.double() @ b.double()).float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, 100, 127])
@pytest.mark.parametrize("n", [96, 4100])
def test_splitk_kernel_with_k_below_one_stage(cuda, k, n):
    """K shorter than one 128-deep stage: one CTA a cluster, one
    partial stage, zero-filled past K."""
    a, b, sa, za, sb, zb, bias, qa, qb = _sk_operands(4, k, n, k + n)
    assert IK._plan_splitk(4, k, n)[:2] == (1, 128)
    got = IK.int8_matmul_cuda(a, b, sa, za, sb, zb, bias, act="silu")
    tiled = IK.int8_matmul_tiled(a, b, sa, za, sb, zb, bias, act="silu")
    want = REF.int8_matmul_ref(a, b, qa, qb, bias=bias, act="silu")
    torch.cuda.synchronize()
    assert torch.equal(got, tiled)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 7, 8])
@pytest.mark.parametrize("m", [4, 17, 32])
def test_splitk_kernel_at_any_cluster_size(cuda, cluster, m):
    """Every cluster size the plan may take, and M past one 16-row
    fragment: the merge is exact, so the output never moves."""
    a, b, sa, za, sb, zb, bias, _, _ = _sk_operands(m, 4096, 4100, cluster)
    assert IK._plan_splitk(m, 4096, 4100, cluster)[0] == cluster
    got = IK.int8_matmul_splitk(a, b, sa, za, sb, zb, bias, act="gelu",
                                cluster=cluster)
    tiled = IK.int8_matmul_tiled(a, b, sa, za, sb, zb, bias, act="gelu")
    torch.cuda.synchronize()
    assert torch.equal(got, tiled)


@pytest.mark.gpu
def test_splitk_shared_memory_matches_the_plan(cuda):
    """The CUDA source's shared-memory layout and the Python mirror that
    the plan sizes launches by."""
    fn = IK._build.load("int8_matmul").int8_matmul_splitk_smem_bytes
    for m in (1, 4, 16, 17, 32):
        for slice_k in (128, 256, 512, 1408, 12160):
            assert fn(m, slice_k) == IK._splitk_smem_bytes(m, slice_k)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 16])
def test_splitk_kernel_replays_in_a_cuda_graph(cuda, m):
    """Captured with no eager call before (M 16 needs more than 48 KB of
    shared memory, so the capture also sets the kernel's limit), then
    replayed: the output equals an eager launch."""
    a, b, sa, za, sb, zb, bias, _, _ = _sk_operands(m, 4096, 11008, 40 + m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = IK.int8_matmul_cuda(a, b, sa, za, sb, zb, bias, act="relu")
    for _ in range(2):
        graph.replay()
    eager = IK.int8_matmul_cuda(a, b, sa, za, sb, zb, bias, act="relu")
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
def test_splitk_kernel_on_two_streams_at_once(cuda):
    """Launches on two streams share nothing (no workspace, no counter):
    each output equals the same call made alone."""
    cases = [_sk_operands(m, k, n, 50 + m)
             for m, k, n in ((4, 11008, 4096), (16, 4096, 11008))]
    solo = [IK.int8_matmul_cuda(*c[:7]) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    outs = []
    for _ in range(3):
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        step = []
        for st, c in zip(streams, cases):
            with torch.cuda.stream(st):
                step.append(IK.int8_matmul_cuda(*c[:7]))
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        outs.append(step)
    torch.cuda.synchronize()
    for step in outs:
        assert all(torch.equal(x, y) for x, y in zip(step, solo))


def _wg_counts():
    return (IK.int8_matmul_cuda.launches, IK.int8_matmul_cuda.wgmma_launches,
            IK.int8_matmul_cuda.pack_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [33, 64, 65, 128, 129, 512, 1000])
@pytest.mark.parametrize("k", [16, 128, 144, 4096, 11008])
@pytest.mark.parametrize("n", [8, 40, 96, 4100, 11008])
def test_wgmma_kernel_matches_plain_and_tiled(cuda, m, k, n):
    """The front door at M > 32 on a packed weight launches the wgmma
    kernel once and packs nothing; it equals the plain version to rtol
    1e-5, atol 1e-4 and the tiled kernel bit for bit (one epilogue on
    exact sums), at ragged M, N and K (TMA's zero fill past the edges;
    K 16 and 144 end inside one 128-deep stage)."""
    a, b, sa, za, sb, zb, bias, qa, qb = _sk_operands(m, k, n, m * k + n)
    packed = IK.pack_int8_weight(b)
    before = _wg_counts()
    got = IK.int8_matmul_cuda(a, packed, sa, za, sb, zb, bias)
    assert _wg_counts() == (before[0] + 1, before[1] + 1, before[2])
    tiled = IK.int8_matmul_tiled(a, b, sa, za, sb, zb, bias)
    want = REF.int8_matmul_ref(a, b, qa, qb, bias=bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, tiled)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int8,
                                       torch.uint8, torch.int16])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("n", [4100, 4099])
def test_wgmma_kernel_epilogues(cuda, act, out_dtype, per_channel, n):
    """Every activation and requant type, per-tensor and per-channel
    weight scales, with bias, stored in pairs (N even) and one by one (N
    odd): bitwise equal to the tiled kernel; f32 within 1e-4 of the plain
    version, integer outputs within one lattice step in under 1 % of
    elements."""
    m, k = 512, 4096
    a, b, sa, za, sb, zb, bias, qa, qb = _sk_operands(
        m, k, n, 21 + per_channel, per_channel)
    kw = dict(act=act, out_dtype=out_dtype)
    ref_kw = dict(bias=bias, act=act)
    if out_dtype != torch.float32:
        so, zo, qmin, qmax, qp = _requant(
            REF.int8_matmul_ref(a, b, qa, qb, **ref_kw), out_dtype)
        kw.update(so=so, zo=zo, qmin=qmin, qmax=qmax)
        ref_kw["out_qp"] = qp
    got = IK.int8_matmul_wgmma(a, IK.pack_int8_weight(b), sa, za, sb, zb,
                               bias, **kw)
    tiled = IK.int8_matmul_tiled(a, b, sa, za, sb, zb, bias, **kw)
    want = REF.int8_matmul_ref(a, b, qa, qb, **ref_kw)
    torch.cuda.synchronize()
    assert got.dtype == tiled.dtype == want.dtype == out_dtype
    assert torch.equal(got, tiled)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(33, 4096, 4100), (512, 4096, 11008)])
def test_wgmma_kernel_on_an_unpacked_weight(cuda, m, k, n):
    """A plain [K, N] weight at M > 32 is packed for the call (one pack
    launch) and goes to the same kernel: one GEMM launch, the same output
    as on the packed weight."""
    a, b, sa, za, sb, zb, bias, _, _ = _sk_operands(m, k, n, 60 + m)
    packed_out = IK.int8_matmul_cuda(a, IK.pack_int8_weight(b), sa, za, sb,
                                     zb, bias, act="gelu")
    before = _wg_counts()
    got = IK.int8_matmul_cuda(a, b, sa, za, sb, zb, bias, act="gelu")
    assert _wg_counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, packed_out)


@pytest.mark.gpu
def test_front_door_keeps_the_tiled_kernel_where_wgmma_cannot(cuda):
    """K not a multiple of 16, or A starting off a 16-byte boundary: the
    tiled kernel, one launch, no pack, equal to the plain version."""
    for k, offset in ((300, 0), (4096, 1)):
        a0, b, sa, za, sb, zb, bias, qa, qb = _sk_operands(64, k, 96, k)
        buf = torch.empty(64 * k + offset, dtype=torch.int8, device="cuda")
        a = buf[offset:].view(64, k)
        a.copy_(a0)
        assert IK._design(64, k, a.data_ptr(), None) == "tiled"
        before = _wg_counts()
        got = OPS.int8_matmul(a, b, qa, qb, bias=bias)
        assert _wg_counts() == (before[0] + 1, before[1], before[2])
        want = REF.int8_matmul_ref(a0, b, qa, qb, bias=bias)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [128, 192])
@pytest.mark.parametrize("persistent", [True, False])
def test_wgmma_kernel_at_every_plan(cuda, bn, persistent):
    """Both tile widths, a persistent grid (CTAs walking up to 3 tiles)
    and one CTA per tile: the output never moves."""
    a, b, sa, za, sb, zb, bias, _, _ = _sk_operands(1000, 4096, 11008, bn)
    packed = IK.pack_int8_weight(b)
    plan = IK._plan_wgmma(1000, 4096, 11008, bn, persistent)
    assert plan[0] == bn
    got = IK.int8_matmul_wgmma(a, packed, sa, za, sb, zb, bias, act="silu",
                               bn=bn, persistent=persistent)
    tiled = IK.int8_matmul_tiled(a, b, sa, za, sb, zb, bias, act="silu")
    torch.cuda.synchronize()
    assert torch.equal(got, tiled)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [33, 512])
def test_wgmma_identity_epilogue_is_the_int32_product(cuda, m):
    g = torch.Generator(device="cuda").manual_seed(m)
    a = torch.randint(-128, 128, (m, 4096), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (4096, 4100), generator=g, device="cuda",
                      dtype=torch.int8)
    one = torch.ones(1, device="cuda")
    zero = torch.zeros(1, device="cuda")
    got = IK.int8_matmul_cuda(a, IK.pack_int8_weight(b), one, zero,
                              one.expand(4100).contiguous(),
                              zero.expand(4100).contiguous())
    want = (a.double() @ b.double()).float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_wgmma_kernel_is_repeatable(cuda):
    a, b, sa, za, sb, zb, bias, _, _ = _sk_operands(512, 11008, 4096, 70)
    packed = IK.pack_int8_weight(b)
    outs = [IK.int8_matmul_cuda(a, packed, sa, za, sb, zb, bias, act="relu")
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [True, False])
def test_wgmma_kernel_replays_in_a_cuda_graph(cuda, packed):
    """Captured with no eager call before (the capture encodes the call's
    tensor maps and sets the kernel's shared-memory limit; an unpacked
    weight captures the pack launch too), then replayed: the output
    equals an eager launch."""
    a, b, sa, za, sb, zb, bias, _, _ = _sk_operands(512, 4096, 11008,
                                                    80 + packed)
    w = IK.pack_int8_weight(b) if packed else b
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = IK.int8_matmul_cuda(a, w, sa, za, sb, zb, bias, act="gelu")
    for _ in range(2):
        graph.replay()
    eager = IK.int8_matmul_cuda(a, w, sa, za, sb, zb, bias, act="gelu")
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
def test_wgmma_kernel_on_two_streams_at_once(cuda):
    """Launches on two streams share nothing (each call's own tensor maps,
    no workspace): each output equals the same call made alone."""
    cases = [_sk_operands(m, k, n, 90 + m)
             for m, k, n in ((512, 11008, 4096), (256, 4096, 11008))]
    packed = [IK.pack_int8_weight(c[1]) for c in cases]
    solo = [IK.int8_matmul_cuda(c[0], p, *c[2:7])
            for c, p in zip(cases, packed)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    outs = []
    for _ in range(3):
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        step = []
        for st, c, p in zip(streams, cases, packed):
            with torch.cuda.stream(st):
                step.append(IK.int8_matmul_cuda(c[0], p, *c[2:7]))
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        outs.append(step)
    torch.cuda.synchronize()
    for step in outs:
        assert all(torch.equal(x, y) for x, y in zip(step, solo))


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(1, 1), (16, 8), (17, 33), (300, 40),
                                 (128, 4100), (4096, 4096), (4096, 11008),
                                 (11008, 4096), (4100, 4099)])
def test_pack_kernel_matches_plain(cuda, k, n):
    """One pack launch: the [N, K] copy and the int32 colsum exactly equal
    the plain version's, on the vector path and the byte path."""
    g = torch.Generator(device="cuda").manual_seed(k + n)
    w = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    before = IK.pack_int8_weight_cuda.launches
    p = IK.pack_int8_weight(w)
    assert IK.pack_int8_weight_cuda.launches == before + 1
    nk, colsum = REF.pack_int8_weight_ref(w)
    torch.cuda.synchronize()
    assert p.kn is w and p.nk.is_contiguous()
    assert torch.equal(p.nk, nk) and torch.equal(p.colsum, colsum)


@pytest.mark.gpu
def test_wgmma_shared_memory_matches_the_plan(cuda):
    """The CUDA source's shared-memory size and the Python mirror."""
    fn = IK._build.load("int8_matmul_sm90").int8_matmul_wgmma_smem_bytes
    for bn in IK._WG_BNS:
        assert fn(bn) == IK._wgmma_smem_bytes(bn) <= IK._SK_MAX_SMEM


@pytest.mark.gpu
def test_quantized_dense_on_a_packed_weight_on_card(cuda):
    """The front door on a packed weight at prefill-sized M: one GEMM
    launch, one wgmma launch, no pack; equal to the plain version."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((4, 128, 512), generator=g, device="cuda")
    w = torch.randn((512, 1024), generator=g, device="cuda")
    qx, qw = compute_qparams(x), compute_qparams(w, axis=1)
    w_q = quantize(w, qw)
    packed = IK.pack_int8_weight(w_q)
    before = _wg_counts()
    got = OPS.quantized_dense(x, packed, qx, qw, act="silu")
    assert _wg_counts() == (before[0] + 1, before[1] + 1, before[2])
    want = REF.quantized_dense_ref(x, w_q, qx, qw, act="silu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


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


@pytest.mark.gpu
@pytest.mark.parametrize("tf32", [True, False])
def test_cnn_layers_on_card_are_true_f32_and_restore_tf32(cuda, tf32,
                                                          monkeypatch):
    """``conv2d`` and ``cnn_dense`` on the card with the caller's TF32 flags
    on or off: each product within 1e-5 of max |f64 CPU| (TF32's 10-bit
    mantissa would be ~1e-3 off), and the flags as the caller left
    them."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    monkeypatch.setattr(mm, "allow_tf32", tf32)
    monkeypatch.setattr(cudnn, "allow_tf32", tf32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 27, 27, 96, generator=g)
    conv = {"w": torch.randn(5, 5, 96, 256, generator=g) * 0.05,
            "b": torch.randn(256, generator=g)}
    fc = {"w": torch.randn(4096, 1000, generator=g) * 0.02,
          "b": torch.randn(1000, generator=g)}
    h = torch.randn(8, 4096, generator=g)
    for fn, p, inp in ((TLY.conv2d, conv, x), (TLY.cnn_dense, fc, h)):
        want = fn(tree_map(lambda t: t.double(), p), inp.double(),
                  act="relu")
        got = fn(tree_map(lambda t: t.cuda(), p), inp.cuda(), act="relu")
        assert (mm.allow_tf32, cudnn.allow_tf32) == (tf32, tf32)
        err = (got.cpu().double() - want).abs().max() / want.abs().max()
        assert err < 1e-5, (fn.__name__, float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("tf32", [True, False])
def test_vision_layers_on_card_are_true_f32_and_restore_tf32(cuda, tf32,
                                                             monkeypatch):
    """ViT's patch embedding, a block (both of ``_sdpa``'s products and
    the MLP) and its head, and ResNet's head, on the card with the
    caller's TF32 flags on or off: within 1e-5 of max |f64 CPU|, and the
    flags as the caller left them."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    monkeypatch.setattr(mm, "allow_tf32", tf32)
    monkeypatch.setattr(cudnn, "allow_tf32", tf32)
    vcfg = dataclasses.replace(get_arch("vit-s16").full, n_layers=1,
                               dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    vp = TV.init_vit(g, vcfg, device="cpu")
    for k in ("ln1", "ln2"):
        vp["blocks"][k]["b"] += 0.1
    rp = TR.init_resnet(g, get_arch("resnet-18").full, device="cpu")["head"]
    rp["b"] += torch.randn(rp["b"].shape, generator=g)
    on_card = TV.make_segments(tree_map(lambda t: t.cuda(), vp), vcfg)
    in_f64 = TV.make_segments(tree_map(lambda t: t.double(), vp),
                              dataclasses.replace(vcfg, dtype=torch.float64))

    def check(seg, seg64, x):
        want = seg64.apply(seg64.params, x.double())
        got = seg.apply(seg.params, x.cuda())
        assert (mm.allow_tf32, cudnn.allow_tf32) == (tf32, tf32)
        err = (got.cpu().double() - want).abs().max() / want.abs().max()
        assert err < 1e-5, (seg.name, float(err))
        return want.float()

    x = torch.rand(4, 224, 224, 3, generator=g)
    for seg, seg64 in zip(on_card.segments, in_f64.segments):
        x = check(seg, seg64, x)                 # patch, the block, head
    head = TC.Segment("resnet head", TR._head, tree_map(torch.Tensor.cuda,
                                                        rp))
    check(head, TC.Segment("f64", TR._head, tree_map(torch.Tensor.double,
                                                     rp)),
          torch.randn(4, 7, 7, 512, generator=g))


@pytest.mark.gpu
@pytest.mark.parametrize("cut", ["conv2", "conv5"])
def test_alexnet_engine_on_card_matches_cpu(cuda, cut):
    """AlexNet's collaborative engine, the same weights and calibration
    batches on the card and on the CPU, each device calibrating its own,
    checked by ``chip_smoke._cnn_card_vs_cpu`` (its docstring lists the
    checks and the bounds beside them: blob, download bytes and zero
    points equal; scales to rtol 1e-4; the fp32 model within 1e-4 of max
    |CPU|; the boundary lattice of one float tensor equal; the last edge
    segment's lattices, teacher-forced one by one, at most one step apart
    on at most 5 % of elements — end to end each static lattice of the
    edge passes a flipped step on, two steps at ``conv5``; the segment's
    float output and the INT8 outputs to relative L2 0.05)."""
    params = TL.init_alexnet(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    calib = [torch.tensor(rng.rand(4, 227, 227, 3).astype(np.float32))
             for _ in range(2)]
    x = torch.tensor(rng.rand(2, 227, 227, 3).astype(np.float32))
    model = TL.alexnet_segments(tree_map(lambda t: t.cuda(), params))
    _chip_smoke()._cnn_card_vs_cpu(model, cut, [c.cuda() for c in calib],
                                   x.cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cut", [("resnet-152", "s2b0/body"),
                                      ("resnet-18", "head"),
                                      ("vit-s16", "blk1/ffn"),
                                      ("deit-b", "blk1/ffn")])
def test_vision_engine_on_card_matches_cpu(cuda, arch, cut):
    """A SMOKE ResNet's and ViT's collaborative engine on the card
    against the CPU, teacher-forced at the last edge segment, by the
    check AlexNet's test and ``chip_smoke.py``'s ``cnn_path`` run
    (``chip_smoke._cnn_card_vs_cpu``); the ViT edges have two blocks
    under one set of calibration names."""
    cfg = get_arch(arch).smoke
    mod, init = ((TR, TR.init_resnet) if arch.startswith("resnet")
                 else (TV, TV.init_vit))
    params = init(torch.Generator().manual_seed(1), cfg, device="cpu")
    model = mod.make_segments(tree_map(lambda t: t.cuda(), params), cfg)
    rng = np.random.RandomState(1)
    calib = [torch.tensor(rng.rand(4, cfg.img_res, cfg.img_res,
                                   3).astype(np.float32)).cuda()
             for _ in range(2)]
    x = torch.tensor(rng.rand(3, cfg.img_res, cfg.img_res,
                              3).astype(np.float32)).cuda()
    res = _chip_smoke()._cnn_card_vs_cpu(model, cut, calib, x)
    if arch.startswith(("vit", "deit")):
        assert res["act_scale_names"] == 7


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_eq1_scale_on_card_equals_cpu(cuda, bits):
    """The same spans give the same Eq.(1) scale and zero point on the
    card and on the CPU, per row and per tensor."""
    rng = np.random.RandomState(bits)
    x = torch.tensor((rng.randn(4096, 96)
                      * rng.lognormal(0.0, 3.0, (4096, 1))).astype(np.float32))
    for axis in (0, None):
        c = compute_qparams(x, axis=axis, bits=bits)
        g = compute_qparams(x.cuda(), axis=axis, bits=bits)
        assert torch.equal(g.scale.cpu(), c.scale)
        assert torch.equal(g.zero_point.cpu(), c.zero_point)
        assert torch.equal(quantize(x.cuda(), g).cpu(), quantize(x, c))


@pytest.mark.gpu
def test_control_loop_and_preemption_on_card_match_cpu(cuda):
    """``chip_smoke._control_parity`` (the check the script's
    ``path_parity_control`` runs) on a 3-layer SMOKE model: a scripted
    warm k raise, drained cut switch, k drop and warm raise, and a
    demand-paged engine preempting under a pool squeeze, each equal to
    its fixed-cut or worst-case twin on each device; here also every
    stream and counter of the card equal to the CPU's."""
    cfg = dataclasses.replace(CFG, n_layers=3, dtype=torch.float32)
    res = _chip_smoke()._control_parity(cfg)
    assert all(res["card_equals_cpu"].values())
    for tag in ("fixed", "scripted", "worst_case", "demand"):
        assert res["stats"][f"{tag}_cuda"] == res["stats"][f"{tag}_cpu"]
    assert res["stats"]["demand_cuda"]["preemptions"] >= 1


@pytest.mark.gpu
def test_kv_scale_on_card_equals_cpu(cuda):
    """The INT8 KV pages' calibrated scale (``layers._kv_scale``, the
    product with f32 ``1/127`` that jitted JAX takes): the card's equal
    to the CPU's bit for bit on 200,000 f32 ``amax`` values, and on
    bf16 ones."""
    rng = np.random.RandomState(127)
    amax = torch.tensor(np.abs(rng.randn(200_000)
                               * rng.lognormal(0.0, 3.0, 200_000)
                               ).astype(np.float32))
    assert torch.equal(TLY._kv_scale(amax.cuda()).cpu(),
                       TLY._kv_scale(amax))
    a16 = amax[:4096].to(torch.bfloat16)
    assert torch.equal(TLY._kv_scale(a16.cuda()).cpu(), TLY._kv_scale(a16))


@pytest.mark.gpu
def test_tc_kernel_at_the_resync_replay_shape(cuda):
    """The resilient engine's resync replay at deepseek-7b's widths: 4
    rows of 24 buffered positions (32 query and kv heads, hd 128, int8
    pages), three from their own resume positions 100-140 — the
    tensor-core kernel with a per-row q_start > 0 — and one riding along
    at position 0 on a zeroed block-table row (the dump page): against
    the plain version within ``KERNEL_TOL`` of max |plain|."""
    q_start = [100, 124, 140, 0]
    args = list(_case(11, dtype=torch.int8, group=1, s=24, n_kv=32,
                      per=12, lens=[s_ + 24 for s_ in q_start]))
    args[5] = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    args[3][3] = 0
    tc_before = PA.paged_flash_mq.tc_launches
    out = PA.paged_multiquery_attention(*args)
    assert PA.paged_flash_mq.tc_launches == tc_before + 1
    want = PA.paged_attention_mq_ref(*args)
    torch.cuda.synchronize()
    tol = _chip_smoke().KERNEL_TOL * max(float(want.abs().max()), 1.0)
    assert float((out - want).abs().max()) <= tol
    assert torch.isfinite(out).all()


@pytest.mark.gpu
def test_resilient_engine_on_card_matches_cpu(cuda):
    """``chip_smoke._resilient_parity`` (the check the script's
    ``path_parity_resilient`` runs) on a 3-layer SMOKE model, lossless,
    through drops and two outages: at spec_k = 1 and 4, and sampled at
    k = 1, each resilient stream equal to the fault-free one on each
    device; here also every stream and counter of the card equal to the
    CPU's."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(CFG, n_layers=3, dtype=torch.float32)
    res = cs._resilient_parity(cfg, outages=cs.PARITY_OUTAGES_SMOKE)
    assert all(res["card_equals_cpu"].values())
    assert all(res["counters_card_equal_cpu"].values())
    for tag in ("k1", "k4", "k1_sampled"):
        assert res["stats"][f"{tag}_cuda"]["resyncs"] >= 1


@pytest.mark.gpu
def test_split_kernel_with_rows_on_the_dump_page(cuda):
    """The fleet's verify shape at deepseek-7b's widths: 8 rows of 4
    query positions (32 query and kv heads, hd 128, int8 pages), half of
    them riding along on zeroed block-table rows (the dump page, as
    ``_PagedPool.table_for`` gives them) — the split kernel, against the
    plain version within ``KERNEL_TOL`` of max |plain|, every value
    finite."""
    lens = [164, 100, 131, 36, 150, 140, 60, 170]
    args = list(_case(12, dtype=torch.int8, group=1, s=4, b=8, n_kv=32,
                      per=12, lens=lens))
    args[3][1::2] = 0
    launches, tc_before = PA.paged_flash_mq.launches, \
        PA.paged_flash_mq.tc_launches
    out = PA.paged_multiquery_attention(*args)
    assert PA.paged_flash_mq.launches == launches + 1
    assert PA.paged_flash_mq.tc_launches == tc_before
    want = PA.paged_attention_mq_ref(*args)
    torch.cuda.synchronize()
    tol = _chip_smoke().KERNEL_TOL * max(float(want.abs().max()), 1.0)
    assert float((out - want).abs().max()) <= tol
    assert torch.isfinite(out).all()


@pytest.mark.gpu
def test_fleet_on_card_matches_cpu(cuda):
    """``chip_smoke._fleet_parity`` (the check the script's
    ``path_parity_fleet`` runs) on a 3-layer SMOKE model, lossless: four
    tenants at two cuts and two draft lengths, one through drops and an
    outage, each fleet stream equal to its solo engine's at the fleet's
    batch shape on each device, every cache finite; here also every
    stream and counter of the card equal to the CPU's."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(CFG, n_layers=3, dtype=torch.float32)
    res = cs._fleet_parity(cfg, outages=cs.FLEET_PARITY_OUTAGES_SMOKE)
    assert all(res["card_equals_cpu"].values())
    assert res["checks"]["card_vs_cpu"]["counts_k1_and_storm"]
    assert len(res["checks"]["card_vs_cpu"][
        "counters_where_streams_equal"]) == 4
    assert res["round_calls"]["cuda"] == res["round_calls"]["cpu"]


@pytest.mark.gpu
def test_int8_fleet_on_card_streams_equal_solo(cuda):
    """The per-row-ranges invariant on the card: the INT8 default fleet
    (per-row Eq.(1) ranges, per-slot KV scales) on a 3-layer SMOKE
    model, each tenant's stream equal to its solo engine's at the
    fleet's batch shape, every budget filled, every page back, every
    cache finite."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(CFG, n_layers=3, dtype=torch.float32)
    params = TT.init_lm(cfg, torch.Generator(device="cuda").manual_seed(5),
                        device="cuda")
    prompts = cs._fleet_prompts(cs.FLEET_TENANTS, cfg.vocab,
                                lens=cs.FLEET_PARITY_LENS)
    run, solo = cs._fleet_parity_runs(params, cfg, "cuda", prompts,
                                      cs.FLEET_PARITY_OUTAGES_SMOKE,
                                      conf={})
    assert all(run["outs"][n] == solo[n] for n in solo)
    assert all(len(o) == cs.FLEET_PARITY_NEW
               for v in run["outs"].values() for o in v)
    assert run["pages_back"] and run["finite"]
    assert sum(run["faults"][cs.FLEET_STORM].values()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_dense_int8_attention_and_q_chunk_on_card_match_cpu(cuda, vector):
    """One attention layer over a dense INT8 cache on the card against
    the CPU: a 16-token write from a scalar index, or 4 tokens a row
    from per-row positions with one row partly and one wholly past the
    cache's end (dropped: those rows keep their bytes).  Outputs within
    ``chip_smoke.PARITY_TOL`` of the largest, the lattice at most one step
    off and equal in 99.9 % of the written elements; ``_sdpa`` with
    ``q_chunk`` equal to the whole block's within 1e-5, on the card and
    against the CPU."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(CFG, n_layers=1, dtype=torch.float32)
    p = TT.init_lm(cfg, torch.Generator().manual_seed(6), device="cpu")
    attn = tree_map(lambda t: t[0], p["blocks"]["attn"])
    g = torch.Generator().manual_seed(7)
    t_len, s = 24, (4 if vector else 16)
    idx = torch.tensor([3, t_len - 2, t_len + 1]) if vector \
        else torch.tensor(4)
    x = torch.randn(3, s, cfg.d_model, generator=g)
    scales = (0.04 + 0.02 * torch.rand(cfg.n_kv, generator=g),
              0.04 + 0.02 * torch.rand(cfg.n_kv, generator=g))
    cache0 = {k: torch.randint(-127, 128, (3, t_len, cfg.n_kv, cfg.hd),
                               generator=g, dtype=torch.int8)
              for k in ("k", "v")}
    rope = TLY.rope_table(t_len, cfg.hd)
    out, caches = {}, {}
    for dev in ("cuda", "cpu"):
        c = {k: v.to(dev) for k, v in cache0.items()}
        out[dev], _ = TLY.attention(
            tree_map(lambda t: t.to(dev), attn), x.to(dev),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            rope=tuple(t.to(dev) for t in rope), kv_cache=c,
            cache_index=idx.to(dev),
            kv_scales=tuple(t.to(dev) for t in scales))
        caches[dev] = {k: v.cpu() for k, v in c.items()}
    tol = cs.PARITY_TOL * max(float(out["cpu"].abs().max()), 1.0)
    assert float((out["cuda"].cpu() - out["cpu"]).abs().max()) <= tol
    written = ([(0, 3, 7), (1, t_len - 2, t_len)] if vector
               else [(r, 4, 20) for r in range(3)])
    for k in ("k", "v"):
        d = torch.cat([(caches["cuda"][k][r, a:b].int()
                        - caches["cpu"][k][r, a:b].int()).abs().flatten()
                       for r, a, b in written])
        assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999
        if vector:
            assert torch.equal(caches["cuda"][k][2], cache0[k][2])
            assert torch.equal(caches["cuda"][k][1, :t_len - 2],
                               cache0[k][1, :t_len - 2])
    q, kk, v = (torch.randn(2, n, 4, 16, generator=g)
                for n in (32, 40, 40))
    whole = TLY._sdpa(q.cuda(), kk.cuda(), v.cuda(), causal=True,
                      q_offset=8)
    chunked = TLY._sdpa(q.cuda(), kk.cuda(), v.cuda(), causal=True,
                        q_offset=8, q_chunk=8)
    torch.testing.assert_close(chunked, whole, atol=1e-5, rtol=0)
    torch.testing.assert_close(
        chunked.cpu(), TLY._sdpa(q, kk, v, causal=True, q_offset=8,
                                 q_chunk=8), atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_dense_engines_on_card_match_cpu(cuda):
    """``chip_smoke._dense_parity`` (the check the script's
    ``path_parity_dense`` runs) on a 3-layer SMOKE model: the dense
    lossless engine's and the seed path's streams on the card equal to
    the CPU's or a near-tie at the first divergence (teacher-forced by
    the cacheless forward), the seed path's wire bytes equal, the dense
    INT8 default's decisions held to the CPU's up to the first tie."""
    cfg = dataclasses.replace(CFG, n_layers=3, dtype=torch.float32)
    res = _chip_smoke()._dense_parity(cfg)
    assert res["int8_divergence"]["noise"] <= _chip_smoke().INT8_NOISE_TOL
    assert res["attention"]["vector"]["lattice_equal_share"] >= 0.999
    assert res["seed_wire_bytes"] > 0


@pytest.mark.gpu
def test_dense_paths_launch_no_paged_or_int8_kernel(cuda):
    """The dense collaborative engine (serial and ``spec_k=2``), the dense
    cloud-only engine, the seed path and the LM's ``CollaborativeEngine``
    on the card: every kernel's launch count, set to 0 before and read
    after, stays 0 (B1 reads only pages, B4 serves no LM path)."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(CFG, n_layers=3, dtype=torch.float32)
    params = TT.init_lm(cfg, torch.Generator(device="cuda").manual_seed(8),
                        device="cuda")
    prompts = [np.random.RandomState(70 + i).randint(0, cfg.vocab, 12)
               .astype(np.int32) for i in range(3)]
    dense = dict(edge_paged=False, cloud_paged=False, device="cuda",
                 max_len=32, cut_layer=1)
    cs._reset_launch_counts()
    for k in (1, 2):
        eng = TE.CollaborativeServingEngine(params, cfg, spec_k=k, **dense)
        assert len(eng.generate(prompts, max_new_tokens=4)[0]) == 4
    eng.generate_recompute(prompts, max_new_tokens=3)
    TE.ServingEngine(params, cfg, max_len=32, device="cuda").generate(
        prompts, max_new_tokens=4)
    model = TT.make_segments(params, cfg, seq=12)
    y, rec = TC.CollaborativeEngine(model, "blk1/ffn", device="cuda").infer(
        torch.tensor(np.stack(prompts), device="cuda"))
    assert bool(torch.isfinite(y).all())
    torch.cuda.synchronize()
    assert cs._launch_counts() == dict.fromkeys(cs._launch_counts(), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 4, 128])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_kernel_at_group8_matches_plain(cuda, dtype, s):
    """qwen3-moe's attention: 32 query heads over 4 kv heads (a group of
    8), hd 128.  Decode stacks 8 rows a kv head on the split kernel; a
    ``spec_k=4`` verify (32 rows) and a prefill go to the tensor-core
    kernel.  Tolerance 1e-4 of max |plain|; the length-0 row is 0."""
    args = _case(12, dtype=dtype, group=8, s=s, n_kv=4, hd=128)
    before = PA.paged_flash_mq.launches
    tc_before = PA.paged_flash_mq.tc_launches
    out = PA.paged_multiquery_attention(*args)
    assert PA.paged_flash_mq.launches == before + 1
    assert PA.paged_flash_mq.tc_launches == tc_before + (s * 8 > 16)
    want = PA.paged_attention_mq_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert float((out - want).abs().max()) <= tol
    assert (out[0] == 0).all()


@pytest.mark.gpu
def test_moe_ordered_combine_on_card_is_bit_identical(cuda):
    """bf16 ``moe`` with pairs past capacity, three times on the card:
    the per-token combine sums in slot order with no atomics, so the
    outputs are equal bit for bit; the routing and the drops equal the
    CPU's on the same inputs."""
    g = torch.Generator(device="cuda").manual_seed(0)
    p = TLY.moe_init(g, 256, 128, 32, dtype=torch.bfloat16, device="cuda")
    x = torch.randn((4, 128, 256), generator=g, device="cuda")
    x = x.to(torch.bfloat16)
    outs = [TLY.moe(p, x, top_k=4, capacity_factor=0.75)[0]
            for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert bool(torch.isfinite(outs[0]).all())
    xt = x.reshape(-1, 256)
    _, idx, _ = TLY._route(p["router"], xt, 32, 4)
    _, idx_cpu, _ = TLY._route(tree_map(lambda v: v.cpu(), p["router"]),
                               xt.cpu(), 32, 4)
    cap = TLY.moe_capacity(xt.shape[0], 4, 32, 0.75)
    drops = TLY.moe_dispatch(idx, 32, cap)["pair_slot"] < 0
    assert drops.any()
    if torch.equal(idx.cpu(), idx_cpu):
        assert torch.equal(drops.cpu(),
                           TLY.moe_dispatch(idx_cpu, 32, cap)["pair_slot"]
                           < 0)


@pytest.mark.gpu
def test_moe_on_card_matches_cpu(cuda):
    """``chip_smoke._moe_parity`` (the script's ``path_parity_moe``) on a
    3-layer qwen3-moe ``SMOKE`` model in f32: ``moe`` at a 4-row decode
    and a 512-row prefill (card runs bit-identical, routing and drops
    equal up to gate near-ties, outputs within ``MOE_TOL``), the
    lossless engine stream against the CPU's up to near-ties, the INT8
    decisions up to the first tie within the devices' noise."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").smoke,
                              n_layers=3)
    res = cs._moe_parity(cfg)
    for check in res["moe"].values():
        assert check["repeat_identical"]
        assert check["max_abs_err"] <= check["tol"]


# ------------------------------- training -----------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("axis", [None, 1])
def test_ste_on_card_equals_cpu(cuda, axis):
    """The clipped STE: forward and gradient (the representable-range
    mask times the cotangent) equal on the card and the CPU."""
    from repro_torch.core.quant import fake_quant
    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 96, generator=g) * 4
    ct = torch.randn(32, 96, generator=g)
    qp = compute_qparams(x * 0.7, axis=axis)      # x saturates here and there
    outs = []
    for dev in ("cpu", cuda):
        xd = x.to(dev, copy=True).requires_grad_()
        y = fake_quant(xd, QuantParams(scale=qp.scale.to(dev),
                                       zero_point=qp.zero_point.to(dev),
                                       axis=qp.axis))
        y.backward(ct.to(dev))
        outs.append((y.detach().cpu(), xd.grad.cpu()))
    (y0, g0), (y1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(g0, g1)
    assert (g0 == 0).any() and (g0 != 0).any()      # both sides of the clip


@pytest.mark.gpu
def test_8bit_adamw_on_card_equals_cpu(cuda):
    """Under the clip (the global norm below ``grad_clip``) the 8-bit
    moments' lattices and scales are equal on the card and the CPU;
    parameters within 2e-6 relative (the f32 ``pow`` of the bias
    corrections)."""
    from repro_torch.train import optim as TO
    g = torch.Generator().manual_seed(1)
    shapes = {"stack": (3, 8, 256), "mat": (4, 384), "odd": (5, 100),
              "vec": (7,)}
    p0 = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=g) * 0.01 for k, s in
              shapes.items()} for _ in range(3)]
    cfg = TO.AdamWConfig(lr=1e-2, grad_clip=1e3)
    res = []
    for dev in ("cpu", cuda):
        p = {k: v.to(dev, copy=True) for k, v in p0.items()}
        o = TO.adamw8bit_init(p)
        for gr in grads:
            p, o, _ = TO.adamw8bit_update({k: v.to(dev) for k, v in
                                          gr.items()}, o, p, cfg)
        res.append((p, o))
    (pc, oc), (pg, og) = res
    for f in ("m_q", "m_scale", "v_q", "v_scale"):
        for k in shapes:
            assert torch.equal(getattr(oc, f)[k], getattr(og, f)[k].cpu())
    for k in shapes:
        torch.testing.assert_close(pg[k].cpu(), pc[k], rtol=2e-6, atol=1e-8)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """``chip_smoke._train_parity`` (the script's train path (c)) on a
    3-layer deepseek-7b ``SMOKE``-width model in f32: the STE, one
    train-cell step with 8-bit AdamW and one QAT ``Trainer`` step card
    against CPU within the phase's tolerances, and supervised restarts
    equal to an uninterrupted run under deterministic kernels."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(CFG, n_layers=3, d_model=128, n_heads=4,
                              n_kv=4, d_ff=256, vocab=512)
    res = cs._train_parity(cfg)
    assert res["train_cell"]["ok"] and res["qat_trainer"]["ok"]
    assert res["supervisor"]["restart_equal_uninterrupted"]
    assert res["supervisor"]["repeat_equal_deterministic"]


@pytest.mark.gpu
def test_card_checkpoint_restores_on_cpu_bit_for_bit(cuda, tmp_path):
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.train.optim import adamw8bit_init
    g = torch.Generator(device="cuda").manual_seed(2)
    params = {"w": torch.randn(4, 256, generator=g, device="cuda"),
              "h": torch.randn(2, 3, 128, generator=g,
                               device="cuda").to(torch.bfloat16),
              "ids": torch.randint(0, 9, (5,), generator=g, device="cuda",
                                   dtype=torch.int32)}
    state = {"params": params,
             "opt": adamw8bit_init({k: params[k] for k in ("w", "h")})}
    save_checkpoint(tmp_path, 1, state)
    back, step, _ = restore_checkpoint(tmp_path, state, device="cpu")
    assert step == 1
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["unet-sd15", "flux-dev"])
def test_diffusion_smoke_step_on_card_matches_cpu(cuda, arch):
    """The SMOKE denoise cell's step (``ddim_step`` / ``rf_step``) in f32
    on the card against the CPU on the same weights and inputs, within
    ``chip_smoke.DIFF_TOL`` × max |CPU| (the check ``diffusion_path``'s
    (e) runs at full width)."""
    cs = _chip_smoke()
    res = cs._diff_step_parity(arch, "cuda", smoke=True, img_res=None,
                               cfg={"dtype": torch.float32})
    assert res["max_abs_err"] <= cs.DIFF_TOL * res["max_abs_cpu"]
