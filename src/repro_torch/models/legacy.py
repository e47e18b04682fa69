"""The paper's own benchmark networks: AlexNet, VGG16, GoogLeNet.

Counterpart of ``repro.models.legacy``: the same layers in the same
order, NHWC activations and HWIO kernels, and the same ``LayerGraph``
node for node at the paper's input resolutions (the Table 3 / Fig. 3
subjects).  Each network has ``init_*`` (fan-in scaled random weights
from an explicit ``torch.Generator`` — torch's numbers, not JAX's; the
tests bridge JAX's weights instead), ``*_forward``, ``*_graph`` and
``*_segments`` (the ``SegmentedModel`` of ``core.collab`` whose segment
boundaries are the graph's candidate partition points).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantCtx

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """One of the paper's CNNs at its published input resolution."""
    name: str
    img_res: int


def lrn(x: torch.Tensor, *, n: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """AlexNet/GoogLeNet local response normalization (channel-wise);
    the ``n`` shifted windows are summed in the reference's order."""
    sq = torch.square(x)
    c = x.shape[-1]
    pad = n // 2
    sq_pad = torch.nn.functional.pad(sq, (pad, pad))
    windows = sq_pad[..., 0:c]
    for i in range(1, n):
        windows = windows + sq_pad[..., i:i + c]
    return x / torch.pow(k + alpha * windows, beta)


# ---------------------------------------------------------------------------
# AlexNet (227x227)
# ---------------------------------------------------------------------------

ALEXNET_CONVS = [
    # name, k, stride, pad, c_out, lrn?, pool?
    ("conv1", 11, 4, "VALID", 96, True, True),
    ("conv2", 5, 1, "SAME", 256, True, True),
    ("conv3", 3, 1, "SAME", 384, False, False),
    ("conv4", 3, 1, "SAME", 384, False, False),
    ("conv5", 3, 1, "SAME", 256, False, True),
]
ALEXNET_FCS = [("fc6", 4096), ("fc7", 4096), ("fc8", 1000)]


def init_alexnet(gen: torch.Generator, *, dtype=torch.float32,
                 device: DeviceLike = None, img_res: int = 227) -> Params:
    dev = resolve_device(device)
    p: Params = {}
    c_in = 3
    for name, k, s, pad, c_out, _, _ in ALEXNET_CONVS:
        p[name] = L.conv2d_init(gen, k, c_in, c_out, dtype=dtype, device=dev)
        c_in = c_out
    d_in = 256 * _alexnet_spatial(img_res)[-1] ** 2
    for name, width in ALEXNET_FCS:
        p[name] = L.dense_init(gen, d_in, width, bias=True, dtype=dtype,
                               device=dev)
        d_in = width
    return p


def _alexnet_spatial(img: int) -> List[int]:
    out = []
    r = img
    for name, k, s, pad, c_out, _, pool in ALEXNET_CONVS:
        r = (r - k) // s + 1 if pad == "VALID" else (r + s - 1) // s
        if pool:
            r = (r - 3) // 2 + 1
        out.append(r)
    return out


def _alexnet_conv(p: Params, x: torch.Tensor, name, k, s, pad, use_lrn,
                  pool, qctx: Optional[QuantCtx]) -> torch.Tensor:
    x = L.conv2d(p, x, stride=s, padding=pad, qctx=qctx, name=name,
                 act="relu")
    if use_lrn:
        x = lrn(x)
    if pool:
        x = L.maxpool2d(x, window=3, stride=2, padding="VALID")
    return x


def _fc(p: Params, x: torch.Tensor, name: str, last: bool,
        qctx: Optional[QuantCtx]) -> torch.Tensor:
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    return L.cnn_dense(p, x, qctx=qctx, name=name,
                       act=None if last else "relu")


def alexnet_forward(params: Params, img: torch.Tensor, *,
                    qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    x = img
    for name, k, s, pad, _, use_lrn, pool in ALEXNET_CONVS:
        x = _alexnet_conv(params[name], x, name, k, s, pad, use_lrn, pool,
                          qctx)
    for name, _ in ALEXNET_FCS:
        x = _fc(params[name], x, name, name == "fc8", qctx)
    return x


def alexnet_graph(*, batch: int = 1, img_res: int = 227) -> LayerGraph:
    g = LayerGraph("alexnet")
    g.add("input", "input", [], (batch, img_res, img_res, 3))
    prev = "input"
    c_in = 3
    spatials = _alexnet_spatial(img_res)
    rs_prepool = []
    r = img_res
    for name, k, s, pad, c_out, _, pool in ALEXNET_CONVS:
        r = (r - k) // s + 1 if pad == "VALID" else (r + s - 1) // s
        rs_prepool.append(r)
        if pool:
            r = (r - 3) // 2 + 1
    for i, (name, k, s, pad, c_out, _, _) in enumerate(ALEXNET_CONVS):
        rp, ro = rs_prepool[i], spatials[i]
        prev = g.add(name, "conv", [prev], (batch, ro, ro, c_out),
                     flops=2 * batch * rp * rp * k * k * c_in * c_out,
                     param_elems=k * k * c_in * c_out + c_out)
        c_in = c_out
    d_in = 256 * spatials[-1] ** 2
    for name, width in ALEXNET_FCS:
        prev = g.add(name, "dense", [prev], (batch, width),
                     flops=2 * batch * d_in * width,
                     param_elems=d_in * width + width)
        d_in = width
    g.validate()
    return g


def alexnet_segments(params: Params, *, img_res: int = 227):
    from repro_torch.core.collab import Segment, SegmentedModel

    def mk_conv(name, k, s, pad, use_lrn, pool):
        def apply(p, x, *, qctx=None):
            return _alexnet_conv(p, x, name, k, s, pad, use_lrn, pool, qctx)
        return apply

    segs = [Segment(name, mk_conv(name, k, s, pad, use_lrn, pool),
                    params[name])
            for name, k, s, pad, _, use_lrn, pool in ALEXNET_CONVS]
    segs += [Segment(name, _mk_fc(name, name == "fc8"), params[name])
             for name, _ in ALEXNET_FCS]
    return SegmentedModel(name="alexnet",
                          graph=alexnet_graph(img_res=img_res),
                          segments=segs)


def _mk_fc(name: str, last: bool):
    def apply(p, x, *, qctx=None):
        return _fc(p, x, name, last, qctx)
    return apply


# ---------------------------------------------------------------------------
# VGG16 (224x224)
# ---------------------------------------------------------------------------

VGG_PLAN = [  # (stage, n_convs, c_out)
    (1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]
VGG_FCS = [("fc6", 4096), ("fc7", 4096), ("fc8", 1000)]


def init_vgg16(gen: torch.Generator, *, dtype=torch.float32,
               device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    p: Params = {}
    c_in = 3
    for stage, n_convs, c_out in VGG_PLAN:
        for j in range(n_convs):
            p[f"conv{stage}_{j + 1}"] = L.conv2d_init(
                gen, 3, c_in, c_out, dtype=dtype, device=dev)
            c_in = c_out
    d_in = 512 * 7 * 7
    for name, width in VGG_FCS:
        p[name] = L.dense_init(gen, d_in, width, bias=True, dtype=dtype,
                               device=dev)
        d_in = width
    return p


def _vgg_conv(p: Params, x: torch.Tensor, name: str, pool: bool,
              qctx: Optional[QuantCtx]) -> torch.Tensor:
    x = L.conv2d(p, x, qctx=qctx, name=name, act="relu")
    if pool:
        x = L.maxpool2d(x, window=2, stride=2, padding="VALID")
    return x


def vgg16_forward(params: Params, img: torch.Tensor, *,
                  qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    x = img
    for stage, n_convs, _ in VGG_PLAN:
        for j in range(n_convs):
            name = f"conv{stage}_{j + 1}"
            x = _vgg_conv(params[name], x, name, j == n_convs - 1, qctx)
    for name, _ in VGG_FCS:
        x = _fc(params[name], x, name, name == "fc8", qctx)
    return x


def vgg16_graph(*, batch: int = 1, img_res: int = 224) -> LayerGraph:
    g = LayerGraph("vgg16")
    g.add("input", "input", [], (batch, img_res, img_res, 3))
    prev = "input"
    c_in, r = 3, img_res
    for stage, n_convs, c_out in VGG_PLAN:
        for j in range(n_convs):
            name = f"conv{stage}_{j + 1}"
            out_r = r if j < n_convs - 1 else r // 2   # pool folds into last
            prev = g.add(name, "conv", [prev], (batch, out_r, out_r, c_out),
                         flops=2 * batch * r * r * 9 * c_in * c_out,
                         param_elems=9 * c_in * c_out + c_out)
            c_in = c_out
        r //= 2
    d_in = 512 * r * r
    for name, width in VGG_FCS:
        prev = g.add(name, "dense", [prev], (batch, width),
                     flops=2 * batch * d_in * width,
                     param_elems=d_in * width + width)
        d_in = width
    g.validate()
    return g


def vgg16_segments(params: Params):
    from repro_torch.core.collab import Segment, SegmentedModel

    def mk_conv(name, pool):
        def apply(p, x, *, qctx=None):
            return _vgg_conv(p, x, name, pool, qctx)
        return apply

    segs = []
    for stage, n_convs, _ in VGG_PLAN:
        for j in range(n_convs):
            name = f"conv{stage}_{j + 1}"
            segs.append(Segment(name, mk_conv(name, j == n_convs - 1),
                                params[name]))
    segs += [Segment(name, _mk_fc(name, name == "fc8"), params[name])
             for name, _ in VGG_FCS]
    return SegmentedModel(name="vgg16", graph=vgg16_graph(), segments=segs)


# ---------------------------------------------------------------------------
# GoogLeNet (224x224) — 9 inception modules
# ---------------------------------------------------------------------------

# (name, b1, b2_in, b2_out, b3_in, b3_out, b4, pool_after)
INCEPTIONS = [
    ("inc3a", 64, 96, 128, 16, 32, 32, False),
    ("inc3b", 128, 128, 192, 32, 96, 64, True),
    ("inc4a", 192, 96, 208, 16, 48, 64, False),
    ("inc4b", 160, 112, 224, 24, 64, 64, False),
    ("inc4c", 128, 128, 256, 24, 64, 64, False),
    ("inc4d", 112, 144, 288, 32, 64, 64, False),
    ("inc4e", 256, 160, 320, 32, 128, 128, True),
    ("inc5a", 256, 160, 320, 32, 128, 128, False),
    ("inc5b", 384, 192, 384, 48, 128, 128, False),
]


def _inc_out(spec) -> int:
    _, b1, _, b2o, _, b3o, b4, _ = spec
    return b1 + b2o + b3o + b4


def init_googlenet(gen: torch.Generator, *, dtype=torch.float32,
                   device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    p: Params = {"conv1": L.conv2d_init(gen, 7, 3, 64, **kw),
                 "conv2_reduce": L.conv2d_init(gen, 1, 64, 64, **kw),
                 "conv2": L.conv2d_init(gen, 3, 64, 192, **kw)}
    c_in = 192
    for spec in INCEPTIONS:
        name, b1, b2i, b2o, b3i, b3o, b4, _ = spec
        p[name] = {"b1": L.conv2d_init(gen, 1, c_in, b1, **kw),
                   "b2a": L.conv2d_init(gen, 1, c_in, b2i, **kw),
                   "b2b": L.conv2d_init(gen, 3, b2i, b2o, **kw),
                   "b3a": L.conv2d_init(gen, 1, c_in, b3i, **kw),
                   "b3b": L.conv2d_init(gen, 5, b3i, b3o, **kw),
                   "b4": L.conv2d_init(gen, 1, c_in, b4, **kw)}
        c_in = _inc_out(spec)
    p["fc"] = L.dense_init(gen, 1024, 1000, bias=True, **kw)
    return p


def _inception_apply(p: Params, x: torch.Tensor, name: str, *,
                     qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    y1 = L.conv2d(p["b1"], x, qctx=qctx, name=f"{name}/b1", act="relu")
    y2 = L.conv2d(p["b2a"], x, qctx=qctx, name=f"{name}/b2a", act="relu")
    y2 = L.conv2d(p["b2b"], y2, qctx=qctx, name=f"{name}/b2b", act="relu")
    y3 = L.conv2d(p["b3a"], x, qctx=qctx, name=f"{name}/b3a", act="relu")
    y3 = L.conv2d(p["b3b"], y3, qctx=qctx, name=f"{name}/b3b", act="relu")
    y4 = L.maxpool2d(x, window=3, stride=1)
    y4 = L.conv2d(p["b4"], y4, qctx=qctx, name=f"{name}/b4", act="relu")
    return torch.cat([y1, y2, y3, y4], dim=-1)


def _stem1(p, x, *, qctx=None):
    x = L.conv2d(p, x, stride=2, qctx=qctx, name="conv1", act="relu")
    x = L.maxpool2d(x, window=3, stride=2)
    return lrn(x)


def _stem2r(p, x, *, qctx=None):
    return L.conv2d(p, x, qctx=qctx, name="conv2_reduce", act="relu")


def _stem2(p, x, *, qctx=None):
    x = L.conv2d(p, x, qctx=qctx, name="conv2", act="relu")
    x = lrn(x)
    return L.maxpool2d(x, window=3, stride=2)


def _inception_block(p: Params, x: torch.Tensor, spec, *,
                     qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    y = _inception_apply(p, x, spec[0], qctx=qctx)
    if spec[-1]:
        y = L.maxpool2d(y, window=3, stride=2)
    return y


def _mk_inc(spec):
    def apply(p, x, *, qctx=None):
        return _inception_block(p, x, spec, qctx=qctx)
    return apply


def _head(p, x, *, qctx=None):
    return L.cnn_dense(p, torch.mean(x, dim=(1, 2)), qctx=qctx, name="fc")


def googlenet_forward(params: Params, img: torch.Tensor, *,
                      qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    x = _stem1(params["conv1"], img, qctx=qctx)
    x = _stem2r(params["conv2_reduce"], x, qctx=qctx)
    x = _stem2(params["conv2"], x, qctx=qctx)
    for spec in INCEPTIONS:
        x = _inception_block(params[spec[0]], x, spec, qctx=qctx)
    return _head(params["fc"], x, qctx=qctx)


def googlenet_graph(*, batch: int = 1, img_res: int = 224) -> LayerGraph:
    g = LayerGraph("googlenet")
    g.add("input", "input", [], (batch, img_res, img_res, 3))
    r = img_res // 2
    g.add("conv1", "conv", ["input"], (batch, r // 2, r // 2, 64),
          flops=2 * batch * r * r * 49 * 3 * 64, param_elems=49 * 3 * 64 + 64)
    r //= 2
    g.add("conv2_reduce", "conv", ["conv1"], (batch, r, r, 64),
          flops=2 * batch * r * r * 64 * 64, param_elems=64 * 64 + 64)
    g.add("conv2", "conv", ["conv2_reduce"], (batch, r // 2, r // 2, 192),
          flops=2 * batch * r * r * 9 * 64 * 192,
          param_elems=9 * 64 * 192 + 192)
    r //= 2
    prev = "conv2"
    c_in = 192
    for spec in INCEPTIONS:
        name, b1, b2i, b2o, b3i, b3o, b4, pool = spec
        c_out = _inc_out(spec)

        def cflops(k, ci, co):
            return 2 * batch * r * r * k * k * ci * co

        n1 = g.add(f"{name}/b1", "conv", [prev], (batch, r, r, b1),
                   flops=cflops(1, c_in, b1), param_elems=c_in * b1 + b1)
        n2a = g.add(f"{name}/b2a", "conv", [prev], (batch, r, r, b2i),
                    flops=cflops(1, c_in, b2i), param_elems=c_in * b2i + b2i)
        n2b = g.add(f"{name}/b2b", "conv", [n2a], (batch, r, r, b2o),
                    flops=cflops(3, b2i, b2o), param_elems=9 * b2i * b2o + b2o)
        n3a = g.add(f"{name}/b3a", "conv", [prev], (batch, r, r, b3i),
                    flops=cflops(1, c_in, b3i), param_elems=c_in * b3i + b3i)
        n3b = g.add(f"{name}/b3b", "conv", [n3a], (batch, r, r, b3o),
                    flops=cflops(5, b3i, b3o),
                    param_elems=25 * b3i * b3o + b3o)
        n4p = g.add(f"{name}/pool", "maxpool", [prev], (batch, r, r, c_in))
        n4 = g.add(f"{name}/b4", "conv", [n4p], (batch, r, r, b4),
                   flops=cflops(1, c_in, b4), param_elems=c_in * b4 + b4)
        out_r = r // 2 if pool else r
        prev = g.add(f"{name}/concat", "concat", [n1, n2b, n3b, n4],
                     (batch, out_r, out_r, c_out))
        if pool:
            r //= 2
        c_in = c_out
    g.add("fc", "dense", [prev], (batch, 1000),
          flops=2 * batch * 1024 * 1000, param_elems=1024 * 1000 + 1000)
    g.validate()
    return g


def googlenet_segments(params: Params):
    from repro_torch.core.collab import Segment, SegmentedModel
    segs = [Segment("conv1", _stem1, params["conv1"]),
            Segment("conv2_reduce", _stem2r, params["conv2_reduce"]),
            Segment("conv2", _stem2, params["conv2"])]
    # the concat fuses into the topo-latest branch conv (b4)
    segs += [Segment(f"{spec[0]}/b4", _mk_inc(spec), params[spec[0]])
             for spec in INCEPTIONS]
    segs.append(Segment("fc", _head, params["fc"]))
    return SegmentedModel(name="googlenet", graph=googlenet_graph(),
                          segments=segs)
