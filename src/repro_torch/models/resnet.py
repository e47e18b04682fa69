"""ResNets: resnet-152 and resnet-18 (the paper's Table 3 subject).

Counterpart of ``repro.models.resnet``: bottleneck (152) and basic (18)
residual blocks with GroupNorm(32) in place of BatchNorm, as in the
reference, NHWC activations and HWIO kernels, the same parameter names
(``stem``, ``{block}/c1|c2|c3|proj``, ``head``) and the same
``LayerGraph`` node for node.  The candidate cuts are the block
boundaries (post-add); each block, its residual add fused in, is one
segment of the ``SegmentedModel``.  Every conv pads as JAX's ``"SAME"``
does, the odd cell at the end (``layers._pads``): the 7×7/2 stem on
224² pads (2, 3), the 3×3/2 max pool and each stage's first 3×3/2 conv
(0, 1).  ``init_resnet`` draws fan-in scaled weights from an explicit
``torch.Generator`` (torch's numbers, not JAX's; the tests bridge JAX's
weights instead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantCtx

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    depths: Tuple[int, int, int, int]
    width: int = 64
    bottleneck: bool = True
    n_classes: int = 1000
    img_res: int = 224
    dtype: Any = torch.float32

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1

    def stage_channels(self, s: int) -> int:
        return self.width * (2 ** s)


def _block_init(gen, c_in: int, c_mid: int, c_out: int, *, bottleneck: bool,
                stride: int, dtype, device) -> Params:
    conv = dict(bias=False, dtype=dtype, device=device)
    norm = dict(bias=True, dtype=dtype, device=device)
    p: Params = {}
    if bottleneck:
        p["conv1"] = L.conv2d_init(gen, 1, c_in, c_mid, **conv)
        p["conv2"] = L.conv2d_init(gen, 3, c_mid, c_mid, **conv)
        p["conv3"] = L.conv2d_init(gen, 1, c_mid, c_out, **conv)
        p["n1"] = L.norm_init(c_mid, **norm)
        p["n2"] = L.norm_init(c_mid, **norm)
        p["n3"] = L.norm_init(c_out, **norm)
    else:
        p["conv1"] = L.conv2d_init(gen, 3, c_in, c_mid, **conv)
        p["conv2"] = L.conv2d_init(gen, 3, c_mid, c_out, **conv)
        p["n1"] = L.norm_init(c_mid, **norm)
        p["n2"] = L.norm_init(c_out, **norm)
    if stride != 1 or c_in != c_out:
        p["proj"] = L.conv2d_init(gen, 1, c_in, c_out, **conv)
        p["nproj"] = L.norm_init(c_out, **norm)
    return p


def _block_apply(p: Params, x: torch.Tensor, *, bottleneck: bool,
                 stride: int, qctx: Optional[QuantCtx] = None,
                 name: str = "blk") -> torch.Tensor:
    sc = x
    if "proj" in p:
        sc = L.conv2d(p["proj"], x, stride=stride, qctx=qctx,
                      name=f"{name}/proj")
        sc = L.groupnorm(p["nproj"], sc)
    if bottleneck:
        h = L.conv2d(p["conv1"], x, qctx=qctx, name=f"{name}/c1")
        h = F.relu(L.groupnorm(p["n1"], h))
        h = L.conv2d(p["conv2"], h, stride=stride, qctx=qctx,
                     name=f"{name}/c2")
        h = F.relu(L.groupnorm(p["n2"], h))
        h = L.conv2d(p["conv3"], h, qctx=qctx, name=f"{name}/c3")
        h = L.groupnorm(p["n3"], h)
    else:
        h = L.conv2d(p["conv1"], x, stride=stride, qctx=qctx,
                     name=f"{name}/c1")
        h = F.relu(L.groupnorm(p["n1"], h))
        h = L.conv2d(p["conv2"], h, qctx=qctx, name=f"{name}/c2")
        h = L.groupnorm(p["n2"], h)
    return F.relu(sc + h)


def _plan(cfg: ResNetConfig) -> List[dict]:
    """Flat list of block descriptors."""
    plan = []
    c_in = cfg.width
    for s, depth in enumerate(cfg.depths):
        c_mid = cfg.stage_channels(s)
        c_out = c_mid * cfg.expansion
        for b in range(depth):
            stride = 2 if (b == 0 and s > 0) else 1
            plan.append(dict(name=f"s{s + 1}b{b}", c_in=c_in, c_mid=c_mid,
                             c_out=c_out, stride=stride))
            c_in = c_out
    return plan


def init_resnet(gen: torch.Generator, cfg: ResNetConfig, *,
                device: DeviceLike = None) -> Params:
    """Random weights with the reference's distributions, drawn from
    ``gen`` — which must live on ``device``."""
    dev = resolve_device(device)
    p: Params = {
        "stem": L.conv2d_init(gen, 7, 3, cfg.width, bias=False,
                              dtype=cfg.dtype, device=dev),
        "stem_n": L.norm_init(cfg.width, bias=True, dtype=cfg.dtype,
                              device=dev),
    }
    for blk in _plan(cfg):
        p[blk["name"]] = _block_init(
            gen, blk["c_in"], blk["c_mid"], blk["c_out"],
            bottleneck=cfg.bottleneck, stride=blk["stride"],
            dtype=cfg.dtype, device=dev)
    c_last = cfg.stage_channels(3) * cfg.expansion
    p["head"] = L.dense_init(gen, c_last, cfg.n_classes, bias=True,
                             dtype=cfg.dtype, device=dev)
    return p


def _stem(p: Params, img: torch.Tensor, cfg: ResNetConfig, *,
          qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    x = L.conv2d(p["stem"], img.to(cfg.dtype), stride=2, qctx=qctx,
                 name="stem")
    x = F.relu(L.groupnorm(p["stem_n"], x))
    return L.maxpool2d(x, window=3, stride=2)


def _head(p: Params, x: torch.Tensor, *,
          qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """Global average pool, then the classifier (a true f32 product on
    the card, ``cnn_dense``)."""
    return L.cnn_dense(p, torch.mean(x, dim=(1, 2)), qctx=qctx, name="head")


def forward(params: Params, img: torch.Tensor, cfg: ResNetConfig, *,
            qctx: Optional[QuantCtx] = None) -> torch.Tensor:
    x = _stem(params, img, cfg, qctx=qctx)
    for blk in _plan(cfg):
        x = _block_apply(params[blk["name"]], x, bottleneck=cfg.bottleneck,
                         stride=blk["stride"], qctx=qctx, name=blk["name"])
    return _head(params["head"], x, qctx=qctx)


def make_graph(cfg: ResNetConfig, *, batch: int) -> LayerGraph:
    g = LayerGraph(cfg.name)
    r = cfg.img_res
    g.add("input", "input", [], (batch, r, r, 3))
    r //= 2
    g.add("stem", "conv", ["input"], (batch, r, r, cfg.width),
          flops=2 * batch * r * r * 49 * 3 * cfg.width,
          param_elems=49 * 3 * cfg.width + 2 * cfg.width)
    r //= 2
    g.add("stem_pool", "maxpool", ["stem"], (batch, r, r, cfg.width))
    prev = "stem_pool"
    for blk in _plan(cfg):
        if blk["stride"] == 2:
            r //= 2
        c_in, c_mid, c_out = blk["c_in"], blk["c_mid"], blk["c_out"]
        if cfg.bottleneck:
            flops = 2 * batch * r * r * (c_in * c_mid + 9 * c_mid * c_mid
                                         + c_mid * c_out)
            pcount = c_in * c_mid + 9 * c_mid * c_mid + c_mid * c_out \
                + 2 * (2 * c_mid + c_out)
        else:
            flops = 2 * batch * r * r * (9 * c_in * c_mid + 9 * c_mid * c_out)
            pcount = 9 * c_in * c_mid + 9 * c_mid * c_out \
                + 2 * (c_mid + c_out)
        has_proj = blk["stride"] != 1 or c_in != c_out
        if has_proj:
            flops += 2 * batch * r * r * c_in * c_out
            pcount += c_in * c_out + 2 * c_out
        name = blk["name"]
        body = g.add(f"{name}/body", "conv", [prev],
                     (batch, r, r, c_out), flops=flops, param_elems=pcount)
        prev = g.add(f"{name}/add", "add", [body, prev],
                     (batch, r, r, c_out))
    c_last = cfg.stage_channels(3) * cfg.expansion
    g.add("head", "dense", [prev], (batch, cfg.n_classes),
          flops=2 * batch * c_last * cfg.n_classes,
          param_elems=c_last * cfg.n_classes + cfg.n_classes)
    g.validate()
    return g


def make_segments(params: Params, cfg: ResNetConfig):
    from repro_torch.core.collab import Segment, SegmentedModel

    def stem_apply(p, img, *, qctx=None):
        return _stem(p, img, cfg, qctx=qctx)

    def mk_block(blk):
        def apply(p, x, *, qctx=None):
            return _block_apply(p, x, bottleneck=cfg.bottleneck,
                                stride=blk["stride"], qctx=qctx,
                                name=blk["name"])
        return apply

    segs = [Segment("stem", stem_apply,
                    {k: params[k] for k in ("stem", "stem_n")})]
    for blk in _plan(cfg):
        # the block's residual add fuses into its body node (§2.2)
        segs.append(Segment(f"{blk['name']}/body", mk_block(blk),
                            params[blk["name"]]))
    segs.append(Segment("head", _head, params["head"]))
    return SegmentedModel(name=cfg.name, graph=make_graph(cfg, batch=1),
                          segments=segs)
