"""Layer-graph IR for partition analysis (paper §2.2).

A ``LayerGraph`` is a DAG of named layers carrying the cost metadata the
auto-tuner needs (FLOPs, parameter count, output blob size).  Nodes must be
added in topological order; a *partition at node L* means the edge device
executes the topological prefix ending at L and the cloud executes the
rest (the paper's ``Net.Split(First, L_i)`` / ``Net.Split(L_i+1, Last)``).

The central primitive is ``crossing_blobs(cut)``: the set of tensors that
must travel edge→cloud for a given cut.  All of the paper's structural
rules (brother-branch, shortcut, non-parametric merge) reduce to
"a candidate cut crosses exactly one blob, and that blob is the cut
layer's own output" — see ``repro_torch.core.partition``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Node", "Blob", "LayerGraph"]

# ops with no parameters; candidates for fusion into the producer
NON_PARAMETRIC_OPS = {
    "relu", "gelu", "silu", "tanh", "sigmoid", "softmax",
    "pool", "maxpool", "avgpool", "globalpool",
    "add", "concat", "mul", "dropout", "flatten", "reshape", "lrn",
    "identity", "input", "rope", "scale",
}


@dataclasses.dataclass
class Node:
    name: str
    op: str
    inputs: List[str]
    out_shape: Tuple[int, ...]
    flops: float = 0.0            # forward FLOPs (MACs*2)
    param_elems: int = 0
    parametric: Optional[bool] = None   # default: op not in NON_PARAMETRIC_OPS
    fused: List[str] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.parametric is None:
            self.parametric = self.op not in NON_PARAMETRIC_OPS

    @property
    def out_elems(self) -> int:
        n = 1
        for d in self.out_shape:
            n *= int(d)
        return n

    def out_bytes(self, bytes_per_elem: float = 4.0) -> float:
        return self.out_elems * bytes_per_elem

    def param_bytes(self, bytes_per_elem: float = 4.0) -> float:
        return self.param_elems * bytes_per_elem


@dataclasses.dataclass(frozen=True)
class Blob:
    """One tensor crossing a partition cut."""
    source: str                  # producing node
    elems: int
    precision: str               # "int8" | "uint8" | "fp32"

    @property
    def bytes(self) -> float:
        per = 4.0 if self.precision == "fp32" else 1.0
        overhead = 8.0 if self.precision == "int8" else 0.0  # scale+zp
        return self.elems * per + overhead


class LayerGraph:
    def __init__(self, name: str):
        self.name = name
        self.nodes: Dict[str, Node] = {}          # insertion order == topo

    # -- construction -----------------------------------------------------
    def add(self, name: str, op: str, inputs: Sequence[str],
            out_shape: Sequence[int], *, flops: float = 0.0,
            param_elems: int = 0, parametric: Optional[bool] = None,
            **meta) -> str:
        assert name not in self.nodes, f"duplicate node {name}"
        for i in inputs:
            assert i in self.nodes, (
                f"{name}: input {i} not yet added (topological order required)")
        self.nodes[name] = Node(name=name, op=op, inputs=list(inputs),
                                out_shape=tuple(int(d) for d in out_shape),
                                flops=float(flops), param_elems=int(param_elems),
                                parametric=parametric, meta=meta)
        return name

    # -- basic queries ------------------------------------------------------
    def topo(self) -> List[str]:
        return list(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, name: str) -> Node:
        return self.nodes[name]

    def successors(self, name: str) -> List[str]:
        return [n for n, nd in self.nodes.items() if name in nd.inputs]

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def total_param_elems(self) -> int:
        return sum(n.param_elems for n in self.nodes.values())

    def prefix(self, cut: str) -> List[str]:
        order = self.topo()
        return order[: order.index(cut) + 1]

    def suffix(self, cut: str) -> List[str]:
        order = self.topo()
        return order[order.index(cut) + 1:]

    # -- the cut-set primitive ----------------------------------------------
    def crossing_blobs(self, cut: str) -> List[Blob]:
        """Tensors shipped edge→cloud when partitioning after ``cut``.

        Paper convention (§2.2 Tables 1-2): the cut layer's own output is
        the quantized INT8 boundary blob; any *other* prefix output needed
        by the FP32 cloud suffix ships in full precision.
        """
        order = self.topo()
        idx = {n: i for i, n in enumerate(order)}
        ci = idx[cut]
        sources: Dict[str, Node] = {}
        for n, nd in self.nodes.items():
            if idx[n] <= ci:
                continue
            for src in nd.inputs:
                if idx[src] <= ci:
                    sources[src] = self.nodes[src]
        # Deterministic order: topo order of sources.
        blobs = []
        for s in sorted(sources, key=idx.get):
            precision = "int8" if s == cut else "fp32"
            blobs.append(Blob(source=s, elems=sources[s].out_elems,
                              precision=precision))
        return blobs

    def validate(self) -> None:
        seen = set()
        for n, nd in self.nodes.items():
            for i in nd.inputs:
                assert i in seen, f"edge {i}->{n} violates topo order"
            seen.add(n)

    def summary(self) -> str:
        lines = [f"LayerGraph({self.name}): {len(self)} nodes, "
                 f"{self.total_flops()/1e9:.2f} GFLOPs, "
                 f"{self.total_param_elems()/1e6:.2f} M params"]
        for n, nd in self.nodes.items():
            fused = f" (+{','.join(nd.fused)})" if nd.fused else ""
            lines.append(
                f"  {n:32s} {nd.op:10s} in={nd.inputs} out={nd.out_shape}"
                f" flops={nd.flops/1e6:.1f}M params={nd.param_elems/1e3:.1f}K"
                f"{fused}")
        return "\n".join(lines)
