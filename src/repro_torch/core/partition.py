"""Candidate partition points — the paper's §2.2 structural rules.

Three rules from the paper, realized on the ``LayerGraph`` cut-set
primitive:

1. **Non-parametric merge**: ReLU / pool / add / concat … are fused into
   the nearest *previous* parametric layer (topo-latest parametric
   producer), so they never appear as candidates and their cost/output
   ride along with the fused parent.
2. **Brother-branch rule** (inception): a layer inside a parallel branch
   can never be a single-blob cut — its brothers' tensors also cross.
3. **Shortcut rule** (residual): a layer spanned by a live skip
   connection can never be a single-blob cut.

Rules 2 and 3 need no pattern matching: after rule 1, a node is a
candidate iff ``crossing_blobs(cut) == [cut's own output]``.  For
multi-stream architectures (e.g. MMDiT's parallel img/txt residual
streams) *no* interior cut is single-blob; we generalize per DESIGN.md
§4: a cut is a candidate iff its blob count equals the graph-wide minimum
achievable ("live stream count"), configurable via ``max_blobs``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.graph import Blob, LayerGraph

__all__ = ["merge_non_parametric", "candidate_partition_points",
           "CandidatePoint", "partition_report"]


def merge_non_parametric(g: LayerGraph) -> LayerGraph:
    """Fuse non-parametric nodes into their topo-latest parametric producer.

    Multi-input merge nodes (add/concat) fuse into the latest parametric
    input; the fused node inherits the merge output shape and the union of
    remaining inputs, exactly reproducing the paper's treatment (the
    residual *add* rides with the last conv of the main path; the
    inception *concat* rides with the last branch).
    """
    out = LayerGraph(g.name)
    # alias: original node name -> name of surviving node that now owns it
    alias: Dict[str, str] = {}

    def resolve(name: str) -> str:
        while name in alias:
            name = alias[name]
        return name

    order = g.topo()
    idx = {n: i for i, n in enumerate(order)}
    for name in order:
        nd = g.nodes[name]
        inputs = [resolve(i) for i in nd.inputs]
        # de-dup while preserving order
        seen, uniq = set(), []
        for i in inputs:
            if i not in seen:
                seen.add(i)
                uniq.append(i)
        inputs = uniq
        if nd.parametric or nd.op == "input" or not inputs:
            out.add(name, nd.op, inputs, nd.out_shape, flops=nd.flops,
                    param_elems=nd.param_elems, parametric=nd.parametric,
                    **nd.meta)
            out.nodes[name].fused = list(nd.fused)
        else:
            # choose the topo-latest producer that survives in `out`
            host = max(inputs, key=lambda i: idx.get(i, -1))
            alias[name] = host
            h = out.nodes[host]
            h.fused.append(name)
            h.flops += nd.flops
            h.out_shape = nd.out_shape           # output becomes fused output
            # absorb the merge node's other inputs (e.g. shortcut source)
            for i in inputs:
                if i != host and i not in h.inputs:
                    h.inputs.append(i)
    out.validate()
    return out


@dataclasses.dataclass(frozen=True)
class CandidatePoint:
    name: str
    blobs: List[Blob]
    edge_flops: float            # cumulative FLOPs of the prefix
    edge_param_elems: int
    transmit_bytes: float        # total bytes crossing the wire

    @property
    def n_blobs(self) -> int:
        return len(self.blobs)


def candidate_partition_points(
    g: LayerGraph,
    *,
    max_blobs: int = 1,
    merge: bool = True,
    include_input: bool = True,
    include_last: bool = True,
) -> List[CandidatePoint]:
    """Apply the paper's candidate rules; returns candidates in topo order.

    ``max_blobs=1`` is the paper's rule; multi-stream archs pass the
    stream count (DESIGN.md extension).  The virtual cut *at the input*
    (= cloud-only inference) is included when ``include_input`` so the
    auto-tuner can fall back to pure-cloud; the cut after the last node
    (= edge-only) likewise.
    """
    if merge:
        g = merge_non_parametric(g)
    order = g.topo()
    out: List[CandidatePoint] = []
    cum_flops = 0.0
    cum_params = 0
    last = order[-1]
    for name in order:
        nd = g.nodes[name]
        cum_flops += nd.flops
        cum_params += nd.param_elems
        blobs = g.crossing_blobs(name)
        if name == last:
            if not include_last:
                continue
            blobs = []           # edge-only: nothing crosses but the logits
            blobs = [Blob(source=name, elems=nd.out_elems, precision="int8")]
        elif nd.op == "input":
            if not include_input:
                continue
            # cloud-only: ship the raw input (images are uint8 on the wire)
            blobs = [Blob(source=name, elems=nd.out_elems,
                          precision="uint8")]
        else:
            own = [b for b in blobs if b.source == name]
            if len(blobs) > max_blobs or not own:
                continue
        out.append(CandidatePoint(
            name=name, blobs=blobs, edge_flops=cum_flops,
            edge_param_elems=cum_params,
            transmit_bytes=sum(b.bytes for b in blobs)))
    return out


def partition_report(g: LayerGraph, *, max_blobs: int = 1) -> str:
    merged = merge_non_parametric(g)
    cands = {c.name for c in candidate_partition_points(
        g, max_blobs=max_blobs)}
    lines = [f"Partition analysis for {g.name} "
             f"({len(merged)} fused layers, {len(cands)} candidates):"]
    for name in merged.topo():
        nd = merged.nodes[name]
        blobs = merged.crossing_blobs(name)
        mark = "*" if name in cands else " "
        desc = " + ".join(f"{b.precision}[{b.elems}]" for b in blobs) or "-"
        lines.append(f" {mark} {name:32s} crossing: {desc}")
    return "\n".join(lines)
