"""Serving engines of the port: the continuous-batching scheduler, the
paged KV pool, the cloud-only and collaborative engines, the online
tuning policy, the overload and fault-injection layers, and the fleet.

    scheduler   slot/bucket/round continuous batching (``_SlotEngine``)
    kvcache     paged KV bookkeeping (``PageAllocator``, demand growth)
    transport   framing, wire accounting, link telemetry, drifting links,
                the reliable transport (deadlines, retries, escalation)
    faults      seeded/scripted channel faults and pool pressure
    policy      online (cut_layer, spec_k) re-tuning + deadline admission
    overload    demand paging / preemption / shedding hooks
    engine      ``ServingEngine`` / ``CollaborativeServingEngine``
    resilience  ``ResilientCollaborativeEngine``: edge-only serving
                through cloud outages and the cloud KV resync
    tenant      the fleet's tenants, per-cut runtimes and fair admission
    fleet       ``FleetServingEngine``: N tenant edges on one shared
                cloud, cross-tenant batched rounds over one weight bank
                and page pool, weighted-fair sharing

``from repro_torch.serve import X`` resolves the public names of the
reference's ``repro.serve`` that the port has, on first use: the
models import ``serve.sharding``, so importing the engines here
eagerly would be circular.
"""
import importlib

_EXPORTS = {
    "ServingEngine": "cloud", "CollaborativeServingEngine": "engine",
    "ResilientCollaborativeEngine": "resilience",
    "FleetServingEngine": "fleet", "TenantSpec": "tenant",
    "FleetFairness": "policy",
    "ReliableTransport": "transport", "CloudUnreachable": "transport",
    "PageAllocator": "kvcache", "PoolExhausted": "kvcache",
    "ServeStats": "stats", "Request": "scheduler",
    "SamplingParams": "sampling", "Transport": "transport",
    "LinkTelemetry": "transport", "DriftingChannel": "transport",
    "FaultyChannel": "faults", "FaultOutcome": "faults",
    "PressureSchedule": "faults", "AdaptivePolicy": "policy",
    "DeadlineAdmission": "policy", "Decision": "policy"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
