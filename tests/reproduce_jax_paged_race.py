"""Loop the JAX package's paged-admission scenario and count how often its
paged engine decodes other tokens than its dense engine.

The scenario is ``tests/test_paged_attention.py::
test_undersized_pool_backpressures_admission``: two prompts, a page pool
that holds one request at a time, 12 new tokens each; the paged
engine's streams must equal the dense engine's.  Run from the root of
the repo (nothing of the port is imported):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/reproduce_jax_paged_race.py \\
        --seconds 200 [--sync | --block both|prefill|decode]

``--sync`` turns JAX's asynchronous CPU dispatch off before the backend
starts; ``--block`` keeps it on and waits for the cloud-only engine's
prefill calls, its decode calls, or both, to finish before the host goes
on.  The script prints one line: the mode, the iterations and the
failures.
"""
import argparse
import sys
import time
from pathlib import Path

import jax


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=200.0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--sync", action="store_true")
    mode.add_argument("--block", choices=("both", "prefill", "decode"))
    args = ap.parse_args(argv)
    if args.sync:
        jax.config.update("jax_cpu_enable_async_dispatch", False)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_paged_attention as T
    from repro.serve import cloud

    if args.block:
        names = {"both": ("_admit", "_decode_all"), "prefill": ("_admit",),
                 "decode": ("_decode_all",)}[args.block]
        for name in names:
            def blocked(self, *a, _fn=getattr(cloud.ServingEngine, name),
                        **kw):
                out = _fn(self, *a, **kw)
                jax.block_until_ready((self._cache, out))
                return out
            setattr(cloud.ServingEngine, name, blocked)
    params = T.init_lm(jax.random.PRNGKey(0), T.CFG)
    prompts = T._prompts(2, plen=6, seed=9)
    n = fails = 0
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        paged = T.ServingEngine(params, T.CFG, max_batch=2, max_len=32,
                                paged=True, page_size=8, num_pages=5)
        dense = T.ServingEngine(params, T.CFG, max_batch=2, max_len=32)
        got = paged.generate(prompts, max_new_tokens=12)
        fails += got != dense.generate(prompts, max_new_tokens=12)
        n += 1
    label = ("sync" if args.sync else f"block {args.block}" if args.block
             else "async")
    print(f"{label}: {n} iterations, {fails} failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
