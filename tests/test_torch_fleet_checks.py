"""``chip_smoke.py``'s fleet checks run on the CPU: the recorder of each
committed index's logits (``_CommittedLogits``) on a fleet and on solo
engines, the near-tie rule ``_fleet_divergence`` holds a tenant's own
requests to, and the bound's byte count of a paged call whose rows share
the dump page (``_paged_work``).  A 3-layer SMOKE deepseek-7b, the four
``FLEET_TENANTS`` at cuts 0 and 1 with the storm's drops and outage."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CUTS = {14: 0, 28: 1}
MAX_NEW = 8


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(cs):
    """(fleet run, solo runs at the fleet's batch shape) per mode, both
    recording their committed logits."""
    cfg = dataclasses.replace(get_arch("deepseek-7b").smoke, n_layers=3,
                              dtype=torch.float32)
    params = init_lm(cfg, torch.Generator().manual_seed(5), device="cpu")
    prompts = cs._fleet_prompts(cs.FLEET_TENANTS, cfg.vocab,
                                lens=cs.FLEET_PARITY_LENS)
    out = {}
    for mode, conf in (("lossless", cs.LOSSLESS_FP), ("int8", {})):
        run = cs._fleet_run(
            params, cfg, device="cpu",
            specs=cs._fleet_specs(cs.FLEET_TENANTS, CUTS,
                                  cs.FLEET_PARITY_OUTAGES_SMOKE),
            prompts=prompts, max_new=MAX_NEW, max_len=64, logits=True,
            **conf)
        solo = cs._solo_runs(
            params, cfg, device="cpu", num_pages=run["num_pages"],
            max_len=64, max_new=MAX_NEW, logits=True,
            jobs={n: (CUTS[c], k, cs.FLEET_SLOTS, None, prompts[n])
                  for n, c, k, *_r in cs.FLEET_TENANTS}, **conf)
        out[mode] = run, solo
    return out


@pytest.mark.parametrize("mode", ["lossless", "int8"])
def test_committed_logits_line_up_fleet_and_solo(cs, runs, mode):
    """On the CPU every fleet row is its solo row bit for bit, so the
    two records must hold the same logits at every committed index of
    every request, each giving the committed token; the divergence
    report then finds nothing."""
    run, solo = runs[mode]
    for name, *_r in cs.FLEET_TENANTS:
        assert run["outs"][name] == solo[name]["outs"]
        for uid, toks in enumerate(run["outs"][name]):
            assert len(toks) == MAX_NEW
            for i, t in enumerate(toks):
                a = run["logits"][(name, uid), i]
                b = solo[name]["logits"][uid, i]
                assert a.dtype == torch.float32
                assert int(a.argmax()) == t
                assert torch.equal(a, b)
        div = cs._fleet_divergence(name, run, solo[name])
        assert div["equal"]
        assert all(r["first_divergent"] is None for r in div["requests"])


@pytest.mark.parametrize("delta", [0.01, 1.0])
def test_fleet_divergence_reads_a_flip_against_int8_noise(cs, runs, delta):
    """A solo stream made to flip at index 3 to the fleet's second
    choice, its logit there raised ``delta`` above the fleet's top: the
    report finds the index, the difference is the fleet's top-2 gap
    plus ``delta``, and it is a near-tie exactly when that is within
    ``INT8_NOISE_TOL``."""
    run, solo = runs["int8"]
    name, i = "edge0", 3
    la = run["logits"][(name, 0), i]
    top, idx = torch.topk(la, 2)
    lb = la.clone()
    lb[idx[1]] = top[0] + delta
    stream = list(run["outs"][name][0])
    stream[i] = int(idx[1])
    fake = dict(outs=[stream] + run["outs"][name][1:],
                logits={**solo[name]["logits"], (0, i): lb})
    row = cs._fleet_divergence(name, run, fake)["requests"][0]
    gap = float(top[0]) - float(top[1])
    assert row["first_divergent"] == i and row["recorded"]
    assert row["tokens"] == [int(idx[0]), int(idx[1])]
    assert row["logit_diff"] == pytest.approx(gap + delta, abs=1e-6)
    assert row["near_tie"] == (row["logit_diff"] <= cs.INT8_NOISE_TOL)
    assert row["near_tie"] == (delta < 0.1 and gap + delta <= 0.25)


def test_paged_work_counts_a_shared_page_once(cs):
    """Rows on a zeroed block-table row all read the dump page: the
    bound's bytes count its positions once, every other row's own."""
    b, s, heads, hd, page = 4, 2, 2, 8, 4
    lens = torch.tensor([10, 9, 6, 7], dtype=torch.int32)
    bt = torch.tensor([[1, 2, 3], [0, 0, 0], [4, 5, 6], [0, 0, 0]],
                      dtype=torch.int32)
    kp = torch.zeros((7, page, heads, hd), dtype=torch.int8)
    c = dict(q=torch.zeros((b, s, heads, hd)), pools=[(kp, kp)], bt=bt,
             lens=lens, qs=lens - s, ks=torch.ones((b, heads)))
    nbytes, flops = cs._paged_work(c)
    # rows 0 and 2 read 10 and 6 positions of their own pages; rows 1
    # and 3 read page 0, whose 4 positions count once
    kv = 10 + 6 + page
    assert nbytes == (2 * kv * heads * hd + 2 * b * s * heads * hd * 4
                      + bt.numel() * 4 + 2 * b * 4 + 2 * b * heads * 4)
    pairs = sum(int(n) - s + 1 + int(n) - s + 2 for n in lens.tolist())
    assert flops == 4 * pairs * heads * hd
