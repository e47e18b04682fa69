"""The dry run of the port (``repro_torch.launch.dryrun``) over all 40
cells at SMOKE size on the meta device, on the CPU: 38 records, the two
MoE train cells named ``not_ported``, each record's kind and
``model_flops`` the cell's (held to the reference's in
``tests/test_torch_cells.py`` and ``test_torch_diffusion_cells.py``),
its bytes and bounds consistent, and a failing cell failing the run."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import list_cells as jlist_cells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402

CELLS = jlist_cells()


def test_dry_run_of_every_cell(tmp_path):
    """All 40 SMOKE cells on the meta device: 38 recorded, the two MoE
    train cells named ``not_ported``; each record's flops, model flops,
    bytes and bounds consistent."""
    assert dryrun.main(["--smoke", "--out", str(tmp_path)]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["cells"] == 40 and summary["ok"] == 38
    assert sorted(map(tuple, summary["not_ported"])) == [
        ("grok-1-314b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k")]
    for arch, shape in CELLS:
        rec = json.loads((tmp_path / f"{arch}__{shape}.json").read_text())
        if rec["status"] == "not_ported":
            continue
        cell = TS.build_cell(arch, shape, smoke=True, device="meta")
        assert rec["kind"] == cell.kind
        assert rec["model_flops"] == cell.model_flops
        assert rec["counted_flops"] > 0 and rec["eager_traffic_bytes"] > 0
        assert rec["resident_bytes"] == (rec["param_bytes"]
                                         + rec["state_bytes"]
                                         + rec["grad_buffer_bytes"]
                                         + rec["input_bytes"])
        assert rec["fits_one_card"] and rec["collectives"]["wire_bytes"] == 0
        b = rec["bounds"]
        assert b["bound_s"] == max(b["compute_s"], b["memory_s"])
        assert b["compute_s"] == rec["counted_flops"] / dryrun.PEAK_BF16
    # a second run keeps the records; a failing cell fails the run
    assert dryrun.main(["--smoke", "--out", str(tmp_path),
                        "--cells", "vit-s16 serve_b1"]) == 0


def test_dry_run_exits_non_zero_on_a_failure(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("no")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    assert dryrun.main(["--smoke", "--out", str(tmp_path), "--force",
                        "--cells", "vit-s16 serve_b1"]) == 1
