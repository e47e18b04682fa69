"""The port stands alone and never falls back from the card to the CPU.

* Every module of ``repro_torch`` imports in a process where ``jax`` and
  ``repro`` cannot be imported.
* With no CUDA device, an engine built without ``device=`` raises.
* The kernel front door on a CPU tensor takes the plain version and
  launches nothing."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = get_arch("deepseek-7b").smoke

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert {"repro_torch.kernels.ops", "repro_torch.kernels.ref",
        "repro_torch.kernels.int8_matmul",
        "repro_torch.serve.spec", "repro_torch.serve.resilience",
        "repro_torch.serve.fleet", "repro_torch.serve.tenant",
        "repro_torch.launch.mesh",
        "repro_torch.launch.shardings",
        "repro_torch.serve.sharding", "repro_torch.models.resnet",
        "repro_torch.models.vit", "repro_torch.configs.resnet18",
        "repro_torch.configs.resnet152", "repro_torch.configs.vit_s16",
        "repro_torch.configs.vit_h14",
        "repro_torch.configs.deit_b"} <= set(names)
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_engine_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = TT.init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.CollaborativeServingEngine(params, CFG, cut_layer=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.ServingEngine(params, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_lm(CFG, torch.Generator().manual_seed(0))


def test_cpu_front_door_takes_the_plain_version():
    rng = np.random.RandomState(0)
    q = torch.tensor(rng.randn(2, 3, 4, 8).astype(np.float32))
    kp = torch.tensor(rng.randint(-127, 128, (5, 4, 2, 8)).astype(np.int8))
    vp = torch.tensor(rng.randint(-127, 128, (5, 4, 2, 8)).astype(np.int8))
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([5, 8], dtype=torch.int32)
    q0 = torch.tensor([2, 5], dtype=torch.int32)
    ks = torch.full((2, 2), 0.02)
    before = PA.paged_flash_mq.launches
    out = PA.paged_multiquery_attention(q, kp, vp, bt, lens, q0, ks, ks)
    assert PA.paged_flash_mq.launches == before == 0
    torch.testing.assert_close(
        out, PA.paged_attention_mq_ref(q, kp, vp, bt, lens, q0, ks, ks),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_flash_mq(q, kp, vp, bt, lens, q0, ks, ks)
    assert PA.paged_flash_mq.launches == 0
