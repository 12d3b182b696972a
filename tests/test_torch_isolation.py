"""Rules of the PyTorch port: it imports nothing of JAX, flax or the JAX
package, and its entry points run on the card unless told otherwise."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

from balancedgroupsoftmax_torch import apis

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "balancedgroupsoftmax_torch"

IMPORT_WITHOUT_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "balancedgroupsoftmax_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "balancedgroupsoftmax_tpu") and sys.modules[m] is not None)
assert not bad, bad
print("ok", len(sys.argv) - 1)
"""


def port_modules():
    return ["balancedgroupsoftmax_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "balancedgroupsoftmax_torch.")
    ]


def test_every_module_and_chip_smoke_import_without_jax():
    names = port_modules() + ["chip_smoke"]
    assert "balancedgroupsoftmax_torch.models.detector" in names
    flow = ["data.lvis", "utils.checkpoint", "eval.results", "eval.lvis_eval", "tools.mini_lvis",
            "tools.gs_partition", "tools.train", "tools.test_lvis", "tools.eval_lvis"]
    assert {f"balancedgroupsoftmax_torch.{m}" for m in flow} <= set(names)
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_WITHOUT_JAX, *names],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(names))]


def test_no_source_file_names_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 10
    for p in files:
        assert "balancedgroupsoftmax_tpu" not in p.read_text(), p


def test_init_detector_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(apis.torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(apis, "build_model", lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        apis.init_detector()
    assert not built  # refused before building anything on the CPU


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    import torch

    from balancedgroupsoftmax_torch import cuda
    from balancedgroupsoftmax_torch.ops.nms import nms_keep_batched

    before = [k.launches for k in cuda.KERNELS]
    keep = nms_keep_batched(torch.zeros(1, 3, 4), torch.ones(1, 3, dtype=torch.bool), 0.5)
    assert keep.tolist() == [[True, False, False]]
    assert [k.launches for k in cuda.KERNELS] == before


def test_every_launcher_signature_matches_its_c_declaration_and_fits_the_launch_slots():
    """`cuda.SIGNATURES` gives each launcher as many arguments as its C
    declaration in `csrc/` takes, and no more than the slots
    `csrc/pylaunch.cu` packs (a launcher with more would be refused on the
    card at every launch)."""
    import re

    from balancedgroupsoftmax_torch import cuda

    slots = int(re.search(r"kMaxSlots = (\d+);", (PORT / "csrc" / "pylaunch.cu").read_text()).group(1))
    sources = "".join(p.read_text() for p in sorted((PORT / "csrc").glob("*.cu")))
    for symbol, kinds in cuda.SIGNATURES.items():
        declared = re.search(rf"\bint {symbol}\(([^)]*)\)\s*{{", sources)
        assert declared, symbol
        assert len(declared.group(1).split(",")) == len(kinds) <= slots, symbol
