"""The port and chip_smoke.py import neither JAX nor the JAX package.

Checked in a fresh interpreter, because this test process has imported
jax already (tests/conftest.py). Importing also builds nothing. The
search slice's modules are also imported each on its own, so that none
of them leans on another module having been imported first.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import npp_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(npp_tpu_torch.__path__,
                                              "npp_tpu_torch.")]
for name in mods + ["chip_smoke"]:
    importlib.import_module(name)
from npp_tpu_torch.ops import heatmaps
assert not heatmaps._LIBRARY, "importing built the kernel"
assert heatmaps.render_heatmaps.launches == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2",
                                    "yaml", "npp_tpu"))
print(len(mods), bad)
"""

BANNED = ("jax", "jaxlib", "flax", "optax", "cv2", "yaml", "npp_tpu")
SEARCH_MODULES = ("npp_tpu_torch.models.search",
                  "npp_tpu_torch.models.genotype_parse",
                  "npp_tpu_torch.core.search",
                  "npp_tpu_torch.core.checkpoint",
                  "npp_tpu_torch.tools.search_lip")


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_imports_no_jax_cv2_yaml_or_npp_tpu():
    n_mods, bad = _run(PROBE).split(" ", 1)
    assert int(n_mods) >= 30
    assert bad.strip() == "[]", bad


@pytest.mark.parametrize("module", SEARCH_MODULES)
def test_search_module_imports_alone_without_jax(module):
    bad = _run(f"import importlib, sys\n"
               f"importlib.import_module({module!r})\n"
               f"print(sorted(m for m in sys.modules\n"
               f"             if m.split('.')[0] in {BANNED!r}))")
    assert bad.strip() == "[]", bad
