"""The port and chip_smoke.py import neither JAX nor the JAX package.

Checked in a fresh interpreter, because this test process has imported
jax already (tests/conftest.py). Importing also builds nothing.
"""
import os
import subprocess
import sys
from pathlib import Path

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


def test_port_imports_no_jax_cv2_yaml_or_npp_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.split(" ", 1)
    assert int(n_mods) >= 26
    assert bad.strip() == "[]", bad
