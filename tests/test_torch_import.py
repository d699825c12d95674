"""The port and chip_smoke.py import neither JAX nor the JAX package,
nor cv2, PIL or yaml, which the card machine lacks.

Checked in a fresh interpreter, because this test process has imported
jax already (tests/conftest.py). Importing also builds nothing: neither
the heatmap kernel nor the readers' host library. The search,
serving, PPP / chain, LIP reader, PPP reader / fused-warp,
data-parallel, spatial, tensor-parallel and serving-layout slices'
modules, and the library modules (the context heads, the summary, the
keypoint transforms, the zip reader), are also imported each on its own,
so that none of them leans on another module having been imported first.
``import npp_tpu_torch`` alone imports none of its submodules; its lazy
exports resolve.
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
from npp_tpu_torch.ops import heatmaps, quantize
from npp_tpu_torch.data import imgproc
assert not heatmaps._LIBRARY, "importing built the kernel"
assert not quantize._LIBRARY, "importing built the int8 kernel"
assert not imgproc._LIBRARY, "importing built the host library"
assert heatmaps.render_heatmaps.launches == 0
assert quantize.conv_s8.launches == 0
assert quantize.quantize_act.launches == quantize.act_absmax.launches == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2",
                                    "PIL", "yaml", "npp_tpu"))
print(len(mods), bad)
"""

BANNED = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "yaml", "npp_tpu")
SEARCH_MODULES = ("npp_tpu_torch.models.search",
                  "npp_tpu_torch.models.genotype_parse",
                  "npp_tpu_torch.core.search",
                  "npp_tpu_torch.core.checkpoint",
                  "npp_tpu_torch.tools.search_lip")
SERVE_MODULES = ("npp_tpu_torch.core.predictor",
                 "npp_tpu_torch.core.multiscale",
                 "npp_tpu_torch.core.test_seg",
                 "npp_tpu_torch.core.loading",
                 "npp_tpu_torch.utils.vis",
                 "npp_tpu_torch.tools.predict",
                 "npp_tpu_torch.tools.test_lip")
PPP_MODULES = ("npp_tpu_torch.config",
               "npp_tpu_torch.core.evaluate",
               "npp_tpu_torch.utils.metrics",
               "npp_tpu_torch.tools.augment_lip",
               "npp_tpu_torch.tools.eval_lip",
               "npp_tpu_torch.tools.eval_ppp_map")
LIP_MODULES = ("npp_tpu_torch.data.imgproc",
               "npp_tpu_torch.data.augmentation",
               "npp_tpu_torch.data.targets",
               "npp_tpu_torch.data.lip")
DATA_MODULES = ("npp_tpu_torch.data.fast_aug",
                "npp_tpu_torch.data.pascal")
PARALLEL_MODULES = ("npp_tpu_torch.parallel.mesh",
                    "npp_tpu_torch.parallel.sync_bn",
                    "npp_tpu_torch.parallel.zero",
                    "npp_tpu_torch.parallel.spatial",
                    "npp_tpu_torch.parallel.tensor")
LAYOUT_MODULES = ("npp_tpu_torch.ops.quantize",
                  "npp_tpu_torch.models.cells",
                  "npp_tpu_torch.models.augment",
                  "npp_tpu_torch.utils.convert")
LIBRARY_MODULES = ("npp_tpu_torch.ops.heads",
                   "npp_tpu_torch.utils.summary",
                   "npp_tpu_torch.utils.transforms",
                   "npp_tpu_torch.utils.zipreader")


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


QUANT_PROBE = """
from npp_tpu_torch.ops import heatmaps


def refuse(*args, **kwargs):
    raise AssertionError("importing built a kernel")


heatmaps.nvcc_build = refuse
from npp_tpu_torch.ops import quantize
assert not quantize._LIBRARY and not quantize._COUNTERS
assert quantize._CSRC.name == "int8_conv.cu" and quantize._CSRC.is_file()
assert quantize._QSRC.name == "int8_quantize.cu"
assert quantize._QSRC.is_file()
print("ok")
"""


def test_int8_layer_imports_without_building_and_names_its_sources():
    """Importing ``ops.quantize`` (with the build refused) builds neither
    int8 kernel, and it names both sources, the conv's and the activation
    quantize's."""
    assert _run(QUANT_PROBE).strip() == "ok"


def test_port_imports_no_jax_cv2_yaml_or_npp_tpu():
    n_mods, bad = _run(PROBE).split(" ", 1)
    assert int(n_mods) >= 49
    assert bad.strip() == "[]", bad


@pytest.mark.parametrize("module",
                         SEARCH_MODULES + SERVE_MODULES + PPP_MODULES
                         + LIP_MODULES + DATA_MODULES + PARALLEL_MODULES
                         + LAYOUT_MODULES + LIBRARY_MODULES)
def test_search_module_imports_alone_without_jax(module):
    bad = _run(f"import importlib, sys\n"
               f"importlib.import_module({module!r})\n"
               f"print(sorted(m for m in sys.modules\n"
               f"             if m.split('.')[0] in {BANNED!r}))")
    assert bad.strip() == "[]", bad


LAZY_PROBE = """
import sys
import npp_tpu_torch
loaded = sorted(m for m in sys.modules if m.startswith("npp_tpu_torch."))
assert not loaded, loaded
names = list(npp_tpu_torch.__all__)
for name in names:
    getattr(npp_tpu_torch, name)
from npp_tpu_torch.ops import heatmaps, quantize
from npp_tpu_torch.data import imgproc
assert not heatmaps._LIBRARY and not quantize._LIBRARY
assert not imgproc._LIBRARY
print(len(names), sorted(m for m in sys.modules
                         if m.split(".")[0] in BANNED))
""".replace("BANNED", repr(BANNED))


def test_top_level_import_is_light_and_exports_resolve():
    """``import npp_tpu_torch`` imports no submodule; resolving every
    export builds nothing and imports none of ``BANNED``."""
    n, bad = _run(LAZY_PROBE).split(" ", 1)
    assert int(n) == 12
    assert bad.strip() == "[]", bad
