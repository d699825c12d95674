"""npp_tpu_torch — the PyTorch / CUDA port of npp_tpu for NVIDIA Hopper.

The JAX package ``npp_tpu`` is the reference: every module here mirrors a
module of the same name there and is held against it by the CPU tests
(``tests/test_torch_*.py``). Tensors are NCHW in semantics; on the card
the model runs in ``channels_last`` memory format under bf16 autocast.

The package imports torch, numpy, scipy and the standard library, never
jax, cv2, PIL or yaml. Importing it builds nothing and imports no
submodule: the three hand-written CUDA kernels (``ops/csrc/``: the
heatmap renderer, the int8 conv and the int8 activation quantize) are
compiled with ``nvcc`` at their first launch on a CUDA tensor, and the
host image library (``data/csrc/``) with the host C++ compiler at its
first use.

What it runs, each on the card by default (``--device cpu`` for the CPU):

- the NPPNet flip-TTA evaluation (``python -m
  npp_tpu_torch.tools.eval_lip``), the augment-phase training
  (``tools.augment_lip``) and the bi-level search (``tools.search_lip``),
  on LIP or PPP, synthetic or read from disk;
- serving (``core.predictor.Predictor``, ``tools.predict``,
  ``tools.test_lip``) in the standard, fused and int8 layouts;
- data, spatial and tensor parallelism (``parallel/``), the weight and
  run-state bridges to and from npp_tpu (``utils/convert``);
- the library around the model: the context heads (``ops/heads``), the
  parameter and FLOP counts (``utils/summary``), the keypoint transforms
  (``utils/transforms``), the zip reader (``utils/zipreader``) and the
  debug drawings (``utils/vis``), without cv2.

Convenience top-level API (lazily imported), under npp_tpu's names::

    from npp_tpu_torch import NPPNet, Predictor, build_model, load_config

Where the port's function has its own name, the export carries
npp_tpu's: ``build_model`` is ``models.augment.build_nppnet``,
``load_config`` is ``config.load_preset`` and the ``*_variables`` layout
converters are ``models.augment``'s ``*_state`` functions over a
``state_dict``.
"""
import importlib

__version__ = "0.1.0"

# npp_tpu's name -> (module, the port's name)
_EXPORTS = {
    "NPPNet": ("npp_tpu_torch.models.augment", "NPPNet"),
    "build_model": ("npp_tpu_torch.models.augment", "build_nppnet"),
    "fuse_neck_variables": ("npp_tpu_torch.models.augment",
                            "fuse_neck_state"),
    "unfuse_neck_variables": ("npp_tpu_torch.models.augment",
                              "unfuse_neck_state"),
    "fuse_sibling_variables": ("npp_tpu_torch.models.augment",
                               "fuse_sibling_state"),
    "unfuse_sibling_variables": ("npp_tpu_torch.models.augment",
                                 "unfuse_sibling_state"),
    "SearchNet": ("npp_tpu_torch.models.search", "SearchNet"),
    "Genotype": ("npp_tpu_torch.genotypes", "Genotype"),
    "Predictor": ("npp_tpu_torch.core.predictor", "Predictor"),
    "load_config": ("npp_tpu_torch.config", "load_preset"),
    "load_eval_model": ("npp_tpu_torch.core.loading", "load_eval_model"),
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module 'npp_tpu_torch' has no attribute {name!r}")
    module, attr = target
    return getattr(importlib.import_module(module), attr)


def __dir__():
    return __all__
