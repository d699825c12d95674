"""npp_tpu_torch — the PyTorch / CUDA port of npp_tpu for NVIDIA Hopper.

The JAX package ``npp_tpu`` is the reference: every module here mirrors a
module of the same name there and is held against it by the CPU tests
(``tests/test_torch_*.py``). Tensors are NCHW in semantics; on the card
the model runs in ``channels_last`` memory format under bf16 autocast.

The package imports torch and numpy only, never jax. Importing it builds
nothing: the one hand-written CUDA kernel (``ops/csrc/``) is compiled
with ``nvcc`` at its first launch on a CUDA tensor.

The slices ported so far: the flagship NPPNet flip-TTA evaluation
(``python -m npp_tpu_torch.tools.eval_lip --synthetic``), the
augment-phase training (``python -m npp_tpu_torch.tools.augment_lip
--synthetic``) and the bi-level interaction search
(``python -m npp_tpu_torch.tools.search_lip --synthetic``), each on the
card by default.
"""
