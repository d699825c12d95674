"""Data parallelism: one process per GPU under ``torchrun``.

Port of ``npp_tpu/parallel/mesh.py`` and ``zero.py``: ``mesh`` holds the
process group, the DDP wrapper and the collectives, ``sync_bn`` the
cross-rank BatchNorm and ``zero`` ZeRO-1 (``--zero``).
"""
