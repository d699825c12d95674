"""Built-in configurations: the LIP and the Pascal-Person-Part presets.

The port reads no YAML (the card machine has no ``yaml``), so the values
of ``experiments/lip/384_384.yaml`` and ``experiments/pascal/384_384.yaml``
as ``npp_tpu/config.py`` loads them are built in here. A preset holds a
dataset's class and joint counts, its parsing class weights and flip
pairs, the fixed NPPNet (``model``) with its train hyper-parameters
(``train``), and the supernet (``search_model``) with its search
hyper-parameters (``search``). ``tiny`` gives the small test
configuration of each, as the JAX CLIs' ``--tiny`` overrides make it:
L=8, C=8, 128x128 crops, batch 4 for training and 2 for the search.

Each preset also holds its dataset layout (``data``) and its reader's
augmentation defaults (``reader``: ``LIPDataset``'s and ``PPPDataset``'s,
which the YAMLs' ``ROT_FACTOR`` and ``SCALE_FACTOR`` do not reach). LIP's
layout is the YAML's root, image and label directories and annotation
files of each split, as ``npp_tpu/config.py`` loads them; PPP's is the
YAML's root, image and label directories with the id lists, pose
``.mat`` and mask ``.npy`` directories that ``tools/augment_lip.py``
pairs with them.

Both datasets take OHEM at 0.9 / 131072: ``LOSS.USE_OHEM: False`` in the
YAMLs is read nowhere (``npp_tpu/config.py:56``), and npp_tpu always
applies OHEM. Joint target weights are off, as both released CLIs leave
them. The search's 15 weight-only warmup epochs and its entropy epoch 70
are ``npp_tpu/config.py:121-125``'s defaults; the YAMLs set neither.
"""
from __future__ import annotations

import dataclasses

from npp_tpu_torch.core.criterion import (LIP_CLASS_WEIGHTS,
                                          PASCAL_CLASS_WEIGHTS)

SIGMA, IGNORE = 3, 255  # MODEL.SIGMA and TRAIN.IGNORE_LABEL of both YAMLs
LIP_FLIP_PAIRS = ((14, 15), (16, 17), (18, 19))  # left/right part classes
TINY_CROP = (128, 128)

_LOSS = dict(ohem_thres=0.9, ohem_keep=131072, use_target_weight=False)
_RUN = dict(print_freq=100, workers=8)  # PRINT_FREQ, WORKERS


def _net(num_classes: int, num_joints: int, layers: int,
         init_channels: int) -> dict:
    return dict(num_classes=num_classes, num_joints=num_joints,
                layers=layers, init_channels=init_channels, refine_layers=1)


@dataclasses.dataclass(frozen=True)
class Preset:
    """One dataset's built-in configuration (see the module docstring).
    ``model`` and ``search_model`` are NPPNet / SearchNet keyword
    arguments; ``train`` and ``search`` the CLIs' hyper-parameters, with
    the crop as (width, height)."""
    name: str
    num_classes: int
    num_joints: int
    class_weights: tuple
    flip_pairs: tuple
    model: dict
    train: dict
    search_model: dict
    search: dict
    data: dict = dataclasses.field(default_factory=dict)
    reader: dict = dataclasses.field(default_factory=dict)

    def train_config(self, tiny: bool = False) -> tuple[dict, dict]:
        """(NPPNet keyword arguments, train hyper-parameters)."""
        if not tiny:
            return self.model, self.train
        return (dict(self.model, layers=8, init_channels=8),
                dict(self.train, crop=TINY_CROP, batch_size=4))

    def search_config(self, tiny: bool = False) -> tuple[dict, dict]:
        """(SearchNet keyword arguments, search hyper-parameters)."""
        if not tiny:
            return self.search_model, self.search
        return (dict(self.search_model, layers=8, init_channels=8),
                dict(self.search, crop=TINY_CROP, batch_size=2))


LIP = Preset(
    name="lip", num_classes=20, num_joints=16,
    class_weights=LIP_CLASS_WEIGHTS, flip_pairs=LIP_FLIP_PAIRS,
    model=_net(20, 16, 16, 64),
    train=dict(crop=(384, 384), batch_size=16, lr=0.0015,
               lr_step=(150, 170), lr_factor=0.2, epochs=190,
               num_samples=5000, **_LOSS, **_RUN),
    search_model=_net(20, 16, 16, 32),
    search=dict(crop=(384, 384), batch_size=7, w_lr=1e-3, alpha_lr=1e-3,
                lr_step=(70, 100), lr_factor=0.2, warmup_epochs=15,
                entropy_epoch=70, epochs=120, **_LOSS, **_RUN),
    # experiments/lip/384_384.yaml:12-24, 57-59, 82-91
    data=dict(root="data/LIP/", train_imroot="train_images",
              val_imroot="val_images", test_imroot="val_images",
              train_segroot="train_segmentations",
              val_segroot="val_segmentations",
              train_set="jsons/LIP_SP_TRAIN_annotations.json",
              val_set="jsons/LIP_SP_VAL_annotations.json",
              search_train_set="jsons/LIP_SP_SEARCH_annotations_w.json",
              search_mini_set="jsons/LIP_SP_SEARCH_annotations_a.json",
              search_val_set="jsons/LIP_SP_VAL_annotations.json",
              test_set="jsons/LIP_SP_VAL_annotations.json"),
    # npp_tpu/data/lip.py:44-46 (LIPDataset's defaults)
    reader=dict(scale_min=0.7, scale_max=1.3, max_rotate_degree=40,
                max_center_trans=40, flip_prob=0.5))

PPP = Preset(
    name="ppp", num_classes=7, num_joints=14,
    class_weights=PASCAL_CLASS_WEIGHTS, flip_pairs=(),
    model=_net(7, 14, 16, 64),
    train=dict(crop=(384, 384), batch_size=2, lr=0.001,
               lr_step=(75, 85, 95), lr_factor=0.1, epochs=150,
               num_samples=5000, **_LOSS, **_RUN),
    search_model=_net(7, 14, 12, 32),
    search=LIP.search,  # the YAMLs' SEARCH sections differ in LAYERS only
    # experiments/pascal/384_384.yaml:12-24 and tools/augment_lip.py:82-94
    data=dict(root="data/pascal_data/", train_imroot="JPEGImages",
              val_imroot="JPEGImages", train_segroot="SegmentationPart",
              val_segroot="SegmentationPart", train_set="train_id.txt",
              val_set="val_id.txt", pose_root="PersonJoints",
              mask_root="masks"),
    # npp_tpu/data/pascal.py:84-86 (PPPDataset's defaults)
    reader=dict(scale_min=0.5, scale_max=1.25, max_rotate_degree=40,
                max_center_trans=40, flip_prob=0.5))

PRESETS = {p.name: p for p in (LIP, PPP)}
