"""Built-in configurations: the LIP and the Pascal-Person-Part presets,
and the experiment YAMLs that pick and set them.

The card machine has no ``yaml``, so the values of
``experiments/lip/384_384.yaml`` and ``experiments/pascal/384_384.yaml``
as ``npp_tpu/config.py`` loads them are built in here, and ``load_preset``
(the CLIs' ``--cfg``) reads such a file with ``read_yaml``, a reader of
the subset of YAML those files use: nested block mappings, plain and
quoted scalars (strings, ints, floats, booleans), flow lists and
comments. As npp_tpu's ``load_config``, it raises ``ValueError`` on a key
the schema does not hold (``SCHEMA``, a copy of npp_tpu's dataclass
fields). ``DATASET.DATASET`` picks the preset, and the file's values give
its fields. A preset holds a
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

The YAML keys that npp_tpu's CLIs read besides (``TRAIN.BEGIN_EPOCH``,
``TEST.FLIP_TEST``, ``TEST.SCALE_LIST``, ``POSE_GT_PATH``) are the
preset's too: ``train["begin_epoch"]``, the first epoch of a train run
that does not resume; ``test["flip_test"]``, the flip of the eval and
test CLIs; ``test["scale_list"]``, the test CLI's scales; and
``data["pose_gt_path"]``, the LIP pose CSV that the train, search and
eval CLIs score PCKh against where that file exists (an explicit
``--gt-csv`` wins). Only the configured path is read.

Both datasets take OHEM at 0.9 / 131072: ``LOSS.USE_OHEM: False`` in the
YAMLs is read nowhere (``npp_tpu/config.py:56``), and npp_tpu always
applies OHEM. Joint target weights are off, as both released CLIs leave
them. The search's 15 weight-only warmup epochs and its entropy epoch 70
are ``npp_tpu/config.py:121-125``'s defaults; the YAMLs set neither.
"""
from __future__ import annotations

import dataclasses
import re

from npp_tpu_torch.core.criterion import (LIP_CLASS_WEIGHTS,
                                          PASCAL_CLASS_WEIGHTS)

SIGMA, IGNORE = 3, 255  # MODEL.SIGMA and TRAIN.IGNORE_LABEL of both YAMLs
LIP_FLIP_PAIRS = ((14, 15), (16, 17), (18, 19))  # left/right part classes
TINY_CROP = (128, 128)

_LOSS = dict(ohem_thres=0.9, ohem_keep=131072, use_target_weight=False)
_RUN = dict(print_freq=100, workers=8)  # PRINT_FREQ, WORKERS
# experiments/*/384_384.yaml:7, 89-90 (both files hold the same values)
_POSE_GT = "data/LIP/pose_csv/pose_gt.csv"
_TEST = dict(flip_test=True, scale_list=(0.5, 0.75, 1.0, 1.25, 1.5))


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
    test: dict = dataclasses.field(default_factory=lambda: dict(_TEST))

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
               num_samples=5000, begin_epoch=0, **_LOSS, **_RUN),
    search_model=_net(20, 16, 16, 32),
    search=dict(crop=(384, 384), batch_size=7, w_lr=1e-3, alpha_lr=1e-3,
                lr_step=(70, 100), lr_factor=0.2, warmup_epochs=15,
                entropy_epoch=70, epochs=120, **_LOSS, **_RUN),
    # experiments/lip/384_384.yaml:7, 12-24, 57-59, 82-91
    data=dict(pose_gt_path=_POSE_GT, root="data/LIP/",
              train_imroot="train_images",
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
               num_samples=5000, begin_epoch=0, **_LOSS, **_RUN),
    search_model=_net(7, 14, 12, 32),
    search=LIP.search,  # the YAMLs' SEARCH sections differ in LAYERS only
    # experiments/pascal/384_384.yaml:7, 12-24 and tools/augment_lip.py:82-94
    data=dict(pose_gt_path=_POSE_GT, root="data/pascal_data/",
              train_imroot="JPEGImages",
              val_imroot="JPEGImages", train_segroot="SegmentationPart",
              val_segroot="SegmentationPart", train_set="train_id.txt",
              val_set="val_id.txt", pose_root="PersonJoints",
              mask_root="masks"),
    # npp_tpu/data/pascal.py:84-86 (PPPDataset's defaults)
    reader=dict(scale_min=0.5, scale_max=1.25, max_rotate_degree=40,
                max_center_trans=40, flip_prob=0.5))

PRESETS = {p.name: p for p in (LIP, PPP)}


# -- experiment YAMLs -------------------------------------------------------

# npp_tpu's schema (``npp_tpu/config.py:26-232``): the keys each section of
# an experiment YAML may hold (field names; ``_RENAMES`` maps the YAML's
# spellings that differ) and the top-level keys.
SCHEMA = {
    "MODEL": ("num_joints", "image_size", "target_type", "heatmap_size",
              "sigma", "final_conv_kernel", "head", "refine_layers",
              "decoder_layers", "deconv_with_bias", "pretrained_pose",
              "pretrained_par", "num_deconv_layers", "num_deconv_filters",
              "num_deconv_kernels", "num_layers", "name", "style"),
    "LOSS": ("use_ohem", "topk", "use_target_weight",
             "use_different_joints_weight", "ohem_thres", "ohem_keep"),
    "DATASET": ("root", "dataset", "train_set", "test_set", "data_format",
                "num_classes", "num_joints", "train_imroot", "val_imroot",
                "test_imroot", "train_segroot", "val_segroot",
                "extra_train_set", "flip", "scale_factor", "rot_factor",
                "prob_half_body", "num_joints_half_body", "color_rgb",
                "select_data", "hybrid_joints_type"),
    "SEARCH": ("w_lr", "lr_factor", "lr_step", "w_lr_min", "momentum",
               "weight_decay", "nesterov", "init_epochs", "epochs",
               "batch_size", "layers", "init_channels", "resume", "alpha_lr",
               "alpha_weight_decay", "seed", "w_gradclip", "train_set",
               "mini_set", "test_set", "name", "path", "warmup_epochs",
               "entropy_epoch"),
    "TRAIN": ("lr_factor", "lr_step", "lr", "optimizer", "momentum", "wd",
              "nesterov", "layers", "init_channels", "gamma1", "gamma2",
              "begin_epoch", "epochs", "resume", "checkpoint", "batch_size",
              "shuffle", "train_set", "mini_set", "test_set", "sample_set",
              "name", "path", "genotype", "ignore_label", "scale_factor",
              "num_samples", "flip"),
    "TEST": ("batch_size", "flip_test", "post_process", "shift_heatmap",
             "use_gt_bbox", "image_thre", "nms_thre", "soft_nms", "oks_thre",
             "in_vis_thre", "coco_bbox_file", "bbox_thre", "model_file",
             "num_samples", "scale_list", "test_set"),
    "DEBUG": ("debug", "save_batch_images_gt", "save_batch_images_pred",
              "save_heatmaps_gt", "save_heatmaps_pred"),
    "CUDNN": ("benchmark", "deterministic", "enabled"),
}
TOP_KEYS = ("output_dir", "log_dir", "data_dir", "pose_gt_path",
            "pose_pred_path", "gpus", "workers", "print_freq", "mesh_shape",
            "compute_dtype")
_IGNORED_SECTIONS = ("EXTRA_POSE", "EXTRA_PAR")  # accepted, read nowhere
_RENAMES = {"APLHA_LR": "alpha_lr", "W_GRADconfigLIP": "w_gradclip",
            "OHEMTHRES": "ohem_thres", "OHEMKEEP": "ohem_keep"}
# The YAML 1.1 scalars that yaml.safe_load resolves (a float needs a dot).
_BOOL = {**{w: True for w in ("true", "True", "TRUE", "yes", "Yes", "YES",
                              "on", "On", "ON")},
         **{w: False for w in ("false", "False", "FALSE", "no", "No", "NO",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_ESCAPES = {"t": "\t", "n": "\n"}  # of a double-quoted string
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (outside quotes, at the line's
    start or after a blank)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str):
    text = text.strip()
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"{where}: unterminated quote in {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f"{where}: unterminated quote in {text!r}")
        return re.sub(r"\\(.)", lambda m: _ESCAPES.get(m.group(1),
                                                    m.group(1)), text[1:-1])
    if text[:1] == "[":
        if text[-1] != "]":
            raise ValueError(f"{where}: unterminated list {text!r}")
        body = text[1:-1].strip()
        return [_scalar(t, where) for t in body.split(",")] if body else []
    if text[:1] in "{&*!|>":
        raise ValueError(f"{where}: {text!r} is outside the YAML subset "
                         f"this reader takes")
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in ("+.", "-.", "."):
        return float(text.replace("_", ""))
    return text


def read_yaml(text: str, name: str = "<yaml>") -> dict:
    """The nested dict of a YAML document in the subset of the module
    docstring, as ``yaml.safe_load`` gives it."""
    root: dict = {}
    stack = [(-1, root)]
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body.startswith(("\t", "- ", "---")) or body == "-":
            raise ValueError(f"{where}: {body!r} is outside the YAML subset "
                             f"this reader takes")
        key, sep, rest = body.partition(":")
        if not sep or (rest and rest[0] not in " \t"):
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key = _scalar(key, where) if key[:1] in "'\"" else key.strip()
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if key in parent:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if rest.strip():
            parent[key] = _scalar(rest, where)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
    return _empty_as_none(root)


def _empty_as_none(tree: dict) -> dict:
    """A key with nothing under it is null, as ``yaml.safe_load`` reads it."""
    return {k: (None if v == {} else
                _empty_as_none(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def load_yaml_config(path: str) -> dict:
    """An experiment YAML as {section or None: {field: value}}, with
    npp_tpu's field names; raises ``ValueError`` on a key outside the
    schema, as ``npp_tpu.config.load_config`` does."""
    with open(path) as f:
        data = read_yaml(f.read(), path) or {}
    out = {None: {}}
    for key, value in data.items():
        section = key if key in SCHEMA else (
            key.upper() if key.upper() in SCHEMA and isinstance(value, dict)
            else None)
        if section is not None:
            fields = out.setdefault(section, {})
            for k, v in (value or {}).items():
                name = _RENAMES.get(k, k.lower())
                if name not in SCHEMA[section]:  # npp_tpu's message
                    raise ValueError(f"{section.capitalize()}Config.{k} not "
                                     f"a known config key")
                fields[name] = v
        elif key in _IGNORED_SECTIONS:
            continue
        elif key.lower() in TOP_KEYS:
            out[None][key.lower()] = value
        else:
            raise ValueError(f"{key} not a known config section/key")
    return out


def load_preset(path: str) -> Preset:
    """The preset an experiment YAML picks by ``DATASET.DATASET`` (npp_tpu's
    default: lip), with the file's values in its fields: the model widths
    (``TRAIN`` / ``SEARCH`` ``LAYERS`` and ``INIT_CHANNELS``,
    ``MODEL.REFINE_LAYERS``), the crops (``MODEL.IMAGE_SIZE``), the train
    and search hyper-parameters, OHEM, ``PRINT_FREQ``, ``WORKERS`` and the
    dataset layout. The dataset's own tables (class weights, flip pairs,
    the reader's augmentation) stay the preset's, so a file whose class or
    joint counts, sigma or ignore label differ from them is refused, as
    are values the port does not take."""
    cfg = load_yaml_config(path)
    ds, md, tr, sr, loss, te = (cfg.get(k, {}) for k in (
        "DATASET", "MODEL", "TRAIN", "SEARCH", "LOSS", "TEST"))
    name = ds.get("dataset", "lip")
    if name not in PRESETS:
        raise ValueError(f"{path}: DATASET.DATASET {name!r}; the port's "
                         f"presets are {sorted(PRESETS)}")
    base = PRESETS[name]
    fixed = {"DATASET.NUM_CLASSES": (ds.get("num_classes"), base.num_classes),
             "DATASET.NUM_JOINTS": (ds.get("num_joints"), base.num_joints),
             "MODEL.SIGMA": (md.get("sigma"), SIGMA),
             "TRAIN.IGNORE_LABEL": (tr.get("ignore_label"), IGNORE)}
    for key, (got, want) in fixed.items():
        if got is not None and got != want:
            raise ValueError(f"{path}: {key} {got!r}; the {name} preset "
                             f"takes {want!r}")
    top = cfg[None]
    def pick(section: dict, keys) -> dict:
        return {k: (tuple(section[k]) if isinstance(section[k], list)
                    else section[k]) for k in keys if k in section}

    crop = tuple(md.get("image_size", base.train["crop"]))
    common = dict(crop=crop, **pick(top, ("print_freq", "workers")),
                  **pick(loss, ("ohem_thres", "ohem_keep",
                                "use_target_weight")))
    train = dict(base.train, **common, **pick(tr, (
        "batch_size", "lr", "lr_step", "lr_factor", "epochs",
        "num_samples", "begin_epoch")))
    search = dict(base.search, **common, **pick(sr, (
        "batch_size", "w_lr", "alpha_lr", "lr_step", "lr_factor",
        "warmup_epochs", "entropy_epoch", "epochs")))
    refine = md.get("refine_layers", base.model["refine_layers"])
    model = dict(base.model, refine_layers=refine, **{
        k: tr[k] for k in ("layers", "init_channels") if k in tr})
    search_model = dict(base.search_model, refine_layers=refine, **{
        k: sr[k] for k in ("layers", "init_channels") if k in sr})
    data = dict(base.data, **{k: ds[k] for k in (
        "root", "train_imroot", "val_imroot", "test_imroot", "train_segroot",
        "val_segroot") if k in ds and k in base.data},
                **pick(top, ("pose_gt_path",)))
    if name == "lip":
        sets = {"train_set": tr.get("train_set"),
                "val_set": tr.get("test_set"),
                "search_train_set": sr.get("train_set"),
                "search_mini_set": sr.get("mini_set"),
                "search_val_set": sr.get("test_set"),
                "test_set": cfg.get("TEST", {}).get("test_set")}
        data.update({k: v for k, v in sets.items() if v is not None})
    test = dict(base.test, **pick(te, ("flip_test",)))
    if "scale_list" in te:
        test["scale_list"] = tuple(float(v) for v in te["scale_list"])
    return dataclasses.replace(base, model=model, train=train,
                               search_model=search_model, search=search,
                               data=data, test=test)
