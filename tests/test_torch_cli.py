"""The port's CLI surface against npp_tpu's: ``--cfg`` on the five CLIs
whose npp_tpu counterparts require it, the port's reader of the YAML
subset the experiment files use, and ``eval_lip --sample``.

- ``config.read_yaml`` against ``yaml.safe_load`` on both experiment
  YAMLs, and on scalars of every form the subset holds;
- ``config.SCHEMA`` against npp_tpu's dataclass fields, section by
  section, and an unknown key raising npp_tpu's ``ValueError``;
- ``config.load_preset`` on both files against ``npp_tpu.config.
  load_config``, field by field as the port's presets hold them, and
  equal to the built-in presets;
- npp_tpu's README and docstring command lines (``--cfg ...``, trailing
  ``opts``) on each port CLI: the train CLI runs its README line on the
  CPU, the other four parse theirs and resolve the preset;
- a ``--dataset`` that contradicts ``--cfg`` and a PPP file on the
  LIP-only CLIs are refused;
- ``eval_lip --synthetic --batch 4`` evaluates 8 images (npp_tpu's 2 x
  ``--batch``), and ``--sample`` caps a LIP tree's val set;
- the four keys npp_tpu's CLIs read besides the presets' fields, each on
  an edited YAML against ``load_config`` and the CLI that reads it:
  ``TRAIN.BEGIN_EPOCH`` (the train CLI's first epoch; a resume wins),
  ``TEST.FLIP_TEST`` (the eval and test CLIs' flip), ``TEST.SCALE_LIST``
  (the test CLI's scales; ``--tiny`` keeps (0.5, 1.0)) and
  ``POSE_GT_PATH`` (scored against where the file exists; ``--gt-csv``
  wins).
"""
import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import yaml

from npp_tpu import config as jconfig

from npp_tpu_torch import config as tconfig
from npp_tpu_torch.core import evaluate as teval
from npp_tpu_torch.core import test_seg
from npp_tpu_torch.tools import (augment_lip, eval_lip, predict, search_lip,
                                 test_lip)

from test_torch_lip import write_lip_tree

ROOT = Path(__file__).resolve().parent.parent
YAMLS = {"lip": str(ROOT / "experiments" / "lip" / "384_384.yaml"),
         "ppp": str(ROOT / "experiments" / "pascal" / "384_384.yaml")}
CPU = ["--device", "cpu", "--dtype", "float32"]
SECTIONS = {"MODEL": jconfig.ModelConfig, "LOSS": jconfig.LossConfig,
            "DATASET": jconfig.DatasetConfig, "SEARCH": jconfig.SearchConfig,
            "TRAIN": jconfig.TrainConfig, "TEST": jconfig.TestConfig,
            "DEBUG": jconfig.DebugConfig, "CUDNN": jconfig.CudnnConfig}


# -- the YAML reader and the schema -------------------------------------------

@pytest.mark.parametrize("name", sorted(YAMLS))
def test_read_yaml_matches_safe_load(name):
    text = Path(YAMLS[name]).read_text()
    assert tconfig.read_yaml(text) == yaml.safe_load(text)


SCALARS = """\
a: 'quoted # not a comment'  # a comment
b: "x\\ty"
c: plain text
d: None
e: [384, 384]
f: [0.5, 0.75, 1, 1.25, 1.5]
g: True
h: false
i: 131072
j: 0.0001
k: 1e-5
l: -3
m: ''
n:
  deeper:
    x: ~
    y: [a, 'b c']
o: 10_000
"""


def test_read_yaml_scalars_match_safe_load():
    assert tconfig.read_yaml(SCALARS) == yaml.safe_load(SCALARS)


@pytest.mark.parametrize("text", ["a: [1, 2\n", "- a\n", "a: {b: 1}\n",
                                  "a: 1\na: 2\n", "just text\n"])
def test_read_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        tconfig.read_yaml(text)


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_schema_is_npp_tpus(section):
    fields = tuple(f.name for f in dataclasses.fields(SECTIONS[section]))
    assert tconfig.SCHEMA[section] == fields


def test_top_level_keys_are_npp_tpus():
    fields = {f.name for f in dataclasses.fields(jconfig.Config)}
    assert set(tconfig.TOP_KEYS) == fields - {s.lower() for s in SECTIONS}


@pytest.mark.parametrize("where,bad", [("TRAIN:\n", "  LAYERZ: 3\n"),
                                       ("MODEL:\n", "  SIGMAA: 2\n"),
                                       ("DATASET:\n", "BOGUS: 1\n")])
def test_unknown_key_raises_npp_tpus_error(tmp_path, where, bad):
    path = tmp_path / "bad.yaml"
    text = Path(YAMLS["lip"]).read_text()
    path.write_text(text.replace(where, where + bad if bad[0] == " "
                                 else bad + where))
    with pytest.raises(ValueError) as want:
        jconfig.load_config(str(path))
    with pytest.raises(ValueError) as got:
        tconfig.load_preset(str(path))
    assert str(got.value) == str(want.value)


# -- the presets from the files -----------------------------------------------

def _as_preset_holds(cfg, name: str) -> dict:
    """npp_tpu's ``load_config`` result, field by field as the port's
    preset holds it."""
    run = dict(crop=tuple(cfg.model.image_size),
               ohem_thres=cfg.loss.ohem_thres, ohem_keep=cfg.loss.ohem_keep,
               use_target_weight=cfg.loss.use_target_weight,
               print_freq=cfg.print_freq, workers=cfg.workers)
    net = dict(num_classes=cfg.dataset.num_classes,
               num_joints=cfg.dataset.num_joints,
               refine_layers=cfg.model.refine_layers)
    t, s, d = cfg.train, cfg.search, cfg.dataset
    data = dict(root=d.root, train_imroot=d.train_imroot,
                val_imroot=d.val_imroot, train_segroot=d.train_segroot,
                val_segroot=d.val_segroot, pose_gt_path=cfg.pose_gt_path)
    if name == "lip":
        data.update(test_imroot=d.test_imroot, train_set=t.train_set,
                    val_set=t.test_set, search_train_set=s.train_set,
                    search_mini_set=s.mini_set, search_val_set=s.test_set,
                    test_set=cfg.test.test_set)
    return dict(
        counts=dict(name=d.dataset, num_classes=d.num_classes,
                    num_joints=d.num_joints),
        model=dict(net, layers=t.layers, init_channels=t.init_channels),
        train=dict(run, batch_size=t.batch_size, lr=t.lr,
                   lr_step=tuple(t.lr_step), lr_factor=t.lr_factor,
                   epochs=t.epochs, num_samples=t.num_samples,
                   begin_epoch=t.begin_epoch),
        search_model=dict(net, layers=s.layers,
                          init_channels=s.init_channels),
        search=dict(run, batch_size=s.batch_size, w_lr=s.w_lr,
                    alpha_lr=s.alpha_lr, lr_step=tuple(s.lr_step),
                    lr_factor=s.lr_factor, warmup_epochs=s.warmup_epochs,
                    entropy_epoch=s.entropy_epoch, epochs=s.epochs),
        data=data,
        test=dict(flip_test=cfg.test.flip_test,
                  scale_list=tuple(cfg.test.scale_list)))


PRESET_CASES = [(n, part) for n in sorted(YAMLS) for part in (
    "counts", "model", "train", "search_model", "search", "data", "test")]


@pytest.mark.parametrize("name,part", PRESET_CASES,
                         ids=[f"{n}-{p}" for n, p in PRESET_CASES])
def test_preset_from_yaml_matches_load_config(name, part):
    preset = tconfig.load_preset(YAMLS[name])
    want = _as_preset_holds(jconfig.load_config(YAMLS[name]), name)[part]
    held = (dataclasses.asdict(preset) if part == "counts"
            else getattr(preset, part))
    assert {k: held[k] for k in want} == want
    if part != "counts":  # every entry accounted for: PPP's id lists and
        # pose / mask directories are npp_tpu's CLI constants, no YAML key
        extra = ({"train_set", "val_set", "pose_root", "mask_root"}
                 if name == "ppp" and part == "data" else set())
        assert set(held) - set(want) == extra


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_preset_from_yaml_is_the_built_in_one(name):
    assert tconfig.load_preset(YAMLS[name]) == tconfig.PRESETS[name]


def test_a_yaml_value_reaches_the_preset(tmp_path):
    text = Path(YAMLS["lip"]).read_text().replace("BATCH_SIZE: 16",
                                                  "BATCH_SIZE: 12")
    (tmp_path / "lip.yaml").write_text(text)
    preset = tconfig.load_preset(str(tmp_path / "lip.yaml"))
    assert preset.train["batch_size"] == 12
    assert jconfig.load_config(str(tmp_path / "lip.yaml")).train.batch_size \
        == 12


def test_a_dataset_table_the_port_fixes_is_refused(tmp_path):
    text = Path(YAMLS["lip"]).read_text().replace("NUM_CLASSES: 20",
                                                  "NUM_CLASSES: 19")
    (tmp_path / "lip.yaml").write_text(text)
    with pytest.raises(ValueError, match="NUM_CLASSES"):
        tconfig.load_preset(str(tmp_path / "lip.yaml"))


# -- the CLIs -----------------------------------------------------------------

# npp_tpu's command lines: README.md's quick start for the train and search
# CLIs, the CLIs' own docstrings (and the verify skill's drives) for the rest.
README_LINES = {
    "augment_lip": ["--cfg", YAMLS["lip"], "--synthetic", "--tiny", "--steps",
                    "2", "--epochs", "1"],
    "search_lip": ["--cfg", YAMLS["lip"], "--synthetic", "--tiny", "--steps",
                   "2", "--epochs", "1", "--warmup-epochs", "0"],
    "eval_lip": ["--cfg", YAMLS["lip"], "--synthetic", "--tiny"],
    "predict": ["--cfg", YAMLS["lip"], "--synthetic", "4", "--tiny", "--out",
                "preds", "--batch", "2"],
    "test_lip": ["--cfg", YAMLS["lip"], "--synthetic", "--tiny", "--limit",
                 "1"],
}
MODULES = {"augment_lip": augment_lip, "search_lip": search_lip,
           "eval_lip": eval_lip, "predict": predict, "test_lip": test_lip}


@pytest.mark.parametrize("cli", sorted(README_LINES))
def test_npp_tpu_command_line_parses_on_the_port_cli(cli):
    p = MODULES[cli].build_parser()
    args = p.parse_args(README_LINES[cli] + CPU)
    assert args.cfg == YAMLS["lip"]
    assert augment_lip.resolve_preset(p, args) == tconfig.LIP


@pytest.mark.parametrize("cli", ["augment_lip", "search_lip"])
def test_trailing_opts_are_accepted_and_read_nowhere(cli):
    p = MODULES[cli].build_parser()
    args = p.parse_args(["--cfg", YAMLS["ppp"], "--tiny", "TRAIN.LR",
                         "0.5"])
    assert args.opts == ["TRAIN.LR", "0.5"]
    assert augment_lip.resolve_preset(p, args) == tconfig.PPP


def test_readme_train_line_runs_on_the_cpu(tmp_path):
    out = augment_lip.main(README_LINES["augment_lip"] + CPU
                           + ["--out", str(tmp_path)])
    assert np.isfinite(out["train_loss"])
    assert out["state"].model.layers == 8  # --tiny on the file's preset


@pytest.mark.parametrize("cli", ["augment_lip", "search_lip"])
def test_cfg_and_a_contradicting_dataset_are_refused(cli):
    with pytest.raises(SystemExit):
        MODULES[cli].main(["--cfg", YAMLS["ppp"],
                           "--dataset", "lip", "--synthetic", "--tiny"]
                          + CPU)


@pytest.mark.parametrize("cli", ["eval_lip", "predict", "test_lip"])
def test_lip_only_clis_refuse_a_ppp_file(cli):
    argv = README_LINES[cli] + CPU
    argv[1] = YAMLS["ppp"]
    with pytest.raises(SystemExit):
        MODULES[cli].main(argv)


def test_eval_synthetic_evaluates_two_batches(capsys):
    result = eval_lip.main(README_LINES["eval_lip"] + CPU + ["--batch", "4"])
    assert len(result["names"]) == 8
    assert result["pose_preds"].shape == (8, 16, 3)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("n=8 ")


@pytest.fixture(scope="module")
def lip_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lip_cli"))
    write_lip_tree(root, n_train=2, n_val=5, fmt="png", seed=13)
    return root


@pytest.mark.parametrize("sample,n", [(3, 3), (0, 5)])
def test_sample_caps_the_val_set(lip_tree, sample, n):
    """``--sample N`` evaluates the first N val entries; 0 takes the
    configuration's TRAIN.NUM_SAMPLES (5000), here the whole set."""
    res = eval_lip.main(["--cfg", YAMLS["lip"], "--data-root", lip_tree,
                         "--tiny", "--sample", str(sample), "--batch", "2"]
                        + CPU)
    assert res["names"] == [f"val_{i:03d}" for i in range(n)]


# -- the keys npp_tpu's CLIs read besides -------------------------------------

def _edited(tmp_path, old: str, new: str) -> str:
    """The LIP YAML with ``old`` replaced by ``new``, and npp_tpu's reading
    of it."""
    text = Path(YAMLS["lip"]).read_text()
    assert text.count(old) == 1, old
    path = tmp_path / "edited.yaml"
    path.write_text(text.replace(old, new))
    return str(path), jconfig.load_config(str(path))


def test_begin_epoch_starts_a_fresh_train_run(tmp_path):
    """``TRAIN.BEGIN_EPOCH: 1`` with two epochs trains epoch 1 only, as
    npp_tpu's loop (``range(begin_epoch, epochs)``); ``--resume`` then
    begins after the restored epoch, whatever the file says."""
    path, cfg = _edited(tmp_path, "BEGIN_EPOCH: 0", "BEGIN_EPOCH: 1")
    argv = ["--cfg", path, "--synthetic", "--tiny", "--steps", "1",
            "--out", str(tmp_path / "run")] + CPU
    out = augment_lip.main(argv + ["--epochs", "2"])
    assert out["begin_epoch"] == cfg.train.begin_epoch == 1
    saved = os.listdir(out["checkpoints"])
    assert "1" in saved and "0" not in saved, saved
    again = augment_lip.main(argv + ["--epochs", "3", "--resume"])
    assert again["begin_epoch"] == 2


def _captured(monkeypatch, module, name: str, result=None) -> dict:
    """The keyword arguments of the next call to ``module.name`` (which
    then runs, or returns ``result`` if one is given)."""
    seen, real = {}, getattr(module, name)

    def capture(*args, **kw):
        seen.update(kw)
        return real(*args, **kw) if result is None else result

    monkeypatch.setattr(module, name, capture)
    return seen


@pytest.mark.parametrize("cli", ["eval_lip", "test_lip"])
def test_flip_test_is_the_eval_and_test_flip(tmp_path, monkeypatch, cli):
    """``TEST.FLIP_TEST: False`` turns the flip off where npp_tpu's CLIs
    pass ``cfg.test.flip_test``: the eval step of ``eval_lip``, the
    multi-scale test of ``test_lip``."""
    path, cfg = _edited(tmp_path, "FLIP_TEST: True", "FLIP_TEST: False")
    argv = README_LINES[cli] + CPU
    argv[1] = path
    if cli == "eval_lip":
        seen = _captured(monkeypatch, teval, "make_eval_step")
        eval_lip.main(argv)
        assert seen["flip_test"] is cfg.test.flip_test is False
    else:
        seen = _captured(monkeypatch, test_seg, "testval")
        test_lip.main(argv)
        assert seen["flip"] is cfg.test.flip_test is False


@pytest.mark.parametrize("tiny", [False, True])
def test_scale_list_is_the_test_cli_scales(tmp_path, monkeypatch, tiny):
    """``TEST.SCALE_LIST`` gives ``test_lip``'s scales; ``--tiny`` keeps
    (0.5, 1.0), as npp_tpu's CLI. The model is the tiny one either way
    (the flagship's forward is not this test's subject)."""
    path, cfg = _edited(tmp_path, "SCALE_LIST: [0.5, 0.75, 1, 1.25, 1.5]",
                        "SCALE_LIST: [0.75, 1.25]")
    real = test_lip.load_eval_model
    monkeypatch.setattr(test_lip, "load_eval_model",
                        lambda *a, **kw: real(*a, **dict(kw, tiny=True)))
    seen = _captured(monkeypatch, test_seg, "testval")
    test_lip.main(["--cfg", path, "--synthetic", "--limit", "1"]
                  + (["--tiny"] if tiny else []) + CPU)
    want = (0.5, 1.0) if tiny else tuple(cfg.test.scale_list)
    assert tuple(seen["scales"]) == want
    assert tiny or want == (0.75, 1.25)


def test_pose_gt_path_is_scored_against(tmp_path, lip_tree):
    """``POSE_GT_PATH`` naming an existing LIP pose CSV adds the PCKh, as
    npp_tpu's ``resolve_pose_gt_csv(cfg.pose_gt_path)``."""
    gt = os.path.join(lip_tree, "pose_gt.csv")
    path, cfg = _edited(tmp_path, "POSE_GT_PATH: 'data/LIP/pose_csv/"
                        "pose_gt.csv'", f"POSE_GT_PATH: '{gt}'")
    assert cfg.pose_gt_path == gt
    res = eval_lip.main(["--cfg", path, "--data-root", lip_tree, "--tiny",
                         "--sample", "3", "--batch", "2"] + CPU)
    assert np.isfinite(res["pck_avg"])


@pytest.mark.parametrize("case", ["explicit", "configured", "missing",
                                  "synthetic", "ppp"])
def test_pose_gt_csv_resolution(tmp_path, case):
    """``--gt-csv`` wins over ``POSE_GT_PATH``; the configured file is
    read only where it exists, only from a LIP directory."""
    gt = tmp_path / "gt.csv"
    gt.write_text("")
    preset = dataclasses.replace(tconfig.LIP, data=dict(
        tconfig.LIP.data, pose_gt_path=str(gt) if case != "missing"
        else str(tmp_path / "absent.csv")))
    if case == "ppp":
        preset = dataclasses.replace(preset, name="ppp")
    args = argparse.Namespace(gt_csv="other.csv" if case == "explicit"
                              else "")
    root = None if case == "synthetic" else str(tmp_path)
    want = {"explicit": "other.csv", "configured": str(gt)}.get(case)
    assert augment_lip.pose_gt_csv(args, preset, root) == want
