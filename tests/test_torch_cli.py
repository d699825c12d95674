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
  ``--batch``), and ``--sample`` caps a LIP tree's val set.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import yaml

from npp_tpu import config as jconfig

from npp_tpu_torch import config as tconfig
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
                val_segroot=d.val_segroot)
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
                   epochs=t.epochs, num_samples=t.num_samples),
        search_model=dict(net, layers=s.layers,
                          init_channels=s.init_channels),
        search=dict(run, batch_size=s.batch_size, w_lr=s.w_lr,
                    alpha_lr=s.alpha_lr, lr_step=tuple(s.lr_step),
                    lr_factor=s.lr_factor, warmup_epochs=s.warmup_epochs,
                    entropy_epoch=s.entropy_epoch, epochs=s.epochs),
        data=data)


PRESET_CASES = [(n, part) for n in sorted(YAMLS) for part in (
    "counts", "model", "train", "search_model", "search", "data")]


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
