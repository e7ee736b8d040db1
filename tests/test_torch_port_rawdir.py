"""The port's train CLI on file corpora (``cli/train.py --raw_dir``)
against the JAX CLI: six pieces of the repo's ``data_synth/`` with two held
out by a split file, twelve-interval transposition, a tiny width; and the
data module of each corpus layout the CLI detects (MusicXML, time-divided,
AugmentedNet joint and RNA TSV directories).

Tolerances: the resolved configs are equal, ``model_config.json`` is
byte-equal, the data modules' splits and samples are equal.  The Trainer runs (two
epochs of two optimizer steps, validation after each, the test split at
the end), from the same parameters with dropout 0, agree within 1e-4
relative plus 1e-6 absolute: Adam moves a coordinate whose gradient is near
rounding level by up to the rate on either side (see
``test_torch_port_train.py``), which reaches the later losses a little
(``test_torch_port_trainer.py`` holds the demo corpus to the same bound).
"""

import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest

from analysisgnn_tpu.cli import train as jcli
from analysisgnn_tpu.data import corpus as jcorpus
from analysisgnn_tpu.data import graph_build as jgraph_build
from analysisgnn_tpu.train import loop as jloop
from analysisgnn_tpu_torch.cli import train as tcli
from analysisgnn_tpu_torch.convert import state_dict_from_flax
from analysisgnn_tpu_torch.train import loop as tloop
from tests.test_musicxml import SCORE
from tests.test_time_divided import _write_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECES = ["synth_07_000", "synth_07_001", "synth_07_002", "synth_07_003", "synth_07_020", "synth_07_021"]
TEST_PIECES = ["synth_07_020", "synth_07_021"]
FLAGS = ["--num_layers", "1", "--hidden_channels", "16", "--out_channels", "8", "--subgraph_size", "24",
         "--batch_size", "20", "--main_tasks", "all", "--num_epochs", "2", "--use_transpositions",
         "--max_steps_per_epoch", "2", "--dropout", "0", "--do_train", "--do_eval"]
TRAINER_RTOL, TRAINER_ATOL = 1e-4, 1e-6


def _corpus(root):
    """A copy of six data_synth pieces and a split file naming two."""
    os.makedirs(root / "all")
    for name in PIECES:
        shutil.copy(os.path.join(REPO, "data_synth", "all", f"{name}.tsv"), root / "all")
    (root / "test_split.json").write_text(json.dumps(TEST_PIECES))
    return ["--raw_dir", str(root), "--test_split_file", str(root / "test_split.json")]


def _metrics(text):
    return json.loads(text[text.index("{"):])


def test_raw_dir_cli_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jcorpus, "build_score_graph", functools.partial(jgraph_build.build_score_graph,
                                                                        use_native=False))
    init, dms = [], []
    jinit, jbuild = jloop.Trainer._init_state, jcli.build_datamodule

    def capture_init(self, example):  # the JAX Trainer's initial parameters, copied before its steps donate them
        state = jinit(self, example)
        init.append(jax.tree_util.tree_map(np.array, state.params))
        return state

    def capture_dm(config):
        dms.append(jbuild(config))
        return dms[-1]

    monkeypatch.setattr(jloop.Trainer, "_init_state", capture_init)
    monkeypatch.setattr(jcli, "build_datamodule", capture_dm)
    jargv = [*_corpus(tmp_path / "j"), *FLAGS, "--checkpoint_dir", str(tmp_path / "j_ckpt")]
    capsys.readouterr()
    jcli.main(jargv)
    jtest = _metrics(capsys.readouterr().out)

    tfit = tloop.Trainer.fit
    sd = state_dict_from_flax(init[0], {"num_layers": 1})
    monkeypatch.setattr(tloop.Trainer, "fit", lambda self, **kw: tfit(self, initial_state_dict=sd, **kw))
    targv = [*_corpus(tmp_path / "t"), *FLAGS, "--checkpoint_dir", str(tmp_path / "t_ckpt"), "--device", "cpu"]
    trainer = tcli.main(targv)
    ttest = _metrics(capsys.readouterr().out)

    want_cfg, got_cfg = jcli.resolve_config(jargv), tcli.resolve_config(targv)
    assert got_cfg.pop("device") == "cpu"
    for cfg in (want_cfg, got_cfg):  # the two copies of the corpus
        for k in ("raw_dir", "test_split_file", "checkpoint_dir"):
            cfg.pop(k)
    assert got_cfg == want_cfg
    assert (tmp_path / "t_ckpt" / "model_config.json").read_bytes() == (
        tmp_path / "j_ckpt" / "model_config.json").read_bytes()

    jdm, tdm = dms[0], trainer.dm
    assert tdm.splits == jdm.splits and tdm.feature_dim == jdm.feature_dim == 25
    samples = tdm.task_samples["all"]
    assert len(samples) == len(jdm.task_samples["all"]) and len({s.transposition for s in samples}) == 12
    assert sorted(s.name for s in samples if s.test) == [f"{p}_P1" for p in TEST_PIECES]
    assert len([f for f in os.listdir(tmp_path / "t" / ".cache") if f.endswith(".done")]) == len(PIECES)

    jhist = [json.loads(line) for line in open(tmp_path / "j_ckpt" / "log.jsonl")]
    assert len(trainer.history) == len(jhist) == 2 and trainer.step_seconds and len(trainer.step_seconds) == 4
    for epoch, (trec, jrec) in enumerate(zip(trainer.history, jhist)):
        assert set(trec) == set(jrec), epoch
        for k, v in jrec.items():
            if k == "train_loss" or k.startswith("val/"):
                assert trec[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), f"epoch {epoch} {k}"
    assert set(ttest) == set(jtest) and "all/localkey_acc" in ttest
    for k, v in jtest.items():
        assert ttest[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), k
    assert (tmp_path / "t_ckpt" / "last.pt").is_file()


def _layout(root, layout):
    """A raw_dir whose main-task directory holds one corpus layout."""
    src = os.path.join(REPO, "data_synth", "all")
    if layout == "musicxml":
        os.makedirs(root / "cadence")
        (root / "cadence" / "a.musicxml").write_text(SCORE)
        return "cadence"
    if layout == "time_divided":
        os.makedirs(root / "rna")
        for split in ("training", "test"):
            _write_fixture(str(root / "rna" / f"{split}-x.tsv"))
        return "rna"
    if layout == "an_joint":
        for split, name in zip(("training", "test", "validation"), PIECES):
            os.makedirs(root / "rna" / split)
            shutil.copy(os.path.join(src, f"{name}.tsv"), root / "rna" / split / f"{name}_joint.tsv")
        return "rna"
    os.makedirs(root / "rna")  # an RNA TSV corpus: AugmentedNet labels, rows without a tpc kept
    for name in PIECES[:3]:
        shutil.copy(os.path.join(src, f"{name}.tsv"), root / "rna")
    return "rna"


@pytest.mark.parametrize("layout", ["musicxml", "time_divided", "an_joint", "rna_tsv"])
def test_raw_dir_layouts_match_jax(layout, tmp_path, monkeypatch):
    """Each layout the CLI detects gives the JAX CLI's samples and splits."""
    monkeypatch.setattr(jcorpus, "build_score_graph", functools.partial(jgraph_build.build_score_graph,
                                                                        use_native=False))
    dms = []
    for side, cli, extra in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        task = _layout(tmp_path / side, layout)
        argv = ["--raw_dir", str(tmp_path / side), "--main_tasks", task, "--use_transpositions", "--subgraph_size",
                "24", *extra]
        dms.append(cli.build_datamodule(cli.resolve_config(argv)))
    jdm, tdm = dms
    assert tdm.splits == jdm.splits and list(tdm.task_samples) == list(jdm.task_samples) == [task]
    js, ts = jdm.task_samples[task], tdm.task_samples[task]
    assert len(ts) == len(js) > 1
    for j, t in zip(js, ts):
        assert (t.name, t.transposition, t.test, t.split) == (j.name, j.transposition, j.test, j.split)
        for part in ("features", "edges", "note_attrs"):
            assert list(getattr(t, part)) == list(getattr(j, part)), (j.name, part)
            for k, v in getattr(j, part).items():
                np.testing.assert_array_equal(getattr(t, part)[k], v, err_msg=f"{j.name} {part} {k}")
