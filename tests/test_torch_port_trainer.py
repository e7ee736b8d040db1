"""The port's combined-mode ``Trainer`` and train CLI against the JAX
package's.

Tolerances: a whole ``Trainer`` run (four optimizer steps, validation after
each epoch, the test split at the end), from the same parameters with
dropout 0, within 1e-4 relative plus 1e-6 absolute: Adam moves a coordinate
whose gradient is near rounding level by up to the rate on either side (see
``test_torch_port_train.py``), which reaches the later losses a little.  The
CLI's resolved configs are equal and its ``model_config.json`` files
byte-equal.
"""

import dataclasses
import functools
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from analysisgnn_tpu.cli import train as jcli
from analysisgnn_tpu.data import corpus as jcorpus
from analysisgnn_tpu.data import datamodule as jdm
from analysisgnn_tpu.data import graph_build as jgraph_build
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu.train import loop as jloop
from analysisgnn_tpu_torch.cli import train as tcli
from analysisgnn_tpu_torch.cli.predict import load_model
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from analysisgnn_tpu_torch.data import corpus as tcorpus
from analysisgnn_tpu_torch.data import datamodule as tdm
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.inference.predict import predict_score_ids
from analysisgnn_tpu_torch.train import loop as tloop

TASKS = tuple(TASK_DICT.items())
REPO = Path(__file__).resolve().parent.parent
TRAINER_RTOL, TRAINER_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_graph_builder():
    """The JAX package may build note edges with its native builder, in
    another order within a relation; the sampler's draws follow that order,
    so the JAX corpora here use its numpy builder, which the port copies."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorpus, "build_score_graph", functools.partial(jgraph_build.build_score_graph, use_native=False))
        yield


def _labels(na, rng):
    labels = {t: rng.integers(0, n + 1, size=len(na)).astype(np.int64) for t, n in TASKS}  # some out of range
    labels["valid_label"] = (rng.random(len(na)) < 0.9).astype(np.int64)
    labels["valid_cadence_label"] = (rng.random(len(na)) < 0.5).astype(np.int64)
    return labels


def _samples(corpus, n_scores, notes, beats, test_from):
    out = []
    for i in range(n_scores):
        na = synthetic_score(notes, seed=i)
        out += corpus.samples_from_note_array(na, name=f"s{i}", labels=_labels(na, np.random.default_rng(i)),
                                              add_beats=beats, add_measures=beats, test=i >= test_from)
    return out


# -------------------------------------------------------------------- Trainer

TRAINER = dict(num_layers=1, hidden_channels=16, out_channels=8, dropout=0.0, main_tasks=("all",), num_epochs=2,
               use_swa=True, test_eval_every=2)


def _trainer_dm(jax_side):
    corpus, dm = (jcorpus, jdm) if jax_side else (tcorpus, tdm)
    cfg = dm.DataModuleConfig(subgraph_size=24, batch_size=2, num_neighbors=(3,), sort_edges_by_src=True)
    tasks = {"all": _samples(corpus, 5, 48, False, 4)}
    return (dm.AnalysisDataModule(tasks, cfg) if jax_side else dm.AnalysisDataModule(tasks, cfg, device="cpu")).setup()


def test_trainer_matches_jax(tmp_path, monkeypatch):
    from tests.test_torch_port_wandb import StubWandb

    # both Trainers log to W&B, each into its own stub module
    jwandb, twandb = StubWandb(), StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", jwandb)
    jt = jloop.Trainer(jloop.TrainConfig(**TRAINER, checkpoint_dir=str(tmp_path / "j"), use_wandb=True,
                                         log_path=str(tmp_path / "j" / "log.jsonl")), _trainer_dm(True))
    init = []
    jinit = jt._init_state

    def capture(example):  # the JAX Trainer's initial parameters, copied before its steps donate them
        state = jinit(example)
        init.append(jax.tree_util.tree_map(np.array, state.params))
        return state

    jt._init_state = capture
    jstate = jt.fit(max_steps_per_epoch=2)
    jtest = jt.evaluate(jstate, split="test")

    ckpt = tmp_path / "t"
    monkeypatch.setitem(sys.modules, "wandb", twandb)
    tt = tloop.Trainer(tloop.TrainConfig(**TRAINER, checkpoint_dir=str(ckpt), log_path=str(ckpt / "log.jsonl"),
                                         use_wandb=True, device="cpu"), _trainer_dm(False))
    tstate = tt.fit(max_steps_per_epoch=2, initial_state_dict=state_dict_from_flax(init[0], {"num_layers": 1}))
    ttest = tt.evaluate(tstate, split="test")

    assert len(tt.history) == len(jt.history) == 2 and tstate.step == int(jstate.step) == 4
    for epoch, (trec, jrec) in enumerate(zip(tt.history, jt.history)):
        assert set(trec) == set(jrec), epoch
        assert (trec["task"], trec["epoch"]) == (jrec["task"], jrec["epoch"]) == ("all", epoch)
        for k, v in jrec.items():
            if k == "train_loss" or k.startswith("val/"):
                assert trec[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), f"epoch {epoch} {k}"
    assert set(ttest) == set(jtest) and "all/rna_onset_acc" in ttest
    for k, v in jtest.items():
        assert ttest[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), k
    assert tt.history[1]["train_loss"] < tt.history[0]["train_loss"]
    # W&B: one init with the same project, name and configuration (the port's has "device" besides), then the
    # same numbers logged record by record
    (jinit,), (tinit,) = [[c[1] for c in w.calls if c[0] == "init"] for w in (jwandb, twandb)]
    assert (tinit["project"], tinit["name"]) == (jinit["project"], jinit["name"]) == ("analysisgnn-tpu",
                                                                                      "HybridGNN_1x16-lr=0.005")
    assert set(tinit["config"]) - set(jinit["config"]) == {"device"} and set(jinit["config"]) <= set(tinit["config"])
    for k, v in jinit["config"].items():
        if k in ("checkpoint_dir", "log_path"):
            v = v.replace(str(tmp_path / "j"), str(ckpt))
        assert tinit["config"][k] == v, k
    jlogs, tlogs = [[c[1] for c in w.calls if c[0] == "log"] for w in (jwandb, twandb)]
    assert [sorted(d) for d in tlogs] == [sorted(d) for d in jlogs] and len(tlogs) == 2
    for tlog, jlog in zip(tlogs, jlogs):
        assert "train_loss" in tlog
        for k, v in jlog.items():
            if k != "secs":  # the epoch's wall seconds
                assert tlog[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), k
    # what it wrote: the log, the test curve, the checkpoints, the full state
    assert [json.loads(line) for line in open(ckpt / "log.jsonl")] == tt.history
    (tcurve,), (jcurve,) = [[json.loads(line) for line in open(p / "test_curve.jsonl")] for p in (ckpt, tmp_path / "j")]
    assert set(tcurve) == set(jcurve) and (tcurve["global_epoch"], tcurve["steps"]) == (2, 4)
    assert tcurve["wloss_p"] == pytest.approx(jcurve["wloss_p"], abs=1e-4)
    for tag in ("best", "all_model", "swa", "last", "full"):
        assert (ckpt / f"{tag}.pt").is_file(), tag
    last = torch.load(ckpt / "last.pt", weights_only=True)
    assert all(torch.equal(last[k], v) for k, v in tt.model.state_dict().items())


def test_full_state_round_trip_and_resume(tmp_path):
    cfg = tloop.TrainConfig(**dict(TRAINER, use_swa=False, test_eval_every=0, num_epochs=1), device="cpu",
                            checkpoint_dir=str(tmp_path))
    tt = tloop.Trainer(cfg, _trainer_dm(False))
    state = tt.fit(max_steps_per_epoch=2)
    saved = {k: v.clone() for k, v in tt.model.state_dict().items()}
    mu = [m.clone() for m in state.opt_state.mu]
    gen = state.generator.get_state().clone()
    fresh = tt._init_state()
    restored = tt.restore_full_state(fresh, "full")
    assert restored.step == state.step == 2 and restored.opt_state.count == 2
    assert all(torch.equal(tt.model.state_dict()[k], v) for k, v in saved.items())
    assert all(torch.equal(a, b) for a, b in zip(restored.opt_state.mu, mu))
    assert torch.equal(restored.generator.get_state(), gen)
    assert torch.equal(restored.mt_params.detach(), state.mt_params.detach())
    resumed = tloop.Trainer(dataclasses.replace(cfg, resume=True), _trainer_dm(False)).fit(max_steps_per_epoch=2)
    assert resumed.step == 4 and resumed.opt_state.count == 4


def test_trainer_refuses_what_is_not_ported():
    dm = _trainer_dm(False)
    # W&B logging is ported: use_wandb builds a Trainer, as in the JAX package (tests/test_torch_port_wandb.py)
    assert tloop.Trainer(tloop.TrainConfig(**TRAINER, use_wandb=True, device="cpu"), dm).cfg.use_wandb
    # SMOTE, the edge-consistency loss (with the edge decoder) and HGT bf16 staging are ported
    assert not hasattr(tloop.Trainer(tloop.TrainConfig(**TRAINER, use_smote=True, device="cpu"), dm).model,
                       "edge_decoder")
    assert tloop.Trainer(tloop.TrainConfig(**TRAINER, use_edge_loss=True, device="cpu"), dm).model.use_edge_decoder
    hgt = tloop.Trainer(tloop.TrainConfig(**dict(TRAINER, model="HGT"), hgt_stage_dtype="bfloat16", device="cpu"), dm)
    assert all(layer.stage == torch.bfloat16 for layer in hgt.model.encoder.layers)
    with pytest.raises(ValueError, match="hgt_stage_dtype"):  # a HybridGNN cannot stage, as in the JAX model
        tloop.Trainer(tloop.TrainConfig(**TRAINER, hgt_stage_dtype="bfloat16", device="cpu"), dm)
    # the five HybridGNN knobs of the JAX train CLI build a Trainer now
    knobs = tloop.Trainer(tloop.TrainConfig(**TRAINER, remat=True, final_dropout=True, fused_torch_init=False,
                                            plain_proj=False, logit_fusion=True, device="cpu"), dm)
    assert knobs.model.encoder.remat and knobs.model.encoder.final_dropout and knobs.model.heads.logit_fusion
    assert not knobs.model_config["plain_proj"] and not knobs.cfg.fused_torch_init
    # MetricalGNN with use_rnn is ported: the Trainer builds the JAX Trainer's parameter tree
    metrical = dict(TRAINER, num_layers=2, model="MetricalGNN", use_rnn=True)
    tt = tloop.Trainer(tloop.TrainConfig(**metrical, device="cpu"), dm)
    jt = jloop.Trainer(jloop.TrainConfig(**metrical), _trainer_dm(True))
    jb = next(iter(jt.dm.val_batches("all")))
    a = jb.node_attrs["note"]
    shapes = jax.eval_shape(jt.model.init, jax.random.PRNGKey(0), jb.x_dict(), jb.edge_index_dict(), jb.batch,
                            a["pitch_spelling"], a["key_signature"], jb.num_target_nodes)["params"]
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    tt._init_state()  # the seeded init and the torch-style draw, as fit() starts
    assert flat(flax_tree_from_state_dict(tt.model.state_dict())) == flat(shapes)
    assert tt.model.encoder_type == "metricalgnn" and tt.model.use_rnn
    with pytest.raises(ValueError, match="lie on"):
        tloop.Trainer(tloop.TrainConfig(**TRAINER, device="meta"), dm)
    assert tloop.expand_main_task("rna", TASK_DICT) == jloop.expand_main_task("rna", TASK_DICT)
    assert tloop.expand_main_task("all", TASK_DICT) == jloop.expand_main_task("all", TASK_DICT)
    assert tloop.expand_main_task("cadence", TASK_DICT) == ("cadence",)


# ------------------------------------------------------------------------ CLI

TINY = ["--num_layers", "1", "--hidden_channels", "8", "--out_channels", "4"]


@pytest.mark.parametrize("argv", [
    [],
    ["--num_epochs", "3,2,1", "--main_tasks", "all,cadence,rna", "--use_metrical", "--model", "HGT", "--use_pallas"],
    ["--no_use_jk", "--no_final_norm", "--lr", "0.001", "--weight_decay", "0.01", "--conv_impl", "edge-zxp",
     "--num_epochs", "7", "--has_memories", "True", "--deep_proj"],
    "config_file",
])
def test_resolve_config_matches_jax(argv, tmp_path):
    if argv == "config_file":
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"hidden_channels": 64, "use_jk": False, "main_tasks": ["cadence"], "extra": 1}))
        argv = ["--config_path", str(path), "--hidden_channels", "32", "--num_epochs", "4"]
    want = jcli.resolve_config(list(argv))
    got = tcli.resolve_config(list(argv) + ["--device", "cpu"])
    assert got.pop("device") == "cpu"
    assert got == want
    assert tcli.resolve_config(list(argv))["device"] == "cuda"


@pytest.mark.parametrize("extra", [
    [],
    ["--model", "HGT", "--use_pallas", "--use_metrical", "--main_tasks", "all"],
    ["--conv_impl", "edge-zxp", "--add_beats", "--no_use_jk", "--dropout", "0.1", "--main_tasks", "cadence,rna"],
])
def test_model_config_json_is_byte_equal_to_jax(extra, tmp_path):
    for side, main, dev in (("j", jcli.main, []), ("t", tcli.main, ["--device", "cpu"])):
        main(["--demo", *TINY, *extra, "--checkpoint_dir", str(tmp_path / side), *dev])
    want = (tmp_path / "j" / "model_config.json").read_bytes()
    assert (tmp_path / "t" / "model_config.json").read_bytes() == want
    assert not (tmp_path / "t" / "last.pt").exists()  # no --do_train: nothing trained


def test_cli_train_then_predict_roundtrip_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    trainer = tcli.main(["--demo", "--do_train", "--do_eval", "--device", "cpu", *TINY, "--num_epochs", "2",
                         "--subgraph_size", "24", "--batch_size", "20", "--main_tasks", "all",
                         "--use_metrical", "--conv_impl", "edge-zxp", "--checkpoint_dir", ckpt,
                         "--max_steps_per_epoch", "2"])
    capsys.readouterr()
    assert len(trainer.history) == 2 and all(np.isfinite(r["train_loss"]) for r in trainer.history)
    model, cfg = load_model(ckpt, "last", "cpu")
    assert cfg["add_beats"] and cfg["conv_impl"] == "edge-zxp"
    assert all(torch.equal(model.state_dict()[k], v) for k, v in trainer.model.state_dict().items())
    na = synthetic_score(30, seed=9)
    ids = predict_score_ids(model, na, add_beats=True, add_measures=True, device="cpu")
    assert ids["cadence"].shape == (30,) and (ids["localkey"] >= 0).all()
    # --do_eval alone evaluates the stored best checkpoint
    tcli.main(["--demo", "--do_eval", "--device", "cpu", *TINY, "--subgraph_size", "24", "--batch_size", "20",
               "--main_tasks", "all", "--use_metrical", "--conv_impl", "edge-zxp", "--checkpoint_dir", ckpt])
    out = capsys.readouterr().out
    metrics = json.loads(out[out.index("{"):])
    assert "all/cadence_acc" in metrics and "all/rna_onset_acc" in metrics
    # --raw_dir trains on the corpus files (here three pieces of data_synth) and writes the checkpoints
    raw = tmp_path / "raw" / "all"
    raw.mkdir(parents=True)
    for name in ("synth_07_000.tsv", "synth_07_001.tsv", "synth_07_020.tsv"):
        shutil.copy(REPO / "data_synth" / "all" / name, raw / name)
    raw_ckpt = tmp_path / "raw_ckpt"
    trainer = tcli.main(["--raw_dir", str(tmp_path / "raw"), "--device", "cpu", *TINY, "--checkpoint_dir",
                         str(raw_ckpt), "--do_train", "--main_tasks", "all", "--num_epochs", "1",
                         "--subgraph_size", "24", "--batch_size", "20", "--max_steps_per_epoch", "1"])
    assert len(trainer.history) == 1 and np.isfinite(trainer.history[0]["train_loss"])
    assert (raw_ckpt / "last.pt").is_file() and (tmp_path / "raw" / ".cache").is_dir()
