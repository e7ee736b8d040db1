"""W&B logging and checkpoint resolution, offline: the Trainer's
``use_wandb`` and the predict CLI's ``resolve_checkpoint`` /
``--artifacts_dir``, held against the JAX package's through a stub ``wandb``
module put in ``sys.modules`` (the tests need no ``wandb`` package and no
network).

``resolve_checkpoint`` is run on the same cases in both packages, each case
laid out in the package's own checkpoint format (JAX: a ``<tag>/`` Orbax
directory beside ``model_config.json``; the port: ``<tag>.pt`` beside it).
Returned paths, printed lines, error types and messages must agree, with the
temporary root written ``<root>``, the port's local file ``<tag>.pt`` read as
the JAX ``<tag>`` and the JAX "Orbax checkpoint" as the port's
"checkpoint"."""

import csv
import dataclasses
import json
import os
import sys
import types

import pytest
import torch

from analysisgnn_tpu.cli import predict as jpredict
from analysisgnn_tpu_torch.cli import predict as tpredict
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.train import loop as tloop
from tests.test_torch_port_predict import SCORE_XML
from tests.test_torch_port_trainer import TRAINER, _trainer_dm


class StubRun:
    def __init__(self, wandb):
        self.wandb = wandb

    def use_artifact(self, artifact_id, type):
        self.wandb.calls.append(("use_artifact", artifact_id, type))
        return StubArtifact(self.wandb, artifact_id)


class StubArtifact:
    def __init__(self, wandb, artifact_id):
        self.wandb, self.artifact_id = wandb, artifact_id

    def download(self, root):
        self.wandb.calls.append(("download", os.path.basename(root)))
        return self.wandb.layout(root, self.artifact_id)


class StubWandb(types.ModuleType):
    """The few calls of the ``wandb`` API the two packages make, recorded.
    ``layout(root, artifact_id)`` writes what an artifact's download would
    and returns the directory ``download`` returns."""

    def __init__(self, layout=None):
        super().__init__("wandb")
        self.run = None
        self.calls = []
        self.layout = layout

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))
        self.run = StubRun(self)
        return self.run

    def log(self, data):
        self.calls.append(("log", dict(data)))

    def finish(self):
        self.calls.append(("finish",))
        self.run = None


# ---------------------------------------------------------------- the Trainer


def _fit(tmp_path, name, **extra):
    ckpt = tmp_path / name
    cfg = tloop.TrainConfig(**TRAINER, checkpoint_dir=str(ckpt), log_path=str(ckpt / "log.jsonl"), device="cpu",
                            **extra)
    trainer = tloop.Trainer(cfg, _trainer_dm(False))
    state = trainer.fit(max_steps_per_epoch=1)
    return trainer, state, [json.loads(line) for line in open(ckpt / "log.jsonl")]


def test_trainer_logs_every_record_to_wandb(tmp_path, monkeypatch):
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    trainer, _, lines = _fit(tmp_path, "stub", use_wandb=True)
    inits = [c for c in stub.calls if c[0] == "init"]
    assert len(inits) == 1 and stub.calls[0][0] == "init"
    kwargs = inits[0][1]
    assert kwargs["project"] == "analysisgnn-tpu"
    assert kwargs["name"] == f"HybridGNN_1x16-lr={trainer.cfg.lr}"
    assert kwargs["config"] == dataclasses.asdict(trainer.cfg) and kwargs["config"]["device"] == "cpu"
    logs = [c[1] for c in stub.calls if c[0] == "log"]
    assert len(logs) == len(lines) == 2
    for logged, line in zip(logs, lines):
        assert logged == {k: v for k, v in line.items() if isinstance(v, (int, float))}
        assert "train_loss" in logged and "task" not in logged


def test_use_wandb_without_wandb_trains_to_the_end(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # any import of wandb raises ImportError
    with pytest.raises(ImportError):
        import wandb  # noqa: F401
    _, state, lines = _fit(tmp_path, "with", use_wandb=True)
    _, _, plain = _fit(tmp_path, "without")
    assert state.step == 2 and len(lines) == len(plain) == 2
    assert [sorted(line) for line in lines] == [sorted(line) for line in plain]
    assert (tmp_path / "with" / "last.pt").is_file()


# --------------------------------------------------------- resolve_checkpoint

TAG = "best"


def _jax_layout(root):
    os.makedirs(os.path.join(root, TAG), exist_ok=True)
    with open(os.path.join(root, "model_config.json"), "w") as f:
        f.write("{}")


def _port_layout(root):
    os.makedirs(root, exist_ok=True)
    open(os.path.join(root, f"{TAG}.pt"), "wb").close()
    with open(os.path.join(root, "model_config.json"), "w") as f:
        f.write("{}")


def _local_only(root, layout):
    """The JAX test's local hit: the tag alone, no model_config.json."""
    if layout is _jax_layout:
        os.makedirs(os.path.join(root, TAG))
    else:
        os.makedirs(root)
        open(os.path.join(root, f"{TAG}.pt"), "wb").close()


# each case: (setup(root, layout) -> (checkpoint_dir, artifacts_dir), wandb: None, "absent" or a layout kind)
def _case_local(root, layout):
    _local_only(os.path.join(root, "ckpt"), layout)
    return os.path.join(root, "ckpt"), os.path.join(root, "empty")


def _case_cache_scan(root, layout):
    cache = os.path.join(root, "artifacts", "models")
    layout(os.path.join(cache, "model-b:v1"))
    layout(os.path.join(cache, "model-abc:v3"))
    os.makedirs(os.path.join(cache, "0-no-tag"))  # no checkpoint in it: skipped
    return os.path.join(root, "nope"), cache


def _case_cache_root(root, layout):
    cache = os.path.join(root, "cache")
    layout(cache)
    return "entity/project/model-x:v1", cache


def _case_cached_artifact_id(root, layout):
    cache = os.path.join(root, "cache")
    layout(os.path.join(cache, "model-x:v1"))
    return "entity/project/model-x:v1", cache


def _case_artifact_without_wandb(root, layout):
    return "entity/project/model-x:v1", os.path.join(root, "empty")


def _case_plain_path(root, layout):
    return os.path.join(root, "nope2"), os.path.join(root, "empty")


def _case_relative_path_with_colon(root, layout):
    return "only/one:v1", os.path.join(root, "empty")  # one "/" only: not an artifact id


CASES = {
    "local": (_case_local, None),
    "cache_scan": (_case_cache_scan, None),
    "cache_root": (_case_cache_root, None),
    "cached_artifact_id": (_case_cached_artifact_id, None),
    "artifact_without_wandb": (_case_artifact_without_wandb, "absent"),
    "plain_path": (_case_plain_path, None),
    "relative_path_with_colon": (_case_relative_path_with_colon, None),
    "wandb_download_nested": (_case_artifact_without_wandb, "nested"),
    "wandb_download_root": (_case_artifact_without_wandb, "root"),
    "wandb_download_empty": (_case_artifact_without_wandb, "empty"),
}


def _stub_for(kind, layout):
    def download(root, artifact_id):
        name = artifact_id.split("/")[-1]
        if kind == "nested":  # the artifact holds one checkpoint directory
            layout(os.path.join(root, name, "checkpoint"))
            return os.path.join(root, name)
        if kind == "root":
            layout(os.path.join(root, name))
            return os.path.join(root, name)
        os.makedirs(os.path.join(root, name, "other"), exist_ok=True)
        return os.path.join(root, name)

    return StubWandb(download)


def _resolve(module, layout, case, kind, root, capsys, monkeypatch):
    os.makedirs(root)
    checkpoint_dir, artifacts_dir = CASES[case][0](root, layout)
    stub = None
    if kind == "absent":
        monkeypatch.setitem(sys.modules, "wandb", None)
    elif kind is not None:
        stub = _stub_for(kind, layout)
        monkeypatch.setitem(sys.modules, "wandb", stub)
    capsys.readouterr()
    try:
        out = ("ok", module.resolve_checkpoint(checkpoint_dir, TAG, artifacts_dir))
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        out = (type(e).__name__, str(e))
    norm = lambda s: (s.replace(root, "<root>").replace(f"{TAG}.pt", TAG)
                      .replace("contains no Orbax checkpoint", "contains no checkpoint"))
    return (out[0], norm(out[1])), norm(capsys.readouterr().out), None if stub is None else stub.calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolve_checkpoint_matches_jax(case, tmp_path, capsys, monkeypatch):
    kind = CASES[case][1]
    want = _resolve(jpredict, _jax_layout, case, kind, str(tmp_path / "jax"), capsys, monkeypatch)
    got = _resolve(tpredict, _port_layout, case, kind, str(tmp_path / "port"), capsys, monkeypatch)
    assert got == want
    expected = {
        "local": "ok", "cache_scan": "ok", "cache_root": "ok", "cached_artifact_id": "ok",
        "artifact_without_wandb": "ImportError", "plain_path": "FileNotFoundError",
        "relative_path_with_colon": "FileNotFoundError", "wandb_download_nested": "ok", "wandb_download_root": "ok",
        "wandb_download_empty": "FileNotFoundError",
    }[case]
    assert got[0][0] == expected
    if case == "cache_scan":
        assert got[0][1] == "<root>/artifacts/models/model-abc:v3" and got[1].startswith("Using cached checkpoint")
    if kind in ("nested", "root", "empty"):
        assert [c[0] for c in got[2]] == ["init", "use_artifact", "download", "finish"]
        assert got[2][1] == ("use_artifact", "entity/project/model-x:v1", "model")


def test_cli_serves_a_cached_artifact_as_the_local_checkpoint(tmp_path, capsys):
    cfg = {"model": "HybridGNN", "num_layers": 1, "hidden_channels": 16, "out_channels": 8, "in_channels": 25,
           "plain_proj": True, "conv_impl": "node", "dropout": 0.0, "add_beats": False, "add_measures": False}
    model = model_from_config(cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    score = tmp_path / "piece.musicxml"
    score.write_text(SCORE_XML)
    for ckpt in (tmp_path / "local", tmp_path / "artifacts" / "model-x:v0"):
        ckpt.mkdir(parents=True)
        (ckpt / "model_config.json").write_text(json.dumps(cfg))
        torch.save(model.state_dict(), ckpt / "last.pt")
    common = ["--score", str(score), "--checkpoint", "last", "--device", "cpu"]
    tpredict.main(["--checkpoint_dir", str(tmp_path / "local"), "--output_csv", str(tmp_path / "local.csv")] + common)
    capsys.readouterr()
    tpredict.main(["--checkpoint_dir", "entity/project/model-x:v0", "--artifacts_dir", str(tmp_path / "artifacts"),
                   "--output_csv", str(tmp_path / "cached.csv")] + common)
    assert f"Using cached checkpoint: {tmp_path / 'artifacts' / 'model-x:v0'}" in capsys.readouterr().out
    rows = list(csv.reader(open(tmp_path / "cached.csv")))
    assert rows == list(csv.reader(open(tmp_path / "local.csv"))) and len(rows) > 1
