"""The port imports nothing of JAX, of the JAX package or of pandas (which
the machine with the card lacks), and its entry points never fall back to
the CPU on their own."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "analysisgnn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "analysisgnn_tpu", "pandas")

IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import analysisgnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(analysisgnn_tpu_torch.__path__, "analysisgnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# the chord chain and the deep / fused analysis heads import more inside their functions: run them too
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.inference.predict_chords import decode_chord_predictions, predict_chord_tasks
from analysisgnn_tpu_torch.models.analysis import model_from_config
probs, onsets = predict_chord_tasks(synthetic_score(30), hidden=8, device="cpu")
# the graph build goes through the C++ edge builder (data/native.py), built with g++ at first use
from analysisgnn_tpu_torch.data.native import build_note_edges_native
calls = build_note_edges_native.calls
decode_chord_predictions(probs)
model_from_config({{"num_layers": 1, "hidden_channels": 8, "out_channels": 4, "in_channels": 25,
                   "plain_proj": False, "logit_fusion": True}}, device="cpu")
# one bf16 train step with SMOTE (single-task cadence), the edge decoder's loss and smote_oversample
import torch
from analysisgnn_tpu_torch.core.graph import NOTE
from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
from analysisgnn_tpu_torch.models.analysis import init_parameters
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
from analysisgnn_tpu_torch.train.smote import smote_draws, smote_oversample
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer
from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step
graph = graph_from_note_array(synthetic_score(40), feature_type="simple", add_beats=False, add_measures=False,
                              device="cpu")
assert build_note_edges_native.calls == calls + 1
n = graph.node_features[NOTE].shape[0]
for task in ("cadence", "quality", "inversion", "degree1", "degree2", "localkey"):
    graph.node_attrs[NOTE][task] = torch.arange(n) % 4
model = model_from_config({{"num_layers": 1, "hidden_channels": 8, "out_channels": 4, "in_channels": 25,
                           "use_edge_decoder": True}}, device="cpu")
init_parameters(model, torch.Generator().manual_seed(0))
opt = make_optimizer(warmup_cosine_schedule(1e-3, total_steps=10))
state = create_train_state(model, len(TASK_DICT), opt, seed=1)
cfg = StepConfig(task_dict=tuple(TASK_DICT.items()), active_tasks=("cadence",), compute_dtype="bfloat16",
                 use_smote=True, smote_synthetic=8, use_edge_loss=True)
state, aux = make_train_step(model, opt, cfg)(state, graph)
assert torch.isfinite(aux["total_loss"]) and "edge_loss" in aux and state.opt_state.count == 1
x, y, w = torch.randn(n, 4), torch.arange(n) % 3, torch.ones(n, dtype=torch.bool)
x_syn, y_syn, w_syn = smote_oversample(x, y, w, 3, smote_draws(y, w, 3, 8, 4, torch.Generator().manual_seed(0)))
assert x_syn.shape == (8, 4) and w_syn.shape == (8,)
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in {FORBIDDEN!r})
assert not loaded, loaded
print(",".join(names + [chip_smoke.__name__]))
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.strip().splitlines()[-1].split(","))
    # every module of the port and chip_smoke: the chord chain's, the families', SMOTE's, the native builder's,
    # the layer zoo's and pre-training's, the mesh's, the corpus generator's, download's and profiling's
    assert len(names) >= 83
    assert "chip_smoke" in names
    assert {f"analysisgnn_tpu_torch.{m}" for m in (
        "kernels.relmm", "data.sampler", "train.losses", "train.schedules", "train.state", "train.step",
        "kernels.softmax_agg", "models.encoders",
        "kernels.segment_sum", "kernels.segment_softmax", "data.corpus", "data.prefetch", "data.datamodule",
        "train.metrics", "train.loop", "cli.train",
        "kernels.halo", "distributed", "distributed.partition", "distributed.partition_encoder",
        "kernels.launch", "data._table", "data.tsv", "data.dlc_meta", "data.time_divided", "data.samplers",
        "data.features", "theory.encoders",
        "theory.roman", "theory.rules", "data.kern", "models.chord", "models.pooling", "models.mlp",
        "inference.predict_chords", "models.pitch_spelling", "models.cadence", "train.smote", "train.cadence",
        "data.native", "models.extra_layers", "models.pre_encoder", "models.unet", "train.pretrain",
        "utils.graph_utils", "utils.explain", "utils.visualization", "data.graph_sampling",
        "distributed.mesh", "distributed.launch", "distributed.dryrun",
        "data.synth_dlc", "data.download", "utils.profiling",
    )} <= names


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:" + "|".join(FORBIDDEN) + r")\b(?!_)"
        r"|import_module\(\s*['\"](?:" + "|".join(FORBIDDEN) + r")\b(?!_)",
        re.MULTILINE,
    )
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 84 and {
        "softmax_agg.py", "encoders.py", "chip_smoke.py", "segment_sum.py", "segment_softmax.py", "corpus.py",
        "prefetch.py", "datamodule.py", "metrics.py", "loop.py", "train.py",
        "halo.py", "partition.py", "partition_encoder.py", "launch.py", "_table.py", "tsv.py", "dlc_meta.py",
        "time_divided.py", "samplers.py",
        "roman.py", "rules.py", "kern.py", "chord.py", "pooling.py", "predict_chords.py",
        "pitch_spelling.py", "cadence.py", "smote.py", "native.py", "extra_layers.py", "pre_encoder.py", "unet.py",
        "pretrain.py", "graph_utils.py", "explain.py", "visualization.py", "graph_sampling.py",
        "mesh.py", "launch.py", "dryrun.py", "synth_dlc.py", "download.py", "profiling.py",
    } <= {f.name for f in files}
    assert (PORT / "train" / "cadence.py").is_file()
    offenders = {str(f.relative_to(REPO)): m for f in files for m in pattern.findall(f.read_text())}
    assert not offenders, offenders


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only refusal cannot be shown here")


def test_predict_without_device_cpu_raises_instead_of_running_on_cpu():
    _no_cuda()
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids
    from analysisgnn_tpu_torch.models.analysis import model_from_config

    cfg = {"num_layers": 1, "hidden_channels": 8, "out_channels": 4, "in_channels": 25}
    model = model_from_config(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        predict_score_ids(model, synthetic_score(20), add_beats=False, add_measures=False)
    with pytest.raises(ValueError, match="model is on"):
        predict_score_ids(model, synthetic_score(20), device="meta")


def test_cli_without_device_cpu_raises(tmp_path):
    _no_cuda()
    from analysisgnn_tpu_torch.cli.predict import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--checkpoint_dir", str(tmp_path), "--score", str(tmp_path / "x.musicxml")])


def test_model_from_config_without_device_cpu_raises():
    _no_cuda()
    from analysisgnn_tpu_torch.models.analysis import model_from_config

    cfg = {"num_layers": 1, "hidden_channels": 8, "out_channels": 4, "in_channels": 25}
    with pytest.raises(RuntimeError, match="cuda"):
        model_from_config(cfg)
    assert next(model_from_config(cfg, device="cpu").parameters()).device.type == "cpu"


def test_sampler_without_device_cpu_raises():
    _no_cuda()
    import numpy as np

    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.sampler import SamplerConfig, ScoreSample, SubgraphSampler

    sample = ScoreSample(features={NOTE: np.zeros((10, 3), np.float32)},
                         edges={(NOTE, "onset", NOTE): np.zeros((2, 0), np.int64)},
                         note_attrs={"valid_label": np.ones(10, np.int64)})
    sampler = SubgraphSampler([sample], SamplerConfig(subgraph_size=4, batch_size=1, calibrate_batches=0))
    with pytest.raises(RuntimeError, match="cuda"):
        sampler.sample_batch()
    assert sampler.sample_batch(device="cpu").num_target_nodes == 4


def test_train_cli_without_device_cpu_raises(tmp_path):
    _no_cuda()
    from analysisgnn_tpu_torch.cli.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--demo", "--do_train", "--checkpoint_dir", str(tmp_path)])
    assert not (tmp_path / "model_config.json").exists()  # it raised before any work
