"""The plain reference against the port's CPU path at tiny sizes, and the
reference's independence from the port."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_cell
from gpubench.gen import sampler as gen_sampler
from gpubench.gen.scores import log_spaced_lengths, synthetic_score
from gpubench.harness import checks
from gpubench.harness.manifest import load_driver
from gpubench.reference import features, graph


@pytest.mark.parametrize("n", [1, 7, 300])
def test_graph_features_and_encodings_match_the_port(n):
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.features import select_features
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph
    from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder

    na = synthetic_score(n, np.random.default_rng(n))
    assert len(na) == n and np.all(np.diff(na["onset_div"]) >= 0)
    port = build_score_graph(na, add_beats=False, add_measures=False, use_native=False)
    ours = graph.note_edges(na)
    for rel in graph.RELATIONS:
        np.testing.assert_array_equal(ours[rel], port.edges[(NOTE, rel, NOTE)])
    np.testing.assert_array_equal(features.voice_features(na), select_features(na, "voice"))
    np.testing.assert_array_equal(features.pitch_spelling(na), PitchEncoder().encode(na))
    np.testing.assert_array_equal(features.key_signature(na), KeySignatureEncoder().encode(na))


def test_sampler_batches_pack_targets_first_and_fit_their_capacities():
    rng = np.random.default_rng(5)
    scores = []
    for n in (120, 80, 200):
        na = synthetic_score(n, rng)
        scores.append(gen_sampler.Score(features.voice_features(na), graph.note_edges(na),
                                        {"pitch_spelling": features.pitch_spelling(na)}))
    smp = gen_sampler.Sampler(scores, 3, 50, (5, 5), rng)
    batches = [smp.sample() for _ in range(3)]
    cap, caps = gen_sampler.capacities(batches, smp.n_graphs, 50)
    for b in batches:
        assert b.num_targets == 150 and b.num_notes <= cap
        for rel, e in b.edges.items():
            assert e.shape[1] <= caps[rel] and np.all(np.diff(e[0]) >= 0) and e.max() < b.num_notes
        # every score's targets come first, as contiguous windows of its notes
        assert np.all(np.bincount(b.graph_ids[:150]) == 50)


def test_log_spaced_lengths_are_the_same_set_for_every_seed():
    lengths = log_spaced_lengths(32, 1000, 20000)
    assert lengths[0] == 1000 and lengths[-1] == 20000 and len(set(lengths.tolist())) == 32


@pytest.mark.parametrize("name", ["hybridgnn.train.cli", "hybridhgt.train.cli", "hybridgnn.serve.scores"])
def test_the_port_agrees_with_the_reference_on_the_cpu(name, cpu_threads):
    cell = tiny_cell(name)
    run = load_driver(cell.traffic).setup(cell, 2**33 + 11, "cpu")
    run.window(0.05)
    run.release()
    readings = run.check()
    correct, table = checks.judge(readings, cell.limits)
    assert correct, table


def _bernoulli_dropout(x, rate, deterministic, generator):
    if deterministic or rate == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate)  # the default generator, another draw
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def _functional_dropout(x, rate, deterministic, generator):
    return x if deterministic or rate == 0.0 else torch.nn.functional.dropout(x, rate, training=True)


@pytest.mark.parametrize("draw", [_bernoulli_dropout, _functional_dropout])
def test_the_check_holds_however_the_program_draws_its_masks(draw, monkeypatch, cpu_threads):
    from analysisgnn_tpu_torch.models import encoders

    monkeypatch.setattr(encoders, "dropout", draw)
    cell = tiny_cell("hybridgnn.train.cli")
    run = load_driver(cell.traffic).setup(cell, 2**33 + 12, "cpu")
    run.window(0.05)
    run.release()
    correct, table = checks.judge(run.check(), cell.limits)
    assert correct, table


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gpubench.reference.model, gpubench.reference.decode, gpubench.reference.graph\n"
            "import gpubench.reference.encoders.hybridgnn, gpubench.reference.encoders.hgt\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('analysisgnn_tpu_torch', 'analysisgnn_tpu', 'jax')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n" % str(ROOT))
    assert subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120).returncode == 0
