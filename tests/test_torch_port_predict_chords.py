"""The port's chord chain (``inference/predict_chords.py``) against the JAX
package's: ``predict_chord_tasks`` with both models' parameters converted
(the JAX ``ChordPredictionModel`` from ``init``, and the smoother as the JAX
chain initialises it, from ``PRNGKey(seed + 1)``), the decode, the resolved
annotations, and the CLI's RNA MusicXML and RomanText.

Tolerances: probabilities within 1e-5 absolute (float64 softmaxes of f32
logits that agree to float reassociation; measured here: up to 3.9e-7
without the smoother and 2.0e-8 after it);
labels, annotations and files equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.core.graph import metadata
from analysisgnn_tpu.data.musicxml import load_score
from analysisgnn_tpu.inference import predict_chords as jpc
from analysisgnn_tpu.models.chord import ChordPredictionModel, PostProcessingMLT
from analysisgnn_tpu.theory.vocab import TASK_DICT_LATEST
from analysisgnn_tpu_torch.convert import chord_state_dict_from_flax
from analysisgnn_tpu_torch.inference import predict_chords as tpc
from analysisgnn_tpu_torch.models.chord import ChordPredictionModel as TChordModel
from analysisgnn_tpu_torch.models.chord import PostProcessingMLT as TPost
from tests.test_torch_port_partition import synthetic_score_xml

HIDDEN = 32
ATOL = 1e-5
TASKS = tuple(TASK_DICT_LATEST.items())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(note_array, seed):
    """The JAX chord model's parameters and the JAX chain's smoother
    parameters (``PRNGKey(seed + 1)``; they depend only on the shapes), and
    the port's models with the same weights."""
    from analysisgnn_tpu.core.graph import NOTE
    from analysisgnn_tpu.inference.predict import graph_from_note_array

    g = graph_from_note_array(note_array, add_beats=False, add_measures=False)
    n = len(note_array)
    jm = ChordPredictionModel(hidden=HIDDEN, task_dict=TASKS, num_layers=1, edge_types=metadata(False, False)[1])
    params = jm.init(jax.random.PRNGKey(seed), g.x_dict(), g.edge_index_dict(), g.batch,
                     g.node_attrs[NOTE]["onset_div"], jnp.ones(n, bool))
    post_params = PostProcessingMLT(hidden=HIDDEN, task_dict=TASKS).init(
        jax.random.PRNGKey(seed + 1), {t: jnp.zeros((n, c)) for t, c in TASKS}, jnp.arange(n) == 0)
    tm = TChordModel(g.x_dict()[NOTE].shape[1], HIDDEN, TASKS, metadata(False, False)[1], num_layers=1)
    tm.load_state_dict(chord_state_dict_from_flax(_np(params)))
    post = TPost(HIDDEN, TASKS)
    post.load_state_dict(chord_state_dict_from_flax(_np(post_params)))
    return params, tm.eval(), post.eval()


@pytest.mark.parametrize("num_notes, seed", [(150, 0), (400, 3)])
def test_predict_chord_tasks_decode_and_annotations_match_jax(num_notes, seed, tmp_path):
    score = tmp_path / "s.musicxml"
    score.write_text(synthetic_score_xml(num_notes, seed=seed))
    na = load_score(str(score)).note_array
    params, tm, post = _models(na, seed)
    want, want_onsets = jpc.predict_chord_tasks(na, params=params, hidden=HIDDEN, num_layers=1, seed=seed)
    got, got_onsets = tpc.predict_chord_tasks(na, model=tm, post_model=post, hidden=HIDDEN, seed=seed, device="cpu")
    np.testing.assert_array_equal(got_onsets, want_onsets)
    assert set(got) == set(want)  # the JAX jit returns its dict sorted
    for task in want:
        assert got[task].shape == want[task].shape
        np.testing.assert_allclose(got[task], want[task], rtol=0, atol=ATOL, err_msg=task)
    decoded = tpc.decode_chord_predictions(got)
    assert decoded == jpc.decode_chord_predictions(want)
    for step in (None, "F", "C"):
        assert tpc.resolve_annotations(decoded, got_onsets, step) == jpc.resolve_annotations(decoded, got_onsets,
                                                                                             step)
    # without the smoother too
    want, _ = jpc.predict_chord_tasks(na, params=params, hidden=HIDDEN, num_layers=1, seed=seed, use_post=False)
    got, _ = tpc.predict_chord_tasks(na, model=tm, hidden=HIDDEN, seed=seed, use_post=False, device="cpu")
    for task in want:
        np.testing.assert_allclose(got[task], want[task], rtol=0, atol=ATOL, err_msg=task)


def test_resolve_annotations_matches_jax_on_hand_written_rows():
    decoded = {
        "hrhythm": [0, 0, 1, 0, 0, 0],
        "localkey": ["C", "C", "C", "G", "G", "a"],
        "tonkey": ["C", "C", "C", "G", "D", "a"],
        "pcset": [(0, 4, 7), (2, 5, 7, 11), (0, 4, 7), (2, 7, 11), (2, 6, 9), (0, 4, 9)],
        "romanNumeral": ["I", "V7", "I", "I", "V", "i"],
        "bass": ["G", "G", "C", "G", "A", "A"],
        "tenor": ["E", "B", "E", "B", "C#", "C"],
        "alto": ["G", "D", "G", "D", "E", "E"],
        "soprano": ["C", "F", "C", "G", "A", "A"],
    }
    onsets = np.array([0, 4, 8, 12, 16, 20])
    for step in (None, "F", "G"):
        assert tpc.resolve_annotations(decoded, onsets, step) == jpc.resolve_annotations(decoded, onsets, step)
    no_onsets = dict(decoded, hrhythm=[1] * 6)  # degenerate: every onset kept
    assert tpc.resolve_annotations(no_onsets, onsets) == jpc.resolve_annotations(no_onsets, onsets)


def test_cli_files_equal_jax_on_the_same_probabilities(tmp_path, monkeypatch):
    """Both CLIs on one score, their chains replaced by the same
    probabilities (the JAX chain's): the RNA MusicXML and the .rntxt text
    byte for byte."""
    score = tmp_path / "piece.musicxml"
    score.write_text(synthetic_score_xml(300, seed=5))
    na = load_score(str(score)).note_array
    params, _, _ = _models(na, 0)
    probs = jpc.predict_chord_tasks(na, params=params, hidden=HIDDEN, num_layers=1)
    monkeypatch.setattr(jpc, "predict_chord_tasks", lambda *a, **k: probs)
    monkeypatch.setattr(tpc, "predict_chord_tasks", lambda *a, **k: probs)
    jpc.main(["--input_score", str(score), "--output_dir", str(tmp_path / "j"), "--romantext"])
    tpc.main(["--input_score", str(score), "--output_dir", str(tmp_path / "t"), "--romantext", "--device", "cpu"])
    for name in ("piece_rna.musicxml", "piece.rntxt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert (tmp_path / "t" / "piece.rntxt").read_text().startswith("Composer: Unknown\nTitle: piece\n")


def test_cli_runs_on_the_cpu_with_seeded_and_loaded_weights(tmp_path):
    score = tmp_path / "piece.musicxml"
    score.write_text(synthetic_score_xml(200, seed=2))
    argv = ["--input_score", str(score), "--hidden", str(HIDDEN), "--romantext", "--device", "cpu"]
    tpc.main(argv + ["--output_dir", str(tmp_path / "a")])
    assert (tmp_path / "a" / "piece_rna.musicxml").stat().st_size > 0
    assert "m1" in (tmp_path / "a" / "piece.rntxt").read_text()
    # --use_ckpt DIR reads DIR/model.pt: the seeded weights saved and loaded give the same files
    na = load_score(str(score)).note_array
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    from analysisgnn_tpu_torch.data.features import select_features

    model = tpc.build_chord_model(select_features(na, "voice").shape[1], HIDDEN, device="cpu")
    torch.save(model.state_dict(), ckpt / "model.pt")
    tpc.main(argv + ["--output_dir", str(tmp_path / "b"), "--use_ckpt", str(ckpt)])
    for name in ("piece_rna.musicxml", "piece.rntxt"):
        assert (tmp_path / "b" / name).read_bytes() == (tmp_path / "a" / name).read_bytes()
    with pytest.raises(ValueError, match="model is on"):
        tpc.predict_chord_tasks(na, model=model, device="meta")
