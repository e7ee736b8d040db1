"""The slice as a whole: the port's ``predict_score_ids`` (``device="cpu"``)
against the JAX package's on the same score and parameters (JAX parameters
from ``model.init``, converted by ``state_dict_from_flax``; 2 layers, hidden
32, out 16, dropout off, f32).

Tolerances: all 21 logits within 1e-4 absolute (the same f32 arithmetic in
another summation order); decoded ids equal wherever the reference's
top-two margin of the quantity the decode takes the argmax of exceeds 1e-3.
"""

import csv
import json

import numpy as np
import jax
import pytest
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data.musicxml import load_score as jload_score
from analysisgnn_tpu.data.note_array import synthetic_score
from analysisgnn_tpu.inference import predict as jpred
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.cli.predict import main as port_cli
from analysisgnn_tpu_torch.convert import state_dict_from_flax
from analysisgnn_tpu_torch.inference import predict as tpred
from analysisgnn_tpu_torch.models.analysis import model_from_config

LOGIT_ATOL = 1e-4
MARGIN = 1e-3


def _cfg(beats_measures):
    return {
        "model": "HybridGNN", "num_layers": 2, "hidden_channels": 32, "out_channels": 16,
        "in_channels": 25, "use_jk": True, "final_norm": True, "plain_proj": True,
        "logit_fusion": False, "use_rnn": False, "conv_impl": "node", "dropout": 0.0,
        "add_beats": beats_measures, "add_measures": beats_measures, "feature_type": "simple",
    }


def _models(cfg, note_array, seed):
    bm = cfg["add_beats"]
    jm = JAnalysisGNN(
        metadata=metadata(bm, bm), in_channels=25, hidden_channels=cfg["hidden_channels"],
        out_channels=cfg["out_channels"], task_dict=tuple(TASK_DICT.items()), num_layers=cfg["num_layers"],
        dropout=0.0, use_jk=True, final_norm=True, plain_proj=True,
    )
    g = jpred.graph_from_note_array(note_array, add_beats=bm, add_measures=bm)
    a = g.node_attrs[NOTE]
    params = jm.init(jax.random.PRNGKey(seed), g.x_dict(), g.edge_index_dict(), g.batch,
                     a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
    tm = model_from_config(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jm, params, tm.eval()


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _margin(v):
    top = np.sort(v, axis=-1)
    return top[..., -1] - top[..., -2]


def _decision_margins(logits, onset, note_array):
    """Per task and note, the top-two margin of what the reference decode
    takes the argmax of: the logits, or for the RNA keys the onset-aggregated
    probabilities of the note's onset representative."""
    n = len(note_array)
    src, dst = onset
    keep = (src != dst) & (src < n) & (dst < n)
    tpc = logits["tpc_in_label"].argmax(-1).astype(bool)
    keep &= tpc[np.minimum(src, n - 1)] & tpc[np.minimum(dst, n - 1)]
    src, dst = src[keep], dst[keep]
    onsets, uniq, rep_rows = jpred._rep_rows_and_grid(note_array)
    note_rep = rep_rows[np.searchsorted(uniq, onsets)]
    out = {}
    for k, v in logits.items():
        if k in jpred.RNA_KEYS:
            p = _softmax(v.astype(np.float64))
            acc = p.copy()
            np.add.at(acc, dst, p[src])
            cnt = 1.0 + np.bincount(dst, minlength=len(p))
            out[k] = _margin(acc / cnt[:, None])[note_rep]
        else:
            out[k] = _margin(v)[:n]
    return out


@pytest.mark.parametrize("num_notes,seed,beats_measures", [(100, 0, False), (60, 2, True)])
def test_predict_score_ids_matches_jax(num_notes, seed, beats_measures):
    cfg = _cfg(beats_measures)
    na = synthetic_score(num_notes, seed=seed)
    jm, params, tm = _models(cfg, na, seed)

    # logits of the whole model on the serving graphs of both packages
    jg = jpred.graph_from_note_array(na, add_beats=beats_measures, add_measures=beats_measures, bucket_factor=1.25)
    a = jg.node_attrs[NOTE]
    want = jm.apply(params, jg.x_dict(), jg.edge_index_dict(), jg.batch, a["pitch_spelling"],
                    a["key_signature"], jg.num_target_nodes)
    want = {k: np.asarray(v) for k, v in want.items()}
    tg = tpred.graph_from_note_array(na, add_beats=beats_measures, add_measures=beats_measures,
                                     bucket_factor=1.25)
    ta = tg.node_attrs[NOTE]
    with torch.no_grad():
        got = tm(tg.node_features, tg.edge_index, ta["pitch_spelling"], ta["key_signature"], tg.num_target_nodes)
    assert sorted(got) == sorted(TASK_DICT) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=LOGIT_ATOL, err_msg=k)

    # decoded ids of the serving entry points
    kw = dict(add_beats=beats_measures, add_measures=beats_measures, bucket_factor=1.25)
    ref_ids = jpred.predict_score_ids(jm, params, na, **kw)
    ids = tpred.predict_score_ids(tm, na, device="cpu", **kw)
    assert sorted(ids) == sorted(ref_ids)
    margins = _decision_margins(want, np.asarray(jg.edges((NOTE, "onset", NOTE))), na)
    compared = 0
    for k, ref in ref_ids.items():
        assert ids[k].shape == ref.shape == (num_notes,)
        sure = margins[k] > MARGIN
        np.testing.assert_array_equal(ids[k][sure], ref[sure], err_msg=k)
        compared += int(sure.sum())
    assert compared > 0.9 * num_notes * len(ref_ids)


SCORE_XML = """<?xml version="1.0"?>
<score-partwise version="3.1">
  <part-list><score-part id="P1"/></part-list>
  <part id="P1">
    <measure number="1">
      <attributes><divisions>1</divisions>
        <time><beats>4</beats><beat-type>4</beat-type></time></attributes>
      <note><pitch><step>C</step><octave>4</octave></pitch><duration>1</duration></note>
      <note><chord/><pitch><step>E</step><octave>4</octave></pitch><duration>1</duration></note>
      <note><pitch><step>G</step><octave>4</octave></pitch><duration>1</duration></note>
      <note><pitch><step>C</step><octave>5</octave></pitch><duration>2</duration></note>
    </measure>
    <measure number="2">
      <note><pitch><step>D</step><octave>4</octave></pitch><duration>2</duration></note>
      <note><chord/><pitch><step>F</step><octave>4</octave></pitch><duration>2</duration></note>
      <note><rest/><duration>1</duration></note>
      <note><pitch><step>B</step><octave>3</octave></pitch><duration>1</duration></note>
    </measure>
  </part>
</score-partwise>
"""


def test_cli_csv_matches_jax_export(tmp_path):
    cfg = _cfg(False)
    score = tmp_path / "piece.musicxml"
    score.write_text(SCORE_XML)
    parsed = jload_score(str(score))
    jm, params, tm = _models(cfg, parsed.note_array, 3)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model_config.json").write_text(json.dumps(cfg))
    torch.save(tm.state_dict(), ckpt / "best.pt")
    out = tmp_path / "port.csv"
    port_cli(["--checkpoint_dir", str(ckpt), "--score", str(score), "--output_csv", str(out), "--device", "cpu"])

    # the JAX package's decode and export of the same ids write the same file
    ids = tpred.predict_score_ids(tm, parsed.note_array, measures=parsed.measures,
                                  add_beats=False, add_measures=False, device="cpu")
    ref = tmp_path / "jax.csv"
    jpred.export_predictions_csv(str(ref), parsed.note_array, jpred.decode_predictions(ids))
    rows, ref_rows = list(csv.reader(open(out))), list(csv.reader(open(ref)))
    assert rows[0] == ["onset_div", "onset_beat", "pitch"] + sorted(TASK_DICT)
    assert len(rows) == len(parsed.note_array) + 1
    assert rows == ref_rows
