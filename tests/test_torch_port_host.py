"""The port's host path against the JAX package's: the same seeds give
identical numpy arrays (exact equality, no tolerance) from synthetic_score,
select_features, the encoders, build_score_graph (the JAX package's numpy
path) and the padded graph container; the vocabularies and the MusicXML
parser agree too."""

import numpy as np
import pytest

from analysisgnn_tpu.core.graph import HeteroGraph as JGraph
from analysisgnn_tpu.core.graph import parse_edge_type_key
from analysisgnn_tpu.data import features as jfeat
from analysisgnn_tpu.data import graph_build as jgb
from analysisgnn_tpu.data import musicxml as jxml
from analysisgnn_tpu.data import note_array as jna
from analysisgnn_tpu.inference import predict as jpred
from analysisgnn_tpu.theory import encoders as jenc
from analysisgnn_tpu.theory import vocab as jvocab
from analysisgnn_tpu_torch.core.graph import HeteroGraph as TGraph
from analysisgnn_tpu_torch.core.graph import metadata as tmetadata
from analysisgnn_tpu_torch.data import features as tfeat
from analysisgnn_tpu_torch.data import graph_build as tgb
from analysisgnn_tpu_torch.data import musicxml as txml
from analysisgnn_tpu_torch.data import note_array as tna
from analysisgnn_tpu_torch.inference import predict as tpred
from analysisgnn_tpu_torch.theory import encoders as tenc
from analysisgnn_tpu_torch.theory import vocab as tvocab

SCORE_XML = """<?xml version="1.0"?>
<score-partwise version="3.1">
  <part-list><score-part id="P1"/></part-list>
  <part id="P1">
    <measure number="1">
      <attributes><divisions>2</divisions><key><fifths>-2</fifths></key>
        <time><beats>3</beats><beat-type>4</beat-type></time></attributes>
      <note><pitch><step>B</step><alter>-1</alter><octave>3</octave></pitch><duration>2</duration></note>
      <note><chord/><pitch><step>D</step><octave>4</octave></pitch><duration>2</duration></note>
      <note><pitch><step>F</step><octave>4</octave></pitch><duration>1</duration><tie type="start"/></note>
      <note><pitch><step>F</step><octave>4</octave></pitch><duration>1</duration><tie type="stop"/></note>
      <note><rest/><duration>2</duration></note>
    </measure>
    <measure number="2">
      <note><pitch><step>E</step><alter>-1</alter><octave>4</octave></pitch><duration>6</duration></note>
    </measure>
  </part>
</score-partwise>
"""


@pytest.mark.parametrize("num_notes,seed", [(40, 0), (120, 5)])
def test_note_array_features_encoders_identical(num_notes, seed):
    a = jna.synthetic_score(num_notes, seed=seed)
    b = tna.synthetic_score(num_notes, seed=seed)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    for name in ("voice", "simple"):
        np.testing.assert_array_equal(jfeat.select_features(a, name), tfeat.select_features(b, name))
    np.testing.assert_array_equal(jenc.PitchEncoder().encode(a), tenc.PitchEncoder().encode(b))
    np.testing.assert_array_equal(jenc.KeySignatureEncoder().encode(a), tenc.KeySignatureEncoder().encode(b))


@pytest.mark.parametrize("beats_measures", [False, True])
@pytest.mark.parametrize("num_notes,seed", [(60, 1), (110, 2)])
def test_build_score_graph_identical(num_notes, seed, beats_measures):
    na = jna.synthetic_score(num_notes, seed=seed)
    want = jgb.build_score_graph(na, add_beats=beats_measures, add_measures=beats_measures, use_native=False)
    got = tgb.build_score_graph(na, add_beats=beats_measures, add_measures=beats_measures)
    assert (got.num_notes, got.num_beats, got.num_measures) == (want.num_notes, want.num_beats, want.num_measures)
    assert list(got.edges) == list(want.edges)
    for et in want.edges:
        np.testing.assert_array_equal(got.edges[et], want.edges[et])
    _, edge_types = tmetadata(beats_measures, beats_measures)
    assert set(edge_types) == set(got.edges)


@pytest.mark.parametrize("bucket_factor", [None, 1.25])
def test_graph_container_padding_identical(bucket_factor):
    """Same ragged arrays in, same padded arrays out (padding edge ids equal
    the padded node capacity)."""
    na = jna.synthetic_score(70, seed=3)
    g = tgb.build_score_graph(na, add_beats=True, add_measures=True)
    feats = {"note": tfeat.select_features(na), "beat": np.zeros((g.num_beats, 25), np.float32),
             "measure": np.zeros((g.num_measures, 25), np.float32)}
    attrs = {"note": {"pitch_spelling": tenc.PitchEncoder().encode(na)}}
    caps = {}
    if bucket_factor:
        caps = dict(
            node_capacity={t: tpred.bucket_capacity(len(x), bucket_factor) for t, x in feats.items()},
            edge_capacity={et: tpred.bucket_capacity(ei.shape[1], bucket_factor) for et, ei in g.edges.items()},
        )
    want = JGraph.from_numpy(feats, g.edges, node_attrs=attrs, num_target_nodes=60, to_device=False, **caps)
    got = TGraph.from_numpy(feats, g.edges, node_attrs=attrs, num_target_nodes=60, **caps)
    for t, x in want.node_features.items():
        np.testing.assert_array_equal(got.node_features[t].numpy(), x)
        assert got.num_nodes[t] == int(want.num_nodes[t])
        for k, v in want.node_attrs[t].items():
            np.testing.assert_array_equal(got.node_attrs[t][k].numpy(), v)
    for et, ei in want.edge_index_dict().items():
        np.testing.assert_array_equal(got.edges(et).numpy(), ei)
    assert got.num_edges == {parse_edge_type_key(k): int(v) for k, v in want.num_edges.items()}
    assert got.num_target_nodes == int(want.num_target_nodes) == 60


def test_serving_graph_matches_jax():
    """graph_from_note_array: identical features, attributes and capacities;
    identical edge sets (the JAX package may build them with its native
    builder, in another order within a relation)."""
    na = jna.synthetic_score(90, seed=4)
    want = jpred.graph_from_note_array(na, add_beats=True, add_measures=True, bucket_factor=1.25)
    got = tpred.graph_from_note_array(na, add_beats=True, add_measures=True, bucket_factor=1.25)
    for t, x in want.node_features.items():
        np.testing.assert_array_equal(got.node_features[t].numpy(), np.asarray(x))
        for k, v in want.node_attrs[t].items():
            np.testing.assert_array_equal(got.node_attrs[t][k].numpy(), np.asarray(v))
    for et, ei in want.edge_index_dict().items():
        ei = np.asarray(ei)
        mine = got.edges(et).numpy()
        assert mine.shape == ei.shape
        np.testing.assert_array_equal(mine[:, np.lexsort(mine[::-1])], ei[:, np.lexsort(ei[::-1])])


def test_vocab_and_capacity_ladder_identical():
    assert tvocab.TASK_DICT == jvocab.TASK_DICT
    jreps, treps = jvocab.available_representations(), tvocab.available_representations()
    assert list(treps) == list(jreps)
    for name, rep in jreps.items():
        assert treps[name].class_list == rep.class_list
    for n in (1, 64, 65, 999, 20000):
        assert tpred.bucket_capacity(n) == jpred.bucket_capacity(n)


def test_musicxml_parse_identical(tmp_path):
    path = tmp_path / "s.musicxml"
    path.write_text(SCORE_XML)
    want = jxml.load_score(str(path))
    got = txml.load_score(str(path))
    np.testing.assert_array_equal(got.note_array, want.note_array)
    np.testing.assert_array_equal(got.measures, want.measures)
    assert got.divs_per_quarter == want.divs_per_quarter
    # a .krn path goes to the kern parser, as in the JAX package (tests/test_torch_port_kern.py)
    with pytest.raises(FileNotFoundError):
        txml.load_score(str(tmp_path / "piece.krn"))
    with pytest.raises(FileNotFoundError):
        jxml.load_score(str(tmp_path / "piece.krn"))
