"""The port's synthetic corpus generator (``data/synth_dlc.py``, numpy only)
against the JAX package's (pandas): the same tables from the same seeds, and
the same bytes on disk, down to the committed ``data_synth`` and
``data_synth_ood`` files."""

from pathlib import Path

import numpy as np
import pytest

from analysisgnn_tpu.data import synth_dlc as jsynth
from analysisgnn_tpu_torch.data import synth_dlc as tsynth
from analysisgnn_tpu_torch.data._table import is_na, read_tsv, write_tsv

REPO = Path(__file__).resolve().parent.parent

# (seed, style, n_phrases): small pieces of both styles
PIECES = [(0, "default", 2), (5, "default", 3), (70_004, "default", 1), (11, "ood", 2), (230_003, "ood", 3)]


@pytest.mark.parametrize("seed,style,n_phrases", PIECES)
def test_piece_equals_the_jax_frame(seed, style, n_phrases):
    frame = jsynth.generate_piece(seed, n_phrases=n_phrases, style=style)
    table = tsynth.generate_piece(seed, n_phrases=n_phrases, style=style)
    assert table.columns == list(frame.columns) and len(table) == len(frame)
    for name in frame.columns:
        want, got = frame[name].to_numpy(), table[name]
        assert got.dtype == want.dtype, name
        assert [is_na(v) for v in got] == [is_na(v) for v in want], name
        assert [v for v in got if not is_na(v)] == [v for v in want if not is_na(v)], name


@pytest.mark.parametrize("style,seed", [("default", 3), ("ood", 4)])
def test_corpus_bytes_equal_the_jax_writer(style, seed, tmp_path):
    jsplit = jsynth.write_corpus(str(tmp_path / "j"), n_pieces=3, n_phrases=2, seed=seed, style=style)
    tsplit = tsynth.write_corpus(str(tmp_path / "t"), n_pieces=3, n_phrases=2, seed=seed, style=style)
    assert tsplit == jsplit
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir()) and len(names) == 3
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


@pytest.mark.parametrize("corpus,seed,i,style", [
    ("data_synth", 7, 0, "default"), ("data_synth", 7, 1, "default"), ("data_synth", 7, 2, "default"),
    ("data_synth_ood", 23, 0, "ood"),
])
def test_committed_files_are_reproduced(corpus, seed, i, style, tmp_path):
    """scripts/parity_experiment.py wrote these with the JAX generator at 10
    phrases a piece; the port writes the same bytes, and reads them back as
    it reads the committed file."""
    committed = REPO / corpus / "all" / f"synth_{seed:02d}_{i:03d}.tsv"
    out = tmp_path / committed.name
    write_tsv(tsynth.generate_piece(seed * 10_000 + i, n_phrases=10, style=style), str(out))
    assert out.read_bytes() == committed.read_bytes()
    got, want = read_tsv(str(out)), read_tsv(str(committed))
    assert got.columns == want.columns
    for name in want.columns:
        assert got[name].dtype == want[name].dtype
        assert [is_na(v) for v in got[name]] == [is_na(v) for v in want[name]], name
        np.testing.assert_array_equal(got[name][~np.array([is_na(v) for v in got[name]])],
                                      want[name][~np.array([is_na(v) for v in want[name]])])

