"""The port's Humdrum **kern parser (``data/kern.py``) and ``load_score``'s
dispatch against the JAX package's, on ``tests/test_kern.py``'s text and on
texts that reach the parser's other branches (spine splits and joins, grace
notes, tuplets, breves, rests, ragged lines, a key and time change).  The
note arrays and measure spans are compared field for field: equal.
"""

import numpy as np
import pytest

from analysisgnn_tpu.data import kern as jkern
from analysisgnn_tpu.data import musicxml as jxml
from analysisgnn_tpu_torch.data import kern as tkern
from analysisgnn_tpu_torch.data import musicxml as txml
from tests.test_kern import KERN

SPLIT = """!! a comment
**kern\t**kern\t**dynam
*M3/4\t*M3/4\t*
*k[b-e-]\t*k[b-e-]\t*
=1\t=1\t=1
4C\t*^\tp
.\t8g\t8bb-\t.
4E-\t8a-\t8cc\t.
4G\t4b-q\t4dd\t.
4G\t4b-\t4dd\t.
=2\t=2\t=2\t=2
*\t*v\t*v\t*
2.C\t2.g 2.cc\t.
=3\t=3\t=3
*M2/4\t*M2/4\t*
*k[f#]\t*k[f#]\t*
3c\t6d\t.
3d\t6e 6g\t.
3e\t6f#\t.
.\t4r\t.
0G\t0GG\t.
*-\t*-\t*-
"""

RAGGED = """**kern\t**kern
*M4/4\t*M4/4
4c\t4e
4d
[4e\t4g
4e]\t.
4f\t4a
==\t==
"""


@pytest.mark.parametrize("text", [KERN, SPLIT, RAGGED], ids=["test_kern", "spines", "ragged"])
def test_parse_kern_identical(text):
    want, got = jkern.parse_kern(text), tkern.parse_kern(text)
    assert got.note_array.dtype == want.note_array.dtype
    for field in want.note_array.dtype.names:
        np.testing.assert_array_equal(got.note_array[field], want.note_array[field], err_msg=field)
    np.testing.assert_array_equal(got.measures, want.measures)
    assert got.divs_per_quarter == want.divs_per_quarter


@pytest.mark.parametrize("token", ["4c", "8cc#", "2C", "4BB-", "4g", "2.d", "16..e", "0G", "00c", "3f", "6AA-n",
                                   "12cc##", "4r", ".", "xyz", "0."])
def test_recip_and_pitch_identical(token):
    assert tkern._recip_duration(token) == jkern._recip_duration(token)
    assert tkern._parse_pitch(token) == jkern._parse_pitch(token)


def test_load_score_dispatches_krn_only(tmp_path):
    krn = tmp_path / "piece.krn"
    krn.write_text(SPLIT)
    want, got = jxml.load_score(str(krn)), txml.load_score(str(krn))
    np.testing.assert_array_equal(got.note_array, want.note_array)
    np.testing.assert_array_equal(got.measures, want.measures)
    # as in the JAX package, a .kern path goes to the MusicXML parser, which refuses kern text
    kern = tmp_path / "piece.kern"
    kern.write_text(SPLIT)
    with pytest.raises(Exception) as jerr:
        jxml.load_score(str(kern))
    with pytest.raises(Exception) as terr:
        txml.load_score(str(kern))
    assert type(terr.value).__name__ == type(jerr.value).__name__
    with pytest.raises(ValueError, match="no notes"):
        tkern.parse_kern("**kern\n*M4/4\n4r\n*-\n")
