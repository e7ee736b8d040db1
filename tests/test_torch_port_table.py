"""The port's pandas-free TSV reader (``data/_table.py``) against
``pandas.read_csv(path, sep="\\t", low_memory=False)``, the reader of the JAX
package's corpora, and its ``to_numeric`` against ``pandas.to_numeric(...,
errors="coerce")``.

Tolerance: none.  Column by column, the names and their order, the inferred
kind (int, float, bool, or strings and mixed objects), every value with its
Python type and every missing position are equal: the JAX labels are built
from these values (``str(5.0)`` is ``'5.0'``), so equal values are what
keeps the labels equal.
"""

import io
import math

import numpy as np
import pandas as pd
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from analysisgnn_tpu_torch.data import _table

NA_SPELLINGS = sorted(_table.NA_STRINGS)
DLC_COLUMNS = ["onset_div", "duration_div", "onset_beat", "pitch", "step", "alter", "tpc", "a_degree1", "a_degree2",
               "a_isOnset", "pedal", "cadence_type", "valid_chord_label"]


def _kind(dtype) -> str:
    return {"i": "int", "u": "int", "f": "float", "b": "bool"}.get(np.dtype(dtype).kind, "object") \
        if not isinstance(dtype, pd.StringDtype) else "object"


def _same_value(a, b) -> bool:
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b and (not isinstance(a, float) or math.copysign(1, a) == math.copysign(1, b))


def assert_same_column(name, theirs: pd.Series, mine: np.ndarray):
    assert _kind(theirs.dtype) == _kind(mine.dtype), (name, theirs.dtype, mine.dtype)
    a, b = theirs.tolist(), mine.tolist()
    assert len(a) == len(b), name
    bad = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if not _same_value(x, y)]
    assert not bad, (name, bad[:5])
    np.testing.assert_array_equal(pd.isna(theirs).to_numpy(), _table.isna(mine), err_msg=name)


def assert_same_table(path):
    df = pd.read_csv(path, sep="\t", low_memory=False)
    table = _table.read_tsv(str(path))
    assert table.columns == list(df.columns)
    assert len(table) == len(df)
    for name in df.columns:
        assert_same_column(name, df[name], table[name])
        assert_same_column(f"to_numeric({name})", pd.to_numeric(df[name], errors="coerce"),
                           _table.to_numeric(table[name]))
    return df, table


# ------------------------------------------------------------------ generated

_int = st.integers(-10 ** 12, 10 ** 12).map(str) | st.integers(0, 999).map(lambda i: f"+{i:04d}")
_float = (st.floats(allow_nan=False, allow_infinity=False, width=64).map(repr)
          | st.decimals(-1000, 1000, places=3, allow_nan=False, allow_infinity=False).map(str)
          | st.sampled_from(["1e5", "-2.5E-3", ".5", "5.", "inf", "-Infinity", "0.30000000000000004",
                             "3.14159265358979323846", "1e400", "-0.0"]))
_bool = st.sampled_from(["True", "False", "true", "FALSE", "tRuE"])
_na = st.sampled_from(NA_SPELLINGS)
_text = st.text(alphabet="abcACEFG#-'.,()[] 0123456789_", min_size=1, max_size=8)

KINDS = {
    "int": lambda n: st.lists(_int, min_size=n, max_size=n),
    "int_na": lambda n: st.lists(_int | _na, min_size=n, max_size=n),
    "float": lambda n: st.lists(_float | _int, min_size=n, max_size=n),
    "float_na": lambda n: st.lists(_float | _na, min_size=n, max_size=n),
    "bool": lambda n: st.lists(_bool, min_size=n, max_size=n),
    "bool_na": lambda n: st.lists(_bool | _na, min_size=n, max_size=n),
    "string": lambda n: st.lists(_text | _na, min_size=n, max_size=n),
    "mixed": lambda n: st.lists(_int | _float | _bool | _text | _na, min_size=n, max_size=n),
    "all_na": lambda n: st.lists(_na, min_size=n, max_size=n),
}


@st.composite
def tables(draw):
    n = draw(st.integers(1, 12))
    kinds = draw(st.lists(st.sampled_from(sorted(KINDS)), min_size=1, max_size=9))
    names = draw(st.permutations(DLC_COLUMNS + [f"extra_{i}" for i in range(9)]))[:len(kinds)]
    columns = {name: draw(KINDS[kind](n)) for name, kind in zip(names, kinds)}
    return n, columns


@settings(max_examples=80, deadline=None, database=None, derandomize=True, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tables())
def test_generated_tables_read_as_pandas_reads_them(tmp_path, data):
    n, columns = data
    names = list(columns)
    lines = ["\t".join(names)] + ["\t".join(columns[c][i] for c in names) for i in range(n)]
    path = tmp_path / "t.tsv"
    path.write_text("\n".join(lines) + "\n")
    assert_same_table(path)


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(st.text(alphabet="0123456789.eE+- ", min_size=1, max_size=30))
def test_number_spellings_parse_as_pandas_parses_them(token):
    """Single cells of digits, signs, points and exponents, beside a plain
    integer: the column's kind and value (pandas' own float parser, whose
    rounding of a long significand differs from ``float``)."""
    if token in _table.NA_STRINGS or token.strip() == "":
        return
    series = pd.Series([token, "1"], dtype=object)
    assert_same_column(token, pd.to_numeric(series, errors="coerce"),
                       _table.to_numeric(np.array([token, "1"], dtype=object)))
    want = pd.read_csv(io.StringIO(f"a\n{token}\n1\n"), sep="\t", low_memory=False)["a"]
    assert_same_column(token, want, _table.parse_column([token, "1"]))


# ---------------------------------------------------------------- fixed cases

def test_the_cases_the_corpus_readers_depend_on(tmp_path):
    rows = [
        # a_degree2: integers with empty cells (float64); a_isOnset: bool; pedal: all empty
        ["0", "8", "0.0", "45", "A", "0", "A", "1", "", "True", "", "PAC", "1", "x"],
        ["4", "8", "1.0", "60", "C", "0", "C", "5", "5", "False", "", "", "1"],
        ["", "4", "NA", "62", "D", "#", "", "2", "2", "True", "", "HC", "0", "", "\"q\ty\""],
    ]
    header = DLC_COLUMNS + ["Unnamed", ""]
    header[-2] = "pitch"  # a repeated name and an empty one
    text = "\t".join(header) + "\n\n" + "\n".join("\t".join(r) for r in rows) + "\n"
    path = tmp_path / "t.tsv"
    path.write_text(text)
    df, table = assert_same_table(path)
    assert table.columns[-2:] == ["pitch.1", "Unnamed: 14"]
    assert table["a_degree2"].dtype == np.float64 and str(table["a_degree2"].tolist()[1]) == "5.0"
    assert table["a_degree1"].dtype == np.int64 and table["a_isOnset"].dtype == bool
    assert np.isnan(table["pedal"]).all()
    assert table["Unnamed: 14"].tolist()[2] == "q\ty"
    kept = table.rows(~_table.isna(table["tpc"]))
    want = df.dropna(subset=["tpc"]).reset_index(drop=True)
    assert len(kept) == len(want) == 2
    for name in want.columns:
        assert_same_column(name, want[name], kept[name])


def test_header_only_and_short_rows(tmp_path):
    path = tmp_path / "h.tsv"
    path.write_text("a\tb\tc\n")
    df, table = assert_same_table(path)
    assert len(table) == 0 and table.columns == ["a", "b", "c"]
    path.write_text("a\tb\tc\n1\t2\n3\n")
    assert_same_table(path)


def test_table_operations():
    t = _table.Table({"a": np.array([1, 2, 3]), "b": _table.object_array(["x", np.nan, [1, 2]])})
    t["c"] = 4
    assert t["c"].tolist() == [4, 4, 4] and t.columns == ["a", "b", "c"]
    r = t.rows(np.array([True, False, True]))
    assert len(r) == 2 and r["b"].tolist() == ["x", [1, 2]] and r["a"].dtype == np.int64
    assert t.rows(np.array([2, 0]))["a"].tolist() == [3, 1]
    np.testing.assert_array_equal(_table.isna(t["b"]), [False, True, False])
    np.testing.assert_array_equal(_table.fillna(np.array([1.5, np.nan]), 4), [1.5, 4.0])
    np.testing.assert_array_equal(_table.as_float(_table.object_array([1, np.nan])), [1.0, np.nan])
    pcsets = _table.object_array([[0, 4, 7], [2, 5, 9]])  # equal-length lists stay elements
    assert pcsets.shape == (2,) and pcsets.tolist() == [[0, 4, 7], [2, 5, 9]]
    copy = t.copy()
    copy["a"][0] = 9
    assert t["a"][0] == 1
