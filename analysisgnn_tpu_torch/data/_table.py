"""Tab-separated tables without pandas.

The JAX package reads its TSV corpora with ``pandas.read_csv(path, sep="\\t",
low_memory=False)`` and builds labels from the Python values of the columns
pandas infers.  Those values decide the labels: an integer column with an
empty cell is read as float64, so ``str(v)`` gives ``'5.0'`` where a complete
column gives ``'5'``, and the vocabularies know only the second.  This module
reads the same files into the same values, column by column, as pandas' C
parser types them:

- a cell equal to one of pandas' default NA strings (:data:`NA_STRINGS`) is
  missing;
- integers with no missing cell: int64 (uint64 or Python ints past int64);
- numbers, or integers with a missing cell: float64, NaN where missing,
  parsed as pandas parses them (:func:`parse_double`);
- ``True``/``False`` in any case: bool, or object with NaN where missing;
- anything else: strings, NaN where missing;
- a column with no value: float64, all NaN.

:class:`Table` keeps one numpy array a column and offers the few frame
operations the corpus readers use; :func:`to_numeric` is
``pandas.to_numeric(errors="coerce")``.  The whole file is typed at once, as
``low_memory=False`` asks.
"""

from __future__ import annotations

import csv
import math
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

#: pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A",
    "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT64_MIN, _INT64_MAX, _UINT64_MAX = -(2 ** 63), 2 ** 63 - 1, 2 ** 64 - 1
_INT = re.compile(r"[ \t\n\r\f\v]*[+-]?[0-9]+[ \t\n\r\f\v]*", re.ASCII)
_NUM = re.compile(
    r"[ \t\n\r\f\v]*([+-]?)([0-9]*)(?:\.([0-9]*))?(?:([eE])[ \t\n\r\f\v]*([+-]?)([0-9]*))?[ \t\n\r\f\v]*", re.ASCII
)
_POW10 = [float(f"1e{k}") for k in range(309)]
_INF_WORDS = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
              "+infinity": math.inf, "-infinity": -math.inf}
_MAX_DIGITS = 17  # significant digits the parser accumulates


def _xstrtod(token: str) -> Tuple[Optional[float], bool]:
    """pandas' ``precise_xstrtod``: (value or None, integral).

    The significand accumulates at most 17 digits in double arithmetic, one
    rounding a digit, and is then scaled by one power of ten, so a long
    significand may round differently from ``float()``; blanks may follow the
    exponent's letter, and an exponent past 308 gives infinity."""
    m = _NUM.fullmatch(token)
    if m is None:
        return None, False
    sign, ipart, fpart, e, esign, edigits = m.groups()
    fpart = fpart or ""
    if not ipart and not fpart:
        return None, False
    if e is not None and not edigits:
        return None, False  # an 'e' without digits
    number, exponent, digits = 0.0, 0, 0
    for ch in ipart:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    decimals = 0
    for ch in fpart:
        if digits >= _MAX_DIGITS:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        decimals += 1
    exponent -= decimals
    if sign == "-":
        number = -number
    if edigits:
        exponent += -int(edigits) if esign == "-" else int(edigits)
    integral = m.group(3) is None and e is None
    if exponent > 308:
        return (math.copysign(math.inf, number) if number else number), integral
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        if exponent < -616:
            number = 0.0 * number
        else:
            number /= _POW10[-308 - exponent]
            number /= _POW10[308]
    else:
        number /= _POW10[-exponent]
    return number, integral


def parse_double(token: str) -> Optional[float]:
    """A cell as the file parser reads it as a double, or None."""
    value, _ = _xstrtod(token)
    if value is None:
        return _INF_WORDS.get(token.lower())
    return value


def parse_column(tokens: List[str]) -> np.ndarray:
    """Type one column of cells as pandas' C parser does (module docstring)."""
    if not tokens:
        return np.array([], dtype=object)
    missing = [t in NA_STRINGS for t in tokens]
    values = [t for t, m in zip(tokens, missing) if not m]
    if not values:
        return np.full(len(tokens), np.nan)
    has_na = any(missing)
    if not has_na and all(_INT.fullmatch(t) for t in values):
        ints = [int(t) for t in values]
        if all(_INT64_MIN <= i <= _INT64_MAX for i in ints):
            return np.array(ints, dtype=np.int64)
        if all(0 <= i <= _UINT64_MAX for i in ints):
            return np.array(ints, dtype=np.uint64)
        return object_array(ints)
    doubles = [parse_double(t) for t in values]
    if all(d is not None for d in doubles):
        out = np.full(len(tokens), np.nan)
        out[~np.array(missing)] = doubles
        return out
    if all(t.lower() in ("true", "false") for t in values):
        if not has_na:
            return np.array([t.lower() == "true" for t in values])
        return object_array(np.nan if m else t.lower() == "true" for t, m in zip(tokens, missing))
    return object_array(np.nan if m else t for t, m in zip(tokens, missing))


def object_array(items: Iterable) -> np.ndarray:
    """A 1-D object array of the items (lists and tuples stay elements)."""
    items = list(items)
    out = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):  # one by one: a slice assignment would unpack equal-length lists
        out[i] = item
    return out


def _header(names: List[str]) -> List[str]:
    """pandas' column names: 'Unnamed: i' for an empty name, '.1', '.2', ...
    after a repeated one."""
    names = [n if n != "" else f"Unnamed: {i}" for i, n in enumerate(names)]
    counts: Dict[str, int] = defaultdict(int)
    out = []
    for col in names:
        cur = counts[col]
        while cur > 0:
            counts[col] = cur + 1
            col = f"{col}.{cur}"
            cur = counts[col]
        out.append(col)
        counts[col] = cur + 1
    return out


class Table:
    """Named columns of one length, each a numpy array, in the header's order.

    Columns are read with ``table[name]`` and set with ``table[name] =
    array or scalar`` (a scalar fills the column); ``table.rows(keep)`` takes
    rows by a boolean mask or by index, keeping every column's type, as a
    frame's row selection does."""

    def __init__(self, columns: Dict[str, np.ndarray], length: Optional[int] = None):
        self._cols = {k: np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._cols.values()}
        if length is None:
            length = lengths.pop() if lengths else 0
        if lengths - {length}:
            raise ValueError(f"columns of lengths {sorted(lengths)} in a table of {length} rows")
        self._len = length

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._len

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, values) -> None:
        if np.ndim(values) == 0:
            values = np.full(self._len, values)
        values = np.asarray(values)
        if len(values) != self._len:
            raise ValueError(f"column {name!r} has {len(values)} rows for {self._len}")
        self._cols[name] = values

    def get(self, name: str, default=None):
        return self._cols.get(name, default)

    def rows(self, keep) -> "Table":
        keep = np.asarray(keep)
        n = int(keep.sum()) if keep.dtype == bool else len(keep)
        return Table({k: v[keep] for k, v in self._cols.items()}, n)

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self._cols.items()}, self._len)


def read_tsv(path: str) -> Table:
    """A tab-separated file with a header line, typed as
    ``pandas.read_csv(path, sep="\\t", low_memory=False)`` types it.  Blank
    lines are skipped, short rows are padded with missing cells, and a row
    with more cells than the header raises."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter="\t", quotechar='"', doublequote=True) if r]
    if not rows:
        raise ValueError(f"{path}: no header line")
    names = _header(rows[0])
    body = rows[1:]
    for i, r in enumerate(body):
        if len(r) > len(names):
            raise ValueError(f"{path}: expected {len(names)} fields in data row {i + 1}, saw {len(r)}")
    cells = [[r[j] if j < len(r) else "" for r in body] for j in range(len(names))]
    return Table({name: parse_column(col) for name, col in zip(names, cells)}, len(body))


def isna(values: np.ndarray) -> np.ndarray:
    """Per element: missing (None or NaN), as ``pandas.isna``."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype.kind == "O":
        return np.fromiter((is_na(v) for v in values), bool, len(values))
    return np.zeros(values.shape, bool)


def is_na(v) -> bool:
    """A scalar is missing (None or NaN), as ``pandas.isna``."""
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _to_number(v):
    """One object for ``to_numeric``: (kind, value), kind one of 'null',
    'float', 'int', 'bool'."""
    if v is None:
        return "null", math.nan
    if isinstance(v, (bool, np.bool_)):
        return "bool", bool(v)
    if isinstance(v, (int, np.integer)):
        v = int(v)
        return ("int", v) if _INT64_MIN <= v <= _UINT64_MAX else ("float", float(v))
    if isinstance(v, (float, np.floating)):
        return ("null", math.nan) if v != v else ("float", float(v))
    if isinstance(v, str):
        value, integral = _xstrtod(v)
        if value is None:
            inf = _INF_WORDS.get(v.lower())
            return ("float", inf) if inf is not None else ("null", math.nan)
        if integral:
            i = int(v)
            return ("int", i) if _INT64_MIN <= i <= _UINT64_MAX else ("float", value)
        return "float", value
    return "null", math.nan


def to_numeric(values) -> np.ndarray:
    """``pandas.to_numeric(values, errors="coerce")``: a numeric array as it
    is; objects parsed one by one, what does not parse missing, to int64
    when every value is an integer, bool when every value is a bool, else
    float64."""
    values = np.asarray(values)
    if values.dtype.kind in "iufb":
        return values
    parsed = [_to_number(v) for v in values.tolist()]
    kinds = {k for k, _ in parsed}
    if "null" in kinds or "float" in kinds:
        return np.array([float(v) for _, v in parsed], dtype=np.float64)
    if kinds == {"bool"}:
        return np.array([v for _, v in parsed], dtype=bool)
    ints = [int(v) for _, v in parsed]
    if all(i <= _INT64_MAX for i in ints):
        return np.array(ints, dtype=np.int64)
    if all(i >= 0 for i in ints):
        return np.array(ints, dtype=np.uint64)
    return np.array([float(i) for i in ints], dtype=np.float64)


def as_float(values) -> np.ndarray:
    """A column as float64, NaN where missing (``to_numpy(float)``)."""
    values = np.asarray(values)
    if values.dtype.kind == "O":
        return np.array([np.nan if is_na(v) else float(v) for v in values.tolist()], np.float64)
    return values.astype(np.float64)


def fillna(values: np.ndarray, value) -> np.ndarray:
    """Missing elements replaced by ``value`` (a numeric array after
    :func:`to_numeric`)."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return np.where(np.isnan(values), value, values)
    if values.dtype.kind == "O":
        mask = isna(values)
        out = values.copy()
        out[mask] = value
        return out
    return values
