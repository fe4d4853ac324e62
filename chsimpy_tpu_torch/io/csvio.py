"""CSV (optionally bz2-compressed) matrix import/export.

The files of ``chsimpy_tpu/io/csvio.py``, byte for byte, without pandas:

* plain CSV: ``np.savetxt(fmt='%s')`` (repr-exact float round trip);
* bz2 CSV: the text ``pandas.DataFrame(V).to_csv(index=False,
  header=None)`` writes — each value as numpy's ``str`` of its element
  type, NaN as an empty field, one row a line — compressed with ``bz2``.
  The compressed bytes may differ between bz2 builds; the text does not.

A 1-D array is one column, as both writers make it.
"""

from __future__ import annotations

import bz2
import difflib

import numpy as np


def csv_text(V) -> str:
    """The text of the bz2 CSV: ``to_csv``'s text for ``V``."""
    V = np.asarray(V)
    if V.ndim == 1:
        V = V.reshape(-1, 1)
    if V.ndim != 2:
        raise ValueError(f"expected a 1-D or 2-D array, got {V.ndim}-D")
    cells = V.astype(str)
    if V.dtype.kind in 'fc':
        cells[np.isnan(V)] = ''
    return ''.join(','.join(row) + '\n' for row in cells)


def csv_export_matrix(V, fname: str) -> None:
    V = np.asarray(V)
    if fname.endswith('bz2'):
        with bz2.open(fname, 'wt', newline='') as f:
            f.write(csv_text(V))
    else:
        np.savetxt(fname, V, delimiter=',', fmt='%s')


def _parse_cell(x: str) -> float:
    x = x.strip()
    return float(x) if x else np.nan


def csv_import_matrix(fname: str) -> np.ndarray:
    """The matrix of a plain CSV (``np.loadtxt``: a one-column file gives
    a 1-D array) or of a bz2 CSV (2-D, as ``pandas.read_csv(...).values``
    gives it, in float64; an empty field, the bz2 writer's NaN, reads as
    NaN)."""
    if not fname.endswith('bz2'):
        return np.loadtxt(fname, delimiter=',')
    with bz2.open(fname, 'rt') as f:
        rows = [[_parse_cell(x) for x in line.rstrip('\r\n').split(',')]
                for line in f if line.strip()]
    return np.array(rows, dtype=np.float64)


def csv_export_list(fname: str, lines) -> None:
    """Write ``lines`` (one string, or an iterable of strings) as they
    are."""
    with open(fname, 'w') as f:
        if isinstance(lines, str):
            f.write(lines)
        else:
            f.writelines(lines)


def validate_solution_files(file_new: str, file_truth: str) -> bool:
    """Line-diff two solution files (reference ``utils.py:94-104``)."""
    with open(file_new) as fnew, open(file_truth) as ftruth:
        diff = difflib.ndiff(fnew.readlines(), ftruth.readlines())
    delta = ''.join(x[2:] for x in diff if x.startswith('- '))
    return not delta
