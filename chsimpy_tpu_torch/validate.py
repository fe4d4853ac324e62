"""Numeric validation against reference outputs.

A copy of ``chsimpy_tpu/validate.py`` (the port imports nothing of the JAX
package), reading matrices through the port's ``io.csvio``.

The reference only line-diffs solution files (``chsimpy/utils.py:94-104``).
Trace validation here is numeric with an explicit tolerance ladder, because
two correct f64 implementations of the same chaotic dynamics (matmul-DCT vs
pocketfft) diverge in a structured way:

* E (total energy): dominated by the bulk term — tight (<=1e-10 relative,
  the BASELINE contract);
* delt/domtime/it: exact arithmetic — essentially bit-level;
* E2/Ra/PS/L2: gradient-of-field quantities — cancellation amplifies the
  field divergence, so they are bounded but looser;
* U fields: statewise comparisons should use summary checksums (mean/sum)
  tight, pointwise loose.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .io import csvio
from .io.csvio import validate_solution_files  # noqa: F401  (re-export)

#: column index -> (name, rtol) for a 9-column timedata trace
TRACE_TOLERANCES = {
    0: ('it', 0.0),
    1: ('E', 1e-10),
    2: ('E2', 1e-4),
    3: ('SA', 1e-3),
    4: ('domtime', 1e-12),
    5: ('Ra', 1e-4),
    6: ('L2', 1e-5),
    7: ('PS', 1e-4),
    8: ('delt', 1e-12),
}


@dataclass
class TraceReport:
    ok: bool
    n_rows: int
    per_column: dict = field(default_factory=dict)
    failures: list = field(default_factory=list)

    def __str__(self):
        lines = [f"trace comparison over {self.n_rows} rows: "
                 f"{'OK' if self.ok else 'FAIL'}"]
        for name, (max_rel, rtol, row) in self.per_column.items():
            mark = 'ok ' if max_rel <= rtol or rtol == 0.0 else 'FAIL'
            lines.append(f"  [{mark}] {name}: max rel err {max_rel:.3e} "
                         f"(tol {rtol:g}, worst row {row})")
        return "\n".join(lines)


def compare_traces(trace_new: np.ndarray, trace_ref: np.ndarray,
                   tolerances: dict = None) -> TraceReport:
    """Column-wise relative comparison of two (n, 9) timedata arrays."""
    tolerances = tolerances or TRACE_TOLERANCES
    if trace_new.shape != trace_ref.shape:
        return TraceReport(ok=False, n_rows=0,
                           failures=[f"shape mismatch: {trace_new.shape} "
                                     f"vs {trace_ref.shape}"])
    rep = TraceReport(ok=True, n_rows=trace_new.shape[0])
    for col, (name, rtol) in tolerances.items():
        a = trace_ref[:, col]
        b = trace_new[:, col]
        if rtol == 0.0:
            ok = np.array_equal(a, b)
            rep.per_column[name] = (0.0 if ok else np.inf, rtol, -1)
            if not ok:
                rep.ok = False
                rep.failures.append(f"{name}: exact mismatch")
            continue
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-300)
        worst = int(np.argmax(rel))
        rep.per_column[name] = (float(rel.max()), rtol, worst)
        if rel.max() > rtol:
            rep.ok = False
            rep.failures.append(
                f"{name}: max rel err {rel.max():.3e} > {rtol:g} "
                f"at row {worst}")
    return rep


def compare_fields(U_new: np.ndarray, U_ref: np.ndarray,
                   rtol_pointwise: float = 1e-5,
                   rtol_checksum: float = 1e-11) -> dict:
    """Field comparison: tight on conserved checksums, loose pointwise."""
    out = {}
    out['shape_ok'] = U_new.shape == U_ref.shape
    if not out['shape_ok']:
        out['ok'] = False
        return out
    sum_rel = abs(U_new.sum() - U_ref.sum()) / max(abs(U_ref.sum()), 1e-300)
    rel = np.abs(U_new - U_ref) / np.maximum(np.abs(U_ref), 1e-300)
    out['checksum_rel'] = float(sum_rel)
    out['pointwise_max_rel'] = float(rel.max())
    out['ok'] = (sum_rel <= rtol_checksum
                 and float(rel.max()) <= rtol_pointwise)
    return out


def compare_solution_csvs(file_new: str, file_ref: str, **kw) -> dict:
    """Load two exported matrices (csv or bz2) and compare as fields."""
    return compare_fields(csvio.csv_import_matrix(file_new),
                          csvio.csv_import_matrix(file_ref), **kw)
