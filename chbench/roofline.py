"""The least time an H100 could take for a hand-written kernel's launch.

A frozen copy of the port's ``benchmarks/roofline.py`` memory peak
(NVIDIA H100 SXM data sheet, 700 W): 3.35 TB/s of HBM.  The kernels the
share counts are memory-bound (their operations at the data sheet's
67 / 34 TFLOP/s float32 / float64 take less time than their bytes), so a
launch's bound is its bytes at that rate: each
input read once and each output written once, counted from the cell's
shapes by the kernel's file under ``kernels/``: ``member_fields`` inputs
and outputs of R·N² elements (each member's own) and ``shared_fields`` of
N² elements (one for all members), of the field's type.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def kernel_bytes(entry: dict, R: int, N: int, itemsize: int) -> float:
    """Bytes a launch must move: its fields read and written once."""
    fields = entry.get('member_fields', 0) * R + entry.get('shared_fields', 0)
    return float(fields) * N * N * itemsize


def kernel_bound_s(entry: dict, R: int, N: int, itemsize: int) -> float:
    return kernel_bytes(entry, R, N, itemsize) / HBM_BYTES_PER_S
