"""The least time an H100 could take for a kernel's work (``bound_ms``):
the larger of its bytes (each input read once, each output written once)
over the memory rate and its operations over the peak rate of their type
(NVIDIA H100 SXM data sheet, 700 W; float64 outside the tensor cores).
``chip_smoke.py`` and the benchmarks take their bounds from here."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# float32 and float64 outside the tensor cores; TF32 on them (dense);
# 32-bit integer operations: 132 SMs x 64 lanes x 1.98 GHz (the H100
# SXM's top SM clock)
INT32_CLOCK_HZ = 1.98e9
PEAK_OPS_PER_S = {'float32': 67e12, 'float64': 34e12, 'tf32': 495e12,
                  'int32': 132 * 64 * INT32_CLOCK_HZ}
# operations per element, counting each arithmetic operation, comparison
# and log as one
OPS_PER_ELEM = {'chemical_potential': 13, 'spectral_update': 3,
                # K12: leig, its square, CHeig, Seig, the update (5), and
                # each thread's lam1, lam2 (2 divisions, a product)
                'update_otf': 11,
                'stats': 27, 'absdev_sum': 3, 'slice_setup': 6,
                'slice_per_plane': 6, 'sobol_jitter': 6,
                # 32-bit integer operations: threefry2x32's 20 rounds of
                # add, rotate, xor and its 6 key injections, the counter
                # and the float bits
                'threefry_jitter': 80}


def bound_fields(nbytes, ops, dtype):
    """``nbytes`` at the memory rate against ``ops`` at the peak rate of
    ``dtype`` (a PEAK_OPS_PER_S key): {'bound_ms', 'bound_by'}."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def slice_bound(numel, n_slices):
    """bound_fields of K5 on ``numel`` float64 values (a field, a block
    or a stack of them): each read once, ``n_slices`` int8 planes
    written."""
    return bound_fields(numel * (8 + n_slices),
                        (OPS_PER_ELEM['slice_setup']
                         + OPS_PER_ELEM['slice_per_plane'] * n_slices)
                        * numel, 'float64')
