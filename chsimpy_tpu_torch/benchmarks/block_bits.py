#!/usr/bin/env python
"""Do the column (row) blocks of a matrix product give the whole product's
bits on a device?

    python -m chsimpy_tpu_torch.benchmarks.block_bits --device cuda

On the pencil layout every product contracts a local axis, so a rank
computes the columns (rows) of a product as a product of its own
(``ops/dct.py`` pencil forms).  Where the device's products give the
whole product's bits on such blocks, a pencil run's field repeats to the
bit across rank counts; where they do not, it holds to the dtype's class.
This tool answers for ``torch.matmul`` (TF32 off) on random operands from
a seed: one line per (N, dtype), for D column and row blocks.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device


def block_bits(N: int, dtype: torch.dtype, D: int, device) -> tuple:
    """(column blocks equal, row blocks equal): ``A @ B[:, cols]`` against
    the columns of ``A @ B``, and ``X[rows] @ A`` against the rows of
    ``X @ A``, for the D blocks of N/D, A (N/2, N/2)."""
    g = torch.Generator(device=device).manual_seed(0)
    A = torch.rand((N // 2, N // 2), generator=g, device=device, dtype=dtype)
    B = torch.rand((N // 2, N), generator=g, device=device, dtype=dtype)
    X = torch.rand((N, N // 2), generator=g, device=device, dtype=dtype)
    full, right = A @ B, X @ A
    c = N // D
    cols = all(torch.equal(A @ B[:, r * c:(r + 1) * c].contiguous(),
                           full[:, r * c:(r + 1) * c]) for r in range(D))
    rows = all(torch.equal(X[r * c:(r + 1) * c] @ A,
                           right[r * c:(r + 1) * c]) for r in range(D))
    return cols, rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.benchmarks.block_bits',
        description=__doc__.splitlines()[0])
    ap.add_argument('--sizes', default='512,4096')
    ap.add_argument('--ranks', default='2,4')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []
    for N in (int(v) for v in a.sizes.split(',')):
        for dtype in (torch.float64, torch.float32):
            parts = []
            for D in (int(v) for v in a.ranks.split(',')):
                cols, rows = block_bits(N, dtype, D, device)
                parts.append(f"D={D}: column blocks {cols}, row blocks "
                             f"{rows}")
            lines.append(f"N={N} {str(dtype)[6:]}: " + '; '.join(parts))
            print(lines[-1], flush=True)
    if device.type == 'cuda':
        from ..sysinfo import card_line
        print(card_line(), flush=True)
    return lines


if __name__ == '__main__':
    main()
