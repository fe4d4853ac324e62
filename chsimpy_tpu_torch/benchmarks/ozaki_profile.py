#!/usr/bin/env python
"""Component profile of the float64 ozaki transform on one device.

    python -m chsimpy_tpu_torch.benchmarks.ozaki_profile -N 4096 \\
        --out ozaki_profile.json

Port of ``chsimpy_tpu/benchmarks/ozaki_profile.py``.  It times cumulative
prefixes of the unfolded forward transform (``ops/ozaki.py``
``dct2_ozaki``), so the cost of each stage falls out by differencing:

  P1 slice      : K5 + a direct recombination of the slices
  P2 +stage1    : slice -> the stage-1 int8 products -> group Horner
                  (value C @ U)
  P3 +renorm    : slice -> stage-1 products -> carry renorm -> a
                  recombination of the renormalized slots
  P4 full dct2  : the route's forward transform (adds the stage-2
                  products, the final Horner and the DC split)

P1-P3 emit the slice and slot counts P4 emits, so the differences are the
stages of P4.  Every pipeline maps an (N, N) float64 field to an
equal-norm (N, N) field (the 1-D DCT pass keeps the norm), so each chains
through a loop of ``--inner`` calls.  A sample is one chained loop between
two CUDA events with a ``torch.cuda.synchronize()`` after it (the host
clock with ``--device cpu``); the first loop is not timed.  The JSON
output has the JAX tool's keys (``N``, ``results``: ``pipeline``,
``ms_median``, ``ms_best``, ``ms_delta``), unrounded, and the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import ozaki
from ..sysinfo import card_line


def _recombine(slices, scale, dtype=torch.float64):
    """Σ_k slices[k] 2^{-7(k+1)}, times scale: the inverse of the slice
    convention, a Horner chain like the stage-2 recombination."""
    acc = slices[-1].to(dtype)
    for k in range(slices.shape[0] - 2, -1, -1):
        acc = acc * 2.0 ** -7 + slices[k].to(dtype)
    return acc * 2.0 ** -7 * scale


def build_pipelines():
    """name -> fn(x, Cs, CsT, sc), the four cumulative prefixes."""
    n_field = ozaki._n_field()
    n_renorm = ozaki._n_slots()

    def p1_slice(x, Cs, CsT, sc):
        Us, su = ozaki.slice_field(x, n_field)
        return _recombine(Us, su)

    def p2_stage1(x, Cs, CsT, sc):
        Us, su = ozaki.slice_field(x, n_field)
        g1 = ozaki._pair_groups(Cs, Us, max_pair=ozaki.STAGE1_PAIR)
        return ozaki._horner_f64(g1) * (su * sc)

    def p3_renorm(x, Cs, CsT, sc):
        Us, su = ozaki.slice_field(x, n_field)
        g1 = ozaki._pair_groups(Cs, Us, max_pair=ozaki.STAGE1_PAIR)
        t = ozaki._renorm_to_slices(g1, n_slices=n_renorm)
        return _recombine(t, su * sc * 2.0 ** ozaki.RENORM_SHIFT)

    def p4_full(x, Cs, CsT, sc):
        return ozaki.dct2_ozaki(x, Cs, CsT, sc)

    return {'P1 slice+recombine': p1_slice,
            'P2 +stage1 dots': p2_stage1,
            'P3 +renorm': p3_renorm,
            'P4 full dct2': p4_full}


def time_pipeline(fn, x, consts, inner, reps):
    """(median, best) ms per call over ``reps`` chained loops of
    ``inner`` calls, after one loop that is not timed."""
    Cs, CsT, sc = consts

    def loop():
        y = x
        for _ in range(inner):
            y = fn(y, Cs, CsT, sc)
        return y

    loop()
    samples = []
    for _ in range(reps):
        if x.is_cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loop()
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            loop()
            ms = (time.perf_counter() - t0) * 1e3
        samples.append(ms / inner)
    return float(np.median(samples)), float(np.min(samples))


def profile_field(N: int, device='cpu') -> torch.Tensor:
    """The profiled field: the JAX tool's, 0.875 + 0.01 (r - 0.5) with r
    from numpy's default_rng(0)."""
    return torch.tensor(0.875 + 0.01 * (np.random.default_rng(0)
                                        .random((N, N)) - 0.5),
                        dtype=torch.float64, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('-N', type=int, default=4096)
    ap.add_argument('--inner', type=int, default=10)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    card = card_line() if dev.type == 'cuda' else 'cpu'
    print(f"# device: {dev} ({card})")
    x = profile_field(args.N, dev)
    consts = ozaki.dct_slices(args.N, dev)
    # each row differences against the previous one (cumulative prefixes)
    rows = []
    prev = 0.0
    for name, fn in build_pipelines().items():
        med, best = time_pipeline(fn, x, consts, args.inner, args.reps)
        delta = med - prev
        prev = med
        print(f"{name}: {med:.4f} ms median ({best:.4f} best), "
              f"delta {delta:+.4f} ms")
        rows.append({'pipeline': name, 'ms_median': med, 'ms_best': best,
                     'ms_delta': delta})
    out = {'N': args.N, 'results': rows, 'card': card, 'device': str(dev),
           'inner': args.inner, 'reps': args.reps}
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {args.out}")
    return out


if __name__ == '__main__':
    main()
