#!/usr/bin/env python
"""2-D DCT transform bake-off on one device.

    python -m chsimpy_tpu_torch.benchmarks.dct_bench --sizes 4096 \\
        --dtypes float32 --reps 10 --out dct_bench.json

Port of ``chsimpy_tpu/benchmarks/dct_bench.py``.  Times ``inner`` chained
forward+inverse round trips (the per-step transform work of the stepper,
``idct2(dct2(x))`` without the update) for each route, with CUDA events on
the card (the host clock with ``--device cpu``); the first call is
excluded.  Reports median and best ms per round trip and the error after
the chained round trips (an exact pair returns x unchanged).

Routes (suffixes name the arithmetic: ``-fp32`` full float32 with TF32
off, ``-tf32`` with TF32 on for the call, ``-fp64`` at float64, where the
pair is one route):

* ``matmul-*``          C·U·Cᵀ on ``torch.matmul``;
* ``split{1,2,3}-*``    split tree, natural layout;
* ``split{1..5}perm-*`` split tree, permuted basis (the solver's route);
* ``split{2..5}permfold-*`` the same on a level-1 folded field;
* ``split2permT-*``     permuted, second pass by full-field transposes;
* ``fft``               Makhoul rFFT on ``torch.fft``;
* ``gemm``              the hand-written float32 GEMM kernel
  (``ops/kernels.py`` ``dct2_gemm``; float32 only), the JAX ``pallas``
  route's twin;
* ``ozaki-int8``, ``ozaki-int8-fold``, ``ozaki-rfold{1,2,3}`` (float64):
  the exact int8 slice routes, untrimmed.

Not ported: the ``hou*`` routes (the Hou recursion was measured and
rejected, ROADMAP.md queue A item 2) and ``ozaki-int8-fused`` (the fused
pair-group form, measured negative in the JAX package).  The JAX
``-pslice`` variants ran the Pallas slice kernel; on the card every ozaki
route runs the slice kernel, so each is one route here.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import dct as dct_ops
from ..ops import kernels as K
from ..ops import ozaki
from ..sysinfo import card_line

INNER = 50  # chained round trips per timed call


def _chain(body, inner):
    def f(x):
        for _ in range(inner):
            x = body(x)
        return x
    return f


def _tf32(body):
    """``body`` with TF32 products on for the call, the process-wide
    switch restored after it (the solver keeps TF32 off)."""
    def f(x):
        mm = torch.backends.cuda.matmul
        prev = mm.allow_tf32
        mm.allow_tf32 = True
        try:
            return body(x)
        finally:
            mm.allow_tf32 = prev
    return f


def _split_perm_t(tree):
    """The permuted split route with the second 1-D pass as a full-field
    transpose and a row application."""
    def f2d(u):
        X = dct_ops._apply_split_perm(tree, u)
        return dct_ops._apply_split_perm(tree, X.T).T

    def i2d(X):
        u = dct_ops._apply_split_t_perm(tree, X)
        return dct_ops._apply_split_t_perm(tree, u.T).T
    return lambda x: i2d(f2d(x))


def _roundtrip_fns(N, dtype, inner=INNER, device='cpu'):
    """name -> fn(x) -> x' running ``inner`` chained forward+inverse round
    trips of the route on ``device``; constants are made once here."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    f64 = dtype == torch.float64
    C = dct_ops.dct_matrix(N, dtype, device)
    tags = (('fp64', False),) if f64 else (('fp32', False), ('tf32', True))
    ftag = tags[0][0]
    bodies = {}

    def add(name, body, tf32=False):
        bodies[name] = _tf32(body) if tf32 else body

    for tag, tf32 in tags:
        add(f'matmul-{tag}',
            lambda x: dct_ops.idct2(dct_ops.dct2(x, C), C), tf32)
    for lv in (1, 2, 3):
        tree = dct_ops.split_tree(N, lv, dtype, device)
        for tag, tf32 in tags:
            add(f'split{lv}-{tag}',
                lambda x, t=tree: dct_ops.idct2_split(
                    dct_ops.dct2_split(x, t), t), tf32)
    for lv in (1, 2, 3, 4, 5):
        tree = dct_ops.split_tree(N, lv, dtype, device)
        add(f'split{lv}perm-{ftag}',
            lambda x, t=tree: dct_ops.idct2_split_perm(
                dct_ops.dct2_split_perm(x, t), t))
    for lv in (2, 3, 4, 5):
        tree = dct_ops.split_tree(N, lv, dtype, device)
        add(f'split{lv}permfold-{ftag}',
            lambda x, t=tree: dct_ops.idct2_split_perm_folded(
                dct_ops.dct2_split_perm_folded(x, t), t))
    add(f'split2permT-{ftag}',
        _split_perm_t(dct_ops.split_tree(N, 2, dtype, device)))
    add('fft', lambda x: dct_ops.idct2_fft(dct_ops.dct2_fft(x)))
    if not f64:
        add('gemm', lambda x: K.idct2_gemm(K.dct2_gemm(x, C), C))
    else:
        Cs, CsT, sc = ozaki.dct_slices(N, device)
        add('ozaki-int8', lambda x: ozaki.idct2_ozaki(
            ozaki.dct2_ozaki(x, Cs, CsT, sc), Cs, CsT, sc))
        fs = ozaki.dct_fold_slices(N, device)
        add('ozaki-int8-fold', lambda x: ozaki.idct2_ozaki_fold(
            ozaki.dct2_ozaki_fold(x, fs), fs))
        for L in (1, 2, 3):
            rf, rsc = ozaki.dct_rfold_slices(N, L, device)
            add(f'ozaki-rfold{L}',
                lambda x, rf=rf, rsc=rsc, L=L: ozaki.idct2_ozaki_rfold(
                    ozaki.dct2_ozaki_rfold(x, rf, rsc, L), rf, rsc, L))
    return {name: _chain(body, inner) for name, body in bodies.items()}


def _elapsed_ms(fn, x) -> float:
    """Milliseconds of one call: CUDA events on the card, the host clock
    (after the call returns) on the CPU."""
    if x.is_cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter()
    fn(x)
    return (time.perf_counter() - t0) * 1e3


def time_route(fn, x, reps, inner=INNER):
    """(median, best) ms per round trip over ``reps`` calls of ``fn``
    (each ``inner`` round trips), after one call that is not timed."""
    fn(x)
    samples = [_elapsed_ms(fn, x) / inner for _ in range(reps)]
    return float(np.median(samples)), float(np.min(samples))


def accuracy_route(fn, x):
    """Accumulated error against the input after one call of ``fn``."""
    r = fn(x)
    return float((r.double() - x.double()).abs().max().item())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sizes', default='2048,4096,8192')
    ap.add_argument('--dtypes', default='float32,float64')
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--routes', default=None,
                    help='comma-separated route-name substrings to run '
                         '(default: all)')
    ap.add_argument('--out', default=None, help='write JSON results here')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    route_filter = args.routes.split(',') if args.routes else None

    dev = resolve_device(args.device)
    dct_ops.require_full_fp32()
    card = card_line() if dev.type == 'cuda' else 'cpu'
    print(f"# device: {dev} ({card})")
    results = []
    for N in [int(s) for s in args.sizes.split(',')]:
        for dtype in args.dtypes.split(','):
            x = torch.tensor(np.random.default_rng(0).random((N, N)),
                             dtype=getattr(torch, dtype), device=dev)
            for name, fn in _roundtrip_fns(N, dtype, INNER, dev).items():
                if route_filter and not any(s in name
                                            for s in route_filter):
                    continue
                try:
                    med, best = time_route(fn, x, args.reps, INNER)
                    err = accuracy_route(fn, x)
                except Exception as e:
                    print(f"N={N} {dtype} {name}: FAILED {type(e).__name__}:"
                          f" {str(e)[:120]}")
                    results.append({'N': N, 'dtype': dtype, 'route': name,
                                    'error': str(e)[:200]})
                    continue
                print(f"N={N} {dtype} {name}: {med:.4f} ms median "
                      f"({best:.4f} best), rt-err {err:.2e}")
                results.append({'N': N, 'dtype': dtype, 'route': name,
                                'ms_median': med, 'ms_best': best,
                                'roundtrip_err': err})
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'card': card, 'device': str(dev), 'inner': INNER,
                       'results': results}, f, indent=1)
        print(f"# wrote {args.out}")
    return results


if __name__ == '__main__':
    main()
