#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chsimpy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the root of a checkout, one card
    python3 chip_smoke.py --out DIR   # also write the details to DIR

Phases (each raises on failure, so the script exits nonzero):

1. the card's name and power limit (nvidia-smi); CUDA must be available;
2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the time;
3. each kernel against its plain PyTorch version on the card, float32 and
   float64, at N = 4096, 1000 and 512, with the tolerances stated below,
   and both timed with CUDA events (median of 30);
4. the canonical default run (N=512, float64, uniform, seed 2023) through
   ``Simulator.solve``: it must stop at step 1674 and hold the golden
   anchors of tests/golden/default_n512_anchors.json; the kernel launch
   counts of this run are the ones reported;
5. the CLI at N=4096 float32 (``python -m chsimpy_tpu_torch``), then the
   same configuration through the API in float32 (256 steps) and float64
   (64 steps): the float32 E trace within 1e-5 of float64, mean(U) held,
   every kernel launched on every step; steps/s of steady windows and the
   per-layer times of one step.

The last two lines of standard output are the kernels' JSON summary and
``{"ok": true, "device": {...}}``; with ``--out DIR`` every measurement also
goes to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KAPPA = 0.00029891134208698706   # derived kappa_tilde of the default run
SOURCE = 'chsimpy_tpu_torch/csrc/ch_kernels.cu'
REPLACES = {
    'chemical_potential': 'chsimpy_tpu/ops/pallas_kernels.py:81',
    'spectral_update': 'chsimpy_tpu/ops/pallas_kernels.py:113',
    'stats_sums': 'chsimpy_tpu/ops/pallas_kernels.py:288',
    'absdev_sum': 'chsimpy_tpu/ops/pallas_kernels.py:348',
}
REPORT_SHAPE = (4096, 'float32')   # the fast-mode shape of the JSON line


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, reps=30, warm=3):
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

def kernel_inputs(N, dtype, dev):
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.stepper import StepConfig, make_consts
    from chsimpy_tpu_torch.derived import Derived
    from chsimpy_tpu_torch.ops import kernels as K

    p = Parameters(N=N, kappa_tilde=KAPPA)
    d = Derived.from_params(p)
    cfg = StepConfig(N=N, dtype=str(dtype).split('.')[-1], RT=d.RT,
                     BRT=d.BRT, B=p.B, Amr=d.Amr, L=p.L, delx=d.delx,
                     delx2=d.delx2, M_tilde=p.M_tilde, threshold=p.threshold,
                     A0=d.A0, A1=d.A1, kappa_tilde=d.kappa_tilde)
    consts = make_consts(cfg, p.delt, device=dev)
    rng = np.random.default_rng(N)
    U = torch.tensor(0.875 + 0.01 * (rng.random((N, N)) - 0.5),
                     dtype=dtype, device=dev)
    hat_U = torch.tensor(rng.standard_normal((N, N)), dtype=dtype,
                         device=dev)
    E = K.chemical_potential_ref(U, cfg.RT, cfg.BRT, cfg.A0, cfg.A1)
    hat_E = torch.tensor(rng.standard_normal((N, N)), dtype=dtype,
                         device=dev)
    return cfg, consts, U, E, hat_U, hat_E


def kernel_phase(dev, card):
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N in (4096, 1000, 512):
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            cfg, c, U, E, hat_U, hat_E = kernel_inputs(N, dtype, dev)
            skw = dict(delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                       threshold=cfg.threshold)
            mean = (U.double().sum() / (N * N)).to(dtype)
            cases = {
                'chemical_potential': (
                    lambda: K.chemical_potential(U, cfg.RT, cfg.BRT, cfg.A0,
                                                 cfg.A1),
                    lambda: K.chemical_potential_ref(U, cfg.RT, cfg.BRT,
                                                     cfg.A0, cfg.A1)),
                'spectral_update': (
                    lambda: K.spectral_update(hat_U, hat_E, c['Seig'],
                                              c['CHeig']),
                    lambda: K.spectral_update_ref(hat_U, hat_E, c['Seig'],
                                                  c['CHeig'])),
                'stats_sums': (
                    lambda: K.stats_sums(U, E, cfg.A0, cfg.A1, **skw),
                    lambda: K.stats_sums_ref(U, E, cfg.A0, cfg.A1, **skw)),
                'absdev_sum': (
                    lambda: K.absdev_sum(U, mean),
                    lambda: K.absdev_sum_ref(U, mean)),
            }
            for name, (kern, ref) in cases.items():
                got, want = kern(), ref()
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs()
                err = diff.max().item()
                scale = want.double().abs()
                rel = err / scale.max().item()
                if name == 'chemical_potential':
                    # f32: the chain cancels ~1e2 terms down to O(1), so
                    # op-order differences show at ~100 eps absolute
                    bound = 1e-12 * scale.max().item() if f64 else 1e-4
                    ok = err <= bound
                    tol = '1e-12 x max|ref|' if f64 else 'atol 1e-4'
                elif name == 'spectral_update':
                    rtol = 1e-12 if f64 else 1e-6
                    ok = bool((diff <= rtol * scale).all())
                    tol = f'rtol {rtol:g}'
                else:
                    rtol = 1e-12 if f64 else 1e-5
                    ok = bool((diff <= rtol * scale).all())
                    tol = f'rtol {rtol:g}'
                    if name == 'stats_sums':
                        ok = ok and got[3].item() == want[3].item()
                        tol += ', count exact'
                ms = median_ms(kern)
                plain_ms = median_ms(ref)
                row = {'name': name, 'N': N, 'dtype': str(dtype)[6:],
                       'max_abs_err': err, 'max_rel_err': rel,
                       'tolerance': tol, 'ok': ok, 'ms': ms,
                       'plain_ms': plain_ms}
                rows.append(row)
                print(f"kernel {name:18s} N={N:5d} {row['dtype']:8s} "
                      f"err={err:.3e} rel={rel:.3e} ({tol}) "
                      f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
                      f"plain {plain_ms:.4f} ms  ({card})", flush=True)
                check(ok, f"{name} N={N} {dtype}: error {err:.3e} "
                          f"outside {tol}")
    return rows


# ----------------------------------------------------------------------
# phase 4: the canonical default run (the main path)
# ----------------------------------------------------------------------

def default_run():
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator
    from chsimpy_tpu_torch.ops import kernels as K

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'default_n512_anchors.json')) as f:
        g = json.load(f)
    p = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA)
    sim = Simulator(p)
    K.reset_launches()
    t0 = time.perf_counter()
    sol = sim.solve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.launches)
    td = sol.timedata.data()
    res = {'computed_steps': sol.computed_steps,
           'stop_reason': sol.stop_reason, 'tau0': sol.tau0, 't0': sol.t0,
           'seconds': seconds, 'launches': launches,
           'E_first_rel': abs(td[0, 1] / g['E_first'] - 1),
           'E_last_rel': abs(td[-1, 1] / g['E_last'] - 1),
           'E_every_100_max_rel': float(np.max(np.abs(
               td[::100, 1] / np.asarray(g['E_every_100']) - 1))),
           'argmax_E2': int(td[:, 2].argmax())}
    print(f"default run: {json.dumps(res)}", flush=True)
    check(tuple(sol.U.shape) == (512, 512) and sol.U.is_cuda
          and bool(torch.isfinite(sol.U).all()),
          'the field is not a finite (512, 512) tensor on the card')
    check(sol.computed_steps == g['computed_steps'] == 1674,
          f"stop step {sol.computed_steps} != 1674")
    check(sol.stop_reason == g['stop_reason'] == 'energy',
          f"stop reason {sol.stop_reason}")
    check(sol.tau0 == g['tau0'], f"tau0 {sol.tau0} != {g['tau0']}")
    check(abs(sol.t0 / g['t0'] - 1) <= 1e-12, 't0 outside 1e-12')
    check(res['E_first_rel'] <= 1e-12, 'E_first outside 1e-12')
    check(res['E_last_rel'] <= 1e-10, 'E_last outside 1e-10')
    check(res['E_every_100_max_rel'] <= 1e-10, 'E_every_100 outside 1e-10')
    check(res['argmax_E2'] == g['argmax_E2'], 'argmax E2 differs')
    for name, n in launches.items():
        check(n >= sol.computed_steps - 1,
              f"{name} launched {n} times in {sol.computed_steps} steps")
    return res


# ----------------------------------------------------------------------
# phase 5: fast mode at N=4096, CLI and API, rates and layer times
# ----------------------------------------------------------------------

def cli_run():
    cmd = [sys.executable, '-m', 'chsimpy_tpu_torch', '-N', '4096', '-n',
           '256', '-z', '--precision', 'float32', '--no-gui', '-g',
           'uniform', '-K', repr(KAPPA)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"CLI exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    m = re.search(r'computed_steps = (\d+)', proc.stdout)
    check(m and int(m.group(1)) == 256, f"CLI summary: {proc.stdout[-500:]}")
    m = re.search(r'kernel launches: (\{.*\})', proc.stdout)
    check(m is not None, 'CLI printed no kernel launch counts')
    launches = json.loads(m.group(1))
    for name, n in launches.items():
        check(n >= 255, f"CLI: {name} launched {n} times in 255 steps")
    print(f"cli run: 256 steps in {seconds:.1f} s (process included), "
          f"launches {launches}", flush=True)
    return {'seconds': seconds, 'launches': launches}


def make_solver(N, precision, chunk, full_sim=True):
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.solver import Solver
    p = Parameters(N=N, precision=precision, full_sim=full_sim,
                   generator='uniform', kappa_tilde=KAPPA, chunk_size=chunk,
                   no_gui=True, device='cuda')
    s = Solver(p)
    s.prepare()
    return s


def rate(solver, steps):
    """steps/s of one window of whole chunks after the solver's warm-up."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve_or_resume(steps)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def layer_ms(solver):
    """Per-layer times of one step at the solver's shapes (CUDA events)."""
    from chsimpy_tpu_torch.core import stepper
    from chsimpy_tpu_torch.ops import dct as dct_ops
    cfg, c, s = solver.cfg, solver._consts, solver._state
    E = stepper._nonlinear_term(cfg, c, s.U)
    hat_E = dct_ops.dct2(E, c['C'])
    return {
        'nonlinear_K1': median_ms(
            lambda: stepper._nonlinear_term(cfg, c, s.U)),
        'forward_dct': median_ms(lambda: dct_ops.dct2(E, c['C'])),
        'update_K2': median_ms(lambda: stepper.K.spectral_update(
            s.hat_U, hat_E, c['Seig'], c['CHeig'])),
        'inverse_dct': median_ms(lambda: dct_ops.idct2(s.hat_U, c['C'])),
        'stats_K3_K4_finalize': median_ms(
            lambda: stepper._stats(cfg, c, s.U, E)),
        'whole_step': median_ms(lambda: stepper._step(cfg, c, s), reps=20),
    }


def fast_mode(card):
    import numpy as np
    from chsimpy_tpu_torch.ops import kernels as K

    cli = cli_run()
    out = {'cli': cli}
    # float32 through the API: 256 steps, as the CLI run (full_sim)
    K.reset_launches()
    s32 = make_solver(4096, 'float32', 256)
    U0_mean = s32.solution.U.double().mean().item()
    sol32 = s32.solve_or_resume(256)
    launches = dict(K.launches)
    for name, n in launches.items():
        check(n >= 255, f"API f32: {name} launched {n} times in 255 steps")
    mean32 = sol32.U.double().mean().item()
    out['f32_launches'] = launches
    out['f32_mean_U'] = mean32
    out['f32_mean_U_initial'] = U0_mean
    check(abs(mean32 - U0_mean) <= 1e-6, f"f32 mean(U) drifted "
          f"{mean32 - U0_mean:.3e}")
    check(abs(mean32 - 0.875) <= 1e-6, f"f32 mean(U) {mean32} != 0.875")
    # float64 through the API, 64 steps, same configuration
    s64 = make_solver(4096, 'float64', 64)
    sol64 = s64.solve_or_resume(64)
    E32 = sol32.timedata.E[:64]
    E64 = sol64.timedata.E
    rel = float(np.max(np.abs(E32 / E64 - 1)))
    out['E_f32_vs_f64_max_rel'] = rel
    print(f"N=4096: f32 E vs f64 max rel {rel:.3e} over 64 steps; "
          f"mean(U) f32 {mean32!r} (initial {U0_mean!r})", flush=True)
    check(rel <= 1e-5, f"f32 E trace {rel:.3e} from f64 (limit 1e-5)")

    # steady windows after the warm-up chunk each solver has run
    rates = {
        'N=4096 float32': rate(s32, 512),
        'N=4096 float64': rate(s64, 256),
    }
    s512 = make_solver(512, 'float64', 1024)
    s512.solve_or_resume(1024)
    rates['N=512 float64'] = rate(s512, 2048)
    for k, v in rates.items():
        print(f"steps/s {k}: {v:.2f}  ({card})", flush=True)
    out['steps_per_s'] = rates
    out['layers_ms'] = {'N=4096 float32': layer_ms(s32),
                        'N=4096 float64': layer_ms(s64),
                        'N=512 float64': layer_ms(s512)}
    for k, v in out['layers_ms'].items():
        print(f"layers {k}: " + ', '.join(f"{n} {t:.4f} ms"
                                          for n, t in v.items()), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', help='directory for chip_smoke.json')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    from chsimpy_tpu_torch.ops import cuda_build
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    info = cuda_build.build()
    how = 'built' if info['built'] else 'cached'
    print(f"build: {info['seconds']:.1f} s ({how}) -> "
          f"{os.path.relpath(info['path'], ROOT)}", flush=True)
    if info['log']:
        print(info['log'], flush=True)
    dev = torch.device('cuda', torch.cuda.current_device())

    detail = {'card': card, 'torch': torch.__version__,
              'cuda': torch.version.cuda, 'build_seconds': info['seconds']}
    detail['kernels'] = kernel_phase(dev, card)
    detail['default_run'] = default_run()
    detail['fast_mode'] = fast_mode(card)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
            json.dump(detail, f, indent=1)

    summary = []
    for name, replaces in REPLACES.items():
        row = next(r for r in detail['kernels'] if r['name'] == name
                   and (r['N'], r['dtype']) == REPORT_SHAPE)
        summary.append({
            'name': name, 'route': 'cuda', 'source': SOURCE,
            'replaces': replaces,
            'launches': detail['default_run']['launches'][name],
            'max_abs_err': row['max_abs_err'],
            'max_rel_err': row['max_rel_err'], 'ms': row['ms'],
            'plain_ms': row['plain_ms'],
            'shape': f"{REPORT_SHAPE[0]}x{REPORT_SHAPE[0]} {REPORT_SHAPE[1]}"})
    print(card)
    print(json.dumps({'kernels': summary}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
