#!/usr/bin/env python
"""Monte-Carlo UQ experiment driver.

Port of ``chsimpy_tpu/experiment.py`` (the reference's
``chsimpy/experiment.py``): perturbs the A0/A1 Redlich-Kister coefficients
by factors in [0.995, 1.005] drawn from uniform/sobol/grid/file sources,
runs one simulation per (A0, A1) pair, post-processes each run (miscibility
gap, spinodal EPP roots, separation time) and aggregates to
``<id>-results.csv`` / ``<id>-results-agg.csv``: the JAX package's files,
byte for byte.

The runs go through :class:`~chsimpy_tpu_torch.ensemble.EnsembleSolver` on
the run's device (the member-batched K1-K4 on the card, and K5 on the
float64 ``--transform ozaki`` route), at most
``-P/--processes`` members per batch.  The per-member host work (CSV/YAML
export, the PNG of ``--png`` and the sympy post-processing) runs in a
spawn-based process pool (:class:`HostPipeline`, ``--host-procs``),
overlapped with the next batch's solve; its workers never touch the card.
The aggregate is computed on numpy (no pandas on the card's machine) and
written as pandas' ``to_csv`` writes it.  ``--live-view`` shows member
0's field, cut to at most 512 pixels a side on the card before the copy,
about every ``--update-every`` steps: the batch's chunk shrinks to that,
which changes no member's bits.

With ``--coordinator host:port --num-processes P --process-id p`` the
experiment is one process of P: the processes form a ``torch.distributed``
world at the coordinator (one process per device, as one JAX process per
host holds its devices), the batches run on an ('ens', 'x', 'y') mesh of
``(P / (mx*my), mx, my)`` ranks (``--mesh MxN``, default 1x1), process
``p`` runs the host pipeline of the runs ``run_id % P == p``, and the
rows are merged (as Python objects, so a None stays None and a NaN stays
NaN) before process 0 alone writes the metadata and the results tables
and shows the progress bar: the bytes of a single-process run.  Each
process binds card ``p`` modulo the host's cards (``--dist-backend
nccl``: one card each).

``--png-anim`` is refused as in the JAX package.  The JAX
package's four-wide batch clamp for float64 ozaki
(``_resolve_batch_width``) guards a TPU compiler fault and has no
counterpart: the auto width is :func:`_auto_batch_width`'s on every
route.

    python -m chsimpy_tpu_torch.experiment -R 16 --A-source sobol -N 512 \\
        --cinit 0.89 --threshold 0.89 --export-csv E2 -f uq
    # two processes (start both; --dist-backend gloo to share a card)
    python -m chsimpy_tpu_torch.experiment ... -f uq \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0
"""

from __future__ import annotations

import os

import numpy as np

from . import ensemble, material, sysinfo
from .cli import CLIParser
from .device import resolve_device
from .ensemble import EnsembleSolver
from .io import csvio
from .solution import Solution

# set in every host-pipeline worker (run_experiment_batch refuses to run
# there)
HOST_WORKER_ENV = 'CHSIMPY_TPU_TORCH_HOST_WORKER'

RESULT_COLUMNS = ('A0', 'A1', 'ca', 'cb', 'sa', 'sb', 'tau0', 't0', 'tsep',
                  'id', 'fac_A0', 'fac_A1')
INT_COLUMNS = ('tau0', 'id')          # cast to int before writing
AGG_STATS = ('count', 'mean', 'std', 'min', '25%', '50%', '75%', 'max',
             'cv')


class ExperimentParams:
    def __init__(self):
        self.runs = 2
        self.jitter_Arellow = 0.995
        self.jitter_Arelhigh = 1.005
        self.processes = -1
        self.independent = False
        self.A_source = 'uniform'
        self.A_seed = None
        self.live_view = False
        self.host_procs = -1
        self.coordinator = None
        self.num_processes = None
        self.process_id = None


class ExperimentCLIParser:
    def __init__(self):
        self.cliparser = CLIParser('chsimpy-tpu-torch (experiment)')
        parser = self.cliparser.parser
        group = parser.add_argument_group('Experiment')
        group.add_argument('-R', '--runs', default=3, type=int,
                           help='Number of Monte-Carlo runs')
        group.add_argument('-P', '--processes', default=-1, type=int,
                           help='Parallel width: members per device batch '
                                '(-1 = all at once, or two batches when '
                                'the host pipeline runs in a pool)')
        group.add_argument('--independent', action='store_true',
                           help='Independent A0, A1 runs, i.e. A0 and A1 do '
                                'not vary at the same time')
        group.add_argument('--A-source', default='uniform',
                           help="= ['uniform', 'sobol', 'grid', '<filename>']"
                                ' - Source for A0 x A1 numbers for the '
                                'Monte-Carlo runs (uniform or sobol random '
                                'numbers, evenly distributed grid points '
                                '[sqrt(runs) x sqrt(runs)], location of '
                                'text file with row-wise A0, A1 pairs)')
        group.add_argument('--A-seed', default=85972, type=int,
                           help='RNG seed for generating random A0, A1 '
                                '(if --A-source is not file-based)')
        group.add_argument('--host-procs', default=-1, type=int,
                           help='Worker processes for the per-member host '
                                'pipeline (CSV/YAML export, PNG render, '
                                'sympy post-processing), overlapped with '
                                'the device solve. -1 = one per CPU, 0/1 = '
                                'synchronous')
        group.add_argument('--coordinator', default=None,
                           help='host:port where the processes of a '
                                'multi-process experiment meet (the '
                                "'ens' mesh axis spans every process; "
                                'each runs the host pipeline of the runs '
                                'it owns)')
        group.add_argument('--num-processes', default=None, type=int,
                           help='Total process count of the distributed '
                                'experiment (with --coordinator)')
        group.add_argument('--process-id', default=None, type=int,
                           help="This process's rank in [0, "
                                '--num-processes) (with --coordinator)')
        group.add_argument('--live-view', action='store_true',
                           help='Live map of ensemble member 0, refreshed '
                                'about every --update-every steps (beyond-'
                                'reference: the reference forces no-gui in '
                                'experiments)')

    def get_parameters(self, argv=None):
        params = self.cliparser.get_parameters(argv)
        exp_params = ExperimentParams()
        args = self.cliparser.args
        parser = self.cliparser.parser
        exp_params.runs = args.runs
        exp_params.independent = args.independent
        exp_params.A_source = args.A_source
        params.no_gui = True
        params.yaml = True
        if args.export_csv is None:
            params.export_csv = 'U, E, E2, SA'
            params.compress_csv = True
        else:
            params.export_csv = args.export_csv
            params.compress_csv = args.compress_csv
        if exp_params.runs < 1:
            parser.error('ERROR: --runs must be at least 1.')
        if params.png_anim:
            parser.error('ERROR: --png-anim is not allowed.')
        exp_params.live_view = args.live_view
        if exp_params.live_view and params.update_every is None:
            parser.error('ERROR: --live-view requires --update-every.')
        exp_params.coordinator = args.coordinator
        exp_params.num_processes = args.num_processes
        exp_params.process_id = args.process_id
        if exp_params.coordinator is not None:
            if exp_params.num_processes is None \
                    or exp_params.process_id is None:
                parser.error('ERROR: --coordinator requires '
                             '--num-processes and --process-id.')
            if exp_params.live_view:
                parser.error('ERROR: --live-view is single-process only.')
            if params.checkpoint_file or params.restore_file:
                parser.error('ERROR: experiment checkpointing is '
                             'single-process only (the checkpoint header '
                             'would need a global result gather at every '
                             'save).')
            if params.file_id is None or params.file_id == 'auto':
                parser.error('ERROR: distributed experiments need an '
                             'explicit --file-id (auto ids are timestamps; '
                             'the processes would disagree).')
        exp_params.processes = args.processes
        exp_params.A_seed = args.A_seed
        exp_params.host_procs = args.host_procs
        return exp_params, params


def generate_A_factors(exp_params: ExperimentParams) -> np.ndarray:
    """(n_items, 2) matrix of multiplicative A0/A1 factors: the
    uniform/sobol/grid constructions of the JAX package (the reference's
    ``experiment.py:148-188``), the same streams."""
    lo, hi = exp_params.jitter_Arellow, exp_params.jitter_Arelhigh
    runs = exp_params.runs
    src = exp_params.A_source
    if src in ('uniform', 'sobol'):
        if src == 'sobol':
            from scipy.stats import qmc
            qrng = qmc.Sobol(d=2, seed=exp_params.A_seed)
            m = int(np.ceil(np.log2(runs))) if runs > 1 else 0
            rtemp = qrng.random_base2(m)
            rtemp = qmc.scale(rtemp, lo, hi)
            rtemp = np.transpose(rtemp[:runs])
        else:
            rng = np.random.Generator(np.random.PCG64(exp_params.A_seed))
            rtemp = rng.uniform(lo, hi, size=(runs, 2))
            rtemp = np.transpose(rtemp)
        if exp_params.independent:
            rand_values = np.ones((2 * runs, 2))
            rand_values[:runs, 0] = rtemp[0]
            rand_values[runs:, 1] = rtemp[1]
        else:
            rand_values = np.ones((runs, 2))
            rand_values[:runs, 0] = rtemp[0]
            rand_values[:runs, 1] = rtemp[1]
        return rand_values
    if src == 'grid':
        nx = int(np.floor(np.sqrt(runs)))
        exp_params.runs = nx * nx
        xvec = np.linspace(lo, hi, nx)
        if exp_params.independent:
            rand_values = np.ones((2 * nx, 2))
            rand_values[:nx, 0] = xvec
            rand_values[nx:, 1] = xvec
        else:
            pts = [[v, w] for v in xvec for w in xvec]
            rand_values = np.asarray(pts, dtype=np.float64)
        return rand_values
    raise ValueError(f"not a generated source: {src}")


def a_plan_digest(A_pairs, facs) -> str:
    """Fingerprint of the experiment's A-plan: the realized (A0, A1)
    pairs and their factor rows, stored in experiment checkpoints so that
    a resume with another plan cannot mix two UQ designs in one
    results.csv."""
    import hashlib
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(A_pairs, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(facs, dtype=np.float64).tobytes())
    return h.hexdigest()


def postprocess_member(params, sol: Solution, run_id, fac_A0, fac_A1):
    """Per-run sympy post-processing (the reference's
    ``experiment.py:110-126``): a results row."""
    cgap = material.get_miscibility_gap(params.R, params.temp, params.B,
                                        sol.A0, sol.A1)
    sa, sb = material.get_roots_of_EPP(params.R, params.temp,
                                       sol.A0, sol.A1)
    itargmax = int(np.argmax(sol.E2))
    return (sol.A0, sol.A1, cgap[0], cgap[1], sa, sb,
            sol.tau0, sol.t0, itargmax, run_id, fac_A0, fac_A1)


def export_member(params, sol: Solution, file_id: str):
    """Per-run YAML/CSV export with the reference's names."""
    fname_sol = f"{file_id}.solution"
    if params.yaml:
        sol.yaml_export_scalars(fname=fname_sol + '.yaml')
    if params.export_csv is not None:
        fext = 'csv.bz2' if params.compress_csv else 'csv'
        for member in params.export_csv.replace(' ', '').split(','):
            varray = getattr(sol, member, None)
            if varray is not None and getattr(varray, 'ndim', 0) >= 1:
                csvio.csv_export_matrix(np.asarray(varray),
                                        fname=f"{fname_sol}.{member}.{fext}")


def render_member(params, sol: Solution, file_id: str):
    """Per-run PNG render when ``--png`` is set (the reference renders every
    experiment run, ``chsimpy/experiment.py:104-109``)."""
    if not params.png:
        return
    from .simulator import render_solution_png
    render_solution_png(params, sol, f"{file_id}.png")


def _host_pool_init():
    """Worker initializer: mark the process (see :func:`run_experiment_batch`)
    and hide the cards from it, so a worker never initializes CUDA; it
    runs numpy and sympy work on host Solutions only."""
    os.environ[HOST_WORKER_ENV] = '1'
    os.environ['CUDA_VISIBLE_DEVICES'] = ''


def _host_pool_warmup():
    """No-op task that front-loads a worker's imports (torch with the
    package, sympy), so they overlap the device solve instead of following
    it."""
    from .io import yamlio  # noqa: F401
    try:
        import sympy  # noqa: F401
    except ImportError:     # runs that pass every material value
        pass


def _host_member_task(rp, sol, run_id, fac_A0, fac_A1):
    """The per-member host pipeline: export, render, then the sympy
    post-processing (the reference's pool worker,
    ``chsimpy/experiment.py:104-126``)."""
    export_member(rp, sol, rp.file_id)
    render_member(rp, sol, rp.file_id)
    return postprocess_member(rp, sol, run_id, fac_A0, fac_A1)


class HostPipeline:
    """Parallel per-member host pipeline, overlapped with the device solve.

    Submissions run in a spawn-based process pool (payloads are plain
    Parameters and Solutions whose field is a numpy array); with
    ``procs <= 1`` everything runs synchronously in-process.  ``drain()``
    blocks until every submitted member is finished and returns the result
    rows in submission order: call it before anything that must see a
    complete result set (checkpoint headers, the final aggregation)."""

    def __init__(self, procs=-1, seed_rows=()):
        self.rows = [tuple(r) for r in seed_rows]
        self._futs = []
        self._pool = None
        if procs is None or procs < 0:
            procs = os.cpu_count() or 1
        if procs > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self._pool = ProcessPoolExecutor(
                max_workers=procs, mp_context=mp.get_context('spawn'),
                initializer=_host_pool_init)
            # start and import the workers now, during the device solve;
            # a failure surfaces at the first drain
            self._warm = [self._pool.submit(_host_pool_warmup)
                          for _ in range(procs)]

    def submit(self, rp, sol, run_id, fac_A0, fac_A1, on_done=None):
        if self._pool is None:
            self.rows.append(_host_member_task(rp, sol, run_id,
                                               fac_A0, fac_A1))
            if on_done is not None:
                on_done()
            return
        fut = self._pool.submit(_host_member_task, rp, sol, run_id,
                                fac_A0, fac_A1)
        if on_done is not None:
            fut.add_done_callback(lambda _f: on_done())
        self._futs.append(fut)

    def drain(self):
        """Wait for all in-flight members; rows stay in submission order."""
        if self._pool is not None:
            for fut in self._warm:
                fut.result()
            self._warm = []
        for fut in self._futs:
            self.rows.append(fut.result())
        self._futs.clear()
        return self.rows

    def map(self, fn, items):
        """Pool-map side work (the per-member sympy kappa solves) through
        the same workers; synchronous when the pool is off."""
        items = list(items)
        if self._pool is None or len(items) < 2:
            return [fn(x) for x in items]
        return list(self._pool.map(fn, items))

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def _member_kappa_task(args):
    """One member's kappa_tilde from its (A0, A1) pair: the pool-friendly
    form of :func:`chsimpy_tpu_torch.ensemble.derive_member_constants`."""
    params, a0, a1 = args
    return ensemble.derive_member_constants(params, a0, a1)


def _member_kappas(init_params, A_sub, sink):
    """kappa_tilde per member of one batch, through the host pool; unique
    pairs are solved once."""
    if init_params.kappa_tilde is not None:
        return np.full(A_sub.shape[0], float(init_params.kappa_tilde))
    uniq = list(dict.fromkeys((float(a0), float(a1)) for a0, a1 in A_sub))
    vals = sink.map(_member_kappa_task,
                    [(init_params, a0, a1) for a0, a1 in uniq])
    table = dict(zip(uniq, vals))
    return np.array([table[(float(a0), float(a1))] for a0, a1 in A_sub])


def _auto_batch_width(nr_items, exp_params, mesh=None):
    """Device batch width when -P is auto (-1): everything at once,
    except that with the host pool on and at least 8 members the run
    splits in two, so the first batch's host work hides behind the second
    batch's solve.  Under a mesh the width maps to the 'ens' axis, so it
    stays one batch there.  The JAX package's rule, kept so that its
    experiment checkpoints (which record the width) restore here."""
    hp = getattr(exp_params, 'host_procs', -1)
    if (nr_items >= 8 and mesh is None
            and (hp is None or hp < 0 or hp > 1)):
        return (nr_items + 1) // 2
    return nr_items


def _world() -> tuple:
    """(process count, this process's index) of the experiment."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def merge_rows_across_processes(rows, nr_items):
    """Every process's result rows (each holds those of the runs it
    owns, ``run_id % P == p``) on every process, in run order: the
    counterpart of the JAX package's ``_merge_rows_across_processes``
    (the reference's pool gathers the rows into the parent,
    ``chsimpy/experiment.py:211-218``).  The rows travel as Python
    objects (``all_gather_object``), so every value comes back as it
    went: a None stays None and a NaN stays NaN (the JAX package sends
    float64 with NaN as its padding and turns a real NaN into None).
    A collective: every process calls it."""
    import torch.distributed as dist
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, [tuple(r) for r in rows])
    merged = sorted((r for part in parts for r in part), key=lambda r: r[9])
    if len(merged) != nr_items:
        raise RuntimeError(f"the processes returned {len(merged)} result "
                           f"rows for {nr_items} runs")
    return merged


def _json_rows(rows):
    """Result rows for the checkpoint header: ints (tsep, run ids) stay
    ints, so a resumed experiment's results.csv is byte-identical to an
    uninterrupted run's."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, (int, np.integer)):
            return int(v)
        return float(v)
    return [[conv(v) for v in r] for r in rows]


# the live view's preview: at most this many pixels a side
LIVE_VIEW_PIXELS = 512


def make_live_view(params):
    """The ``--live-view`` window: a shown, interactive ``MapView``."""
    from .viz.mapview import MapView
    view = MapView(params.N)
    view.prepare(show=True)
    view.imode_on()
    view.show()
    return view


def live_view_hook(view, params):
    """``on_chunk`` hook that draws member 0's field in ``view``, every
    ``ceil(N / LIVE_VIEW_PIXELS)``-th row and column taken on the card
    before the copy, so a refresh moves at most 512² values, not N²."""
    stride = -(-params.N // LIVE_VIEW_PIXELS)

    def on_chunk(ens, states):
        # member 0 in the natural layout (unfolded under fold_field)
        U0 = ens.field_layout(states.U[0])[::stride, ::stride].cpu().numpy()
        step = int(states.computed_steps[0])
        view.set_Umap(U0, params.threshold, title=f"member 0 | step {step}")
        view.draw()
    return on_chunk


def live_chunk_size(chunk_size: int, update_every: int) -> int:
    """The batch's chunk under the live view: at most ``update_every``
    steps, so the view refreshes about that often (the chunk size never
    shows in the members' bits)."""
    return max(1, min(chunk_size, update_every))


def run_experiment_batch(init_params, exp_params, A_list=None, U_init=None,
                         progress=True, mesh=None):
    """Run the full ensemble (on ``mesh``, an EnsembleMesh of the
    processes' world, or one device); returns the results rows in run
    order, every run's on every process."""
    if os.environ.get(HOST_WORKER_ENV):
        raise RuntimeError(
            "run_experiment_batch called inside a host-pipeline worker: "
            "the experiment script was re-imported by the spawn pool. "
            "Guard the script's entry point with if __name__ == "
            "'__main__' (or pass --host-procs 1 to disable the pool).")
    if A_list is None:
        rand_values = generate_A_factors(exp_params)
        A0_base = init_params.func_A0(init_params.temp)
        A1_base = init_params.func_A1(init_params.temp)
        A_pairs = np.stack([rand_values[:, 0] * A0_base,
                            rand_values[:, 1] * A1_base], axis=1)
        facs = rand_values
    else:
        # the reference caps file-sourced runs at --runs
        A_pairs = np.asarray(A_list, dtype=np.float64)[:exp_params.runs]
        facs = np.full_like(A_pairs, np.nan)

    nr_items = A_pairs.shape[0]
    plan_digest = a_plan_digest(A_pairs, facs)
    width = exp_params.processes
    if width is None or width <= 0:
        width = _auto_batch_width(nr_items, exp_params, mesh)

    pcount, pindex = _world()
    if pcount > 1:
        if init_params.checkpoint_file or init_params.restore_file:
            raise ValueError(
                'experiment checkpoint/restore is single-process only '
                '(the checkpoint header needs a global result gather at '
                'every save)')
        if getattr(exp_params, 'live_view', False):
            raise ValueError('live_view is single-process only')
        if mesh is None:
            raise ValueError(
                'multi-process experiments need a mesh of the processes '
                "(an 'ens' axis spanning every process)")

    # checkpoint/resume of the experiment itself: the per-batch ensemble
    # snapshots carry the experiment's progress (the finished rows and the
    # batch cursor) in their header, so --restore skips finished batches
    # and finishes the interrupted one in place (stopped members stay
    # stopped: preserve_stops)
    seed_rows = []
    resume_start = 0
    resumed_ens = None
    if init_params.restore_file:
        from .checkpoint import restore_ensemble
        resumed_ens = restore_ensemble(init_params.restore_file,
                                       device=init_params.device)
        extra = resumed_ens._ckpt_extra or {}
        if extra.get('kind') != 'experiment':
            raise ValueError(
                f"{init_params.restore_file} is not an experiment "
                "checkpoint (solver checkpoints resume via the "
                "single-run CLI)")
        if extra['nr_items'] != nr_items or extra['width'] != width:
            raise ValueError(
                "experiment restore needs the same run plan: the "
                f"checkpoint has {extra['nr_items']} runs / width "
                f"{extra['width']}, this command line gives "
                f"{nr_items} / {width}")
        if extra.get('A_plan') != plan_digest:
            raise ValueError(
                "experiment restore needs the same A-plan: the "
                "checkpoint's A0/A1 factor matrix differs from the one "
                "this command line generates (check --A-source, "
                "--A-seed, the jitter-Arel bounds, --independent, and "
                "the temperature/A-fits)")
        seed_rows = [tuple(r) for r in extra['results']]
        resume_start = int(extra['start'])

    live_view = getattr(exp_params, 'live_view', False)
    if init_params.png or live_view:
        # before the solve, not in the first member's render after it
        from .viz.base import require_matplotlib
        require_matplotlib()
    view = on_chunk = None
    if live_view:
        if not init_params.update_every:
            raise ValueError("live_view requires update_every (the CLI "
                             "enforces this; programmatic callers too)")
        view = make_live_view(init_params)
        on_chunk = live_view_hook(view, init_params)

    sink = HostPipeline(getattr(exp_params, 'host_procs', -1),
                        seed_rows=seed_rows)
    pbar = None
    if progress:
        try:
            # per-run ticks with a memory postfix, like the reference's
            # imap_unordered progress
            from tqdm import tqdm
            owned = len(range(pindex, nr_items, pcount))
            pbar = tqdm(total=owned, desc='ensemble runs')
        except ImportError:
            pass
    try:
        results = _run_batches(init_params, sink, A_pairs, facs, A_list,
                               U_init, nr_items, width, resume_start,
                               resumed_ens, plan_digest, pbar, on_chunk,
                               mesh)
    finally:
        sink.close()
        if pbar is not None:
            pbar.close()
        if view is not None:
            view.finish()
    if pcount > 1:
        results = merge_rows_across_processes(results, nr_items)
    return results


def _run_batches(init_params, sink, A_pairs, facs, A_list, U_init,
                 nr_items, width, resume_start, resumed_ens, plan_digest,
                 pbar, on_chunk=None, mesh=None):
    """The batch loop of :func:`run_experiment_batch`: solve each batch,
    hand every finished member this process owns to the host pipeline
    ``sink``.  With the live view's ``on_chunk`` the chunk shrinks to
    ``update_every`` and the checkpoint hook calls it first."""
    pcount, pindex = _world()
    file_id = init_params.file_id
    ckpt_file = init_params.checkpoint_file
    ckpt_every = init_params.checkpoint_every
    for start in range(0, nr_items, width):
        stop = min(start + width, nr_items)
        if start + width <= resume_start:
            # finished before the checkpoint: rows recovered from the
            # header, per-run files already on disk
            if pbar is not None:
                pbar.update(stop - start)
            continue

        hook = on_chunk
        if ckpt_file and ckpt_every:
            last_saved = [0]

            def hook(ens_, states, _start=start, _prev=on_chunk,
                     _last=last_saved):
                if _prev is not None:
                    _prev(ens_, states)
                c = int(states.computed_steps.max())
                if c - _last[0] >= ckpt_every:
                    from .checkpoint import save_ensemble_checkpoint
                    # the header carries the COMPLETE rows of the batches
                    # before _start: wait out their host pipelines
                    save_ensemble_checkpoint(
                        ckpt_file, ens_, extra_header={
                            'kind': 'experiment',
                            'nr_items': nr_items, 'width': width,
                            'A_plan': plan_digest, 'start': _start,
                            'results': _json_rows(sink.drain())})
                    _last[0] = c

        if start == resume_start and resumed_ens is not None:
            # finish the interrupted batch in place
            ens = resumed_ens
            if on_chunk is not None:
                ens.chunk_size = live_chunk_size(ens.chunk_size,
                                                 init_params.update_every)
            c0 = int(ens._states.computed_steps.max())
            remaining = max(init_params.ntmax - c0, 0)
            sols = ens.solve_or_resume(remaining, on_chunk=hook,
                                       preserve_stops=True)
        else:
            kappas = _member_kappas(init_params, A_pairs[start:stop], sink)
            ens = EnsembleSolver(init_params.deepcopy(), A_pairs[start:stop],
                                 U_init=U_init, kappas=kappas, mesh=mesh)
            if on_chunk is not None:
                # refresh the view about every --update-every steps
                ens.chunk_size = live_chunk_size(ens.chunk_size,
                                                 init_params.update_every)
            ens.prepare()
            sols = ens.solve_or_resume(init_params.ntmax, on_chunk=hook)
        on_done = None
        if pbar is not None:
            def on_done():
                pbar.set_postfix({'Mem': sysinfo.get_mem_usage_all()},
                                 refresh=False)
                pbar.update(1)
        for i, sol in enumerate(sols):
            run_id = start + i
            if run_id % pcount != pindex:
                # another process owns this member's host pipeline (its
                # row arrives in the merge)
                continue
            rp = init_params.deepcopy()
            rp.file_id = f"{file_id}-run{run_id}"
            fac0 = None if A_list is not None else facs[run_id, 0]
            fac1 = None if A_list is not None else facs[run_id, 1]
            # the worker gets the field as a host array, never a card
            # tensor; its export and sympy work overlap the next batch
            sol.U = sol.U.cpu().numpy()
            sink.submit(rp, sol, run_id, fac0, fac1, on_done=on_done)
        # free the batch's fields on the card before the next batch's
        del ens, sols
    return sink.drain()


# ----------------------------------------------------------------------
# the results and the aggregate: pandas' DataFrame(rows).to_csv() and
# describe() + cv, on numpy
# ----------------------------------------------------------------------

def _columns(results) -> dict:
    """Column name -> (kind, values) as pandas' DataFrame of the rows
    holds it: 'none' for a column of None only (object, written empty),
    'int' for Python or numpy ints, else 'float' (None as NaN); tau0 and
    id cast to int."""
    cols = {}
    for k, name in enumerate(RESULT_COLUMNS):
        vals = [r[k] for r in results]
        if all(v is None for v in vals):
            cols[name] = ('none', None)
        elif name in INT_COLUMNS:
            cols[name] = ('int', np.array([int(v) for v in vals],
                                          dtype=np.int64))
        elif all(isinstance(v, (int, np.integer))
                 and not isinstance(v, bool) for v in vals):
            cols[name] = ('int', np.array(vals, dtype=np.int64))
        else:
            cols[name] = ('float', np.array(
                [np.nan if v is None else float(v) for v in vals],
                dtype=np.float64))
    return cols


def _cells(values) -> np.ndarray:
    """The cells ``to_csv`` writes for a numeric column: numpy's str of
    each element, NaN empty."""
    cells = values.astype(str)
    if values.dtype.kind == 'f':
        cells[np.isnan(values)] = ''
    return cells


def results_csv_text(results) -> str:
    """``<id>-results.csv``: the index, then RESULT_COLUMNS."""
    cols = _columns(results)
    n = len(results)
    cells = [_cells(v) if kind != 'none' else np.full(n, '', dtype=object)
             for kind, v in cols.values()]
    lines = [',' + ','.join(RESULT_COLUMNS)]
    lines += [','.join([str(i)] + [c[i] for c in cells]) for i in range(n)]
    return '\n'.join(lines) + '\n'


def _describe(values) -> list:
    """pandas' describe() of a numeric column plus cv, as float64s:
    count, mean (float64 sum over count), std (ddof 1, from the squared
    deviations from that mean), min, the linear 25/50/75% percentiles,
    max, std/mean."""
    v = values[~np.isnan(values)] if values.dtype.kind == 'f' else values
    count = v.shape[0]
    f = v.astype(np.float64)
    # pandas' quiet NaN for one row (std) and a zero mean (cv)
    with np.errstate(invalid='ignore', divide='ignore'):
        mean = f.sum(dtype=np.float64) / count
        std = np.sqrt(((mean - f) ** 2).sum(dtype=np.float64)
                      / (count - 1))
        q = np.percentile(v, [25.0, 50.0, 75.0])
        out = [np.float64(x) for x in (count, mean, std, v.min(), q[0],
                                       q[1], q[2], v.max())]
        return out + [out[2] / out[1]]


def aggregate(results) -> dict:
    """Column name -> its AGG_STATS values, for every numeric column but
    id (pandas' describe() skips the object ones)."""
    return {name: _describe(v)
            for name, (kind, v) in _columns(results).items()
            if kind != 'none' and name != 'id'}


def agg_csv_text(agg: dict) -> str:
    """``<id>-results-agg.csv``: the transposed describe() + cv table."""
    lines = [',' + ','.join(AGG_STATS)]
    lines += [','.join([name] + list(_cells(np.array(stats))))
              for name, stats in agg.items()]
    return '\n'.join(lines) + '\n'


def aggregate_results(results, file_id):
    """Write ``<id>-results.csv`` and ``<id>-results-agg.csv`` (the
    reference's ``experiment.py:218-229``); returns the aggregate."""
    csvio.csv_export_list(f"{file_id}-results.csv",
                          results_csv_text(results))
    agg = aggregate(results)
    csvio.csv_export_list(f"{file_id}-results-agg.csv", agg_csv_text(agg))
    return agg


def _distributed_mesh(exp_params, init_params):
    """Join the processes' world (``--coordinator``, or a ``torchrun``
    launch) and return the ('ens', 'x', 'y') mesh the batches run on: the
    'ens' axis spans every process, ``--mesh`` (if given) carves a
    per-member ('x', 'y') grid out of each member's share (the JAX
    package's ``_distributed_mesh``, ``experiment.py:719-739``)."""
    import torch

    from .parallel import distributed
    from .parallel.mesh import EnsembleMesh
    topo = distributed.initialize(
        init_params.dist_backend, init_params.device,
        coordinator_address=exp_params.coordinator,
        num_processes=exp_params.num_processes,
        process_id=exp_params.process_id)
    grid = tuple(init_params.mesh_shape or (1, 1))
    n_grid = grid[0] * grid[1]
    n_dev = topo['global_devices']
    if n_dev % n_grid:
        raise ValueError(f"--mesh {grid} does not divide the "
                         f"{n_dev} processes")
    dev = torch.device(init_params.device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    return EnsembleMesh(n_dev // n_grid, grid, dev)


def main(argv=None):
    import threading

    # scipy.stats costs ~2 s of import (the sobol A-source needs qmc):
    # start it on a daemon thread, overlapped with parsing
    threading.Thread(target=lambda: __import__('scipy.stats'),
                     daemon=True).start()
    exp_cliparser = ExperimentCLIParser()
    exp_cliparser.cliparser.print_info()
    exp_params, init_params = exp_cliparser.get_parameters(argv)
    resolve_device(init_params.device)
    mesh = None
    if exp_params.coordinator is not None \
            or init_params.mesh_shape is not None:
        mesh = _distributed_mesh(exp_params, init_params)
    try:
        _main(exp_params, init_params, mesh)
    finally:
        if mesh is not None:
            from .parallel import distributed
            distributed.shutdown()


def _main(exp_params, init_params, mesh):
    is_primary = _world()[1] == 0
    if is_primary:
        print(str(init_params).replace(", '", "\n '"))

    if init_params.file_id is None or init_params.file_id == 'auto':
        init_params.file_id = sysinfo.get_or_create_file_id(
            init_params.file_id)
    info = (sysinfo.get_system_info()
            + sysinfo.get_device_info(init_params.device))

    U_init = None
    if init_params.Uinit_file is not None:
        U_init = csvio.csv_import_matrix(init_params.Uinit_file)

    A_list = None
    if exp_params.A_source not in ('uniform', 'sobol', 'grid'):
        A_list = csvio.csv_import_matrix(exp_params.A_source)

    if is_primary:
        csvio.csv_export_list(
            f"{init_params.file_id}-metadata.csv",
            "\n".join(info + sysinfo.vars_to_list(exp_params)))

    results = run_experiment_batch(init_params, exp_params, A_list=A_list,
                                   U_init=U_init, progress=is_primary,
                                   mesh=mesh)
    if not is_primary:
        # every process holds the merged rows; one writes the tables
        return
    agg = aggregate_results(results, init_params.file_id)
    print(agg_csv_text(agg), end='')
    print('Output files:')
    print(f"  {init_params.file_id}-metadata.csv")
    print(f"  {init_params.file_id}-results-agg.csv")
    print(f"  {init_params.file_id}-results.csv")
    print(f"  {{{init_params.file_id}-run***.solution.yaml}}")
    print(f"  {{{init_params.file_id}-run***.solution.*.(csv|bz2)}}")
    if init_params.png:
        print(f"  {{{init_params.file_id}-run***.png}}")


if __name__ == '__main__':
    main()
