#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chsimpy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the root of a checkout, one card
    python3 chip_smoke.py --out DIR   # also write the details to DIR

Phases (each raises on failure, so the script exits nonzero):

1. the card's name and power limit (nvidia-smi); CUDA must be available;
2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the time;
3. each kernel against its plain PyTorch version on the card, float32 and
   float64, at N = 4096, 1000, 1001 (no vector width divides it) and 512,
   with the tolerances stated below; the statistics kernel K3 also gives
   the same bits in 30 calls; both versions timed (``device_ms``: the
   device time of one call in a run of back-to-back calls; ``call_ms``:
   one call alone between two CUDA events, the wrapper's host time
   included); K3 also timed on the fixed tile in turns with its tile
   where the two differ (``design_turns``, ``kernels.fixed_stats_tile``),
   K4 beside ``torch.dist(U, mean, p=1)``; (b) K3 at N=1024 and 2048
   likewise, at 2048 the fixed tile's bits; in (a) and (b) the
   statistics kernel's body against its parent body (``prev=True``: the
   true divisions, the edges decided per element) on the same tile: the
   five sums to the bit, timed in turns (``body_turns``; so are K7 in
   phase 8 (a), K3_members in 10 (a), K7_members in 14 (a) and the fold
   in 16 (a)); (c) the body's division by h and 2h (``cdiv``) against
   the true division for the fields' delx at N = 512-4096: float32 on
   every finite float, float64 on 2e9 draws and the edges, no bit may
   differ;
4. the canonical default run (N=512, float64, uniform, seed 2023) through
   ``Simulator.solve``: it must stop at step 1674 and hold the golden
   anchors of tests/golden/default_n512_anchors.json; the kernel launch
   counts of this run are the ones reported;
5. the CLI at N=4096 float32 (``python -m chsimpy_tpu_torch``), then the
   same configuration through the API in float32 (256 steps) and float64
   (64 steps): the float32 E trace within 1e-5 of float64, mean(U) held,
   every kernel launched on every step; steps/s of steady windows and the
   per-layer times of one step;
6. the float64 ozaki route (``transform_backend='ozaki'``):
   (a) the slice kernel against its plain version at N = 4096, 1000 and
   512, 4, 6 and 8 slices, three field classes and a field whose max|x|
   lies one ulp above a power of two (the scale's log2/ceil formula, not
   frexp's exponent): the same slices to the bit, the same scale and one
   count a call, both timed, and each of the kernel's two launches (the
   max pass that writes the scale, the slice pass) timed alone; a field
   with a NaN (a NaN scale, the same bits); where the field takes the
   one-launch path (N=512), its bits = the two launches' and both timed
   in turns;
   (b) the canonical run through ``Simulator.solve`` on the level-1 fold
   route: stop at 1674 with the golden anchors, and the slice kernel
   launched exactly as often as the route implies, every call by its
   one-launch path (the slice kernel's count in the JSON line comes from
   this run);
   (c) the tests/golden/n1024_uniform_stop.json run on the rfold route:
   stop 1837, E within 1e-10 at every step;
   (d) N=4096 (rfold, two levels): E over 64 steps within 1e-10 of the
   native float64 matmul route from the same field, steady steps/s of
   both routes in turns, and the per-layer times of one ozaki step;
7. the split and FFT routes and the DCT bake-off with the GEMM kernel:
   (a) the GEMM kernel (3xTF32 on the tensor cores) against its plain
   version (``torch.matmul``, TF32 off) at 4096², 1000², 512² and a
   ragged non-square shape, float32, in all four operand layouts (each
   operand row-major or a ``.T`` view), both held against the float64
   product of the same operands (the kernel's error at most 4x the plain
   version's and 1e-5 max|ref|), both timed with TFLOP/s; ``dct2_gemm``
   and ``idct2_gemm``
   against the matmul route's ``dct2``/``idct2`` at N=4096 by the same
   bounds; a float64 input raises;
   (b) the bake-off through its own functions (``benchmarks/dct_bench.py``,
   a short ``inner``) at N=4096 float32 and N=2048 float64: every route
   gives a time and a round-trip error within its arithmetic's bound
   (``ROUNDTRIP_BOUND``), and the GEMM kernel is launched 4 times per
   round trip of the ``gemm`` route (its count in the JSON line comes from
   this run);
   (c) the canonical run on ``--transform split`` and ``--transform fft``:
   stop at 1674, the step the JAX package gives on the CPU for both, with
   the golden anchors;
   (d) N=4096 float32 ``full_sim`` on split (levels 4) and fft: E over 64
   steps within 1e-5 of phase 5's float64 run, mean(U) held, steady
   steps/s in turns with the matmul route, and the per-layer times of one
   step (transforms, their products or FFTs, and the folds around them);
   (e) the stop goldens tests/golden/n1024_uniform_stop.json (stop 1837)
   and n2048_uniform_stop.json (2040) on the matmul, split and fft routes
   (exact stop step, E within 1e-10 at every step), and n1024_lcg_60 on
   matmul (E within 1e-12);
8. the grid-sharded solve (``--mesh``, the matmul route over ranks of a
   ``torch.distributed`` world):
   (a) the shard-local statistics kernel K7 against its plain version on
   every block of 2x2, 1x4 and 4x1 meshes of N=4096 and N=512 fields,
   float32 and float64, with halos from the neighbour blocks (K3's
   tolerances), and the blocks' sums in rank order against K3 on the whole
   field (1e-13 relative in float64, 1e-12 in float32: only the float64
   summation order differs); K7 on the whole field as one block (offsets
   0, edge-replicated halos) gives K3's sums to the bit; K7 gives the same
   bits in 30 calls on a 2x2 block; a block whose W no vector width
   divides and a block with an unaligned halo row (K7's one-column path)
   against the plain version; K7 and its plain version timed on a 2x2
   block beside the bound;
   (b) K8 on a block against K1 on the same block: the same bits;
   (c) a 2x2 world of 4 ranks on the card (gloo, collectives staged
   through host memory, as the mesh prints) running the canonical run
   through the Solver (entered to step 1601 in chunks of 200, saving
   every 800 steps: the checkpoint phase 14 (e) restores; then again to
   the stop): stop 1674 with the golden anchors, E within 1e-10 of the
   single-device run at every step, the same rows on every rank, K7 and
   K8 launched once per step iteration per rank (K7 once more for
   prepare; the JSON line's counts are rank 0's);
   (d) the same run through ``torchrun`` and the CLI: rank 0 prints the
   stop line (1674, energy), K7 and K8 launched on every step;
   (e) N=4096 float32 ``full_sim`` over 64 steps in the same world: E
   within 1e-5 of phase 5's float64 run and 1e-6 of its single-device
   float32 run, mean(U) held, and steps/s of a 64-step window (4 ranks
   sharing one card with host-staged collectives: not a scaling figure);
   the same world also runs phase 9 (d);
   (f) with one card per rank, (c) and (e) again on NCCL; otherwise a line
   saying why it did not run;
9. adaptive time stepping, per-step jitter, the sobol and simplex
   generators, the Sobol jitter kernel K9 and the threefry jitter kernel
   K10:
   (a) K9 against its plain version, to the bit, at N = 4096, 1000 and
   512, float32 and float64, at draw bases 0, N and N/2 below 2^32 (the
   walk wraps), on the field and on a 2x2 mesh's (1, 1) block; both timed;
   K10 against its plain version, to the bit (the field, the next key),
   at N = 4096, 1000, 1001 and 512, float32 and float64, on the field and
   on a 2x2 mesh's (1, 1) block, its values at steps 1 and 2 of seed 2023
   against jax.random's (K10_LITERALS), both timed at N=4096 beside a
   bound taken at the INT32 rate (132 SMs x 64 lanes x 1.98 GHz);
   (b) the seven item 7 goldens (N=64, float64: n64_sobol_100, the three
   adaptive ones, the uniform, sobol and simplex jitter), n64_adaptive_600
   also on split, fft and ozaki (untrimmed forward pairs), with the
   tolerances of tests/test_golden.py and tests/test_golden_extra.py, and
   the device Sobol jitter's U and rows equal to the host stream's;
   (c) N=4096 float32 ``full_sim`` on matmul: steps/s over steps 513-768
   with -a (delt_max ITEM7_DELT_MAX; the column sum at step 501 recorded),
   with the device Sobol jitter (K9 on every step) and with the device
   uniform jitter (K10 on every step), beside phase 5's fixed-delt rate;
   delt moved after step 500 only and mean(U) held under -a; the layer
   times of one step (adaptive delt, coefficient rebuild, jitter);
   (d) in phase 8's 2x2 world: -a over 520 steps (N=32) and the device
   Sobol jitter over 100, against one device: delt within 1e-9, E within
   1e-10, the same rows on every rank;
10. the member-batched ensemble (``EnsembleSolver``: K1-K4 launched once a
   step for R members), checkpoints and the CLI's exports:
   (a) each batched kernel against its plain version (phase 3's
   tolerances) and member by member against the single-field launch on
   the member's field with its scalars (the same bits), at R=16 N=512
   float64 and float32 and R=4 N=4096 float32 and float64, one count a
   call; device ms of the batched launch and of R single launches, the
   plain version's, and the bound; K3_members also on the fixed tile, in
   turns with its tile; K4_members as the step runs it, with each
   member's Ra (K11's body) in its second pass: its sums and Ra the bits
   of K4_members and K11 launched apart, timed in turns with them;
   (b) the canonical UQ batch (R=16, N=512 float64, the JAX experiment's
   A factors from seed 85972, each member's kappa passed as ``kappas=``):
   every member's stop step equals the port's single run of the member on
   the card, E within 1e-10 at every row; member-steps/s beside the single
   runs' steps/s; the batched kernels' counts in the JSON line come from
   this run;
   (c) R=4 N=4096 float32 ``full_sim`` over 128 steps on matmul, split and
   fft: member-steps/s after a 16-step warm-up beside the single runs',
   mean(U) held to 1e-6, each member's E within 1e-6 of its single run
   at every row and U within 1e-5 (the float32 class);
   (d) the canonical run through the CLI to step 1025 (its
   --checkpoint-every 1024 save), then --restore: it stops at 1674, its
   rows are those of the in-memory run that re-enters the solve at 1025
   to the bit and within 1e-10 of phase 4's uninterrupted run; an
   ensemble saved mid-batch and restored ends bit-equal; a run with the
   device jitter resumes its threefry stream (the key in the file) to the
   bit;
   (e) the restored CLI run also exports U, E and E2 as bz2 CSV and the
   solution's YAML: read back, they equal the solution;
11. the UQ experiment (``experiment.main``, in-process, the member-batched
   K1-K4 on the card; the port's three sympy solves replaced by lookups in
   SOBOL_MATERIAL, since the card's machine has no sympy):
   (a) the paper's design (R=16 sobol, A-seed 85972, N=512, cinit =
   threshold = 0.89) in float64: A0, A1, the factors, ca, cb, sa, sb,
   tau0, tsep and id equal to the bit, t0 within 1e-12, of the JAX
   package's on-chip float64 run (artifacts/r5/uq_f64/tpu64-*); tau0 and
   tsep equal the reference's run (artifacts/r4/uq/ref-results.csv);
   results-agg.csv byte-equal in every row whose inputs are bit-equal;
   each member's E2 at every row within 1e-10 plus tpu64's own distance
   from the JAX package's CPU float64 run (TPU64_E2_OWN_REL: the TPU's
   float64 E2 lies up to ~1e-9 from it) of tpu64-run*.solution.E2.csv,
   its YAML scalars equal (t0 to 1e-12); the batched kernels'
   counts (read on this run); wall, solve and host-pipeline seconds and
   member-steps/s;
   (b) the same design in float32: tau0, t0 and tsep within 6e-3 of the
   reference's run per member, their means within 3e-3.
12. the float64 ozaki route under the ensemble (K5_members: K5 with a
   member axis, one launch a pass for all members), the experiment's
   ``--transform ozaki`` and the ozaki profile:
   (a) K5_members against its plain version and, member by member,
   against the single K5 launch on the member's field (planes and scales
   to the bit, one count a call) at R=16 N=512, R=4 N=4096, R=3 N=1001
   (the scalar path, members off the vector alignment) and R=2 N=1000,
   4 and 6 slices, a member 1000x smaller than the rest and an all-zero
   one, and a member with a NaN at R=16 N=512 and R=3 N=1001 (its scale
   NaN, its bits); the one-launch path where the shape takes it (the
   planes and scales the two launches' bits); device ms of the batched
   call (in turns with the two launches), of R single launches, of the
   copy of its planes into the products' layout and of the plain
   version, and the bound;
   (b) the canonical UQ batch of phase 10 (b) on the ozaki route (level-1
   fold) to every stop, then all 16 single ozaki runs to their stops
   (threads side by side, each run replaying its steps as a CUDA graph
   on a stream of its own, ``_graph_solver``): every member's
   stop step equals its single ozaki run's, E within 1e-10 at every row,
   and its rows (Ra, a batched row mean, within 1e-12) and final U equal
   the single run's to the bit; the stops equal phase 10 (b)'s matmul
   batch's; member-steps/s beside that matmul batch's; K5_members
   launched as often as the route implies, every call by its one-launch
   path, the single-field K5 never (the JSON line's K5_members count
   comes from this run);
   (c) R=4 N=4096 float64 ``full_sim`` over 64 steps on ozaki (rfold,
   two levels) beside matmul: member-steps/s after a 16-step warm-up, E
   within 1e-10 of the matmul members at every row, mean(U) held, the
   peak memory of each batch;
   (d) phase 11 (a) with ``--transform ozaki``: the same checks and
   bounds (tau0 and tsep equal tpu64's and the reference's, t0 within
   1e-12, E2 within 1e-10 plus TPU64_E2_OWN_REL), K5_members on its
   path; wall, solve and host-pipeline seconds;
   (e) ``benchmarks/ozaki_profile.py`` at N=4096: ms of the prefixes
   P1-P4 (slice, + stage-1 products, + renorm, the full forward);
13. the live loop of the views (``Simulator``'s chunked solve, the
   experiment's live view), with a stand-in view class patched over
   ``viz.plotview.PlotView`` and ``viz.mapview.MapView`` (the card's
   machine has no matplotlib; it records each refresh's host arrays and
   titles and writes a small file in ``render_to``):
   (a) the canonical run through ``Simulator.solve`` with ``png``,
   ``no_gui`` and ``update_every=100``: stop at 1674 with the golden
   anchors, its rows and U equal to the bit to a Solver resumed at the
   same 100-step boundaries, one refresh per chunk (17), one host copy of
   U per refresh shared by the panels, one ``render_to``; K1-K4 launched
   on every step of it;
   (b) N=4096 float32 matmul ``full_sim`` after 256 warm-up steps: steps/s
   of 1024 steps as one ``solve_or_resume`` and through the live loop
   with a refresh every 256 steps, in turns (live, straight, live), and
   the host time of one ``push_solution_view`` (its one copy of U);
   (c) the canonical R=16 batch of phase 10 (b) with the experiment's
   live-view hook and chunk (``update_every`` 100) beside the batch at
   chunk 1024: every member's stop, rows and final U to the bit, the
   member-0 previews 512² host arrays, member-steps/s and step
   iterations of both, the batched kernels launched once a step
   iteration;
   (d) ``python -m chsimpy_tpu_torch -N 64 -n 10 --png`` in a subprocess
   (started first, read after (a)): without matplotlib it exits nonzero
   with an error naming matplotlib and --no-gui and writes no PNG; with
   matplotlib it says so and must write the PNG.
14. the distributed ensemble, the checkpoint under ``--mesh`` and the
   multi-process experiment; the worlds' ranks share the one card, so
   they take the gloo backend (collectives staged through host memory;
   no scaling figure):
   (a) K7_members (``local_band_sums_members``: K7 with a member axis)
   against its plain version (K3's tolerances, the count exact) and,
   member by member, against the single K7 launch on the member's block,
   halo and scalars (the same bits), R=4 on block (1, 0) of a 2x2 mesh
   of N=512 float64 and N=4096 float32 and float64 fields; device ms
   beside the 4 single launches and, in turns, beside the fixed tile,
   the plain version's and the bound; K11
   (``row_absdev_members``, each member's Ra, no Pallas counterpart)
   against its plain version (1e-12 / 1e-5) and member by member against
   its launch on the member alone (the same bits), R=16 N=512 float64
   and R=4 N=4096 float32 and float64; K4_members with Ra on (c)'s
   blocks and gathered mid rows against K4_members and K11, in turns;
   (b) the canonical UQ batch of phase 10 (b) on an 'ens' world of 2
   ranks (``EnsembleMesh(2)``): every member's rows, U, stop, tau0 and
   t0 equal phase 10 (b)'s batch from this call, to the bit, on both
   ranks; member-steps/s; the world's ensemble checkpoint restores on one
   device with its bits, and both re-enter for 100 steps with the same
   bits;
   (c) a grid ensemble on a (1, 2, 2) world of 4 ranks: R=4 N=512
   float64 over 256 steps, E within 1e-10 of one device's batch, the
   rows the same on every rank (K7_members on every step: the JSON
   line's count); R=4 N=4096 float32 ``full_sim`` over 32 steps, E
   within 1e-6 of one device's batch, each member's mean(U) within 1e-6
   of its start, ms per step iteration and peak memory per rank;
   (d) phase 11 (a)'s float64 design as two processes of the experiment
   (``--coordinator``, each ``python3 chip_smoke.py --uq-process`` with
   the experiment's arguments: ``experiment.main`` with the material
   table), each in its own directory: results.csv and results-agg.csv the
   bytes of phase 11 (a)'s run, the same per-run files, process 0 alone
   writing the tables, each process the runs it owns; wall seconds;
   (e) phase 8 (c)'s checkpoint (the canonical run on a 2x2 world
   saving every 800 steps in chunks of 200: the file at step 1601, which
   that run re-enters) restored on (c)'s world, a new 2x2 world: stop
   1674, phase 8 (c)'s rows to the bit, E within 1e-10 of phase 4's run;
   in a full run (c) and (e) run in phase 15's world, whose shape is
   (c)'s, and are checked there (``--phase 14`` gives them a world of
   their own).
15. the pencil layout (``--transform split`` and ``ozaki`` under
   ``--mesh``: the field in column blocks, the spectral image in row
   blocks, one transpose all-to-all per 2-D transform), in one world of 4
   gloo ranks sharing the card (collectives staged through host memory:
   no scaling figure):
   (a) K5 sharded (``slice_field_sharded``, ``slice_field_members_sharded``:
   the max pass's max-only mode, a world max of its bits, the slice pass's
   sharded mode, which forms the scale from it) on the column and row
   blocks of
   N=4096 and N=1000 float64 fields, the max in one block only and one ulp
   above 2^8 in one block only, and on members' blocks: every rank's
   planes are K5's on the whole field restricted to its block and its
   plain version's at the world's max, to the bit, the scale the same on
   every rank, one count a call; timed on a (4096, 1024) block and on R=4
   members' (512, 128) blocks (its world max left out), each launch alone,
   four block calls beside one whole-field K5, the plain version, the
   bound; K7 on every (N, N/4) column block (halos left and right), K8
   against K1 on the block (the same bits), K2 on a (N/4, N) row block and
   K4 on the column block with the field's mean against their plain
   versions, N=4096 and N=64 (W=16), float32 and float64;
   (b) the canonical run on split (entered to step 1601 in chunks of 32,
   saving there, then to the stop) and its first 640 steps on ozaki
   through the Solver on a 2x2 mesh of the world: stop 1674 with the
   golden anchors (ozaki: those of its steps), E within 1e-10 of one
   device's run of the route at every step (phase 7 (c), phase 6 (b)),
   the same rows on every rank, K8, K2 and K7 once a step iteration (K7
   once more for prepare), K5 sharded once per transform on ozaki (the
   JSON line's count) and never the single K5;
   (c) N=4096 float32 ``full_sim`` on split over 64 steps: E within 1e-5
   of phase 5's float64 run and 1e-6 of phase 7 (d)'s one-device split
   run, mean(U) held, ms a step and peak GB a rank; the audit's bytes a
   step and rank on split beside the grid matmul route's at the same N
   (``parallel/audit.py``);
   (d) N=4096 float64 ozaki over 32 steps: E within 1e-10 of phase 5's
   float64 matmul run, ms a step, peak GB a rank, the audit's bytes;
   (e) the grid ensemble on the world's (1, 2, 2) mesh, R=4 (the first
   four canonical pairs) N=512 float64 over 256 steps on split and ozaki:
   every member's E within 1e-10 of one device's batch, the rows the same
   on every rank, K5_members sharded once per transform on ozaki (the
   JSON line's count);
   (f) (b)'s split file (step 1601) restored on a 1x4 mesh of the world's
   ranks: stop 1674, the re-entered run's rows to the bit;
   the grid layout where 4 does not divide N, in the same world:
   (g) K7, K8, K2 and K4 on every block of grids whose block sides are
   no multiple of 8 (2047, 501, 20, 18 x 9, 17) against their plain
   versions, K7 and K8 timed on 2047 and 501 blocks; N=4094 float32
   matmul over 32 steps: E within 1e-6 of one device's run from the same
   field;
   (h) N=4094 float64 ozaki (the grid ozaki route) over 32 steps: E
   within 1e-10 of one device's float64 matmul run at every step, the
   same rows on every rank, K5 sharded twice a step iteration (the JSON
   line's count), ms a step and peak GB a rank, the audit's bytes;
   (i) N=1002 float64 ozaki with the forward pairs (5, 7) over 256 steps:
   E within 1e-10 of one device's ozaki run with the same pairs;
   (j) K5 sharded on every block of the 2x2 grid at N=4094 and N=1002 =
   K5 on the whole field restricted to the block, to the bit, and timed
   on a block (the JSON line's row), each launch alone, the forward's
   column strip at a given max;
   (k) ``benchmarks/scaling.py`` on the world, ``--axis grid`` and
   ``ens`` at N=1024 float32 over 64 steps: its JSON line and keys;
   (l) ``benchmarks/rank_profile.py``: rank 0's ``torch.profiler`` trace
   of 4 more step iterations of (h)'s grid ozaki run and (c)'s pencil
   split run: the top device operations and the host's gaps by what the
   host was doing;
   with one card per rank, (b) and (c) again on NCCL; otherwise a line
   saying why it did not run.
16. the float32 knobs: the product precisions (``highest``:
   cuBLAS FP32, ``high``: 3xTF32 by the GEMM kernel K6, ``default``: one
   TF32 pass), ``--fwd-matmul-precision``, ``--inv-band``,
   ``--otf-coeffs`` (kernel K12), ``--fold-field`` (K3's fold mode), and
   ``transform='auto'``:
   (a) K12 and K12_members against their plain versions to the bit at
   N = 4096, 1000, 1001, 512, float32 and float64, R = 4 and 16, each
   member against K12 on the member, on a 2x2 block against the whole
   field's block; K3's fold mode on the folded field against its plain
   version (K3's tolerances, the count exact) and against K3 on the
   natural field (the same bits where the fold keeps K3's vector width),
   single and R=4 members, at N = 4096, 1000, 1002, 512, timed at N=4096
   in turns with K3 on the natural field; K6 on every
   product shape of a solve at 'high' (N=4096 matmul, split levels 4,
   folded levels 5; R=4 N=512 ensembles), held as in 7 (a), a member
   stack member by member against K6 on the member; each timed at N=4096
   (K6 at its largest solve shape, beside cuBLAS FP32) beside its bound;
   (b) in 4 worker processes side by side (in a full run started beside
   phase 6 (b) and (c), and waited for before 6 (d)): the canonical
   float32 run and the N=1024 and N=2048 float32 stops on matmul at
   'high', fft and split at its default precision (N >= 1024), and
   split with the 1-pass forward,
   --inv-band N/4 (N >= 1024), --otf-coeffs 1, --fold-field and all of
   them: each stop within its band of PERFORMANCE.md:254 (the 1-pass
   forward: the E class only), E within 1e-5 of float64 at every step,
   the path's kernels launched on every step; the float64 canonical run
   with --otf-coeffs 1 (stop 1674, the anchors); as jobs of their own: an R=4
   ensemble with K12_members, K3_members' fold mode and K6 (64 steps,
   each member within 1e-6 of its single run), the folded runs' U, E, E2
   and Ra = the natural runs' at pinned levels (N=4096 float32 levels 4
   and 5; N=512 with -a and the host jitter, and the device jitter), and
   N=4096 float32 over 256 steps within 1e-5 of float64 on matmul at
   'high' and on split with what its auto gates take there;
   (c) steps/s at N=4096 float32 in turns: matmul at 'highest' and
   'high', split at 'high' alone and with each knob and all of them,
   fft, -a with and without --otf-coeffs 1;
   (d) steps/s of every route at N = 512, 1024, 2048, 4096, float32 (at
   both precisions) and float64 (the float64 runs of phases 4, 6 and 7
   where they exist), float64 fft at N=4096 within 1e-10 of matmul; at
   each (N, precision) the route ``core/solver.py`` ``AUTO_ROUTES`` picks
   must run at least AUTO_MARGIN (0.85) of the fastest route's steps/s.
   Phase 3's kernel window is bracketed by nvidia-smi's SM clock,
   temperature and power draw.

The kernels' rows carry ``bound_ms``, the least time the card could take
for the same work (bytes at 3.35 TB/s or operations at the peak rate of
their type, whichever is larger), and ``library_ms`` where one PyTorch call
computes the same function.  The last two lines of standard output are
the kernels' JSON summary and ``{"ok": true, "device": {...}}``
(``count``: the cards the script used); with ``--out DIR`` every
measurement also goes to DIR/chip_smoke.json.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 and the kernel parts of 6-15 ((a); (a)-(b) of 8; K9
and K10 of 9; (a) of 10, 12 and 14; 15 (a) but its world) only (phase 13
has no kernel of its own),
and prints the kernels' table instead of the two last lines.

    python3 chip_smoke.py --phase 14

runs phase 14 alone after the build, with what it is held to (phase 4's
canonical run, phase 8 (c)'s world run, phase 10 (b)'s batch without its
single runs, phase 11 (a)'s float64 experiment and its checks), and
prints no closing lines; ``--phase 15`` does the same for phase 15 (one
device's canonical runs on split and ozaki, N=4096 float64 matmul and
float32 split over 64 steps), ``--phase 16`` for phase 16 (phase 4's
run and N=4096 float64 over 64 steps; its sweep measures every
configuration itself).
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

from chsimpy_tpu_torch.benchmarks.roofline import (
    INT32_CLOCK_HZ, OPS_PER_ELEM, bound_fields, slice_bound)

ROOT = os.path.dirname(os.path.abspath(__file__))
KAPPA = 0.00029891134208698706   # derived kappa_tilde of the default run
SOURCE = 'chsimpy_tpu_torch/csrc/ch_kernels.cu'
GEMM_SOURCE = 'chsimpy_tpu_torch/csrc/gemm_sm90.cu'
REPLACES = {
    'chemical_potential': 'chsimpy_tpu/ops/pallas_kernels.py:81',
    'spectral_update': 'chsimpy_tpu/ops/pallas_kernels.py:113',
    'stats_sums': 'chsimpy_tpu/ops/pallas_kernels.py:288',
    'absdev_sum': 'chsimpy_tpu/ops/pallas_kernels.py:348',
    'slice_field': 'chsimpy_tpu/ops/ozaki.py:233',
    'matmul': 'chsimpy_tpu/ops/pallas_kernels.py:149',
    'local_band_sums': 'chsimpy_tpu/ops/pallas_kernels.py:434',
    'chemical_potential_sharded': 'chsimpy_tpu/ops/pallas_kernels.py:538',
    # no Pallas counterpart: the XLA-fused Sobol points of the JAX step
    'sobol_jitter': 'chsimpy_tpu/ops/sobol.py:46',
    # no Pallas counterpart: jax.random.split and uniform in the JAX step
    'threefry_jitter': 'chsimpy_tpu/core/stepper.py:750-751',
}
# the kernels of the matmul route (the ozaki route adds slice_field)
MATMUL_PATH = ('chemical_potential', 'spectral_update', 'stats_sums',
               'absdev_sum')
# the grid-sharded route's own kernels (it also runs K2 and K4)
SHARDED_PATH = ('local_band_sums', 'chemical_potential_sharded')
REPORT_SHAPE = (4096, 'float32')   # the fast-mode shape of the JSON line
# the slice kernel's row of the JSON line: a full N=4096 field cut into the
# 4 slices of the trimmed (3, 5) transforms
SLICE_REPORT = (4096, 4, 'solver')
SLICE_NS = (4096, 1000, 512)
# phase 7 (b): the bake-off's routes and their short protocol
BAKEOFF = ((4096, 'float32', ('matmul-fp32', 'matmul-tf32', 'fft',
                              'split4perm-fp32', 'split5permfold-fp32',
                              'gemm')),
           (2048, 'float64', ('matmul-fp64', 'split2perm-fp64', 'fft',
                              'ozaki-rfold2')))
BAKEOFF_INNER = 4
BAKEOFF_REPS = 5


class PhaseError(RuntimeError):
    pass


# results of earlier phases that a later phase holds its own to (host
# arrays and bytes; not part of the JSON detail), and files in kept_dir()
KEPT = {}


def kept_dir() -> str:
    """A temporary directory for files a later phase reads (removed at
    the end of main)."""
    if 'dir' not in KEPT:
        import tempfile
        KEPT['dir'] = tempfile.mkdtemp(prefix='chip_smoke_kept_')
    return KEPT['dir']


def keep_mesh_run(res, ckpt):
    """Phase 8 (c)'s canonical world run for phase 14 (e): its rows (the
    same on every rank) and its checkpoint file."""
    KEPT['mesh_run'] = {'timedata': res[0][0]['timedata'], 'ckpt': ckpt}


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def same_bits(a, b):
    """float64 tensors with the same bits (a NaN equal to itself)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.int64), b.reshape(-1).view(torch.int64))


def call_ms(fn, reps=30, warm=3):
    """One call alone between two CUDA events on an idle card (median of
    ``reps``): the device time plus the host time the card waits for the
    wrapper (argument checks, allocations, the launch)."""
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


DEVICE_CALLS = 20     # back-to-back calls per timed window
SLEEP_CYCLES_PER_S = 2e9   # the SM clock is at most 1.98 GHz on an H100


def device_ms(fn, calls=DEVICE_CALLS, reps=5):
    """Device time of one call: ``calls`` back-to-back calls between two
    CUDA events, over ``calls`` (median of ``reps`` windows, after a
    warm-up).  A sleep kernel holds the card while the host queues the
    window, twice as long as the host took to queue one call times
    ``calls``, so the window holds the device's work and not the wrapper's
    host time.  At N=4096 the fields exceed the 50 MB L2: each call reads
    its operands from device memory, as on the solver's path."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(2e-3, 2 * enqueue * calls) * SLEEP_CYCLES_PER_S)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def timed_row(kern, ref):
    """'ms' (device time), 'call_ms' and 'plain_ms' (device time) of a
    kernel's wrapper and its plain version."""
    return {'ms': device_ms(kern), 'call_ms': call_ms(kern),
            'plain_ms': device_ms(ref)}


def launch_counts():
    """The kernels' launch counts since the last reset, and under
    'one_launch' the calls of K5 and K5_members that took the one-launch
    path."""
    from chsimpy_tpu_torch.ops import kernels as K
    return dict(K.launches, one_launch=dict(K.one_launch))


# seconds spent in the design turns and the small-field checks, by part
# (design_turns, spent)
PART_SECONDS = {}


def spent(part, t0):
    """Add the seconds since ``t0`` to PART_SECONDS[part]."""
    PART_SECONDS[part] = (PART_SECONDS.get(part, 0.0)
                          + time.perf_counter() - t0)


def design_turns(where, fn, before_fn):
    """Device ms of ``fn`` (a wrapper, on its current design) and of
    ``before_fn`` (the design it replaced: the statistics kernel's fixed
    tile, K5's two launches) in turns in this call (before, now, now,
    before): 'ms_turns', 'before_ms_turns' and 'before_ms', their median.
    Called only where the two designs differ; the seconds it takes add up
    in PART_SECONDS['turns ' + where]."""
    t0 = time.perf_counter()
    now, before = [], []
    for turn in ('before', 'now', 'now', 'before'):
        if turn == 'now':
            now.append(device_ms(fn))
        else:
            before.append(device_ms(before_fn))
    spent('turns ' + where, t0)
    return {'ms_turns': now, 'before_ms_turns': before,
            'before_ms': statistics.median(before)}


def turns_text(row):
    """design_turns' figures for a printed line ('' where not timed)."""
    if 'before_ms' not in row:
        return ''
    return (f"before {row['before_ms']:.4f} ms, turns "
            f"{row['before_ms_turns']} / {row['ms_turns']}")


def body_turns(where, kern, prev):
    """The statistics kernel's body (``kern``) against its parent body
    (``prev``: the same launch, inputs and tile with ``prev=True``): the
    five sums to the bit (a check), both timed in turns (design_turns):
    'parent_body_same_bits', 'body_ms_turns', 'parent_body_ms_turns',
    'parent_body_ms'."""
    import torch
    a, b = kern(), prev()
    torch.cuda.synchronize()
    same = same_bits(a, b)
    check(same, f"{where}: the body's sums differ from the parent "
                f"body's: {a.tolist()} / {b.tolist()}")
    t = design_turns(where + ' body', kern, prev)
    return {'parent_body_same_bits': same, 'body_ms_turns': t['ms_turns'],
            'parent_body_ms_turns': t['before_ms_turns'],
            'parent_body_ms': t['before_ms']}


def fused_ra_turns(where, U, mean, rows, row):
    """K4_members with Ra in its second pass (``absdev_ra_members``)
    against the parent's two passes and K11 (``absdev_sum_members`` +
    ``row_absdev_members``): PS sums and Ra to the bit (a check), timed in
    turns (design_turns): 'fused_same_bits', 'ms_fused_turns',
    'k4_k11_ms_turns', 'k4_k11_ms'."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    def parent():
        return (K.absdev_sum_members(U, mean),
                K.row_absdev_members(rows, row))
    ps, ra = K.absdev_ra_members(U, mean, rows, row)
    ps0, ra0 = parent()
    torch.cuda.synchronize()
    same = same_bits(ps, ps0) and same_bits(ra, ra0)
    check(same, f"{where}: the fused pass differs from K4 + K11")
    t = design_turns(where + ' fused',
                     lambda: K.absdev_ra_members(U, mean, rows, row), parent)
    return {'fused_same_bits': same, 'ms_fused_turns': t['ms_turns'],
            'k4_k11_ms_turns': t['before_ms_turns'],
            'k4_k11_ms': t['before_ms']}


def body_text(row):
    """body_turns' figures for a printed line ('' where not timed)."""
    if 'parent_body_ms' not in row:
        return ''
    return (f"; parent body {row['parent_body_ms']:.4f} ms, the same bits, "
            f"turns {row['parent_body_ms_turns']} / {row['body_ms_turns']}")


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


# phase 3's field sizes: 1001 is divisible by no vector width (K3's scalar
# path); K3's calls that must give the same bits
KERNEL_NS = (4096, 1000, 1001, 512)
DETERMINISM_CALLS = 30


def kernel_phase(dev, card):
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N in KERNEL_NS:
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
                        # fixed-order sums: the same bits every call
                        same = all(torch.equal(kern(), got)
                                   for _ in range(DETERMINISM_CALLS - 1))
                        ok = ok and got[3].item() == want[3].item() and same
                        tol += (f', count exact, the same bits in '
                                f'{DETERMINISM_CALLS} calls')
                dname = str(dtype)[6:]
                row = {'name': name, 'N': N, 'dtype': dname,
                       'max_abs_err': err, 'max_rel_err': rel,
                       'tolerance': tol, 'ok': ok, **timed_row(kern, ref),
                       **kernel_bound(name, N, dname)}
                extra = ''
                if name == 'stats_sums':
                    row.update(stats_turns(
                        '3 (a)', kern, N, N, U, E,
                        lambda t, prev=False: K._stats_sums_launch(
                            U, E, cfg.A0, cfg.A1, t, prev=prev, **skw)))
                    extra = (f" (tile {row['tile']}, the fixed tile "
                             f"{row['earlier_tile']}: {turns_text(row)}"
                             f"{body_text(row)})")
                elif name == 'absdev_sum':
                    # one PyTorch call for the same sum (at float32 torch
                    # sums in float32, K4 in float64)
                    row['library_ms'] = device_ms(
                        lambda: torch.dist(U, mean, p=1))
                    extra = f"  torch.dist {row['library_ms']:.4f} ms"
                row['bound_share'] = row['bound_ms'] / row['ms']
                rows.append(row)
                print(f"kernel {name:18s} N={N:5d} {dname:8s} "
                      f"err={err:.3e} rel={rel:.3e} ({tol}) "
                      f"{'ok' if ok else 'FAIL'}  kernel {row['ms']:.4f} ms "
                      f"(one call {row['call_ms']:.4f})  plain "
                      f"{row['plain_ms']:.4f} ms  bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                      f"{row['bound_share']:.0%}){extra}  ({card})",
                      flush=True)
                check(ok, f"{name} N={N} {dtype}: error {err:.3e} "
                          f"outside {tol}")
    return rows + stats_fields(dev, card) + cdiv_checks(card)


# phase 3 (c): the fields whose h = delx (and 2h) the statistics body's
# divisions are held at: the canonical run's, the goldens', N=4096 and
# phase 3's; float64 draws per field
CDIV_NS = (512, 1024, 2048, 4096, 1000, 1001, 1002, 4094)
CDIV_DRAWS = 2_000_000_000


def cdiv_checks(card):
    """(c) the statistics body's division by h and 2h (``cdiv``: the
    product by the reciprocal, corrected) against the true division on
    the card (``kernels.cdiv_check``): float32 on every finite float,
    float64 on CDIV_DRAWS draws and the edges (0, the subnormals, the
    guard's ends, the largest double); no input may differ."""
    import math
    import torch
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.derived import Derived
    from chsimpy_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    lo, hi = 2.0 ** -900, 2.0 ** 901
    edges = [0.0, -0.0, 5e-324, -5e-324, 2.0 ** -1022, 1.7976931348623157e308,
             -1.7976931348623157e308, lo, -lo, math.nextafter(lo, 0.0),
             math.nextafter(hi, 0.0), hi, 1.0, -1.0]
    rows = []
    for N in CDIV_NS:
        delx = Derived.from_params(Parameters(N=N, kappa_tilde=KAPPA)).delx
        r32 = K.cdiv_check(delx, torch.float32)
        r64 = K.cdiv_check(delx, torch.float64, n=CDIV_DRAWS, seed=N,
                           edges=edges + [delx, 2 * delx, -3 * delx])
        ok = not (r32['h'] or r32['h2'] or r64['h'] or r64['h2'])
        rows.append({'name': 'cdiv', 'N': N, 'delx': delx, 'float32': r32,
                     'float64': r64, 'ok': ok})
        print(f"cdiv N={N} (h = {delx!r}, 2h): float32 {r32['checked']} "
              f"inputs, {r32['h']} / {r32['h2']} differ; float64 "
              f"{r64['checked']} inputs, {r64['h']} / {r64['h2']} differ  "
              f"({card})", flush=True)
        check(ok, f"cdiv N={N}: {r32} {r64}")
    spent('3 (c) cdiv', t0)
    return rows


def stats_turns(where, kern, bn, W, U, E, launch):
    """The statistics kernel's tile on (bn, W) blocks U (and E) and the
    fixed tile it replaced: 'tile', 'earlier_tile' as (V, band, blocks);
    where they differ, ``kern`` timed in turns with ``launch`` on the
    fixed tile (design_turns); and the body against the parent body on
    the tile (``launch(tile, prev=True)``, body_turns)."""
    from chsimpy_tpu_torch.ops import kernels as K
    ptrs = (U.data_ptr(), E.data_ptr())
    tile = K.stats_tile(bn, W, max(bn, W), 0, 0, U.element_size(), *ptrs)
    earlier = K.fixed_stats_tile(bn, W, U.element_size(), *ptrs)
    out = {'tile': list(tile), 'earlier_tile': list(earlier)}
    if tile != earlier:
        out.update(design_turns(where, kern, lambda: launch(earlier)))
    out.update(body_turns(where, kern, lambda: launch(tile, prev=True)))
    return out


# phase 3 (b): K3 on the fields whose tile the refinement sizes (N=512 is
# in (a)) and on N=2048, whose fixed tile (256 blocks) stays
STATS_FIELD_NS = (1024, 2048)


def stats_fields(dev, card):
    """(b) K3 at STATS_FIELD_NS against its plain version (phase 3's
    tolerances, the count exact, the same bits in 30 calls), its tile
    and the fixed tile, timed in turns with the fixed tile; where the
    tile is the fixed one, the same bits as under it."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    rows = []
    for N in STATS_FIELD_NS:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cfg, _, U, E, _, _ = kernel_inputs(N, dtype, dev)
            skw = dict(delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                       threshold=cfg.threshold)

            def kern():
                return K.stats_sums(U, E, cfg.A0, cfg.A1, **skw)

            def launch(tile, prev=False):
                return K._stats_sums_launch(U, E, cfg.A0, cfg.A1, tile,
                                            prev=prev, **skw)

            got = kern()
            want = K.stats_sums_ref(U, E, cfg.A0, cfg.A1, **skw)
            earlier = launch(K.fixed_stats_tile(N, N, U.element_size(),
                                                U.data_ptr(), E.data_ptr()))
            torch.cuda.synchronize()
            diff = (got - want).abs()
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            row = {'name': 'stats_sums', 'N': N, 'dtype': dname,
                   'max_abs_err': diff.max().item(),
                   'max_rel_err': (diff / want.abs()).max().item(),
                   **stats_turns('3 (b)', kern, N, N, U, E, launch)}
            same = all(torch.equal(kern(), got)
                       for _ in range(DETERMINISM_CALLS - 1))
            fixed = row['tile'] == row['earlier_tile']
            ok = (bool((diff <= rtol * want.abs()).all()) and same
                  and got[3].item() == want[3].item()
                  and (not fixed or torch.equal(got, earlier)))
            row.update(ok=ok, tolerance=f'rtol {rtol:g}, count exact, the '
                       f'same bits in {DETERMINISM_CALLS} calls; the fixed '
                       f'tile\'s bits where the tile is the fixed one',
                       **timed_row(kern, lambda: K.stats_sums_ref(
                           U, E, cfg.A0, cfg.A1, **skw)),
                       **kernel_bound('stats_sums', N, dname))
            row['bound_share'] = row['bound_ms'] / row['ms']
            rows.append(row)
            print(f"kernel stats_sums (b) N={N:5d} {dname:8s} "
                  f"rel={row['max_rel_err']:.3e} tile {row['tile']} (fixed "
                  f"{row['earlier_tile']}) {'ok' if ok else 'FAIL'}  kernel "
                  f"{row['ms']:.4f} ms ({turns_text(row) or 'one design'}"
                  f"{body_text(row)})"
                  f"  plain "
                  f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}, {row['bound_share']:.0%})  ({card})",
                  flush=True)
            check(ok, f"stats_sums N={N} {dname}: {row}")
            del U, E
    spent('3 (b)', t0)
    return rows


# ----------------------------------------------------------------------
# phase 4: the canonical default run (the main path)
# ----------------------------------------------------------------------

def default_run(transform='matmul', **fields):
    """The canonical run on ``transform`` (pinned: ``auto`` follows the
    card's table) with the Parameters ``fields``: the stop step and the
    golden anchors.  On every route the JAX package stops this run at the
    golden's 1674 on the CPU (split at levels 2 with fold_field=False, and
    fft: E every 100 steps within 5.06e-11 of the anchors)."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator
    from chsimpy_tpu_torch.ops import kernels as K

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'default_n512_anchors.json')) as f:
        g = json.load(f)
    p = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA,
                   transform_backend=transform, **fields)
    sim = Simulator(p)
    K.reset_launches()
    t0 = time.perf_counter()
    sol = sim.solve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.launches)
    td = sol.timedata.data()
    res = {'route': sim.solver.cfg.transform_backend,
           'computed_steps': sol.computed_steps,
           'stop_reason': sol.stop_reason, 'tau0': sol.tau0, 't0': sol.t0,
           'seconds': seconds, 'launches': launches,
           'E_first_rel': abs(td[0, 1] / g['E_first'] - 1),
           'E_last_rel': abs(td[-1, 1] / g['E_last'] - 1),
           'E_every_100_max_rel': float(np.max(np.abs(
               td[::100, 1] / np.asarray(g['E_every_100']) - 1))),
           'argmax_E2': int(td[:, 2].argmax())}
    tag = f"default run ({res['route']})"
    print(f"{tag}: {json.dumps(res)}", flush=True)
    res['E'] = [float(e) for e in td[:, 1]]
    check(tuple(sol.U.shape) == (512, 512) and sol.U.is_cuda
          and bool(torch.isfinite(sol.U).all()),
          f'{tag}: the field is not a finite (512, 512) tensor on the card')
    check(sol.computed_steps == g['computed_steps'] == 1674,
          f"{tag}: stop step {sol.computed_steps} != 1674")
    check(sol.stop_reason == g['stop_reason'] == 'energy',
          f"{tag}: stop reason {sol.stop_reason}")
    check(sol.tau0 == g['tau0'], f"{tag}: tau0 {sol.tau0} != {g['tau0']}")
    check(abs(sol.t0 / g['t0'] - 1) <= 1e-12, f'{tag}: t0 outside 1e-12')
    check(res['E_first_rel'] <= 1e-12, f'{tag}: E_first outside 1e-12')
    check(res['E_last_rel'] <= 1e-10, f'{tag}: E_last outside 1e-10')
    check(res['E_every_100_max_rel'] <= 1e-10,
          f'{tag}: E_every_100 outside 1e-10')
    check(res['argmax_E2'] == g['argmax_E2'], f'{tag}: argmax E2 differs')
    otf = sim.solver.cfg.otf_coeffs
    for name in MATMUL_PATH:
        if otf and name == 'spectral_update':
            name = 'update_otf'             # K12 in place of K2
        n = launches[name]
        check(n >= sol.computed_steps - 1,
              f"{tag}: {name} launched {n} times in {sol.computed_steps} "
              f"steps")
    check(launches['slice_field'] == 0 and launches['matmul'] == 0,
          f'{tag}: the route sliced a field or ran the GEMM kernel')
    return res


# ----------------------------------------------------------------------
# phase 5: fast mode at N=4096, CLI and API, rates and layer times
# ----------------------------------------------------------------------

def cli_run():
    cmd = [sys.executable, '-m', 'chsimpy_tpu_torch', '-N', '4096', '-n',
           '256', '-z', '--precision', 'float32', '--no-gui', '-g',
           'uniform', '-K', repr(KAPPA), '--transform', 'matmul',
           '--matmul-precision', 'highest']
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
    for name in MATMUL_PATH:
        check(launches[name] >= 255,
              f"CLI: {name} launched {launches[name]} times in 255 steps")
    print(f"cli run: 256 steps in {seconds:.1f} s (process included), "
          f"launches {launches}", flush=True)
    return {'seconds': seconds, 'launches': launches}


def make_solver(N, precision, chunk, full_sim=True, transform='matmul',
                **fields):
    """A prepared Solver on the card; the route and (unless ``fields``
    give one) the full-float32 products pinned, so a phase measures what
    it measured before ``auto`` and the float32 default followed the
    card's table (phase 16)."""
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.solver import Solver
    fields.setdefault('matmul_precision', 'highest')
    p = Parameters(N=N, precision=precision, full_sim=full_sim,
                   generator='uniform', kappa_tilde=KAPPA, chunk_size=chunk,
                   no_gui=True, device='cuda', transform_backend=transform,
                   **fields)
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
        'nonlinear_K1': call_ms(
            lambda: stepper._nonlinear_term(cfg, c, s.U)),
        'forward_dct': call_ms(lambda: dct_ops.dct2(E, c['C'])),
        'update_K2': call_ms(lambda: stepper.K.spectral_update(
            s.hat_U, hat_E, c['Seig'], c['CHeig'])),
        'inverse_dct': call_ms(lambda: dct_ops.idct2(s.hat_U, c['C'])),
        'stats_K3_K4_finalize': call_ms(
            lambda: stepper._stats(cfg, c, s.U, E)),
        'whole_step': call_ms(lambda: stepper._step(cfg, c, s), reps=20),
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
    for name in MATMUL_PATH:
        check(launches[name] >= 255,
              f"API f32: {name} launched {launches[name]} times in 255 "
              f"steps")
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
    out['E_f64_64_steps'] = [float(e) for e in E64]
    out['E_f32_64_steps'] = [float(e) for e in E32]
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


# ----------------------------------------------------------------------
# phase 6: the float64 ozaki route
# ----------------------------------------------------------------------

# phase 6 (a): max|x| of the 'ulp' field, one ulp above 2^SLICE_ULP_EXP,
# where ceil(log2(.)) and frexp's exponent differ by one
SLICE_ULP_EXP = 8


def slice_launch_ms(K, x, n):
    """Device time of each launch of the two-launch slice kernel alone
    (at every size: the one-launch path's fields too): the max pass that
    writes the scale, and the slice pass."""
    _, inv = K._slice_scale_launch(x)
    return {'slice_scale_kernel': device_ms(lambda: K._slice_scale_launch(x)),
            'slice_kernel': device_ms(
                lambda: K._slice_planes_launch(x, inv, n))}


def slice_phase(dev, card):
    """(a) the slice kernel against its plain version on the card."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N in SLICE_NS:
        rng = np.random.default_rng(N)
        fields = {'solver': 0.875 + 0.01 * (rng.random((N, N)) - 0.5),
                  'normal': rng.standard_normal((N, N)),
                  'zeros': np.zeros((N, N))}
        ulp = np.clip(rng.standard_normal((N, N)) * 20.0, -120.0, 120.0)
        ulp[N // 3, N // 2] = -np.nextafter(2.0 ** SLICE_ULP_EXP, np.inf)
        fields['ulp'] = ulp
        nan = fields['solver'].copy()
        nan[N // 2, N // 3] = np.nan
        fields['nan'] = nan
        one_path = K.slice_one_launch(1, N * N)
        for kind, f in fields.items():
            t0 = time.perf_counter()
            x = torch.tensor(f, dtype=torch.float64, device=dev)
            for n in (4, 6, 8):
                K.reset_launches()
                got, scale = K.slice_field(x, n)
                counted = K.launches['slice_field']
                one = K.one_launch['slice_field']
                want, wscale = K.slice_field_ref(x, n)
                two, tscale = K._slice_two_launches(x, n)
                torch.cuda.synchronize()
                err = (got.int() - want.int()).abs().max().item()
                ok = (err == 0 and same_bits(scale, wscale)
                      and torch.equal(got, two) and same_bits(scale, tscale)
                      and counted == 1 and one == int(one_path))
                if kind == 'ulp':
                    # the plain formula's exponent, not frexp's
                    ok = ok and scale.item() == 2.0 ** (SLICE_ULP_EXP + 2)
                row = {'name': 'slice_field', 'N': N, 'n_slices': n,
                       'field': kind, 'max_abs_err': err,
                       'one_launch': one_path,
                       'scale': scale.item(), 'plain_scale': wscale.item(),
                       'tolerance': 'bit-identical slices and scale (a NaN '
                                    'scale too), the two launches\' bits, '
                                    'one count a call, the one-launch path '
                                    'where the shape takes it',
                       'ok': ok}
                if kind == 'solver':
                    row.update(timed_row(lambda: K.slice_field(x, n),
                                         lambda: K.slice_field_ref(x, n)))
                    row['launch_ms'] = slice_launch_ms(K, x, n)
                    if one_path:
                        row.update(design_turns(
                            '6 (a)', lambda: K.slice_field(x, n),
                            lambda: K._slice_two_launches(x, n)))
                rows.append(row)
                times = (f"kernel {row['ms']:.4f} ms (" + ', '.join(
                    f"{k} {v:.4f}" for k, v in row['launch_ms'].items())
                    + (f"; one launch, two launches: {turns_text(row)}"
                       if 'before_ms' in row else '')
                    + f") plain {row['plain_ms']:.4f} ms  ({card})"
                    if 'ms' in row else '')
                print(f"kernel slice_field N={N:5d} n={n} {kind:6s} "
                      f"max diff {err} scale {row['scale']!r} "
                      f"{'ok' if ok else 'FAIL'}  {times}", flush=True)
                check(ok, f"slice_field N={N} n={n} {kind}: slices differ "
                          f"by {err} or scale {row['scale']!r} != "
                          f"{row['plain_scale']!r} ({counted} counts)")
            if kind == 'nan':
                spent('6 (a) NaN field', t0)
    return rows


def slices_per_forward(cfg) -> int:
    """Slice kernel launches of one forward transform of the route (the
    inverse slices once)."""
    if cfg.ozaki_rfold_levels:
        return cfg.ozaki_rfold_levels + 1
    return 2 if cfg.ozaki_fold else 1


def iterations_run(steps, chunk, n_iters, start=1):
    """Step iterations a solve entered at computed step ``start`` with
    ``n_iters`` to go runs when it ends at computed step ``steps``: all of
    them without a stop, else the chunks before the one that holds the
    stop and in that one the steps to the first look at the stop flag
    after it (``stepper.STOP_POLL``)."""
    from chsimpy_tpu_torch.core.stepper import STOP_POLL
    t = steps - start
    if t >= n_iters:
        return n_iters
    c = (t - 1) // chunk * chunk
    k = min(chunk, n_iters - c)
    return c + min(k, -(-(t - c) // STOP_POLL) * STOP_POLL)


def check_ozaki_launches(tag, cfg, launches, steps, chunk, ntmax):
    """Every kernel of the route launched; K1 once per step iteration the
    chunks ran;
    the slice kernel fwd + iterations * (fwd + 1) times (one forward at
    entry, a forward and an inverse per step), each by its one-launch path
    where the field's shape takes it."""
    from chsimpy_tpu_torch.ops import kernels as K
    iterations = iterations_run(steps, chunk, ntmax - 1)
    fwd = slices_per_forward(cfg)
    want = fwd + iterations * (fwd + 1)
    for name in MATMUL_PATH + ('slice_field',):
        check(launches[name] > 0, f"{tag}: {name} was never launched")
    check(launches['matmul'] == 0, f"{tag}: the GEMM kernel was launched")
    check(launches['chemical_potential'] == iterations,
          f"{tag}: chemical_potential launched "
          f"{launches['chemical_potential']} times, not {iterations}")
    check(launches['slice_field'] == want,
          f"{tag}: slice_field launched {launches['slice_field']} times, "
          f"the route implies {want}")
    one = want if K.slice_one_launch(1, cfg.N * cfg.N) else 0
    check(launches['one_launch']['slice_field'] == one,
          f"{tag}: {launches['one_launch']['slice_field']} of the "
          f"slice_field calls took the one-launch path, the shape implies "
          f"{one}")
    return iterations, want


def ozaki_default_run():
    """(b) the canonical N=512 float64 run on the ozaki route (level-1
    fold): the main path of this slice."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator
    from chsimpy_tpu_torch.ops import kernels as K

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'default_n512_anchors.json')) as f:
        g = json.load(f)
    p = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA,
                   transform_backend='ozaki')
    sim = Simulator(p)
    cfg = sim.solver.cfg
    check(cfg.ozaki_fold and not cfg.ozaki_rfold_levels,
          'the N=512 ozaki run is not on the level-1 fold route')
    K.reset_launches()
    t0 = time.perf_counter()
    sol = sim.solve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    td = sol.timedata.data()
    res = {'route': 'fold', 'computed_steps': sol.computed_steps,
           'stop_reason': sol.stop_reason, 'tau0': sol.tau0, 't0': sol.t0,
           'seconds': seconds, 'launches': launches,
           'E_first_rel': abs(td[0, 1] / g['E_first'] - 1),
           'E_last_rel': abs(td[-1, 1] / g['E_last'] - 1),
           'E_every_100_max_rel': float(np.max(np.abs(
               td[::100, 1] / np.asarray(g['E_every_100']) - 1))),
           'argmax_E2': int(td[:, 2].argmax())}
    print(f"ozaki default run: {json.dumps(res)}", flush=True)
    check(tuple(sol.U.shape) == (512, 512) and sol.U.is_cuda
          and bool(torch.isfinite(sol.U).all()),
          'ozaki: the field is not a finite (512, 512) tensor on the card')
    check(sol.computed_steps == 1674, f"ozaki stop step "
                                      f"{sol.computed_steps} != 1674")
    check(sol.stop_reason == 'energy', f"ozaki stop reason "
                                       f"{sol.stop_reason}")
    check(sol.tau0 == g['tau0'], f"ozaki tau0 {sol.tau0} != {g['tau0']}")
    check(abs(sol.t0 / g['t0'] - 1) <= 1e-12, 'ozaki t0 outside 1e-12')
    check(res['E_first_rel'] <= 1e-12, 'ozaki E_first outside 1e-12')
    check(res['E_last_rel'] <= 1e-10, 'ozaki E_last outside 1e-10')
    check(res['E_every_100_max_rel'] <= 1e-10,
          'ozaki E_every_100 outside 1e-10')
    check(res['argmax_E2'] == g['argmax_E2'], 'ozaki argmax E2 differs')
    res['iterations'], res['slice_launches_implied'] = check_ozaki_launches(
        'ozaki default run', cfg, launches, sol.computed_steps,
        p.chunk_size, p.ntmax)
    res['E'] = [float(e) for e in td[:, 1]]
    return res


def ozaki_golden_n1024():
    """(c) tests/golden/n1024_uniform_stop.json on the rfold route."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator
    from chsimpy_tpu_torch.ops import kernels as K

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'n1024_uniform_stop.json')) as f:
        g = json.load(f)
    p = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA,
                   transform_backend='ozaki', **g['config'])
    sim = Simulator(p)
    cfg = sim.solver.cfg
    check(cfg.ozaki_rfold_levels == 2 and cfg.ozaki_fwd_pairs == (3, 5)
          and cfg.ozaki_inv_pairs == (3, 5),
          'the N=1024 ozaki run is not on the rfold route (L=2, (3, 5))')
    K.reset_launches()
    t0 = time.perf_counter()
    sol = sim.solve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    td = sol.timedata.data()
    n = min(len(td), len(g['E']))
    rel = float(np.max(np.abs(td[:n, 1] / np.asarray(g['E'][:n]) - 1)))
    res = {'route': 'rfold L=2', 'computed_steps': sol.computed_steps,
           'stop_reason': sol.stop_reason, 'tau0': sol.tau0,
           'E_max_rel': rel, 'seconds': seconds,
           'launches': launch_counts()}
    print(f"ozaki n1024 golden: {json.dumps(res)}", flush=True)
    check(sol.computed_steps == g['computed_steps'] == 1837,
          f"ozaki N=1024 stop step {sol.computed_steps} != 1837")
    check(sol.stop_reason == g['stop_reason'] == 'energy',
          f"ozaki N=1024 stop reason {sol.stop_reason}")
    check(sol.tau0 == g['tau0'], f"ozaki N=1024 tau0 {sol.tau0}")
    check(rel <= 1e-10, f"ozaki N=1024 E {rel:.3e} outside 1e-10")
    check_ozaki_launches('ozaki N=1024', cfg, res['launches'],
                         sol.computed_steps, p.chunk_size, p.ntmax)
    return res


class CallRecorder:
    """Records every call (arguments included) of the wrapped functions
    during one step; the wrappers are removed on exit."""

    def __init__(self, targets):
        self.targets = targets      # (module, attribute, label)
        self.calls = {}
        self.saved = []

    def __enter__(self):
        for module, name, label in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def recorded(*a, _fn=fn, _label=label, **k):
                self.calls.setdefault(_label, []).append((_fn, a, k))
                return _fn(*a, **k)
            setattr(module, name, recorded)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def replay_ms(calls, reps=3):
    """Device time of a layer: its recorded calls of one step replayed
    back to back between two CUDA events (median of ``reps``)."""
    def run():
        for fn, a, k in calls:
            fn(*a, **k)
    return call_ms(run, reps=reps, warm=1)


def ozaki_layer_ms(solver):
    """Per-layer times of one ozaki step: each layer's calls of one step,
    recorded and replayed alone; the step itself timed whole."""
    from chsimpy_tpu_torch.core import stepper
    from chsimpy_tpu_torch.ops import ozaki as oz
    cfg, c, s = solver.cfg, solver._consts, solver._state
    targets = [(oz, 'slice_field', 'slice_kernel'),
               (oz, 'int8_matmul', 'int8_products'),
               (oz, '_pair_groups', 'pair_groups'),
               (oz, '_renorm_to_slices', 'renorm'),
               (oz, '_horner_f64', 'horner'),
               (stepper, 'dct2_route', 'forward_transform'),
               (stepper, 'idct2_route', 'inverse_transform')]
    with CallRecorder(targets) as rec:
        stepper._step(cfg, c, s)
    out = {label: replay_ms(calls) for label, calls in rec.calls.items()}
    out['whole_step'] = call_ms(lambda: stepper._step(cfg, c, s),
                                reps=10, warm=1)
    out['int32_group_adds'] = out['pair_groups'] - out['int8_products']
    transforms = out['forward_transform'] + out['inverse_transform']
    out['transform_rest'] = transforms - (
        out['slice_kernel'] + out['pair_groups'] + out['renorm']
        + out['horner'])
    out['step_rest'] = out['whole_step'] - transforms
    # int8 operations of the step's products, and their rate
    ops = sum(2 * a[0].shape[0] * a[0].shape[1] * a[1].shape[1]
              for _, a, _ in rec.calls['int8_products'])
    counts = {k: len(v) for k, v in rec.calls.items()}
    return out, {'int8_ops': ops, 'int8_products': counts['int8_products'],
                 'int8_TOPS': ops / out['int8_products'] / 1e9,
                 'calls': counts}


def int8_layout_probe(card):
    """One product of the path's shape, (2048, 2048) @ (2048, 4096), with
    the right operand row-major and column-major: the rate of each."""
    import torch
    dev = torch.device('cuda', torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-64, 65, (2048, 2048), dtype=torch.int8, device=dev,
                      generator=g)
    b = torch.randint(-64, 65, (2048, 4096), dtype=torch.int8, device=dev,
                      generator=g)
    bc = b.t().contiguous().t()
    check(torch.equal(torch._int_mm(a, b), torch._int_mm(a, bc)),
          'int8 product differs between operand layouts')
    ops = 2 * 2048 * 2048 * 4096
    out = {}
    for name, rhs in (('row_major', b), ('column_major', bc)):
        ms = call_ms(lambda: torch._int_mm(a, rhs))
        out[name] = {'ms': ms, 'TOPS': ops / ms / 1e9}
    print("int8 product (2048x2048)@(2048x4096): " + ', '.join(
        f"right operand {k} {v['ms']:.4f} ms {v['TOPS']:.1f} TOP/s"
        for k, v in out.items()) + f"  ({card})", flush=True)
    return out


def ozaki_n4096(card):
    """(d) N=4096 float64: ozaki (rfold) against native float64 matmul."""
    import numpy as np
    import torch

    mm = make_solver(4096, 'float64', 64, transform='matmul')
    oz = make_solver(4096, 'float64', 64, transform='ozaki')
    check(oz.cfg.ozaki_rfold_levels == 2, 'N=4096 ozaki is not rfold L=2')
    check(np.array_equal(mm.U_init, oz.U_init), 'different initial fields')
    # the warm chunk: 64 steps from the same field on both routes
    Emm = np.array(mm.solve_or_resume(64).timedata.E)
    Eoz = np.array(oz.solve_or_resume(64).timedata.E)
    check(len(Emm) == len(Eoz) == 64, 'N=4096: not 64 rows')
    rel = float(np.max(np.abs(Eoz / Emm - 1)))
    check(bool(torch.isfinite(oz.solution.U).all()),
          'N=4096 ozaki field not finite')
    print(f"N=4096 float64: ozaki E vs matmul max rel {rel:.3e} over 64 "
          f"steps", flush=True)
    check(rel <= 1e-10, f"N=4096 ozaki E {rel:.3e} from matmul (1e-10)")
    rates = {'matmul': [], 'ozaki': []}
    for name in ('matmul', 'ozaki', 'ozaki', 'matmul'):
        rates[name].append(rate(mm if name == 'matmul' else oz, 128))
    for k, v in rates.items():
        print(f"steps/s N=4096 float64 {k}: " + ', '.join(
            f"{r:.2f}" for r in v) + f"  ({card})", flush=True)
    layers, products = ozaki_layer_ms(oz)
    print("layers N=4096 float64 ozaki: " + ', '.join(
        f"{n} {t:.4f} ms" for n, t in layers.items()), flush=True)
    print(f"int8 products per step: {products['int8_products']}, "
          f"{products['int8_ops'] / 1e12:.3f} T ops, "
          f"{products['int8_TOPS']:.1f} TOP/s  ({card})", flush=True)
    torch.cuda.synchronize()
    return {'E_vs_matmul_max_rel': rel, 'steps_per_s': rates,
            'layers_ms': layers, 'int8': products,
            'int8_layout': int8_layout_probe(card),
            'peak_memory_GB': torch.cuda.max_memory_allocated() / 1e9}


def ozaki_phase(dev, card):
    out = {'slice_kernel': slice_phase(dev, card)}
    t0 = time.perf_counter()
    if 'knob_refs' in KEPT:
        # phase 16 (b)'s checks and stop runs (no rates) in worker
        # processes beside (b) and (c), two single-process host-bound runs
        # whose checks take no rates; done before (d) times the routes
        KEPT['knob_workers'] = start_knob_workers(*KEPT.pop('knob_refs'))
    out['default_run'] = ozaki_default_run()
    out['n1024_golden'] = ozaki_golden_n1024()
    if 'knob_workers' in KEPT:
        wait_knob_workers(KEPT['knob_workers'])
    out['n4096'] = ozaki_n4096(card)
    out['seconds_b_to_d'] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 7: the split and FFT routes, the bake-off and the GEMM kernel
# ----------------------------------------------------------------------

GEMM_SHAPES = ((4096, 4096, 4096), (1000, 1000, 1000), (512, 512, 512),
               (1000, 1531, 777))   # (M, K, N); the last one ragged
# (transposed A, transposed B): each operand row-major or the .T view of a
# row-major matrix; every layout is its own instantiation of the kernel
GEMM_LAYOUTS = ((False, False), (False, True), (True, False), (True, True))
GEMM_TOL = '<= 4x the plain error and 1e-5 max|ref|, both vs float64'
GEMM_DCT_N = 4096
# phase 7 (b): the round-trip error after BAKEOFF_INNER round trips of a
# [0, 1) field, per arithmetic (measured on the card: fp32 routes <= 2.5e-5,
# tf32 3.1e-3, float64 <= 4.7e-11); a wrong product gives O(1)
ROUNDTRIP_BOUND = {'float32': 1e-4, 'tf32': 1e-2, 'float64': 1e-9}


def held_to_plain(tag, got, plain, ref, times, card, **info):
    """One GEMM row: ``got`` (the kernel) and ``plain`` against the float64
    ``ref``; the kernel's error at most 4x the plain one and 1e-5
    max|ref|.  ``times``: :func:`timed_row`'s."""
    err = (got.double() - ref).abs().max().item()
    plain_err = (plain.double() - ref).abs().max().item()
    bound = 1e-5 * ref.abs().max().item()
    ok = err <= 4 * plain_err and err <= bound
    row = {'name': 'matmul', **info, 'dtype': 'float32', 'max_abs_err': err,
           'plain_max_abs_err': plain_err, 'tolerance': GEMM_TOL, 'ok': ok,
           **times}
    print(f"kernel {tag} err={err:.3e} plain {plain_err:.3e} "
          f"{'ok' if ok else 'FAIL'}  kernel {row['ms']:.4f} ms (one call "
          f"{row['call_ms']:.4f})  plain {row['plain_ms']:.4f} ms  ({card})",
          flush=True)
    check(ok, f"{tag}: error {err:.3e} (plain {plain_err:.3e}, bound "
              f"{bound:.3e})")
    return row


def gemm_phase(dev, card):
    """(a) the GEMM kernel against its plain version on the card, every
    operand layout at every shape, and the DCT pair built on it."""
    import torch
    from chsimpy_tpu_torch.ops import dct as dct_ops
    from chsimpy_tpu_torch.ops import kernels as K

    dct_ops.require_full_fp32()
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for M, Kd, N in GEMM_SHAPES:
        for ta, tb in GEMM_LAYOUTS:
            A = torch.randn((Kd, M) if ta else (M, Kd), device=dev,
                            generator=g)
            B = torch.randn((N, Kd) if tb else (Kd, N), device=dev,
                            generator=g)
            A, B = (A.T if ta else A), (B.T if tb else B)
            layout = ('T' if ta else 'N') + ('T' if tb else 'N')
            got, plain = K.matmul(A, B), K.matmul_ref(A, B)
            ref = A.double() @ B.double()
            torch.cuda.synchronize()
            row = held_to_plain(
                f"matmul ({M}x{Kd})@({Kd}x{N}) {layout}", got, plain, ref,
                timed_row(lambda: K.matmul(A, B),
                          lambda: K.matmul_ref(A, B)), card,
                M=M, K=Kd, N=N, layout=layout)
            if not rows:
                # the one PyTorch call of the same product (cuBLAS)
                row['library_ms'] = device_ms(lambda: torch.matmul(A, B))
            flop = 2.0 * M * Kd * N
            row['TFLOPS'] = flop / row['ms'] / 1e9
            row['plain_TFLOPS'] = flop / row['plain_ms'] / 1e9
            print(f"kernel matmul ({M}x{Kd})@({Kd}x{N}) {layout}: "
                  f"{row['TFLOPS']:.2f} TFLOP/s, plain "
                  f"{row['plain_TFLOPS']:.2f}  ({card})", flush=True)
            rows.append(row)
    # the DCT pair of the bake-off's gemm route against the solver's
    # matmul route (torch.matmul, TF32 off) on the same operands
    N = GEMM_DCT_N
    C = dct_ops.dct_matrix(N, torch.float32, dev)
    x = torch.rand((N, N), device=dev, generator=g)
    C64, x64 = C.double(), x.double()
    X = K.dct2_gemm(x, C)
    rows.append(held_to_plain(
        f"dct2_gemm N={N}", X, dct_ops.dct2(x, C), C64 @ x64 @ C64.T,
        timed_row(lambda: K.dct2_gemm(x, C), lambda: dct_ops.dct2(x, C)),
        card, N=N, op='dct2_gemm'))
    X64 = X.double()
    rows.append(held_to_plain(
        f"idct2_gemm N={N}", K.idct2_gemm(X, C), dct_ops.idct2(X, C),
        C64.T @ X64 @ C64,
        timed_row(lambda: K.idct2_gemm(X, C), lambda: dct_ops.idct2(X, C)),
        card, N=N, op='idct2_gemm'))
    x = torch.ones((8, 8), dtype=torch.float64, device=dev)
    try:
        K.matmul(x, x)
    except TypeError as e:
        print(f"kernel matmul float64 input raises: {e}", flush=True)
    else:
        raise PhaseError('matmul took a float64 CUDA input')
    return rows


def bakeoff_phase(dev, card):
    """(b) the bake-off's routes through its own functions; the GEMM
    kernel's launches counted over this run."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.benchmarks import dct_bench
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    K.reset_launches()
    gemm_round_trips = 0
    for N, dtype, routes in BAKEOFF:
        x = torch.tensor(np.random.default_rng(0).random((N, N)),
                         dtype=getattr(torch, dtype), device=dev)
        fns = dct_bench._roundtrip_fns(N, dtype, BAKEOFF_INNER, dev)
        for name in routes:
            fn = fns[name]
            med, best = dct_bench.time_route(fn, x, BAKEOFF_REPS,
                                             BAKEOFF_INNER)
            err = dct_bench.accuracy_route(fn, x)
            if name == 'gemm':
                # the untimed first call, the timed ones, the accuracy call
                gemm_round_trips += (BAKEOFF_REPS + 2) * BAKEOFF_INNER
            bound = ROUNDTRIP_BOUND['tf32' if name.endswith('-tf32')
                                    else dtype]
            row = {'N': N, 'dtype': dtype, 'route': name, 'ms_median': med,
                   'ms_best': best, 'roundtrip_err': err,
                   'roundtrip_bound': bound, 'inner': BAKEOFF_INNER}
            rows.append(row)
            print(f"bake-off N={N} {dtype} {name}: {med:.4f} ms median "
                  f"({best:.4f} best) per round trip, rt-err {err:.3e} "
                  f"(bound {bound:g})  ({card})", flush=True)
            check(np.isfinite(med) and med > 0,
                  f"bake-off {name}: no time")
            check(err <= bound, f"bake-off N={N} {dtype} {name}: round-trip "
                                f"error {err:.3e} above {bound:g}")
        del fns
    # the solver's TF32 switch is restored after the tf32 route
    check(not torch.backends.cuda.matmul.allow_tf32,
          'TF32 left on after the bake-off')
    launches = dict(K.launches)
    check(launches['matmul'] == 4 * gemm_round_trips,
          f"matmul launched {launches['matmul']} times for "
          f"{gemm_round_trips} gemm round trips")
    return {'rows': rows, 'launches': launches,
            'gemm_round_trips': gemm_round_trips}


def route_layer_ms(solver, targets):
    """Per-layer times of one step of ``solver``'s route: the forward and
    inverse transforms and each of ``targets`` (their calls of one step,
    recorded and replayed alone), and the whole step."""
    from chsimpy_tpu_torch.core import stepper
    cfg, c, s = solver.cfg, solver._consts, solver._state
    with CallRecorder([(stepper, 'dct2_route', 'forward_transform'),
                       (stepper, 'idct2_route', 'inverse_transform'),
                       *targets]) as rec:
        stepper._step(cfg, c, s)
    out = {label: replay_ms(calls) for label, calls in rec.calls.items()}
    out['whole_step'] = call_ms(lambda: stepper._step(cfg, c, s),
                                reps=10, warm=1)
    transforms = out['forward_transform'] + out['inverse_transform']
    out['step_rest'] = out['whole_step'] - transforms
    return out, {k: len(v) for k, v in rec.calls.items()}


def routes_n4096(card, E64):
    """(d) N=4096 float32 on split and fft against phase 5's float64 E,
    rates in turns with the matmul route, and the layers of one step."""
    import numpy as np
    import torch

    solvers = {t: make_solver(4096, 'float32', 64, transform=t)
               for t in ('matmul', 'split', 'fft')}
    check(solvers['split'].cfg.split_levels_resolved == 4,
          'N=4096 split is not at levels 4')
    out = {'E_vs_f64_max_rel': {}, 'mean_U': {}}
    for t in ('split', 'fft'):
        s = solvers[t]
        U0 = s.solution.U.double().mean().item()
        E = np.array(s.solve_or_resume(64).timedata.E)
        check(len(E) == len(E64) == 64, f'N=4096 {t}: not 64 rows')
        rel = float(np.max(np.abs(E / np.asarray(E64) - 1)))
        mean = s.solution.U.double().mean().item()
        out['E_vs_f64_max_rel'][t] = rel
        out['mean_U'][t] = {'initial': U0, 'after_64': mean}
        KEPT[f'E_{t}_f32_4096'] = E.tolist()      # phase 15 (c)
        print(f"N=4096 float32 {t}: E vs float64 max rel {rel:.3e} over 64 "
              f"steps; mean(U) {mean!r} (initial {U0!r})", flush=True)
        check(bool(torch.isfinite(s.solution.U).all()),
              f'N=4096 {t}: field not finite')
        check(rel <= 1e-5, f"N=4096 {t}: E {rel:.3e} from float64 (1e-5)")
        check(abs(mean - U0) <= 1e-6,
              f"N=4096 {t}: mean(U) {mean} drifted from {U0}")
    solvers['matmul'].solve_or_resume(64)          # its warm-up chunk
    rates = {t: [] for t in solvers}
    for t in ('matmul', 'split', 'fft', 'fft', 'split', 'matmul'):
        rates[t].append(rate(solvers[t], 128))
    for t, v in rates.items():
        print(f"steps/s N=4096 float32 {t}: " + ', '.join(
            f"{r:.2f}" for r in v) + f"  ({card})", flush=True)
    out['steps_per_s'] = rates
    layers = {}
    layers['split'], calls_split = route_layer_ms(
        solvers['split'], [(torch, 'matmul', 'block_products')])
    layers['split']['folds'] = (layers['split']['forward_transform']
                                + layers['split']['inverse_transform']
                                - layers['split']['block_products'])
    layers['fft'], calls_fft = route_layer_ms(
        solvers['fft'], [(torch.fft, 'rfft', 'rfft'),
                         (torch.fft, 'irfft', 'irfft')])
    layers['fft']['twiddles_and_folds'] = (
        layers['fft']['forward_transform']
        + layers['fft']['inverse_transform']
        - layers['fft']['rfft'] - layers['fft']['irfft'])
    for t, v in layers.items():
        print(f"layers N=4096 float32 {t}: " + ', '.join(
            f"{n} {ms:.4f} ms" for n, ms in v.items()) + f"  ({card})",
            flush=True)
    out['layers_ms'] = layers
    out['calls_per_step'] = {'split': calls_split, 'fft': calls_fft}
    return out


# phase 7 (e): (golden, routes, E bound at every step: tests/test_golden.py)
STOP_GOLDENS = (('n1024_uniform_stop', ('matmul', 'split', 'fft'), 1e-10),
                ('n2048_uniform_stop', ('matmul', 'split', 'fft'), 1e-10),
                ('n1024_lcg_60', ('matmul',), 1e-12))


def load_golden(name):
    with open(os.path.join(ROOT, 'tests', 'golden', name + '.json')) as f:
        return json.load(f)


def stop_goldens():
    """(e) the N=1024 and N=2048 stop goldens on the matmul, split and fft
    routes (exact stop step, E at every step) and n1024_lcg_60."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator

    out = []
    for name, routes, rtol in STOP_GOLDENS:
        g = load_golden(name)
        for route in routes:
            p = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA,
                           transform_backend=route, **g['config'])
            t0 = time.perf_counter()
            sim = Simulator(p)
            sol = sim.solve()
            torch.cuda.synchronize()
            td = sol.timedata.data()
            n = min(len(td), len(g['E']))
            rel = float(np.max(np.abs(td[:n, 1] / np.asarray(g['E'][:n])
                                      - 1)))
            res = {'golden': name, 'route': route,
                   'levels': sim.solver.cfg.spectral_levels,
                   'computed_steps': sol.computed_steps,
                   'stop_reason': sol.stop_reason, 'tau0': sol.tau0,
                   'E_max_rel': rel, 'E_bound': rtol,
                   'seconds': time.perf_counter() - t0}
            out.append(res)
            print(f"stop golden {name} on {route}: {json.dumps(res)}",
                  flush=True)
            check(sol.computed_steps == g['computed_steps']
                  and sol.stop_reason == g['stop_reason']
                  and sol.tau0 == g['tau0'],
                  f"{name} on {route}: stop {sol.computed_steps} "
                  f"{sol.stop_reason} tau0 {sol.tau0}, golden "
                  f"{g['computed_steps']} {g['stop_reason']} {g['tau0']}")
            check(len(td) == len(g['E']) and rel <= rtol,
                  f"{name} on {route}: E {rel:.3e} (bound {rtol:g})")
    return out


def routes_phase(dev, card, E64):
    out = {'gemm': gemm_phase(dev, card),
           'bakeoff': bakeoff_phase(dev, card)}
    t0 = time.perf_counter()
    out['default_run'] = {t: default_run(t) for t in ('split', 'fft')}
    out['n4096'] = routes_n4096(card, E64)
    out['seconds_c_to_d'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['stop_goldens'] = stop_goldens()
    out['seconds_e'] = time.perf_counter() - t0
    return out


# the least time the card could take for a kernel's work (bound_ms):
# chsimpy_tpu_torch/benchmarks/roofline.py (imported at the top)
TF32_PASSES = 3     # the GEMM's float32-class product: 3xTF32


def mu_bytes_ops(U):
    n, s = U.numel(), U.element_size()
    return 2 * n * s, OPS_PER_ELEM['chemical_potential'] * n


def stats_bytes_ops(U, halo=True):
    """K3 on a field, or K7 on a block with its halo: U and E read, five
    float64 sums written."""
    n, s = U.numel(), U.element_size()
    extra = 2 * (U.shape[0] + U.shape[1]) * s if halo else 0
    return 2 * n * s + extra + 5 * 8, OPS_PER_ELEM['stats'] * n


def kernel_bound(name, N, dtype, n_slices=4):
    """bound_fields of the kernels of phases 3, 6 and 7 at their report
    shapes (an (N, N) field; the GEMM an (N, N) @ (N, N) float32
    product)."""
    n = N * N
    s = 4 if dtype == 'float32' else 8
    if name == 'chemical_potential':
        return bound_fields(2 * n * s, OPS_PER_ELEM[name] * n, dtype)
    if name == 'spectral_update':
        return bound_fields(5 * n * s, OPS_PER_ELEM[name] * n, dtype)
    if name == 'stats_sums':
        return bound_fields(2 * n * s + 5 * 8, OPS_PER_ELEM['stats'] * n,
                            dtype)
    if name == 'absdev_sum':
        return bound_fields(n * s + 8, OPS_PER_ELEM[name] * n, dtype)
    if name == 'slice_field':
        return bound_fields(n * 8 + n * n_slices,
                            (OPS_PER_ELEM['slice_setup']
                             + OPS_PER_ELEM['slice_per_plane'] * n_slices)
                            * n, 'float64')
    if name == 'matmul':
        # the float32-class product in TF32 passes on the tensor cores;
        # beside it the bound on the FP32 pipes the kernel left
        out = bound_fields(3 * n * 4, TF32_PASSES * 2.0 * N ** 3, 'tf32')
        out['bound_fp32_ms'] = bound_fields(3 * n * 4, 2.0 * N ** 3,
                                            'float32')['bound_ms']
        return out
    if name == 'sobol_jitter':
        # U read and written; the (N, 30) direction numbers, the N shifts
        # (int64) and the base read
        return bound_fields(2 * n * s + N * 31 * 8 + 8,
                            OPS_PER_ELEM[name] * n, dtype)
    if name == 'threefry_jitter':
        # U read and written, the key read, the next key written; its
        # hashes are 32-bit integer work
        return bound_fields(2 * n * s + 4 * 8, OPS_PER_ELEM[name] * n,
                            'int32')
    raise KeyError(name)


# ----------------------------------------------------------------------
# phase 8: the grid-sharded solve (K7, K8, worlds of ranks)
# ----------------------------------------------------------------------

# block sums against the plain version: K3's tolerances (count exact); the
# blocks' sums in rank order against K3 on the whole field (only the
# float64 summation order differs)
SHARD_MESHES = ((2, 2), (1, 4), (4, 1))
SHARD_TOTAL_RTOL = {'float32': 1e-12, 'float64': 1e-13}
SHARD_NS = (4096, 512)
SHARD_REPORT = (4096, 'float32', (2, 2))   # the JSON line's K7/K8 rows
WORLD_SHAPE = (2, 2)
WORLD_FAST_N = 4096                        # (e)'s field


def block_halo(F, i, j, bn, bw):
    """Block (i, j) of F and its four halo vectors (edge-replicated at the
    global boundary, as the halo exchange delivers them)."""
    N = F.shape[0]
    r0, r1, c0, c1 = i * bn, (i + 1) * bn, j * bw, (j + 1) * bw
    return (F[r0:r1, c0:c1].contiguous(),
            (F[max(r0 - 1, 0), c0:c1].contiguous(),
             F[min(r1, N - 1), c0:c1].contiguous(),
             F[r0:r1, max(c0 - 1, 0)].contiguous(),
             F[r0:r1, min(c1, N - 1)].contiguous()))


def shard_kernel_phase(dev, card):
    """(a) K7 against its plain version on every block of 2x2, 1x4 and
    4x1 meshes, and the blocks' sums against K3 on the whole field; (b) K8
    against K1 on the same block."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N in SHARD_NS:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cfg, c, U, E, _, _ = kernel_inputs(N, dtype, dev)
            skw = dict(N=N, delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                       threshold=cfg.threshold)
            whole = K.stats_sums(U, E, cfg.A0, cfg.A1,
                                 **{k: v for k, v in skw.items()
                                    if k != 'N'})
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            for mx, my in SHARD_MESHES:
                bn, bw = N // mx, N // my
                total = None
                err = rel = 0.0
                for i in range(mx):
                    for j in range(my):
                        Ub, halo = block_halo(U, i, j, bn, bw)
                        Eb = block_halo(E, i, j, bn, bw)[0]
                        args = (Ub, *halo, Eb, cfg.A0, cfg.A1, i * bn,
                                j * bw)
                        got = K.local_band_sums(*args, **skw)
                        want = K.local_band_sums_ref(*args, **skw)
                        tile = K.stats_tile(
                            bn, bw, N, i * bn, j * bw, Ub.element_size(),
                            *(t.data_ptr() for t in (Ub, *halo[:2], Eb)))
                        prev = K._local_band_sums_launch(*args, tile,
                                                         prev=True, **skw)
                        torch.cuda.synchronize()
                        check(same_bits(got, prev),
                              f"K7 N={N} {dname} {mx}x{my} block ({i}, "
                              f"{j}): the body's sums differ from the "
                              f"parent body's")
                        d = (got - want).abs()
                        err = max(err, d.max().item())
                        rel = max(rel, (d / want.abs()).max().item())
                        check(got[3].item() == want[3].item(),
                              f"K7 N={N} {dname} {mx}x{my} block ({i}, "
                              f"{j}): count {got[3].item()} != "
                              f"{want[3].item()}")
                        # the ranks' order: (0, 0), (0, 1), ...
                        total = got if total is None else total + got
                total_rel = ((total - whole).abs() / whole.abs()).max().item()
                row = {'name': 'local_band_sums', 'N': N, 'dtype': dname,
                       'mesh': f'{mx}x{my}', 'block': f'{bn}x{bw}',
                       'max_abs_err': err, 'max_rel_err': rel,
                       'tolerance': f'rtol {rtol:g}, count exact; blocks '
                                    f'summed vs K3 rtol '
                                    f'{SHARD_TOTAL_RTOL[dname]:g}',
                       'total_vs_K3_max_rel': total_rel,
                       'ok': rel <= rtol
                       and total_rel <= SHARD_TOTAL_RTOL[dname]}
                if (mx, my) == (2, 2):
                    Ub, halo = block_halo(U, 0, 0, bn, bw)
                    Eb = block_halo(E, 0, 0, bn, bw)[0]
                    args = (Ub, *halo, Eb, cfg.A0, cfg.A1, 0, 0)
                    # fixed-order sums: the same bits every call
                    first = K.local_band_sums(*args, **skw)
                    row['same_bits_calls'] = DETERMINISM_CALLS
                    row['ok'] = row['ok'] and all(
                        torch.equal(K.local_band_sums(*args, **skw), first)
                        for _ in range(DETERMINISM_CALLS - 1))
                    row['tolerance'] += (f'; the same bits in '
                                         f'{DETERMINISM_CALLS} calls')
                    row.update(timed_row(
                        lambda: K.local_band_sums(*args, **skw),
                        lambda: K.local_band_sums_ref(*args, **skw)))
                    row.update(bound_fields(
                        *stats_bytes_ops(Ub), dname))
                    tile = K.stats_tile(
                        bn, bw, N, 0, 0, Ub.element_size(),
                        *(t.data_ptr() for t in (Ub, *halo[:2], Eb)))
                    row.update(body_turns(
                        '8 (a)', lambda: K.local_band_sums(*args, **skw),
                        lambda: K._local_band_sums_launch(
                            *args, tile, prev=True, **skw)))
                    # (b) K8 on the same block: K1's kernel, the same bits
                    b8 = K.chemical_potential_sharded(
                        None, Ub, cfg.RT, cfg.BRT, cfg.A0, cfg.A1)
                    k1 = K.chemical_potential(Ub, cfg.RT, cfg.BRT, cfg.A0,
                                              cfg.A1)
                    plain = K.chemical_potential_ref(Ub, cfg.RT, cfg.BRT,
                                                     cfg.A0, cfg.A1)
                    torch.cuda.synchronize()
                    same = bool(torch.equal(b8, k1))
                    mu_row = {
                        'name': 'chemical_potential_sharded', 'N': N,
                        'dtype': dname, 'mesh': '2x2', 'block': f'{bn}x{bw}',
                        'identical_to_K1': same,
                        'max_abs_err': (b8 - plain).abs().max().item(),
                        'tolerance': 'identical bits to K1 on the block',
                        'ok': same,
                        **timed_row(
                            lambda: K.chemical_potential_sharded(
                                None, Ub, cfg.RT, cfg.BRT, cfg.A0, cfg.A1),
                            lambda: K.chemical_potential_ref(
                                Ub, cfg.RT, cfg.BRT, cfg.A0, cfg.A1)),
                        **bound_fields(*mu_bytes_ops(Ub), dname)}
                    rows.append(mu_row)
                    print(f"kernel chemical_potential_sharded N={N} {dname} "
                          f"block {bn}x{bw}: identical to K1 {same}  kernel "
                          f"{mu_row['ms']:.4f} ms  plain "
                          f"{mu_row['plain_ms']:.4f} ms  bound "
                          f"{mu_row['bound_ms']:.4f} ms  ({card})",
                          flush=True)
                    check(same, f"K8 N={N} {dname}: bits differ from K1")
                rows.append(row)
                times = (f"  kernel {row['ms']:.4f} ms{body_text(row)}  "
                         f"plain {row['plain_ms']:.4f} ms  bound "
                         f"{row['bound_ms']:.4f} ms  ({card})"
                         if 'ms' in row else '')
                print(f"kernel local_band_sums N={N} {dname} {mx}x{my}: "
                      f"rel {rel:.3e}, blocks vs K3 {total_rel:.3e} "
                      f"{'ok' if row['ok'] else 'FAIL'}{times}", flush=True)
                check(row['ok'], f"K7 N={N} {dname} {mx}x{my}: rel {rel:.3e}"
                                 f", blocks vs K3 {total_rel:.3e}")
            rows += shard_whole_and_scalar(K, U, E, cfg, skw, whole, dname)
    return rows


def shard_whole_and_scalar(K, U, E, cfg, skw, whole, dname):
    """K7 on the whole field as one block against K3 (the same bits), and
    K7's one-column path against its plain version: a block whose W no
    vector width divides and a block whose up row starts 8 bytes past a
    16-byte boundary."""
    import torch
    N = U.shape[0]
    rows = []
    Ub, halo = block_halo(U, 0, 0, N, N)
    got = K.local_band_sums(Ub, *halo, E, cfg.A0, cfg.A1, 0, 0, **skw)
    torch.cuda.synchronize()
    same = torch.equal(got, whole)
    rows.append({'name': 'local_band_sums', 'N': N, 'dtype': dname,
                 'mesh': '1x1', 'block': f'{N}x{N}', 'identical_to_K3': same,
                 'max_abs_err': (got - whole).abs().max().item(),
                 'tolerance': "K3's bits", 'ok': same})
    print(f"kernel local_band_sums N={N} {dname} whole field as one block: "
          f"identical to K3 {same}", flush=True)
    check(same, f"K7 N={N} {dname} on the whole field: bits differ from K3")
    h = N // 2
    # a (h, h - 1) block at (0, h + 1): the global right edge, W odd
    odd = (U[:h, h + 1:].contiguous(),
           (U[0, h + 1:].contiguous(), U[h, h + 1:].contiguous(),
            U[:h, h].contiguous(), U[:h, N - 1].contiguous()),
           E[:h, h + 1:].contiguous(), 0, h + 1, 'odd W')
    # the (h, h) block at (h, 0) with its up row in an unaligned copy
    store = torch.empty(h + 1, dtype=U.dtype, device=U.device)
    up = store[1:]
    up.copy_(U[h - 1, :h])
    Ub, halo = block_halo(U, 1, 0, h, h)
    unaligned = (Ub, (up,) + halo[1:], block_halo(E, 1, 0, h, h)[0], h, 0,
                 'unaligned up row')
    rtol = 1e-12 if dname == 'float64' else 1e-5
    for Ub, halo, Eb, r0, c0, what in (odd, unaligned):
        vec = K.local_stats_grid(*Ub.shape, N, r0, c0, Ub.element_size(),
                                 *(t.data_ptr()
                                   for t in (Ub, halo[0], halo[1], Eb)))[0]
        args = (Ub, *halo, Eb, cfg.A0, cfg.A1, r0, c0)
        got = K.local_band_sums(*args, **skw)
        want = K.local_band_sums_ref(*args, **skw)
        torch.cuda.synchronize()
        d = (got - want).abs()
        rel = (d / want.abs()).max().item()
        ok = vec == 1 and rel <= rtol and got[3].item() == want[3].item()
        rows.append({'name': 'local_band_sums', 'N': N, 'dtype': dname,
                     'mesh': what, 'block': '%dx%d' % tuple(Ub.shape),
                     'vec': vec, 'max_abs_err': d.max().item(),
                     'max_rel_err': rel,
                     'tolerance': f'one-column path, rtol {rtol:g}, count '
                                  f'exact', 'ok': ok})
        print(f"kernel local_band_sums N={N} {dname} {what} block "
              f"{rows[-1]['block']} at ({r0}, {c0}): V={vec} rel {rel:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K7 N={N} {dname} {what}: V={vec}, rel {rel:.3e}")
    return rows


# phase 9 (d), run in phase 8's world: tests/test_combined_features.py's
# adaptive configuration, and the device Sobol jitter
ITEM7_WORLD = {
    'adaptive': {'N': 32, 'ntmax': 520, 'full_sim': True, 'generator': 'lcg',
                 'kappa_tilde': 2.98911291966116e-4, 'adaptive_time': True},
    'sobol_device': {'N': 32, 'ntmax': 100, 'full_sim': True,
                     'generator': 'sobol', 'jitter': 0.01,
                     'jitter_backend': 'device',
                     'kappa_tilde': 2.98911291966116e-4},
}


def world_tasks(ckpt):
    """(c) the canonical run (through the Solver: entered to
    MESH_CKPT_STEP, saving every 800 steps into ``ckpt``, then again to
    its stop: phase 14 (e) restores the file and is held to these rows),
    (e) N=4096 float32 over 64 steps plus a timed window of 64, and phase
    9 (d)'s runs."""
    canon = {'kappa_tilde': KAPPA, 'checkpoint_file': ckpt, **MESH_CKPT}
    fast = {'N': WORLD_FAST_N, 'precision': 'float32', 'full_sim': True,
            'generator': 'uniform', 'kappa_tilde': KAPPA, 'chunk_size': 64,
            'matmul_precision': 'highest'}
    return [('solve', {'params': canon, 'return_U': False,
                       'steps': [MESH_CKPT_STEP, int(1e6)]}),
            ('solve', {'params': fast, 'steps': 64, 'rate_steps': 64,
                       'return_U': False}),
            ('imported', {})] + [('solve', {'params': p})
                                 for p in ITEM7_WORLD.values()]


def check_world(tag, res, refs, card):
    """The world's results: the same bits on every rank; (c) stop 1674
    with the anchors, E within 1e-10 of the single-device run at every
    step, K7/K8 once per step per rank (+ prepare for K7); (e) E within
    1e-5 of float64 and 1e-6 of single-device float32, mean(U) held."""
    import numpy as np
    with open(os.path.join(ROOT, 'tests', 'golden',
                           'default_n512_anchors.json')) as f:
        g = json.load(f)
    canon = [r[0] for r in res]
    fast = [r[1] for r in res]
    for mods in (r[2] for r in res):
        check(not {'jax', 'jaxlib', 'chsimpy_tpu'} & set(mods),
              f"{tag}: a rank imported {mods}")
    check(all(np.array_equal(r['timedata'], canon[0]['timedata'])
              for r in canon), f"{tag} (c): ranks differ in their rows")
    check(all(np.array_equal(r['timedata'], fast[0]['timedata'])
              for r in fast), f"{tag} (e): ranks differ in their rows")
    c = canon[0]
    td = c['timedata']
    E1 = np.asarray(refs['E_single_n512'])
    n = min(len(td), len(E1))
    out = {'mesh': c['mesh'], 'computed_steps': c['computed_steps'],
           'stop_reason': c['stop_reason'], 'tau0': c['tau0'],
           'seconds': [r['seconds'] for r in canon],
           'launches': [r['launches'] for r in canon],
           'E_vs_single_max_rel': float(np.max(np.abs(td[:n, 1] / E1[:n]
                                                      - 1))),
           'E_every_100_max_rel': float(np.max(np.abs(
               td[::100, 1] / np.asarray(g['E_every_100']) - 1))),
           'E_last_rel': abs(td[-1, 1] / g['E_last'] - 1),
           'argmax_E2': int(td[:, 2].argmax())}
    print(f"{tag} (c) canonical run: " + json.dumps(
        {k: v for k, v in out.items() if k != 'launches'}), flush=True)
    check(c['computed_steps'] == 1674 and c['stop_reason'] == 'energy',
          f"{tag} (c): stop {c['computed_steps']} {c['stop_reason']}")
    check(len(td) == len(E1), f"{tag} (c): {len(td)} rows, single {len(E1)}")
    check(tuple(c['U_shape']) == (512, 512) and c['U_finite'],
          f"{tag} (c): the gathered field is not a finite (512, 512) one")
    check(c['tau0'] == g['tau0'] and abs(c['t0'] / g['t0'] - 1) <= 1e-12,
          f"{tag} (c): tau0/t0 differ from the golden")
    check(out['E_vs_single_max_rel'] <= 1e-10,
          f"{tag} (c): E {out['E_vs_single_max_rel']:.3e} from single")
    check(out['E_every_100_max_rel'] <= 1e-10 and out['E_last_rel'] <= 1e-10
          and out['argmax_E2'] == g['argmax_E2'],
          f"{tag} (c): golden anchors not held")
    # the first entry's chunks to MESH_CKPT_STEP, then the re-entry's to
    # the stop
    iterations = MESH_CKPT_STEP - 1 + iterations_run(
        1674, MESH_CKPT['chunk_size'], int(1e6), start=MESH_CKPT_STEP)
    for lc in out['launches']:
        check(lc['chemical_potential_sharded'] == iterations
              and lc['local_band_sums'] == iterations + 1
              and lc['spectral_update'] == iterations
              and lc['chemical_potential'] == 0 and lc['stats_sums'] == 0,
              f"{tag} (c): launches {lc}, {iterations} step iterations")
    out['iterations'] = iterations
    f = fast[0]
    E = f['timedata'][:, 1]
    rel64 = float(np.max(np.abs(E / np.asarray(refs['E_f64_4096']) - 1)))
    rel32 = float(np.max(np.abs(E / np.asarray(refs['E_f32_4096']) - 1)))
    drift = f['U_mean'] - refs['U0_mean_4096']
    out['n4096'] = {'E_vs_f64_max_rel': rel64,
                    'E_vs_single_f32_max_rel': rel32, 'U_mean': f['U_mean'],
                    'U_mean_drift': drift,
                    'steps_per_s': [r['steps_per_s'] for r in fast],
                    'seconds_64_steps': [r['seconds'] for r in fast],
                    'launches': [r['launches'] for r in fast]}
    print(f"{tag} (e) N={WORLD_FAST_N} float32 over 64 steps: E vs float64 "
          f"max rel "
          f"{rel64:.3e}, vs single-device float32 {rel32:.3e}; mean(U) "
          f"drift {drift:.3e}", flush=True)
    print(f"{tag} (e) steps/s N={WORLD_FAST_N} float32: "
          f"{f['steps_per_s']:.2f} "
          f"({c['mesh']}; ranks {WORLD_SHAPE[0] * WORLD_SHAPE[1]} on "
          f"{torch_cards()} card(s) — not a scaling figure)  ({card})",
          flush=True)
    check(len(E) == 64 and f['U_finite']
          and tuple(f['U_shape']) == (WORLD_FAST_N, WORLD_FAST_N),
          f"{tag} (e): rows or field")
    check(rel64 <= 1e-5, f"{tag} (e): E {rel64:.3e} from float64 (1e-5)")
    check(rel32 <= 1e-6, f"{tag} (e): E {rel32:.3e} from float32 (1e-6)")
    check(abs(drift) <= 1e-6, f"{tag} (e): mean(U) drifted {drift:.3e}")
    return out


def torch_cards() -> int:
    import torch
    return torch.cuda.device_count()


# (d)'s canonical stop: N=512 from the seeded uniform field
WORLD_CLI_STOP = 1674


def world_cli(backend, device):
    """(d) the canonical run through torchrun and the CLI: rank 0 prints
    the stop line; K7 and K8 launched on every step."""
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc-per-node', str(WORLD_SHAPE[0] * WORLD_SHAPE[1]), '-m',
           'chsimpy_tpu_torch', '--mesh', '%dx%d' % WORLD_SHAPE, '-N', '512',
           '--no-gui', '-K', repr(KAPPA), '--dist-backend', backend,
           '--device', device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"torchrun exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
          f"{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('computed_steps = ')]
    check(len(lines) == 1, f"torchrun: {len(lines)} stop lines")
    check(lines[0].startswith(f'computed_steps = {WORLD_CLI_STOP},')
          and lines[0].endswith('stop reason = energy'),
          f"torchrun: {lines[0]}")
    m = re.search(r'kernel launches: (\{.*\})', proc.stdout)
    check(m is not None, 'torchrun: no kernel launch counts')
    launches = json.loads(m.group(1))
    check(launches['local_band_sums'] >= WORLD_CLI_STOP - 1
          and launches['chemical_potential_sharded'] >= WORLD_CLI_STOP - 1,
          f"torchrun: launches {launches}")
    mesh_line = next(ln for ln in proc.stdout.splitlines()
                     if ln.startswith('mesh '))
    print(f"torchrun {backend}: {lines[0]}; {mesh_line}; "
          f"{seconds:.1f} s (processes included)", flush=True)
    return {'stop_line': lines[0], 'mesh': mesh_line, 'seconds': seconds,
            'launches': launches}


def sharded_phase(dev, card, refs):
    from chsimpy_tpu_torch.parallel.distributed import spawn_grid
    from chsimpy_tpu_torch.parallel.workers import run_tasks

    out = {'kernels': shard_kernel_phase(dev, card)}
    t0 = time.perf_counter()
    ckpt = os.path.join(kept_dir(), 'mesh.npz')
    res = spawn_grid(run_tasks, WORLD_SHAPE, backend='gloo',
                     device=dev.type, args=(world_tasks(ckpt),), timeout=900)
    out['gloo'] = check_world('world gloo', res, refs, card)
    keep_mesh_run(res, ckpt)
    out['gloo']['world_seconds'] = time.perf_counter() - t0
    out['item7_world'] = check_item7_world('world gloo', res)
    out['cli'] = world_cli('gloo', dev.type)
    if torch_cards() >= WORLD_SHAPE[0] * WORLD_SHAPE[1]:
        res = spawn_grid(run_tasks, WORLD_SHAPE, backend='nccl',
                         device='cuda', args=(world_tasks(os.path.join(
                             kept_dir(), 'mesh-nccl.npz')),), timeout=900)
        out['nccl'] = check_world('world nccl', res, refs, card)
        out['nccl']['item7'] = check_item7_world('world nccl', res)
    else:
        out['nccl'] = None
        print(f"phase 8 (f): the NCCL world did not run: "
              f"{torch_cards()} card(s), and NCCL takes one card per rank "
              f"({WORLD_SHAPE[0] * WORLD_SHAPE[1]} needed)", flush=True)
    return out


# ----------------------------------------------------------------------
# phase 9: adaptive time stepping, per-step jitter, the sobol and simplex
# generators, and the Sobol jitter kernel K9
# ----------------------------------------------------------------------

SOBOL_NS = (4096, 1000, 512)
SOBOL_JITTER = 0.01
SOBOL_REPORT = (4096, 'float32', 'zero')   # the JSON line's K9 row


def sobol_bases(N):
    """Draw bases of (a): the first point, the step after one draw of N
    points, and N/2 rows before 2^32 (the walk wraps inside the field)."""
    return {'zero': 0, 'one_draw': N, 'wrap': 2 ** 32 - N // 2}


def sobol_phase(dev, card):
    """(a) K9 against its plain version to the bit, on the field and on
    the (1, 1) block of a 2x2 mesh (offsets N/2, N/2), one count a call;
    both timed at base 0."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.ops import kernels as K
    from chsimpy_tpu_torch.ops import sobol

    rows = []
    for N in SOBOL_NS:
        sv_np, sh_np = sobol.sobol_tables(N, 2023)
        sv = torch.tensor(sv_np.astype(np.int64), device=dev)
        sh = torch.tensor(sh_np.astype(np.int64), device=dev)
        h = N // 2
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            U = torch.tensor(0.875 + 0.01 * (np.random.default_rng(N).random(
                (N, N)) - 0.5), dtype=dtype, device=dev)
            blk = U[h:, h:].contiguous()
            for where, base in sobol_bases(N).items():
                b = torch.tensor(base, device=dev)
                K.reset_launches()
                got = K.sobol_jitter(U.clone(), sv, sh, b, SOBOL_JITTER)
                gblk = K.sobol_jitter(blk.clone(), sv, sh, b, SOBOL_JITTER,
                                      h, h)
                counted = K.launches['sobol_jitter']
                want = K.sobol_jitter_ref(U.clone(), sv, sh, b, SOBOL_JITTER)
                wblk = K.sobol_jitter_ref(blk.clone(), sv, sh, b,
                                          SOBOL_JITTER, h, h)
                torch.cuda.synchronize()
                err = max((got - want).abs().max().item(),
                          (gblk - wblk).abs().max().item())
                ok = (torch.equal(got, want) and torch.equal(gblk, wblk)
                      and counted == 2)
                row = {'name': 'sobol_jitter', 'N': N, 'dtype': dname,
                       'base': base, 'where': where, 'max_abs_err': err,
                       'tolerance': 'bit-identical field and (1, 1) block '
                                    'of a 2x2 mesh, one count a call',
                       'ok': ok}
                if where == 'zero':
                    V = U.clone()   # K9 is in place: the timed calls add up
                    row.update(timed_row(
                        lambda: K.sobol_jitter(V, sv, sh, b, SOBOL_JITTER),
                        lambda: K.sobol_jitter_ref(V, sv, sh, b,
                                                   SOBOL_JITTER)))
                    row.update(kernel_bound('sobol_jitter', N, dname))
                    row['bound_share'] = row['bound_ms'] / row['ms']
                rows.append(row)
                times = (f"  kernel {row['ms']:.4f} ms (one call "
                         f"{row['call_ms']:.4f})  plain {row['plain_ms']:.4f}"
                         f" ms  bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_share']:.0%})  ({card})"
                         if 'ms' in row else '')
                print(f"kernel sobol_jitter N={N:5d} {dname:8s} base "
                      f"{base} ({where}): max diff {err:.3e} "
                      f"{'ok' if ok else 'FAIL'}{times}", flush=True)
                check(ok, f"sobol_jitter N={N} {dname} base {base}: differs "
                          f"by {err:.3e} ({counted} counts)")
    return rows


THREEFRY_NS = (4096, 1000, 1001, 512)
THREEFRY_REPORT = (4096, 'float32')         # the JSON line's K10 row
# K10 on a zero field with jitter 0.5 (r - 0.5, exact) at N=4096, steps 1
# and 2 of seed 2023: the first and the last value, jax.random's
# (pinned by tests/test_torch_experiment.py)
K10_LITERAL_N = 4096
K10_LITERALS = {
    1: {'float32': (0.49181878566741943, 0.23713326454162598),
        'float64': (0.20596503892135498, 0.09468211888864819)},
    2: {'float32': (-0.2964421510696411, 0.3008319139480591),
        'float64': (-0.3081856423477558, 0.2612592445365276)},
}


def threefry_phase(dev, card):
    """(a) K10 against its plain version to the bit, on the field and on
    the (1, 1) block of a 2x2 mesh (offsets N//2), the next key too, one
    count a call; its values at steps 1 and 2 of seed 2023 against
    jax.random's (K10_LITERALS); both versions timed at N=4096."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.core.state import jax_prng_key
    from chsimpy_tpu_torch.ops import kernels as K

    key = torch.tensor(jax_prng_key(2023).astype(np.int64), device=dev)
    rows = []
    for N in THREEFRY_NS:
        h = N // 2
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            U = torch.tensor(0.875 + 0.01 * (np.random.default_rng(N).random(
                (N, N)) - 0.5), dtype=dtype, device=dev)
            blk = U[h:, h:].contiguous()
            k1, k2, w1, w2 = (torch.empty_like(key) for _ in range(4))
            K.reset_launches()
            got = K.threefry_jitter(U.clone(), key, k1, SOBOL_JITTER, N)
            gblk = K.threefry_jitter(blk.clone(), key, k2, SOBOL_JITTER, N,
                                     h, h)
            counted = K.launches['threefry_jitter']
            want = K.threefry_jitter_ref(U.clone(), key, w1, SOBOL_JITTER, N)
            wblk = K.threefry_jitter_ref(blk.clone(), key, w2, SOBOL_JITTER,
                                         N, h, h)
            torch.cuda.synchronize()
            err = max((got - want).abs().max().item(),
                      (gblk - wblk).abs().max().item())
            ok = (torch.equal(got, want) and torch.equal(gblk, wblk)
                  and torch.equal(k1, w1) and torch.equal(k2, w1)
                  and counted == 2)
            row = {'name': 'threefry_jitter', 'N': N, 'dtype': dname,
                   'max_abs_err': err,
                   'tolerance': 'bit-identical field, (1, 1) block of a 2x2 '
                                'mesh and next key, one count a call',
                   'ok': ok}
            if N == K10_LITERAL_N:
                # steps 1 and 2 from PRNGKey(2023) on a zero field
                prev, vals = key, {}
                for step in (1, 2):
                    nxt = torch.empty_like(key)
                    Z = K.threefry_jitter(torch.zeros_like(U), prev, nxt,
                                          0.5, N)
                    vals[step] = (Z[0, 0].item(), Z[-1, -1].item())
                    prev = nxt
                lit = {st: K10_LITERALS[st][dname] for st in (1, 2)}
                row['literals_steps_1_2'] = vals
                row['literals_ok'] = vals == lit
                ok = ok and row['literals_ok']
                V = U.clone()   # K10 is in place: the timed calls add up
                row.update(timed_row(
                    lambda: K.threefry_jitter(V, key, k1, SOBOL_JITTER, N),
                    lambda: K.threefry_jitter_ref(V, key, w1, SOBOL_JITTER,
                                                  N)))
                row.update(kernel_bound('threefry_jitter', N, dname))
                row['bound_share'] = row['bound_ms'] / row['ms']
                row['int32_clock_hz'] = INT32_CLOCK_HZ
                # what the device jitter ran before K10: torch.rand and
                # the update's eager passes (another stream)
                row['before_ms'] = device_ms(
                    lambda: V + SOBOL_JITTER * (2.0 * torch.rand(
                        (N, N), dtype=dtype, device=dev) - 1.0))
            rows.append(row)
            times = (f"  kernel {row['ms']:.4f} ms (one call "
                     f"{row['call_ms']:.4f})  plain {row['plain_ms']:.4f} ms"
                     f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                     f"{row['bound_share']:.0%}); before (torch.rand and "
                     f"passes) {row['before_ms']:.4f} ms; steps 1-2 = "
                     f"jax.random: "
                     f"{row['literals_ok']}  ({card})"
                     if 'ms' in row else '')
            print(f"kernel threefry_jitter N={N:5d} {dname:8s}: max diff "
                  f"{err:.3e} {'ok' if ok else 'FAIL'}{times}", flush=True)
            check(ok, f"threefry_jitter N={N} {dname}: differs by {err:.3e} "
                      f"({counted} counts), literals "
                      f"{row.get('literals_steps_1_2')}")
    return rows


# (b): name, route, rtol E, delt, E2 (tests/test_golden.py:46-62); the
# jitter goldens hold tests/test_golden_extra.py's E 1e-11 (sobol: E2 1e-4)
ITEM7_GOLDENS = (
    ('n64_sobol_100', 'matmul', 1e-11, 1e-12, 1e-6),
    ('n64_adaptive_400', 'matmul', 1e-11, 1e-11, 1e-6),
    ('n64_adaptive_floor_600', 'matmul', 1e-11, 1e-12, 1e-6),
    ('n64_adaptive_600', 'matmul', 1e-8, 1e-6, 1e-4),
    ('n64_adaptive_600', 'split', 1e-8, 1e-6, 1e-4),
    ('n64_adaptive_600', 'fft', 1e-8, 1e-6, 1e-4),
    # untrimmed forward pairs: the default trim lands 1.6e-7 from this
    # chaotic golden in the JAX package too
    ('n64_adaptive_600', 'ozaki', 1e-8, 1e-6, 1e-4),
    ('n64_jitter_100', 'matmul', 1e-11, None, None),
    ('n64_sobol_jitter_100', 'matmul', 1e-11, None, 1e-4),
    ('n64_simplex_jitter_100', 'matmul', 1e-11, None, None),
)


def item7_run(name, **extra):
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator
    g = load_golden(name)
    p = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA,
                   **g['config'])
    for k, v in extra.items():
        setattr(p, k, v)
    sim = Simulator(p)
    sol = sim.solve()
    torch.cuda.synchronize()
    return g, sim, sol


def item7_goldens():
    """(b) the seven goldens of item 7 on the card (float64), the chaotic
    one on every route, and the device Sobol jitter against the host
    stream, U and rows to the bit."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    out = []
    for name, route, rE, rdelt, rE2 in ITEM7_GOLDENS:
        extra = {'transform_backend': route}
        if route == 'ozaki':
            extra['ozaki_fwd_pairs'] = (5, 7)
        g, sim, sol = item7_run(name, **extra)
        td = sol.timedata.data()
        U = sol.U.cpu().numpy()
        rel = {'E': float(np.max(np.abs(td[:, 1] / np.asarray(g['E']) - 1)))}
        if rdelt is not None:
            rel['delt'] = float(np.max(np.abs(td[:, 8]
                                              / np.asarray(g['delt']) - 1)))
        if rE2 is not None:
            rel['E2'] = float(np.max(np.abs(td[:, 2] / np.asarray(g['E2'])
                                            - 1)))
        rel['U_sum'] = abs(float(np.sum(U)) / g['U_sum'] - 1)
        bounds = {'E': rE, 'delt': rdelt, 'E2': rE2, 'U_sum': 1e-12}
        ok = (sol.computed_steps == g['computed_steps']
              and len(td) == len(g['E'])
              and all(v <= bounds[k] for k, v in rel.items()))
        if rdelt is not None:
            ok = ok and (sol.stop_reason == g['stop_reason']
                         and sol.tau0 == g['tau0']
                         and np.array_equal(td[:, 0], np.asarray(g['it'])))
        if name in ('n64_sobol_100', 'n64_sobol_jitter_100') \
                or rdelt is not None:
            rel['U_corner'] = float(np.max(np.abs(
                U[:2, :2] / np.asarray(g['U_corner']) - 1)))
            ok = ok and rel['U_corner'] <= 1e-5
        res = {'golden': name, 'route': route,
               'jitter_mode': sim.solver.cfg.jitter_mode,
               'computed_steps': sol.computed_steps, 'max_rel': rel,
               'bounds': bounds, 'ok': ok}
        out.append(res)
        print(f"item 7 golden {name} on {route}: {json.dumps(res)}",
              flush=True)
        check(ok, f"item 7 golden {name} on {route}: {rel} (bounds "
                  f"{bounds}), {sol.computed_steps} steps")
    g, _, host = item7_run('n64_sobol_jitter_100')
    K.reset_launches()
    _, sim, dev = item7_run('n64_sobol_jitter_100', jitter_backend='device')
    n = K.launches['sobol_jitter']
    same = (torch.equal(dev.U, host.U)
            and np.array_equal(dev.timedata.data(), host.timedata.data()))
    res = {'golden': 'n64_sobol_jitter_100', 'route': 'matmul',
           'jitter_mode': sim.solver.cfg.jitter_mode,
           'U_and_rows_equal_host': same, 'sobol_jitter_launches': n}
    out.append(res)
    print(f"item 7 device Sobol jitter vs host stream: {json.dumps(res)}",
          flush=True)
    check(sim.solver.cfg.jitter_mode == 'device_sobol' and same
          and n == g['computed_steps'] - 1,
          f"device Sobol jitter: bits equal {same}, {n} launches")
    return out


# the adaptive delt is delt_max times a column SUM over N rows of
# 1 / sqrt(1 + α·E²), so it grows with N: with the default delt_max (9e-8)
# the first adapted step of this run would take thousands of times the
# base delt and the field turns NaN after step 500, in the JAX package
# too (ROADMAP.md queue C).  (c) runs -a with a delt_max that puts the
# first adapted delt ~1.5 times the base (> 1.15: the blend branch; the
# column sum there is recorded); the steps run the same passes whatever
# delt is
ITEM7_DELT_MAX = 2.4e-11
ITEM7_N4096 = {
    '-a': {'adaptive_time': True, 'delt_max': ITEM7_DELT_MAX},
    '-j 0.01 -g sobol --jitter-backend device': {
        'jitter': 0.01, 'generator': 'sobol', 'jitter_backend': 'device'},
    '-j 0.01 --jitter-backend device': {
        'jitter': 0.01, 'jitter_backend': 'device'},
}
ITEM7_WARM = 512          # steps before the window: adaptation starts at 501
ITEM7_WINDOW = 256


def item7_layers(solver):
    """Per-layer times of one step (CUDA events, one call): the adaptive
    delt, the coefficient rebuild, the jitter, the whole step."""
    from chsimpy_tpu_torch.core import stepper
    cfg, c, s = solver.cfg, solver._consts, solver._state
    E = stepper._nonlinear_term(cfg, c, s.U)
    out = {}
    if cfg.adaptive_time:
        delt = stepper.adapted_delt(cfg, s, E)
        out['adaptive_delt'] = call_ms(
            lambda: stepper.adapted_delt(cfg, s, E))
        out['coefficient_rebuild'] = call_ms(
            lambda: stepper.rebuilt_coefficients(cfg, c, delt))
    if cfg.jitter_mode != 'none':
        V = s.U.clone()
        go = s.stop_reason == 0
        out['jitter_' + cfg.jitter_mode] = call_ms(
            lambda: stepper._jitter(cfg, c, s, V, None, go))
    out['whole_step'] = call_ms(lambda: stepper._step(cfg, c, s), reps=20)
    return out


def item7_n4096(card, fixed_rate):
    """(c) N=4096 float32 full_sim on the matmul route: steps/s of a
    window of 256 steps after step 512 with -a, with the device Sobol
    jitter and with the device uniform jitter, beside phase 5's fixed-delt
    rate; delt moved after step 500 and mean(U) held under -a; K9 launched
    on every step of the Sobol run, K10 on every step of the uniform one
    (their counts in the JSON line)."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.solver import Solver
    from chsimpy_tpu_torch.ops import kernels as K

    out = {'fixed_delt_steps_per_s_phase5': fixed_rate}
    for tag, kw in ITEM7_N4096.items():
        p = Parameters(N=4096, precision='float32', full_sim=True,
                       generator='uniform', kappa_tilde=KAPPA,
                       chunk_size=ITEM7_WINDOW, no_gui=True, device='cuda',
                       transform_backend='matmul',
                       matmul_precision='highest')
        for k, v in kw.items():
            setattr(p, k, v)
        s = Solver(p)
        s.prepare()
        U0 = s.solution.U.double().mean().item()
        K.reset_launches()
        # to step 501, the column sum there, then to the window's start
        s.solve_or_resume(501)
        colsum = item7_column_sum(s) if p.adaptive_time else None
        s.solve_or_resume(ITEM7_WARM - 501)
        r = rate(s, ITEM7_WINDOW)
        launches = dict(K.launches)
        td = s.solution.timedata.data()
        mean = s.solution.U.double().mean().item()
        iterations = ITEM7_WARM - 1 + ITEM7_WINDOW
        res = {'steps_per_s': r, 'window': ITEM7_WINDOW,
               'window_after_step': ITEM7_WARM,
               'jitter_mode': s.cfg.jitter_mode,
               'delt_first': float(td[0, 8]), 'delt_last': float(td[-1, 8]),
               'U_mean_initial': U0, 'U_mean': mean, 'launches': launches,
               'iterations': iterations, 'layers_ms': item7_layers(s)}
        if p.adaptive_time:
            res.update(delt_max=p.delt_max, column_sum_min_step_501=colsum,
                       delt_step_502_over_base=float(td[502, 8] / td[0, 8]),
                       default_delt_max_first_delt_over_base=(
                           Parameters().delt_max * colsum / p.delt))
        out[tag] = res
        print(f"N=4096 float32 {tag}: {r:.2f} steps/s over steps "
              f"{ITEM7_WARM + 1}-{ITEM7_WARM + ITEM7_WINDOW} (fixed delt, "
              f"phase 5: {fixed_rate:.2f}); delt {td[0, 8]:.6e} -> "
              f"{td[-1, 8]:.6e}; mean(U) {mean!r} (initial {U0!r}); layers "
              + ', '.join(f"{k} {v:.4f} ms"
                          for k, v in res['layers_ms'].items())
              + f"  ({card})", flush=True)
        check(len(td) == iterations + 1
              and bool(torch.isfinite(s.solution.U).all()),
              f"N=4096 {tag}: rows or field")
        for name in MATMUL_PATH:
            check(launches[name] >= iterations,
                  f"N=4096 {tag}: {name} launched {launches[name]} times")
        if kw.get('adaptive_time'):
            check(np.any(td[ITEM7_WARM - 10:, 8] != td[0, 8])
                  and np.all(td[:500, 8] == td[0, 8]),
                  f"N=4096 -a: delt did not move after step 500 only")
            check(abs(mean - U0) <= 1e-6,
                  f"N=4096 -a: mean(U) drifted {mean - U0:.3e}")
        for name, mode in (('sobol_jitter', 'device_sobol'),
                           ('threefry_jitter', 'device')):
            expect = iterations if s.cfg.jitter_mode == mode else 0
            check(launches[name] == expect,
                  f"N=4096 {tag}: {name} launched {launches[name]} times, "
                  f"not {expect}")
        del s
        torch.cuda.empty_cache()
    return out


def item7_column_sum(solver):
    """The least column sum of 1 / sqrt(1 + α·E²) of the solver's field,
    in float64: the adapted delt of the next even step over delt_max."""
    import torch
    from chsimpy_tpu_torch.core import stepper
    E = stepper._nonlinear_term(solver.cfg, solver._consts,
                                solver._state.U).double()
    return torch.min(torch.sum(
        1.0 / torch.sqrt(1.0 + stepper.ADAPT_ALPHA * E * E), dim=0)).item()


def check_item7_world(tag, res):
    """(d) phase 9's runs in phase 8's world against one device on the
    card: delt within 1e-9, E within 1e-10, the same rows on every rank."""
    import numpy as np
    from chsimpy_tpu_torch import Parameters, Simulator
    from chsimpy_tpu_torch.ops import kernels as K

    out = {}
    for k, (case, params) in enumerate(ITEM7_WORLD.items()):
        ranks = [r[3 + k] for r in res]
        K.reset_launches()
        single = Simulator(Parameters(no_gui=True, device='cuda',
                                      **params)).solve()
        td, td1 = ranks[0]['timedata'], single.timedata.data()
        same = all(np.array_equal(r['timedata'], td) for r in ranks)
        rel = {'delt': float(np.max(np.abs(td[:, 8] / td1[:, 8] - 1))),
               'E': float(np.max(np.abs(td[:, 1] / td1[:, 1] - 1))),
               'U': float(np.max(np.abs(ranks[0]['U']
                                        - single.U.cpu().numpy())))}
        res_k = {'case': case, 'computed_steps': ranks[0]['computed_steps'],
                 'max_rel_vs_single': rel, 'same_rows_every_rank': same,
                 'delt_moved': bool(td[-1, 8] != td[0, 8]),
                 'launches_rank0': ranks[0]['launches'],
                 'seconds': [r['seconds'] for r in ranks]}
        out[case] = res_k
        print(f"{tag} phase 9 (d) {case}: {json.dumps(res_k)}", flush=True)
        check(same and len(td) == len(td1) and rel['delt'] <= 1e-9
              and rel['E'] <= 1e-10,
              f"{tag} phase 9 (d) {case}: {rel}, same rows {same}")
        if case == 'adaptive':
            check(res_k['delt_moved'], f"{tag} (d): delt never moved")
        else:
            check(ranks[0]['launches']['sobol_jitter'] == params['ntmax'] - 1,
                  f"{tag} (d): K9 launches {ranks[0]['launches']}")
    return out


def item7_phase(dev, card, fixed_rate):
    out = {'sobol_kernel': sobol_phase(dev, card),
           'threefry_kernel': threefry_phase(dev, card)}
    t0 = time.perf_counter()
    out['goldens'] = item7_goldens()
    out['n4096'] = item7_n4096(card, fixed_rate)
    out['seconds_b_to_c'] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 10: the member-batched ensemble (K1-K4 for R members in one
# launch each), checkpoints and the CLI's exports
# ----------------------------------------------------------------------

# the member-batched kernels and the single-field kernel each one extends
# (the JAX ensemble vmaps the same Pallas kernels over its member axis)
MEMBER_KERNELS = {'chemical_potential_members': 'chemical_potential',
                  'spectral_update_members': 'spectral_update',
                  'stats_sums_members': 'stats_sums',
                  'absdev_sum_members': 'absdev_sum'}
# (a): (R, N, dtype) of the batched launches; the JSON line's rows are the
# canonical batch's shape
MEMBER_SHAPES = ((16, 512, 'float64'), (16, 512, 'float32'),
                 (4, 4096, 'float32'), (4, 4096, 'float64'))
MEMBER_REPORT = (16, 512, 'float64')
# (b): the canonical UQ batch of the JAX experiment (A factors in
# [0.995, 1.005] from PCG64(85972), chsimpy_tpu/experiment.py:153-180,
# 464-468) and the members' kappa_tilde, the sympy common-tangent solve of
# each (A0, A1) (pinned by tests/test_torch_ensemble.py: the card's
# machine has no sympy)
CANONICAL_A_SEED = 85972
CANONICAL_KAPPAS = (0.00031265939230567846, 0.00029492551257139036,
                    0.00026709268342122003, 0.0003123359193314077,
                    0.0003865912887370596, 0.00029681491195003606,
                    0.00031215609936870354, 0.00026274837504202054,
                    0.000351306290558011, 0.0002604288804095901,
                    0.00034803164344450493, 0.00035838595210251984,
                    0.00034111541458706007, 0.00031366579393963276,
                    0.00025791626846952473, 0.00032044238344307595)
# (c): members, steps (a warm-up of ENS_WARM, then the timed window)
ENS_4096 = (4, 256)
ENS_WARM = 16


def canonical_pairs(runs=16):
    """The canonical batch's (A0, A1) pairs: the JAX experiment's uniform
    factors times the default A0(T), A1(T)."""
    import numpy as np
    from chsimpy_tpu_torch import Parameters
    p = Parameters()
    rng = np.random.Generator(np.random.PCG64(CANONICAL_A_SEED))
    f = np.transpose(rng.uniform(0.995, 1.005, size=(runs, 2)))
    return np.stack([f[0] * p.func_A0(p.temp), f[1] * p.func_A1(p.temp)],
                    axis=1)


def member_bound(name, R, N, dtype):
    """bound_fields of a batched launch: R fields, each member's scalars
    (A0/A1, the mean) and results; K2's shared Seig read once."""
    n = N * N
    s = 4 if dtype == 'float32' else 8
    if name == 'chemical_potential_members':
        return bound_fields(2 * R * n * s + 2 * R * 8,
                            OPS_PER_ELEM['chemical_potential'] * R * n, dtype)
    if name == 'spectral_update_members':
        return bound_fields((4 * R + 1) * n * s,
                            OPS_PER_ELEM['spectral_update'] * R * n, dtype)
    if name == 'stats_sums_members':
        return bound_fields(2 * R * n * s + R * (2 * 8 + 5 * 8),
                            OPS_PER_ELEM['stats'] * R * n, dtype)
    if name == 'absdev_sum_members':
        # with each member's Ra in the second pass: one more row of N
        # read, one more double written, 5 N operations (K11's)
        return bound_fields(R * n * s + R * s + R * 8 + R * N * s + R * 8,
                            OPS_PER_ELEM['absdev_sum'] * R * n + 5 * R * N,
                            dtype)
    raise KeyError(name)


def member_inputs(R, N, dtype, dev):
    """Seeded member fields and operands on the card: U (R, N, N) near
    the mean concentration, the canonical pairs' A0/A1, EnergieEut, random
    spectral operands, the members' CHeig and the shared Seig."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.stepper import StepConfig, make_members_consts
    from chsimpy_tpu_torch.derived import Derived
    from chsimpy_tpu_torch.ops import kernels as K

    p = Parameters(N=N, kappa_tilde=KAPPA)
    d = Derived.from_params(p)
    cfg = StepConfig(N=N, dtype=str(dtype)[6:], RT=d.RT, BRT=d.BRT, B=p.B,
                     Amr=d.Amr, L=p.L, delx=d.delx, delx2=d.delx2,
                     M_tilde=p.M_tilde, threshold=p.threshold)
    pairs = canonical_pairs(R)
    c = make_members_consts(cfg, p.delt, pairs[:, 0], pairs[:, 1],
                            np.asarray(CANONICAL_KAPPAS[:R]), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(N + R)
    U = 0.875 + 0.01 * (torch.rand((R, N, N), generator=g, dtype=dtype,
                                   device=dev) - 0.5)
    hat_U = torch.randn((R, N, N), generator=g, dtype=dtype, device=dev)
    hat_E = torch.randn((R, N, N), generator=g, dtype=dtype, device=dev)
    E = K.chemical_potential_members_ref(U, cfg.RT, cfg.BRT, c['A0'],
                                         c['A1'])
    mean = (U.double().sum((1, 2)) / (N * N)).to(dtype)
    return cfg, c, U, E, hat_U, hat_E, mean


def member_kernel_phase(dev, card):
    """(a) each batched kernel against its plain version (phase 3's
    tolerances) and, member by member, against the single-field launch on
    the member's field with its scalars: the same bits; one count a
    batched call; device ms of the batched launch and of R single
    launches, the plain version's, and the bound."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for R, N, dname in MEMBER_SHAPES:
        t0 = time.perf_counter()
        dtype = getattr(torch, dname)
        f64 = dtype == torch.float64
        cfg, c, U, E, hat_U, hat_E, mean = member_inputs(R, N, dtype, dev)
        skw = dict(delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                   threshold=cfg.threshold)
        A0s, A1s = c['A0'], c['A1']
        a0 = A0s.tolist()
        a1 = A1s.tolist()
        CH, S = c['CHeig'], c['Seig']
        cases = {
            'chemical_potential_members': (
                lambda: K.chemical_potential_members(U, cfg.RT, cfg.BRT,
                                                     A0s, A1s),
                lambda: K.chemical_potential_members_ref(U, cfg.RT, cfg.BRT,
                                                         A0s, A1s),
                lambda r: K.chemical_potential(U[r], cfg.RT, cfg.BRT, a0[r],
                                               a1[r])),
            'spectral_update_members': (
                lambda: K.spectral_update_members(hat_U, hat_E, S, CH),
                lambda: K.spectral_update_members_ref(hat_U, hat_E, S, CH),
                lambda r: K.spectral_update(hat_U[r], hat_E[r], S, CH[r])),
            'stats_sums_members': (
                lambda: K.stats_sums_members(U, E, A0s, A1s, **skw),
                lambda: K.stats_sums_members_ref(U, E, A0s, A1s, **skw),
                lambda r: K.stats_sums(U[r], E[r], a0[r], a1[r], **skw)),
            # the step's K4_members: each member's Ra (K11's body on row
            # N/2+1) in its second pass
            'absdev_sum_members': (
                lambda: K.absdev_ra_members(U, mean, U, N // 2 + 1)[0],
                lambda: K.absdev_ra_members_ref(U, mean, U, N // 2 + 1)[0],
                lambda r: K.absdev_sum(U[r], mean[r])),
        }
        for name, (kern, ref, single) in cases.items():
            K.reset_launches()
            got = kern()
            counted = K.launches[name]
            want = ref()
            torch.cuda.synchronize()
            same = all(torch.equal(got[r], single(r)) for r in range(R))
            diff = (got.double() - want.double()).abs()
            err = diff.max().item()
            scale = want.double().abs()
            rel = err / scale.max().item()
            if name == 'chemical_potential_members':
                bound = 1e-12 * scale.max().item() if f64 else 1e-4
                ok = err <= bound
                tol = '1e-12 x max|ref|' if f64 else 'atol 1e-4'
            else:
                rtol = 1e-12 if f64 else (
                    1e-6 if name == 'spectral_update_members' else 1e-5)
                ok = bool((diff <= rtol * scale).all())
                tol = f'rtol {rtol:g}'
            ok = ok and same and counted == 1
            tol += (', each member the single launch\'s bits, one count a '
                    'call')
            row = {'name': name, 'R': R, 'N': N, 'dtype': dname,
                   'max_abs_err': err, 'max_rel_err': rel,
                   'members_equal_single_launch': same, 'tolerance': tol,
                   'ok': ok, **timed_row(kern, ref),
                   'single_launches_ms': device_ms(
                       lambda: [single(r) for r in range(R)]),
                   **member_bound(name, R, N, dname)}
            if name == 'absdev_sum_members':
                row.update(fused_ra_turns('10 (a)', U, mean, U,
                                          N // 2 + 1))
            if name == 'stats_sums_members':
                row.update(stats_turns(
                    '10 (a)', kern, N, N, U, E,
                    lambda t, prev=False: K._stats_sums_members_launch(
                        U, E, A0s, A1s, t, prev=prev, **skw)))
            row['bound_share'] = row['bound_ms'] / row['ms']
            rows.append(row)
            print(f"kernel {name:27s} R={R:2d} N={N:5d} {dname:8s} "
                  f"err={err:.3e} rel={rel:.3e} members=single "
                  f"{'yes' if same else 'NO'} ({tol}) "
                  f"{'ok' if ok else 'FAIL'}  kernel {row['ms']:.4f} ms "
                  f"(one call {row['call_ms']:.4f}; {R} single launches "
                  f"{row['single_launches_ms']:.4f})  plain "
                  f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms"
                  f" ({row['bound_by']}, {row['bound_share']:.0%})"
                  + (f"  tile {row['tile']} (the fixed tile "
                     f"{row['earlier_tile']}) {turns_text(row)}"
                     + body_text(row) if 'tile' in row else '')
                  + (f"  with Ra; K4 + K11 {row['k4_k11_ms']:.4f} ms, the "
                     f"same bits, turns {row['k4_k11_ms_turns']} / "
                     f"{row['ms_fused_turns']}" if 'k4_k11_ms' in row
                     else '') + f"  ({card})",
                  flush=True)
            check(ok, f"{name} R={R} N={N} {dname}: error {err:.3e} "
                      f"outside {tol}, members equal {same}, {counted} "
                      f"counts")
        del U, E, hat_U, hat_E, c
        torch.cuda.empty_cache()
        if (R, N, dname) == (16, 512, 'float32'):
            spent('10 (a) R=16 float32', t0)
    return rows


def _graph_solver(params):
    """A Solver whose chunks replay each ``STOP_POLL`` steps as one CUDA
    graph (``core/stepper.py`` ``ChunkGraph``, the eager steps' bits; a
    run on the card with no jitter and no mesh).  Only this script's
    single runs of phase 10 (b) and 12 (b) take it, to spare the host
    their launches; each replay adds its capture's launches to the launch
    counters, as the eager steps would, and no count is read over these
    runs."""
    from chsimpy_tpu_torch.core.solver import Solver
    from chsimpy_tpu_torch.core.stepper import (STOP_POLL, ChunkGraph,
                                                run_chunk)

    class GraphSolver(Solver):
        graph = None

        def _run_chunk(self, state, k):
            if self.graph is None and k >= STOP_POLL:
                self.graph = ChunkGraph(self.cfg, self._consts, state)
            return run_chunk(self.cfg, self._consts, state, k,
                             graph=self.graph)

    check(params.mesh_shape is None, 'a CUDA graph run takes no mesh')
    return GraphSolver(params)


def _single_member_run(p, A0, A1, kappa, steps=None, warm=0,
                       cuda_graph=False):
    """The port's single run of one member on the card: (solution,
    steps/s of the solve after ``warm`` steps); ``cuda_graph``: the steps
    replayed as CUDA graphs (:func:`_graph_solver`, the same bits).  It
    waits for its own stream only: runs of other threads may be capturing
    graphs."""
    import torch
    from chsimpy_tpu_torch.core.solver import Solver
    q = p.deepcopy()
    q.A0_const, q.A1_const, q.kappa_tilde = float(A0), float(A1), kappa
    s = _graph_solver(q) if cuda_graph else Solver(q)
    s.prepare()
    if warm:
        s.solve_or_resume(warm)
    torch.cuda.current_stream().synchronize()
    t0 = time.perf_counter()
    sol = s.solve_or_resume(steps)
    torch.cuda.current_stream().synchronize()
    done = sol.computed_steps - (warm or 1)
    return sol, done / (time.perf_counter() - t0)


def _ensemble_run(p, pairs, kappas, steps=None, warm=0):
    """(ensemble, solutions, member-steps/s of the solve after ``warm``
    steps, launches of that solve and, under 'members', the member
    count)."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    from chsimpy_tpu_torch.ops import kernels as K
    ens = EnsembleSolver(p, pairs, kappas=np.asarray(kappas))
    ens.prepare()
    if warm:
        ens.solve_or_resume(warm)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    sols = ens.solve_or_resume(steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    launches['members'] = len(sols)
    done = sum(s.computed_steps - (warm or 1) for s in sols)
    return ens, sols, done / seconds, launches


def canonical_ensemble():
    """_ensemble_run of the canonical batch; its members' results are
    kept for phase 14 (b), which holds the 2-rank world's batch to them
    to the bit."""
    from chsimpy_tpu_torch import Parameters
    out = _ensemble_run(Parameters(no_gui=True, device='cuda'),
                        canonical_pairs(), CANONICAL_KAPPAS)
    KEPT['canonical'] = _members_of(out[1])
    return out


def canonical_batch(card):
    """(b) the canonical R=16 N=512 float64 batch through
    ``EnsembleSolver`` (the main path: its launch counts are the JSON
    line's): each member's stop step equals the port's single run of the
    member on the card, E within 1e-10 at every row; member-steps/s beside
    a single run's steps/s (member 0, alone and eager; the other members'
    single runs replayed as CUDA graphs side by side,
    :func:`graph_single_runs`)."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters

    pairs = canonical_pairs()
    p = Parameters(no_gui=True, device='cuda')
    ens, sols, rate_b, launches = canonical_ensemble()
    stops = [s.computed_steps for s in sols]
    iterations = max(stops) - 1
    ref0, rate_1 = _single_member_run(p, *pairs[0], CANONICAL_KAPPAS[0])
    singles, single_s = graph_single_runs(p, range(1, len(pairs)))
    singles[0] = (ref0.timedata.data(), None,
                  {'stop': ref0.computed_steps, 'reason': ref0.stop_reason})
    E_rel = []
    for r, s in enumerate(sols):
        b, _, meta = singles[r]
        a = s.timedata.data()
        check(s.computed_steps == meta['stop']
              and s.stop_reason == meta['reason'] == 'energy'
              and a.shape == b.shape,
              f"canonical batch member {r}: stop {s.computed_steps} "
              f"({s.stop_reason}), single run {meta['stop']} "
              f"({meta['reason']})")
        E_rel.append(float(np.max(np.abs(a[:, 1] / b[:, 1] - 1))))
        check(E_rel[-1] <= 1e-10, f"canonical batch member {r}: E "
                                  f"{E_rel[-1]:.3e} off its single run")
        check(bool(torch.isfinite(s.U).all()), f"member {r}: field")
    res = {'R': 16, 'N': 512, 'dtype': 'float64', 'stop_steps': stops,
           'member_steps_per_s': rate_b,
           'single_steps_per_s': [rate_1],
           'graph_single_runs_seconds': single_s,
           'E_max_rel_vs_single': E_rel, 'launches': launches,
           'iterations': iterations}
    print(f"canonical batch R=16 N=512 float64: stops {stops}; "
          f"{rate_b:.1f} member-steps/s, member 0's single run "
          f"{rate_1:.1f} steps/s (the other 15 as CUDA graphs in "
          f"{single_s:.1f} s); E vs single <= {max(E_rel):.3e}; launches "
          f"{launches}  ({card})", flush=True)
    for name, single in MEMBER_KERNELS.items():
        check(launches[name] >= iterations,
              f"canonical batch: {name} launched {launches[name]} times "
              f"in {iterations} step iterations")
        check(launches[single] == 0,
              f"canonical batch: the single-field {single} launched")
    # each member's Ra comes from K4_members' second pass
    # (absdev_ra_members, counted as absdev_sum_members): K11 has no
    # launch of its own
    check(launches['row_absdev_members'] == 0,
          f"canonical batch: row_absdev_members launched "
          f"{launches['row_absdev_members']} times (its body runs in "
          f"absdev_sum_members' second pass)")
    del ens
    torch.cuda.empty_cache()
    return res


def ensemble_n4096(card):
    """(c) R=4 N=4096 float32 full_sim over ENS_4096 steps on matmul,
    split and fft: member-steps/s of the steps after the warm-up beside
    the single runs' steps/s, mean(U) held to 1e-6, each member's E within
    1e-6 of its single run at every row (the members' batched products
    and the single runs' round differently) and U within the float32
    class, 1e-5 (tests/test_torch_solver.py's bound against JAX)."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters

    R, steps = ENS_4096
    pairs = canonical_pairs(R)
    kappas = CANONICAL_KAPPAS[:R]
    out = {}
    for route in ('matmul', 'split', 'fft'):
        p = Parameters(N=4096, precision='float32', full_sim=True,
                       generator='uniform', no_gui=True, device='cuda',
                       transform_backend=route, matmul_precision='highest')
        ens, sols, rate_b, launches = _ensemble_run(
            p, pairs, kappas, steps - ENS_WARM, ENS_WARM)
        U0 = float(np.mean(ens.U_init))
        means = [s.U.double().mean().item() for s in sols]
        single_rates, E_rel, U_diff = [], [], []
        for r, s in enumerate(sols):
            ref, rate_1 = _single_member_run(p, *pairs[r], kappas[r],
                                             steps - ENS_WARM, ENS_WARM)
            single_rates.append(rate_1)
            a, b = s.timedata.data(), ref.timedata.data()
            check(a.shape == b.shape == (steps, 9),
                  f"N=4096 {route} member {r}: rows {a.shape}")
            E_rel.append(float(np.max(np.abs(a[:, 1] / b[:, 1] - 1))))
            U_diff.append((s.U - ref.U).abs().max().item())
            del ref
        res = {'R': R, 'steps': steps, 'warm': ENS_WARM,
               'member_steps_per_s': rate_b,
               'single_steps_per_s': single_rates,
               'E_max_rel_vs_single': E_rel, 'U_max_diff_vs_single': U_diff,
               'U_mean': means, 'U_mean_initial': U0, 'launches': launches}
        out[route] = res
        print(f"N=4096 float32 R={R} {route}: {rate_b:.2f} member-steps/s, "
              f"single runs {min(single_rates):.2f}-{max(single_rates):.2f} "
              f"steps/s; E vs single <= {max(E_rel):.3e}, U <= "
              f"{max(U_diff):.3e}; mean(U) drift "
              f"{max(abs(m - U0) for m in means):.3e}  ({card})", flush=True)
        check(max(abs(m - U0) for m in means) <= 1e-6,
              f"N=4096 {route}: mean(U) drifted")
        check(max(E_rel) <= 1e-6 and max(U_diff) <= 1e-5,
              f"N=4096 {route}: members off their single runs "
              f"(E {max(E_rel):.3e}, U {max(U_diff):.3e})")
        for name in MEMBER_KERNELS:
            check(launches[name] >= steps - ENS_WARM,
                  f"N=4096 {route}: {name} launched {launches[name]} times")
        del ens, sols
        torch.cuda.empty_cache()
    return out


def _cli(*args, cwd):
    cmd = [sys.executable, '-m', 'chsimpy_tpu_torch', '--no-gui', *args]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)
    check(proc.returncode == 0,
          f"CLI {' '.join(args)} exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


def checkpoint_phase(card, E_single):
    """(d) checkpoints and (e) the CLI's exports: the canonical run through
    the CLI to step CKPT_STEP (a --checkpoint-every save there), then
    --restore with --export-csv U,E,E2 -C --yaml: it stops at 1674; its
    rows (read back from the exports, repr-exact) are the in-memory run
    that re-enters the solve at CKPT_STEP to the bit (a resume recomputes
    the spectral image at the entry, the reference's semantics) and within
    1e-10 of the uninterrupted run (phase 4's E); U and the YAML scalars
    read back equal the solution.  An ensemble saved mid-batch and
    restored ends bit-equal to the in-memory re-entry, and a run with the
    device jitter resumes its threefry stream to the bit."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator, checkpoint
    from chsimpy_tpu_torch.io import csvio, yamlio

    out = {}
    work = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    try:
        ck = os.path.join(work, 'canon.npz')
        kappa = ['-K', repr(KAPPA)]
        _cli('-n', str(CKPT_STEP), '--checkpoint-file', ck,
             '--checkpoint-every', '1024', *kappa, cwd=work)
        text = _cli('--restore', ck, '--export-csv', 'U,E,E2', '-C',
                    '--yaml', '-f', 'restored', cwd=work)
        m = re.search(r'computed_steps = (\d+).*stop reason = (\w+)', text)
        check(m is not None and m.group(1) == '1674'
              and m.group(2) == 'energy',
              f"restored CLI run: {text[-500:]}")
        sim = Simulator(Parameters(no_gui=True, device='cuda',
                                   kappa_tilde=KAPPA, ntmax=CKPT_STEP))
        sim.solve()
        sol = sim.solver.solve_or_resume(int(1e6))
        td = sol.timedata.data()
        stem = os.path.join(work, 'restored.solution')
        E = csvio.csv_import_matrix(stem + '.E.csv.bz2')[:, 0]
        E2 = csvio.csv_import_matrix(stem + '.E2.csv.bz2')[:, 0]
        U = csvio.csv_import_matrix(stem + '.U.csv.bz2')
        data = yamlio.import_scalars(stem + '.yaml')
        res = {'checkpoint_step': CKPT_STEP,
               'stop': int(m.group(1)),
               'rows_equal_reentry': bool(np.array_equal(E, td[:, 1])
                                          and np.array_equal(E2, td[:, 2])),
               'U_equal': bool(np.array_equal(U, sol.U.cpu().numpy())),
               'yaml_equal': sol.is_scalarwise_equal_with(data),
               'E_max_rel_vs_uninterrupted': float(np.max(np.abs(
                   E / np.asarray(E_single) - 1)))}
        out['cli_restore'] = res
        print(f"checkpoint (d)+(e): {json.dumps(res)}", flush=True)
        check(res['rows_equal_reentry'] and res['U_equal']
              and res['yaml_equal'] and len(E) == 1674
              and res['E_max_rel_vs_uninterrupted'] <= 1e-10,
              f"checkpoint (d)/(e): {res}")

        # the ensemble, saved mid-batch
        pairs = canonical_pairs(4)
        p = Parameters(no_gui=True, device='cuda')
        first, then = 800, 400

        def ens_first():
            from chsimpy_tpu_torch.ensemble import EnsembleSolver
            e = EnsembleSolver(p, pairs, kappas=np.asarray(
                CANONICAL_KAPPAS[:4]))
            e.prepare()
            e.solve_or_resume(first)
            return e
        e = ens_first()
        ek = os.path.join(work, 'ens.npz')
        checkpoint.save_ensemble_checkpoint(ek, e)
        ref = e.solve_or_resume(then)
        got = checkpoint.restore_ensemble(ek).solve_or_resume(then)
        same = all(np.array_equal(a.timedata.data(), b.timedata.data())
                   and torch.equal(a.U, b.U) for a, b in zip(got, ref))
        out['ensemble'] = {'R': 4, 'saved_at': first, 'then': then,
                           'equal': same}
        print(f"checkpoint (d) ensemble R=4 N=512 saved at {first}, "
              f"{then} more steps: {'bit-equal' if same else 'DIFFERS'}",
              flush=True)
        check(same, 'the restored ensemble differs')
        del e, ref, got

        # the device jitter's threefry stream (the key in the file)
        jk = os.path.join(work, 'jit.npz')
        q = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA,
                       jitter=0.01, jitter_backend='device', ntmax=200,
                       checkpoint_file=jk)
        s = Simulator(q)
        s.solve()
        ref = s.solver.solve_or_resume(100)
        q2 = Parameters(no_gui=True, device='cuda', restore_file=jk,
                        ntmax=100)
        got = Simulator(q2).solve()
        same = bool(np.array_equal(got.timedata.data(), ref.timedata.data())
                    and torch.equal(got.U, ref.U))
        out['device_jitter'] = {'saved_at': 200, 'then': 100, 'equal': same}
        print(f"checkpoint (d) device jitter: resumed stream "
              f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
        check(same, 'the device jitter stream did not resume')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


CKPT_STEP = 1025    # the first --checkpoint-every 1024 save of a fresh run


def ensemble_phase(dev, card, E_single):
    out = {'member_kernels': member_kernel_phase(dev, card)}
    t0 = time.perf_counter()
    out['canonical'] = canonical_batch(card)
    out['seconds_b'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['n4096'] = ensemble_n4096(card)
    out['seconds_c'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['checkpoint'] = checkpoint_phase(card, E_single)
    out['seconds_d_e'] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 11: the UQ experiment (experiment.main) on the card
# ----------------------------------------------------------------------

# the JAX package's on-chip float64 run of the paper's UQ design
# (scripts/probes/uq_tpu_f64_run.py) and the reference's own run
UQ64_DIR = 'artifacts/r5/uq_f64'
UQ_REF_DIR = 'artifacts/r4/uq'
UQ_ARGV = ['-R', '16', '--A-source', 'sobol', '--A-seed', '85972', '-N',
           '512', '--cinit', '0.89', '--threshold', '0.89', '--export-csv',
           'E2', '--host-procs', '1', '--device', 'cuda']
# the sympy values of the design's 16 (A0, A1) pairs (cinit 0.89): (ca,
# cb) of the miscibility gap, (sa, sb) the EPP roots, and kappa_tilde.
# The card's machine has no sympy; phase 11 looks these up instead of
# solving (a miss raises), and tests/test_torch_experiment.py pins them to
# the port's sympy solves and to tpu64-results.csv and
# tpu64-run*.solution.yaml, to the bit
SOBOL_MATERIAL = {
    (-151.87576441553873, -85.52227802797925):
        (0.8162315040826797, 0.9710404276847839,
         0.8570077513584462, 0.9481731848319069, 0.0003093641995360705),
    (-150.9080095764055, -85.89228190012857):
        (0.8073931187391281, 0.9739690944552422,
         0.8518224752564517, 0.9502020655831758, 0.0004221420018242648),
    (-150.77636994397903, -85.3404879420829):
        (0.8126952350139618, 0.9720800518989563,
         0.8548714718934353, 0.9488291347185329, 0.0003487157622523389),
    (-151.3456578533421, -85.6995169102154):
        (0.8116062507033348, 0.9725993424654007,
         0.8542939947520909, 0.9492436294099279, 0.00036541673487657563),
    (-151.620656057502, -85.21640680808606):
        (0.8183944225311279, 0.9701677933335304,
         0.8582304848944693, 0.9475399137906533, 0.0002834363007348547),
    (-150.68876389584088, -85.82281750317429):
        (0.8070631995797157, 0.9740333929657936,
         0.8516124270186912, 0.9502327719412499, 0.00042587831115345297),
    (-151.20744390399696, -85.41146933197494):
        (0.8140802308917046, 0.9716772064566612,
         0.8557084862711543, 0.9485743470002095, 0.0003329588895467177),
    (-151.76376804468302, -86.00231005509494):
        (0.8103972002863884, 0.9731197208166122,
         0.8536331675354852, 0.9496492237643757, 0.0003836348715088714),
    (-151.66646283744896, -85.3901851673904):
        (0.8166518211364746, 0.9708350375294685,
         0.8572312121222669, 0.94801245791108, 0.00030360570543424187),
    (-151.1156492050405, -85.64649544394506):
        (0.8110416531562805, 0.9727476015686989,
         0.8539477802054373, 0.9493330291239639, 0.00037194099825368134),
    (-150.5914529071683, -85.58294852437254):
        (0.8091405853629112, 0.9732968285679817,
         0.852803802943992, 0.9496902575506011, 0.00039559829632703506),
    (-151.52891327879382, -85.82828716277245):
        (0.8111166730523109, 0.9728140905499458,
         0.8540277146718873, 0.9494116003107107, 0.0003727814112882081),
    (-151.44883714301275, -85.45219120284072):
        (0.8148476853966713, 0.9714522436261177,
         0.8561723596339874, 0.9484326649460771, 0.0003244304546318499),
    (-150.86224450057813, -85.95826394326633):
        (0.8064770922064781, 0.9742702394723892,
         0.8512890101001509, 0.9504186249204453, 0.00043544703256680173),
    (-151.01126388953898, -85.27270028385111):
        (0.8146329149603844, 0.9714296162128448,
         0.8560095091774679, 0.9483836716816171, 0.0003253245749258373),
    (-151.96161013256426, -85.7631997864464):
        (0.8139819428324699, 0.9718861505389214,
         0.8557188749965416, 0.9487795384667489, 0.00033726871764646997),
}
# (a): the largest relative distance, over its rows, of each member's E2
# in tpu64-run{r}.solution.E2.csv from the JAX package's float64 run of
# the member on the CPU (the TPU's float64 arithmetic; pinned by
# tests/test_torch_uq_artifact.py).  A member's E2 on the card is held to
# that distance plus the float64 contract's 1e-10
TPU64_E2_OWN_REL = (
    8.017604358201424e-10, 2.9450542005093894e-10, 8.469662748922246e-10,
    1.041957187197795e-09, 6.92008228497798e-10, 4.0439407378300984e-10,
    4.799889374851318e-10, 1.297951301992839e-09, 9.141787327138218e-10,
    1.2129772741786837e-09, 1.0632950075972758e-09, 8.344132051973929e-10,
    5.6816817917138e-10, 4.71313210681501e-10, 6.039753142061954e-10,
    6.84565071296106e-10)
UQ_E2_RTOL = 1e-10
# (b): the reference's float32 ladder (tests/test_uq_artifact.py:69-78)
UQ_F32_RTOL, UQ_F32_MEAN_RTOL = 6e-3, 3e-3


class _MaterialTable:
    """The experiment's three sympy solves replaced by lookups in
    SOBOL_MATERIAL for the ``with`` block: material.get_miscibility_gap,
    material.get_roots_of_EPP and ensemble.derive_member_constants (the
    member kappa).  A pair outside the table raises."""

    def __enter__(self):
        from chsimpy_tpu_torch import ensemble, material

        def entry(a0, a1):
            key = (float(a0), float(a1))
            if key not in SOBOL_MATERIAL:
                raise KeyError(f"(A0, A1) = {key} is not in SOBOL_MATERIAL "
                               "(no sympy on this machine)")
            return SOBOL_MATERIAL[key]

        self._saved = [(material, 'get_miscibility_gap'),
                       (material, 'get_roots_of_EPP'),
                       (ensemble, 'derive_member_constants')]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]
        material.get_miscibility_gap = \
            lambda R, T, B, a0, a1: entry(a0, a1)[:2]
        material.get_roots_of_EPP = \
            lambda R, T, a0, a1: list(entry(a0, a1)[2:4])
        ensemble.derive_member_constants = \
            lambda params, a0, a1: entry(a0, a1)[4]
        return self

    def __exit__(self, *exc):
        for m, n, f in self._saved:
            setattr(m, n, f)


def read_results(path):
    """A results.csv's rows, read exactly: id -> {column: value} (tau0,
    tsep and id ints, the rest Python floats, empty cells None)."""
    lines = open(path).read().splitlines()
    cols = lines[0].split(',')[1:]
    out = {}
    for line in lines[1:]:
        cells = line.split(',')[1:]
        row = {c: (None if v == '' else int(v) if c in ('tau0', 'tsep', 'id')
                   else float(v)) for c, v in zip(cols, cells)}
        out[row['id']] = row
    return out


def _experiment_run(precision, tag, work, extra=()):
    """experiment.main on the card in ``work`` with the material table
    (UQ_ARGV, then ``extra``): (wall s, {solve s, host-pipeline s},
    launches)."""
    import torch
    from chsimpy_tpu_torch import ensemble, experiment
    from chsimpy_tpu_torch.ops import kernels as K

    timers = {'solve': 0.0, 'host': 0.0}
    solve0 = ensemble.EnsembleSolver.solve_or_resume
    host0 = experiment._host_member_task

    def solve(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols = solve0(self, *a, **kw)
        torch.cuda.synchronize()
        timers['solve'] += time.perf_counter() - t0
        return sols

    def host(*a):
        t0 = time.perf_counter()
        row = host0(*a)
        timers['host'] += time.perf_counter() - t0
        return row

    cwd = os.getcwd()
    os.makedirs(work)
    os.chdir(work)
    ensemble.EnsembleSolver.solve_or_resume = solve
    experiment._host_member_task = host
    try:
        with _MaterialTable():
            K.reset_launches()
            t0 = time.perf_counter()
            experiment.main(UQ_ARGV + ['--precision', precision, '-f', tag,
                                       *extra])
            wall = time.perf_counter() - t0
            launches = dict(K.launches)
    finally:
        ensemble.EnsembleSolver.solve_or_resume = solve0
        experiment._host_member_task = host0
        os.chdir(cwd)
    return wall, timers, launches


def _yaml_scalars(path):
    from chsimpy_tpu_torch.io import yamlio
    return yamlio.import_scalars(path)


def experiment_f64(card, work, transform=None):
    """(a) the paper's UQ design in float64 through experiment.main (the
    main path: its member-batched kernel counts are read here): every
    member against the JAX package's on-chip float64 run (tpu64-*) and
    the reference's own run.  ``transform='ozaki'`` (phase 12 (d)) runs
    it with ``--transform ozaki``: K5_members on every transform, the
    single-field K5 never."""
    import numpy as np

    tag, extra, label = 'uq64', (), 'phase 11 (a)'
    if transform is not None:
        tag, extra = 'uq64' + transform, ('--transform', transform)
        label = f'phase 12 (d) --transform {transform}'
    print(f"{label}: the three sympy solves are lookups in SOBOL_MATERIAL "
          "(no sympy on this machine)", flush=True)
    wall, timers, launches = _experiment_run('float64', tag, work, extra)
    if transform is None:
        # phase 14 (d) holds the two-process run to these bytes
        KEPT['uq64'] = {
            'files': sorted(os.listdir(work)),
            **{s: open(os.path.join(work, f'{tag}-{s}.csv'), 'rb').read()
               for s in ('results', 'results-agg')}}
    got = read_results(os.path.join(work, f'{tag}-results.csv'))
    want = read_results(os.path.join(ROOT, UQ64_DIR, 'tpu64-results.csv'))
    ref = read_results(os.path.join(ROOT, UQ_REF_DIR, 'ref-results.csv'))
    check(sorted(got) == sorted(want) == list(range(16)),
          f"{label}: ids {sorted(got)}")
    exact = ('A0', 'A1', 'fac_A0', 'fac_A1', 'ca', 'cb', 'sa', 'sb', 'tau0',
             'tsep', 'id')
    t0_rel, E2_rel, yaml_diff = [], [], []
    for r in range(16):
        g, w = got[r], want[r]
        bad = [c for c in exact if g[c] != w[c]]
        check(not bad, f"{label} member {r}: {bad} differ: {g} vs {w}")
        t0_rel.append(abs(g['t0'] / w['t0'] - 1))
        check((g['tau0'], g['tsep']) == (ref[r]['tau0'], ref[r]['tsep']),
              f"{label} member {r}: tau0/tsep {g['tau0']}/{g['tsep']}"
              f", the reference's {ref[r]['tau0']}/{ref[r]['tsep']}")
        e2 = np.loadtxt(os.path.join(work, f'{tag}-run{r}.solution.E2.csv'))
        e2w = np.loadtxt(os.path.join(ROOT, UQ64_DIR,
                                      f'tpu64-run{r}.solution.E2.csv'))
        check(e2.shape == e2w.shape, f"member {r}: E2 rows {e2.shape} vs "
                                     f"{e2w.shape}")
        E2_rel.append(float(np.max(np.abs(e2 / e2w - 1))))
        check(E2_rel[-1] <= TPU64_E2_OWN_REL[r] + UQ_E2_RTOL,
              f"{label} member {r}: E2 {E2_rel[-1]:.3e} from tpu64, "
              f"whose own distance from the JAX package's CPU run is "
              f"{TPU64_E2_OWN_REL[r]:.3e} (+ {UQ_E2_RTOL})")
        ys = _yaml_scalars(os.path.join(work, f'{tag}-run{r}.solution.yaml'))
        yw = _yaml_scalars(os.path.join(ROOT, UQ64_DIR,
                                        f'tpu64-run{r}.solution.yaml'))
        check(sorted(ys) == sorted(yw), f"member {r}: YAML keys differ")
        yaml_diff += [(r, k) for k in ys if k != 't0' and ys[k] != yw[k]]
        check(abs(ys['t0'] / yw['t0'] - 1) <= 1e-12,
              f"member {r}: YAML t0 {ys['t0']!r} vs {yw['t0']!r}")
    check(max(t0_rel) <= 1e-12, f"{label}: t0 off by {max(t0_rel)}")
    check(not yaml_diff, f"{label}: YAML scalars differ: {yaml_diff}")
    # results-agg.csv: byte-equal in every row whose 16 inputs are the
    # artifact's to the bit
    agg = open(os.path.join(work, f'{tag}-results-agg.csv')).read()
    aggw = open(os.path.join(ROOT, UQ64_DIR, 'tpu64-results-agg.csv')).read()
    rows, rows_w = agg.splitlines(), aggw.splitlines()
    check(len(rows) == len(rows_w) and rows[0] == rows_w[0],
          f"{label}: results-agg.csv layout")
    compared, differ = [], []
    for line, line_w in zip(rows[1:], rows_w[1:]):
        col = line.split(',')[0]
        if all(got[r][col] == want[r][col] for r in range(16)):
            compared.append(col)
            if line != line_w:
                differ.append(col)
    check(not differ, f"{label}: agg rows {differ} differ")
    steps = sum(got[r]['tau0'] for r in range(16))
    iterations = max(got[r]['tau0'] for r in range(16)) - 1
    for name, single in MEMBER_KERNELS.items():
        check(launches[name] >= iterations,
              f"{label}: {name} launched {launches[name]} times in "
              f"{iterations} step iterations")
        check(launches[single] == 0,
              f"{label}: the single-field {single} launched")
    if transform == 'ozaki':
        check(launches['slice_field_members'] >= iterations
              and launches['slice_field'] == 0,
              f"{label}: slice_field_members launched "
              f"{launches['slice_field_members']} times, slice_field "
              f"{launches['slice_field']}, in {iterations} step iterations")
    res = {'members': 16, 'N': 512, 'dtype': 'float64',
           'transform': transform or 'auto',
           'tau0': [got[r]['tau0'] for r in range(16)],
           't0_max_rel': max(t0_rel), 'E2_rel_per_member': E2_rel,
           'E2_rel_over_tpu64_own': max(
               e - TPU64_E2_OWN_REL[r] for r, e in enumerate(E2_rel)),
           'agg_rows_byte_equal': compared, 'launches': launches,
           'wall_s': wall, 'solve_s': timers['solve'],
           'host_pipeline_s': timers['host'],
           'member_steps_per_s': steps / timers['solve']}
    print(f"{label} UQ R=16 N=512 float64 sobol: tau0 = tpu64 = ref "
          f"{res['tau0']}; t0 within {res['t0_max_rel']:.2e}, E2 within "
          f"{max(E2_rel):.2e} of tpu64 (at most "
          f"{res['E2_rel_over_tpu64_own']:.2e} beyond tpu64's own distance "
          f"from the JAX CPU run); agg rows byte-equal {compared}; wall "
          f"{wall:.2f} s (solve {timers['solve']:.2f}, host pipeline "
          f"{timers['host']:.2f}), {res['member_steps_per_s']:.1f} "
          f"member-steps/s; launches {launches}  ({card})", flush=True)
    return res


def experiment_f32(card, work):
    """(b) the same design in float32: tau0, t0 and tsep per member within
    6e-3 of the reference's run, their means within 3e-3."""
    import numpy as np

    wall, timers, launches = _experiment_run('float32', 'uq32', work)
    got = read_results(os.path.join(work, 'uq32-results.csv'))
    ref = read_results(os.path.join(ROOT, UQ_REF_DIR, 'ref-results.csv'))
    res = {'members': 16, 'N': 512, 'dtype': 'float32', 'wall_s': wall,
           'solve_s': timers['solve'], 'host_pipeline_s': timers['host'],
           'launches': launches}
    for col in ('tau0', 't0', 'tsep'):
        a = np.array([got[r][col] for r in range(16)], dtype=np.float64)
        b = np.array([ref[r][col] for r in range(16)], dtype=np.float64)
        res[col] = {'max_rel': float(np.max(np.abs(a / b - 1))),
                    'mean_rel': float(abs(a.mean() / b.mean() - 1))}
        check(res[col]['max_rel'] <= UQ_F32_RTOL
              and res[col]['mean_rel'] <= UQ_F32_MEAN_RTOL,
              f"phase 11 (b): {col} {res[col]} outside the float32 ladder")
    res['tau0_values'] = [got[r]['tau0'] for r in range(16)]
    print(f"phase 11 (b) UQ R=16 N=512 float32: tau0 {res['tau0_values']}; "
          f"vs ref: " + ', '.join(f"{c} {res[c]}" for c in
                                  ('tau0', 't0', 'tsep'))
          + f"; wall {wall:.2f} s  ({card})", flush=True)
    return res


def experiment_phase(card):
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix='chip_smoke_uq_')
    try:
        out = {'f64': experiment_f64(card, os.path.join(work, 'f64'))}
        out['f32'] = experiment_f32(card, os.path.join(work, 'f32'))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 12: the ozaki route under the ensemble (K5_members), the
# experiment's --transform ozaki and the ozaki profile
# ----------------------------------------------------------------------

# (a): (R, N) of the batched slice launches, with the slice counts of the
# route (4: the trimmed (3, 5) forward, 6: the untrimmed inverse); the
# JSON line's row is the canonical batch's shape with 4 slices
SLICE_MEMBER_SHAPES = ((16, 512), (4, 4096), (3, 1001), (2, 1000))
SLICE_MEMBER_REPORT = (16, 512, 4)
# and a NaN in member 0 (its scale NaN, its planes the plain version's)
SLICE_NAN_SHAPES = ((16, 512), (3, 1001))
# (c): members, steps (a warm-up of ENS_WARM, then the timed window)
OZ_ENS_4096 = (4, 64)
# (e): the profiled field size
OZ_PROFILE_N = 4096


def member_slice_bound(R, N, n_slices):
    """bound_fields of K5_members: R fields read once, R x n_slices int8
    planes, R scales and inverses written."""
    n = N * N
    return bound_fields(R * (n * 8 + n * n_slices + 12),
                        (OPS_PER_ELEM['slice_setup']
                         + OPS_PER_ELEM['slice_per_plane'] * n_slices)
                        * R * n, 'float64')


def member_slice_inputs(R, N, dev):
    """R seeded solver-class members; member 1 is 1000x smaller than the
    rest (its own scale) and, for R > 2, the last one is all zero."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(R * N)
    x = 0.875 + 0.01 * (torch.rand((R, N, N), generator=g,
                                   dtype=torch.float64, device=dev) - 0.5)
    x[1] *= 1e-3
    if R > 2:
        x[-1] = 0.0
    return x


def member_slice_phase(dev, card):
    """(a) K5_members against its plain version and, member by member,
    against the single K5 launch on the member's field: the same int8
    planes and scales to the bit, one count a call; device ms of the
    batched call, of R single launches and of the plain version, and the
    bound."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for R, N, kind in [s + ('solver',) for s in SLICE_MEMBER_SHAPES] + [
            s + ('nan',) for s in SLICE_NAN_SHAPES]:
        t0 = time.perf_counter()
        x = member_slice_inputs(R, N, dev)
        if kind == 'nan':
            x[0, N // 2, N // 3] = float('nan')
        one_path = K.slice_one_launch(R, N * N)
        for n in (4, 6):
            K.reset_launches()
            got, scale = K.slice_field_members(x, n)
            counted = K.launches['slice_field_members']
            one = K.one_launch['slice_field_members']
            want, wscale = K.slice_field_members_ref(x, n)
            singles = [K.slice_field(x[r], n) for r in range(R)]
            two, tscale = K._slice_members_two_launches(x, n)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            same = all(torch.equal(got[:, r], a) and same_bits(scale[r], b)
                       for r, (a, b) in enumerate(singles))
            ok = (err == 0 and same_bits(scale, wscale) and same
                  and torch.equal(got, two) and same_bits(scale, tscale)
                  and counted == 1 and one == int(one_path)
                  and tuple(got.shape) == (n, R, N, N))
            row = {'name': 'slice_field_members', 'R': R, 'N': N,
                   'n_slices': n, 'dtype': 'float64', 'field': kind,
                   'max_abs_err': err, 'one_launch': one_path,
                   'members_equal_single_launch': same,
                   'scales': scale.tolist(),
                   'tolerance': 'bit-identical planes and scales (a NaN '
                                'scale too), each member the single '
                                'launch\'s and the two launches\', one '
                                'count a call, the one-launch path where '
                                'the shape takes it',
                   'ok': ok}
            if (R, N, kind) in ((16, 512, 'solver'), (4, 4096, 'solver')):
                row.update(timed_row(
                    lambda: K.slice_field_members(x, n),
                    lambda: K.slice_field_members_ref(x, n)))
                if one_path:
                    row.update(design_turns(
                        '12 (a)', lambda: K.slice_field_members(x, n),
                        lambda: K._slice_members_two_launches(x, n)))
                row['single_launches_ms'] = device_ms(
                    lambda: [K.slice_field(x[r], n) for r in range(R)])
                # ops/ozaki.py's _slice: the planes in the products'
                # (S, rows, R, cols) layout, a copy the route pays a slice
                row['relayout_ms'] = device_ms(
                    lambda: got.transpose(1, 2).contiguous())
                row.update(member_slice_bound(R, N, n))
                row['bound_share'] = row['bound_ms'] / row['ms']
            rows.append(row)
            times = (f"kernel {row['ms']:.4f} ms (one call "
                     f"{row['call_ms']:.4f}; {R} single launches "
                     f"{row['single_launches_ms']:.4f}; relayout "
                     f"{row['relayout_ms']:.4f}"
                     + (f"; two launches: {turns_text(row)}"
                        if 'before_ms' in row else '') + f") plain "
                     f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f}"
                     f" ms ({row['bound_share']:.0%})  ({card})"
                     if 'ms' in row else '')
            print(f"kernel slice_field_members R={R:2d} N={N:5d} n={n} "
                  f"{kind} {'one launch' if one_path else 'two launches'} "
                  f"max diff {err} members=single "
                  f"{'yes' if same else 'NO'} {'ok' if ok else 'FAIL'}  "
                  f"{times}", flush=True)
            check(ok, f"slice_field_members R={R} N={N} n={n}: planes "
                      f"differ by {err}, members equal {same}, {counted} "
                      f"counts")
        del x
        torch.cuda.empty_cache()
        if kind == 'nan':
            spent('12 (a) NaN members', t0)
    return rows


def check_members_ozaki_launches(tag, cfg, launches):
    """The ozaki ensemble's path: K1-K4 and K5_members for all members,
    never a single-field kernel; K5_members fwd + iterations * (fwd + 1)
    times (one forward at the solve's entry, a forward and an inverse a
    step; K1 counts the step iterations), each by its one-launch path
    where the batch's shape takes it."""
    from chsimpy_tpu_torch.ops import kernels as K
    iterations = launches['chemical_potential_members']
    fwd = slices_per_forward(cfg)
    want = fwd + iterations * (fwd + 1)
    for name, single in MEMBER_KERNELS.items():
        check(launches[name] >= iterations > 0,
              f"{tag}: {name} launched {launches[name]} times")
        check(launches[single] == 0, f"{tag}: the single-field {single} "
                                     f"launched")
    check(launches['slice_field_members'] == want
          and launches['slice_field'] == 0,
          f"{tag}: slice_field_members launched "
          f"{launches['slice_field_members']} times (the route implies "
          f"{want}), slice_field {launches['slice_field']}")
    R = launches['members']
    one = want if K.slice_one_launch(R, cfg.N * cfg.N) else 0
    check(launches['one_launch']['slice_field_members'] == one,
          f"{tag}: {launches['one_launch']['slice_field_members']} of the "
          f"slice_field_members calls took the one-launch path, the shape "
          f"implies {one}")
    return iterations, want


def _ozaki_params():
    from chsimpy_tpu_torch import Parameters
    return Parameters(no_gui=True, device='cuda', transform_backend='ozaki')


def graph_single_runs(p, members):
    """The single runs (Parameters ``p``) of the canonical batch's
    ``members`` to their stops: {r: (rows, U, meta)} and the wall seconds.
    Each run replays its steps as a CUDA graph (:func:`_graph_solver`,
    the eager steps' bits) on a stream of its own, the runs in
    threads of this process side by side: eagerly the host held an N=512
    ozaki run to ~60-85 steps/s (four processes took ~2 minutes for the
    16), replayed the card takes ~300 steps/s in all (processes
    time-slice it, streams share it)."""
    import threading
    import torch
    pairs = canonical_pairs()
    runs, errors = {}, []

    def run(r):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                sol, rate = _single_member_run(
                    p, *pairs[r], CANONICAL_KAPPAS[r], cuda_graph=True)
                runs[r] = (sol.timedata.data(), sol.U.cpu().numpy(),
                           {'stop': sol.computed_steps,
                            'reason': sol.stop_reason,
                            'steps_per_s': rate})
        except BaseException as e:      # raised again below
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(r,)) for r in members]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return runs, time.perf_counter() - t0


def ozaki_canonical_batch(card, matmul_batch):
    """(b) the canonical R=16 N=512 float64 batch on the ozaki route (the
    main path of this slice: the JSON line's K5_members count is read
    here) to every stop, then every member's single ozaki run to its stop
    (threads side by side, :func:`graph_single_runs`): the same stop step,
    E within 1e-10 at every row, and beyond that the same rows (Ra aside: a
    batched row mean, within 1e-12) and the same final U to the bit; the
    stops equal those of phase 10 (b)'s matmul batch (``matmul_batch``,
    run in the same call), whose member-steps/s stand beside the ozaki
    batch's."""
    import numpy as np
    import torch

    pairs = canonical_pairs()
    ens, sols, rate_oz, launches = _ensemble_run(_ozaki_params(), pairs,
                                                 CANONICAL_KAPPAS)
    check(ens.cfg.ozaki_fold and not ens.cfg.ozaki_rfold_levels
          and ens.cfg.ozaki_inv_pairs is None,
          'the N=512 ozaki batch is not on the level-1 fold route')
    iterations, implied = check_members_ozaki_launches(
        'ozaki batch', ens.cfg, launches)
    stops = [s.computed_steps for s in sols]
    check(stops == matmul_batch['stop_steps'],
          f"ozaki batch stops {stops}, the matmul batch's "
          f"{matmul_batch['stop_steps']}")
    del ens
    torch.cuda.empty_cache()
    # every member's single ozaki run to its stop
    singles, single_s = graph_single_runs(_ozaki_params(), range(len(pairs)))
    check(sorted(singles) == list(range(len(pairs))),
          f"single ozaki runs of members {sorted(singles)}")
    E_rel, single_rates = [], []
    for r, s in enumerate(sols):
        b, U, meta = singles[r]
        a = s.timedata.data()
        check(s.computed_steps == meta['stop']
              and s.stop_reason == meta['reason'] == 'energy'
              and a.shape == b.shape,
              f"ozaki batch member {r}: stop {s.computed_steps} "
              f"({s.stop_reason}), its single ozaki run {meta['stop']} "
              f"({meta['reason']})")
        E_rel.append(float(np.max(np.abs(a[:, 1] / b[:, 1] - 1))))
        check(E_rel[-1] <= 1e-10, f"ozaki batch member {r}: E "
                                  f"{E_rel[-1]:.3e} off its single run")
        check(bool(torch.isfinite(s.U).all()), f"member {r}: field")
        cols = [c for c in range(a.shape[1]) if c != 5]
        check(np.array_equal(a[:, cols], b[:, cols])
              and np.allclose(a[:, 5], b[:, 5], rtol=1e-12, atol=0)
              and np.array_equal(s.U.cpu().numpy(), U),
              f"ozaki batch member {r}: not its single ozaki run's bits")
        single_rates.append(meta['steps_per_s'])
    res = {'R': 16, 'N': 512, 'dtype': 'float64', 'route': 'fold',
           'stop_steps': stops, 'member_steps_per_s': rate_oz,
           'matmul_member_steps_per_s': matmul_batch['member_steps_per_s'],
           'E_max_rel_vs_single': E_rel,
           'single_threads': len(pairs), 'single_runs_seconds': single_s,
           'single_steps_per_s_side_by_side': single_rates,
           'launches': launches, 'iterations': iterations,
           'slice_launches_implied': implied}
    print(f"ozaki batch R=16 N=512 float64: stops {stops} = its single "
          f"ozaki runs' and the matmul batch's; {rate_oz:.1f} "
          f"member-steps/s beside matmul's "
          f"{matmul_batch['member_steps_per_s']:.1f} (phase 10 (b)); every "
          f"member's rows and U = its single ozaki run's to the bit (E "
          f"<= {max(E_rel):.3e}); 16 single runs as CUDA graphs in "
          f"threads {single_s:.1f} s ({min(single_rates):.1f}-"
          f"{max(single_rates):.1f} steps/s each); launches {launches}  "
          f"({card})", flush=True)
    del sols
    torch.cuda.empty_cache()
    return res


def ozaki_ensemble_n4096(card):
    """(c) R=4 N=4096 float64 full_sim over OZ_ENS_4096 steps on the
    ozaki route (rfold, two levels) beside matmul: member-steps/s of the
    steps after the warm-up, each member's E within 1e-10 of its matmul
    member at every row, mean(U) held, and the peak memory of each
    batch."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters

    R, steps = OZ_ENS_4096
    pairs = canonical_pairs(R)
    kappas = CANONICAL_KAPPAS[:R]
    out = {}
    sols = {}
    for route in ('matmul', 'ozaki'):
        p = Parameters(N=4096, precision='float64', full_sim=True,
                       generator='uniform', no_gui=True, device='cuda',
                       transform_backend=route)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ens, sols[route], rate_b, launches = _ensemble_run(
            p, pairs, kappas, steps - ENS_WARM, ENS_WARM)
        peak = torch.cuda.max_memory_allocated()
        U0 = float(np.mean(ens.U_init))
        drift = max(abs(s.U.double().mean().item() - U0)
                    for s in sols[route])
        out[route] = {'R': R, 'steps': steps, 'warm': ENS_WARM,
                      'member_steps_per_s': rate_b,
                      'peak_memory_GB': peak / 1e9,
                      'memory_before_GB': base / 1e9,
                      'mean_U_drift': drift, 'launches': launches}
        if route == 'ozaki':
            check(ens.cfg.ozaki_rfold_levels == 2,
                  'the N=4096 ozaki batch is not rfold L=2')
            check_members_ozaki_launches('ozaki N=4096 batch', ens.cfg,
                                         launches)
        check(drift <= 1e-12, f"N=4096 {route}: mean(U) drifted {drift}")
        del ens
    E_rel = [float(np.max(np.abs(a.timedata.data()[:, 1]
                                 / b.timedata.data()[:, 1] - 1)))
             for a, b in zip(sols['ozaki'], sols['matmul'])]
    out['E_max_rel_ozaki_vs_matmul'] = E_rel
    print(f"N=4096 float64 R={R}: ozaki {out['ozaki']['member_steps_per_s']:.2f}"
          f" member-steps/s (peak {out['ozaki']['peak_memory_GB']:.2f} GB), "
          f"matmul {out['matmul']['member_steps_per_s']:.2f} (peak "
          f"{out['matmul']['peak_memory_GB']:.2f} GB); E ozaki vs matmul <= "
          f"{max(E_rel):.3e}  ({card})", flush=True)
    check(all(len(s.timedata) == steps for s in sols['ozaki']),
          'N=4096 ozaki batch: not every member has its rows')
    check(max(E_rel) <= 1e-10, f"N=4096 ozaki batch E {max(E_rel):.3e} "
                               f"from matmul (1e-10)")
    del sols
    torch.cuda.empty_cache()
    return out


def ozaki_profile_phase(card):
    """(e) benchmarks/ozaki_profile.py at N=4096 on the card: the four
    cumulative prefixes P1-P4, ms per call."""
    from chsimpy_tpu_torch.benchmarks import ozaki_profile
    res = ozaki_profile.main(['-N', str(OZ_PROFILE_N), '--reps', '3'])
    check([r['pipeline'] for r in res['results']]
          == list(ozaki_profile.build_pipelines())
          and all(r['ms_median'] > 0 for r in res['results']),
          f"ozaki_profile: {res}")
    print(f"ozaki_profile N={OZ_PROFILE_N}: " + ', '.join(
        f"{r['pipeline']} {r['ms_median']:.4f} ms" for r in res['results'])
        + f"  ({card})", flush=True)
    return res


def ozaki_ensemble_phase(dev, card, matmul_batch):
    out = {'slice_members': member_slice_phase(dev, card)}
    for key, fn, a in (('canonical', ozaki_canonical_batch, (matmul_batch,)),
                       ('n4096', ozaki_ensemble_n4096, ())):
        t0 = time.perf_counter()
        out[key] = fn(card, *a)
        out[f'seconds_{key}'] = time.perf_counter() - t0
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix='chip_smoke_uq_ozaki_')
    t0 = time.perf_counter()
    try:
        out['experiment'] = experiment_f64(card, os.path.join(work, 'f64'),
                                           transform='ozaki')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out['seconds_experiment'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['profile'] = ozaki_profile_phase(card)
    out['seconds_profile'] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# phase 13: the live loop on the card (the views' chunked solve)
# ----------------------------------------------------------------------

# (b): N=4096 float32 matmul full_sim: warm-up steps, the window, the live
# loop's refresh cadence in it, and the windows' order
LIVE_WARM, LIVE_WINDOW, LIVE_EVERY = 256, 1024, 256
LIVE_TURNS = ('live', 'straight', 'live')
# (a), (c): the refresh cadence of the canonical run and batch
LIVE_CANONICAL_EVERY = 100


class StandInView:
    """A view without matplotlib (the card's machine has none), patched
    over ``viz.plotview.PlotView`` and ``viz.mapview.MapView``: it keeps
    each refresh's titles and the shape and identity of the host arrays
    it was handed, and ``render_to`` writes a small JSON file."""
    made = []

    def __init__(self, N, XXX=None):
        self.N = N
        self.refreshes = 0          # draw() calls: one per live chunk
        self.calls = []             # (panel, id of U or None, title)
        self.shapes = set()         # shapes and types of the U arrays
        self.rendered = []
        StandInView.made.append(self)

    def prepare(self, show=True):
        pass

    def imode_on(self):
        pass

    def imode_off(self):
        pass

    def imode_default(self):
        pass

    def show(self, block=False):
        pass

    def finish(self):
        pass

    def draw(self):
        self.refreshes += 1

    def render_to(self, fname):
        with open(fname, 'w') as f:
            json.dump({'refreshes': self.refreshes,
                       'titles': [c[2] for c in self.calls[-6:]]}, f)
        self.rendered.append(fname)

    def _keep(self, panel, U, title):
        if U is not None:
            self.shapes.add((type(U).__module__, type(U).__name__,
                             tuple(U.shape)))
        self.calls.append((panel, None if U is None else id(U), title))

    def set_Umap(self, U, threshold, title):
        self._keep('Umap', U, title)

    def set_Uline(self, U, title):
        self._keep('Uline', U, title)

    def set_Eline(self, E, it_range, title, computed_steps):
        self._keep('Eline', None, title)

    def set_Eline_delt(self, E, it_range, delt, title, computed_steps):
        self._keep('Eline', None, title)

    def set_SAlines(self, domtime, SA, title, computed_steps, x2, t0):
        self._keep('SAlines', None, title)

    def set_E2line(self, E2, it_range, title, computed_steps, tau0, t0):
        self._keep('E2line', None, title)

    def set_Uhist(self, U, title):
        self._keep('Uhist', U, title)

    def copies_per_refresh(self) -> set:
        """The number of distinct U arrays in each refresh of the six
        panels (one host copy: {1})."""
        out = set()
        for k in range(0, len(self.calls) - 5, 6):
            ids = {c[1] for c in self.calls[k:k + 6] if c[1] is not None}
            out.add(len(ids))
        return out


class stand_in_views:
    """Context manager: ``StandInView`` in place of both view classes."""

    def __enter__(self):
        from chsimpy_tpu_torch.viz import mapview, plotview
        self.saved = (plotview, plotview.PlotView, mapview, mapview.MapView)
        plotview.PlotView = mapview.MapView = StandInView
        StandInView.made = []
        return StandInView

    def __exit__(self, *exc):
        plotview, pv, mapview, mv = self.saved
        plotview.PlotView, mapview.MapView = pv, mv
        return False


def start_no_fallback(work):
    """(d), started first and read after (a): the CLI with --png and the
    GUI on a machine without matplotlib must fail and name it."""
    env = dict(os.environ, PYTHONPATH=ROOT, MPLBACKEND='Agg')
    return subprocess.Popen(
        [sys.executable, '-m', 'chsimpy_tpu_torch', '-N', '64', '-n', '10',
         '--png', '-K', repr(KAPPA)], cwd=work, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_no_fallback(proc, work):
    import importlib.util
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    pngs = sorted(f for f in os.listdir(work) if f.endswith('.png'))
    has_mpl = importlib.util.find_spec('matplotlib') is not None
    res = {'matplotlib_importable': has_mpl, 'returncode': proc.returncode,
           'pngs': pngs, 'error_tail': err.strip().splitlines()[-1:]}
    print(f"live (d) --png without matplotlib: {json.dumps(res)}",
          flush=True)
    if has_mpl:
        print("live (d): matplotlib is importable on this machine: the "
              "run must write its PNG", flush=True)
        check(proc.returncode == 0 and len(pngs) == 1,
              f"live (d): exit {proc.returncode}, PNGs {pngs}:\n{err}")
    else:
        check(proc.returncode != 0 and 'matplotlib' in err
              and '--no-gui' in err and not pngs,
              f"live (d): exit {proc.returncode}, PNGs {pngs}, the error "
              f"does not name matplotlib and --no-gui:\n{out}\n{err}")
    return res


def check_live_anchors(tag, sol, g):
    """The golden anchors of the canonical run (phase 4's bounds)."""
    import numpy as np
    td = sol.timedata.data()
    check(sol.computed_steps == g['computed_steps'] == 1674
          and sol.stop_reason == g['stop_reason'] == 'energy'
          and sol.tau0 == g['tau0'],
          f"{tag}: stop {sol.computed_steps} ({sol.stop_reason}), tau0 "
          f"{sol.tau0}")
    check(abs(sol.t0 / g['t0'] - 1) <= 1e-12, f'{tag}: t0 outside 1e-12')
    check(abs(td[0, 1] / g['E_first'] - 1) <= 1e-12,
          f'{tag}: E_first outside 1e-12')
    check(abs(td[-1, 1] / g['E_last'] - 1) <= 1e-10,
          f'{tag}: E_last outside 1e-10')
    rel = float(np.max(np.abs(td[::100, 1] / np.asarray(g['E_every_100'])
                              - 1)))
    check(rel <= 1e-10, f'{tag}: E_every_100 outside 1e-10')
    check(int(td[:, 2].argmax()) == g['argmax_E2'],
          f'{tag}: argmax E2 differs')
    return rel


def live_canonical(work):
    """(a) the canonical run through ``Simulator.solve`` with ``png``,
    ``no_gui`` and ``update_every=100``: the stop and the anchors, the
    rows and U of a Solver resumed at the same boundaries to the bit, one
    refresh per chunk and one ``render_to``."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator, Solver
    from chsimpy_tpu_torch.ops import kernels as K

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'default_n512_anchors.json')) as f:
        g = json.load(f)
    every = LIVE_CANONICAL_EVERY
    p = Parameters(no_gui=True, png=True, update_every=every,
                   device='cuda', kappa_tilde=KAPPA,
                   file_id=os.path.join(work, 'live'))
    with stand_in_views():
        sim = Simulator(p)
        K.reset_launches()
        t0 = time.perf_counter()
        sol = sim.solve()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(K.launches)
        sim.render()
    view = sim.view
    tag = 'live (a) canonical run, update_every 100'
    rel = check_live_anchors(tag, sol, g)
    ref = Solver(Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA))
    ref.prepare()
    while ref.solution.stop_reason == 'None':
        ref.solve_or_resume(every)
    same_rows = np.array_equal(sol.timedata.data(),
                               ref.solution.timedata.data())
    same_U = bool(torch.equal(sol.U, ref.solution.U))
    chunks = -(-sol.computed_steps // every)
    res = {'computed_steps': sol.computed_steps,
           'stop_reason': sol.stop_reason, 'tau0': sol.tau0,
           'E_every_100_max_rel': rel, 'seconds': seconds,
           'steps_per_s': (sol.computed_steps - 1) / seconds,
           'refreshes': view.refreshes, 'chunks': chunks,
           'rendered': [os.path.basename(f) for f in view.rendered],
           'arrays': sorted(map(str, view.shapes)),
           'copies_per_refresh': sorted(view.copies_per_refresh()),
           'rows_equal_resumed': same_rows, 'U_equal_resumed': same_U,
           'launches': launches}
    print(f"{tag}: {json.dumps(res)}", flush=True)
    check(same_rows and same_U,
          f"{tag}: rows equal {same_rows}, U equal {same_U} to the Solver "
          f"resumed every {every} steps")
    check(view.refreshes == chunks == 17,
          f"{tag}: {view.refreshes} refreshes for {chunks} chunks (17)")
    check(len(view.rendered) == 1 and os.path.exists(view.rendered[0]),
          f"{tag}: render_to {view.rendered}")
    check(view.shapes == {('numpy', 'ndarray', (512, 512))}
          and view.copies_per_refresh() == {1},
          f"{tag}: the panels got {view.shapes}, "
          f"{view.copies_per_refresh()} copies a refresh")
    for name in MATMUL_PATH:
        check(launches[name] >= sol.computed_steps - 1,
              f"{tag}: {name} launched {launches[name]} times in "
              f"{sol.computed_steps} steps")
    return res


def live_rate(card, work):
    """(b) N=4096 float32 matmul full_sim after LIVE_WARM steps: steps/s
    of LIVE_WINDOW steps as one solve_or_resume and through the live loop
    (a refresh every LIVE_EVERY steps), in turns; the host time of one
    push_solution_view (its one copy of U)."""
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator
    from chsimpy_tpu_torch.simulator import (push_solution_view,
                                             solution_time_total)

    p = Parameters(N=4096, precision='float32', full_sim=True,
                   generator='uniform', kappa_tilde=KAPPA, chunk_size=1024,
                   transform_backend='matmul', matmul_precision='highest',
                   no_gui=True, png=True, update_every=LIVE_EVERY,
                   ntmax=LIVE_WINDOW, device='cuda',
                   file_id=os.path.join(work, 'rate'))
    rates = {'straight': [], 'live': []}
    with stand_in_views():
        sim = Simulator(p)
        solver = sim.solver
        solver.prepare()
        solver.solve_or_resume(LIVE_WARM)
        for turn in LIVE_TURNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if turn == 'straight':
                solver.solve_or_resume(LIVE_WINDOW)
            else:
                sim.steps_total = 0
                sim._live_solve()
            torch.cuda.synchronize()
            rates[turn].append(LIVE_WINDOW / (time.perf_counter() - t0))
        push_ms = []
        sol = solver.solution
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            push_solution_view(sim.view, p, sol, solution_time_total(p, sol))
            push_ms.append((time.perf_counter() - t0) * 1e3)
    view = sim.view
    ratio = statistics.mean(rates['live']) / statistics.mean(
        rates['straight'])
    refreshes = sum(t == 'live' for t in LIVE_TURNS) * (LIVE_WINDOW
                                                       // LIVE_EVERY)
    res = {'N': 4096, 'dtype': 'float32', 'warm': LIVE_WARM,
           'window': LIVE_WINDOW, 'update_every': LIVE_EVERY,
           'turns': list(LIVE_TURNS), 'steps_per_s': rates,
           'live_over_straight': ratio, 'push_solution_view_ms': push_ms,
           'refreshes': view.refreshes,
           'computed_steps': sol.computed_steps}
    print(f"live (b) N=4096 float32: steps/s straight "
          f"{rates['straight']}, live (refresh every {LIVE_EVERY}) "
          f"{rates['live']}, live/straight {ratio:.4f}; one "
          f"push_solution_view {push_ms} ms  ({card})", flush=True)
    check(view.refreshes == refreshes,
          f"live (b): {view.refreshes} refreshes, {refreshes} expected")
    check(sol.computed_steps == LIVE_WARM + LIVE_WINDOW * len(LIVE_TURNS),
          f"live (b): {sol.computed_steps} steps")
    check(bool(torch.isfinite(sol.U).all()), 'live (b): the field')
    check(view.shapes == {('numpy', 'ndarray', (4096, 4096))},
          f"live (b): the panels got {view.shapes}")
    del sim, solver, sol
    torch.cuda.empty_cache()
    return res


def live_batch(card):
    """(c) the canonical R=16 N=512 float64 batch with the experiment's
    live-view hook and its chunk (update_every = 100), beside the batch at
    chunk 1024: every member's stop, rows and U to the bit; the member-0
    previews are 512² host arrays; member-steps/s and step iterations."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch import experiment as texp
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    from chsimpy_tpu_torch.ops import kernels as K

    pairs = canonical_pairs()
    p = Parameters(no_gui=True, device='cuda',
                   update_every=LIVE_CANONICAL_EVERY)
    _, sols_ref, rate_ref, launches_ref = _ensemble_run(
        p, pairs, CANONICAL_KAPPAS)
    with stand_in_views():
        view = texp.make_live_view(p)
        hook = texp.live_view_hook(view, p)
        ens = EnsembleSolver(p.deepcopy(), pairs,
                             kappas=np.asarray(CANONICAL_KAPPAS))
        ens.chunk_size = texp.live_chunk_size(ens.chunk_size,
                                              p.update_every)
        ens.prepare()
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        sols = ens.solve_or_resume(None, on_chunk=hook)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(K.launches)
    rate = sum(s.computed_steps - 1 for s in sols) / seconds
    same = [s.computed_steps == r.computed_steps
            and s.stop_reason == r.stop_reason
            and np.array_equal(s.timedata.data(), r.timedata.data())
            and bool(torch.equal(s.U, r.U))
            for s, r in zip(sols, sols_ref)]
    it_live = launches['chemical_potential_members']
    it_ref = launches_ref['chemical_potential_members']
    res = {'R': 16, 'N': 512, 'dtype': 'float64',
           'chunk': ens.chunk_size, 'stops': [s.computed_steps for s in sols],
           'members_equal_chunk_1024': sum(same),
           'member_steps_per_s': {'live_chunk_100': rate,
                                  'chunk_1024': rate_ref},
           'step_iterations': {'live_chunk_100': it_live,
                               'chunk_1024': it_ref},
           'refreshes': view.refreshes,
           'previews': sorted(map(str, view.shapes)),
           'launches': launches}
    print(f"live (c) canonical batch with the live view: "
          f"{json.dumps(res)}  ({card})", flush=True)
    check(all(same), f"live (c): members equal to the chunk-1024 run "
                     f"{same}")
    check(view.shapes == {('numpy', 'ndarray', (512, 512))}
          and view.refreshes == len(view.calls) == -(-it_live // 100),
          f"live (c): previews {view.shapes}, {view.refreshes} refreshes "
          f"for {it_live} step iterations")
    for name, single in MEMBER_KERNELS.items():
        check(launches[name] == it_live and launches[single] == 0,
              f"live (c): {name} launched {launches[name]} times in "
              f"{it_live} step iterations, {single} {launches[single]}")
    del ens, sols, sols_ref
    torch.cuda.empty_cache()
    return res


def live_phase(card):
    """Phase 13: (d) started, (a), (d) read, (b), (c)."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix='chip_smoke_live_')
    cli_dir = os.path.join(work, 'cli')
    os.makedirs(cli_dir)
    proc = start_no_fallback(cli_dir)
    try:
        out = {'canonical': live_canonical(work)}
        out['no_fallback'] = finish_no_fallback(proc, cli_dir)
        out['rate'] = live_rate(card, work)
        out['batch'] = live_batch(card)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 14: the distributed ensemble (K7_members), the checkpoint under
# --mesh and the multi-process experiment
# ----------------------------------------------------------------------

# the worlds' ranks share the one card, so they take gloo (NCCL takes one
# card a rank): every collective is staged through host memory
DIST_BACKEND = 'gloo'
# (a): (R, N, dtype) of K7_members on block (1, 0) of a 2x2 mesh; the
# JSON line's row
LOCAL_MEMBER_SHAPES = ((4, 512, 'float64'), (4, 4096, 'float32'),
                       (4, 4096, 'float64'))
LOCAL_MEMBER_REPORT = (4, 4096, 'float32')
# (b): steps of the re-entry after every member's stop
ENS_THEN = 100
# (c): (R, N, steps) of the grid ensembles on a (1, 2, 2) world
GRID_ENS_512 = (4, 512, 256)
GRID_ENS_4096 = (4, 4096, 32)
# (e): the single run's saves (every 800 steps at chunks of 200: steps 801
# and 1601) and the step the file holds
MESH_CKPT = {'checkpoint_every': 800, 'chunk_size': 200}
MESH_CKPT_STEP = 1601


def member_block_halo(F, i, j, bn, bw):
    """Block (i, j) of every member's field F (R, N, N) and the stacked
    halo vectors ((R, bw) rows, (R, bn) columns; edge-replicated at the
    global boundary)."""
    N = F.shape[-1]
    r0, r1, c0, c1 = i * bn, (i + 1) * bn, j * bw, (j + 1) * bw
    return (F[:, r0:r1, c0:c1].contiguous(),
            (F[:, max(r0 - 1, 0), c0:c1].contiguous(),
             F[:, min(r1, N - 1), c0:c1].contiguous(),
             F[:, r0:r1, max(c0 - 1, 0)].contiguous(),
             F[:, r0:r1, min(c1, N - 1)].contiguous()))


def local_members_bound(R, bn, bw, dtype):
    """bound_fields of K7_members: each member's block of U and E and its
    halo read once, its A0/A1 read and its five float64 sums written."""
    s = 4 if dtype == 'float32' else 8
    n = bn * bw
    return bound_fields(R * (2 * n + 2 * (bn + bw)) * s + R * (2 * 8 + 5 * 8),
                        OPS_PER_ELEM['stats'] * R * n, dtype)


def local_members_kernel_phase(dev, card):
    """(a) K7_members on block (1, 0) of a 2x2 mesh of R member fields
    against its plain version (K3's tolerances, the count exact) and,
    member by member, against the single K7 launch on the member's block
    with its halo and scalars (the same bits); one count a call; device
    ms of the batched launch, of R single launches and of the plain
    version, and the bound."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for R, N, dname in LOCAL_MEMBER_SHAPES:
        dtype = getattr(torch, dname)
        f64 = dtype == torch.float64
        cfg, c, U, E, _, _, _ = member_inputs(R, N, dtype, dev)
        bn = bw = N // 2
        i, j = 1, 0
        Ub, halo = member_block_halo(U, i, j, bn, bw)
        Eb = member_block_halo(E, i, j, bn, bw)[0]
        A0s, A1s = c['A0'], c['A1']
        a0, a1 = A0s.tolist(), A1s.tolist()
        skw = dict(N=N, delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                   threshold=cfg.threshold)
        args = (Ub, *halo, Eb, A0s, A1s, i * bn, j * bw)

        def kern():
            return K.local_band_sums_members(*args, **skw)

        def ref():
            return K.local_band_sums_members_ref(*args, **skw)

        def single(r):
            return K.local_band_sums(Ub[r], *(h[r] for h in halo), Eb[r],
                                     a0[r], a1[r], i * bn, j * bw, **skw)

        K.reset_launches()
        got = kern()
        counted = K.launches['local_band_sums_members']
        want = ref()
        torch.cuda.synchronize()
        same = all(torch.equal(got[r], single(r)) for r in range(R))
        d = (got - want).abs()
        err = d.max().item()
        rel = (d / want.abs()).max().item()
        rtol = 1e-12 if f64 else 1e-5
        count_exact = bool(torch.equal(got[:, 3], want[:, 3]))
        ok = rel <= rtol and count_exact and same and counted == 1
        tol = (f'rtol {rtol:g}, count exact; each member the single K7 '
               f'launch\'s bits; one count a call')
        row = {'name': 'local_band_sums_members', 'R': R, 'N': N,
               'dtype': dname, 'mesh': '2x2', 'block': f'{bn}x{bw}',
               'max_abs_err': err, 'max_rel_err': rel,
               'members_equal_single_launch': same, 'tolerance': tol,
               'ok': ok, **timed_row(kern, ref),
               'single_launches_ms': device_ms(
                   lambda: [single(r) for r in range(R)]),
               **local_members_bound(R, bn, bw, dname),
               **stats_turns('14 (a)', kern, bn, bw, Ub, Eb,
                             lambda t, prev=False:
                             K._local_band_sums_members_launch(
                                 *args, t, prev=prev, **skw))}
        row['bound_share'] = row['bound_ms'] / row['ms']
        rows.append(row)
        print(f"kernel local_band_sums_members R={R} N={N} {dname} block "
              f"{bn}x{bw}: rel={rel:.3e} members=single "
              f"{'yes' if same else 'NO'} ({tol}) "
              f"{'ok' if ok else 'FAIL'}  kernel {row['ms']:.4f} ms (one "
              f"call {row['call_ms']:.4f}; {R} single launches "
              f"{row['single_launches_ms']:.4f})  plain "
              f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {row['bound_share']:.0%})  tile "
              f"{row['tile']} (the fixed tile {row['earlier_tile']}) "
              f"{turns_text(row)}{body_text(row)}  ({card})",
              flush=True)
        check(ok, f"K7_members R={R} N={N} {dname}: rel {rel:.3e}, count "
                  f"exact {count_exact}, members equal {same}, {counted} "
                  f"counts")
        del U, E, Ub, Eb, halo, c
        torch.cuda.empty_cache()
    return rows


# (a): (R, N, dtype) of K11 (each member's Ra; on the main path its body
# runs in K4_members' second pass, whose JSON row names what it replaces)
ROW_ABSDEV_SHAPES = ((16, 512, 'float64'), (4, 4096, 'float32'),
                     (4, 4096, 'float64'))
ROW_ABSDEV_REPLACES = ('no Pallas counterpart: jnp.mean twice on the mid '
                       'row in chsimpy_tpu/core/stepper.py:473, vmapped '
                       'over the member axis (chsimpy_tpu/ensemble.py)')


def row_absdev_kernel_phase(dev, card):
    """(a) K11 (each member's Ra) against its plain version (1e-12 / 1e-5
    relative) and member by member against its launch on the member
    alone (the same bits: the order does not depend on the member
    count); one count a call; device ms, the plain version's and the
    bound (each row read once, R float64 written)."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for R, N, dname in ROW_ABSDEV_SHAPES:
        dtype = getattr(torch, dname)
        U = member_inputs(R, N, dtype, dev)[2]
        row = N // 2 + 1
        K.reset_launches()
        got = K.row_absdev_members(U, row)
        counted = K.launches['row_absdev_members']
        want = K.row_absdev_members_ref(U, row)
        alone = torch.cat([K.row_absdev_members(U[r:r + 1], row)
                           for r in range(R)])
        torch.cuda.synchronize()
        same = bool(torch.equal(got, alone))
        rel = ((got - want).abs() / want.abs()).max().item()
        rtol = 1e-12 if dtype == torch.float64 else 1e-5
        ok = rel <= rtol and same and counted == 1
        s = U.element_size()
        row_out = {'name': 'row_absdev_members', 'R': R, 'N': N,
                   'dtype': dname,
                   'max_abs_err': (got - want).abs().max().item(),
                   'max_rel_err': rel, 'members_equal_alone': same,
                   'tolerance': f'rtol {rtol:g}; each member its launch '
                                f'alone to the bit; one count a call',
                   'ok': ok,
                   **timed_row(lambda: K.row_absdev_members(U, row),
                               lambda: K.row_absdev_members_ref(U, row)),
                   **bound_fields(R * N * s + R * 8, 5 * R * N, dname)}
        row_out['bound_share'] = row_out['bound_ms'] / row_out['ms']
        rows.append(row_out)
        print(f"kernel row_absdev_members R={R} N={N} {dname}: rel="
              f"{rel:.3e} members=alone {'yes' if same else 'NO'} "
              f"{'ok' if ok else 'FAIL'}  kernel {row_out['ms']:.4f} ms "
              f"(one call {row_out['call_ms']:.4f})  plain "
              f"{row_out['plain_ms']:.4f} ms  bound "
              f"{row_out['bound_ms']:.5f} ms  ({card})", flush=True)
        check(ok, f"K11 R={R} N={N} {dname}: rel {rel:.3e}, members equal "
                  f"{same}, {counted} counts")
    # the fused pass on (c)'s grid ensemble: a rank's (N/2, N/2) blocks
    # with their members' mean and the gathered mid rows (R, 1, N)
    R, N, steps = GRID_ENS_512
    U = member_inputs(R, N, torch.float64, dev)[2]
    Ub = U[:, :N // 2, :N // 2].contiguous()
    mid = U[:, N // 2 + 1].contiguous().unsqueeze(1)
    mean = (U.sum((1, 2)) / (N * N)).to(U.dtype)
    row = {'name': 'absdev_ra_members', 'R': R, 'N': N, 'dtype': 'float64',
           'mesh': '(1, 2, 2)', 'block': f'{N // 2}x{N // 2}',
           **fused_ra_turns('14 (a)', Ub, mean, mid, 0)}
    rows.append(row)
    fused_ms = statistics.median(row['ms_fused_turns'])
    print(f"kernel absdev_ra_members R={R} N={N} float64 on (c)'s "
          f"{row['block']} blocks: {fused_ms:.4f} ms; K4 + K11 "
          f"{row['k4_k11_ms']:.4f} ms, the same bits, turns "
          f"{row['k4_k11_ms_turns']} / {row['ms_fused_turns']}  ({card})",
          flush=True)
    return rows


def _world(shape, tasks, timeout=600):
    """``spawn_world`` of ``shape`` on the card (gloo), and its seconds."""
    from chsimpy_tpu_torch.parallel.distributed import spawn_world
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    t0 = time.perf_counter()
    res = spawn_world(run_tasks, shape, backend=DIST_BACKEND, device='cuda',
                      args=(tasks,), timeout=timeout)
    return res, time.perf_counter() - t0


def _no_jax(tag, res, k):
    for r in res:
        check(not {'jax', 'jaxlib', 'chsimpy_tpu'} & set(r[k]),
              f"{tag}: a rank imported {r[k]}")


def _members_of(sols) -> dict:
    """Solutions as the per-member lists a world's ensemble task returns
    (``parallel/workers.py`` ``_ensemble_out``)."""
    import numpy as np
    return {'computed_steps': [s.computed_steps for s in sols],
            'tau0': [s.tau0 for s in sols], 't0': [s.t0 for s in sols],
            'timedata': [s.timedata.data() for s in sols],
            'U': np.stack([s.U.cpu().numpy() for s in sols])}


def _same_members(a, b):
    """True when the members of two results (:func:`_members_of`) hold
    the same bits."""
    import numpy as np
    return (all(list(a[k]) == list(b[k])
                for k in ('computed_steps', 'tau0', 't0'))
            and all(np.array_equal(x, y)
                    for x, y in zip(a['timedata'], b['timedata']))
            and np.array_equal(np.asarray(a['U']), np.asarray(b['U'])))


def ens_world_phase(card, work):
    """(b) the canonical batch on an 'ens' world of 2 ranks: every
    member's rows, U, stop, tau0 and t0 equal phase 10 (b)'s batch to the
    bit on both ranks; K1-K4 member-batched on every step of each rank;
    member-steps/s.  Its ensemble checkpoint (saved after the stops)
    restores on one device with the world's bits, and both re-enter for
    ENS_THEN steps with the same bits."""
    from chsimpy_tpu_torch import checkpoint

    ck = os.path.join(work, 'ens-world.npz')
    res, seconds = _world((2, 1, 1), [
        ('ensemble', {'params': {'no_gui': True, 'device': 'cuda'},
                      'pairs': canonical_pairs(),
                      'kappas': list(CANONICAL_KAPPAS), 'save': ck,
                      'then': ENS_THEN}),
        ('imported', {})])
    _no_jax('phase 14 (b)', res, 1)
    ref = KEPT['canonical']
    runs = [r[0] for r in res]
    equal = [_same_members(g, ref) for g in runs]
    for rank, g in enumerate(runs):
        # a rank leaves a chunk once its own members have stopped
        iterations = max(ref['computed_steps'][8 * rank:8 * rank + 8]) - 1
        lc = g['launches']
        check(g['local_members'] == (8 * rank, 8 * rank + 8),
              f"phase 14 (b) rank {rank}: members {g['local_members']}")
        for name, single in MEMBER_KERNELS.items():
            check(lc[name] >= iterations and lc[single] == 0,
                  f"phase 14 (b) rank {rank}: {name} {lc[name]}, {single} "
                  f"{lc[single]} in {iterations} step iterations")
    restored = checkpoint.restore_ensemble(ck, device='cuda')
    handoff_equal = _same_members(_members_of(restored.solutions()),
                                  runs[0])
    then = _members_of(restored.solve_or_resume(ENS_THEN))
    then_equal = _same_members(then, runs[0]['then'])
    out = {'world': '(2, 1, 1)', 'mesh': runs[0]['mesh'],
           'members_equal_phase10b': equal,
           'member_steps_per_s': [g['member_steps_per_s'] for g in runs],
           'solve_seconds': [g['seconds'] for g in runs],
           'world_seconds': seconds, 'launches': [g['launches']
                                                  for g in runs],
           'checkpoint_handoff_equal': handoff_equal,
           'then_steps': ENS_THEN,
           'then_computed_steps': then['computed_steps'],
           'then_equal': then_equal}
    print(f"phase 14 (b) canonical batch on {runs[0]['mesh']}: 16 members "
          f"= phase 10 (b) to the bit on ranks {equal}; "
          + ', '.join(f"rank {k} {g['member_steps_per_s']:.1f} "
                      f"member-steps/s" for k, g in enumerate(runs))
          + f"; world {seconds:.1f} s; its checkpoint on one device: "
          f"handoff {handoff_equal}, {ENS_THEN} more steps "
          f"{then_equal}  ({card})", flush=True)
    check(all(equal), f"phase 14 (b): members differ from phase 10 (b) "
                      f"({equal})")
    check(handoff_equal and then_equal,
          f"phase 14 (b): the checkpoint on one device: handoff "
          f"{handoff_equal}, re-entry {then_equal}")
    del restored
    return out


def grid_ens_phase(card, E_single):
    """(c) grid ensembles and (e) the single run's checkpoint under
    --mesh, on one (1, 2, 2) world of 4 ranks (:func:`grid_ens_tasks`,
    :func:`grid_ens_check`); in a full run the tasks run in phase 15's
    world of the same shape instead (a world's start costs ~10-25 s)."""
    tasks, ctx = grid_ens_tasks(E_single)
    world, seconds = _world((1, 2, 2), tasks + [('imported', {})])
    _no_jax('phase 14 (c)', world, 3)
    return grid_ens_check(world, seconds, ctx, card)


def grid_ens_tasks(E_single):
    """(c) and (e)'s world tasks and what they are held to: one device's
    batches from the same pairs, phase 8 (c)'s checkpoint, phase 4's
    run."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters, checkpoint

    R, N, steps = GRID_ENS_512
    pairs, kappas = canonical_pairs(R), list(CANONICAL_KAPPAS[:R])
    p512 = {'no_gui': True, 'device': 'cuda'}
    Rb, Nb, steps_b = GRID_ENS_4096
    pbig = {'N': Nb, 'precision': 'float32', 'full_sim': True,
            'generator': 'uniform', 'no_gui': True, 'device': 'cuda',
            'transform_backend': 'matmul', 'matmul_precision': 'highest'}
    # one device's batches, from the same pairs
    _, one512, _, _ = _ensemble_run(Parameters(**p512), pairs, kappas,
                                    steps)
    E512 = [s.timedata.data()[:, 1] for s in one512]
    ens, onebig, _, _ = _ensemble_run(Parameters(**pbig), pairs, kappas,
                                      steps_b)
    Ebig = [s.timedata.data()[:, 1] for s in onebig]
    U0_mean = float(np.mean(ens.U_init))
    del ens, onebig, one512
    torch.cuda.empty_cache()

    ck = KEPT['mesh_run']['ckpt']
    params, payload = checkpoint.load_checkpoint(ck, device='cuda')
    tasks = [('ensemble', {'params': p512, 'pairs': pairs, 'kappas': kappas,
                           'steps': steps, 'return_U': False}),
             ('solve', {'params': {'restore_file': ck, 'ntmax': int(1e6)},
                        'return_U': False}),
             ('ensemble', {'params': pbig, 'pairs': pairs, 'kappas': kappas,
                           'steps': steps_b, 'return_U': False})]
    return tasks, {'E512': E512, 'Ebig': Ebig, 'U0_mean': U0_mean,
                   'mesh_shape': params.mesh_shape,
                   'saved_at': payload['header']['computed_steps'],
                   'E_single': E_single}


def grid_ens_check(world, seconds, ctx, card):
    """(c) and (e) from the world's results (each rank's list, the tasks
    of :func:`grid_ens_tasks` first): R=4 N=512 float64 over 256 steps (E
    within 1e-10 of one device's batch, the rows the same on every rank;
    K7_members on every step: the JSON line's count) and R=4 N=4096
    float32 full_sim over 32 steps (E within 1e-6 of one device's batch,
    mean(U) within 1e-6 of its start, ms per step iteration and each
    rank's peak memory); phase 8 (c)'s checkpoint (MESH_CKPT_STEP)
    restored on that world: the stop 1674 and phase 8 (c)'s rows (that
    run re-entered at the same step) to the bit, E within 1e-10 of phase
    4's run."""
    import numpy as np
    R, N, steps = GRID_ENS_512
    Rb, Nb, steps_b = GRID_ENS_4096
    E512, Ebig, U0_mean = ctx['E512'], ctx['Ebig'], ctx['U0_mean']
    saved_at, E_single = ctx['saved_at'], ctx['E_single']
    mesh_shape = ctx['mesh_shape']

    # (c) N=512
    g512 = [r[0] for r in world]
    same512 = all(all(np.array_equal(a, b) for a, b in
                      zip(g['timedata'], g512[0]['timedata']))
                  for g in g512)
    rel512 = max(float(np.max(np.abs(td[:, 1] / e - 1)))
                 for td, e in zip(g512[0]['timedata'], E512))
    lc = g512[0]['launches']
    it512 = steps - 1
    path = ('chemical_potential_members', 'spectral_update_members',
            'local_band_sums_members', 'absdev_sum_members')
    for g in g512:
        check(all(g['launches'][k] >= it512 for k in path)
              and g['launches']['stats_sums_members'] == 0
              and g['launches']['local_band_sums'] == 0
              and g['launches']['row_absdev_members'] == 0,
              f"phase 14 (c) N={N}: launches {g['launches']}")
    # (c) N=4096
    gbig = [r[2] for r in world]
    samebig = all(all(np.array_equal(a, b) for a, b in
                      zip(g['timedata'], gbig[0]['timedata']))
                  for g in gbig)
    relbig = max(float(np.max(np.abs(td[:, 1] / e - 1)))
                 for td, e in zip(gbig[0]['timedata'], Ebig))
    drift = max(abs(m - U0_mean) for m in gbig[0]['U_mean'])
    ms_step = [g['seconds'] / (steps_b - 1) * 1e3 for g in gbig]
    peak_gb = [g['peak_bytes'] / 1e9 for g in gbig]
    # (e)
    restored = [r[1] for r in world]
    same_ranks = all(np.array_equal(r['timedata'], restored[0]['timedata'])
                     for r in restored)
    rows_equal = np.array_equal(restored[0]['timedata'],
                                KEPT['mesh_run']['timedata'])
    td = restored[0]['timedata']
    E1 = np.asarray(E_single)
    rel_single = float(np.max(np.abs(td[:, 1] / E1 - 1))) \
        if len(td) == len(E1) else float('inf')
    out = {'n512': {'R': R, 'N': N, 'steps': steps, 'mesh': g512[0]['mesh'],
                    'E_max_rel_vs_one_device': rel512,
                    'rows_same_on_every_rank': same512,
                    'member_steps_per_s': [g['member_steps_per_s']
                                           for g in g512],
                    'launches': [g['launches'] for g in g512]},
           'n4096': {'R': Rb, 'N': Nb, 'steps': steps_b,
                     'E_max_rel_vs_one_device': relbig,
                     'rows_same_on_every_rank': samebig,
                     'U_mean_drift': drift, 'ms_per_step_iteration': ms_step,
                     'peak_GB_per_rank': peak_gb},
           'checkpoint': {'saved_at': saved_at,
                          'mesh_shape': mesh_shape,
                          'restored_computed_steps':
                              restored[0]['computed_steps'],
                          'stop_reason': restored[0]['stop_reason'],
                          'rows_equal_phase8_run': rows_equal,
                          'rows_same_on_every_rank': same_ranks,
                          'E_max_rel_vs_phase4': rel_single},
           'world_seconds': seconds, 'launches': lc}
    print(f"phase 14 (c) R={R} N={N} float64 {steps} steps on "
          f"{g512[0]['mesh']}: E vs one device {rel512:.3e}, rows the same "
          f"on every rank {same512}; R={Rb} N={Nb} float32 {steps_b} "
          f"steps: E vs one device {relbig:.3e}, mean(U) drift "
          f"{drift:.3e}, ms per step iteration "
          + ', '.join(f'{m:.1f}' for m in ms_step) + ", peak GB per rank "
          + ', '.join(f'{m:.2f}' for m in peak_gb)
          + f" (4 ranks on one card, gloo)  ({card})", flush=True)
    print(f"phase 14 (e) phase 8 (c)'s canonical run on a 2x2 world, "
          f"saved at {saved_at} (mesh_shape {mesh_shape}), restored "
          f"on a new world: stop {restored[0]['computed_steps']} "
          f"({restored[0]['stop_reason']}), rows = phase 8 (c)'s "
          f"{rows_equal}, the same on every rank {same_ranks}, E vs phase "
          f"4 {rel_single:.3e}; the world's {seconds:.1f} s  "
          f"({card})",
          flush=True)
    check(same512 and rel512 <= 1e-10,
          f"phase 14 (c) N={N}: E {rel512:.3e}, ranks same {same512}")
    check(samebig and relbig <= 1e-6 and drift <= 1e-6
          and all(g['U_finite'] for g in gbig),
          f"phase 14 (c) N={Nb}: E {relbig:.3e}, drift {drift:.3e}, ranks "
          f"same {samebig}")
    check(saved_at == MESH_CKPT_STEP and tuple(mesh_shape) == (2, 2),
          f"phase 14 (e): the file holds step {saved_at}, mesh "
          f"{mesh_shape}")
    check(restored[0]['computed_steps'] == 1674
          and restored[0]['stop_reason'] == 'energy' and rows_equal
          and same_ranks and rel_single <= 1e-10,
          f"phase 14 (e): {out['checkpoint']}")
    return out


def uq_process(argv) -> int:
    """One process of phase 14 (d): ``experiment.main(argv)`` with the
    sympy solves looked up in SOBOL_MATERIAL (the card's machine has no
    sympy)."""
    from chsimpy_tpu_torch import experiment
    with _MaterialTable():
        experiment.main(argv)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def uq_two_processes(card, work):
    """(d) phase 11 (a)'s float64 design as two processes of the
    experiment (``--coordinator``, gloo, each in its own directory):
    results.csv and results-agg.csv the bytes of phase 11 (a)'s
    single-process run, the same per-run files, process 0 alone writing
    the tables and each process the runs it owns; the wall seconds."""
    coord = f'127.0.0.1:{_free_port()}'
    dirs = [os.path.join(work, f'p{k}') for k in (0, 1)]
    procs = []
    t0 = time.perf_counter()
    try:
        for k, d in enumerate(dirs):
            os.makedirs(d)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
                 '--uq-process', *UQ_ARGV, '--precision', 'float64', '-f',
                 'uq64', '--coordinator', coord, '--num-processes', '2',
                 '--process-id', str(k), '--dist-backend', DIST_BACKEND],
                cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    check(rcs == [0, 0], f"phase 14 (d): exit codes {rcs}:\n"
                         + '\n'.join(o[-3000:] for o in outs))
    want = KEPT['uq64']
    files = [sorted(os.listdir(d)) for d in dirs]
    tables = {s: open(os.path.join(dirs[0], f'uq64-{s}.csv'), 'rb').read()
              for s in ('results', 'results-agg')}
    equal = {s: tables[s] == want[s] for s in tables}
    owned = all(re.search(r'-run(\d+)\.', f) is None
                or int(re.search(r'-run(\d+)\.', f).group(1)) % 2 == k
                for k, fs in enumerate(files) for f in fs)
    shared = ('uq64-metadata.csv', 'uq64-results.csv',
              'uq64-results-agg.csv')
    out = {'processes': 2, 'backend': DIST_BACKEND,
           'results_byte_equal': equal['results'],
           'agg_byte_equal': equal['results-agg'],
           'file_set_equal': sorted(files[0] + files[1]) == want['files'],
           'each_process_its_runs': owned,
           'tables_by_process_0_only': all(f in files[0] for f in shared)
           and not any(f in files[1] for f in shared),
           'wall_s': wall}
    print(f"phase 14 (d) the experiment as 2 processes ({DIST_BACKEND}): "
          f"{json.dumps(out)}  ({card})", flush=True)
    check(all(v is True for k, v in out.items()
              if k not in ('processes', 'backend', 'wall_s')),
          f"phase 14 (d): {out}")
    return out


def distributed_phase(dev, card, E_single, merged=False):
    """Phase 14; ``merged`` (a full run): (c) and (e) are prepared here and
    run in phase 15's world, which checks them (KEPT['grid_ens'])."""
    import shutil
    import tempfile
    out = {'kernels': local_members_kernel_phase(dev, card),
           'row_absdev': row_absdev_kernel_phase(dev, card)}
    work = tempfile.mkdtemp(prefix='chip_smoke_dist_')
    try:
        t0 = time.perf_counter()
        out['ens_world'] = ens_world_phase(card, work)
        out['seconds_b'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if merged:
            KEPT['grid_ens'] = grid_ens_tasks(E_single)
        else:
            out['grid'] = grid_ens_phase(card, E_single)
        out['seconds_c_e'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['experiment'] = uq_two_processes(card, os.path.join(work, 'uq'))
        out['seconds_d'] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 15: the pencil layout (split and ozaki under --mesh, the single
# run and the grid ensemble; K5 sharded; the collective audit)
# ----------------------------------------------------------------------

PENCIL_D = 4
# (a) K5 sharded against K5 on the whole field, in the world: (N, kind,
# layout, members); 'block': the max in one block only, 'ulp': the max
# one ulp above 2^8 in one block only
PENCIL_SLICE_CASES = tuple((N, kind, layout, 0) for N in (4096, 1000)
                           for kind in ('block', 'ulp')
                           for layout in ('field', 'spec')) + (
    (512, 'ulp', 'field', 4), (512, 'block', 'spec', 4),
    (1000, 'ulp', 'spec', 2))
PENCIL_SLICE_N = 6              # the inverse's slices; the forward's: 4
PENCIL_SLICE_REPORT = (4096, 4)        # the JSON line's K5 sharded row
PENCIL_MEMBER_REPORT = (4, 512, 4)     # and K5_members sharded's
PENCIL_BLOCK_NS = (4096, 64)
PENCIL_FAST = (4096, 64)        # (c): N, steps (float32 split)
PENCIL_OZAKI = (4096, 32)       # (d): N, steps (float64 ozaki)
PENCIL_ENS = (4, 512, 256)      # (e): R, N, steps
PENCIL_RESTORE_MESH = (1, 4)    # (f): the restoring grid of the 4 ranks
# (b): the canonical runs' chunk; the split run saves at PENCIL_CKPT_STEP
# (its first boundary 1600 steps after entering) and re-enters there
PENCIL_CHUNK = 32
PENCIL_CKPT_STEP = 1601
# (b) on ozaki: the canonical run's first steps (the split run goes to the
# stop; a world step of the ozaki route costs ~30-40 ms on gloo ranks that
# share the card, so its run to the stop would take the phase past 150 s)
PENCIL_OZAKI_STEPS = 640
# (g)-(l): the grid layout where the rank count does not divide N, in the
# same world.  (g): K7, K8, K2 and K4 on every block of a grid whose block
# sides are no multiple of 8 (N, mesh), timed on the GRID_TIMED_NS blocks;
# the float32 matmul run (N, steps)
GRID_BLOCK_CASES = ((4094, (2, 2)), (1002, (2, 2)), (40, (2, 2)),
                    (36, (2, 4)), (34, (2, 2)))
GRID_TIMED_NS = (4094, 1002)
GRID_F32 = (4094, 32)
GRID_OZAKI = (4094, 32)         # (h): N, steps (float64 ozaki, (3, 5))
GRID_OZAKI_PINNED = (1002, 256)  # (i): N, steps, ozaki_fwd_pairs (5, 7)
GRID_CHUNK = 16
# (j): K5 sharded on each block of the 2x2 grid: (N, kind); the timed
# block calls (the JSON line's row: a block of N=4094, 6 slices)
GRID_SLICE_CASES = ((4094, 'block'), (4094, 'ulp'), (1002, 'block'),
                    (1002, 'ulp'))
GRID_SLICE_REPORT = (4094, 6)
GRID_SCALING = (1024, 64)       # (k): N, steps (float32)
GRID_PROFILE_STEPS = 4          # (l): traced step iterations after (c), (h)


class _OneRank:
    """A grid of one rank: K5 sharded's world max is its own (the timed
    launches alone, with no collective)."""
    size = 1


def sharded_slice_launch_ms(K, b, R, n):
    """Device time of each launch of K5 sharded on R blocks b alone: the
    max pass (max-only mode) and the slice pass (sharded mode)."""
    import torch
    world = K._slice_max_launch(b, R).view(torch.float64)
    return {'max pass (max-only mode)': device_ms(
                lambda: K._slice_max_launch(b, R)),
            'slice pass (sharded mode)': device_ms(
                lambda: K._slice_sharded_planes_launch(b, world, R, n))}


def sharded_slice_row(K, b, members, n, plain, **info):
    """K5 sharded on ``members`` blocks b (a one-rank grid: its world max
    left out): the call, each launch alone, the plain version, the
    bound."""
    one = _OneRank()
    if members > 1:
        def call():
            return K.slice_field_members_sharded(b, one, n)
    else:
        def call():
            return K.slice_field_sharded(b, one, n)
    got, sc = call()
    row = {**info, 'n_slices': n, 'block': '%dx%d' % tuple(b.shape[-2:]),
           **timed_row(call, plain),
           'launch_ms': sharded_slice_launch_ms(K, b, members, n),
           'library_ms': None, **slice_bound(b.numel(), n)}
    row['bound_share'] = row['bound_ms'] / row['ms']
    return row, got, sc


def sharded_slice_text(r):
    """The printed times of a sharded_slice_row."""
    launches = ', '.join(f"{k} {v:.4f}" for k, v in r['launch_ms'].items())
    return (f"{r['ms']:.4f} ms (one call {r['call_ms']:.4f}; {launches}) "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_share']:.0%})")


def pencil_slice_timing(dev, card):
    """(a) K5 sharded timed on a rank's column block (4096, 1024) of an
    N=4096 float64 field, and on R=4 members' (512, 128) blocks: the call
    (its world max left out: a one-rank grid), each launch alone, the
    plain version, four block calls beside one whole-field K5 call, and
    the bound."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    one = _OneRank()
    N, n = PENCIL_SLICE_REPORT
    rng = np.random.default_rng(N)
    x = torch.tensor(0.01 * (rng.random((N, N)) - 0.5), device=dev)
    b = x[:, :N // PENCIL_D].contiguous()
    amax = torch.abs(x).amax()
    row, got, sc = sharded_slice_row(
        K, b, 1, n, lambda: K.slice_field_ref(b, n, amax),
        name='slice_field_sharded', N=N)
    row['whole_field_K5_ms'] = device_ms(lambda: K.slice_field(x, n))
    want, wsc = K.slice_field_ref(b, n)
    torch.cuda.synchronize()
    row['max_abs_err'] = (got.int() - want.int()).abs().max().item()
    row['four_blocks_ms'] = PENCIL_D * row['ms']
    check(row['max_abs_err'] == 0 and sc.item() == wsc.item(),
          f"K5 sharded on a one-rank grid: planes {row['max_abs_err']}, "
          f"scale {sc.item()} vs {wsc.item()}")
    rows.append(row)
    R, Nm, n = PENCIL_MEMBER_REPORT
    xm = torch.tensor(rng.standard_normal((R, Nm, Nm)), device=dev)
    bm = xm[..., :Nm // PENCIL_D].contiguous()
    am = torch.abs(xm).amax(dim=(1, 2))
    row, got, sc = sharded_slice_row(
        K, bm, R, n, lambda: K.slice_field_members_ref(bm, n, am),
        name='slice_field_members_sharded', R=R, N=Nm)
    want, wsc = K.slice_field_members_ref(bm, n)
    torch.cuda.synchronize()
    row['max_abs_err'] = (got.int() - want.int()).abs().max().item()
    row['single_launches_ms'] = device_ms(lambda: [
        K.slice_field_sharded(bm[r], one, n) for r in range(R)])
    check(row['max_abs_err'] == 0 and torch.equal(sc, wsc),
          f"K5_members sharded on a one-rank grid: planes "
          f"{row['max_abs_err']}")
    rows.append(row)
    for r in rows:
        print(f"kernel {r['name']} {r.get('R', 1)} x {r['block']} block(s) "
              f"of {r['N']}x{r['N']} float64, {r['n_slices']} slices: "
              + sharded_slice_text(r)
              + (f"; 4 block calls {r['four_blocks_ms']:.4f} ms beside one "
                 f"whole-field K5 {r['whole_field_K5_ms']:.4f}"
                 if 'four_blocks_ms' in r else
                 f"; {r['R']} single block calls "
                 f"{r['single_launches_ms']:.4f} ms") + f"  ({card})",
              flush=True)
    return rows


def pencil_block_kernels(dev, card):
    """(a) K7, K8, K2 and K4 on the pencil blocks of D=4 ranks against
    their plain versions (K3's tolerances; K8 to the bit against K1 on
    the same block): K7 on each (N, N/4) column block with left and right
    halos (its own edges above and below), the blocks' sums in rank order
    against K3; K2 on a (N/4, N) row block; K4 on the column block with
    the whole field's mean; N=4096 and N=64 (W=16)."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N in PENCIL_BLOCK_NS:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cfg, c, U, E, hat_U, hat_E = kernel_inputs(N, dtype, dev)
            skw = dict(N=N, delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                       threshold=cfg.threshold)
            whole = K.stats_sums(U, E, cfg.A0, cfg.A1,
                                 **{k: v for k, v in skw.items()
                                    if k != 'N'})
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            c_ = N // PENCIL_D
            mean = (U.double().sum() / (N * N)).to(dtype)
            total, k7 = None, 0.0
            k8_same = k4_ok = True
            k4_rel = 0.0
            for j in range(PENCIL_D):
                Ub, halo = block_halo(U, 0, j, N, c_)
                Eb = block_halo(E, 0, j, N, c_)[0]
                args = (Ub, *halo, Eb, cfg.A0, cfg.A1, 0, j * c_)
                got = K.local_band_sums(*args, **skw)
                want = K.local_band_sums_ref(*args, **skw)
                b8 = K.chemical_potential_sharded(None, Ub, cfg.RT, cfg.BRT,
                                                  cfg.A0, cfg.A1)
                k1 = K.chemical_potential(Ub, cfg.RT, cfg.BRT, cfg.A0,
                                          cfg.A1)
                a4 = K.absdev_sum(Ub, mean)
                r4 = K.absdev_sum_ref(Ub, mean)
                torch.cuda.synchronize()
                k7 = max(k7, ((got - want).abs() / want.abs()).max().item())
                check(got[3].item() == want[3].item(),
                      f"K7 N={N} {dname} column block {j}: count")
                k8_same = k8_same and torch.equal(b8, k1)
                rel4 = abs(a4.item() - r4.item()) / abs(r4.item())
                k4_rel = max(k4_rel, rel4)
                k4_ok = k4_ok and rel4 <= rtol
                total = got if total is None else total + got
            total_rel = ((total - whole).abs() / whole.abs()).max().item()
            r0 = slice(0, c_)
            Xb = (hat_U[r0].contiguous(), hat_E[r0].contiguous(),
                  c['Seig'][r0].contiguous(), c['CHeig'][r0].contiguous())
            got2, want2 = K.spectral_update(*Xb), K.spectral_update_ref(*Xb)
            torch.cuda.synchronize()
            rtol2 = 1e-12 if dtype == torch.float64 else 1e-6
            k2_ok = bool(((got2 - want2).abs()
                          <= rtol2 * want2.abs()).all())
            row = {'N': N, 'dtype': dname, 'column_block': f'{N}x{c_}',
                   'row_block': f'{c_}x{N}', 'K7_max_rel_err': k7,
                   'K7_blocks_vs_K3_max_rel': total_rel,
                   'K8_same_bits_as_K1': k8_same, 'K4_max_rel_err': k4_rel,
                   'K2_ok': k2_ok,
                   'tolerance': f"K7 rtol {rtol:g} (count exact), blocks vs "
                                f"K3 {SHARD_TOTAL_RTOL[dname]:g}; K8 = K1 "
                                f"bits; K4 rtol {rtol:g}; K2 rtol "
                                f"{rtol2:g}"}
            if N == PENCIL_BLOCK_NS[0]:
                Ub, halo = block_halo(U, 0, 1, N, c_)
                Eb = block_halo(E, 0, 1, N, c_)[0]
                args = (Ub, *halo, Eb, cfg.A0, cfg.A1, 0, c_)
                row['K7'] = {**timed_row(
                    lambda: K.local_band_sums(*args, **skw),
                    lambda: K.local_band_sums_ref(*args, **skw)),
                    **bound_fields(*stats_bytes_ops(Ub), dname)}
                row['K2'] = {**timed_row(lambda: K.spectral_update(*Xb),
                                         lambda: K.spectral_update_ref(*Xb)),
                             **bound_fields(5 * Xb[0].numel()
                                            * Xb[0].element_size(),
                                            3 * Xb[0].numel(), dname)}
            rows.append(row)
            times = ''.join(f"; {k} {row[k]['ms']:.4f} ms (plain "
                            f"{row[k]['plain_ms']:.4f}, bound "
                            f"{row[k]['bound_ms']:.4f})"
                            for k in ('K7', 'K2') if k in row)
            print(f"pencil blocks N={N} {dname}: K7 rel {k7:.3e}, blocks vs "
                  f"K3 {total_rel:.3e}; K8 = K1 {k8_same}; K4 rel "
                  f"{k4_rel:.3e}; K2 {k2_ok}{times}  ({card})", flush=True)
            check(k7 <= rtol and total_rel <= SHARD_TOTAL_RTOL[dname]
                  and k8_same and k4_ok and k2_ok,
                  f"pencil blocks N={N} {dname}: {row}")
    return rows


def grid_block_kernels(dev, card):
    """(g) K7, K8, K2 and K4 on every block of GRID_BLOCK_CASES' grids
    (sides 2047, 501, 20, 18 x 9 and 17: no multiple of 8) against their
    plain versions (K3's tolerances, the count exact; K8 also K1's bits on
    the block), the blocks' K7 sums in rank order against K3 on the whole
    field; K7 and K8 timed on block (1, 0) of GRID_TIMED_NS."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N, (mx, my) in GRID_BLOCK_CASES:
        bn, bw = N // mx, N // my
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cfg, c, U, E, hat_U, hat_E = kernel_inputs(N, dtype, dev)
            skw = dict(N=N, delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                       threshold=cfg.threshold)
            whole = K.stats_sums(U, E, cfg.A0, cfg.A1,
                                 **{k: v for k, v in skw.items()
                                    if k != 'N'})
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            rtol2 = 1e-12 if dtype == torch.float64 else 1e-6
            mean = (U.double().sum() / (N * N)).to(dtype)
            total, k7, k8, k4 = None, 0.0, 0.0, 0.0
            k8_same = k2_ok = count_ok = True
            for i in range(mx):
                for j in range(my):
                    Ub, halo = block_halo(U, i, j, bn, bw)
                    Eb = block_halo(E, i, j, bn, bw)[0]
                    args = (Ub, *halo, Eb, cfg.A0, cfg.A1, i * bn, j * bw)
                    got = K.local_band_sums(*args, **skw)
                    want = K.local_band_sums_ref(*args, **skw)
                    b8 = K.chemical_potential_sharded(
                        None, Ub, cfg.RT, cfg.BRT, cfg.A0, cfg.A1)
                    k1 = K.chemical_potential(Ub, cfg.RT, cfg.BRT, cfg.A0,
                                              cfg.A1)
                    p8 = K.chemical_potential_ref(Ub, cfg.RT, cfg.BRT,
                                                  cfg.A0, cfg.A1)
                    a4 = K.absdev_sum(Ub, mean)
                    r4 = K.absdev_sum_ref(Ub, mean)
                    blk = (slice(i * bn, (i + 1) * bn),
                           slice(j * bw, (j + 1) * bw))
                    Xb = tuple(t[blk].contiguous() for t in
                               (hat_U, hat_E, c['Seig'], c['CHeig']))
                    g2, w2 = K.spectral_update(*Xb), \
                        K.spectral_update_ref(*Xb)
                    torch.cuda.synchronize()
                    k7 = max(k7, ((got - want).abs()
                                  / want.abs()).max().item())
                    count_ok = count_ok and got[3].item() == want[3].item()
                    k8_same = k8_same and torch.equal(b8, k1)
                    k8 = max(k8, ((b8 - p8).abs()
                                  / p8.abs()).max().item())
                    k4 = max(k4, abs(a4.item() - r4.item())
                             / abs(r4.item()))
                    k2_ok = k2_ok and bool(((g2 - w2).abs()
                                            <= rtol2 * w2.abs()).all())
                    total = got if total is None else total + got
            total_rel = ((total - whole).abs() / whole.abs()).max().item()
            row = {'N': N, 'mesh': '%dx%d' % (mx, my), 'dtype': dname,
                   'block': f'{bn}x{bw}', 'K7_max_rel_err': k7,
                   'K7_count_exact': count_ok,
                   'K7_blocks_vs_K3_max_rel': total_rel,
                   'K8_max_rel_err': k8, 'K8_same_bits_as_K1': k8_same,
                   'K4_max_rel_err': k4, 'K2_ok': k2_ok,
                   'tolerance': f"K7, K8, K4 rtol {rtol:g} (K7's count "
                                f"exact), blocks vs K3 "
                                f"{SHARD_TOTAL_RTOL[dname]:g}; K8 = K1 "
                                f"bits; K2 rtol {rtol2:g}"}
            if N in GRID_TIMED_NS:
                Ub, halo = block_halo(U, 1, 0, bn, bw)
                Eb = block_halo(E, 1, 0, bn, bw)[0]
                args = (Ub, *halo, Eb, cfg.A0, cfg.A1, bn, 0)
                row['K7'] = {**timed_row(
                    lambda: K.local_band_sums(*args, **skw),
                    lambda: K.local_band_sums_ref(*args, **skw)),
                    **bound_fields(*stats_bytes_ops(Ub), dname)}
                row['K8'] = {**timed_row(
                    lambda: K.chemical_potential_sharded(
                        None, Ub, cfg.RT, cfg.BRT, cfg.A0, cfg.A1),
                    lambda: K.chemical_potential_ref(
                        Ub, cfg.RT, cfg.BRT, cfg.A0, cfg.A1)),
                    **bound_fields(*mu_bytes_ops(Ub), dname)}
            rows.append(row)
            times = ''.join(f"; {k} {row[k]['ms']:.4f} ms (one call "
                            f"{row[k]['call_ms']:.4f}, plain "
                            f"{row[k]['plain_ms']:.4f}, bound "
                            f"{row[k]['bound_ms']:.4f})"
                            for k in ('K7', 'K8') if k in row)
            print(f"phase 15 (g) grid blocks {bn}x{bw} of N={N} on "
                  f"{mx}x{my} {dname}: K7 rel {k7:.3e}, blocks vs K3 "
                  f"{total_rel:.3e}; K8 rel {k8:.3e}, = K1 {k8_same}; K4 "
                  f"rel {k4:.3e}; K2 {k2_ok}{times}  ({card})", flush=True)
            check(k7 <= rtol and count_ok and k8 <= rtol and k8_same
                  and total_rel <= SHARD_TOTAL_RTOL[dname] and k4 <= rtol
                  and k2_ok, f"phase 15 (g) grid blocks N={N} {dname}: "
                             f"{row}")
    return rows


def grid_slice_timing(dev, card):
    """(j) K5 sharded timed on block (1, 0) of the 2x2 grid at N=4094
    and N=1002 (its world max left out: a one-rank grid), with the
    forward's column strip (N, N/2) at a given max, the plain version,
    each launch alone, four block calls beside one whole-field K5, and
    the bound; the block's planes against the plain version's."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    one = _OneRank()
    n = GRID_SLICE_REPORT[1]
    for N in GRID_TIMED_NS:
        rng = np.random.default_rng(N)
        x = torch.tensor(rng.standard_normal((N, N)), device=dev)
        h = N // 2
        b = x[h:, :h].contiguous()
        strip = x[:, :h].contiguous()
        amax = torch.abs(x).amax()
        row, got, sc = sharded_slice_row(
            K, b, 1, n, lambda: K.slice_field_ref(b, n, amax),
            name='slice_field_sharded', N=N, layout='grid 2x2')
        row['strip_ms'] = device_ms(lambda: K.slice_field_sharded(
            strip, one, n, amax=amax))
        row['whole_field_K5_ms'] = device_ms(lambda: K.slice_field(x, n))
        want, wsc = K.slice_field_ref(b, n)
        torch.cuda.synchronize()
        row['max_abs_err'] = (got.int() - want.int()).abs().max().item()
        row['four_blocks_ms'] = 4 * row['ms']
        check(row['max_abs_err'] == 0 and sc.item() == wsc.item(),
              f"K5 sharded on a {row['block']} grid block: planes "
              f"{row['max_abs_err']}, scale {sc.item()} vs {wsc.item()}")
        rows.append(row)
        print(f"phase 15 (j) kernel slice_field_sharded on a {row['block']}"
              f" block of {N}x{N} float64 (2x2 grid), {n} slices: "
              + sharded_slice_text(row)
              + f"; the forward's {N}x{h} strip at a given max "
              f"{row['strip_ms']:.4f} ms; 4 block calls "
              f"{row['four_blocks_ms']:.4f} ms beside one whole-field K5 "
              f"{row['whole_field_K5_ms']:.4f}  ({card})", flush=True)
    return rows


def pencil_world_tasks(ckpt):
    """The phase world's tasks, which each rank runs in turn, as a list
    of (key, task): the K5 sharded checks, the audits, (c), (d), (b) on
    split (saving into ``ckpt`` and re-entering at PENCIL_CKPT_STEP) and
    ozaki, (f) the file restored on PENCIL_RESTORE_MESH, (e) on split and
    ozaki.  (Two such worlds side by side took longer than one: the 8
    processes time-slice the card.)"""
    Nf, sf = PENCIL_FAST
    No, so = PENCIL_OZAKI
    R, Ne, se = PENCIL_ENS
    fast = {'N': Nf, 'precision': 'float32', 'full_sim': True,
            'generator': 'uniform', 'kappa_tilde': KAPPA,
            'chunk_size': sf // 2, 'transform_backend': 'split',
            'matmul_precision': 'highest'}
    oz = {'N': No, 'full_sim': True, 'generator': 'uniform',
          'kappa_tilde': KAPPA, 'chunk_size': so // 2,
          'transform_backend': 'ozaki'}
    canon = {'kappa_tilde': KAPPA, 'chunk_size': PENCIL_CHUNK}
    pairs = canonical_pairs(R)

    def ensemble(t):
        return ('ensemble', {'params': {'N': Ne, 'no_gui': True,
                                        'device': 'cuda',
                                        'transform_backend': t},
                             'pairs': pairs,
                             'kappas': list(CANONICAL_KAPPAS[:R]),
                             'steps': se, 'return_U': False})

    a = [(('slice', k), ('slice_sharded_check', {
        'N': N, 'n_slices': PENCIL_SLICE_N, 'kind': kind, 'layout': layout,
        'R': Rm, 'seed': N}))
        for k, (N, kind, layout, Rm) in enumerate(PENCIL_SLICE_CASES)]
    a += [('grid_audit', ('audit', {'N': Nf, 'precision': 'float32',
                                    'transform': 'matmul'}))]
    # (c), (d): two entries each, the second one timed, then the audit's
    # chunk
    a += [('fast', ('solve', {'params': fast, 'steps': [sf // 2, sf // 2],
                              'return_U': False, 'audit_steps': 2,
                              'profile_steps': GRID_PROFILE_STEPS})),
          ('ozaki_4096', ('solve', {'params': oz,
                                    'steps': [so // 2, so // 2],
                                    'return_U': False,
                                    'audit_steps': 2})),
          ('split', ('solve', {'params': dict(
              canon, transform_backend='split', checkpoint_file=ckpt,
              checkpoint_every=PENCIL_CKPT_STEP - 1),
              'steps': [PENCIL_CKPT_STEP, int(1e6)], 'return_U': False})),
          ('restored', ('solve', {'params': {'restore_file': ckpt,
                                             'ntmax': int(1e6)},
                                  'mesh_shape': PENCIL_RESTORE_MESH,
                                  'return_U': False})),
          ('ozaki', ('solve', {'params': dict(canon,
                                              transform_backend='ozaki'),
                               'steps': PENCIL_OZAKI_STEPS,
                               'return_U': False})),
          ('ens_split', ensemble('split')),
          ('ens_ozaki', ensemble('ozaki'))]
    # (g)-(l): the grid layout where 4 does not divide N
    grid = {'full_sim': True, 'generator': 'uniform', 'kappa_tilde': KAPPA,
            'chunk_size': GRID_CHUNK}
    g32 = dict(grid, N=GRID_F32[0], precision='float32',
               transform_backend='matmul', matmul_precision='highest')
    goz = dict(grid, N=GRID_OZAKI[0], transform_backend='ozaki')
    gpin = dict(grid, N=GRID_OZAKI_PINNED[0], transform_backend='ozaki',
                ozaki_fwd_pairs=(5, 7), chunk_size=128)
    half = [GRID_CHUNK, GRID_CHUNK]
    Ns, ss = GRID_SCALING
    a += [(('grid_slice', k), ('slice_sharded_check', {
        'N': N, 'n_slices': PENCIL_SLICE_N, 'kind': kind, 'layout': 'grid',
        'seed': N})) for k, (N, kind) in enumerate(GRID_SLICE_CASES)]
    a += [('grid_f32', ('solve', {'params': g32, 'steps': half,
                                  'return_U': False})),
          ('grid_ozaki', ('solve', {'params': goz, 'steps': half,
                                    'return_U': False, 'audit_steps': 2,
                                    'profile_steps': GRID_PROFILE_STEPS})),
          ('grid_ozaki_pinned', ('solve', {'params': gpin,
                                           'steps': GRID_OZAKI_PINNED[1],
                                           'return_U': False})),
          ('scaling_grid', ('scaling', {'axis': 'grid', 'N': Ns,
                                        'nsteps': ss})),
          ('scaling_ens', ('scaling', {'axis': 'ens', 'N': Ns,
                                       'nsteps': ss})),
          ('imported', ('imported', {}))]
    return a


def run_pencil_world(tasks, timeout=900):
    """The world of :func:`pencil_world_tasks`: ({key: [each rank's
    result]}, the world's seconds, {key: rank 0's seconds of the task})."""
    from chsimpy_tpu_torch.parallel.distributed import spawn_world
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    t0 = time.perf_counter()
    res = spawn_world(run_tasks, (1, 2, 2), backend=DIST_BACKEND,
                      device='cuda', args=([t for _, t in tasks], True),
                      timeout=timeout)
    seconds = time.perf_counter() - t0
    return ({key: [r[0][i] for r in res] for i, (key, _) in
             enumerate(tasks)}, seconds,
            {str(key): res[0][1][i] for i, (key, _) in enumerate(tasks)})


def _iterations_to_stop(start):
    """Step iterations a canonical world run entered at ``start`` runs."""
    return iterations_run(1674, PENCIL_CHUNK, int(1e6), start)


def pencil_phase(dev, card, refs):
    """(a) the kernels on pencil shapes; (b)-(f) in one world of 4 gloo
    ranks sharing the card (no scaling figure)."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters

    t0 = time.perf_counter()
    out = {'slice_timing': pencil_slice_timing(dev, card),
           'blocks': pencil_block_kernels(dev, card),
           'grid_slice_timing': grid_slice_timing(dev, card),
           'grid_blocks': grid_block_kernels(dev, card)}
    kernel_seconds = time.perf_counter() - t0
    with open(os.path.join(ROOT, 'tests', 'golden',
                           'default_n512_anchors.json')) as f:
        g = json.load(f)
    # the world starts (its ranks import torch) while this process runs
    # (e)'s one-device batches from the same pairs (no timing in either)
    import threading
    ckpt = os.path.join(kept_dir(), 'pencil.npz')
    world = {}
    tasks = pencil_world_tasks(ckpt)
    # phase 14 (c) and (e) in a full run: the same (1, 2, 2) world
    grid14 = KEPT.pop('grid_ens', None)
    if grid14 is not None:
        tasks[-1:-1] = [(('grid_ens', k), t) for k, t in enumerate(grid14[0])]

    def run():
        try:
            world['out'] = run_pencil_world(tasks)
        except BaseException as e:      # raised again below
            world['error'] = e

    th = threading.Thread(target=run)
    th.start()
    t1 = time.perf_counter()
    R, Ne, se = PENCIL_ENS
    pairs, kappas = canonical_pairs(R), list(CANONICAL_KAPPAS[:R])
    one = {}
    for t in ('split', 'ozaki'):
        _, sols, _, _ = _ensemble_run(
            Parameters(N=Ne, no_gui=True, device='cuda',
                       transform_backend=t), pairs, kappas, se)
        one[t] = [s.timedata.data()[:, 1] for s in sols]
    # (g)-(i)'s one-device runs from the same fields
    from chsimpy_tpu_torch.core.solver import Solver
    grid_one = {}
    for key, (N, steps), prec, tb, extra in (
            ('f32', GRID_F32, 'float32', 'matmul', {}),
            ('f64', GRID_OZAKI, 'float64', 'matmul', {}),
            ('pinned', GRID_OZAKI_PINNED, 'float64', 'ozaki',
             {'ozaki_fwd_pairs': (5, 7)})):
        s1 = Solver(Parameters(N=N, precision=prec, full_sim=True,
                               generator='uniform', kappa_tilde=KAPPA,
                               chunk_size=steps, no_gui=True, device='cuda',
                               transform_backend=tb,
                               matmul_precision='highest', **extra))
        s1.prepare()
        grid_one[key] = np.array(s1.solve_or_resume(steps).timedata.E)
        del s1
    torch.cuda.empty_cache()
    one_seconds = time.perf_counter() - t1
    th.join()
    if 'error' in world:
        raise world['error']
    res, seconds, task_seconds = world['out']
    out['task_seconds'] = task_seconds
    out['world_seconds'] = seconds
    _no_jax('phase 15', [[r] for r in res['imported']], 0)
    if grid14 is not None:
        ranks = len(res['imported'])
        out['grid_ens'] = grid_ens_check(
            [[res[('grid_ens', k)][r] for k in range(len(grid14[0]))]
             for r in range(ranks)], seconds, grid14[1], card)

    # (a) K5 sharded in the world
    slices = []
    for k, case in enumerate(PENCIL_SLICE_CASES):
        rr = res[('slice', k)]
        ok = all(r['max_diff_whole'] == 0 and r['max_diff_plain'] == 0
                 and r['scale'] == r['whole_scale'] == r['plain_scale']
                 == rr[0]['scale'] for r in rr)
        want = 'slice_field_members_sharded' if case[3] else \
            'slice_field_sharded'
        ok = ok and all(r['launches'][want] == 1 for r in rr)
        slices.append({'case': list(case), 'ok': ok,
                       'blocks': [r['block'] for r in rr],
                       'scale': rr[0]['scale'],
                       'max_diff_whole': max(r['max_diff_whole'] for r in rr),
                       'max_diff_plain': max(r['max_diff_plain']
                                             for r in rr)})
        print(f"phase 15 (a) K5 sharded N={case[0]} {case[1]} {case[2]} "
              f"blocks {rr[0]['block']}" + (f", R={case[3]}" if case[3]
                                             else '')
              + f": planes = the whole field's K5 on every rank "
              f"{ok}, scale {rr[0]['scale']} on every rank", flush=True)
        check(ok, f"phase 15 (a) K5 sharded {case}: {rr}")
    out['slice_checks'] = slices

    # the audits
    audits = {'split_f32': res['fast'][0]['audit'],
              'grid_matmul_f32': res['grid_audit'][0],
              'ozaki_f64': res['ozaki_4096'][0]['audit']}
    out['audit'] = audits
    for name, a in audits.items():
        print(f"phase 15 audit N={PENCIL_FAST[0]} {name} on 2x2: "
              f"{_audit_line(a)}  ({card})", flush=True)
    sp, gr, oz = (audits['split_f32'], audits['grid_matmul_f32'],
                  audits['ozaki_f64'])
    check(sp['pencil'] and sp['per_op_bytes']['all-gather'] == 0
          and sp['per_op_bytes']['all-to-all'] > 0
          and sp['total_bytes'] < gr['per_op_bytes']['all-gather']
          and sp['total_wire_bytes'] < gr['total_wire_bytes']
          and sp['max_single_collective_bytes'] <= sp['field_bytes'] // 4
          and oz['pencil'] and oz['per_op_bytes']['all-to-all'] > 0
          and oz['total_bytes'] < 3 * oz['field_bytes'],
          f"phase 15 audit: {audits}")

    # (c) N=4096 float32 split
    fast = res['fast']
    f = fast[0]
    E = f['timedata'][:, 1]
    rel64 = float(np.max(np.abs(E / np.asarray(refs['E_f64_4096']) - 1)))
    rel32 = float(np.max(np.abs(
        E / np.asarray(refs['E_split_f32_4096']) - 1)))
    drift = f['U_mean'] - refs['U0_mean_4096']
    timed = PENCIL_FAST[1] // 2
    out['n4096_split'] = {
        'E_vs_f64_max_rel': rel64, 'E_vs_single_split_f32_max_rel': rel32,
        'U_mean_drift': drift,
        'ms_per_step': [r['entry_seconds'][1] / timed * 1e3 for r in fast],
        'peak_GB_per_rank': [r['peak_bytes'] / 1e9 for r in fast],
        'rows_same_on_every_rank': all(np.array_equal(r['timedata'],
                                                      f['timedata'])
                                       for r in fast),
        'launches': f['launches']}
    o = out['n4096_split']
    print(f"phase 15 (c) N={PENCIL_FAST[0]} float32 split on the 2x2 "
          f"pencil world, {PENCIL_FAST[1]} steps: E vs float64 {rel64:.3e}, "
          f"vs one device's split float32 {rel32:.3e}, mean(U) drift "
          f"{drift:.3e}; ms a step (the last {timed}) " + ', '.join(
              f'{m:.1f}' for m in o['ms_per_step']) + '; peak GB a rank '
          + ', '.join(f'{m:.2f}' for m in o['peak_GB_per_rank'])
          + f" (4 ranks on one card, gloo)  ({card})", flush=True)
    check(f['pencil'] and len(E) == PENCIL_FAST[1] and f['U_finite']
          and o['rows_same_on_every_rank'],
          "phase 15 (c): not a finite pencil run of the same rows")
    check(rel64 <= 1e-5 and rel32 <= 1e-6 and abs(drift) <= 1e-6,
          f"phase 15 (c): E {rel64:.3e} / {rel32:.3e}, drift {drift:.3e}")

    # (d) N=4096 float64 ozaki
    ozr = res['ozaki_4096']
    z = ozr[0]
    n = PENCIL_OZAKI[1]
    Ez = z['timedata'][:, 1]
    relz = float(np.max(np.abs(Ez / np.asarray(refs['E_f64_4096'][:n])
                               - 1)))
    out['n4096_ozaki'] = {
        'E_vs_matmul_f64_max_rel': relz,
        'ms_per_step': [r['entry_seconds'][1] / (n // 2) * 1e3 for r in ozr],
        'peak_GB_per_rank': [r['peak_bytes'] / 1e9 for r in ozr],
        'rows_same_on_every_rank': all(np.array_equal(r['timedata'],
                                                      z['timedata'])
                                       for r in ozr),
        'launches': z['launches']}
    o = out['n4096_ozaki']
    print(f"phase 15 (d) N={PENCIL_OZAKI[0]} float64 ozaki on the 2x2 "
          f"pencil world, {n} steps: E vs the matmul route {relz:.3e}; ms "
          f"a step (the last {n // 2}) "
          + ', '.join(f'{m:.1f}' for m in o['ms_per_step'])
          + '; peak GB a rank '
          + ', '.join(f'{m:.2f}' for m in o['peak_GB_per_rank'])
          + f"  ({card})", flush=True)
    check(z['pencil'] and len(Ez) == n and z['U_finite']
          and o['rows_same_on_every_rank'] and relz <= 1e-10,
          f"phase 15 (d): E {relz:.3e} from matmul, {o}")

    # (b) the canonical run on split (re-entered at PENCIL_CKPT_STEP) and
    # ozaki
    out['canonical'] = {
        'split': check_pencil_canonical(
            'phase 15 (b) split', res['split'],
            np.asarray(refs['E_split_n512']), g,
            PENCIL_CKPT_STEP - 1 + _iterations_to_stop(PENCIL_CKPT_STEP),
            'split'),
        'ozaki': check_pencil_canonical(
            'phase 15 (b) ozaki', res['ozaki'],
            np.asarray(refs['E_ozaki_n512']), g, PENCIL_OZAKI_STEPS - 1,
            'ozaki', PENCIL_OZAKI_STEPS)}

    # (f) the split run's file (PENCIL_CKPT_STEP) restored on 1x4
    rest = res['restored']
    rows_equal = np.array_equal(rest[0]['timedata'],
                                res['split'][0]['timedata'])
    out['restored'] = {
        'mesh': rest[0]['mesh'], 'computed_steps': rest[0]['computed_steps'],
        'stop_reason': rest[0]['stop_reason'],
        'rows_equal_the_reentered_run': rows_equal,
        'rows_same_on_every_rank': all(
            np.array_equal(r['timedata'], rest[0]['timedata'])
            for r in rest)}
    print(f"phase 15 (f) the 2x2 pencil run's file (step "
          f"{PENCIL_CKPT_STEP}) restored on {rest[0]['mesh']}: stop "
          f"{rest[0]['computed_steps']} ({rest[0]['stop_reason']}), the "
          f"re-entered run's rows to the bit {rows_equal}", flush=True)
    check(rest[0]['pencil'] and rest[0]['computed_steps'] == 1674
          and rows_equal and out['restored']['rows_same_on_every_rank'],
          f"phase 15 (f): {out['restored']}")

    # (e) the grid ensembles
    out['ensemble'] = {}
    for t in ('split', 'ozaki'):
        er = res['ens_' + t]
        e0 = er[0]
        same = all(all(np.array_equal(a, b) for a, b in
                       zip(r['timedata'], e0['timedata'])) for r in er)
        rel = max(float(np.max(np.abs(td[:, 1] / e - 1)))
                  for td, e in zip(e0['timedata'], one[t]))
        ms = [r['seconds'] / (se - 1) * 1e3 for r in er]
        out['ensemble'][t] = {'E_max_rel_vs_one_device': rel,
                              'rows_same_on_every_rank': same,
                              'ms_per_step_iteration': ms,
                              'launches': e0['launches']}
        print(f"phase 15 (e) R={R} N={Ne} float64 {se} steps on {t}, "
              f"{e0['mesh']}: E vs one device's batch {rel:.3e}, rows the "
              f"same on every rank {same}; ms a step iteration "
              + ', '.join(f'{m:.1f}' for m in ms) + f"  ({card})",
              flush=True)
        lc = e0['launches']
        check(same and rel <= 1e-10 and e0['U_finite'],
              f"phase 15 (e) {t}: E {rel:.3e}, ranks same {same}")
        check(lc['local_band_sums_members'] >= se - 1
              and lc['spectral_update_members'] >= se - 1
              and lc['slice_field_members_sharded']
              == (1 + 2 * (se - 1) if t == 'ozaki' else 0)
              and lc['slice_field_members'] == 0,
              f"phase 15 (e) {t}: launches {lc}")
    out['grid'] = grid_phase_checks(res, grid_one, card)
    out['kernel_seconds'], out['one_device_seconds'] = (kernel_seconds,
                                                        one_seconds)
    print(f"phase 15 kernels {kernel_seconds:.1f} s before the world; "
          f"one-device runs {one_seconds:.1f} s beside it; world: "
          f"{seconds:.1f} s; rank 0's tasks: "
          + ', '.join(f"{k} {v:.1f}" for k, v in task_seconds.items())
          + f"  ({card})", flush=True)
    out['nccl'] = pencil_nccl(card, refs, g)
    return out


def grid_phase_checks(res, one, card):
    """(g)-(l) from the world's results: the runs against one device's
    (``one``: E of the float32 and float64 matmul runs at N=4094 and of
    the pinned ozaki run at N=1002), K5 sharded on the grid blocks, the
    scaling lines and the profiles."""
    import numpy as np
    out = {}
    # (j) K5 sharded on every block of the 2x2 grid
    slices = []
    for k, (N, kind) in enumerate(GRID_SLICE_CASES):
        rr = res[('grid_slice', k)]
        ok = all(r['max_diff_whole'] == 0 and r['max_diff_plain'] == 0
                 and r['scale'] == r['whole_scale'] == r['plain_scale']
                 == rr[0]['scale'] and r['launches']['slice_field_sharded']
                 == 1 for r in rr)
        slices.append({'N': N, 'kind': kind, 'ok': ok,
                       'blocks': [r['block'] for r in rr],
                       'scale': rr[0]['scale']})
        print(f"phase 15 (j) K5 sharded N={N} {kind} on the 2x2 grid's "
              f"blocks {rr[0]['block']}: planes = the whole field's K5 on "
              f"every rank {ok}, scale {rr[0]['scale']}", flush=True)
        check(ok, f"phase 15 (j) K5 sharded N={N} {kind}: {rr}")
    out['slice_checks'] = slices
    # (g), (h), (i): the runs
    cases = (('g', 'grid_f32', 'f32', 1e-6, GRID_F32),
             ('h', 'grid_ozaki', 'f64', 1e-10, GRID_OZAKI),
             ('i', 'grid_ozaki_pinned', 'pinned', 1e-10, GRID_OZAKI_PINNED))
    for part, key, ref, rtol, (N, steps) in cases:
        rr = res[key]
        r0 = rr[0]
        E = r0['timedata'][:, 1]
        rel = float(np.max(np.abs(E / one[ref] - 1)))
        same = all(np.array_equal(r['timedata'], r0['timedata'])
                   for r in rr)
        # the last entry's seconds over its step iterations (g, h: the
        # second entry of GRID_CHUNK; i: the one entry of steps - 1)
        last = GRID_CHUNK if part != 'i' else steps - 1
        o = {'N': N, 'steps': steps, 'E_max_rel_vs_one_device': rel,
             'rows_same_on_every_rank': same,
             'ms_per_step_iteration': [r['entry_seconds'][-1] / last * 1e3
                                       for r in rr],
             'peak_GB_per_rank': [r['peak_bytes'] / 1e9 for r in rr],
             'launches': r0['launches'], 'block': r0['block_shapes']['U'],
             'pencil': r0['pencil']}
        if 'audit' in r0:
            o['audit'] = r0['audit']
        out[key] = o
        what = {'g': f'float32 matmul vs one device\'s float32 matmul',
                'h': 'float64 ozaki vs one device\'s float64 matmul',
                'i': 'float64 ozaki (5, 7) vs one device\'s ozaki (5, 7)'}
        print(f"phase 15 ({part}) N={N} {what[part]} on the 2x2 grid "
              f"({o['block'][0]}x{o['block'][1]} blocks), {steps} steps: E "
              f"{rel:.3e} (bound {rtol:g}), rows the same on every rank "
              f"{same}; ms a step iteration "
              + ', '.join(f'{m:.1f}' for m in o['ms_per_step_iteration'])
              + '; peak GB a rank '
              + ', '.join(f'{m:.2f}' for m in o['peak_GB_per_rank'])
              + (f"; audit {_audit_line(o['audit'])}" if 'audit' in o
                 else '') + f"  (4 ranks on one card, gloo)  ({card})",
              flush=True)
        check(not r0['pencil'] and len(E) == len(one[ref]) == steps
              and r0['U_finite'] and same and rel <= rtol,
              f"phase 15 ({part}): E {rel:.3e}, {o}")
        lc = r0['launches']
        it = steps - 1
        k5 = 0 if part == 'g' else (2 if part != 'i' else 1) + 2 * it
        check(lc['chemical_potential_sharded'] == it
              and lc['spectral_update'] == it
              and lc['local_band_sums'] == it + 1
              and lc['slice_field_sharded'] == k5
              and lc['slice_field'] == 0 and lc['chemical_potential'] == 0,
              f"phase 15 ({part}): launches {lc}, {it} step iterations")
    a = out['grid_ozaki']['audit']
    check(a['max_single_collective_bytes'] < a['field_bytes']
          and a['total_bytes'] <= 16 * a['field_bytes']
          and a['per_op_bytes']['all-to-all'] == 0,
          f"phase 15 (h) audit: {a}")
    # (k) the scaling benchmark's lines
    keys = {'grid': {'axis', 'N', 'devices', 'mesh', 'steps_per_s_1dev',
                     'steps_per_s_mesh', 'speedup', 'scaling_efficiency'},
            'ens': {'axis', 'N', 'devices', 'members',
                    'member_steps_per_s_1dev', 'member_steps_per_s_mesh',
                    'speedup', 'scaling_efficiency'}}
    out['scaling'] = {}
    for axis in ('grid', 'ens'):
        line = res['scaling_' + axis][0]
        out['scaling'][axis] = line
        print(f"phase 15 (k) benchmarks/scaling.py --axis {axis} (4 gloo "
              f"ranks sharing the card: no scaling figure): "
              f"{json.dumps(line)}  ({card})", flush=True)
        check(set(line) == keys[axis] and line['devices'] == 4
              and line['speedup'] > 0
              and all(r == line for r in res['scaling_' + axis]),
              f"phase 15 (k) scaling --axis {axis}: {line}")
    # (l) rank 0's profiles, after (h)'s and (c)'s runs
    out['profile'] = {}
    for key, run in (('grid_ozaki', 'grid_ozaki'), ('pencil_split', 'fast')):
        prof = res[run][0]['profile']
        out['profile'][key] = prof
        top = ', '.join(f"{n} {ms:.2f} ms x{c}"
                        for n, ms, c in prof['top_device'][:6])
        gaps = ', '.join(f"{n} {ms:.2f}" for n, ms in prof['host_gaps'][:6])
        print(f"phase 15 (l) torch.profiler, rank 0, {key} N="
              f"{prof['N']} {prof['dtype']}, {prof['steps']} step "
              f"iterations: window {prof['window_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms (idle share "
              f"{prof['device_idle_share']:.3f}, {prof['device_events']} "
              f"device events); top device: {top}; host gaps (ms): {gaps}"
              f"  ({card})", flush=True)
        check(prof['window_ms'] > 0 and prof['top_host'],
              f"phase 15 (l) {key}: {prof}")
    return out


def pencil_nccl(card, refs, g):
    """With one card per rank: (b) on split and ozaki and (c) again on
    NCCL; otherwise a line saying why it did not run."""
    import numpy as np
    from chsimpy_tpu_torch.parallel.distributed import spawn_grid
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    if torch_cards() < PENCIL_D:
        print(f"phase 15: the NCCL world did not run: {torch_cards()} "
              f"card(s), and NCCL takes one card per rank ({PENCIL_D} "
              f"needed)", flush=True)
        return None
    tasks = dict(pencil_world_tasks(os.path.join(kept_dir(),
                                                 'pencil-nccl.npz')))
    res = spawn_grid(run_tasks, (2, 2), backend='nccl', device='cuda',
                     args=([tasks['fast'], tasks['split'],
                            tasks['ozaki']],), timeout=900)
    out = {'split': check_pencil_canonical(
        'phase 15 nccl (b) split', [r[1] for r in res],
        np.asarray(refs['E_split_n512']), g,
        PENCIL_CKPT_STEP - 1 + _iterations_to_stop(PENCIL_CKPT_STEP),
        'split'),
        'ozaki': check_pencil_canonical(
        'phase 15 nccl (b) ozaki', [r[2] for r in res],
        np.asarray(refs['E_ozaki_n512']), g, PENCIL_OZAKI_STEPS - 1,
        'ozaki', PENCIL_OZAKI_STEPS)}
    E = res[0][0]['timedata'][:, 1]
    rel = float(np.max(np.abs(E / np.asarray(refs['E_f64_4096']) - 1)))
    timed = PENCIL_FAST[1] // 2
    out['n4096_split_E_vs_f64'] = rel
    out['n4096_split_ms_per_step'] = [r[0]['entry_seconds'][1] / timed * 1e3
                                      for r in res]
    print(f"phase 15 nccl (c): E vs float64 {rel:.3e}, ms a step "
          + ', '.join(f"{m:.2f}" for m in out['n4096_split_ms_per_step'])
          + f"  ({card})", flush=True)
    check(rel <= 1e-5, f"phase 15 nccl (c): E {rel:.3e}")
    return out


def _audit_line(a):
    per = a['per_op_bytes']
    return (f"{a['total_bytes'] / 1e6:.3f} MB a step and rank ("
            + ', '.join(f"{k} {v / 1e6:.3f}" for k, v in per.items() if v)
            + f"; received {a['total_wire_bytes'] / 1e6:.3f} MB; largest "
            f"{a['max_single_collective_bytes'] / 1e6:.3f} MB; "
            f"{a['n_collectives']} calls)")


def check_pencil_canonical(tag, runs, E1, g, iterations, route,
                           steps=None):
    """(b): stop 1674 with the anchors (with ``steps``: the first steps,
    the anchors among them), E within 1e-10 of one device's run of the
    route at every step, the same rows on every rank, the route's kernels
    launched as it implies."""
    import numpy as np
    c = runs[0]
    td = c['timedata']
    n = min(len(td), len(E1))
    e100 = np.asarray(g['E_every_100'])[:len(td[::100])]
    out = {'mesh': c['mesh'], 'pencil': c['pencil'],
           'computed_steps': c['computed_steps'],
           'stop_reason': c['stop_reason'],
           'rows_same_on_every_rank': all(
               np.array_equal(r['timedata'], td) for r in runs),
           'E_vs_single_max_rel': float(np.max(np.abs(td[:n, 1]
                                                      / E1[:n] - 1))),
           'E_every_100_max_rel': float(np.max(np.abs(
               td[::100, 1] / e100 - 1))),
           'E_last_rel': None if steps else abs(td[-1, 1] / g['E_last'] - 1),
           'argmax_E2': None if steps else int(td[:, 2].argmax()),
           'iterations': iterations,
           'seconds': [r['seconds'] for r in runs],
           'launches': [r['launches'] for r in runs]}
    ms = [s / iterations * 1e3 for s in out['seconds']]
    print(f"phase 15 (b) canonical run on {route}: "
          + json.dumps({k: v for k, v in out.items()
                        if k not in ('launches', 'seconds')})
          + ', ms a step iteration ' + ', '.join(f'{m:.1f}' for m in ms),
          flush=True)
    check(c['pencil'], f"{tag}: not on the pencil layout")
    check(out['rows_same_on_every_rank'], f"{tag}: ranks differ")
    if steps:
        check(c['computed_steps'] == len(td) == steps
              and c['stop_reason'] == 'None'
              and out['E_every_100_max_rel'] <= 1e-10,
              f"{tag}: {c['computed_steps']} steps ({c['stop_reason']}), "
              f"{len(td)} rows, E every 100 "
              f"{out['E_every_100_max_rel']:.3e}")
    else:
        check(c['computed_steps'] == 1674 and c['stop_reason'] == 'energy'
              and len(td) == len(E1), f"{tag}: stop {c['computed_steps']} "
                                      f"{c['stop_reason']}, {len(td)} rows")
        check(c['tau0'] == g['tau0']
              and abs(c['t0'] / g['t0'] - 1) <= 1e-12
              and out['E_every_100_max_rel'] <= 1e-10
              and out['E_last_rel'] <= 1e-10
              and out['argmax_E2'] == g['argmax_E2'],
              f"{tag}: golden anchors not held")
    check(out['E_vs_single_max_rel'] <= 1e-10,
          f"{tag}: E {out['E_vs_single_max_rel']:.3e} from one device")
    want_k5 = 1 + 2 * iterations if route == 'ozaki' else 0
    for lc in out['launches']:
        check(lc['chemical_potential_sharded'] == iterations
              and lc['spectral_update'] == iterations
              and lc['local_band_sums'] == iterations + 1
              and lc['slice_field_sharded'] == want_k5
              and lc['slice_field'] == 0 and lc['chemical_potential'] == 0
              and lc['stats_sums'] == 0,
              f"{tag}: launches {lc}, {iterations} step iterations")
    return out


def pencil_refs():
    """What phase 15 is held to when it runs alone: one device's
    canonical runs on split and ozaki, N=4096 float64 matmul and float32
    split over 64 steps from the same field."""
    import numpy as np
    s64 = make_solver(4096, 'float64', 64, transform='matmul')
    E64 = np.array(s64.solve_or_resume(64).timedata.E)
    del s64
    s32 = make_solver(4096, 'float32', 64, transform='split')
    U0 = s32.solution.U.double().mean().item()
    E32 = np.array(s32.solve_or_resume(64).timedata.E)
    del s32
    return {'E_split_n512': default_run('split')['E'],
            'E_ozaki_n512': ozaki_default_run()['E'],
            'E_f64_4096': E64.tolist(), 'E_split_f32_4096': E32.tolist(),
            'U0_mean_4096': U0}


def phase15_alone(detail, dev, card, out_dir) -> int:
    """``--phase 15``: phase 15 after what it is held to
    (:func:`pencil_refs`); its details to DIR/chip_smoke_15.json with
    ``--out``."""
    refs = pencil_refs()
    t0 = time.perf_counter()
    detail['pencil'] = pencil_phase(dev, card, refs)
    detail['phase_seconds'][15] = time.perf_counter() - t0
    print(f"phase 15: {detail['phase_seconds'][15]:.1f} s  ({card})",
          flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, 'chip_smoke_15.json'), 'w') as f:
            json.dump(detail, f, indent=1)
    return 0


# ----------------------------------------------------------------------
# phase 16: the float32 knobs (queue A item 14): K12, K3's fold mode, K6
# in the solve, runs under each knob, N=4096 speeds, the auto sweep
# ----------------------------------------------------------------------

OTF_NS = (4096, 1000, 1001, 512)
# K12 has no Pallas counterpart: XLA fuses the JAX step's otf update
OTF_REPLACES = ('chsimpy_tpu/core/stepper.py:588 (get_coefficients_axis '
                'fused into the update; B2, chsimpy_tpu/ops/'
                'pallas_kernels.py:113, on the stored grids)')
OTF_RS = (4, 16)
OTF_REPORT = (4096, 'float32')            # the JSON line's K12 rows
OTF_MEMBERS_REPORT = (4, 4096, 'float32')
# K3's fold mode needs an even N; 1002 / 2 is odd: the fold's one-column
# path in both types
FOLD_NS = (4096, 1000, 1002, 512)
FOLD_REPORT = (4096, 'float32')
# (b): the stop runs (N, golden with the float64 E at every step or None
# for the canonical run, the float32 stop band of PERFORMANCE.md:254)
KNOB_STOPS = ((512, None, 0.0030), (1024, 'n1024_uniform_stop', 0.0049),
              (2048, 'n2048_uniform_stop', 0.0098))
KNOB_E_CLASS = 1e-5         # float32 E against float64 at every step


def otf_bound(R, N, dtype):
    """K12 reads hat_U and hat_E and writes one field (the axis aside)."""
    s = 4 if dtype == 'float32' else 8
    n = R * N * N
    return bound_fields(3 * n * s + N * s, OPS_PER_ELEM['update_otf'] * n,
                        dtype)


def otf_kernel_phase(dev, card):
    """(a) K12 and K12_members against their plain versions to the bit,
    member by member against K12 on the member, and on a 2x2 block
    against the whole field's block; timed at N=4096."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N in OTF_NS:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cfg, c, _U, _E, hat_U, hat_E = kernel_inputs(N, dtype, dev)
            e = c['eaxis']
            delt = torch.tensor(3e-8, dtype=torch.float64, device=dev)
            args = (e, delt, cfg.kappa_tilde, cfg.delx2)
            before = K.launches['update_otf']
            got = K.update_otf(hat_U, hat_E, *args)
            want = K.update_otf_ref(hat_U, hat_E, *args)
            check(K.launches['update_otf'] == before + 1,
                  f'update_otf N={N}: not one count a call')
            err = (got.double() - want.double()).abs().max().item()
            ok = torch.equal(got, want)
            row = {'name': 'update_otf', 'N': N, 'dtype': dname,
                   'max_abs_err': err, 'tolerance': 'the same bits',
                   'ok': ok}
            if N == 4096:
                row.update(timed_row(lambda: K.update_otf(hat_U, hat_E,
                                                          *args),
                                     lambda: K.update_otf_ref(hat_U, hat_E,
                                                              *args)),
                           **otf_bound(1, N, dname))
                # K2 on the stored grids, the kernel K12 replaces
                row['K2_ms'] = device_ms(lambda: K.spectral_update(
                    hat_U, hat_E, c['Seig'], c['CHeig']))
                h = N // 2
                blk = [x[h:, h:].contiguous() for x in (hat_U, hat_E)]
                bgot = K.update_otf(*blk, *args, h, h)
                ok = (ok and torch.equal(bgot, K.update_otf_ref(
                    *blk, *args, h, h)) and torch.equal(bgot, got[h:, h:]))
                row['block_2x2'] = 'the same bits as the plain version ' \
                                   'and the whole field\'s block'
            rows.append(row)
            print(f"kernel update_otf N={N} {dname}: err={err:.3e} "
                  f"{'ok' if ok else 'FAIL'}" + (
                      f"  kernel {row['ms']:.4f} ms (one call "
                      f"{row['call_ms']:.4f}, K2 {row['K2_ms']:.4f})  plain "
                      f"{row['plain_ms']:.4f} ms  bound "
                      f"{row['bound_ms']:.4f} ms" if 'ms' in row else '')
                  + f"  ({card})", flush=True)
            check(ok, f"update_otf N={N} {dname}: not the plain bits")
            for R in OTF_RS:
                g = torch.Generator(device=dev).manual_seed(N + R)
                hU = torch.randn((R, N, N), dtype=dtype, device=dev,
                                 generator=g)
                hE = torch.randn((R, N, N), dtype=dtype, device=dev,
                                 generator=g)
                f = torch.arange(R, dtype=torch.float64, device=dev)
                kap = cfg.kappa_tilde * (1.0 + 0.01 * f)
                dts = 3e-8 * (1.0 + 0.02 * f)
                margs = (e, dts, kap, cfg.delx2)
                mgot = K.update_otf_members(hU, hE, *margs)
                ok = torch.equal(mgot, K.update_otf_ref(hU, hE, *margs))
                for r in range(R):
                    ok = ok and torch.equal(mgot[r], K.update_otf(
                        hU[r], hE[r], e, dts[r], kap[r].item(), cfg.delx2))
                h = N // 2
                bl = [x[:, h:, :h].contiguous() for x in (hU, hE)]
                ok = ok and torch.equal(K.update_otf_members(
                    *bl, *margs, h, 0), mgot[:, h:, :h])
                mrow = {'name': 'update_otf_members', 'R': R, 'N': N,
                        'dtype': dname, 'max_abs_err': 0.0 if ok else None,
                        'tolerance': 'the same bits as the plain version '
                                     'and as K12 on each member', 'ok': ok}
                if (R, N, dname) == OTF_MEMBERS_REPORT:
                    mrow.update(timed_row(
                        lambda: K.update_otf_members(hU, hE, *margs),
                        lambda: K.update_otf_ref(hU, hE, *margs)),
                        **otf_bound(R, N, dname))
                    mrow['single_launches_ms'] = device_ms(lambda: [
                        K.update_otf(hU[r], hE[r], e, dts[r],
                                     float(kap[r]), cfg.delx2)
                        for r in range(R)])
                rows.append(mrow)
                print(f"kernel update_otf_members R={R} N={N} {dname}: "
                      f"{'ok' if ok else 'FAIL'}" + (
                          f"  kernel {mrow['ms']:.4f} ms (R single "
                          f"{mrow['single_launches_ms']:.4f})  plain "
                          f"{mrow['plain_ms']:.4f} ms  bound "
                          f"{mrow['bound_ms']:.4f} ms" if 'ms' in mrow
                          else '') + f"  ({card})", flush=True)
                check(ok, f"update_otf_members R={R} N={N} {dname}")
                del hU, hE, mgot, bl
            del hat_U, hat_E, got, want
    torch.cuda.empty_cache()
    return rows


def fold_kernel_phase(dev, card):
    """(a) K3's fold mode on the folded field against its plain version
    (K3's tolerances, the count exact) and against K3 on the natural field
    (the same bits), single and members; timed at N=4096."""
    import torch
    from chsimpy_tpu_torch.ops import dct as dct_ops
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    for N in FOLD_NS:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            cfg, c, U, E, _hu, _he = kernel_inputs(N, dtype, dev)
            V, EV = dct_ops.fold1(U), dct_ops.fold1(E)
            skw = dict(delx=cfg.delx, RT=cfg.RT, B=cfg.B,
                       threshold=cfg.threshold)
            got = K.stats_sums(V, EV, cfg.A0, cfg.A1, fold=True, **skw)
            want = K.stats_sums_ref(V, EV, cfg.A0, cfg.A1, fold=True, **skw)
            natural = K.stats_sums(U, E, cfg.A0, cfg.A1, **skw)
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            diff = (got - want).abs()
            # the natural bits where the fold keeps K3's vector width
            same_grid = (K.stats_grid(N, U.element_size(), U.data_ptr(),
                                      E.data_ptr())
                         == K.stats_grid(N, V.element_size(), V.data_ptr(),
                                         EV.data_ptr(), fold=True))
            ok = (bool((diff <= rtol * want.abs()).all())
                  and got[3].item() == want[3].item()
                  and (torch.equal(got, natural) or not same_grid))
            row = {'name': 'stats_sums (fold)', 'N': N, 'dtype': dname,
                   'max_abs_err': diff.max().item(),
                   'max_rel_err': (diff / want.abs().clamp_min(1e-300))
                   .max().item(),
                   'tolerance': f'rtol {rtol:g}, count exact, the natural '
                                f'K3 bits where the grid is K3\'s',
                   'same_grid_as_K3': same_grid, 'ok': ok}
            R = 4
            Us = torch.stack([U, 1.0 - 0.5 * U, U, U * 0.999])
            Es = torch.stack([E, E, 2.0 * E, E])
            a0 = torch.full((R,), cfg.A0, dtype=torch.float64, device=dev)
            a1 = torch.full((R,), cfg.A1, dtype=torch.float64, device=dev)
            Vs, EVs = dct_ops.fold1(Us), dct_ops.fold1(Es)
            mgot = K.stats_sums_members(Vs, EVs, a0, a1, fold=True, **skw)
            ok = ok and (torch.equal(mgot, K.stats_sums_members(
                Us, Es, a0, a1, **skw)) or not same_grid)
            row['members'] = 'R=4: the natural K3_members bits'
            # the body against the parent body, single and members
            tile = K.stats_tile(N, N, N, 0, 0, V.element_size(),
                                V.data_ptr(), EV.data_ptr(), fold=True)
            mtile = K.stats_tile(N, N, N, 0, 0, V.element_size(),
                                 Vs.data_ptr(), EVs.data_ptr(), fold=True)
            check(same_bits(mgot, K._stats_sums_members_launch(
                Vs, EVs, a0, a1, mtile, fold=True, prev=True, **skw)),
                f"stats_sums fold members N={N} {dname}: the body's sums "
                f"differ from the parent body's")
            body = body_turns(
                '16 (a)', lambda: K.stats_sums(V, EV, cfg.A0, cfg.A1,
                                               fold=True, **skw),
                lambda: K._stats_sums_launch(V, EV, cfg.A0, cfg.A1, tile,
                                             fold=True, prev=True, **skw))
            if N == FOLD_REPORT[0]:
                row.update(body)
            if N == FOLD_REPORT[0]:
                def fold():
                    return K.stats_sums(V, EV, cfg.A0, cfg.A1, fold=True,
                                        **skw)
                # in turns with K3 on the natural field (natural, fold,
                # fold, natural)
                t = design_turns('16 (a)', fold, lambda: K.stats_sums(
                    U, E, cfg.A0, cfg.A1, **skw))
                row.update(
                    ms=statistics.median(t['ms_turns']),
                    call_ms=call_ms(fold), plain_ms=device_ms(
                        lambda: K.stats_sums_ref(V, EV, cfg.A0, cfg.A1,
                                                 fold=True, **skw)),
                    fold_ms_turns=t['ms_turns'],
                    natural_ms_turns=t['before_ms_turns'],
                    natural_ms=t['before_ms'],
                    **kernel_bound('stats_sums', N, dname))
                row['over_natural'] = row['ms'] / row['natural_ms']
                row['bound_share'] = row['bound_ms'] / row['ms']
            rows.append(row)
            print(f"kernel stats_sums fold N={N} {dname}: rel "
                  f"{row['max_rel_err']:.3e} {'ok' if ok else 'FAIL'}" + (
                      f"  kernel {row['ms']:.4f} ms (one call "
                      f"{row['call_ms']:.4f}; natural K3 "
                      f"{row['natural_ms']:.4f}, {row['over_natural']:.3f}x"
                      f"; turns natural / fold {row['natural_ms_turns']} / "
                      f"{row['fold_ms_turns']}{body_text(row)})  plain "
                      f"{row['plain_ms']:.4f} ms  bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                      f"{row['bound_share']:.0%})" if 'ms' in row else '')
                  + f"  ({card})", flush=True)
            check(ok, f"stats_sums fold N={N} {dname}")
    return rows


def solve_products(dev):
    """Every product K6 does in one step of the float32 solves at
    matmul_precision 'high' (N=4096 matmul, split levels 4, folded
    split levels 5; an R=4 N=512 ensemble on matmul and split): one
    recorded (A, B) pair per shape and layout."""
    import numpy as np
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core import stepper
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    from chsimpy_tpu_torch.ops import dct as dct_ops

    seen = {}
    runs = [('matmul', 4096, {}), ('split', 4096, {}),
            ('split', 4096, {'fold_field': True})]
    with CallRecorder([(dct_ops.K, 'matmul', 'K6')]) as rec:
        for route, N, extra in runs:
            s = make_solver(N, 'float32', 8, transform=route,
                            matmul_precision='high', **extra)
            stepper._step(s.cfg, s._consts, s._state.replace(
                hat_U=stepper.entry_dct2(s.cfg, s._consts, s._state.U)))
            del s
        for route in ('matmul', 'split'):
            p = Parameters(N=512, precision='float32', device='cuda',
                           kappa_tilde=KAPPA, transform_backend=route,
                           matmul_precision='high', no_gui=True)
            ens = EnsembleSolver(p, np.tile([[p.func_A0(p.temp),
                                              p.func_A1(p.temp)]], (4, 1)),
                                 kappas=np.full(4, KAPPA))
            ens.prepare()
            ens.solve_or_resume(2)
            del ens
    for _fn, (A, B), _k in rec.calls.get('K6', []):
        key = (tuple(A.shape), A.stride()[-2:], tuple(B.shape),
               B.stride()[-2:], A.dim() == 3 and A.stride(0) != 0,
               B.dim() == 3 and B.stride(0) != 0)
        seen.setdefault(key, (A, B))
    return list(seen.values())


def gemm_solve_phase(dev, card):
    """(a) K6 on every product the solve gives it (solve_products):
    held to its plain version as phase 7 (a) holds it (against the
    float64 product); a member stack also member by member against K6 on
    the member (the same bits); timed at the largest shape."""
    import torch
    from chsimpy_tpu_torch.ops import kernels as K

    rows = []
    pairs = solve_products(dev)
    check(pairs, 'no K6 product in a solve at matmul_precision high')
    big = max(pairs, key=lambda ab: ab[0].shape[-2] * ab[0].shape[-1]
              * ab[1].shape[-1])
    for A, B in pairs:
        got, plain = K.matmul(A, B), K.matmul_ref(A, B)
        ref = torch.matmul(A.double(), B.double())
        tag = (f"matmul in the solve {tuple(A.shape)}@{tuple(B.shape)} "
               f"strides {A.stride()} {B.stride()}")
        times = (timed_row(lambda: K.matmul(A, B),
                           lambda: K.matmul_ref(A, B))
                 if A is big[0] and B is big[1] else
                 {'ms': float('nan'), 'call_ms': float('nan'),
                  'plain_ms': float('nan')})
        row = held_to_plain(tag, got, plain, ref, times, card,
                            A=list(A.shape), B=list(B.shape))
        if got.dim() == 3:
            same = all(torch.equal(got[r], K.matmul(
                A[r] if A.dim() == 3 else A, B[r] if B.dim() == 3 else B))
                for r in range(got.shape[0]))
            row['members_same_bits'] = same
            check(same, f"{tag}: a member differs from K6 on the member")
        if A is big[0] and B is big[1]:
            M, Kd, N = A.shape[-2], A.shape[-1], B.shape[-1]
            row['library_ms'] = device_ms(lambda: torch.matmul(A, B))
            row.update(bound_fields(4 * (M * Kd + Kd * N + M * N),
                                    TF32_PASSES * 2.0 * M * Kd * N, 'tf32'))
            row['report'] = True
        rows.append(row)
    return rows


def _knob_fields(N, **knob):
    """Parameters fields of a float32 run at N with every knob pinned
    (the product precision the run takes by default, the forward at it, no
    band, no otf, no fold), then ``knob``: one knob alone, whatever the
    auto gates say."""
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.solver import resolve_matmul_precision
    mp = resolve_matmul_precision(Parameters(N=N, precision='float32'))
    return {'matmul_precision': mp, 'fwd_matmul_precision': mp,
            'inv_band': 0, 'otf_coeffs': 0, 'fold_field': False, **knob}


def knob_configs(N):
    """(b)'s configurations at size N: matmul at 'high' (the float32
    default from N=1024); at N >= 1024 the float32 class of fft and of
    split at its default precision ('high'), the crossover sizes; the
    split route with each knob and all together; --inv-band at N >= 1024
    only, as the JAX package measured it."""
    split = dict(_knob_fields(N), transform_backend='split')
    out = {'matmul high': dict(_knob_fields(N, matmul_precision='high',
                                            fwd_matmul_precision='high'),
                               transform_backend='matmul')}
    if N >= 1024:
        out['fft'] = {'transform_backend': 'fft'}
        out['split'] = dict(split)
    out['split fwd default'] = dict(split, fwd_matmul_precision='default')
    if N >= 1024:
        out['split inv-band N/4'] = dict(split, inv_band=N // 4)
    out['split otf'] = dict(split, otf_coeffs=1)
    out['split fold'] = dict(split, fold_field=True)
    out['split all'] = dict(split, fwd_matmul_precision='default',
                            inv_band=N // 4 if N >= 1024 else 0,
                            otf_coeffs=1, fold_field=True)
    return out


# (b)'s checks that are no stop runs, each a job of its own
KNOB_CHECKS = ('members', 'fold bits', 'n4096 class')


def knob_jobs():
    """(b)'s work as jobs for the workers: the checks of KNOB_CHECKS and
    the stop runs (N, golden, band, name, fields), the largest first; then
    the float64 canonical run with --otf-coeffs 1."""
    jobs = [(N, golden, band, name, fields)
            for N, golden, band in reversed(KNOB_STOPS)
            for name, fields in knob_configs(N).items()]
    return ([(None, None, None, name, None) for name in KNOB_CHECKS]
            + jobs + [(512, None, 0.0, 'float64 otf', None)])


def knob_run_raw(N, golden, name, fields):
    """One stop run of (b) (N=512: the canonical run, else the golden's
    configuration), float32 with ``fields``, from zeroed counts: its rows'
    E, stop, the counts and what the solver resolved."""
    import torch
    from chsimpy_tpu_torch import Parameters, Simulator
    from chsimpy_tpu_torch.ops import kernels as K

    if fields is None:
        # the float64 canonical run with --otf-coeffs 1: default_run's
        # checks (stop 1674, the anchors, K12 on every step)
        res = default_run('matmul', otf_coeffs=1)
        return dict(res, config=name, N=N)
    cfg = {} if golden is None else load_golden(golden)['config']
    p = Parameters(no_gui=True, device='cuda', kappa_tilde=KAPPA,
                   precision='float32', **cfg, **fields)
    sim = Simulator(p)
    K.reset_launches()
    t0 = time.perf_counter()
    sol = sim.solve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = sim.solver.cfg
    return {'N': N, 'config': name, 'route': c.transform_backend,
            'levels': c.spectral_levels, 'matmul_precision':
            c.matmul_precision, 'fwd': c.fwd_precision,
            'inv_band': c.inv_band, 'otf': c.otf_coeffs,
            'fold': c.fold_field, 'computed_steps': sol.computed_steps,
            'stop_reason': sol.stop_reason, 'seconds': seconds,
            'launches': {k: v for k, v in K.launches.items() if v},
            'E': [float(e) for e in sol.timedata.E]}


def knob_worker(indices, path):
    """A worker of (b): the jobs ``indices`` of :func:`knob_jobs`, their
    results to ``path`` (JSON); the checks read the earlier phases'
    float64 traces from ``path``'s directory (refs.json)."""
    import torch
    with open(os.path.join(os.path.dirname(path), 'refs.json')) as f:
        refs = json.load(f)
    checks = {'members': members_knob_run,
              'fold bits': lambda: fold_bits(
                  torch.device('cuda', torch.cuda.current_device())),
              'n4096 class': lambda: high_class_n4096(refs['E64_4096'])}
    out = []
    for i in indices:
        N, golden, _band, name, fields = knob_jobs()[i]
        if N is None:
            out.append({'check': name, 'result': checks[name]()})
        else:
            out.append(knob_run_raw(N, golden, name, fields))
    with open(path, 'w') as f:
        json.dump(out, f)
    return 0


# (b)'s worker processes (the card's machine has 8 cores)
KNOB_PROCS = 4


def start_knob_workers(E512, E64_4096):
    """(b)'s jobs in KNOB_PROCS processes on the card side by side (job i
    in process i % KNOB_PROCS): their host work overlaps, so (b)'s runs
    give stops and traces, not rates.  A full run starts them beside
    phase 6 (b) and (c) (single-process runs whose checks take no rates);
    --phase 16 at (b)."""
    import tempfile
    work = tempfile.mkdtemp(prefix='chip_smoke_knobs_')
    with open(os.path.join(work, 'refs.json'), 'w') as f:
        json.dump({'E64_4096': list(E64_4096)}, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    n = len(knob_jobs())
    procs = []
    for w in range(KNOB_PROCS):
        path = os.path.join(work, f'knobs{w}.json')
        idx = ','.join(str(i) for i in range(w, n, KNOB_PROCS))
        procs.append((path, subprocess.Popen(
            [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
             '--knob-runs', idx, '--out', path], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return {'work': work, 'procs': procs, 'E512': list(E512),
            't0': time.perf_counter()}


def wait_knob_workers(started, timeout=900):
    """Wait until every worker of :func:`start_knob_workers` has ended
    (their logs and exit codes into ``started``)."""
    if 'rcs' in started:
        return
    logs, rcs = [], []
    for _, proc in started['procs']:
        left = max(1.0, timeout - (time.perf_counter() - started['t0']))
        log, _ = proc.communicate(timeout=left)
        logs.append(log)
        rcs.append(proc.returncode)
    started.update(logs=logs, rcs=rcs,
                   wall=time.perf_counter() - started['t0'])


def stop_knob_workers(started):
    for _, proc in started['procs']:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_knob_workers(started, timeout=900):
    """Wait for :func:`start_knob_workers`'s processes (their checks
    raised there) and hold each run: its stop within its band of the
    float64 stop (the 1-pass forward: the E class only), E within
    KNOB_E_CLASS of float64 at every step, the kernels of its path
    launched on every step.  Returns (the runs, the checks' results, the
    workers' wall seconds)."""
    import shutil
    import numpy as np
    E512 = started['E512']
    runs, checks = [], {}
    try:
        wait_knob_workers(started, timeout)
        for (path, _), log, rc in zip(started['procs'], started['logs'],
                                      started['rcs']):
            print(log, end='', flush=True)
            check(rc == 0, f"knob worker exited {rc}:\n{log[-3000:]}")
            with open(path) as f:
                for res in json.load(f):
                    if 'check' in res:
                        checks[res['check']] = res['result']
                    else:
                        runs.append(res)
    finally:
        stop_knob_workers(started)
        shutil.rmtree(started['work'], ignore_errors=True)
    wall = started['wall']
    check(sorted(checks) == sorted(KNOB_CHECKS), f"checks {sorted(checks)}")
    bands = {N: (golden, band) for N, golden, band in KNOB_STOPS}
    out = []
    for res in sorted(runs, key=lambda r: (r['N'], r['config'])):
        if res['config'] == 'float64 otf':
            print(f"knob run float64 canonical --otf-coeffs 1: stop "
                  f"{res['computed_steps']}, E every 100 steps "
                  f"{res['E_every_100_max_rel']:.3e} of the anchors, "
                  f"update_otf {res['launches']['update_otf']}", flush=True)
            res.pop('E')
            out.append(res)
            continue
        N, name = res['N'], res['config']
        golden, band = bands[N]
        E64 = E512 if golden is None else load_golden(golden)['E']
        ref_stop = 1674 if golden is None else \
            load_golden(golden)['computed_steps']
        E = np.asarray(res.pop('E'))
        n = min(len(E), len(E64))
        rel = float(np.max(np.abs(E[:n] / np.asarray(E64[:n]) - 1)))
        shift = res['computed_steps'] / ref_stop - 1
        res.update(E_vs_f64_max_rel=rel, stop_shift=shift, band=band,
                   in_band=abs(shift) <= band)
        print(f"knob run N={N} float32 {name} ({res['route']}, "
              f"{res['matmul_precision']}, fwd {res['fwd']}, levels "
              f"{res['levels']}): stop {res['computed_steps']} "
              f"({shift:+.4%}, band {band:.2%}), E vs float64 {rel:.3e}, "
              f"launches {res['launches']}", flush=True)
        check(res['stop_reason'] == 'energy', f"{name} N={N}: no stop")
        check(rel <= KNOB_E_CLASS, f"{name} N={N}: E {rel:.3e} from "
                                   f"float64")
        if res['fwd'] != 'default':
            # the 1-pass forward is held to the E class only: the JAX
            # package measured it moving the canonical stop (1669 ->
            # 1683, chsimpy_tpu/core/solver.py:145-147)
            check(res['in_band'], f"{name} N={N}: stop "
                                  f"{res['computed_steps']} outside "
                                  f"{band:.2%} of {ref_stop}")
        L = res['launches']
        steps = res['computed_steps'] - 1
        update = 'update_otf' if res['otf'] else 'spectral_update'
        for k in ('chemical_potential', update, 'stats_sums', 'absdev_sum'):
            check(L.get(k, 0) >= steps, f"{name} N={N}: {k} launched "
                                        f"{L.get(k, 0)} in {steps} steps")
        high = 'high' in (res['matmul_precision'], res['fwd'])
        if res['route'] in ('matmul', 'split') and high:
            check(L.get('matmul', 0) >= steps, f"{name}: K6 launched "
                                               f"{L.get('matmul', 0)}")
        else:
            check('matmul' not in L, f"{name}: K6 launched")
        out.append(res)
    return out, checks, wall


def fold_bits(dev):
    """(b) with --split-levels pinned the folded run's U is the natural
    run's to the bit, and E, E2 and Ra too (K3's fold mode; N=4096
    float32 64 steps at levels 4 and 5; N=512 float64 with -a and the
    host jitter to step 520; N=512 float32 with the device jitter)."""
    import numpy as np
    import torch
    out = {}
    for N, prec, steps, levels, extra in (
            (4096, 'float32', 64, 4, {}), (4096, 'float32', 64, 5, {}),
            (512, 'float64', 520, 2,
             {'adaptive_time': True, 'delt_max': 8 * ITEM7_DELT_MAX,
              'jitter': 0.01}),
            (512, 'float32', 300, 2,
             {'jitter': 0.01, 'jitter_backend': 'device'})):
        Us, rows = [], []
        for ff in (False, True):
            s = make_solver(N, prec, steps, transform='split',
                            split_levels=levels, fold_field=ff,
                            matmul_precision='high', **extra)
            sol = s.solve_or_resume(steps)
            Us.append(sol.U.clone())
            rows.append(sol.timedata.data()[:, [1, 2, 5]].copy())
            del s
        same = torch.equal(Us[0], Us[1])
        same_rows = bool(np.array_equal(rows[0], rows[1]))
        key = f"N={N} {prec} levels {levels} {steps} steps {extra}"
        out[key] = {'U_same_bits': same, 'E_E2_Ra_same_bits': same_rows}
        print(f"fold bits {key}: U {'equal' if same else 'DIFFER'}, "
              f"E/E2/Ra {'equal' if same_rows else 'differ'}", flush=True)
        check(same and same_rows,
              f"fold {key}: the folded run is not the natural run")
    return out


def high_class_n4096(E64_64):
    """(b) at N=4096 over 256 steps, E within KNOB_E_CLASS of a float64
    run at every step (its first 64 steps = phase 5's, ``E64_64``):
    matmul at 'high' (the float32 default's condition), and the split
    route with what its auto gates take there (the 1-pass forward,
    --otf-coeffs)."""
    import numpy as np
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core import solver as solver_mod
    s64 = make_solver(4096, 'float64', 256)
    E64 = np.asarray(s64.solve_or_resume(256).timedata.E)
    del s64
    check(np.array_equal(E64[:64], np.asarray(E64_64)),
          'N=4096 float64: not phase 5\'s run')
    gated = Parameters(N=4096, precision='float32', transform_backend='split')
    runs = {'matmul high': {'matmul_precision': 'high'},
            'split auto gates': {
                'transform': 'split', 'matmul_precision': None,
                'fwd_matmul_precision':
                    solver_mod.resolve_fwd_matmul_precision(gated),
                'otf_coeffs': int(solver_mod.resolve_otf_coeffs(gated))}}
    out = {}
    for name, kw in runs.items():
        s32 = make_solver(4096, 'float32', 256, **kw)
        E32 = np.asarray(s32.solve_or_resume(256).timedata.E)
        c = s32.cfg
        del s32
        rel = float(np.max(np.abs(E32 / E64 - 1)))
        out[name] = {'E_vs_f64_max_rel_256': rel,
                     'precision': c.matmul_precision, 'fwd': c.fwd_precision,
                     'otf': c.otf_coeffs, 'fold': c.fold_field,
                     'inv_band': c.inv_band}
        print(f"N=4096 float32 {name} ({c.transform_backend}, "
              f"{c.matmul_precision}, fwd {c.fwd_precision}, otf "
              f"{c.otf_coeffs}, fold {c.fold_field}, band {c.inv_band}): E "
              f"vs float64 {rel:.3e} over 256 steps", flush=True)
        check(rel <= KNOB_E_CLASS, f"N=4096 {name}: E {rel:.3e} from "
                                   f"float64")
    return out


# (c): N=4096 float32 configurations, steps/s in turns
SPEED_N = 4096
SPEED_WINDOW = 96


def speed_configs():
    """(c): FP32 against 3xTF32 on matmul; the split route at 'high' (its
    default at N=4096) against each knob alone and all together; fft;
    -a with and without --otf-coeffs (matmul, full float32, as phase 9
    (c))."""
    split = dict(_knob_fields(SPEED_N, matmul_precision='high',
                              fwd_matmul_precision='high'),
                 transform='split')
    a = {'transform': 'matmul', 'matmul_precision': 'highest',
         'adaptive_time': True, 'delt_max': ITEM7_DELT_MAX}
    return {
        'matmul highest': {'transform': 'matmul',
                           'matmul_precision': 'highest'},
        'matmul high': {'transform': 'matmul', 'matmul_precision': 'high'},
        'split high': dict(split),
        'split high fwd default': dict(split,
                                       fwd_matmul_precision='default'),
        'split high inv-band N/4': dict(split, inv_band=SPEED_N // 4),
        'split high otf': dict(split, otf_coeffs=1),
        'split high fold': dict(split, fold_field=True),
        'split high all': dict(split, fwd_matmul_precision='default',
                               inv_band=SPEED_N // 4, otf_coeffs=1,
                               fold_field=True),
        'fft': {'transform': 'fft'},
        'matmul -a': dict(a),
        'matmul -a otf': dict(a, otf_coeffs=1),
    }


def knob_speeds(card):
    """(c) steps/s at N=4096 float32 of every speed_configs entry, each
    after a 32-step warm-up chunk, two windows in turns (forward then
    backward order)."""
    solvers = {}
    for name, kw in speed_configs().items():
        s = make_solver(SPEED_N, 'float32', 32, **kw)
        s.solve_or_resume(32)
        solvers[name] = s
    names = list(solvers)
    rates = {n: [] for n in names}
    for n in names + names[::-1]:
        rates[n].append(rate(solvers[n], SPEED_WINDOW))
    for n, v in rates.items():
        c = solvers[n].cfg
        print(f"steps/s N=4096 float32 {n} (levels {c.spectral_levels}): "
              + ', '.join(f"{r:.2f}" for r in v) + f"  ({card})",
              flush=True)
    del solvers
    return rates


# (d): auto's route runs at least this share of the fastest route's
# steps/s in the same run
AUTO_MARGIN = 0.85
# (d): the auto sweep's sizes and windows (steps) a configuration
SWEEP = ((512, 256), (1024, 128), (2048, 128), (4096, 32))


def sweep_routes(N, prec):
    """(d)'s configurations at N: float32 matmul at both product
    precisions (the float32 default's evidence), split at the default
    one, fft; float64 every route."""
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.solver import resolve_matmul_precision
    if prec == 'float64':
        return [('matmul', None), ('split', None), ('fft', None),
                ('ozaki', None)], None
    mp = resolve_matmul_precision(Parameters(N=N, precision='float32'))
    return [('matmul', 'highest'), ('matmul', 'high'), ('split', mp),
            ('fft', None)], mp


def _sweep_rate(N, prec, window, route, mp=None):
    kw = {'transform': route}
    if mp:
        kw['matmul_precision'] = mp
    s = make_solver(N, prec, window, **kw)
    s.solve_or_resume(window)
    out = max(rate(s, window), rate(s, window))
    return out, s


def auto_sweep(card, speeds, earlier=None):
    """(d) steps/s of every route at N = 512 .. 4096 in float32 (full
    float32 and 3xTF32 products) and float64, one warm-up chunk and two
    windows each; N=4096 float32 from (c).  ``earlier``: the same run's
    earlier measurements, taken instead of measuring again: the float64
    whole runs of phases 4, 6 (b), (c), 7 (c), (e) (steps over seconds) at
    N <= 2048 and phase 6 (d)'s windows at N=4096 (matmul, ozaki).  The
    float64 fft at N=4096 is held to the matmul run (E within 1e-10 over
    64 steps).  Then each (N, precision)'s fastest route beside what
    core/solver.py's AUTO_ROUTES picks."""
    import numpy as np
    from chsimpy_tpu_torch.core import solver as solver_mod
    out = dict(earlier or {})
    for prec in ('float32', 'float64'):
        for N, window in SWEEP:
            for route, mp in sweep_routes(N, prec)[0]:
                key = f"N={N} {prec} {route}" + (f" {mp}" if mp else '')
                if key in out or (earlier and route == 'ozaki'):
                    # the ozaki route is 4-12x slower than matmul at every
                    # N (phase 6, and this sweep run alone)
                    continue
                if prec == 'float32' and N == SPEED_N:
                    name = {'fft': 'fft', 'matmul highest': 'matmul highest',
                            'matmul high': 'matmul high',
                            'split high': 'split high'}.get(
                        f"{route} {mp}" if mp else route)
                    if name:
                        out[key] = max(speeds[name])
                        continue
                out[key], s = _sweep_rate(N, prec, window, route, mp)
                if (N, prec, route) == (4096, 'float64', 'fft'):
                    mm = make_solver(4096, 'float64', 64)
                    Em = np.asarray(mm.solve_or_resume(64).timedata.E)
                    Ef = np.asarray(s.solution.timedata.E[:64])
                    rel = float(np.max(np.abs(Ef / Em - 1)))
                    out['fft_f64_4096_E_vs_matmul'] = rel
                    print(f"N=4096 float64 fft: E vs matmul {rel:.3e} over "
                          f"64 steps", flush=True)
                    check(rel <= 1e-10, f"float64 fft E {rel:.3e}")
                    del mm
                del s
                print(f"auto sweep {key}: {out[key]:.2f} steps/s  ({card})",
                      flush=True)
    table = {}
    for prec in ('float32', 'float64'):
        for N, _ in SWEEP:
            # the routes at the precision a run takes when it pins none
            routes, mp = sweep_routes(N, prec)
            keys = {r: f"N={N} {prec} {r}" + (f" {m}" if m else '')
                    for r, m in routes if m in (None, mp)}
            cands = {r: out[k] for r, k in keys.items() if k in out}
            best = max(cands, key=cands.get)
            auto = solver_mod.auto_route(N, prec)
            table[f"N={N} {prec}"] = {'fastest': best, 'auto': auto,
                                      'precision': mp,
                                      'steps_per_s': cands}
            print(f"auto N={N} {prec} ({mp or 'float64'} products): fastest "
                  f"{best}, auto picks {auto}: {cands}", flush=True)
            # host-bound sizes move ~10-20% run to run (PERF.md §7)
            check(cands[auto] >= AUTO_MARGIN * cands[best],
                  f"auto N={N} {prec} picks {auto} ({cands[auto]:.1f} "
                  f"steps/s), the card measured {best} at "
                  f"{cands[best]:.1f}")
    return {'steps_per_s': out, 'table': table}


def earlier_rates(detail):
    """(d)'s float64 rates from the same run's earlier phases: whole runs
    (computed steps - 1 over their seconds) of the canonical run on
    matmul (4), split and fft (7 (c)), the N=1024/2048 stop goldens (7
    (e)); phase 6 (d)'s windows at N=4096 (matmul, ozaki).  Phase 6 (b)
    and (c) share the card with (b)'s workers: their ozaki runs give no
    rate (the ozaki route is 4-12x slower than matmul at every N)."""
    out = {}

    def whole(key, res):
        out[key] = (res['computed_steps'] - 1) / res['seconds']
    whole('N=512 float64 matmul', detail['default_run'])
    for t in ('split', 'fft'):
        whole(f'N=512 float64 {t}', detail['routes']['default_run'][t])
    for res in detail['routes']['stop_goldens']:
        N = {'n1024_uniform_stop': 1024,
             'n2048_uniform_stop': 2048}.get(res['golden'])
        if N:
            whole(f"N={N} float64 {res['route']}", res)
    for k, v in detail['ozaki']['n4096']['steps_per_s'].items():
        out[f'N=4096 float64 {k}'] = max(v)
    return out


def members_knob_run():
    """The ensemble's path under the knobs: R=4 N=512 float32 on split at
    'high' with --otf-coeffs 1 and --fold-field over 64 steps from
    zeroed counts (K12_members, K3_members' fold mode and K6 launched on
    every step), each member within 1e-6 of its single run."""
    import numpy as np
    import torch
    from chsimpy_tpu_torch import Parameters
    from chsimpy_tpu_torch.core.solver import Solver
    from chsimpy_tpu_torch.ensemble import EnsembleSolver
    from chsimpy_tpu_torch.ops import kernels as K

    fields = dict(N=512, precision='float32', device='cuda',
                  kappa_tilde=KAPPA, transform_backend='split',
                  matmul_precision='high', otf_coeffs=1, fold_field=True,
                  full_sim=True, no_gui=True)
    p = Parameters(**fields)
    pairs = canonical_pairs(4)
    kappas = KAPPA * (1.0 + 0.01 * np.arange(4))
    ens = EnsembleSolver(p, pairs, kappas=kappas)
    ens.prepare()
    K.reset_launches()
    sols = ens.solve_or_resume(64)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    for name in ('update_otf_members', 'stats_sums_members', 'matmul'):
        check(launches[name] >= 63, f"ensemble: {name} launched "
                                    f"{launches[name]} times in 63 steps")
    worst = 0.0
    for r, sol in enumerate(sols):
        q = Parameters(**fields, A0_const=float(pairs[r][0]),
                       A1_const=float(pairs[r][1]))
        q.kappa_tilde = float(kappas[r])
        s = Solver(q)
        s.prepare()
        one = s.solve_or_resume(64)
        worst = max(worst, float(np.max(np.abs(
            np.asarray(sol.timedata.E) / np.asarray(one.timedata.E) - 1))))
    print(f"ensemble R=4 N=512 float32 split high otf fold: 64 steps, "
          f"members vs single runs E {worst:.3e}, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check(worst <= 1e-6, f"ensemble members {worst:.3e} from single runs")
    return {'launches': launches, 'E_vs_single_max_rel': worst}


def knobs_phase(dev, card, E512, E64_4096, detail=None):
    """Phase 16 (``detail``: the run's earlier phases, whose float64
    rates (d) takes instead of measuring again; (b)'s workers, if phase
    6 started them, in KEPT['knob_workers'])."""
    import torch
    out = {'otf_kernels': otf_kernel_phase(dev, card),
           'fold_kernels': fold_kernel_phase(dev, card),
           'gemm_solve': gemm_solve_phase(dev, card)}
    t0 = time.perf_counter()
    started = KEPT.pop('knob_workers', None) or start_knob_workers(
        E512, E64_4096)
    out['runs'], checks, out['workers_wall_s'] = finish_knob_workers(
        started)
    out['members'] = checks['members']
    out['fold_bits'] = checks['fold bits']
    out['high_n4096'] = checks['n4096 class']
    out['seconds_b'] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out['speeds'] = knob_speeds(card)
    out['seconds_c'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['auto'] = auto_sweep(card, out['speeds'], None if detail is None
                             else earlier_rates(detail))
    out['seconds_d'] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


def phase16_alone(detail, dev, card, out_dir) -> int:
    """``--phase 16``: phase 16 after what it is held to (phase 4's
    canonical run, phase 5's float64 N=4096 run); its details to
    DIR/chip_smoke_16.json with ``--out``."""
    import numpy as np
    detail['default_run'] = default_run('matmul')
    s64 = make_solver(4096, 'float64', 64)
    E64 = np.asarray(s64.solve_or_resume(64).timedata.E).tolist()
    del s64
    t0 = time.perf_counter()
    detail['knobs'] = knobs_phase(dev, card, detail['default_run']['E'],
                                  E64)
    detail['phase_seconds'][16] = time.perf_counter() - t0
    print(f"phase 16: {detail['phase_seconds'][16]:.1f} s  ({card})",
          flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, 'chip_smoke_16.json'), 'w') as f:
            json.dump(detail, f, indent=1)
    return 0


def gpu_clocks():
    """The card's SM clock, temperature and power draw (nvidia-smi)."""
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,temperature.gpu,power.draw',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else f'nvidia-smi exited {proc.returncode}'


# what a timed row says of the design it was timed beside (design_turns),
# carried into the JSON line
DESIGN_KEYS = ('before_ms', 'tile', 'earlier_tile', 'parent_body_ms',
               'parent_body_same_bits', 'k4_k11_ms', 'fused_same_bits')


def summary_rows(detail):
    """The kernels' JSON line: one row per kernel."""
    rows = []
    for name, replaces in REPLACES.items():
        if name == 'slice_field':
            N, n, kind = SLICE_REPORT
            row = next(r for r in detail['ozaki']['slice_kernel']
                       if (r['N'], r['n_slices'], r['field']) == SLICE_REPORT)
            run = detail['ozaki']['default_run']['launches']
            launches = run[name]
            extra = {'shape': f"{N}x{N} float64 -> {n} int8 slices",
                     'launch_ms': row['launch_ms'],
                     'one_launch_launches': run['one_launch'][name],
                     **kernel_bound(name, N, 'float64', n)}
        elif name == 'matmul':
            row = detail['routes']['gemm'][0]
            launches = detail['routes']['bakeoff']['launches'][name]
            extra = {'shape': f"({row['M']}x{row['K']})@({row['K']}x"
                              f"{row['N']}) float32",
                     'TFLOPS': row['TFLOPS'],
                     'plain_TFLOPS': row['plain_TFLOPS'],
                     **kernel_bound(name, row['M'], 'float32')}
        elif name in SHARDED_PATH:
            N, dtype, mesh = SHARD_REPORT
            row = next(r for r in detail['sharded']['kernels']
                       if r['name'] == name and (r['N'], r['dtype'],
                                                 r['mesh'])
                       == (N, dtype, '%dx%d' % mesh))
            launches = detail['sharded']['gloo']['launches'][0][name]
            extra = {'shape': f"{row['block']} {dtype} block of {N}x{N} on "
                              f"{row['mesh']}",
                     'bound_ms': row['bound_ms'], 'bound_by': row['bound_by']}
            if 'max_rel_err' in row:
                extra['max_rel_err'] = row['max_rel_err']
        elif name == 'sobol_jitter':
            N, dtype, where = SOBOL_REPORT
            row = next(r for r in detail['item7']['sobol_kernel']
                       if (r['N'], r['dtype'], r['where']) == SOBOL_REPORT)
            run = detail['item7']['n4096'][
                '-j 0.01 -g sobol --jitter-backend device']
            launches = run['launches'][name]
            extra = {'shape': f"{N}x{N} {dtype}, in place",
                     'note': 'no Pallas counterpart: the XLA-fused '
                             'sobol_points of the JAX step',
                     'bound_ms': row['bound_ms'], 'bound_by': row['bound_by']}
        elif name == 'threefry_jitter':
            N, dtype = THREEFRY_REPORT
            row = next(r for r in detail['item7']['threefry_kernel']
                       if (r['N'], r['dtype']) == THREEFRY_REPORT)
            run = detail['item7']['n4096']['-j 0.01 --jitter-backend device']
            launches = run['launches'][name]
            extra = {'shape': f"{N}x{N} {dtype}, in place",
                     'note': 'no Pallas counterpart: jax.random.split and '
                             'uniform of the JAX step',
                     'before_ms': row['before_ms'],
                     'bound_ms': row['bound_ms'], 'bound_by': row['bound_by']}
        else:
            row = next(r for r in detail['kernels'] if r['name'] == name
                       and (r['N'], r['dtype']) == REPORT_SHAPE)
            launches = detail['default_run']['launches'][name]
            extra = {'max_rel_err': row['max_rel_err'],
                     'shape': f"{REPORT_SHAPE[0]}x{REPORT_SHAPE[0]} "
                              f"{REPORT_SHAPE[1]}",
                     **kernel_bound(name, *REPORT_SHAPE)}
        rows.append({
            'name': name, 'route': 'cuda',
            'source': GEMM_SOURCE if name == 'matmul' else SOURCE,
            'replaces': replaces, 'launches': launches,
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'call_ms': row['call_ms'], 'plain_ms': row['plain_ms'],
            'library_ms': row.get('library_ms'), **extra,
            **{k: row[k] for k in DESIGN_KEYS if k in row}})
        rows[-1]['bound_share'] = rows[-1]['bound_ms'] / row['ms']
    # the member-batched kernels at the canonical batch's shape, counted
    # on phase 10 (b)'s run
    R, N, dtype = MEMBER_REPORT
    for name, single in MEMBER_KERNELS.items():
        row = next(r for r in detail['ensemble']['member_kernels']
                   if r['name'] == name
                   and (r['R'], r['N'], r['dtype']) == MEMBER_REPORT)
        fused = name == 'absdev_sum_members'
        rows.append({
            'name': name, 'route': 'cuda', 'source': SOURCE,
            'replaces': REPLACES[single] + ' (vmapped over the member '
                                           'axis, chsimpy_tpu/ensemble.py)'
            + (', and in its second pass K11 (each member\'s Ra): '
               + ROW_ABSDEV_REPLACES if fused else ''),
            'launches': detail['ensemble']['canonical']['launches'][name],
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'call_ms': row['call_ms'], 'plain_ms': row['plain_ms'],
            'library_ms': None, 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'], 'max_rel_err': row['max_rel_err'],
            'single_launches_ms': row['single_launches_ms'],
            'shape': f"{R} members of {N}x{N} {dtype}",
            **{k: row[k] for k in DESIGN_KEYS if k in row},
            'bound_share': row['bound_ms'] / row['ms']})
    # K5_members at the canonical batch's shape, counted on phase 12 (b)'s
    # run of the ozaki batch
    R, N, n = SLICE_MEMBER_REPORT
    row = next(r for r in detail['ozaki_ensemble']['slice_members']
               if (r['R'], r['N'], r['n_slices']) == SLICE_MEMBER_REPORT)
    rows.append({
        'name': 'slice_field_members', 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES['slice_field'] + ' (vmapped over the member '
                                              'axis, chsimpy_tpu/ensemble.py)',
        'launches': detail['ozaki_ensemble']['canonical']['launches'][
            'slice_field_members'],
        'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
        'call_ms': row['call_ms'], 'plain_ms': row['plain_ms'],
        'library_ms': None, 'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'],
        'single_launches_ms': row['single_launches_ms'],
        'shape': f"{R} members of {N}x{N} float64 -> {n} int8 slices",
        'one_launch_launches': detail['ozaki_ensemble']['canonical'][
            'launches']['one_launch']['slice_field_members'],
        **{k: row[k] for k in DESIGN_KEYS if k in row},
        'bound_share': row['bound_ms'] / row['ms']})
    # K7_members on a 2x2 mesh's block, counted on phase 14 (c)'s grid
    # ensemble (rank 0)
    R, N, dtype = LOCAL_MEMBER_REPORT
    row = next(r for r in detail['distributed']['kernels']
               if (r['R'], r['N'], r['dtype']) == LOCAL_MEMBER_REPORT)
    rows.append({
        'name': 'local_band_sums_members', 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES['local_band_sums'] + ' (vmapped over the member '
                                                  'axis, chsimpy_tpu/'
                                                  'ensemble.py)',
        'launches': detail['distributed']['grid']['launches'][
            'local_band_sums_members'],
        'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
        'call_ms': row['call_ms'], 'plain_ms': row['plain_ms'],
        'library_ms': None, 'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'], 'max_rel_err': row['max_rel_err'],
        'single_launches_ms': row['single_launches_ms'],
        'shape': f"{R} members' {row['block']} {dtype} blocks of {N}x{N} "
                 f"on {row['mesh']}",
        **{k: row[k] for k in DESIGN_KEYS if k in row},
        'bound_share': row['bound_ms'] / row['ms']})
    # K5 sharded on a rank's pencil block (phase 15 (a)), counted on
    # phase 15 (b)'s canonical ozaki run and (e)'s ozaki grid ensemble
    # (rank 0); on a rank's grid block (phase 15 (j)), counted on (h)'s
    # N=4094 grid ozaki run (rank 0)
    pen = detail['pencil']
    world_err = max(max(c['max_diff_whole'], c['max_diff_plain'])
                    for c in pen['slice_checks'])
    grid_row = next(r for r in pen['grid_slice_timing']
                    if r['N'] == GRID_SLICE_REPORT[0])
    counted = (pen['canonical']['ozaki']['launches'][0][
        'slice_field_sharded'], pen['ensemble']['ozaki']['launches'][
        'slice_field_members_sharded'], pen['grid']['grid_ozaki'][
        'launches']['slice_field_sharded'])
    for row, launches in zip(pen['slice_timing'] + [grid_row], counted):
        grid = row is grid_row
        rows.append({
            'name': row['name'], 'route': 'cuda', 'source': SOURCE,
            'replaces': REPLACES['slice_field'] + (
                ' on the grid layout (the GSPMD-partitioned ozaki route, '
                'chsimpy_tpu/core/stepper.py:707-718)' if grid else
                ' on the pencil layout (the sharded ozaki route, '
                'chsimpy_tpu/core/stepper.py:690-705' + (
                    ', vmapped' if 'R' in row else '') + ')'),
            'layout': 'grid' if grid else 'pencil',
            'launches': launches,
            'max_abs_err': max(row['max_abs_err'], world_err),
            'ms': row['ms'], 'call_ms': row['call_ms'],
            'plain_ms': row['plain_ms'], 'library_ms': None,
            'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
            'shape': (f"{row.get('R', 1)} x {row['block']} float64 "
                      f"block(s) of {row['N']}x{row['N']} -> "
                      f"{row['n_slices']} int8 slices, world max left out"),
            'launch_ms': row['launch_ms'],
            **({'whole_field_K5_ms': row['whole_field_K5_ms']}
               if 'whole_field_K5_ms' in row else
               {'single_launches_ms': row['single_launches_ms']}),
            **({'strip_ms': row['strip_ms']} if grid else {}),
            'bound_share': row['bound_ms'] / row['ms']})
    rows += knob_rows(detail['knobs'])
    return rows


def knob_rows(kn):
    """Phase 16's kernels in the JSON line: K12 and K12_members (N=4096
    float32, R=4), counted on (b)'s canonical split run with --otf-coeffs
    1 and the ensemble's run; K3's fold mode (N=4096 float32), counted on
    (b)'s canonical split run with --fold-field; K6 at its largest product
    in a solve, counted on (b)'s N=1024 split run at 'high'."""
    def launches(N, config, name):
        return next(r for r in kn['runs'] if r['N'] == N
                    and r['config'] == config)['launches'].get(name, 0)

    def row_of(rows, **key):
        return next(r for r in rows if 'ms' in r and all(
            r.get(k) == v for k, v in key.items()))
    otf = row_of(kn['otf_kernels'], name='update_otf', N=OTF_REPORT[0],
                 dtype=OTF_REPORT[1])
    R, N, dt = OTF_MEMBERS_REPORT
    otfm = row_of(kn['otf_kernels'], name='update_otf_members', R=R, N=N,
                  dtype=dt)
    fold = row_of(kn['fold_kernels'], N=FOLD_REPORT[0],
                  dtype=FOLD_REPORT[1])
    gemm = next(r for r in kn['gemm_solve'] if r.get('report'))
    out = []
    for name, row, replaces, count, shape, extra in (
            ('update_otf', otf, OTF_REPLACES,
             launches(512, 'split otf', 'update_otf'),
             f"{N}x{N} {dt}", {'K2_ms': otf['K2_ms']}),
            ('update_otf_members', otfm, OTF_REPLACES + ' (vmapped over '
             'the member axis, chsimpy_tpu/ensemble.py)',
             kn['members']['launches']['update_otf_members'],
             f"{R} members of {N}x{N} {dt}",
             {'single_launches_ms': otfm['single_launches_ms']}),
            ('stats_sums (fold)', fold, REPLACES['stats_sums'] + ' (on the '
             'folded layout of chsimpy_tpu/core/stepper.py:405)',
             launches(512, 'split fold', 'stats_sums'),
             f"{FOLD_REPORT[0]}x{FOLD_REPORT[0]} {FOLD_REPORT[1]}, folded",
             {'natural_ms': fold['natural_ms'],
              'over_natural': fold['over_natural'],
              'max_rel_err': fold['max_rel_err']}),
            ('matmul (solve)', gemm, REPLACES['matmul'] + ' (the solve\'s '
             'float32 products at Precision.HIGH, chsimpy_tpu/core/'
             'stepper.py:615-650, 719-729)',
             launches(1024, 'split', 'matmul'),
             f"{gemm['A']}@{gemm['B']} float32", {})):
        out.append({
            'name': name, 'route': 'cuda',
            'source': GEMM_SOURCE if name.startswith('matmul') else SOURCE,
            'replaces': replaces, 'launches': count,
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'call_ms': row['call_ms'], 'plain_ms': row['plain_ms'],
            'library_ms': row.get('library_ms'), 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'], 'shape': shape, **extra,
            'bound_share': row['bound_ms'] / row['ms']})
    return out


def kernels_only(detail, dev, card, out_dir) -> int:
    """The kernel parts of phases 6-8 after phase 3, and a table of every
    kernel at its report shape (no main path, so no launch counts and no
    closing lines)."""
    detail['slice_kernel'] = slice_phase(dev, card)
    detail['gemm'] = gemm_phase(dev, card)
    detail['shard_kernels'] = shard_kernel_phase(dev, card)
    detail['sobol_kernel'] = sobol_phase(dev, card)
    detail['threefry_kernel'] = threefry_phase(dev, card)
    detail['member_kernels'] = member_kernel_phase(dev, card)
    detail['slice_members'] = member_slice_phase(dev, card)
    detail['local_members'] = local_members_kernel_phase(dev, card)
    detail['row_absdev'] = row_absdev_kernel_phase(dev, card)
    detail['pencil_slices'] = pencil_slice_timing(dev, card)
    detail['pencil_blocks'] = pencil_block_kernels(dev, card)
    detail['grid_slices'] = grid_slice_timing(dev, card)
    detail['grid_blocks'] = grid_block_kernels(dev, card)
    detail['otf_kernels'] = otf_kernel_phase(dev, card)
    detail['fold_kernels'] = fold_kernel_phase(dev, card)
    report = [r for r in detail['kernels'] if r['N'] == REPORT_SHAPE[0]
              and 'ms' in r]
    report += [r for r in detail['sobol_kernel'] if 'ms' in r
               and r['N'] == SOBOL_REPORT[0]]
    report += [r for r in detail['threefry_kernel'] if 'ms' in r]
    report += [r for r in detail['slice_kernel'] if 'ms' in r
               and (r['N'], r['n_slices'], r['field']) == SLICE_REPORT]
    report += [dict(detail['gemm'][0],
                    **kernel_bound('matmul', detail['gemm'][0]['M'],
                                   'float32'))]
    report += [r for r in detail['shard_kernels'] if 'ms' in r
               and r['N'] == SHARD_REPORT[0]]
    report += detail['member_kernels']
    report += [r for r in detail['slice_members'] if 'ms' in r]
    report += detail['local_members'] + [r for r in detail['row_absdev']
                                         if 'ms' in r]
    report += detail['pencil_slices'] + detail['grid_slices']
    report += [r for r in detail['otf_kernels'] + detail['fold_kernels']
               if 'ms' in r]
    for r in report:
        if 'bound_ms' not in r:     # the slice kernel's row
            r.update(kernel_bound(r['name'], r['N'], 'float64'))
        launches = ''.join(f"  {k} {v:.4f} ms"
                           for k, v in r.get('launch_ms', {}).items())
        print(f"kernels-only {r['name']:26s} {r.get('dtype', ''):8s} "
              f"{'R=%d N=%d ' % (r['R'], r['N']) if 'R' in r else ''}"
              f"device {r['ms']:.4f} ms  one call {r['call_ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%}){launches}  ({card})",
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, 'chip_smoke_kernels.json'),
                  'w') as f:
            json.dump(detail, f, indent=1)
    return 0


def phase14_alone(detail, dev, card, out_dir) -> int:
    """``--phase 14``: phase 14 after what it is held to (phase 4's
    canonical run, phase 8 (c)'s world run, phase 10 (b)'s batch without
    its single runs, phase 11 (a)'s experiment run and checks); its
    details to DIR/chip_smoke_14.json with ``--out``."""
    import shutil
    import tempfile
    from chsimpy_tpu_torch.parallel.distributed import spawn_grid
    from chsimpy_tpu_torch.parallel.workers import run_tasks
    detail['default_run'] = default_run()
    # phase 8 (c)'s canonical world run alone (its checks are phase 8's)
    ckpt = os.path.join(kept_dir(), 'mesh.npz')
    keep_mesh_run(spawn_grid(run_tasks, WORLD_SHAPE, backend='gloo',
                             device='cuda', args=(world_tasks(ckpt)[:1],),
                             timeout=900), ckpt)
    canonical_ensemble()
    work = tempfile.mkdtemp(prefix='chip_smoke_uq_')
    try:
        detail['experiment'] = {'f64': experiment_f64(
            card, os.path.join(work, 'f64'))}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    detail['distributed'] = distributed_phase(dev, card,
                                              detail['default_run']['E'])
    detail['phase_seconds'][14] = time.perf_counter() - t0
    print(f"phase 14: {detail['phase_seconds'][14]:.1f} s  ({card})",
          flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, 'chip_smoke_14.json'), 'w') as f:
            json.dump(detail, f, indent=1)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ['--uq-process']:
        # a process of phase 14 (d): the experiment's own argument list
        return uq_process(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', help='directory for chip_smoke.json')
    ap.add_argument('--kernels-only', action='store_true',
                    help='only the kernels against their plain versions, '
                         'and their times')
    ap.add_argument('--phase', type=int, choices=(14, 15, 16),
                    help='run this phase alone after the build, with the '
                         'parts of earlier phases it holds its results to '
                         '(phase 14: the canonical run of 4, the batch of '
                         '10 (b), the float64 experiment of 11 (a); phase '
                         '15: the canonical runs on split and ozaki, N=4096 '
                         'float64 matmul and float32 split; phase 16: the '
                         'canonical run of 4); no closing lines')
    # a worker of phase 16 (b): knob runs, saved to --out
    ap.add_argument('--knob-runs', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    if args.knob_runs:
        return knob_worker([int(i) for i in args.knob_runs.split(',')],
                           args.out)
    from chsimpy_tpu_torch.ops import cuda_build
    from chsimpy_tpu_torch.sysinfo import card_line
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
              'cuda': torch.version.cuda, 'build_seconds': info['seconds'],
              'phase_seconds': {}}

    try:
        return _main(args, detail, dev, card, torch)
    finally:
        if 'knob_workers' in KEPT:
            stop_knob_workers(KEPT['knob_workers'])
        if 'dir' in KEPT:
            import shutil
            shutil.rmtree(KEPT['dir'], ignore_errors=True)


def _main(args, detail, dev, card, torch) -> int:
    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        detail['phase_seconds'][phase] = time.perf_counter() - t0
        return out

    if args.phase == 14:
        return phase14_alone(detail, dev, card, args.out)
    if args.phase == 15:
        return phase15_alone(detail, dev, card, args.out)
    if args.phase == 16:
        return phase16_alone(detail, dev, card, args.out)
    # the SM clock beside phase 3's kernel window (B1 and B8 read slower in
    # some runs with the code unchanged)
    detail['clocks_before_phase3'] = gpu_clocks()
    detail['kernels'] = timed(3, kernel_phase, dev, card)
    detail['clocks_after_phase3'] = gpu_clocks()
    print(f"clocks.sm, temperature.gpu, power.draw: before phase 3 "
          f"{detail['clocks_before_phase3']}, after "
          f"{detail['clocks_after_phase3']}", flush=True)
    if args.kernels_only:
        return kernels_only(detail, dev, card, args.out)
    detail['default_run'] = timed(4, default_run)
    fm = detail['fast_mode'] = timed(5, fast_mode, card)
    KEPT['knob_refs'] = (detail['default_run']['E'], fm['E_f64_64_steps'])
    detail['ozaki'] = timed(6, ozaki_phase, dev, card)
    detail['routes'] = timed(7, routes_phase, dev, card,
                             fm['E_f64_64_steps'])
    refs = {'E_f32_4096': fm['E_f32_64_steps'],
            'E_f64_4096': fm['E_f64_64_steps'],
            'U0_mean_4096': fm['f32_mean_U_initial'],
            'E_single_n512': detail['default_run']['E']}
    detail['sharded'] = timed(8, sharded_phase, dev, card, refs)
    detail['item7'] = timed(9, item7_phase, dev, card,
                            fm['steps_per_s']['N=4096 float32'])
    detail['ensemble'] = timed(10, ensemble_phase, dev, card,
                               detail['default_run']['E'])
    detail['experiment'] = timed(11, experiment_phase, card)
    detail['ozaki_ensemble'] = timed(12, ozaki_ensemble_phase, dev, card,
                                     detail['ensemble']['canonical'])
    detail['live'] = timed(13, live_phase, card)
    detail['distributed'] = timed(14, distributed_phase, dev, card,
                                  detail['default_run']['E'], True)
    detail['pencil'] = timed(15, pencil_phase, dev, card, {
        'E_split_n512': detail['routes']['default_run']['split']['E'],
        'E_ozaki_n512': detail['ozaki']['default_run']['E'],
        'E_f64_4096': fm['E_f64_64_steps'],
        'E_split_f32_4096': KEPT['E_split_f32_4096'],
        'U0_mean_4096': fm['f32_mean_U_initial']})
    # phase 14 (c) and (e), run and checked in phase 15's world
    detail['distributed']['grid'] = detail['pencil'].pop('grid_ens')
    detail['knobs'] = timed(16, knobs_phase, dev, card,
                            detail['default_run']['E'],
                            fm['E_f64_64_steps'], detail)
    print('phase seconds: ' + ', '.join(
        f"{k} {v:.1f}" for k, v in detail['phase_seconds'].items()),
        flush=True)
    detail['part_seconds'] = dict(PART_SECONDS)
    print('design turns and small-field checks, seconds: ' + ', '.join(
        f"{k} {v:.1f}" for k, v in PART_SECONDS.items()), flush=True)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
            json.dump(detail, f, indent=1)

    print(card)
    print(json.dumps({'kernels': summary_rows(detail)}))
    # every phase ran on the one card the script selected
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': 1}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
