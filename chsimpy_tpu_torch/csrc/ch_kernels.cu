// Hand-written Hopper kernels of the Cahn-Hilliard step (sm_90a).
//
// K1-K4 carry the step's elementwise and reduction work; the solver's DCT
// products stay torch.matmul / torch.fft (or, on the float64 ozaki route,
// torch._int_mm int8 products), as the JAX package leaves them to XLA.
// K1-K4 are templated on the field type and instantiated for float and
// double: Hopper has native FP64, so the float64 validation mode runs the
// same kernels as the float32 fast mode.  K5 slices a float64 field into
// int8 planes for the ozaki route and exists for double only (K5_members:
// the same two kernels over R members' fields; where the fields fit in
// L2, one cooperative launch instead).  K6, the
// float32 GEMM of the DCT bake-off's 'gemm' route (ROADMAP.md kernel B5),
// lives in gemm_sm90.cu (tensor cores, 3xTF32).  On a grid mesh (one rank
// per block of the field) K7 is K3's stats_kernel on a block with halo
// vectors from the neighbour ranks (kernel B7): one body, the halo a
// compile-time flag.  K8 (B8) is K1's mu_kernel launched on the block: it
// has no source of its own.  K9 and K10 add the step's jitter on the card
// (the Sobol points, the device jitter's threefry stream), and K11 takes
// each ensemble member's Ra: none has a Pallas counterpart.  K12 is K2 with
// the coefficient grids rebuilt in registers from the 1-D eigenvalue axis
// (the JAX step's --otf-coeffs, which XLA fuses into the update there).
// K3 also has a fold mode: the field stored in the level-1 folded layout of
// the split route's --fold-field, read through the fold map.
//
// Plain C interface (extern "C" at the end), loaded with ctypes by
// chsimpy_tpu_torch/ops/kernels.py.  Every entry launches on the stream it
// is given, allocates nothing (the Python wrapper passes outputs and
// scratch), and returns cudaGetLastError().
//
// Member-batched launches (the ensemble, chsimpy_tpu/ensemble.py, whose
// vmap batches B1-B4 and, on the ozaki route, B6 over a leading member
// axis; with grid-sharded member fields B7 too): K1-K5 and K7 take a
// member count R and run member r on field (or block) r of a
// contiguous (R, ...) stack, with its own A0/A1 (K1, K3: float64 device
// arrays, cast to the field type on the card as the host casts the single
// launch's scalars), its own mean (K4), its own sums (K3: (R, 5); K4: (R,))
// and its own scale (K5: (R,) scales and inverses, planes (S, R, ...)).
// Member r of one batched launch does the arithmetic, in the order and on
// the grid, of a single launch on field r: the member index only offsets
// the pointers (blockIdx.y for K1, K2, K4 and K5, blockIdx.z for K3 and
// K7, whose member also offsets its halo vectors).
// R = 1 with no member arrays is the single launch.
//
// Built with -fmad=false (ops/cuda_build.py): every operation is rounded on
// its own, in the order of the plain PyTorch version, so K1 and K2 give the
// same bits as their plain versions on the card and the sums differ only in
// summation order.
//
// K1-K4 are bound by device-memory bandwidth: a few flops per element
// against 4-8 bytes read per operand.  Byte counts below are per call at
// N=4096 in float32 (double them for float64).  The designs keep to one
// pass over each operand; no shifted copies of the field are made.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;           // every kernel runs 256-thread blocks
constexpr int kWarps = kThreads / 32;
constexpr int kNStats = 5;              // sums of the statistics pass

__device__ __forceinline__ float flog(float x) { return logf(x); }
__device__ __forceinline__ double flog(double x) { return log(x); }
__device__ __forceinline__ float fabsT(float x) { return fabsf(x); }
__device__ __forceinline__ double fabsT(double x) { return fabs(x); }

// Sum of v over the block, in a fixed order (warp shuffles, then the warps
// in index order): the result does not depend on scheduling, so a run is
// reproducible to the bit.  The total lands in thread 0.  Ends with a
// barrier, so the shared buffer can be reused by the next call.
template <int NV>
__device__ __forceinline__ void block_sum(double (&v)[NV]) {
  __shared__ double sh[kWarps][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) sh[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += sh[w][k];
      v[k] = s;
    }
  }
  __syncthreads();
}

// K1 — chemical potential.  Replaces chemical_potential / _mu_kernel
// (chsimpy_tpu/ops/pallas_kernels.py:70-101).
// EnergieEut = RT*log(U/(1-U)) - BRT + (A0 + A1*(1-2U))*(1-2U)
//              - 2*A1*U*(1-U), in the field type, one log of the ratio as
// in the TPU kernel.  Reads U and writes the result: 134 MB per call at
// N=4096 f32.  One element per thread; any N.
// Member r (blockIdx.y) takes A0s[r], A1s[r] where those are given.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mu_kernel(const T* __restrict__ U, T* __restrict__ out, long long n,
          T RT, T BRT, T A0_in, T A1_in, const double* __restrict__ A0s,
          const double* __restrict__ A1s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long m = (long long)blockIdx.y * n;
  const T A0 = A0s != nullptr ? T(A0s[blockIdx.y]) : A0_in;
  const T A1 = A1s != nullptr ? T(A1s[blockIdx.y]) : A1_in;
  const T u = U[m + i];
  const T uinv = T(1) - u;
  const T u2inv = uinv - u;
  out[m + i] = RT * flog(u / uinv) - BRT + (A0 + A1 * u2inv) * u2inv
               - T(2) * A1 * u * uinv;
}

// K2 — semi-implicit spectral update (eq. 12 of Ghiass et al. 2016).
// Replaces spectral_update / _update_kernel (pallas_kernels.py:108-126).
// out = (hat_U + Seig*hat_E) / CHeig.  Reads four fields and writes one:
// 336 MB per call at N=4096 f32.  Member r (blockIdx.y) reads Seig and
// CHeig at r * seig_stride and r * cheig_stride: n for a grid per member,
// 0 for one grid shared by all members (the ensemble's Seig at a fixed
// delt).
template <typename T>
__global__ void __launch_bounds__(kThreads)
update_kernel(const T* __restrict__ hat_U, const T* __restrict__ hat_E,
              const T* __restrict__ Seig, const T* __restrict__ CHeig,
              T* __restrict__ out, long long n, long long seig_stride,
              long long cheig_stride) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long m = (long long)blockIdx.y * n;
  out[m + i] = (hat_U[m + i] + Seig[blockIdx.y * seig_stride + i]
                * hat_E[m + i]) / CHeig[blockIdx.y * cheig_stride + i];
}

// K12 — K2 with the coefficients formed in registers.  Replaces the JAX
// step's otf_coeffs update (coeffs.get_coefficients_axis feeding
// (hat_U + Seig*hat_E)/CHeig, chsimpy_tpu/core/stepper.py:568-593, which
// XLA fuses into one elementwise pass): leig = e[i] + e[j] from the (N,)
// eigenvalue axis (already in the route's spectral order), and, in the
// order of chsimpy_tpu/ops/coeffs.py:47-66 with every operation rounded on
// its own (-fmad=false),
//   lam1 = delt / delx2,  lam2 = kappa * lam1 / delx2  (true divisions),
//   CHeig = 1 + lam2 * (leig * leig),  Seig = lam1 * leig.
// delt and kappa are cast to the field type first, as the JAX step casts
// them; delt is read from the card (the adaptive step's delt never
// crosses to the host).  Reads hat_U and hat_E and writes one field where
// K2 reads four: 201 MB per call at N=4096 f32 against K2's 336 MB.  A
// block of R members' (rows, cols) blocks at (row_off, col_off) of the
// spectral image (a rank's grid or pencil block); member r = blockIdx.z
// takes delt[r] (delt_per_member) and kappas[r] where those are given.
template <typename T>
__global__ void __launch_bounds__(kThreads)
update_otf_kernel(const T* __restrict__ hat_U, const T* __restrict__ hat_E,
                  const T* __restrict__ eaxis, T* __restrict__ out, int rows,
                  int cols, int row_off, int col_off,
                  const double* __restrict__ delt, int delt_per_member,
                  const double* __restrict__ kappas, T kappa_in, T delx2) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const long long i = ((long long)blockIdx.z * rows + blockIdx.y) * cols + c;
  const T lam1 = T(delt[delt_per_member ? blockIdx.z : 0]) / delx2;
  const T kappa = kappas != nullptr ? T(kappas[blockIdx.z]) : kappa_in;
  const T lam2 = kappa * lam1 / delx2;
  const T leig = eaxis[row_off + (int)blockIdx.y] + eaxis[col_off + c];
  const T cheig = T(1) + lam2 * (leig * leig);
  const T seig = lam1 * leig;
  out[i] = (hat_U[i] + seig * hat_E[i]) / cheig;
}

// K3 and K7 — fused field statistics in one launch.  K3 replaces
// stats_band_sums / _stats_band_kernel (pallas_kernels.py:205-258,
// 288-321) on the whole field; K7 replaces _local_band_sums /
// _stats_band_kernel_sh (pallas_kernels.py:382-461), which
// fused_stats_sharded (:489-535) runs on each rank's block of a
// grid-sharded field.  Both are stats_kernel: K3 with HALO false (the
// field is the block, the compiler sees the offsets as 0), K7 with HALO
// true.
// Five sums: the Flory-Huggins integrand, |grad U|^2 with the np.gradient
// edge_order=1 stencil, sum U, #(U < threshold), and sum EnergieEut^2
// (zero when E is null: the prepare path).  Terms are formed in the field
// type, with the plain version's true quotients, and accumulated in
// double, as the float32 stop predicate needs.
//
// K7's block U is (bn, W) with row stride W, its rows starting at global
// row row_off and its columns at col_off of the (N, N) field.  Where the
// stencil crosses the block's edge it reads the halo vectors the caller
// received from the neighbour ranks: up_row / dn_row (W each: the last row
// of the block above, the first row of the block below) as rows -1 and bn
// of the sweep, and lf_col / rt_col (bn each) as the values beyond the
// block's first and last column.  The one-sided differences test the
// GLOBAL row and column, so the sums of all blocks are the whole field's.
// The TPU caller concatenates four shifted copies of the block for its
// banded operands; here the halo is read in place.
//
// Its byte bound: U and E read once, 134 MB per call at N=4096 f32 (33.6
// MB on a 2048 x 2048 block).  Per element it also takes two logs, two
// divisions by the constants h and 2h and four float64 conversions and
// adds, which on the H100 cost about as much time as the bytes (K1, one
// log and one division per element over the same bytes, runs nearer its
// bound); in float64 the two logs' FP64 instructions alone take longer
// than the bytes.  The body (below the parent body it replaced, which is
// kept as stats_kernel's PREV instantiation) divides by a product with the
// reciprocal, corrected (cdiv, the true quotient's bits), and keeps the
// field's edges out of the interior's arithmetic.  A row sweep keeps the
// bytes to one pass:
// * each thread owns V contiguous columns (a float4 in float32, a double2
//   in float64; V=1 where W or an address does not allow the vector) and
//   walks down a band of `band` rows with the rows above, at and below in
//   registers, so a U element is loaded once, plus three halo rows per
//   band; every load is issued one row before the row that uses it (at
//   N=4096 a deeper prefetch, more rows a band, fewer registers for more
//   blocks an SM or float2 in float32 were slower on the H100);
// * the column neighbours come from the adjacent lanes (shuffles); lanes 0
//   and 31 load the one value beyond the warp's columns (lane 0 at the
//   block's left edge: lf_col), and under HALO the thread that holds column
//   W-1 reads rt_col;
// * the one-sided edges (global rows 0 and N-1, columns 0 and N-1) are
//   decided per row and per thread, not per element (in the body the
//   field's first and last rows run outside the interior loop, and the
//   first and last columns take themselves as the neighbour beyond);
// * one launch: every block writes its five float64 sums to partials, and
//   the last block to finish (an atomic ticket after __threadfence) adds
//   all partials in a fixed order and resets the ticket to 0 for the next
//   call.  The grid depends on (bn, W) and V alone, never on the card or
//   the offsets: every run gives the same bits, and K7 on the whole field
//   gives K3's.
// The tile (V, band) is the wrapper's (ops/kernels.py stats_tile), from
// the block's shape, the element size and the vector width alone.  Its
// fixed tile, 256 V columns by 64 / V rows, was sized at N=4096 (1024
// blocks in either type) and stays wherever it gives at least 256 blocks.
// On smaller blocks it left most SMs idle (16 blocks on a 512-wide float64
// field, a float4 block twice as wide as a 512-wide float32 field), so
// there the vector narrows (a float2 in float32, one column) until a
// block is no wider than needed, and the band shortens until the grid
// reaches 256 blocks (down to 4 rows): a member of a batched launch keeps
// the single field's grid, and a small field fills the card.
//
// K3's fold mode (FOLD, never with HALO) takes the field in the level-1
// folded layout of --fold-field (chsimpy_tpu/ops/dct.py fold1): natural
// row r stored at row r for r < N/2, else at 3N/2-1-r, and the same for
// columns.  The sweep walks the NATURAL rows and columns: a row is still
// one stored row, and a thread's V columns in the right half are V stored
// columns in reverse order (one vector load, its lanes reversed; the
// vector needs N/2 % V == 0).  The edges and the seams of the stored
// layout (rows and columns 0, N/2-1, N/2, N-1) are then ordinary natural
// neighbours, and every term and every partial sum is K3's on the natural
// field: where the fold keeps K3's vector width (N/2 % V == 0, every N
// that is a multiple of 16) the sums are the natural field's to the bit;
// otherwise the one-column grid's, within K3's tolerances.  What the fold
// map costs is decided once, not per row: a thread's side of the column
// fold (its stored columns and the warp's edge column) before the sweep;
// for a band whose rows and look-ahead rows lie on one side of N/2, its
// first stored row and the signed step to the next (the band at the seam
// maps each row); and a reversed thread's lanes are swapped where a row
// enters the sweep, not where it is loaded, so that the loads stay a row
// ahead as in the natural sweep.  The JAX package refuses --fold-field
// with its Pallas kernels (chsimpy_tpu/core/solver.py:78-83, 445-448; its
// XLA path regroups the sums instead); here this mode is what lets the
// hand kernels run the folded layout.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2 && sizeof(T) == 8) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

// K3's terms of row GR of the field (the natural row in the fold mode) at
// a thread's V columns, added to its sums (acc, count): U's rows GR-1, GR,
// GR+1 (up, cur, dn), E's row GR (e, read where has_e), the values left
// and right of the thread's columns; one-sided differences at the field's
// edges.  The natural sweep and the fold's both expand it, so their terms,
// and the fold's sums where it keeps K3's grid, are one code's.  A macro:
// as a __forceinline__ function or a lambda the same terms changed the
// natural instantiations' compiled loops (benchmarks/stats_sass.py, sm_90a:
// float64 V=2 312.3 static instructions an element and 70 registers became
// 314.3 / 72 and 316.8 / 64, float64 V=1 320.7 became 335.7 and 330.0,
// float32 V=2 172.5 became 179.2 and 178.8); expanded, every
// instantiation compiles to the loop it had with the terms written out.
#define STATS_ROW_TERMS(GR)                                                   \
  if (active) {                                                               \
    _Pragma("unroll")                                                         \
    for (int j = 0; j < V; ++j) {                                             \
      const T u = cur[j];                                                     \
      T dux;                                                                  \
      if ((GR) == 0) dux = (dn[j] - u) / h;                                   \
      else if ((GR) == N - 1) dux = (u - up[j]) / h;                          \
      else dux = (dn[j] - up[j]) / h2;                                        \
      const T l = j == 0 ? left : cur[j > 0 ? j - 1 : 0];                     \
      const T rv = j == V - 1 ? right : cur[j < V - 1 ? j + 1 : 0];           \
      T duy;                                                                  \
      if (j == 0 && first_col) duy = (rv - u) / h;                            \
      else if (j == V - 1 && last_col) duy = (u - l) / h;                     \
      else duy = (rv - l) / h2;                                               \
      const T uinv = T(1) - u;                                                \
      const T integrand = RT * (u * (flog(u) - B) + uinv * flog(uinv))        \
                          + (A0 + A1 * (uinv - u)) * u * uinv;                \
      acc[0] += (double)integrand;                                            \
      acc[1] += (double)(dux * dux + duy * duy);                              \
      acc[2] += (double)u;                                                    \
      count += u < threshold;                                                 \
      if (has_e) acc[4] += (double)(e[j] * e[j]);                             \
    }                                                                         \
  }

// The new body's divisions by the constants h and h2 = 2h (the parent
// body above divides): c the divisor, y = 1/c rounded to nearest in
// double, formed once a thread.  Each returns the true quotient's bits:
// * float: RN((double)x * y) rounded to float.  The product is x/c (1 + e)
//   with |e| <= 2^-52 (to first order: y's rounding and the product's).
//   No float quotient x/c lies on a midpoint of two floats (x = m c with m
//   of 25 significant bits, its last one set, needs more bits than x
//   has; a subnormal midpoint k 2^-150, k odd, needs c >= 2), and none
//   lies nearer one than 2^-49 |x/c| (2^-174 below 2^-126): farther than
//   the product's error, so the product rounds to the float x/c rounds
//   to, overflow included.  Two conversions and a DMUL against the true
//   division's reciprocal iterations, range check and slow path.
// * double: q0 = RN(x y) is x/c within 2 ulps; q1 = RN(q0 + r0 y), r0 =
//   RN(x - q0 c) (one fma each), is x/c (1 + e) with |e| ~ 2^-104, so
//   within one ulp; r1 = x - q1 c is then exact (the remainder of a
//   quotient within one ulp, barring underflow), and by Markstein's
//   theorem (IBM J. Res. Develop. 34 (1990), 111-119: y within half an
//   ulp of 1/c, q1 within one ulp of x/c) q2 = RN(q1 + r1 y) is RN(x / c).
//   Nothing over- or underflows for 2^-900 <= |x| < 2^901 and h in
//   [2^-29, 2^29]; outside that range of |x| (x = 0 included) the true
//   division runs.  A DMUL and four DFMA against the true division's
//   MUFU.RCP64H, its iterations and range check.
// Where h is outside these ranges (cdiv_range: h >= 2 in float) the body
// passes y = 0, and cdiv takes the true division: a branch the same way
// in every thread.  ch_cdiv_check holds both forms to the true division
// on the card (float: every finite x; double: random and edge inputs).
constexpr unsigned int kCdivLoHi = (1023u - 900u) << 20;  // |x| = 2^-900
constexpr unsigned int kCdivHiHi = (1023u + 901u) << 20;  // |x| = 2^901

template <typename T>
__device__ __forceinline__ bool cdiv_range(T h) {
  if constexpr (sizeof(T) == 4) return h > 0.0f && h < 2.0f;
  else return h >= 0x1p-29 && h <= 0x1p29;
}

__device__ __forceinline__ float cdiv(float x, float c, double y) {
  return y != 0.0 ? (float)((double)x * y) : x / c;
}
__device__ __forceinline__ double cdiv(double x, double c, double y) {
  const unsigned int hx = (unsigned int)__double2hiint(x) & 0x7fffffffu;
  if (y == 0.0 || hx - kCdivLoHi >= kCdivHiHi - kCdivLoHi) return x / c;
  const double q0 = x * y;
  const double q1 = __fma_rn(__fma_rn(-q0, c, x), y, q0);
  return __fma_rn(__fma_rn(-q1, c, x), y, q1);
}

// The new body's terms of one row, STATS_ROW_TERMS' arithmetic operation
// for operation: the row difference (XA) - (XB) over CX (YX its
// reciprocal), chosen per row by the caller (the interior's (dn - up) /
// h2 has no select); the column differences over h2, but the thread's
// first element over cf and its last over cl (h at the field's first and
// last column), whose neighbours left / right the step sets to the
// element itself there; every division by cdiv.
#define STATS_TERMS(XA, XB, CX, YX)                                           \
  if (active) {                                                               \
    _Pragma("unroll")                                                         \
    for (int j = 0; j < V; ++j) {                                             \
      const T u = cur[j];                                                     \
      const T dux = cdiv((XA) - (XB), CX, YX);                                \
      const T l = j == 0 ? left : cur[j > 0 ? j - 1 : 0];                     \
      const T rv = j == V - 1 ? right : cur[j < V - 1 ? j + 1 : 0];           \
      const T duy = j == 0 ? cdiv(rv - l, cf, yf)                             \
                    : j == V - 1 ? cdiv(rv - l, cl, yl)                       \
                    : cdiv(rv - l, h2, yh2);                                  \
      const T uinv = T(1) - u;                                                \
      const T integrand = RT * (u * (flog(u) - B) + uinv * flog(uinv))        \
                          + (A0 + A1 * (uinv - u)) * u * uinv;                \
      acc[0] += (double)integrand;                                            \
      acc[1] += (double)(dux * dux + duy * duy);                              \
      acc[2] += (double)u;                                                    \
      count += u < threshold;                                                 \
      if (has_e) acc[4] += (double)(e[j] * e[j]);                             \
    }                                                                         \
  }

// One row of the new body's sweeps: NEXT loads U's row r+2 and E's row
// r+1 into un / en and row r+1's edge and tail values into edge_n / rt_n;
// the row's terms; the rows move up one.
#define STATS_ROW_STEP(NEXT, XA, XB, CX, YX)                                  \
  {                                                                           \
    T un[V], en[V], edge_n, rt_n;                                             \
    NEXT;                                                                     \
    T left = __shfl_up_sync(0xffffffffu, cur[V - 1], 1);                      \
    T right = __shfl_down_sync(0xffffffffu, cur[0], 1);                       \
    if (lane == 0) left = first_col ? cur[0] : edge;                          \
    if (lane == 31) right = edge;                                             \
    if (tail) right = rt;                                                     \
    if (last_col) right = cur[V - 1];                                         \
    STATS_TERMS(XA, XB, CX, YX)                                               \
    _Pragma("unroll")                                                         \
    for (int j = 0; j < V; ++j) {                                             \
      up[j] = cur[j];                                                         \
      cur[j] = dn[j];                                                         \
      dn[j] = un[j];                                                          \
      e[j] = en[j];                                                           \
    }                                                                         \
    edge = edge_n;                                                            \
    rt = rt_n;                                                                \
  }

// The statistics kernel: PREV the parent body, else the new one.  The
// body is written in the kernel (behind a __forceinline__ function the
// parent body compiled to other loops and registers).  Only the new
// float64 body asks for 3 blocks an SM (at most 85 registers a thread,
// against the 108-110 it took uncapped: two blocks an SM); the parent
// body and the float32 body keep the compiler's choice (0: no minimum).
template <typename T, int V, bool HALO, bool FOLD, bool PREV>
__global__ void __launch_bounds__(kThreads,
                                  !PREV && sizeof(T) == 8 ? 3 : 0)
stats_kernel(const T* __restrict__ U, const T* __restrict__ E,
             const T* __restrict__ up_row, const T* __restrict__ dn_row,
             const T* __restrict__ lf_col, const T* __restrict__ rt_col,
             int block_rows, int block_cols, int N, int block_row_off,
             int block_col_off, int band, double delx, T RT, T B, T A0_in,
             T A1_in,
             const double* __restrict__ A0s, const double* __restrict__ A1s,
             T threshold, double* __restrict__ partials,
             unsigned int* __restrict__ ticket, double* __restrict__ sums) {
  // member r = blockIdx.z: its field (K3) or block (K7_members) and, under
  // HALO, its halo vectors; its A0/A1, partials, ticket and sums.  The
  // grid of (x, y) blocks is each member's
  {
    const long long moff = (long long)blockIdx.z * block_rows * block_cols;
    U += moff;
    if (E != nullptr) E += moff;
    if (HALO) {
      up_row += (long long)blockIdx.z * block_cols;
      dn_row += (long long)blockIdx.z * block_cols;
      lf_col += (long long)blockIdx.z * block_rows;
      rt_col += (long long)blockIdx.z * block_rows;
    }
    partials += (long long)blockIdx.z * gridDim.x * gridDim.y * kNStats;
    ticket += blockIdx.z;
    sums += (long long)blockIdx.z * kNStats;
  }
  const T A0 = A0s != nullptr ? T(A0s[blockIdx.z]) : A0_in;
  const T A1 = A1s != nullptr ? T(A1s[blockIdx.z]) : A1_in;
  const int bn = HALO ? block_rows : N;
  const int W = HALO ? block_cols : N;
  const int row_off = HALO ? block_row_off : 0;
  const int col_off = HALO ? block_col_off : 0;
  const T h = T(delx);
  const T h2 = T(2.0 * delx);
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int wc0 = (blockIdx.x * kThreads + (threadIdx.x & ~31)) * V;
  const int wc1 = wc0 + 32 * V;          // one past the warp's columns
  const bool active = c0 < W;            // W % V == 0: all V columns exist
  const bool first_col = c0 + col_off == 0;
  const bool last_col = c0 + col_off + V - 1 == N - 1;
  const int r0 = blockIdx.y * band;
  const int r1 = min(r0 + band, bn);
  const bool has_e = E != nullptr;
  // the one value beyond the warp's columns that a row needs: lane 0 the
  // left one, lane 31 the right one; under HALO, the value right of column
  // W-1 (rt_col) goes to the thread that holds it, whichever lane that is
  const bool edge_lane = (lane == 0 && active && (HALO || wc0 > 0)) ||
                         (lane == 31 && wc1 < W);
  const bool left_halo = HALO && lane == 0 && wc0 == 0;
  const T* edge_base = left_halo ? lf_col : U + (lane == 0 ? wc0 - 1 : wc1);
  const long long edge_stride = left_halo ? 1 : W;
  const bool tail = HALO && active && c0 + V == W;
  // FOLD: the stored row of natural row r, where this thread's V columns
  // start in the stored row (reversed in the right half), and the stored
  // column of the warp's edge value
  const int half = N / 2;
  auto frow = [&](int r) { return FOLD && r >= half ? 3 * half - 1 - r : r; };
  const bool rev = FOLD && c0 >= half;
  const int sc0 = rev ? 3 * half - c0 - V : c0;
  if (FOLD) {
    const int col = lane == 0 ? wc0 - 1 : wc1;
    edge_base = U + (col >= half ? 3 * half - 1 - col : col);
  }
  // rows -1 and bn of the sweep are the halo rows; K3 clamps to the field
  // (the one-sided differences at its edges never read the clamped row)
  const int last_row = HALO ? bn : N - 1;
  auto below = [&](int r) { return r < last_row ? r + 1 : last_row; };
  // the next row of E and of the edge values stays in the block
  auto below_in = [&](int r) { return r < bn - 1 ? r + 1 : bn - 1; };
  auto load_row = [&](const T* F, int r, T (&v)[V]) {
    const T* row = HALO && r < 0 ? up_row
                   : HALO && r == bn ? dn_row : F + (long long)frow(r) * W;
    if (active) {
      load_vec<T, V>(row + sc0, v);
      if (rev) {
#pragma unroll
        for (int j = 0; j < V / 2; ++j) {
          const T t = v[j];
          v[j] = v[V - 1 - j];
          v[V - 1 - j] = t;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = T(0);
    }
  };
  auto load_edge = [&](int r) {
    return edge_lane ? edge_base[(long long)frow(r) * edge_stride] : T(0);
  };
  auto load_tail = [&](int r) { return tail ? rt_col[r] : T(0); };
  double acc[kNStats] = {0.0, 0.0, 0.0, 0.0, 0.0};
  int count = 0;
  // rows r-1, r, r+1 of U, row r of E and row r's edge values; the loop
  // loads row r+2 of U and row r+1 of the others before it computes row r
  T up[V], cur[V], dn[V], e[V];
  load_row(U, HALO ? r0 - 1 : (r0 > 0 ? r0 - 1 : 0), up);
  load_row(U, r0, cur);
  load_row(U, below(r0), dn);
  if (has_e) load_row(E, r0, e);
  T edge = load_edge(r0);
  T rt = HALO ? load_tail(r0) : T(0);
  if constexpr (PREV && !FOLD) {
    for (int r = r0; r < r1; ++r) {
      T un[V], en[V];
      load_row(U, below(below(r)), un);
      if (has_e) load_row(E, below_in(r), en);
      const T edge_n = load_edge(below_in(r));
      const T rt_n = HALO ? load_tail(below_in(r)) : T(0);
      T left = __shfl_up_sync(0xffffffffu, cur[V - 1], 1);
      T right = __shfl_down_sync(0xffffffffu, cur[0], 1);
      if (lane == 0) left = edge;
      if (lane == 31) right = edge;
      if (tail) right = rt;
      const int gr = r + row_off;
      STATS_ROW_TERMS(gr)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        up[j] = cur[j];
        cur[j] = dn[j];
        dn[j] = un[j];
        e[j] = en[j];
      }
      edge = edge_n;
      rt = rt_n;
    }
  } else if constexpr (PREV) {
    // K3's fold mode.  The loops load a row as stored (load_raw: a
    // reversed thread's V values in reverse column order) and put it in
    // natural order only where it enters the sweep (natural(), as dn and
    // e move up): a swap at the load made the loop wait for each load at
    // once and lose the row of look-ahead (0.1175 against the natural
    // sweep's 0.0907 ms at N=4096 float32 on the H100).
    auto natural = [&](T (&v)[V]) {
      if (rev) {
#pragma unroll
        for (int j = 0; j < V / 2; ++j) {
          const T t = v[j];
          v[j] = v[V - 1 - j];
          v[V - 1 - j] = t;
        }
      }
    };
    auto load_raw = [&](const T* row, T (&v)[V]) {
      if (active) {
        load_vec<T, V>(row + sc0, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = T(0);
      }
    };
    // row r's terms, then the rows move up one: un (U row r+2) and en (E
    // row r+1), as loaded, become dn and e
    auto sweep_row = [&](int r, T (&un)[V], T (&en)[V], T edge_n) {
      T left = __shfl_up_sync(0xffffffffu, cur[V - 1], 1);
      T right = __shfl_down_sync(0xffffffffu, cur[0], 1);
      if (lane == 0) left = edge;
      if (lane == 31) right = edge;
      STATS_ROW_TERMS(r)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        up[j] = cur[j];
        cur[j] = dn[j];
        dn[j] = un[j];
        e[j] = en[j];
      }
      natural(dn);
      natural(e);
      edge = edge_n;
    };
    if (r0 >= half || r1 < half) {
      // a band on one side of the seam with every row it loads (at N=4096
      // every band of the fixed tile but the one that ends at N/2): its
      // stored rows follow one another by one signed step, decided here
      // once (down the stored rows in the upper half); o is the stored
      // offset of row r+1 (E, the edge values), U's row r+2 one step on.
      // The rows it loads past the band (U's r1 and r1+1, E's r1) lie in
      // the field (stored rows down to N/2-2) and no row it sums reads
      // them.
      const long long step = r0 >= half ? -(long long)W : (long long)W;
      long long o = (long long)frow(r0 + 1) * W;
      for (int r = r0; r < r1; ++r) {
        T un[V], en[V];
        load_raw(U + o + step, un);
        if (has_e) load_raw(E + o, en);
        const T edge_n = edge_lane ? edge_base[o] : T(0);
        o += step;
        sweep_row(r, un, en, edge_n);
      }
    } else {
      // the band at the seam: each row through the fold map
      for (int r = r0; r < r1; ++r) {
        T un[V], en[V];
        load_raw(U + (long long)frow(below(below(r))) * W, un);
        if (has_e) load_raw(E + (long long)frow(below_in(r)) * W, en);
        sweep_row(r, un, en, load_edge(below_in(r)));
      }
    }
  } else {
    // The new body: the parent's sweeps and terms with the edges taken
    // out of the interior's arithmetic and the divisions by cdiv.  The
    // field's first and last rows run on their own (their one-sided row
    // differences chosen for the row); the first and last columns' column
    // differences take the element itself as the neighbour (left / right)
    // and h as the divisor, both decided once a thread.  The natural
    // sweep's interior rows whose loads all lie in the block (U's r+2, E's
    // and the edge values' r+1) step their pointers by one row.  The
    // reciprocals are 0 where h is outside cdiv's range (its true
    // division).
    const bool fast = cdiv_range(h);
    const double yh = fast ? 1.0 / (double)h : 0.0;
    const double yh2 = fast ? 1.0 / (double)h2 : 0.0;
    const bool h_first = first_col || (V == 1 && last_col);
    const bool h_last = last_col || (V == 1 && first_col);
    const T cf = h_first ? h : h2, cl = h_last ? h : h2;
    const double yf = h_first ? yh : yh2, yl = h_last ? yh : yh2;
    if constexpr (!FOLD) {
      auto next_any = [&](int r, T (&un)[V], T (&en)[V], T& edge_n,
                          T& rt_n) {
        load_row(U, below(below(r)), un);
        if (has_e) load_row(E, below_in(r), en);
        edge_n = load_edge(below_in(r));
        rt_n = HALO ? load_tail(below_in(r)) : T(0);
      };
      int r = r0;
      if (r0 + row_off == 0) {            // the field's first row
        STATS_ROW_STEP(next_any(r, un, en, edge_n, rt_n), dn[j], u, h, yh)
        ++r;
      }
      const int rf = max(r, min(r1, bn - 2));
      if (r < rf) {
        const T* pu = U + c0 + (long long)(r + 2) * W;
        const T* pe = (has_e ? E : U) + c0 + (long long)(r + 1) * W;
        const T* pedge = edge_base + (long long)(r + 1) * edge_stride;
        const T* prt = (HALO ? rt_col : U) + r + 1;
        auto next_in = [&](T (&un)[V], T (&en)[V], T& edge_n, T& rt_n) {
          if (active) {
            load_vec<T, V>(pu, un);
            if (has_e) load_vec<T, V>(pe, en);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) un[j] = en[j] = T(0);
          }
          edge_n = edge_lane ? *pedge : T(0);
          rt_n = tail ? *prt : T(0);
          pu += W;
          pe += W;
          pedge += edge_stride;
          ++prt;
        };
        for (; r < rf; ++r)
          STATS_ROW_STEP(next_in(un, en, edge_n, rt_n), dn[j], up[j], h2,
                         yh2)
      }
      for (; r < r1; ++r) {               // the block's last rows
        const bool bot = r + row_off == N - 1;
        const T cx = bot ? h : h2;
        const double yx = bot ? yh : yh2;
        STATS_ROW_STEP(next_any(r, un, en, edge_n, rt_n), bot ? u : dn[j],
                       up[j], cx, yx)
      }
    } else {
      // the fold mode: the parent's two sweeps (stored rows loaded as
      // stored, a reversed thread's lanes swapped where the row enters),
      // the field's first and last natural rows on their own
      auto natural = [&](T (&v)[V]) {
        if (rev) {
#pragma unroll
          for (int j = 0; j < V / 2; ++j) {
            const T t = v[j];
            v[j] = v[V - 1 - j];
            v[V - 1 - j] = t;
          }
        }
      };
      auto load_raw = [&](const T* row, T (&v)[V]) {
        if (active) {
          load_vec<T, V>(row + sc0, v);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = T(0);
        }
      };
      if (r0 >= half || r1 < half) {
        const long long step = r0 >= half ? -(long long)W : (long long)W;
        long long o = (long long)frow(r0 + 1) * W;
        auto next_step = [&](T (&un)[V], T (&en)[V], T& edge_n, T& rt_n) {
          load_raw(U + o + step, un);
          if (has_e) load_raw(E + o, en);
          edge_n = edge_lane ? edge_base[o] : T(0);
          rt_n = T(0);
          o += step;
        };
        int r = r0;
        if (r0 == 0) {                    // the field's first row
          STATS_ROW_STEP(next_step(un, en, edge_n, rt_n), dn[j], u, h, yh)
          natural(dn);
          natural(e);
          ++r;
        }
        for (const int re = r1 == N ? N - 1 : r1; r < re; ++r) {
          STATS_ROW_STEP(next_step(un, en, edge_n, rt_n), dn[j], up[j], h2,
                         yh2)
          natural(dn);
          natural(e);
        }
        if (r < r1) {                     // the field's last row
          STATS_ROW_STEP(next_step(un, en, edge_n, rt_n), u, up[j], h, yh)
        }
      } else {
        // the band at the seam: each row through the fold map
        for (int r = r0; r < r1; ++r) {
          const bool top = r == 0, bot = r == N - 1;
          const T cx = top || bot ? h : h2;
          const double yx = top || bot ? yh : yh2;
          STATS_ROW_STEP(
              (load_raw(U + (long long)frow(below(below(r))) * W, un),
               has_e ? load_raw(E + (long long)frow(below_in(r)) * W, en)
                     : (void)0,
               edge_n = load_edge(below_in(r)), rt_n = T(0)),
              bot ? u : dn[j], top ? u : up[j], cx, yx)
          natural(dn);
          natural(e);
        }
      }
    }
  }
  acc[3] = (double)count;
  block_sum<kNStats>(acc);
  const unsigned int nblocks = gridDim.x * gridDim.y;
  const unsigned int b = blockIdx.y * gridDim.x + blockIdx.x;
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kNStats; ++k)
      partials[(long long)b * kNStats + k] = acc[k];
    __threadfence();                     // the partials before the ticket
    last = atomicAdd(ticket, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double tot[kNStats] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (unsigned int i = threadIdx.x; i < nblocks; i += kThreads) {
#pragma unroll
    for (int k = 0; k < kNStats; ++k)
      tot[k] += __ldcg(partials + (long long)i * kNStats + k);
  }
  block_sum<kNStats>(tot);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kNStats; ++k) sums[k] = tot[k];
    *ticket = 0u;
  }
}
#undef STATS_ROW_TERMS
#undef STATS_TERMS
#undef STATS_ROW_STEP

// cdiv against the true division, for c = h and c = 2h (h = T(delx), as
// in the statistics kernel): out[0], out[1] count the inputs where the bits
// differ, out[2] the inputs checked (for each c), out[3] the smallest
// pattern of |x| that differed (~0 if none).  float: every finite float x
// (the grid strides over the 2^32 bit patterns); double: n draws of a
// counter-based generator (splitmix64 from seed: any bit pattern, an
// exponent across cdiv's range and past both its ends, differences of two
// values in [0, 1), and values next to x = q c for a random q, so x / c
// lands near a double or a midpoint) and the caller's edge inputs.
__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

__device__ __forceinline__ unsigned long long bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned long long bits_of(double v) {
  return (unsigned long long)__double_as_longlong(v);
}

template <typename T>
__device__ __forceinline__ void cdiv_check_one(T x, T h, T h2, double yh,
                                               double yh2,
                                               unsigned long long* out) {
  const unsigned long long magnitude = sizeof(T) == 4 ? 0x7fffffffull
                                                      : ~0ull >> 1;
  const T a[2] = {cdiv(x, h, yh), cdiv(x, h2, yh2)};
  const T b[2] = {x / h, x / h2};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (bits_of(a[k]) != bits_of(b[k])) {
      atomicAdd(out + k, 1ull);
      atomicMin(out + 3, bits_of(x) & magnitude);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cdiv_check_f32_kernel(double delx, unsigned long long* __restrict__ out) {
  const float h = float(delx), h2 = float(2.0 * delx);
  const double yh = 1.0 / (double)h, yh2 = 1.0 / (double)h2;
  unsigned long long checked = 0;
  for (unsigned long long i = (unsigned long long)blockIdx.x * kThreads
                              + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * kThreads) {
    const float x = __uint_as_float((unsigned int)i);
    if (!isfinite(x)) continue;
    ++checked;
    cdiv_check_one<float>(x, h, h2, yh, yh2, out);
  }
  atomicAdd(out + 2, checked);
}

__global__ void __launch_bounds__(kThreads)
cdiv_check_f64_kernel(double delx, long long n, unsigned long long seed,
                      const double* __restrict__ edges, int n_edges,
                      unsigned long long* __restrict__ out) {
  const double h = delx, h2 = 2.0 * delx;
  const double yh = 1.0 / h, yh2 = 1.0 / h2;
  unsigned long long checked = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n + n_edges; i += (long long)gridDim.x * kThreads) {
    double x;
    if (i >= n) {
      x = edges[i - n];
    } else {
      const unsigned long long r1 = splitmix64(seed + 2 * i);
      const unsigned long long r2 = splitmix64(seed + 2 * i + 1);
      const unsigned long long sign = r2 & (1ull << 63);
      const unsigned long long mant = r1 & ((1ull << 52) - 1);
      switch ((r2 >> 60) & 3) {
        case 0:                      // any bit pattern
          x = __longlong_as_double((long long)r1);
          break;
        case 1: {                    // |x| from 2^-960 to 2^960
          const long long ex = (long long)(r2 % 1921) - 960 + 1023;
          x = __longlong_as_double(
              (long long)(sign | (unsigned long long)ex << 52 | mant));
          break;
        }
        case 2:                      // a difference of two values in [0, 1)
          x = (double)(r1 >> 11) * 0x1p-53 - (double)(r2 >> 11) * 0x1p-53;
          break;
        default: {                   // x / c near a double or a midpoint
          const long long eq = (long long)(r2 % 400) - 200 + 1023;
          const double q = __longlong_as_double(
              (long long)(sign | (unsigned long long)eq << 52 | mant));
          const double c = (r2 >> 40) & 1 ? h2 : h;
          const double half = (r2 >> 41) & 1 ? 0.5 : 0.0;
          const double ulp = __longlong_as_double((eq - 52) << 52);
          x = __fma_rn(half * ulp, c, q * c);
          x = __longlong_as_double(__double_as_longlong(x)
                                   + (long long)((r2 >> 42) & 7) - 3);
          break;
        }
      }
      if (!isfinite(x)) continue;
    }
    ++checked;
    cdiv_check_one<double>(x, h, h2, yh, yh2, out);
  }
  atomicAdd(out + 2, checked);
}

// K4 — sum |U - mean|, pass 1.  Replaces absdev_band_sums /
// _absdev_band_kernel (pallas_kernels.py:261-273, 348-369).
// The mean is read from device memory (written by the step's own
// finalization), so no host round trip per step.  Grid-stride over the
// flat field with a grid fixed by the caller: reads 67 MB per call at
// N=4096 f32.  Member r (blockIdx.y) sums field r with mean[r] into column
// r of the (blocks, R) partials, which pass 2 reduces column by column.
template <typename T>
__global__ void __launch_bounds__(kThreads)
absdev_partials_kernel(const T* __restrict__ U, long long n,
                       const T* __restrict__ mean,
                       double* __restrict__ partials) {
  U += (long long)blockIdx.y * n;
  const T m = mean[blockIdx.y];
  double acc[1] = {0.0};
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    acc[0] += (double)fabsT(U[i] - m);
  block_sum<1>(acc);
  if (threadIdx.x == 0)
    partials[(long long)blockIdx.x * gridDim.y + blockIdx.y] = acc[0];
}

// K11 — Ra of every member: the mean of |row - mean(row)| over one row of
// each member's field (the JAX step's Ra, jnp.mean twice on the row,
// chsimpy_tpu/core/stepper.py:473: no Pallas counterpart).  One block a
// member (blockIdx.x), its W values read twice: the row's sum in double
// (each thread its strided columns, then block_sum), the mean rounded to
// the field type, then |x - mean| in the field type summed in double, over
// W.  The order depends on W alone, so member r gives the same bits in a
// launch of any member count (a torch reduction over the rows of an
// (R, W) tensor splits a row across blocks by R: its bits depend on R).
// The row of member r starts at r * member_stride + row_offset.  The body
// (row_absdev, a block's Ra of one row, in thread 0) also runs in K4's
// second pass (reduce_columns_kernel), which takes each member's Ra beside
// its sum where the step asks for both: no launch of its own there.
template <typename T>
__device__ __forceinline__ double row_absdev(const T* __restrict__ row,
                                             int W) {
  double acc[1] = {0.0};
  for (int c = threadIdx.x; c < W; c += kThreads) acc[0] += (double)row[c];
  block_sum<1>(acc);
  __shared__ double total;
  if (threadIdx.x == 0) total = acc[0];
  __syncthreads();
  const T m = T(total / W);
  acc[0] = 0.0;
  for (int c = threadIdx.x; c < W; c += kThreads)
    acc[0] += (double)fabsT(row[c] - m);
  block_sum<1>(acc);
  return acc[0] / W;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_absdev_kernel(const T* __restrict__ U, long long member_stride,
                  long long row_offset, int W, double* __restrict__ out) {
  const double ra = row_absdev<T>(
      U + (long long)blockIdx.x * member_stride + row_offset, W);
  if (threadIdx.x == 0) out[blockIdx.x] = ra;
}

// K5 — float64 field -> int8 slices for the ozaki int8 transforms, scale
// included.  Replaces slice_field_pallas / _slice_kernel
// (chsimpy_tpu/ops/ozaki.py:214-262) and the scale before it.  Two
// launches on the caller's stream, no host sync and no torch arithmetic:
//
// 1. slice_scale_kernel: max|x| over the field, then the shared power of
//    two of the plain version (ops/kernels.py slice_scale), to the bit:
//    e = max(ceil(log2(amax + 1e-30)) + 2, -90) in float64 with CUDA's log2
//    and ceil (what torch computes on the card; frexp would differ when
//    amax lies just above a power of two), scale = exp2(e) and
//    inv = float(exp2(-e)), exact at an integer e.  Each block takes the
//    max of |x| as the bits of a non-negative double (their integer order
//    is the numbers' order, a NaN above +inf, so a NaN propagates as in
//    torch.amax), the last block to finish (K3's ticket) takes the max of
//    the blocks' and writes scale and inv.  Max is order-free: the grid
//    does not change the result.
// 2. slice_kernel: split x into float32 hi = rn(x) and lo = rn(x - hi) (the
//    double subtraction is exact), scale both by inv (read from device
//    memory), then run the fixed-point chain v *= 128; s = rint(v); v -= s
//    in float32 on each, rounding half to even as torch.round and
//    jnp.round do (slice_planes).  The lo chain starts at slice 3 (lo *
//    128^3 / scale < 1/2 rounds to 0 in the first three).  Plane k of out
//    gets int8(s_hi + s_lo): the plain version's bits.
//
// K5_members (the JAX ensemble vmaps B6, so each member has its own
// scale): both kernels with member r on grid row r of an (R, ...) stack of
// fields, member r's planes at plane k, row r of an (n_slices, R, ...)
// output.  Each member's max, scale and planes are the single launch's on
// its field, to the bit (the max is exact; the planes are elementwise).
//
// K5 sharded (the pencil layout: B6 on a rank's block at the WHOLE field's
// scale, as GSPMD's max over the sharded field gives it in the JAX
// package): the max pass in its max-only mode writes the block's max|x|
// (its bits, one word a member) instead of the scale; the caller takes the
// max of those words over the ranks (an all-reduce MAX: order-free, so
// every rank gets the same bits), and the slice pass in its sharded mode
// (slice_kernel<true>) forms the scale and inverse from that max by the
// same formula (scale_from_max) in every block, the block holding a
// member's first tile writing its scale out.  A rank's planes are then the
// whole field's planes of its block, to the bit, and its scale the whole
// field's.  Two launches, one where the caller gives the world max.  Tried
// on the H100 and left out, as slower: an L2 evict_last policy on the max
// pass's loads, to keep a 33.5 MB block in L2 for the slice pass, and
// evict_first on the slice pass's loads.
//
// Bound by device-memory bandwidth: the field is read by both launches
// (8 bytes an element each; at N=4096 the 134 MB field exceeds the 50 MB
// L2) and n_slices bytes an element are written, 0.34 GB per call at
// N=4096 with 4 slices.  The slice pass runs its blocks in reverse, so the
// first to run read the end of the field, which the max pass read last and
// L2 may still hold.  A warp takes 512 neighbouring elements, 16 a thread,
// with double2 loads that read 512 contiguous bytes each; its bytes of a
// plane go through shared memory so that each thread stores 16 contiguous
// bytes (512 a warp per plane).  A field that is not 16-byte aligned, a
// plane length n % 16 != 0 and the ragged last warp take scalar loads and
// byte stores instead.
constexpr int kSliceElems = 16;                       // a thread's elements
constexpr int kSliceWarpTile = 32 * kSliceElems;      // a warp's
constexpr int kSliceBlockTile = kThreads * kSliceElems;
constexpr int kScaleLoads = 4;      // double2 loads a thread has in flight

__device__ __forceinline__ unsigned long long abs_bits(double v) {
  return (unsigned long long)__double_as_longlong(fabs(v));
}

// e = max(ceil(log2(amax + 1e-30)) + 2, -90), scale = 2^e, inv = 2^-e
// rounded to float (exact at an integer e); amax given by its bits
__device__ __forceinline__ void scale_from_max(unsigned long long m,
                                               double* scale, float* inv) {
  const double amax = __longlong_as_double((long long)m);
  double e = ceil(log2(amax + 1e-30)) + 2.0;
  if (e < -90.0) e = -90.0;              // a NaN stays NaN, as in torch.clamp
  *scale = exp2(e);
  *inv = __double2float_rn(exp2(-e));
}

// amax_out == nullptr: the last block writes scale and inv; else (K5
// sharded's max-only mode) it writes the max's bits to amax_out
__global__ void __launch_bounds__(kThreads)
slice_scale_kernel(const double* __restrict__ x, long long n, bool vec,
                   unsigned long long* __restrict__ partials,
                   unsigned int* __restrict__ ticket,
                   double* __restrict__ scale, float* __restrict__ inv,
                   unsigned long long* __restrict__ amax_out) {
  __shared__ unsigned long long sh[kWarps];
  __shared__ bool last;
  // member r (blockIdx.y): its field, partials and ticket (and at the
  // end its scale and inverse, or its max)
  const int r = blockIdx.y;
  x += (long long)r * n;
  partials += (long long)r * gridDim.x;
  ticket += r;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned long long m = 0;
  if (vec) {
    const double2* x2 = reinterpret_cast<const double2*>(x);
    const long long n2 = n / 2;
    long long i = t0;
    for (; i + (kScaleLoads - 1) * stride < n2; i += kScaleLoads * stride) {
      double2 q[kScaleLoads];
#pragma unroll
      for (int k = 0; k < kScaleLoads; ++k) q[k] = x2[i + k * stride];
#pragma unroll
      for (int k = 0; k < kScaleLoads; ++k)
        m = max(m, max(abs_bits(q[k].x), abs_bits(q[k].y)));
    }
    for (; i < n2; i += stride) {
      const double2 q = x2[i];
      m = max(m, max(abs_bits(q.x), abs_bits(q.y)));
    }
    if ((n & 1) && t0 == 0) m = max(m, abs_bits(x[n - 1]));
  } else {
    for (long long i = t0; i < n; i += stride) m = max(m, abs_bits(x[i]));
  }
  auto block_max = [&](unsigned long long v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = max(v, __shfl_down_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 1; w < kWarps; ++w) v = max(v, sh[w]);
    __syncthreads();
    return v;                           // the block's max in thread 0
  };
  m = block_max(m);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    __threadfence();                     // the partial before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = 0;
  for (unsigned int b = threadIdx.x; b < gridDim.x; b += kThreads)
    m = max(m, __ldcg(partials + b));
  m = block_max(m);
  if (threadIdx.x == 0) {
    if (amax_out != nullptr)
      amax_out[r] = m;
    else
      scale_from_max(m, scale + r, inv + r);
    *ticket = 0u;
  }
}

// A thread's kSliceElems values of one warp tile of K5's slice pass (the
// up-to-kSliceWarpTile elements at src): element 2k+b of the thread lies
// at 64k + 2 lane + b; valid: how many of the tile's elements exist (the
// rest read as 0); full: a whole tile with 16-byte loads.
__device__ __forceinline__ void slice_load(const double* __restrict__ src,
                                           long long valid, bool full,
                                           double (&v)[kSliceElems]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kSliceElems / 2; ++k) {
    const int i = 64 * k + 2 * lane;
    if (full) {
      const double2 q = *reinterpret_cast<const double2*>(src + i);
      v[2 * k] = q.x;
      v[2 * k + 1] = q.y;
    } else {
      v[2 * k] = i < valid ? src[i] : 0.0;
      v[2 * k + 1] = i + 1 < valid ? src[i + 1] : 0.0;
    }
  }
}

// the float32 hi = rn(x) and lo = rn(x - hi) of each value
__device__ __forceinline__ void slice_split(const double (&v)[kSliceElems],
                                            float (&h)[kSliceElems],
                                            float (&l)[kSliceElems]) {
#pragma unroll
  for (int e = 0; e < kSliceElems; ++e) {
    h[e] = __double2float_rn(v[e]);
    l[e] = __double2float_rn(v[e] - (double)h[e]);
  }
}

// The planes of a thread's values of one warp tile (hi, lo in h, l, the
// thread's elements as slice_load places them) into dst, plane p at
// dst + p * plane_stride; full: 16-byte stores, the warp's bytes staged
// through its stage.  The stores stream (st.global.cs: evict-first in L2,
// the planes are not read again by this kernel).  rint(v) is (v + M) - M
// with M = 1.5 * 2^23 (|v| <= 64 here, far below 2^22: the float sum
// rounds v to an integer, half to even, as rintf and torch.round do), and
// the integer is the low byte of the sum's bits (M's low byte is 0): two
// float additions and an integer one in place of a rounding and a
// conversion (FRND, F2I), both on the H100's 16-a-clock conversion pipe,
// which held the slice pass (about 12 of them an element at 4 slices).
// The planes are the rintf chain's, to the bit (a zero's sign aside,
// which no plane keeps): a NaN value, whose conversion gave 0 in every
// plane, starts the chain at 0.
__device__ __forceinline__ void slice_planes(
    float (&h)[kSliceElems], float (&l)[kSliceElems], float inv,
    signed char* __restrict__ dst, long long plane_stride, long long valid,
    bool full, int n_slices, unsigned char* __restrict__ stage) {
  const int lane = threadIdx.x & 31;
  const float inv_lo = inv * 2097152.0f;  // 128^3, exact: a power of two
  const int lo_skip = n_slices < 3 ? n_slices : 3;
  const float M = 12582912.0f;            // 1.5 * 2^23
#pragma unroll
  for (int e = 0; e < kSliceElems; ++e) {
    h[e] = h[e] * inv;
    l[e] = l[e] * inv_lo;
    if (h[e] != h[e]) h[e] = l[e] = 0.0f;   // NaN x or scale: lo is NaN too
  }
  for (int p = 0; p < n_slices; ++p) {
    signed char s8[kSliceElems];
#pragma unroll
    for (int e = 0; e < kSliceElems; ++e) {
      h[e] = h[e] * 128.0f;
      const float hm = h[e] + M;
      h[e] = h[e] - (hm - M);
      unsigned q = __float_as_uint(hm);
      if (p >= lo_skip) {
        l[e] = l[e] * 128.0f;
        const float lm = l[e] + M;
        l[e] = l[e] - (lm - M);
        q += __float_as_uint(lm);
      }
      s8[e] = (signed char)(q & 0xffu);
    }
    signed char* d = dst + (long long)p * plane_stride;
    if (full) {
      // plane p of member r starts at (p R + r) n, 16-byte aligned for
      // every p and r (full holds n % 16 == 0): two bytes a store into
      // the warp's stage, then 16 contiguous bytes a thread
#pragma unroll
      for (int k = 0; k < kSliceElems / 2; ++k)
        *reinterpret_cast<unsigned short*>(&stage[64 * k + 2 * lane]) =
            (unsigned short)((unsigned char)s8[2 * k] |
                             (unsigned)(unsigned char)s8[2 * k + 1] << 8);
      __syncwarp();
      const uint4 q = *reinterpret_cast<const uint4*>(&stage[16 * lane]);
      __syncwarp();                      // read before the next plane writes
      __stcs(reinterpret_cast<uint4*>(d + 16 * lane), q);
    } else {
#pragma unroll
      for (int e = 0; e < kSliceElems; ++e) {
        const int idx = 64 * (e / 2) + 2 * lane + (e % 2);
        if (idx < valid) __stcs(d + idx, s8[e]);
      }
    }
  }
}

// SHARDED (K5 sharded's slice pass): each member's scale and inverse from
// the bits of its world max (amax), formed by thread 0 of every block
// while the block's loads are in flight; the block holding the member's
// first tile writes the scale.  Else the inverses are read from inv_ptr.
template <bool SHARDED>
__global__ void __launch_bounds__(kThreads)
slice_kernel(const double* __restrict__ x, const float* __restrict__ inv_ptr,
             const unsigned long long* __restrict__ amax,
             double* __restrict__ scale, signed char* __restrict__ out,
             long long n, int n_slices, bool vec) {
  __shared__ __align__(16) unsigned char stage[kWarps][kSliceWarpTile];
  __shared__ float inv_sh;
  // member r (blockIdx.y) of R (gridDim.y): its field and inverse; its
  // plane p at (p R + r) n of the (n_slices, R, n) output
  const long long r = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const long long tile =
      (long long)(gridDim.x - 1 - blockIdx.x) * kSliceBlockTile +
      (long long)warp * kSliceWarpTile;
  if (!SHARDED && tile >= n) return;    // the whole warp
  const bool full = vec && tile + kSliceWarpTile <= n;
  double v[kSliceElems];
  float inv;
  if (SHARDED) {
    // every thread reaches the barrier: a warp past the end loads nothing
    if (tile < n) slice_load(x + r * n + tile, n - tile, full, v);
    if (threadIdx.x == 0) {
      double sc;
      scale_from_max(amax[r], &sc, &inv_sh);
      if (blockIdx.x == gridDim.x - 1) scale[r] = sc;
    }
    __syncthreads();
    inv = inv_sh;
    if (tile >= n) return;
  } else {
    slice_load(x + r * n + tile, n - tile, full, v);
    inv = inv_ptr[r];
  }
  float h[kSliceElems], l[kSliceElems];
  slice_split(v, h, l);
  slice_planes(h, l, inv, out + r * n + tile, (long long)gridDim.y * n,
               n - tile, full, n_slices, stage[warp]);
}

// K5 in one launch (the one-launch path), where the members' fields fit in
// L2 (the wrapper's slice_one_launch, up to 48 MiB: the canonical R=16
// N=512 batch, 32 MiB, and the single N=512 to 2048 fields): at R=16
// N=512 the two launches above took 36% of their bound.  One cooperative launch of co-resident blocks,
// each taking a fixed range of the members' 4096-element tiles:
// 1. max pass: each block takes max|x| over its tiles (the bits of a
//    non-negative double, as slice_scale_kernel does) and adds it to its
//    members' maxima with atomicMax (order-free, so the max pass's bits);
// 2. a grid barrier (every block is resident: the launch is cooperative);
// 3. slice pass: each block forms its members' scale and inverse from the
//    maxima (scale_from_max) and slices the same tiles again, last read
//    first: the last from registers, the others from L2 (slice_load,
//    slice_split, slice_planes, the slice pass's code); the block holding
//    a member's first tile writes its scale and inverse;
// 4. the last block to finish (a ticket) puts the maxima and the barrier
//    back to 0 for the next call.
// Planes and scales are the two launches' (and the plain version's), to
// the bit, whatever the grid.  A one-cluster-a-member design (the field
// in the shared memory of up to 16 CTAs, maxima over distributed shared
// memory) was slower than the two launches at R=16 and at R=1, N=512 on
// the H100: one CTA an SM, each loading 128 KiB before it could slice.
// Holding the last tile in registers costs registers (two blocks an SM);
// capping them for more blocks an SM was no faster.

// the block's max of m into *dst (atomicMax; every thread calls it)
__device__ __forceinline__ void block_max_into(unsigned long long m,
                                               unsigned long long* sh,
                                               unsigned long long* dst) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = max(m, sh[w]);
    atomicMax(dst, m);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
slice_one_launch_kernel(const double* __restrict__ x, long long n, int R,
                        long long member_tiles,
                        unsigned long long* __restrict__ scratch,
                        double* __restrict__ scale,
                        float* __restrict__ inv_out,
                        signed char* __restrict__ out, int n_slices,
                        bool vec) {
  __shared__ __align__(16) unsigned char stage[kWarps][kSliceWarpTile];
  __shared__ unsigned long long sh[kWarps];
  // scratch: the barrier's two counters, then the R members' maxima, all
  // 0 between calls
  unsigned int* arrived = reinterpret_cast<unsigned int*>(scratch);
  unsigned int* finished = arrived + 1;
  unsigned long long* amax = scratch + 1;
  const long long tiles = (long long)R * member_tiles;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  // 1. the maxima (a block's range changes member at most a few times:
  // the member, hence the branch, is the same for all its threads); the
  // values of the block's last tile stay in registers for step 3
  const int warp = threadIdx.x >> 5;
  long long cur = -1;
  unsigned long long m = 0;
  double v[kSliceElems];
  for (long long t = t0; t < t1; ++t) {
    const long long r = t / member_tiles;
    if (r != cur) {
      if (cur >= 0) block_max_into(m, sh, amax + cur);
      cur = r;
      m = 0;
    }
    const long long w0 = (t - r * member_tiles) * kSliceBlockTile +
                         (long long)warp * kSliceWarpTile;
    slice_load(x + r * n + w0, n - w0, vec && w0 + kSliceWarpTile <= n, v);
#pragma unroll
    for (int e = 0; e < kSliceElems; ++e) m = max(m, abs_bits(v[e]));
  }
  if (cur >= 0) block_max_into(m, sh, amax + cur);
  float h[kSliceElems], l[kSliceElems];
  slice_split(v, h, l);
  // 2. the grid barrier (thread 0 polls, backing off up to 512 ns)
  if (threadIdx.x == 0) {
    __threadfence();                     // the maxima before the arrival
    atomicAdd(arrived, 1u);
    unsigned int wait = 32;
    while (*reinterpret_cast<volatile unsigned int*>(arrived) < gridDim.x) {
      __nanosleep(wait);
      if (wait < 512) wait *= 2;
    }
    __threadfence();
  }
  __syncthreads();
  // 3. the slices, the block's tiles in reverse: the last one is in
  // registers, the one before it the likeliest still in L2
  cur = -1;
  float inv = 0.0f;
  double sc = 0.0;
  for (long long t = t1 - 1; t >= t0; --t) {
    const long long r = t / member_tiles;
    if (r != cur) {
      cur = r;
      scale_from_max(__ldcg(amax + r), &sc, &inv);
    }
    if (t == r * member_tiles && threadIdx.x == 0) {
      scale[r] = sc;
      inv_out[r] = inv;
    }
    const long long w0 = (t - r * member_tiles) * kSliceBlockTile +
                         (long long)warp * kSliceWarpTile;
    const bool full = vec && w0 + kSliceWarpTile <= n;
    if (t < t1 - 1) {
      slice_load(x + r * n + w0, n - w0, full, v);
      slice_split(v, h, l);
    }
    if (w0 < n)
      slice_planes(h, l, inv, out + r * n + w0, (long long)R * n, n - w0,
                   full, n_slices, stage[warp]);
  }
  // 4. the last block puts the scratch back to 0 (every block has read
  // the maxima and left the barrier before it counts itself finished)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(finished, 1u) == gridDim.x - 1) {
      for (int r = 0; r < R; ++r) amax[r] = 0ull;
      *arrived = 0u;
      *finished = 0u;
      __threadfence();
    }
  }
}

// K9 — per-step Sobol jitter, U += jitter * (2 r - 1) in place.  It has no
// Pallas counterpart: the JAX package adds the points of
// chsimpy_tpu/ops/sobol.py:46 sobol_points (30 XOR-select passes that XLA
// fuses into one) in its step (core/stepper.py:734-748).  r[i, j] is point
// base + row_off + i (mod 2^32), dimension col_off + j of scipy's scrambled
// Sobol sequence: the XOR of shift[j] and of sv[j, k] over the set bits
// k < 30 of gray(n) = n ^ (n >> 1), times 2^-30, formed in double (exact)
// and cast to the field type; the rest runs in the field type in the plain
// version's order (-fmad=false), so the result is its bits.  base is read
// from device memory (the step computes it on the card: no host sync).
//
// Bound by device-memory bandwidth: U is read and written once, 134 MB per
// call at N=4096 f32.  A block of 32 x 8 threads takes 32 columns and 8
// strips of kSobolRows rows: a warp is 32 neighbouring columns of one row,
// so each load and store of U is coalesced.  The block first copies the 32
// columns' direction numbers (sv rows, contiguous) into shared memory,
// padded so that neither the copy nor the reads conflict.  A thread forms
// its first point in full (at most 30 XORs), then steps one row with one
// XOR: gray(n+1) ^ gray(n) = 1 << ctz(n+1).  ctz(n+1) >= 30 changes
// nothing, as bits 30 and 31 never enter (JAX's loop stops at 30), and the
// wrap n+1 = 0 flips bit 31 only.  Each thread loads kSobolBatch rows
// before it stores any, so that many loads are in flight.
constexpr int kSobolBits = 30;
constexpr int kSobolCols = 32;          // columns a block (one warp wide)
constexpr int kSobolStrips = kThreads / kSobolCols;
constexpr int kSobolRows = 32;          // rows a thread
constexpr int kSobolBatch = 8;          // rows loaded before the first store

template <typename T>
__global__ void __launch_bounds__(kThreads)
sobol_jitter_kernel(T* __restrict__ U, int bn, int W,
                    const long long* __restrict__ sv,
                    const long long* __restrict__ shift,
                    const long long* __restrict__ base_ptr, int row_off,
                    int col_off, T jitter) {
  __shared__ unsigned int tab[kSobolBits][kSobolCols + 1];
  const int tx = threadIdx.x % kSobolCols;
  const int ty = threadIdx.x / kSobolCols;
  const int c0 = blockIdx.x * kSobolCols;
  const int ncols = min(kSobolCols, W - c0);
  const long long* src = sv + (long long)(col_off + c0) * kSobolBits;
  for (int i = threadIdx.x; i < ncols * kSobolBits; i += kThreads)
    tab[i % kSobolBits][i / kSobolBits] = (unsigned int)src[i];
  __syncthreads();
  const int r0 = (blockIdx.y * kSobolStrips + ty) * kSobolRows;
  const int r1 = min(r0 + kSobolRows, bn);
  if (tx >= ncols || r0 >= r1) return;
  const int j = c0 + tx;
  unsigned int n = (unsigned int)(*base_ptr) + (unsigned int)(row_off + r0);
  const unsigned int g = n ^ (n >> 1);
  unsigned int acc = (unsigned int)shift[col_off + j];
  for (int k = 0; k < kSobolBits; ++k)
    if ((g >> k) & 1u) acc ^= tab[k][tx];
  T* col = U + j;
  for (int r = r0; r < r1; r += kSobolBatch) {
    T u[kSobolBatch];
#pragma unroll
    for (int b = 0; b < kSobolBatch; ++b)
      if (r + b < r1) u[b] = col[(long long)(r + b) * W];
#pragma unroll
    for (int b = 0; b < kSobolBatch; ++b) {
      if (r + b < r1) {
        const T rv = (T)((double)acc * 9.313225746154785e-10);  // 2^-30
        const T two_r = T(2) * rv;
        const T centred = two_r - T(1);
        col[(long long)(r + b) * W] = u[b] + jitter * centred;
        ++n;                                  // the next row's point
        const int k = __ffs((int)n) - 1;      // ctz(n); -1 at the wrap
        if (k >= 0 && k < kSobolBits) acc ^= tab[k][tx];
      }
    }
  }
}

// K10 — the device jitter's threefry stream, U += jitter * (2 r - 1) in
// place.  It has no Pallas counterpart: the JAX step draws r with
// jax.random (chsimpy_tpu/core/stepper.py:750-751, `rng_key, sub =
// split(rng_key)`, `uniform(sub, (N, N), dtype)`) and XLA fuses the hash.
// Threefry-2x32 with 20 rounds (Salmon et al., SC'11; JAX's threefry2x32,
// the Random123 rotation constants), under JAX's partitionable defaults:
// split hashes the counters (0, 0) -> next key and (0, 1) -> sub, and
// element (i, j) of the (N, N) draw hashes the counter (idx >> 32,
// idx & 0xFFFFFFFF) of idx = i*N + j under sub.  float takes the top 23 bits
// of bits1 ^ bits2, double the top 52 of (bits1 << 32) | bits2, as the
// mantissa of a number in [1, 2), minus 1: the bits of jax.random.uniform.
// The update runs in the field type in the plain version's order
// (-fmad=false).  On a grid mesh a rank's block at (row_off, col_off) hashes
// only its own counters: the partitionable counters make the block the
// whole draw's, to the bit.
//
// The key lives in device memory (two uint32 words in int64s): every block
// derives sub from it (thread 0, into shared memory), and block (0, 0)
// writes the next key into key_out, another buffer than key_in, so no
// thread reads a key that another writes; go (a bool on the card, or null)
// keeps the key where the step is thrown away.  No host sync.
//
// Bound by integer operations: ~80 32-bit operations an element (20 rounds
// of add, rotate, xor, 6 key injections, the counter and the float bits)
// against 8 or 16 bytes of U read and written.  One element a thread, a
// row of 256 columns a block: a warp's loads and stores are coalesced.
__device__ __forceinline__ void threefry2x32(unsigned int k0,
                                             unsigned int k1,
                                             unsigned int& x0,
                                             unsigned int& x1) {
  const unsigned int ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i & 1][j]);   // rotate left
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned int)(i + 1);
  }
}

__device__ __forceinline__ float threefry_unit(unsigned int b0,
                                               unsigned int b1, float) {
  return __uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u) - 1.0f;
}
__device__ __forceinline__ double threefry_unit(unsigned int b0,
                                                unsigned int b1, double) {
  const unsigned long long m = ((unsigned long long)b0 << 20) | (b1 >> 12);
  return __longlong_as_double((long long)(m | 0x3FF0000000000000ull)) - 1.0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
threefry_jitter_kernel(T* __restrict__ U, int bn, int W, long long N,
                       int row_off, int col_off,
                       const long long* __restrict__ key_in,
                       long long* __restrict__ key_out,
                       const unsigned char* __restrict__ go, T jitter) {
  __shared__ unsigned int sub[2];
  if (threadIdx.x == 0) {
    const unsigned int k0 = (unsigned int)key_in[0];
    const unsigned int k1 = (unsigned int)key_in[1];
    unsigned int s0 = 0u, s1 = 1u;
    threefry2x32(k0, k1, s0, s1);
    sub[0] = s0;
    sub[1] = s1;
    if (blockIdx.x == 0 && blockIdx.y == 0) {
      unsigned int n0 = 0u, n1 = 0u;
      threefry2x32(k0, k1, n0, n1);
      const bool advance = go == nullptr || *go != 0;
      key_out[0] = advance ? n0 : k0;
      key_out[1] = advance ? n1 : k1;
    }
  }
  __syncthreads();
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= W || row >= bn) return;
  const unsigned long long idx =
      (unsigned long long)(row_off + row) * (unsigned long long)N +
      (unsigned long long)(col_off + col);
  unsigned int x0 = (unsigned int)(idx >> 32);
  unsigned int x1 = (unsigned int)idx;
  threefry2x32(sub[0], sub[1], x0, x1);
  const T r = threefry_unit(x0, x1, T(0));
  const T two_r = T(2) * r;
  const T centred = two_r - T(1);
  T* p = U + (long long)row * W + col;
  *p = *p + jitter * centred;
}

// Pass 2 of K4: out[c] = sum over b of partials[b, c], block c (one a
// member), fixed order (the order of the single block that walked the
// columns one after another before: the same bits).  Where rows is given,
// block c then runs K11's body on member c's row (rows + c * member_stride
// + row_offset, W values) and writes its Ra to ra[c]: the members' step
// takes PS and Ra in K4's two launches.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_columns_kernel(const double* __restrict__ partials, int nrows,
                      int ncols, double* __restrict__ out,
                      const T* __restrict__ rows, long long member_stride,
                      long long row_offset, int W, double* __restrict__ ra) {
  const int c = blockIdx.x;
  double acc[1] = {0.0};
  for (int b = threadIdx.x; b < nrows; b += kThreads)
    acc[0] += partials[(long long)b * ncols + c];
  block_sum<1>(acc);
  if (threadIdx.x == 0) out[c] = acc[0];
  if (rows == nullptr) return;
  const double r = row_absdev<T>(rows + c * member_stride + row_offset, W);
  if (threadIdx.x == 0) ra[c] = r;
}

inline unsigned int elementwise_blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

inline bool bad_members(int R) { return R < 1 || R > 65535; }

constexpr int kMaxDevices = 64;

// K1 on R fields of n elements; A0s / A1s: R doubles on the card, or null
// (R = 1) for the scalars A0 / A1
template <typename T>
int launch_mu(const void* U, void* out, long long n, int R, double RT,
              double BRT, double A0, double A1, const void* A0s,
              const void* A1s, void* stream) {
  if (n <= 0 || bad_members(R) || (R > 1 && (A0s == nullptr ||
                                             A1s == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(elementwise_blocks(n), R);
  mu_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)U, (T*)out, n, T(RT), T(BRT), T(A0), T(A1),
      (const double*)A0s, (const double*)A1s);
  return (int)cudaGetLastError();
}

// K2 on R fields of n elements; Seig / CHeig per member (1) or shared (0)
template <typename T>
int launch_update(const void* hat_U, const void* hat_E, const void* Seig,
                  const void* CHeig, void* out, long long n, int R,
                  int seig_per_member, int cheig_per_member, void* stream) {
  if (n <= 0 || bad_members(R)) return (int)cudaErrorInvalidValue;
  const dim3 grid(elementwise_blocks(n), R);
  update_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)hat_U, (const T*)hat_E, (const T*)Seig, (const T*)CHeig,
      (T*)out, n, seig_per_member ? n : 0, cheig_per_member ? n : 0);
  return (int)cudaGetLastError();
}

// K12 on R members' (rows, cols) blocks at (row_off, col_off) of the
// spectral image; delt: R doubles (delt_per_member) or one; kappas: R
// doubles on the card, or null for kappa
template <typename T>
int launch_update_otf(const void* hat_U, const void* hat_E,
                      const void* eaxis, void* out, int rows, int cols,
                      int row_off, int col_off, int R, const void* delt,
                      int delt_per_member, const void* kappas, double kappa,
                      double delx2, void* stream) {
  if (rows < 1 || cols < 1 || rows > 65535 || row_off < 0 || col_off < 0 ||
      bad_members(R) || delt == nullptr || eaxis == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kThreads - 1) / kThreads, rows, R);
  update_otf_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)hat_U, (const T*)hat_E, (const T*)eaxis, (T*)out, rows,
      cols, row_off, col_off, (const double*)delt, delt_per_member,
      (const double*)kappas, T(kappa), T(delx2));
  return (int)cudaGetLastError();
}

template <typename T, int V, bool HALO, bool FOLD, bool PREV>
int launch_stats_v(const void* U, const void* E, const void* up,
                   const void* dn, const void* lf, const void* rt, int bn,
                   int W, int N, int row_off, int col_off, int R, int band,
                   double delx, double RT, double B, double A0, double A1,
                   const void* A0s, const void* A1s, double threshold,
                   void* partials, int nblocks, void* ticket, void* sums,
                   cudaStream_t s) {
  const dim3 grid((W + kThreads * V - 1) / (kThreads * V),
                  (bn + band - 1) / band, R);
  if ((long long)grid.x * grid.y != nblocks || grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  stats_kernel<T, V, HALO, FOLD, PREV><<<grid, kThreads, 0, s>>>(
      (const T*)U, (const T*)E, (const T*)up, (const T*)dn, (const T*)lf,
      (const T*)rt, bn, W, N, row_off, col_off, band, delx, T(RT), T(B),
      T(A0), T(A1), (const double*)A0s, (const double*)A1s, T(threshold),
      (double*)partials, (unsigned int*)ticket, (double*)sums);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* p, long long bytes) {
  return ((unsigned long long)p % (unsigned long long)bytes) == 0;
}

inline bool aligned16(const void* p) { return aligned(p, 16); }

// K3 (HALO false: the (N, N) field, or R members' fields of a contiguous
// (R, N, N) stack, no halo pointers) and K7 (a (bn, W) block at (row_off,
// col_off) with its halo vectors; K7_members: R members' blocks of a
// contiguous (R, bn, W) stack, the halo vectors (R, W) and (R, bn)).
// (vec, band): the wrapper's tile (stats_tile), vec 1, 2 or (float) 4
// columns a thread, band rows a block; a vector needs W % vec == 0 and
// every pointer aligned to its width (the wrapper checks W and the
// addresses; checked again here, for every member's block and halo row);
// nblocks: the grid of one member that the wrapper sized partials for (R *
// nblocks rows); ticket: R counters; A0s / A1s: R doubles on the card, or
// null (R = 1); FOLD: K3's fold mode (even N, a vector only where N/2 %
// vec == 0); prev: the parent body (stats_kernel's PREV), kept only to
// time the new body beside it
template <typename T, bool HALO, bool FOLD = false>
int launch_stats(const void* U, const void* E, const void* up,
                 const void* dn, const void* lf, const void* rt, int bn,
                 int W, int N, int row_off, int col_off, int R, double delx,
                 double RT, double B, double A0, double A1, const void* A0s,
                 const void* A1s, double threshold, void* partials,
                 int nblocks, int vec, int band, void* ticket, void* sums,
                 int prev, void* stream) {
  if (bn < 1 || W < 1 || N < 2 || row_off < 0 || col_off < 0 ||
      row_off + bn > N || col_off + W > N || U == nullptr || band < 1 ||
      bad_members(R) || (R > 1 && (A0s == nullptr || A1s == nullptr)) ||
      (HALO && (up == nullptr || dn == nullptr || lf == nullptr ||
                rt == nullptr)) || (FOLD && (HALO || N % 2)) ||
      (vec != 1 && vec != 2 && vec * (int)sizeof(T) != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec > 1) {
    // a member's field (block) starts bn * W elements after the last, its
    // halo rows W after the last: aligned with the first where W % vec
    // == 0
    const long long width = vec * (long long)sizeof(T);
    if (W % vec || !aligned(U, width) ||
        (E != nullptr && !aligned(E, width)) ||
        (HALO && (!aligned(up, width) || !aligned(dn, width))) ||
        (FOLD && (N / 2) % vec))
      return (int)cudaErrorMisalignedAddress;
  }
#define CH_STATS_LAUNCH(VV)                                                 \
  return prev ? launch_stats_v<T, VV, HALO, FOLD, true>(                  \
      U, E, up, dn, lf, rt, bn, W, N, row_off, col_off, R, band, delx, RT, \
      B, A0, A1, A0s, A1s, threshold, partials, nblocks, ticket, sums, s)  \
                : launch_stats_v<T, VV, HALO, FOLD, false>(                 \
      U, E, up, dn, lf, rt, bn, W, N, row_off, col_off, R, band, delx, RT, \
      B, A0, A1, A0s, A1s, threshold, partials, nblocks, ticket, sums, s)
  if (vec == 1) CH_STATS_LAUNCH(1);
  if (vec == 2) CH_STATS_LAUNCH(2);
  if constexpr (sizeof(T) == 4) CH_STATS_LAUNCH(4);
#undef CH_STATS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K3 with its fold mode chosen at run time
template <typename T>
int launch_stats_field(const void* U, const void* E, int N, int R,
                       double delx, double RT, double B, double A0,
                       double A1, const void* A0s, const void* A1s,
                       double threshold, void* partials, int nblocks,
                       int vec, int band, void* ticket, void* sums, int fold,
                       int prev, void* stream) {
  if (fold)
    return launch_stats<T, false, true>(
        U, E, nullptr, nullptr, nullptr, nullptr, N, N, N, 0, 0, R, delx,
        RT, B, A0, A1, A0s, A1s, threshold, partials, nblocks, vec, band,
        ticket, sums, prev, stream);
  return launch_stats<T, false>(
      U, E, nullptr, nullptr, nullptr, nullptr, N, N, N, 0, 0, R, delx, RT,
      B, A0, A1, A0s, A1s, threshold, partials, nblocks, vec, band, ticket,
      sums, prev, stream);
}

// K4 on R fields of n elements with R means; partials: nblocks * R
// doubles; sums: R doubles.  rows (or null): K11's rows of the R members
// (member r's W values at r * member_stride + row_offset), their Ra to ra
// (R doubles) in the second pass
template <typename T>
int launch_absdev(const void* U, long long n, int R, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream,
                  const void* rows = nullptr, long long member_stride = 0,
                  long long row_offset = 0, int W = 0, void* ra = nullptr) {
  if (n <= 0 || nblocks < 1 || bad_members(R) ||
      (rows != nullptr && (W < 1 || member_stride < 0 || row_offset < 0 ||
                           ra == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  absdev_partials_kernel<T><<<dim3(nblocks, R), kThreads, 0, s>>>(
      (const T*)U, n, (const T*)mean, (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_columns_kernel<T><<<R, kThreads, 0, s>>>(
      (const double*)partials, nblocks, R, (double*)sums, (const T*)rows,
      member_stride, row_offset, W, (double*)ra);
  return (int)cudaGetLastError();
}

// K11 on R members' rows of W elements; out: R doubles
template <typename T>
int launch_row_absdev(const void* U, int R, long long member_stride,
                      long long row_offset, int W, void* out, void* stream) {
  if (W < 1 || bad_members(R) || member_stride < 0 || row_offset < 0)
    return (int)cudaErrorInvalidValue;
  row_absdev_kernel<T><<<R, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)U, member_stride, row_offset, W, (double*)out);
  return (int)cudaGetLastError();
}

// K5's first launch on R fields of n elements.  partials: R * max_blocks
// 64-bit words of scratch; ticket, scale, inv: R each; each member's grid
// is the single launch's, at most max_blocks blocks of 8 elements a thread
// (the max is exact, so the double2 loads, taken where every member's
// field is 16-byte aligned, change no bit)
// (amax_out: nullptr for K5's own scale; R words for K5 sharded's max)
int launch_slice_scale(const void* x, long long n, int R, void* partials,
                       int max_blocks, void* ticket, void* scale, void* inv,
                       void* amax_out, void* stream) {
  if (n <= 0 || max_blocks < 1 || bad_members(R))
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * 2 * kScaleLoads;
  const long long want = (n + per_block - 1) / per_block;
  const dim3 grid((unsigned int)(want < max_blocks ? want : max_blocks), R);
  slice_scale_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)x, n, aligned16(x) && (R == 1 || n % 2 == 0),
      (unsigned long long*)partials, (unsigned int*)ticket, (double*)scale,
      (float*)inv, (unsigned long long*)amax_out);
  return (int)cudaGetLastError();
}

// K5's second launch on R fields of n elements: n_slices * R planes of n
// bytes into out, (n_slices, R, n), with R inverses (inv), or (K5
// sharded, amax given) with the scales and inverses of R world maxima,
// the scales written to scale
int launch_slice(const void* x, const void* inv, const void* amax,
                 void* scale, void* out, long long n, int R, int n_slices,
                 void* stream) {
  if (n <= 0 || n_slices < 1 || n_slices > 8 || bad_members(R) ||
      (amax == nullptr ? inv == nullptr : scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && aligned16(x) && aligned16(out);
  const dim3 grid((unsigned int)((n + kSliceBlockTile - 1) / kSliceBlockTile),
                  R);
  if (amax != nullptr)
    slice_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)x, nullptr, (const unsigned long long*)amax,
        (double*)scale, (signed char*)out, n, n_slices, vec);
  else
    slice_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)x, (const float*)inv, nullptr, nullptr,
        (signed char*)out, n, n_slices, vec);
  return (int)cudaGetLastError();
}

// K5's one-launch path on R fields of n elements: a cooperative launch of
// at most the blocks the card holds at once (one a tile where there are
// fewer tiles); scratch: 1 + R 64-bit words, 0 between calls; scale, inv:
// R each; out (n_slices, R, n).  A launch the card refuses returns its
// error; there is no other path here.
int launch_slice_one_launch(const void* x, long long n, int R,
                            void* scratch, void* scale, void* inv, void* out,
                            int n_slices, void* stream) {
  if (n <= 0 || bad_members(R) || scratch == nullptr || n_slices < 1 ||
      n_slices > 8)
    return (int)cudaErrorInvalidValue;
  // the blocks the card holds at once, asked once a device
  static int resident[kMaxDevices] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, slice_one_launch_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident[device] = sms * per_sm;
  }
  const long long member_tiles = (n + kSliceBlockTile - 1) / kSliceBlockTile;
  const long long tiles = member_tiles * R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(tiles < resident[device]
                                        ? tiles : resident[device]));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = n % 16 == 0 && aligned16(x) && aligned16(out);
  err = cudaLaunchKernelEx(&cfg, slice_one_launch_kernel, (const double*)x,
                           n, R, member_tiles,
                           (unsigned long long*)scratch, (double*)scale,
                           (float*)inv, (signed char*)out, n_slices, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K9: U (bn, W), row stride W, a block at (row_off, col_off) of the
// sequence's points and dimensions; sv (d, 30) and shift (d,) as int64, base
// a 0-d int64 on the card
template <typename T>
int launch_sobol_jitter(void* U, int bn, int W, const void* sv,
                        const void* shift, const void* base, int row_off,
                        int col_off, double jitter, void* stream) {
  if (bn < 1 || W < 1 || row_off < 0 || col_off < 0 || U == nullptr ||
      sv == nullptr || shift == nullptr || base == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kSobolCols - 1) / kSobolCols,
                  (bn + kSobolStrips * kSobolRows - 1) /
                      (kSobolStrips * kSobolRows));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  sobol_jitter_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)U, bn, W, (const long long*)sv, (const long long*)shift,
      (const long long*)base, row_off, col_off, T(jitter));
  return (int)cudaGetLastError();
}

// K10: U (bn, W), row stride W, the block at (row_off, col_off) of an
// (N, N) draw; key_in, key_out two int64 each on the card (distinct), go a
// bool on the card or null
template <typename T>
int launch_threefry_jitter(void* U, int bn, int W, long long N, int row_off,
                           int col_off, const void* key_in, void* key_out,
                           const void* go, double jitter, void* stream) {
  if (bn < 1 || W < 1 || row_off < 0 || col_off < 0 ||
      (long long)row_off + bn > N || (long long)col_off + W > N ||
      U == nullptr || key_in == nullptr || key_out == nullptr ||
      key_in == key_out)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, bn);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  threefry_jitter_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)U, bn, W, N, row_off, col_off, (const long long*)key_in,
      (long long*)key_out, (const unsigned char*)go, T(jitter));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ch_mu_f32(const void* U, void* out, long long n, double RT, double BRT,
              double A0, double A1, void* stream) {
  return launch_mu<float>(U, out, n, 1, RT, BRT, A0, A1, nullptr, nullptr,
                          stream);
}
int ch_mu_f64(const void* U, void* out, long long n, double RT, double BRT,
              double A0, double A1, void* stream) {
  return launch_mu<double>(U, out, n, 1, RT, BRT, A0, A1, nullptr, nullptr,
                           stream);
}
// member-batched K1: n elements a member, A0s / A1s R doubles on the card
int ch_mu_members_f32(const void* U, void* out, long long n, int R,
                      double RT, double BRT, const void* A0s,
                      const void* A1s, void* stream) {
  return launch_mu<float>(U, out, n, R, RT, BRT, 0.0, 0.0, A0s, A1s,
                          stream);
}
int ch_mu_members_f64(const void* U, void* out, long long n, int R,
                      double RT, double BRT, const void* A0s,
                      const void* A1s, void* stream) {
  return launch_mu<double>(U, out, n, R, RT, BRT, 0.0, 0.0, A0s, A1s,
                           stream);
}

int ch_update_f32(const void* hat_U, const void* hat_E, const void* Seig,
                  const void* CHeig, void* out, long long n, void* stream) {
  return launch_update<float>(hat_U, hat_E, Seig, CHeig, out, n, 1, 0, 0,
                              stream);
}
int ch_update_f64(const void* hat_U, const void* hat_E, const void* Seig,
                  const void* CHeig, void* out, long long n, void* stream) {
  return launch_update<double>(hat_U, hat_E, Seig, CHeig, out, n, 1, 0, 0,
                               stream);
}
// member-batched K2: Seig / CHeig (R, n) (flag 1) or one shared (n,) grid
int ch_update_members_f32(const void* hat_U, const void* hat_E,
                          const void* Seig, const void* CHeig, void* out,
                          long long n, int R, int seig_per_member,
                          int cheig_per_member, void* stream) {
  return launch_update<float>(hat_U, hat_E, Seig, CHeig, out, n, R,
                              seig_per_member, cheig_per_member, stream);
}
int ch_update_members_f64(const void* hat_U, const void* hat_E,
                          const void* Seig, const void* CHeig, void* out,
                          long long n, int R, int seig_per_member,
                          int cheig_per_member, void* stream) {
  return launch_update<double>(hat_U, hat_E, Seig, CHeig, out, n, R,
                               seig_per_member, cheig_per_member, stream);
}

// K12: R members' (rows, cols) blocks at (row_off, col_off) of the
// spectral image, eaxis the whole (N,) axis; delt: one double on the card,
// or R (delt_per_member); kappas: R doubles on the card, or null for kappa
int ch_update_otf_f32(const void* hat_U, const void* hat_E,
                      const void* eaxis, void* out, int rows, int cols,
                      int row_off, int col_off, int R, const void* delt,
                      int delt_per_member, const void* kappas, double kappa,
                      double delx2, void* stream) {
  return launch_update_otf<float>(hat_U, hat_E, eaxis, out, rows, cols,
                                  row_off, col_off, R, delt,
                                  delt_per_member, kappas, kappa, delx2,
                                  stream);
}
int ch_update_otf_f64(const void* hat_U, const void* hat_E,
                      const void* eaxis, void* out, int rows, int cols,
                      int row_off, int col_off, int R, const void* delt,
                      int delt_per_member, const void* kappas, double kappa,
                      double delx2, void* stream) {
  return launch_update_otf<double>(hat_U, hat_E, eaxis, out, rows, cols,
                                   row_off, col_off, R, delt,
                                   delt_per_member, kappas, kappa, delx2,
                                   stream);
}

// ticket: an unsigned int that is 0 between calls (the kernel resets it);
// fold: the field in the level-1 folded layout (K3's fold mode); prev: the
// parent body (the K3 and K7 entries all take it)
int ch_stats_f32(const void* U, const void* E, int N, double delx, double RT,
                 double B, double A0, double A1, double threshold,
                 void* partials, int nblocks, int vec, int band, void* ticket,
                 void* sums, int fold, int prev, void* stream) {
  return launch_stats_field<float>(U, E, N, 1, delx, RT, B, A0, A1, nullptr,
                                 nullptr, threshold, partials, nblocks, vec,
                                 band, ticket, sums, fold, prev, stream);
}
int ch_stats_f64(const void* U, const void* E, int N, double delx, double RT,
                 double B, double A0, double A1, double threshold,
                 void* partials, int nblocks, int vec, int band, void* ticket,
                 void* sums, int fold, int prev, void* stream) {
  return launch_stats_field<double>(U, E, N, 1, delx, RT, B, A0, A1, nullptr,
                                 nullptr, threshold, partials, nblocks, vec,
                                 band, ticket, sums, fold, prev, stream);
}
// member-batched K3: R fields (N, N); nblocks: one member's grid; ticket:
// R counters; sums: (R, 5)
int ch_stats_members_f32(const void* U, const void* E, int N, int R,
                         double delx, double RT, double B, const void* A0s,
                         const void* A1s, double threshold, void* partials,
                         int nblocks, int vec, int band, void* ticket,
                         void* sums, int fold, int prev, void* stream) {
  return launch_stats_field<float>(U, E, N, R, delx, RT, B, 0.0, 0.0, A0s,
                                 A1s, threshold, partials, nblocks, vec,
                                 band, ticket, sums, fold, prev, stream);
}
int ch_stats_members_f64(const void* U, const void* E, int N, int R,
                         double delx, double RT, double B, const void* A0s,
                         const void* A1s, double threshold, void* partials,
                         int nblocks, int vec, int band, void* ticket,
                         void* sums, int fold, int prev, void* stream) {
  return launch_stats_field<double>(U, E, N, R, delx, RT, B, 0.0, 0.0, A0s,
                                 A1s, threshold, partials, nblocks, vec,
                                 band, ticket, sums, fold, prev, stream);
}

// K7: one block of a grid-sharded field (the halo vectors beside it); the
// same ticket as K3
int ch_local_stats_f32(const void* U, const void* up, const void* dn,
                       const void* lf, const void* rt, const void* E, int bn,
                       int W, int N, int row_off, int col_off, double delx,
                       double RT, double B, double A0, double A1,
                       double threshold, void* partials, int nblocks,
                       int vec, int band, void* ticket, void* sums,
                       int prev, void* stream) {
  return launch_stats<float, true>(
      U, E, up, dn, lf, rt, bn, W, N, row_off, col_off, 1, delx, RT, B, A0,
      A1, nullptr, nullptr, threshold, partials, nblocks, vec, band, ticket,
      sums, prev, stream);
}
int ch_local_stats_f64(const void* U, const void* up, const void* dn,
                       const void* lf, const void* rt, const void* E, int bn,
                       int W, int N, int row_off, int col_off, double delx,
                       double RT, double B, double A0, double A1,
                       double threshold, void* partials, int nblocks,
                       int vec, int band, void* ticket, void* sums,
                       int prev, void* stream) {
  return launch_stats<double, true>(
      U, E, up, dn, lf, rt, bn, W, N, row_off, col_off, 1, delx, RT, B, A0,
      A1, nullptr, nullptr, threshold, partials, nblocks, vec, band, ticket,
      sums, prev, stream);
}

// K7_members: R members' blocks (R, bn, W) of grid-sharded fields, each
// with its halo vectors (up / dn: (R, W), lf / rt: (R, bn)) and its A0 /
// A1 (R doubles); nblocks: one member's grid; ticket: R counters; sums:
// (R, 5)
int ch_local_stats_members_f32(const void* U, const void* up,
                               const void* dn, const void* lf,
                               const void* rt, const void* E, int bn, int W,
                               int N, int R, int row_off, int col_off,
                               double delx, double RT, double B,
                               const void* A0s, const void* A1s,
                               double threshold, void* partials, int nblocks,
                               int vec, int band, void* ticket, void* sums,
                               int prev, void* stream) {
  return launch_stats<float, true>(
      U, E, up, dn, lf, rt, bn, W, N, row_off, col_off, R, delx, RT, B, 0.0,
      0.0, A0s, A1s, threshold, partials, nblocks, vec, band, ticket, sums,
      prev, stream);
}
int ch_local_stats_members_f64(const void* U, const void* up,
                               const void* dn, const void* lf,
                               const void* rt, const void* E, int bn, int W,
                               int N, int R, int row_off, int col_off,
                               double delx, double RT, double B,
                               const void* A0s, const void* A1s,
                               double threshold, void* partials, int nblocks,
                               int vec, int band, void* ticket, void* sums,
                               int prev, void* stream) {
  return launch_stats<double, true>(
      U, E, up, dn, lf, rt, bn, W, N, row_off, col_off, R, delx, RT, B, 0.0,
      0.0, A0s, A1s, threshold, partials, nblocks, vec, band, ticket, sums,
      prev, stream);
}

int ch_absdev_f32(const void* U, long long n, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream) {
  return launch_absdev<float>(U, n, 1, mean, partials, nblocks, sums,
                              stream);
}
int ch_absdev_f64(const void* U, long long n, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream) {
  return launch_absdev<double>(U, n, 1, mean, partials, nblocks, sums,
                               stream);
}
// member-batched K4: R fields of n elements, R means in the field type,
// partials nblocks * R doubles, sums R doubles
int ch_absdev_members_f32(const void* U, long long n, int R,
                          const void* mean, void* partials, int nblocks,
                          void* sums, void* stream) {
  return launch_absdev<float>(U, n, R, mean, partials, nblocks, sums,
                              stream);
}
int ch_absdev_members_f64(const void* U, long long n, int R,
                          const void* mean, void* partials, int nblocks,
                          void* sums, void* stream) {
  return launch_absdev<double>(U, n, R, mean, partials, nblocks, sums,
                               stream);
}

// K4_members with each member's Ra in its second pass (K11's body): rows,
// member_stride, row_offset, W as ch_row_absdev_members; ra: R doubles
int ch_absdev_ra_members_f32(const void* U, long long n, int R,
                             const void* mean, void* partials, int nblocks,
                             void* sums, const void* rows,
                             long long member_stride, long long row_offset,
                             int W, void* ra, void* stream) {
  return launch_absdev<float>(U, n, R, mean, partials, nblocks, sums, stream,
                              rows, member_stride, row_offset, W, ra);
}
int ch_absdev_ra_members_f64(const void* U, long long n, int R,
                             const void* mean, void* partials, int nblocks,
                             void* sums, const void* rows,
                             long long member_stride, long long row_offset,
                             int W, void* ra, void* stream) {
  return launch_absdev<double>(U, n, R, mean, partials, nblocks, sums,
                               stream, rows, member_stride, row_offset, W,
                               ra);
}

// cdiv (the statistics kernel's division by h and 2h) against the true
// division (float: every finite x; double: n random draws and the edges);
// out: 4 words, out[3] set to ~0 and the rest to 0 by the caller
int ch_cdiv_check_f32(double delx, void* out, void* stream) {
  cdiv_check_f32_kernel<<<132 * 8, kThreads, 0, (cudaStream_t)stream>>>(
      delx, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
int ch_cdiv_check_random_f64(double delx, long long n, long long seed,
                      const void* edges, int n_edges, void* out,
                      void* stream) {
  if (n < 0 || n_edges < 0 || (n_edges > 0 && edges == nullptr))
    return (int)cudaErrorInvalidValue;
  cdiv_check_f64_kernel<<<132 * 8, kThreads, 0, (cudaStream_t)stream>>>(
      delx, n, (unsigned long long)seed, (const double*)edges, n_edges,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}

int ch_row_absdev_members_f32(const void* U, int R, long long member_stride,
                              long long row_offset, int W, void* out,
                              void* stream) {
  return launch_row_absdev<float>(U, R, member_stride, row_offset, W, out,
                                  stream);
}
int ch_row_absdev_members_f64(const void* U, int R, long long member_stride,
                              long long row_offset, int W, void* out,
                              void* stream) {
  return launch_row_absdev<double>(U, R, member_stride, row_offset, W, out,
                                   stream);
}

// float64 only: the ozaki route is the float64 transform.  K5 is
// ch_slice_scale then ch_slice on one stream (scale: a double, inv: a
// float, both written by the first; ticket: K3's)
int ch_slice_scale_f64(const void* x, long long n, void* partials,
                       int max_blocks, void* ticket, void* scale, void* inv,
                       void* stream) {
  return launch_slice_scale(x, n, 1, partials, max_blocks, ticket, scale,
                            inv, nullptr, stream);
}
int ch_slice_f64(const void* x, const void* inv, void* out, long long n,
                 int n_slices, void* stream) {
  return launch_slice(x, inv, nullptr, nullptr, out, n, 1, n_slices,
                      stream);
}
// K5_members: R fields of n elements; partials R * max_blocks words,
// ticket R counters, scale R doubles, inv R floats; out (n_slices, R, n)
int ch_slice_scale_members_f64(const void* x, long long n, int R,
                               void* partials, int max_blocks, void* ticket,
                               void* scale, void* inv, void* stream) {
  return launch_slice_scale(x, n, R, partials, max_blocks, ticket, scale,
                            inv, nullptr, stream);
}
int ch_slice_members_f64(const void* x, const void* inv, void* out,
                         long long n, int R, int n_slices, void* stream) {
  return launch_slice(x, inv, nullptr, nullptr, out, n, R, n_slices,
                      stream);
}
// K5's one-launch path (slice_one_launch_kernel) on R fields of n
// elements: scratch 1 + R words, 0 between calls (the kernel resets
// them); scale R doubles, inv R floats, out (n_slices, R, n)
int ch_slice_one_launch_f64(const void* x, long long n, int R,
                            void* scratch, void* scale, void* inv, void* out,
                            int n_slices, void* stream) {
  return launch_slice_one_launch(x, n, R, scratch, scale, inv, out,
                                 n_slices, stream);
}
// K5 sharded: the max pass of R fields of n elements into R words of
// amax (their bits), then, from the world max of those words, the slice
// pass (ch_slice_sharded: R scales and the planes)
int ch_slice_max_f64(const void* x, long long n, int R, void* partials,
                     int max_blocks, void* ticket, void* amax,
                     void* stream) {
  return launch_slice_scale(x, n, R, partials, max_blocks, ticket, nullptr,
                            nullptr, amax, stream);
}
int ch_slice_sharded_f64(const void* x, const void* amax, void* scale,
                         void* out, long long n, int R, int n_slices,
                         void* stream) {
  return launch_slice(x, nullptr, amax, scale, out, n, R, n_slices, stream);
}

// K9, in place on U
int ch_sobol_jitter_f32(void* U, int bn, int W, const void* sv,
                        const void* shift, const void* base, int row_off,
                        int col_off, double jitter, void* stream) {
  return launch_sobol_jitter<float>(U, bn, W, sv, shift, base, row_off,
                                    col_off, jitter, stream);
}
int ch_sobol_jitter_f64(void* U, int bn, int W, const void* sv,
                        const void* shift, const void* base, int row_off,
                        int col_off, double jitter, void* stream) {
  return launch_sobol_jitter<double>(U, bn, W, sv, shift, base, row_off,
                                     col_off, jitter, stream);
}

// K10, in place on U; the next key into key_out
int ch_threefry_jitter_f32(void* U, int bn, int W, long long N, int row_off,
                           int col_off, const void* key_in, void* key_out,
                           const void* go, double jitter, void* stream) {
  return launch_threefry_jitter<float>(U, bn, W, N, row_off, col_off,
                                       key_in, key_out, go, jitter, stream);
}
int ch_threefry_jitter_f64(void* U, int bn, int W, long long N, int row_off,
                           int col_off, const void* key_in, void* key_out,
                           const void* go, double jitter, void* stream) {
  return launch_threefry_jitter<double>(U, bn, W, N, row_off, col_off,
                                        key_in, key_out, go, jitter, stream);
}

}  // extern "C"
