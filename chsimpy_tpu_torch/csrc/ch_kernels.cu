// Hand-written Hopper kernels of the Cahn-Hilliard step (sm_90a).
//
// K1-K4 carry the step's elementwise and reduction work; the solver's DCT
// products stay torch.matmul / torch.fft (or, on the float64 ozaki route,
// torch._int_mm int8 products), as the JAX package leaves them to XLA.
// K1-K4 are templated on the field type and instantiated for float and
// double: Hopper has native FP64, so the float64 validation mode runs the
// same kernels as the float32 fast mode.  K5 slices a float64 field into
// int8 planes for the ozaki route and exists for double only.  K6 is the
// float32 GEMM of the DCT bake-off's 'gemm' route (ROADMAP.md kernel B5).
// On a grid mesh (one rank per block of the field) K7 is K3 on a block
// with halo vectors from the neighbour ranks (kernel B7), and K8 (B8) is
// K1's mu_kernel launched on the block: it has no source of its own.
//
// Plain C interface (extern "C" at the end), loaded with ctypes by
// chsimpy_tpu_torch/ops/kernels.py.  Every entry launches on the stream it
// is given, allocates nothing (the Python wrapper passes outputs and
// scratch), and returns cudaGetLastError().
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
mu_kernel(const T* __restrict__ U, T* __restrict__ out, long long n,
          T RT, T BRT, T A0, T A1) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const T u = U[i];
  const T uinv = T(1) - u;
  const T u2inv = uinv - u;
  out[i] = RT * flog(u / uinv) - BRT + (A0 + A1 * u2inv) * u2inv
           - T(2) * A1 * u * uinv;
}

// K2 — semi-implicit spectral update (eq. 12 of Ghiass et al. 2016).
// Replaces spectral_update / _update_kernel (pallas_kernels.py:108-126).
// out = (hat_U + Seig*hat_E) / CHeig.  Reads four fields and writes one:
// 336 MB per call at N=4096 f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
update_kernel(const T* __restrict__ hat_U, const T* __restrict__ hat_E,
              const T* __restrict__ Seig, const T* __restrict__ CHeig,
              T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = (hat_U[i] + Seig[i] * hat_E[i]) / CHeig[i];
}

// K3 — fused field statistics, pass 1.  Replaces stats_band_sums /
// _stats_band_kernel (pallas_kernels.py:205-258, 288-321).
// Five full-field sums: the Flory-Huggins integrand, |grad U|^2 with the
// np.gradient edge_order=1 stencil, sum U, #(U < threshold), and
// sum EnergieEut^2 (zero when E is null: the prepare path).  Terms are
// formed in the field type and accumulated in double, as the float32 stop
// predicate needs.  Reads U once from device memory (neighbour rows come
// from L1/L2) and E once: 134 MB per call at N=4096 f32.
//
// The TPU kernel carried its sums across a sequential grid; here blocks run
// in any order, so block b owns rows [b*rpb, (b+1)*rpb) and writes its five
// sums to partials[b], and reduce_columns_kernel adds the partials in a
// fixed order.  No atomics: the sums are the same on every run.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_partials_kernel(const T* __restrict__ U, const T* __restrict__ E,
                      int N, int rows_per_block, double delx, T RT, T B,
                      T A0, T A1, T threshold,
                      double* __restrict__ partials) {
  const T h = T(delx);
  const T h2 = T(2.0 * delx);
  double acc[kNStats] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, N);
  for (int r = r0; r < r1; ++r) {
    const T* row = U + (long long)r * N;
    const T* up = U + (long long)(r > 0 ? r - 1 : 0) * N;
    const T* dn = U + (long long)(r < N - 1 ? r + 1 : N - 1) * N;
    for (int j = threadIdx.x; j < N; j += kThreads) {
      const T u = row[j];
      T dux;
      if (r == 0) dux = (dn[j] - u) / h;
      else if (r == N - 1) dux = (u - up[j]) / h;
      else dux = (dn[j] - up[j]) / h2;
      T duy;
      if (j == 0) duy = (row[1] - u) / h;
      else if (j == N - 1) duy = (u - row[N - 2]) / h;
      else duy = (row[j + 1] - row[j - 1]) / h2;
      const T uinv = T(1) - u;
      const T integrand = RT * (u * (flog(u) - B) + uinv * flog(uinv))
                          + (A0 + A1 * (uinv - u)) * u * uinv;
      acc[0] += (double)integrand;
      acc[1] += (double)(dux * dux + duy * duy);
      acc[2] += (double)u;
      acc[3] += (u < threshold) ? 1.0 : 0.0;
      if (E != nullptr) {
        const T e = E[(long long)r * N + j];
        acc[4] += (double)(e * e);
      }
    }
  }
  block_sum<kNStats>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kNStats; ++k)
      partials[(long long)blockIdx.x * kNStats + k] = acc[k];
  }
}

// K7 — K3 on one rank's block of a grid-sharded field, pass 1.  Replaces
// _local_band_sums / _stats_band_kernel_sh (pallas_kernels.py:382-461),
// which fused_stats_sharded (:489-535) runs per shard.  The block U is
// (bn, W), its rows starting at global row row_off and its columns at
// col_off of the (N, N) field.  Where the stencil crosses the block's edge
// it reads the halo vectors the caller received from the neighbour ranks:
// up_row / dn_row (W each: the last row of the block above, the first row
// of the block below) and lf_col / rt_col (bn each).  The TPU caller
// concatenates four shifted (bn, W) copies of the block for its banded
// operands; here the halo is read in place, so U and E are each read once
// from device memory (neighbour rows come from L1/L2): 33.6 MB per call on
// a 2048 x 2048 float32 block (N=4096 on a 2x2 mesh).  The one-sided
// differences are keyed on the GLOBAL row and column, so the sums of all
// blocks are the whole field's.  Same schedule as K3: rows_per_block rows
// per block, float64 partials, reduce_columns_kernel in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
local_stats_partials_kernel(const T* __restrict__ U,
                            const T* __restrict__ up_row,
                            const T* __restrict__ dn_row,
                            const T* __restrict__ lf_col,
                            const T* __restrict__ rt_col,
                            const T* __restrict__ E, int bn, int W, int N,
                            int row_off, int col_off, int rows_per_block,
                            double delx, T RT, T B, T A0, T A1, T threshold,
                            double* __restrict__ partials) {
  const T h = T(delx);
  const T h2 = T(2.0 * delx);
  double acc[kNStats] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, bn);
  for (int r = r0; r < r1; ++r) {
    const T* row = U + (long long)r * W;
    const T* up = r > 0 ? U + (long long)(r - 1) * W : up_row;
    const T* dn = r < bn - 1 ? U + (long long)(r + 1) * W : dn_row;
    const int gr = r + row_off;
    for (int j = threadIdx.x; j < W; j += kThreads) {
      const T u = row[j];
      T dux;
      if (gr == 0) dux = (dn[j] - u) / h;
      else if (gr == N - 1) dux = (u - up[j]) / h;
      else dux = (dn[j] - up[j]) / h2;
      const T left = j > 0 ? row[j - 1] : lf_col[r];
      const T right = j < W - 1 ? row[j + 1] : rt_col[r];
      const int gc = j + col_off;
      T duy;
      if (gc == 0) duy = (right - u) / h;
      else if (gc == N - 1) duy = (u - left) / h;
      else duy = (right - left) / h2;
      const T uinv = T(1) - u;
      const T integrand = RT * (u * (flog(u) - B) + uinv * flog(uinv))
                          + (A0 + A1 * (uinv - u)) * u * uinv;
      acc[0] += (double)integrand;
      acc[1] += (double)(dux * dux + duy * duy);
      acc[2] += (double)u;
      acc[3] += (u < threshold) ? 1.0 : 0.0;
      if (E != nullptr) {
        const T e = E[(long long)r * W + j];
        acc[4] += (double)(e * e);
      }
    }
  }
  block_sum<kNStats>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kNStats; ++k)
      partials[(long long)blockIdx.x * kNStats + k] = acc[k];
  }
}

// K4 — sum |U - mean|, pass 1.  Replaces absdev_band_sums /
// _absdev_band_kernel (pallas_kernels.py:261-273, 348-369).
// The mean is read from device memory (written by the step's own
// finalization), so no host round trip per step.  Grid-stride over the
// flat field with a grid fixed by the caller: reads 67 MB per call at
// N=4096 f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
absdev_partials_kernel(const T* __restrict__ U, long long n,
                       const T* __restrict__ mean,
                       double* __restrict__ partials) {
  const T m = *mean;
  double acc[1] = {0.0};
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    acc[0] += (double)fabsT(U[i] - m);
  block_sum<1>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
}

// K5 — float64 field -> int8 slices for the ozaki int8 transforms.
// Replaces slice_field_pallas / _slice_kernel (chsimpy_tpu/ops/ozaki.py:
// 214-262).  Matches the plain version (ops/kernels.py slice_field_ref) bit
// for bit: split x into float32 hi = rn(x) and lo = rn(x - hi) (the double
// subtraction is exact), scale both by the power of two inv (read from
// device memory: the wrapper computes it from max|x| without a host sync),
// then run the fixed-point chain v *= 128; s = rint(v); v -= s in float32
// on each.  rintf rounds half to even, as torch.round and jnp.round do.
// The lo chain starts at slice 3 (lo * 128^3 / scale < 1/2 rounds to 0 in
// the first three).  Plane k of out gets int8(s_hi + s_lo).
//
// Bound by device-memory bandwidth: 8 bytes read and n_slices bytes written
// per element, 0.27 GB per call at N=4096 with 8 slices.  The TPU wrapper
// first writes hi and lo as two float32 arrays; Hopper has native float64,
// so the field is read once and split in registers.  Each thread takes
// kSliceElems neighbouring elements, so a warp stores 128 contiguous bytes
// per plane as one 32-bit word a thread.
constexpr int kSliceElems = 4;

__global__ void __launch_bounds__(kThreads)
slice_kernel(const double* __restrict__ x, const float* __restrict__ inv_ptr,
             signed char* __restrict__ out, long long n, int n_slices) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kSliceElems;
  if (i0 >= n) return;
  const float inv = *inv_ptr;
  const float inv_lo = inv * 2097152.0f;  // 128^3, exact: a power of two
  const int lo_skip = n_slices < 3 ? n_slices : 3;
  const int cnt = n - i0 < kSliceElems ? (int)(n - i0) : kSliceElems;
  float h[kSliceElems], l[kSliceElems];
#pragma unroll
  for (int e = 0; e < kSliceElems; ++e) {
    const double v = e < cnt ? x[i0 + e] : 0.0;
    const float hi = __double2float_rn(v);
    const float lo = __double2float_rn(v - (double)hi);
    h[e] = hi * inv;
    l[e] = lo * inv_lo;
  }
  // plane k starts at k * n: 4-byte aligned for every k when n % 4 == 0
  const bool packed = cnt == kSliceElems && n % kSliceElems == 0;
  for (int k = 0; k < n_slices; ++k) {
    unsigned int word = 0;
    signed char s8[kSliceElems];
#pragma unroll
    for (int e = 0; e < kSliceElems; ++e) {
      h[e] = h[e] * 128.0f;
      float s = rintf(h[e]);
      h[e] = h[e] - s;
      if (k >= lo_skip) {
        l[e] = l[e] * 128.0f;
        const float t = rintf(l[e]);
        l[e] = l[e] - t;
        s = s + t;
      }
      s8[e] = (signed char)(int)s;
      word |= (unsigned int)(unsigned char)s8[e] << (8 * e);
    }
    signed char* dst = out + (long long)k * n + i0;
    if (packed) {
      *reinterpret_cast<unsigned int*>(dst) = word;
    } else {
      for (int e = 0; e < cnt; ++e) dst[e] = s8[e];
    }
  }
}

// K6 — float32 GEMM, C = op(A) · op(B).  Replaces matmul / _matmul_kernel
// (chsimpy_tpu/ops/pallas_kernels.py:133-174), the product under
// dct2_pallas / idct2_pallas (:177-183): float32 operands contracted at
// Precision.HIGHEST with float32 accumulation.  Here every product and sum
// is one float32 fused multiply-add (__fmaf_rn, called explicitly: the file
// is built with -fmad=false), in k order; no TF32.
//
// Bound by FP32 FMA throughput on the SMs (67 TFLOP/s on an H100 SXM at
// 700 W): at N=4096 a product is 137 GFLOP against 201 MB of operands and
// result.  The design keeps the FMA pipes fed from registers:
// * each 256-thread block owns a 128x128 tile of C and walks K in steps of
//   8, staging an (8 x 128) slice of A and of B in shared memory (17 KB,
//   double-buffered: the next slice is loaded into registers while the
//   current one is multiplied, one barrier per step); two blocks per SM
//   (128 registers a thread, 82 KB of shared memory a block);
// * each thread keeps an 8x8 accumulator in registers, split into four 4x4
//   quadrants 64 rows and 64 columns apart, so its shared-memory reads are
//   four float4 loads per k whose addresses are contiguous across the warp
//   (no bank conflicts; the A reads are broadcasts); every 128 k it is
//   added into the thread's slots of a 64 KB sum in shared memory;
// * the global loads are coalesced for either operand layout: TA / TB pick
//   the thread-to-element map at compile time, so a transposed operand (C^T
//   of the DCT) is read in place, with no copy;
// * any M, N, K: loads beyond an edge read 0 and stores are masked.
// Tensor cores (3xTF32 mma/wgmma with TMA-fed tiles) are work for a later
// change; so is a persistent schedule.
constexpr int kGemmBM = 128;
constexpr int kGemmBN = 128;
constexpr int kGemmBK = 8;
constexpr int kGemmLoads = kGemmBM * kGemmBK / kThreads;  // per operand
// rows of the staged tiles are padded by 4 floats: a k-fastest operand
// (row-major A, transposed B) then stores its 8 k values to 8 different
// banks, and the float4 reads stay 16-byte aligned
constexpr int kGemmPad = 4;
// the register accumulator is added into a per-thread float sum in dynamic
// shared memory every kGemmFlush steps (128 k) and restarted: rounding then
// grows with 128 + K/128 serial terms instead of K (a serial k loop alone
// left ~4x cuBLAS's error at K=512)
constexpr int kGemmFlush = 16;
constexpr int kGemmSumBytes = 64 * kThreads * (int)sizeof(float);  // 64 KB

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, 2)
matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, long long lda,
                  long long ldb, long long ldc) {
  __shared__ __align__(16) float As[2][kGemmBK][kGemmBM + kGemmPad];
  __shared__ __align__(16) float Bs[2][kGemmBK][kGemmBN + kGemmPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kGemmBM;
  const int n0 = blockIdx.x * kGemmBN;

  extern __shared__ float sums[];  // 64 slots per thread, each its own
  // element i of this thread's share of a slice: (row in the tile's m or n
  // range, k within the step), with the index contiguous in memory fastest
  // across the threads
  auto a_at = [&](int i, int& m, int& k) {
    const int idx = tid + i * kThreads;
    m = TA ? idx % kGemmBM : idx / kGemmBK;
    k = TA ? idx / kGemmBM : idx % kGemmBK;
  };
  auto b_at = [&](int i, int& n, int& k) {
    const int idx = tid + i * kThreads;
    n = TB ? idx / kGemmBK : idx % kGemmBN;
    k = TB ? idx % kGemmBK : idx / kGemmBN;
  };
  float ra[kGemmLoads], rb[kGemmLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kGemmLoads; ++i) {
      int m, k, n, kb;
      a_at(i, m, k);
      b_at(i, n, kb);
      const int gm = m0 + m, gk = k0 + k, gn = n0 + n, gkb = k0 + kb;
      ra[i] = (gm < M && gk < K)
                  ? A[TA ? (long long)gk * lda + gm : (long long)gm * lda + gk]
                  : 0.0f;
      rb[i] = (gn < N && gkb < K)
                  ? B[TB ? (long long)gn * ldb + gkb
                         : (long long)gkb * ldb + gn]
                  : 0.0f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kGemmLoads; ++i) {
      int m, k, n, kb;
      a_at(i, m, k);
      b_at(i, n, kb);
      As[buf][k][m] = ra[i];
      Bs[buf][kb][n] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.0f;
      sums[(i * 8 + j) * kThreads + tid] = 0.0f;
    }

  const int steps = (K + kGemmBK - 1) / kGemmBK;
  load(0);
  stage(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * kGemmBK);
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if ((s + 1) % kGemmFlush == 0 && s + 1 < steps) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sums[(i * 8 + j) * kThreads + tid] += acc[i][j];
          acc[i][j] = 0.0f;
        }
    }
    if (s + 1 < steps) stage(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = sums[(i * 8 + j) * kThreads + tid] + acc[i][j];

  // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise with tx
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (gm >= M) continue;
    float* row = C + (long long)gm * ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      if (gn + 3 < N && ldc % 4 == 0) {
        *reinterpret_cast<float4*>(row + gn) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) row[gn + j] = acc[i][4 * h + j];
      }
    }
  }
}

// Pass 2 of K3 and K4: out[c] = sum over b of partials[b, c], one block,
// fixed order.
__global__ void __launch_bounds__(kThreads)
reduce_columns_kernel(const double* __restrict__ partials, int nrows,
                      int ncols, double* __restrict__ out) {
  for (int c = 0; c < ncols; ++c) {
    double acc[1] = {0.0};
    for (int b = threadIdx.x; b < nrows; b += kThreads)
      acc[0] += partials[(long long)b * ncols + c];
    block_sum<1>(acc);
    if (threadIdx.x == 0) out[c] = acc[0];
  }
}

inline unsigned int elementwise_blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_mu(const void* U, void* out, long long n, double RT, double BRT,
              double A0, double A1, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  mu_kernel<T><<<elementwise_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)U, (T*)out, n, T(RT), T(BRT), T(A0), T(A1));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update(const void* hat_U, const void* hat_E, const void* Seig,
                  const void* CHeig, void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  update_kernel<T><<<elementwise_blocks(n), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const T*)hat_U, (const T*)hat_E, (const T*)Seig, (const T*)CHeig,
      (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stats(const void* U, const void* E, int N, double delx, double RT,
                 double B, double A0, double A1, double threshold,
                 void* partials, int nblocks, void* sums, void* stream) {
  if (N < 2 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const int rows_per_block = (N + nblocks - 1) / nblocks;
  cudaStream_t s = (cudaStream_t)stream;
  stats_partials_kernel<T><<<nblocks, kThreads, 0, s>>>(
      (const T*)U, (const T*)E, N, rows_per_block, delx, T(RT), T(B), T(A0),
      T(A1), T(threshold), (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_columns_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, nblocks, kNStats, (double*)sums);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_local_stats(const void* U, const void* up, const void* dn,
                       const void* lf, const void* rt, const void* E, int bn,
                       int W, int N, int row_off, int col_off, double delx,
                       double RT, double B, double A0, double A1,
                       double threshold, void* partials, int nblocks,
                       void* sums, void* stream) {
  if (bn < 1 || W < 1 || N < 2 || nblocks < 1 || row_off < 0 ||
      col_off < 0 || row_off + bn > N || col_off + W > N)
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = (bn + nblocks - 1) / nblocks;
  cudaStream_t s = (cudaStream_t)stream;
  local_stats_partials_kernel<T><<<nblocks, kThreads, 0, s>>>(
      (const T*)U, (const T*)up, (const T*)dn, (const T*)lf, (const T*)rt,
      (const T*)E, bn, W, N, row_off, col_off, rows_per_block, delx, T(RT),
      T(B), T(A0), T(A1), T(threshold), (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_columns_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, nblocks, kNStats, (double*)sums);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_absdev(const void* U, long long n, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream) {
  if (n <= 0 || nblocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  absdev_partials_kernel<T><<<nblocks, kThreads, 0, s>>>(
      (const T*)U, n, (const T*)mean, (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_columns_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, nblocks, 1, (double*)sums);
  return (int)cudaGetLastError();
}

int launch_slice(const void* x, const void* inv, void* out, long long n,
                 int n_slices, void* stream) {
  if (n <= 0 || n_slices < 1 || n_slices > 8)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kSliceElems;
  slice_kernel<<<(unsigned int)((n + per_block - 1) / per_block), kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const double*)x, (const float*)inv, (signed char*)out, n, n_slices);
  return (int)cudaGetLastError();
}

template <bool TA, bool TB>
cudaError_t launch_matmul_tt(const float* A, const float* B, float* C, int M,
                             int N, int K, long long lda, long long ldb,
                             long long ldc, cudaStream_t s) {
  // above 48 KB a block's shared memory must be asked for, and the SM's
  // carve-out set to hold two such blocks (once per entry and process)
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        matmul_f32_kernel<TA, TB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSumBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        matmul_f32_kernel<TA, TB>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (configured != cudaSuccess) return configured;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  matmul_f32_kernel<TA, TB><<<grid, kThreads, kGemmSumBytes, s>>>(
      A, B, C, M, N, K, lda, ldb, ldc);
  return cudaGetLastError();
}

int launch_matmul(const void* A, int transA, long long lda, const void* B,
                  int transB, long long ldb, void* C, long long ldc, int M,
                  int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kGemmBM - 1) / kGemmBM > 65535 ||
      ldc < N || lda < (transA ? M : K) || ldb < (transB ? K : N))
    return (int)cudaErrorInvalidValue;
  const float* a = (const float*)A;
  const float* b = (const float*)B;
  float* c = (float*)C;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (transA) {
    err = transB ? launch_matmul_tt<true, true>(a, b, c, M, N, K, lda, ldb,
                                                ldc, s)
                 : launch_matmul_tt<true, false>(a, b, c, M, N, K, lda, ldb,
                                                 ldc, s);
  } else {
    err = transB ? launch_matmul_tt<false, true>(a, b, c, M, N, K, lda, ldb,
                                                 ldc, s)
                 : launch_matmul_tt<false, false>(a, b, c, M, N, K, lda, ldb,
                                                  ldc, s);
  }
  return (int)err;
}

}  // namespace

extern "C" {

int ch_mu_f32(const void* U, void* out, long long n, double RT, double BRT,
              double A0, double A1, void* stream) {
  return launch_mu<float>(U, out, n, RT, BRT, A0, A1, stream);
}
int ch_mu_f64(const void* U, void* out, long long n, double RT, double BRT,
              double A0, double A1, void* stream) {
  return launch_mu<double>(U, out, n, RT, BRT, A0, A1, stream);
}

int ch_update_f32(const void* hat_U, const void* hat_E, const void* Seig,
                  const void* CHeig, void* out, long long n, void* stream) {
  return launch_update<float>(hat_U, hat_E, Seig, CHeig, out, n, stream);
}
int ch_update_f64(const void* hat_U, const void* hat_E, const void* Seig,
                  const void* CHeig, void* out, long long n, void* stream) {
  return launch_update<double>(hat_U, hat_E, Seig, CHeig, out, n, stream);
}

int ch_stats_f32(const void* U, const void* E, int N, double delx, double RT,
                 double B, double A0, double A1, double threshold,
                 void* partials, int nblocks, void* sums, void* stream) {
  return launch_stats<float>(U, E, N, delx, RT, B, A0, A1, threshold,
                             partials, nblocks, sums, stream);
}
int ch_stats_f64(const void* U, const void* E, int N, double delx, double RT,
                 double B, double A0, double A1, double threshold,
                 void* partials, int nblocks, void* sums, void* stream) {
  return launch_stats<double>(U, E, N, delx, RT, B, A0, A1, threshold,
                              partials, nblocks, sums, stream);
}

// K7: one block of a grid-sharded field (the halo vectors beside it)
int ch_local_stats_f32(const void* U, const void* up, const void* dn,
                       const void* lf, const void* rt, const void* E, int bn,
                       int W, int N, int row_off, int col_off, double delx,
                       double RT, double B, double A0, double A1,
                       double threshold, void* partials, int nblocks,
                       void* sums, void* stream) {
  return launch_local_stats<float>(U, up, dn, lf, rt, E, bn, W, N, row_off,
                                   col_off, delx, RT, B, A0, A1, threshold,
                                   partials, nblocks, sums, stream);
}
int ch_local_stats_f64(const void* U, const void* up, const void* dn,
                       const void* lf, const void* rt, const void* E, int bn,
                       int W, int N, int row_off, int col_off, double delx,
                       double RT, double B, double A0, double A1,
                       double threshold, void* partials, int nblocks,
                       void* sums, void* stream) {
  return launch_local_stats<double>(U, up, dn, lf, rt, E, bn, W, N, row_off,
                                    col_off, delx, RT, B, A0, A1, threshold,
                                    partials, nblocks, sums, stream);
}

int ch_absdev_f32(const void* U, long long n, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream) {
  return launch_absdev<float>(U, n, mean, partials, nblocks, sums, stream);
}
int ch_absdev_f64(const void* U, long long n, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream) {
  return launch_absdev<double>(U, n, mean, partials, nblocks, sums, stream);
}

// float64 only: the ozaki route is the float64 transform
int ch_slice_f64(const void* x, const void* inv, void* out, long long n,
                 int n_slices, void* stream) {
  return launch_slice(x, inv, out, n, n_slices, stream);
}

// float32 only: the TPU kernel contracts float32 operands.  A is (M, K),
// stored row-major with leading dimension lda, or (transA) as the
// transpose of a row-major (K, M); B likewise; C row-major (M, N).
int ch_matmul_f32(const void* A, int transA, long long lda, const void* B,
                  int transB, long long ldb, void* C, long long ldc, int M,
                  int N, int K, void* stream) {
  return launch_matmul(A, transA, lda, B, transB, ldb, C, ldc, M, N, K,
                       stream);
}

}  // extern "C"
