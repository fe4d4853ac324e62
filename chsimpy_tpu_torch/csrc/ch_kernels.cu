// Hand-written Hopper kernels of the Cahn-Hilliard step (sm_90a).
//
// Four kernels carry the step's elementwise and reduction work; the two
// DCT products stay torch.matmul.  Each is templated on the field type and
// instantiated for float and double: Hopper has native FP64, so the
// float64 validation mode runs the same kernels as the float32 fast mode.
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
// All four are bound by device-memory bandwidth: a few flops per element
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

int ch_absdev_f32(const void* U, long long n, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream) {
  return launch_absdev<float>(U, n, mean, partials, nblocks, sums, stream);
}
int ch_absdev_f64(const void* U, long long n, const void* mean,
                  void* partials, int nblocks, void* sums, void* stream) {
  return launch_absdev<double>(U, n, mean, partials, nblocks, sums, stream);
}

}  // extern "C"
