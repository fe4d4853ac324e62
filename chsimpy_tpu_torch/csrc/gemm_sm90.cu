// K6 — the float32 GEMM of the DCT bake-off's 'gemm' route (ROADMAP.md
// kernel B5), C = op(A) · op(B), on Hopper's tensor cores (sm_90a).
//
// Replaces matmul / _matmul_kernel (chsimpy_tpu/ops/pallas_kernels.py:
// 133-174), the product under dct2_pallas / idct2_pallas (:177-183): float32
// operands contracted at Precision.HIGHEST with float32 accumulation.  On
// the TPU's bf16 matrix unit that is a multi-pass split of each operand; the
// Hopper counterpart is 3xTF32:
//
//   x_hi = tf32_rna(x),  x_lo = tf32_rna(x - x_hi)          (x - x_hi exact)
//   C = A_lo·B_hi + A_hi·B_lo + A_hi·B_hi   (A_lo·B_lo, ~2^-22, dropped)
//
// with every TF32 product exact in the tensor core and the sums in float32.
// One TF32 pass alone is not in the float32 class (the bake-off's
// matmul-tf32 route misses the float32 round-trip bound).
//
// Bound: 3 TF32 passes, 3 x 2MNK operations at 495 TFLOP/s (0.833 ms at
// 4096^3 on an H100 SXM at 700 W); the float32 FMA pipes alone could not go
// below 2.05 ms.  The design:
//
// * split_tf32_kernel, a first elementwise pass, writes the hi and lo
//   copies of each operand K-major (the only layout wgmma takes for .tf32
//   operands), whatever the operand's layout, zero-padded to whole tiles,
//   already cut into (128 x 32) tiles laid out as the 128-byte swizzle
//   expects: a tile of the main kernel is then one contiguous 16 KB block,
//   and any M, N, K and operand stride works (4 B + 16 B read and written
//   per element: ~0.12 ms of traffic at 4096^3).
// * gemm_tf32x3_kernel: one 128 x 128 tile of C per block of three
//   warpgroups.  Warpgroup 0 is the producer: one thread walks K in steps
//   of 32 and brings the hi and lo tiles of A and B (64 KB) into a ring of
//   three stages with bulk copies on the Tensor Memory Accelerator
//   (cp.async.bulk), completion counted on an mbarrier per stage.
//   Warpgroups 1 and 2 each own 64 rows of the tile and issue
//   wgmma.m64n128k8.f32.tf32.tf32 from shared memory: per 32-k step the
//   eight small products first, then the four hi·hi ones, into a fresh
//   tensor-core accumulator that is then added into a float32 register sum
//   (round to nearest).  The tensor core's own accumulation rounds
//   differently; its error then grows with 32 k, and the sum's with K/32.
//   Registers move from the producer to the consumers (setmaxnreg).
// * Tiles are visited in groups of 8 block rows so that the blocks in
//   flight share their A and B panels in L2.
//
// * A member axis (the ensemble's (R, N, N) stacks): batch z of a launch
//   takes operands at z times their batch strides, and an operand shared
//   by every member (stride 0: a DCT matrix or a split block) is split
//   once and read by all.  Each member's product is the one a launch of
//   its own gives, to the bit.
//
// In the solve K6 is the float32 product at --matmul-precision high (the
// TPU's 3-pass bf16, chsimpy_tpu/core/stepper.py:159-162): the matmul
// route's C·U·Cᵀ, the split route's block products, the grid and pencil
// transforms.
//
// Every mbarrier wait gives up with a trap after ~2^26 polls: a protocol
// fault then stops the kernel with an error instead of hanging the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                   // tile rows of C (and of op(A))
constexpr int kBN = 128;                   // tile columns of C
constexpr int kBK = 32;                    // k per stage: one 128-B row
constexpr int kStages = 3;
constexpr int kTileFloats = kBM * kBK;     // one (128 x 32) operand tile
constexpr int kTileBytes = kTileFloats * 4;            // 16 KB
constexpr int kStageBytes = 4 * kTileBytes;            // A hi/lo, B hi/lo
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment
constexpr int kGroupM = 8;                 // block rows per raster group
constexpr int kSplitThreads = 256;
constexpr int kGemmThreads = 384;          // producer + two consumers
static_assert(kBM == kBN, "one tile shape for both operands");

// ---------------------------------------------------------------- split

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// out holds ceil(rows/128) x KT tiles, tile (rb, kb) at
// ((rb * KT + kb) * 2) * kTileFloats: hi, then lo; batch z (blockIdx.z)
// reads X + z * x_stride and writes the next such block of tiles.  Inside a tile, element
// (r, k) sits at r*32 + ((k/4) ^ (r%8))*4 + k%4: row r is 128 B of k, and
// its 16-byte chunk c is stored at chunk c ^ (r % 8), the 128-byte swizzle
// of wgmma's operand descriptor.  Element (r, k) of op(X) is X[r*ld + k]
// when k_fastest, else X[k*ld + r]; beyond rows or K it is 0.
__global__ void __launch_bounds__(kSplitThreads)
split_tf32_kernel(const float* __restrict__ X, int rows, int K, long long ld,
                  int k_fastest, int KT, long long x_stride,
                  float* __restrict__ out) {
  __shared__ float tile[kBM][kBK + 1];
  X += (long long)blockIdx.z * x_stride;
  out += (long long)blockIdx.z * ((rows + kBM - 1) / kBM) * KT * 2
         * kTileFloats;
  const int kb = blockIdx.x;
  const int rb = blockIdx.y;
  const int r0 = rb * kBM;
  const int k0 = kb * kBK;
  if (k_fastest) {
    for (int i = threadIdx.x; i < kTileFloats; i += kSplitThreads) {
      const int r = i / kBK, k = i % kBK;
      const int gr = r0 + r, gk = k0 + k;
      tile[r][k] = (gr < rows && gk < K) ? X[(long long)gr * ld + gk] : 0.0f;
    }
  } else {
    for (int i = threadIdx.x; i < kTileFloats; i += kSplitThreads) {
      const int r = i % kBM, k = i / kBM;
      const int gr = r0 + r, gk = k0 + k;
      tile[r][k] = (gr < rows && gk < K) ? X[(long long)gk * ld + gr] : 0.0f;
    }
  }
  __syncthreads();
  float4* hi = reinterpret_cast<float4*>(
      out + ((long long)rb * KT + kb) * 2 * kTileFloats);
  float4* lo = hi + kTileFloats / 4;
  for (int q = threadIdx.x; q < kTileFloats / 4; q += kSplitThreads) {
    const int r = q >> 3;
    const int c = (q & 7) ^ (r & 7);       // the chunk stored at slot q
    float h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = tile[r][c * 4 + j];
      h[j] = tf32_rna(x);
      l[j] = tf32_rna(x - h[j]);
    }
    hi[q] = make_float4(h[0], h[1], h[2], h[3]);
    lo[q] = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// ------------------------------------------------- barriers, copies, wgmma

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// bytes (a multiple of 16) from global to shared memory on the TMA unit;
// the mbarrier counts them as they land
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma operand descriptor of a K-major tile in 128-byte swizzle: rows of
// 128 B, 8-row groups 1024 B apart (the stride byte offset); the leading
// byte offset is unused in this layout.  The tile base is 1024-B aligned;
// a k step inside the 128-B row advances the start address by 32 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma sequence
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64 x 128) (+)= A(64 x 8) · B(8 x 128), TF32 operands from shared
// memory, float32 accumulator; scale_d = 0 starts a fresh sum
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ----------------------------------------------------------------- GEMM

// As / Bs: the split operands (split_tf32_kernel) of op(A) (M x K) and
// op(B)^T (N x K), KT = ceil(K / 32) k tiles each; C row-major (M, N).
// Batch z = blockIdx.y: As / Bs advance by as_stride / bs_stride floats (0
// for an operand shared by the batch), C by c_stride.
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_tf32x3_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                   float* __restrict__ C, int M, int N, int KT,
                   long long ldc, long long as_stride, long long bs_stride,
                   long long c_stride) {
  As += (long long)blockIdx.y * as_stride;
  Bs += (long long)blockIdx.y * bs_stride;
  C += (long long)blockIdx.y * c_stride;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  // the swizzle is a function of the address: tiles sit on 1024-B bounds
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  // tile (mb, nb) of this block, in groups of kGroupM block rows
  const int MT = (M + kBM - 1) / kBM;
  const int NT = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * NT;
  const int pid = blockIdx.x;
  const int first_m = (pid / per_group) * kGroupM;
  const int rows_in_group = min(MT - first_m, kGroupM);
  const int mb = first_m + (pid % per_group) % rows_in_group;
  const int nb = (pid % per_group) / rows_in_group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const float* a_src = As + (long long)mb * KT * 2 * kTileFloats;
      const float* b_src = Bs + (long long)nb * KT * 2 * kTileFloats;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        const uint32_t phase = (uint32_t)(kt / kStages) & 1u;
        mbar_wait(smem_addr(&empty_bar[s]), phase ^ 1u);
        const uint32_t full = smem_addr(&full_bar[s]);
        mbar_expect_tx(full, kStageBytes);
        const uint32_t dst = base + s * kStageBytes;
        bulk_load(dst, a_src + (long long)kt * 2 * kTileFloats,
                  2 * kTileBytes, full);
        bulk_load(dst + 2 * kTileBytes,
                  b_src + (long long)kt * 2 * kTileFloats, 2 * kTileBytes,
                  full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const uint32_t a_rows = (uint32_t)(wg - 1) * 64 * 128;  // bytes: 64 rows
    float sum[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = acc[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      const uint32_t phase = (uint32_t)(kt / kStages) & 1u;
      mbar_wait(smem_addr(&full_bar[s]), phase);
      const uint32_t a_hi = base + s * kStageBytes + a_rows;
      const uint32_t a_lo = a_hi + kTileBytes;
      const uint32_t b_hi = base + s * kStageBytes + 2 * kTileBytes;
      const uint32_t b_lo = b_hi + kTileBytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {        // the small terms first
        wgmma_tf32(acc, sw128_desc(a_lo + 32 * j), sw128_desc(b_hi + 32 * j),
                   j > 0);
        wgmma_tf32(acc, sw128_desc(a_hi + 32 * j), sw128_desc(b_lo + 32 * j),
                   1);
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        wgmma_tf32(acc, sw128_desc(a_hi + 32 * j), sw128_desc(b_hi + 32 * j),
                   1);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      mbar_arrive(smem_addr(&empty_bar[s]));   // this stage may be refilled
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    // accumulator layout of m64nN: warp w of the warpgroup holds rows
    // 16w..16w+15; register i sits at row l/4 + 8*((i/2)%2) and column
    // (i/4)*8 + (l%4)*2 + i%2 of that band (l: the lane)
    const int t = threadIdx.x - 128 * wg;
    const int lane = t & 31;
    const int row0 = mb * kBM + (wg - 1) * 64 + (t >> 5) * 16 + (lane >> 2);
    const int col0 = nb * kBN + (lane & 3) * 2;
    const bool pairs = (ldc & 1) == 0;
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const int gm = row0 + 8 * (p & 1);
      const int gn = col0 + (p >> 1) * 8;
      if (gm >= M || gn >= N) continue;
      float* dst = C + (long long)gm * ldc + gn;
      if (pairs && gn + 1 < N) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(sum[2 * p], sum[2 * p + 1]);
      } else {
        dst[0] = sum[2 * p];
        if (gn + 1 < N) dst[1] = sum[2 * p + 1];
      }
    }
  }
}

inline int tiles(int n, int t) { return (n + t - 1) / t; }

// floats of one split operand of `rows` rows
long long split_floats(int rows, int K) {
  return 2LL * kTileFloats * tiles(K, kBK) * tiles(rows, kBM);
}

}  // namespace

extern "C" {

// float32 only: the TPU kernel contracts float32 operands.  A is (M, K),
// stored row-major with leading dimension lda, or (transA) as the
// transpose of a row-major (K, M); B likewise; C row-major (M, N).  A batch
// of `batch` products: A and B advance by stride_a / stride_b floats a
// member (0: one operand for every member), C by M * ldc.  ws: a scratch
// buffer of ch_matmul_workspace_f32(M, N, K, a_splits, b_splits) floats
// for the split operands (a_splits: batch, or 1 where stride_a is 0; b
// likewise).  Three launches on the stream: the two splits and the GEMM.
long long ch_matmul_workspace_f32(int M, int N, int K, int a_splits,
                                  int b_splits) {
  return a_splits * split_floats(M, K) + b_splits * split_floats(N, K);
}

int ch_matmul_f32(const void* A, int transA, long long lda,
                  long long stride_a, const void* B, int transB,
                  long long ldb, long long stride_b, void* C, long long ldc,
                  int M, int N, int K, int batch, void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldc < N || lda < (transA ? M : K) ||
      ldb < (transB ? K : N) || tiles(K, kBK) > 65535 ||
      tiles(M, kBM) > 65535 || tiles(N, kBN) > 65535 ||
      (long long)tiles(M, kBM) * tiles(N, kBN) > 0x7fffffffLL ||
      batch < 1 || batch > 65535 || stride_a < 0 || stride_b < 0)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t configured = cudaFuncSetAttribute(
      gemm_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (configured != cudaSuccess) return (int)configured;
  cudaStream_t s = (cudaStream_t)stream;
  const int KT = tiles(K, kBK);
  const int a_splits = stride_a ? batch : 1;
  const int b_splits = stride_b ? batch : 1;
  float* As = (float*)ws;
  float* Bs = As + a_splits * split_floats(M, K);
  // op(A) (M x K): k runs along memory unless A is a transposed view;
  // op(B)^T (N x K): k runs along memory only when B is one
  split_tf32_kernel<<<dim3(KT, tiles(M, kBM), a_splits), kSplitThreads, 0,
                      s>>>((const float*)A, M, K, lda, transA ? 0 : 1, KT,
                           stride_a, As);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_tf32_kernel<<<dim3(KT, tiles(N, kBN), b_splits), kSplitThreads, 0,
                      s>>>((const float*)B, N, K, ldb, transB ? 1 : 0, KT,
                           stride_b, Bs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_tf32x3_kernel<<<dim3(tiles(M, kBM) * tiles(N, kBN), batch),
                       kGemmThreads, kSmemBytes, s>>>(
      As, Bs, (float*)C, M, N, KT, ldc, stride_a ? split_floats(M, K) : 0,
      stride_b ? split_floats(N, K) : 0, (long long)M * ldc);
  return (int)cudaGetLastError();
}

}  // extern "C"
