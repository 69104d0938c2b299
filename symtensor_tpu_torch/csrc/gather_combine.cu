// Weighted gather-combine of the symmetrized outer product and tensordot,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel symtensor_tpu/kernels/gather_mm.py:_build_op
// (inner `kernel`). For R index rows over n_out outputs it computes
//
//     out[o] = sum_{r < R} w[r] * a[idxA[r, o]] * b[idxB[r, o]]
//
// with idxA, idxB (R, n_out) int32 row-major, a (n_a,) and b (n_b,) the
// packed operand tables, w (R,) in the accumulation type.
//
// What bounds it: the index bytes. Every (r, o) reads two int32 indices
// once (at rank-3 x rank-3 dim 30: R = 20, n_out = 1 623 160, 260 MB of
// indices) against a few tens of KB of operand values that every output
// reuses. The design serves that:
//   * each thread owns kItems outputs and loops over r, so at every r a
//     warp reads 32 neighbouring indices of a row: 128-byte coalesced
//     loads, with kItems * 2 independent loads in flight per thread. The
//     index loads bypass L1 and are marked evict-first (__ldcs), since
//     each is read once;
//   * a and b are read many times each: when both fit the block's dynamic
//     shared memory the block stages them there once, in the accumulation
//     type; otherwise they are read through the read-only cache (__ldg).
//     The caller chooses (argument `stage`); both give the same result;
//   * w is staged in shared memory in chunks of kWChunk rows, so any R
//     works with a fixed shared-memory footprint;
//   * a persistent grid (as many blocks as fit on the card at once) walks
//     the output tiles, so each block stages a and b only once;
//   * every output belongs to one thread: no atomics, the same bits on
//     every run.
//
// (The TPU kernel gathered through two-level one-hot matmuls on the MXU,
// with a 128-lane split and a cap on the source size; none of that is a
// fact of this card.)
//
// Offsets: indices are int32 (the caller guarantees n_a, n_b < 2^31);
// row offsets r * n_out are int64. An index outside [0, n) is never read
// through: its output is written as NaN instead.
//
// Types: float32 and float64 accumulate in their own type; bfloat16 and
// float16 operands accumulate in float32 and the output is rounded to
// their type (round to nearest even, as torch's .to() does). Each
// product and sum is rounded on its own, in the twin's order over r, so
// the kernel gives the plain twin's result bit for bit (16-bit outputs
// included: a fused multiply-add would move some sums across a 16-bit
// rounding boundary).
//
// Interface: plain C functions taking device pointers, int64 sizes and a
// cudaStream_t; each returns a cudaError_t code (0 on success) after its
// launch.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // one block: 8 warps
constexpr int kItems = 4;                  // outputs per thread
constexpr int kTile = kThreads * kItems;   // outputs per block and tile
constexpr int kWChunk = 1024;              // weights staged per pass over r

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }

// Products and sums rounded one by one (no FMA contraction), in the order
// of the plain twin's torch ops: (w * a) * b, then the add.
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

template <typename S, typename A, bool kStage>
__global__ void __launch_bounds__(kThreads)
gather_combine_kernel(const S* __restrict__ a, const S* __restrict__ b,
                      const A* __restrict__ w,
                      const int32_t* __restrict__ idx_a,
                      const int32_t* __restrict__ idx_b, int64_t R,
                      int64_t n_out, int32_t n_a, int32_t n_b,
                      S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* s_w = reinterpret_cast<A*>(smem);  // kWChunk weights
  A* s_a = s_w + kWChunk;               // n_a values when staged
  A* s_b = s_a + n_a;                   // n_b values when staged
  if (kStage) {
    for (int32_t i = threadIdx.x; i < n_a; i += kThreads) s_a[i] = to_acc(a[i]);
    for (int32_t i = threadIdx.x; i < n_b; i += kThreads) s_b[i] = to_acc(b[i]);
  }

  const int64_t ntiles = (n_out + kTile - 1) / kTile;
  // The tile loop and the chunk loop are uniform across the block, so
  // every thread reaches every barrier.
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t o0 = tile * kTile + threadIdx.x;
    A acc[kItems];
    bool bad[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      acc[k] = A(0);
      bad[k] = false;
    }
    for (int64_t r0 = 0; r0 < R; r0 += kWChunk) {
      const int nr = static_cast<int>(R - r0 < kWChunk ? R - r0 : kWChunk);
      __syncthreads();  // staging done / last chunk's weights no longer read
      for (int i = threadIdx.x; i < nr; i += kThreads) s_w[i] = w[r0 + i];
      __syncthreads();
#pragma unroll 2
      for (int rr = 0; rr < nr; ++rr) {
        const A wr = s_w[rr];
        const int64_t row = (r0 + rr) * n_out;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int64_t o = o0 + int64_t(k) * kThreads;
          if (o < n_out) {
            const int32_t xa = __ldcs(idx_a + row + o);
            const int32_t xb = __ldcs(idx_b + row + o);
            if (static_cast<uint32_t>(xa) < static_cast<uint32_t>(n_a) &&
                static_cast<uint32_t>(xb) < static_cast<uint32_t>(n_b)) {
              const A va = kStage ? s_a[xa] : to_acc(__ldg(a + xa));
              const A vb = kStage ? s_b[xb] : to_acc(__ldg(b + xb));
              acc[k] = add(acc[k], mul(mul(wr, va), vb));
            } else {
              bad[k] = true;
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t o = o0 + int64_t(k) * kThreads;
      if (o < n_out) store(out + o, bad[k] ? A(NAN) : acc[k]);
    }
  }
}

template <typename S, typename A>
int launch(const void* a, const void* b, const void* w, const void* idx_a,
           const void* idx_b, int64_t R, int64_t n_out, int64_t n_a,
           int64_t n_b, int stage, void* out, void* stream) {
  if (R < 1 || n_out < 1 || n_a < 1 || n_b < 1 || n_a > 0x7fffffffLL ||
      n_b > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem =
      sizeof(A) * (kWChunk + (stage ? size_t(n_a) + size_t(n_b) : 0));
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  auto kernel = stage ? &gather_combine_kernel<S, A, true>
                      : &gather_combine_kernel<S, A, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t ntiles = (n_out + kTile - 1) / kTile;
  const int64_t resident = int64_t(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned int grid =
      static_cast<unsigned int>(ntiles < resident ? ntiles : resident);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(a), static_cast<const S*>(b),
      static_cast<const A*>(w), static_cast<const int32_t*>(idx_a),
      static_cast<const int32_t*>(idx_b), R, n_out,
      static_cast<int32_t>(n_a), static_cast<int32_t>(n_b),
      static_cast<S*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gather_combine_f32(const void* a, const void* b, const void* w,
                       const void* idx_a, const void* idx_b, int64_t R,
                       int64_t n_out, int64_t n_a, int64_t n_b, int stage,
                       void* out, void* stream) {
  return launch<float, float>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                              stage, out, stream);
}

int gather_combine_bf16(const void* a, const void* b, const void* w,
                        const void* idx_a, const void* idx_b, int64_t R,
                        int64_t n_out, int64_t n_a, int64_t n_b, int stage,
                        void* out, void* stream) {
  return launch<__nv_bfloat16, float>(a, b, w, idx_a, idx_b, R, n_out, n_a,
                                      n_b, stage, out, stream);
}

int gather_combine_f16(const void* a, const void* b, const void* w,
                       const void* idx_a, const void* idx_b, int64_t R,
                       int64_t n_out, int64_t n_a, int64_t n_b, int stage,
                       void* out, void* stream) {
  return launch<__half, float>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                               stage, out, stream);
}

int gather_combine_f64(const void* a, const void* b, const void* w,
                       const void* idx_a, const void* idx_b, int64_t R,
                       int64_t n_out, int64_t n_a, int64_t n_b, int stage,
                       void* out, void* stream) {
  return launch<double, double>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                                stage, out, stream);
}

}  // extern "C"
