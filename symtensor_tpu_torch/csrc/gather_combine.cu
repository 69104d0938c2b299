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
//     loads. The index loads bypass L1 and are marked evict-first
//     (__ldcs), since each is read once; a and b, read many times each,
//     go through the read-only cache (__ldg);
//   * the caller plans the launch from n_out (gather_mm.launch_plan):
//     kItems (4, 2 or 1) and the threads per block are chosen so that the
//     grid has about two blocks per SM wherever n_out allows, so a small
//     n_out (tensordot's table route, n_out = 40 920) still fills the
//     card;
//   * a thread loads the indices of the next kAhead rows, then their
//     gathers, into registers before it adds them in order: the loads of
//     several r overlap, and the sum keeps the twin's order;
//   * w is staged in shared memory in chunks of kWChunk rows, so any R
//     works with a fixed shared-memory footprint;
//   * a persistent grid (as many blocks as fit on the card at once) walks
//     the output tiles;
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

constexpr int kMaxThreads = 256;           // threads per block, at most
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

template <typename S, typename A, int kItems>
__global__ void __launch_bounds__(kMaxThreads)
gather_combine_kernel(const S* __restrict__ a, const S* __restrict__ b,
                      const A* __restrict__ w,
                      const int32_t* __restrict__ idx_a,
                      const int32_t* __restrict__ idx_b, int64_t R,
                      int64_t n_out, int32_t n_a, int32_t n_b,
                      S* __restrict__ out) {
  // Rows whose loads a thread issues before their adds: 8 loads of each
  // table at 4 or 2 outputs a thread, 16 at 1 output, where the outputs
  // alone are too few to keep the memory busy.
  constexpr int kAhead = kItems == 1 ? 16 : 8 / kItems;
  __shared__ A s_w[kWChunk];
  const int nt = blockDim.x;
  const int64_t tile_n = int64_t(nt) * kItems;
  const int64_t ntiles = (n_out + tile_n - 1) / tile_n;
  // The tile loop and the chunk loop are uniform across the block, so
  // every thread reaches every barrier.
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t o0 = tile * tile_n + threadIdx.x;
    A acc[kItems];
    bool bad[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      acc[k] = A(0);
      bad[k] = false;
    }
    for (int64_t r0 = 0; r0 < R; r0 += kWChunk) {
      const int nr = static_cast<int>(R - r0 < kWChunk ? R - r0 : kWChunk);
      __syncthreads();  // the last chunk's weights are no longer read
      for (int i = threadIdx.x; i < nr; i += nt) s_w[i] = w[r0 + i];
      __syncthreads();
      for (int rr = 0; rr < nr; rr += kAhead) {
        const int m = nr - rr < kAhead ? nr - rr : kAhead;
        int32_t xa[kAhead][kItems], xb[kAhead][kItems];
        A va[kAhead][kItems], vb[kAhead][kItems];
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          const int64_t row = (r0 + rr + q) * n_out;
#pragma unroll
          for (int k = 0; k < kItems; ++k) {
            const int64_t o = o0 + int64_t(k) * nt;
            const bool live = q < m && o < n_out;
            xa[q][k] = live ? __ldcs(idx_a + row + o) : 0;
            xb[q][k] = live ? __ldcs(idx_b + row + o) : 0;
          }
        }
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
#pragma unroll
          for (int k = 0; k < kItems; ++k) {
            const bool live = q < m && o0 + int64_t(k) * nt < n_out;
            const bool ok =
                static_cast<uint32_t>(xa[q][k]) < static_cast<uint32_t>(n_a) &&
                static_cast<uint32_t>(xb[q][k]) < static_cast<uint32_t>(n_b);
            va[q][k] = ok ? to_acc(__ldg(a + xa[q][k])) : A(0);
            vb[q][k] = ok ? to_acc(__ldg(b + xb[q][k])) : A(0);
            if (live && !ok) bad[k] = true;
          }
        }
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          if (q < m) {
            const A wr = s_w[rr + q];
#pragma unroll
            for (int k = 0; k < kItems; ++k)
              acc[k] = add(acc[k], mul(mul(wr, va[q][k]), vb[q][k]));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t o = o0 + int64_t(k) * nt;
      if (o < n_out) store(out + o, bad[k] ? A(NAN) : acc[k]);
    }
  }
}

template <typename S, typename A, int kItems>
int launch_items(const void* a, const void* b, const void* w,
                 const void* idx_a, const void* idx_b, int64_t R,
                 int64_t n_out, int64_t n_a, int64_t n_b, int threads,
                 void* out, void* stream) {
  auto kernel = &gather_combine_kernel<S, A, kItems>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tile_n = int64_t(threads) * kItems;
  const int64_t ntiles = (n_out + tile_n - 1) / tile_n;
  const int64_t resident = int64_t(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned int grid =
      static_cast<unsigned int>(ntiles < resident ? ntiles : resident);
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(a), static_cast<const S*>(b),
      static_cast<const A*>(w), static_cast<const int32_t*>(idx_a),
      static_cast<const int32_t*>(idx_b), R, n_out,
      static_cast<int32_t>(n_a), static_cast<int32_t>(n_b),
      static_cast<S*>(out));
  return static_cast<int>(cudaGetLastError());
}

// items (outputs per thread: 1, 2 or 4) and threads (a multiple of 32, at
// most kMaxThreads) come from the caller's launch plan.
template <typename S, typename A>
int launch(const void* a, const void* b, const void* w, const void* idx_a,
           const void* idx_b, int64_t R, int64_t n_out, int64_t n_a,
           int64_t n_b, int items, int threads, void* out, void* stream) {
  if (R < 1 || n_out < 1 || n_a < 1 || n_b < 1 || n_a > 0x7fffffffLL ||
      n_b > 0x7fffffffLL || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return cudaErrorInvalidValue;
  switch (items) {
    case 4:
      return launch_items<S, A, 4>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                                   threads, out, stream);
    case 2:
      return launch_items<S, A, 2>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                                   threads, out, stream);
    case 1:
      return launch_items<S, A, 1>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                                   threads, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int gather_combine_f32(const void* a, const void* b, const void* w,
                       const void* idx_a, const void* idx_b, int64_t R,
                       int64_t n_out, int64_t n_a, int64_t n_b, int items,
                       int threads, void* out, void* stream) {
  return launch<float, float>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                              items, threads, out, stream);
}

int gather_combine_bf16(const void* a, const void* b, const void* w,
                        const void* idx_a, const void* idx_b, int64_t R,
                        int64_t n_out, int64_t n_a, int64_t n_b, int items,
                        int threads, void* out, void* stream) {
  return launch<__nv_bfloat16, float>(a, b, w, idx_a, idx_b, R, n_out, n_a,
                                      n_b, items, threads, out, stream);
}

int gather_combine_f16(const void* a, const void* b, const void* w,
                       const void* idx_a, const void* idx_b, int64_t R,
                       int64_t n_out, int64_t n_a, int64_t n_b, int items,
                       int threads, void* out, void* stream) {
  return launch<__half, float>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                               items, threads, out, stream);
}

int gather_combine_f64(const void* a, const void* b, const void* w,
                       const void* idx_a, const void* idx_b, int64_t R,
                       int64_t n_out, int64_t n_a, int64_t n_b, int items,
                       int threads, void* out, void* stream) {
  return launch<double, double>(a, b, w, idx_a, idx_b, R, n_out, n_a, n_b,
                                items, threads, out, stream);
}

}  // extern "C"
