// Fused group pass of packed polynomial evaluation, for Hopper (sm_90a).
//
// Replaces the TPU kernel symtensor_tpu/kernels/pallas_poly.py:_group_pass.
// For every gflat group j (value block V_j of P_j rows by T_j columns, read
// in place from the packed buffer at goff[j] + p*T_j + t) and its slice
// tri_j of the triangle-monomial vector, it writes for each row p
//
//     u[0][prow_off[j] + p] = sum_t V_j[p, t] * tri_j[t]             (full)
//     u[1][prow_off[j] + p] = sum_{t < d-j} V_j[p, t] * tri_j[t]     (row)
//     u[2][prow_off[j] + p] = V_j[p, 0] * tri_j[0]                   (cell)
//
// for all d groups in ONE launch. The caller's epilogue (plain torch)
// weights the three outputs by the head monomials.
//
// What bounds it: bytes read. Each packed value is used exactly once
// (about 2 flops per 4 bytes at float32), so the kernel is a single
// streaming pass over the values. The design serves that:
//   * one pass, in place: no view copies, no transposition, no second
//     read for the row and cell reductions (both come from the same loads);
//   * rows are split into tiles by a host-built table (one block per tile),
//     so the ragged groups (T_j from 1 to d(d+1)/2, P_j up to hundreds of
//     thousands of rows) all fill the card in one launch;
//   * a row is owned by L lanes of one warp, L the largest power of two
//     <= T_j, capped at 32: wide rows read coalesced by a whole warp,
//     narrow rows pack several (or 32) rows into one warp instead of
//     idling lanes. (The TPU answered the same problem by transposing the
//     narrow groups into a copy; that copy is not needed here.)
//   * each lane segment sums kRows rows at once, so every step issues
//     kRows independent loads (enough bytes in flight per warp to stream
//     at bandwidth) and one tri_j load serves them all;
//   * every output row belongs to exactly one lane segment of one block:
//     no atomics, no cross-block sums, the same result on every run.
//
// Offsets: every element offset is int64 (a packed tensor at rank 6,
// dim 110 already holds more than 2^31 values), and the tile table is
// int64.
//
// Types: float32 and float64 storage accumulate in their own type;
// bfloat16 storage accumulates and writes float32. (The Pallas kernel
// writes its output in the storage dtype; the float32 output here keeps
// the accumulation type through the epilogue, as the JAX package's plain
// path does with preferred_element_type.)
//
// Interface: plain C functions taking device pointers, int64 sizes and a
// cudaStream_t; each returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // one block: 8 warps
constexpr int kRows = 4;           // rows each lane segment sums at once
constexpr int kTileFields = 8;     // int64 fields per tile entry

// Tile entry layout (int64): j, first row, row count, T_j, goff[j],
// toff[j] (start of tri_j), prow_off[j] (first output column of group j),
// L (lanes per row: 1, 2, 4, 8, 16 or 32).

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
group_pass_kernel(const S* __restrict__ vals, const A* __restrict__ tri,
                  const int64_t* __restrict__ tiles, int64_t dim,
                  int64_t ncols, A* __restrict__ out) {
  const int64_t* tile = tiles + kTileFields * static_cast<int64_t>(blockIdx.x);
  const int64_t j = tile[0];
  const int64_t row0 = tile[1];
  const int64_t nrows = tile[2];
  const int64_t T = tile[3];
  const int64_t goff = tile[4];
  const int64_t toff = tile[5];
  const int64_t prow = tile[6];
  const int L = static_cast<int>(tile[7]);

  const int64_t row_len = dim - j;  // tails touching j: t < d - j
  const A* __restrict__ tri_j = tri + toff;
  const int sub = threadIdx.x & (L - 1);  // lane within the row's segment
  const int seg = threadIdx.x / L;        // segment index within the block
  const int nseg = kThreads / L;

  // Each segment sums kRows rows of the group at once: kRows independent
  // loads per step keep enough bytes in flight to stream at bandwidth, and
  // one tri_j load serves all of them. The loop bound is uniform across
  // the block, so every lane reaches the shuffles below. A row past the
  // tile's end rereads the tile's first row (in bounds) and is not stored.
  for (int64_t base = 0; base < nrows; base += int64_t(nseg) * kRows) {
    const S* __restrict__ v[kRows];
    bool active[kRows];
    A part[kRows], rest[kRows], cell[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t r = base + seg + int64_t(k) * nseg;
      active[k] = r < nrows;
      v[k] = vals + goff + (row0 + (active[k] ? r : 0)) * T;
      part[k] = rest[k] = cell[k] = A(0);
    }
    int64_t t = sub;
    for (; t < row_len; t += L) {
      const A w = tri_j[t];
#pragma unroll
      for (int k = 0; k < kRows; ++k) part[k] += to_acc(v[k][t]) * w;
    }
#pragma unroll 2
    for (; t < T; t += L) {
      const A w = tri_j[t];
#pragma unroll
      for (int k = 0; k < kRows; ++k) rest[k] += to_acc(v[k][t]) * w;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (sub == 0) cell[k] = to_acc(v[k][0]) * tri_j[0];
      for (int o = L >> 1; o > 0; o >>= 1) {
        part[k] += __shfl_xor_sync(0xffffffffu, part[k], o);
        rest[k] += __shfl_xor_sync(0xffffffffu, rest[k], o);
      }
      if (active[k] && sub == 0) {
        const int64_t c = prow + row0 + base + seg + int64_t(k) * nseg;
        out[c] = part[k] + rest[k];
        out[ncols + c] = part[k];
        out[2 * ncols + c] = cell[k];
      }
    }
  }
}

template <typename S, typename A>
int launch(const void* vals, const void* tri, const void* tiles,
           int64_t ntiles, int64_t dim, int64_t ncols, void* out,
           void* stream) {
  if (ntiles <= 0 || ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  group_pass_kernel<S, A><<<static_cast<unsigned int>(ntiles), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(vals), static_cast<const A*>(tri),
      static_cast<const int64_t*>(tiles), dim, ncols, static_cast<A*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int group_pass_f32(const void* vals, const void* tri, const void* tiles,
                   int64_t ntiles, int64_t dim, int64_t ncols, void* out,
                   void* stream) {
  return launch<float, float>(vals, tri, tiles, ntiles, dim, ncols, out,
                              stream);
}

int group_pass_bf16(const void* vals, const void* tri, const void* tiles,
                    int64_t ntiles, int64_t dim, int64_t ncols, void* out,
                    void* stream) {
  return launch<__nv_bfloat16, float>(vals, tri, tiles, ntiles, dim, ncols,
                                      out, stream);
}

int group_pass_f64(const void* vals, const void* tri, const void* tiles,
                   int64_t ntiles, int64_t dim, int64_t ncols, void* out,
                   void* stream) {
  return launch<double, double>(vals, tri, tiles, ntiles, dim, ncols, out,
                                stream);
}

}  // extern "C"
