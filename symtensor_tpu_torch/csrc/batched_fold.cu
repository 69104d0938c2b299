// Batched evaluation of one packed rank >= 3 tensor, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the batched route
// (symtensor_tpu/kernels/poly_eval.py:poly_eval_flat_batched) to XLA's
// matmul, one per group. It was added because the port's per-group chain
// (kernels/poly_eval.py:_batched_forward, now the plain twin) issues about
// ten torch ops a group, 100 groups a rank at dim 100: the card waited on
// the host for a third of every batch and spent another fifth on copies
// and reductions around the cuBLAS GEMMs. One launch a rank computes
//
//     out[b] = r! * sum_j x[b, j] * sum_p M[b, p] * S_j[b, p]
//     S_j[b, p] = sum_t tri[toff_j + t, b] * V_j[p, t] * w_j(p, t)
//     w_j(p, t) = w1[p] + w2[p] * [t < d - j] + w3[p] * [t == 0]
//
// over all d groups: V_j the (P_j, T_j) value block of group j, read in
// place from the packed values at voff + p * T_j + t; tri the triangle
// monomials of the batch, transposed to (Ttri, Bp) and zero past B; M the
// (B, N) head monomials; (w1, w2, w3) the corrections c(q_p) at x_j = 1 of
// kernels/group_pass.py, decoded from each head's code
// (maxel * 256 + maxrun) as the evaluation mode of group_pass.cu decodes
// them. This is the fold of _batched_forward: the corrections folded into
// the values, one product, the (b, p) sums weighted by M and x.
//
// What bounds it: operations. 2 * B * n of them (3.49e12 for the
// flagship's 1.71e9 coefficients at B = 1024), in full float32, since
// TF32 products lose the float32 result's accuracy. On the FP32 cores
// (67 TFLOP/s) that is 52 ms a batch. The values are read about once per
// batch (6.8 GB, 2 ms), so the kernel is an FFMA loop, and its design is
// the classic SIMT GEMM's, with the fold around it:
//   * output tiles run over (b, p), BM x BN, and the reduction over t, so
//     K = T_j <= d (d + 1) / 2 and every tile's work is bounded. A host
//     table lists one entry per (group, BN rows), ordered by T_j from the
//     largest down (kernels/batched_eval.py:tile_list); a tile is an entry
//     and one of the Bp / BM batch tiles, the batch tile varying fastest,
//     so the blocks that share a value tile run together and read it from
//     L2. Persistent blocks (two an SM) take tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ...: largest first, so the walk balances;
//   * 256 threads, each an (BM / 16) x (BN / 16) sub-tile of the sums in
//     registers, float32 FFMA; shared memory holds two stages of BK = 8
//     columns of each operand (with 16 the 128 x 128 tile spilled past the
//     128 registers its launch bounds allow, which cost 2-8 %). tri tiles
//     are copied with cp.async (16-byte copies, zero-filled past T_j).
//     Value tiles pass through registers: each thread loads four values
//     of a row ahead of the current stage's products, weights them by
//     w_j(p, t) in _folded's order (v * w1, plus v * w2, plus v * w3, each
//     rounded, no FMA) and stores them transposed into the other stage,
//     XOR-swizzled so that neither the stores nor the 16-byte reads of the
//     products conflict on a bank. No folded value reaches device memory.
//     One barrier a stage;
//   * tile_product is the tile's whole inner product, so a later product
//     (split-TF32 on the tensor cores) replaces it alone;
//   * the epilogue stays in registers: each thread weights its sums by
//     M[b, p] (float32), the 16 threads of a row of the tile add theirs by
//     shuffle in float64, and one thread adds x[b, j] times that to the
//     block's float64 partial of input b (scratch: one row of Bp per block,
//     owned by one thread per b, so no atomics). The last block to finish (a
//     threadfence and a done counter, as in group_pass.cu) sums the
//     partials in block order, scales by r! and writes the (B,) result.
//     No (B, P_j) intermediate exists, and two runs give the same bits;
//   * ragged edges are masked: rows past P_j and columns past T_j load as
//     zero, inputs past B are zero columns of tri and are not written.
//
// Tile shapes: BM in {16, 64, 128} and BN in {32, 128}, chosen by the
// wrapper from B and the groups' P_j and T_j
// (kernels/batched_eval.py:tile_shape).
//
// Interface: one plain C function taking device pointers, int64 sizes,
// r! and a cudaStream_t; it returns a cudaError_t code (0 on success)
// after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads, each a sub-tile
constexpr int kBK = 8;            // columns of t a stage
constexpr int kQuads = kBK / 4;   // a value row's loads of 4 columns a stage
constexpr int kTileFields = 6;    // int64 fields of a table entry
constexpr int kHeadShift = 8;     // head code: maxel << 8 | maxrun

// Table entry (int64): group j, first row p0, rows np (<= BN), T_j, the
// element offset of row p0 (goff_j + p0 * T_j), tri's first row toff_j.
enum { kJ, kP0, kNp, kT, kVoff, kToff };

struct Args {
  const float* vals;      // packed values
  const float* tri;       // (Ttri, Bp) triangle monomials, zero past B
  const float* M;         // (B, N) head monomials
  const float* x;         // (B, dim) inputs
  const int32_t* heads;   // (N,) head codes
  const double* corr;     // (r - 2, 3) corrections at x_j = 1, by q
  const int64_t* tiles;   // nentries x kTileFields
  int64_t nentries, B, Bp, N, dim;
  double* partials;       // (gridDim.x, Bp) float64 scratch
  unsigned int* done;     // zero at launch, left zero
  float* out;             // (B,)
  double scale;           // r!
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The swizzle of the value stage: column n of row k is stored at
// n ^ swz(k). A warp's stores (32 / kQuads rows n, kQuads columns k) then
// hit 32 banks, and 4-aligned groups of n stay contiguous for the
// products' reads.
__device__ __forceinline__ constexpr int swz(int k) {
  return (k % kQuads) * (32 / kQuads);
}

// Logical index of a thread's i-th element along a tile side of W with T
// elements a thread (t: the thread's coordinate, 0..15). T >= 4 takes
// groups of 4, W * 4 / T apart, so that neighbouring threads read
// neighbouring 16-byte words.
template <int T, int W>
__device__ __forceinline__ int frag_index(int t, int i) {
  if constexpr (T >= 4) return (i / 4) * (W * 4 / T) + t * 4 + i % 4;
  return t * T + i;
}

// The thread's T elements of one stage row, at logical positions
// frag_index(t, .), stored swizzled by s.
template <int T, int W>
__device__ __forceinline__ void load_frag(const float* row, int t, int s,
                                          float (&v)[T]) {
  if constexpr (T >= 4) {
#pragma unroll
    for (int g = 0; g < T / 4; ++g) {
      const float4 a =
          *reinterpret_cast<const float4*>(row + g * (W * 4 / T) + ((t * 4) ^ s));
      v[4 * g] = a.x; v[4 * g + 1] = a.y; v[4 * g + 2] = a.z; v[4 * g + 3] = a.w;
    }
  } else if constexpr (T == 2) {
    const float2 a = *reinterpret_cast<const float2*>(row + ((t * 2) ^ s));
    v[0] = a.x; v[1] = a.y;
  } else {
    static_assert(T == 1, "1, 2 or a multiple of 4 elements a thread");
    v[0] = row[t ^ s];
  }
}

// The tile's inner product over one stage: acc[i][jj] += sum_k
// A[k][m_i] * B[k][n_jj], float32 FFMA, the columns of every other row
// in reverse (so consecutive products share an operand).
template <int BM, int BN>
__device__ __forceinline__ void tile_product(const float (*As)[BM],
                                             const float (*Bs)[BN], int tx,
                                             int ty,
                                             float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float a[TM], b[TN];
    load_frag<TM, BM>(As[k], ty, 0, a);
    load_frag<TN, BN>(Bs[k], tx, swz(k), b);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int jj = i % 2 ? TN - 1 - q : q;
        acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      }
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    batched_fold_kernel(const Args a) {
  constexpr int TM = BM / 16, TN = BN / 16;
  // tri stage: kBK rows of BM inputs, copied 4 floats at a time
  constexpr int kACopies = kBK * BM / 4;
  constexpr int kASlots = (kACopies + kThreads - 1) / kThreads;
  // value stage: BN rows of kBK values, loaded 4 a thread (one row each)
  constexpr int kBQuads = BN * kQuads;
  constexpr int kBSlots = (kBQuads + kThreads - 1) / kThreads;

  __shared__ __align__(16) float As[2][kBK][BM];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  double* part = a.partials + int64_t(blockIdx.x) * a.Bp;
  for (int64_t b = tid; b < a.Bp; b += kThreads) part[b] = 0.0;
  __syncthreads();

  const int64_t nbt = a.Bp / BM;
  const int64_t ntiles = a.nentries * nbt;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t* e = a.tiles + (tile / nbt) * kTileFields;
    const int64_t b0 = (tile % nbt) * BM;
    const int j = static_cast<int>(e[kJ]);
    const int64_t p0 = e[kP0];
    const int np = static_cast<int>(e[kNp]);
    const int T = static_cast<int>(e[kT]);
    const int rl = static_cast<int>(a.dim) - j;  // t < rl: the row term
    const float* tri = a.tri + e[kToff] * a.Bp + b0;

    // This thread's value rows (quad q: row q / kQuads, columns
    // q % kQuads + kQuads * i of each stage) and their weights, whose
    // loads follow the first stage's (below) so that both wait together.
    const float* vrow[kBSlots];
    float w1[kBSlots], w2[kBSlots], w3[kBSlots];
#pragma unroll
    for (int s = 0; s < kBSlots; ++s) {
      const int q = tid + s * kThreads, n = q / kQuads;
      vrow[s] = q < kBQuads && n < np ? a.vals + e[kVoff] + int64_t(n) * T : nullptr;
    }
    auto load_weights = [&]() {
#pragma unroll
      for (int s = 0; s < kBSlots; ++s) {
        w1[s] = w2[s] = w3[s] = 0.0f;
        if (vrow[s] != nullptr) {
          const int h = __ldg(a.heads + p0 + (tid + s * kThreads) / kQuads);
          const int run = (h >> kHeadShift) == j ? (h & ((1 << kHeadShift) - 1)) : 0;
          w1[s] = static_cast<float>(__ldg(a.corr + 3 * run));
          w2[s] = static_cast<float>(__ldg(a.corr + 3 * run + 1));
          w3[s] = static_cast<float>(__ldg(a.corr + 3 * run + 2));
        }
      }
    };

    auto copy_tri = [&](float (*dst)[BM], int k0) {
#pragma unroll
      for (int s = 0; s < kASlots; ++s) {
        const int q = tid + s * kThreads;
        if (q < kACopies) {
          const int k = q / (BM / 4), m = (q % (BM / 4)) * 4;
          const bool valid = k0 + k < T;
          copy16(&dst[k][m], valid ? tri + int64_t(k0 + k) * a.Bp + m : a.tri,
                 valid);
        }
      }
      copies_commit();
    };
    float v[kBSlots][4];
    auto load_vals = [&](int k0) {
      const bool inside = k0 + kBK <= T;  // no column past T_j
#pragma unroll
      for (int s = 0; s < kBSlots; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = k0 + (tid + s * kThreads) % kQuads + kQuads * i;
          v[s][i] = vrow[s] != nullptr && (inside || t < T) ? __ldg(vrow[s] + t) : 0.0f;
        }
    };
    auto store_vals = [&](float (*dst)[BN], int k0) {
      const bool rest = k0 >= rl;  // every column past the row term: w1 alone
#pragma unroll
      for (int s = 0; s < kBSlots; ++s) {
        const int q = tid + s * kThreads;
        if (q < kBQuads) {
          const int n = q / kQuads;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = q % kQuads + kQuads * i, t = k0 + k;
            float f = __fmul_rn(v[s][i], w1[s]);
            if (!rest) {
              if (t < rl) f = __fadd_rn(f, __fmul_rn(v[s][i], w2[s]));
              if (t == 0) f = __fadd_rn(f, __fmul_rn(v[s][i], w3[s]));
            }
            dst[k][n ^ swz(k)] = f;
          }
        }
      }
    };

    // The epilogue's M rows (BM rows of np floats, 128-byte lines) into L2
    // now, so that their reads from device memory overlap the products.
    constexpr int kLines = BN / 32 + 1;
    for (int q = tid; q < BM * kLines; q += kThreads) {
      const int64_t b = b0 + q / kLines;
      const int c = (q % kLines) * 32;
      if (b < a.B && c < np + 31) prefetch_l2(a.M + b * a.N + p0 + min(c, np - 1));
    }

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.0f;

    const int nk = (T + kBK - 1) / kBK;
    copy_tri(As[0], 0);
    load_vals(0);
    load_weights();
    store_vals(Bs[0], 0);
    copies_wait();
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < nk;
      if (more) {
        copy_tri(As[cur ^ 1], (kt + 1) * kBK);
        load_vals((kt + 1) * kBK);
      }
      tile_product<BM, BN>(As[cur], Bs[cur], tx, ty, acc);
      if (more) {
        store_vals(Bs[cur ^ 1], (kt + 1) * kBK);
        copies_wait();
      }
      __syncthreads();
    }

    // Epilogue: sum_p M[b, p] * S[b, p] over the thread's columns in
    // float32, then over the 16 threads of a row (lanes tx of one
    // half-warp) by shuffle in float64.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t b = b0 + frag_index<TM, BM>(ty, i);
      float dot = 0.0f;
      if (b < a.B) {
        const float* Mrow = a.M + b * a.N + p0;
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          const int n = frag_index<TN, BN>(tx, jj);
          if (n < np) dot = fmaf(__ldg(Mrow + n), acc[i][jj], dot);
        }
      }
      double sum = dot;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (tx == 0 && b < a.B) part[b] += sum * double(__ldg(a.x + b * a.dim + j));
    }
  }

  // The last block sums the partials in block order.
  __threadfence();  // this thread's partials are visible before the count
  __syncthreads();
  if (__syncthreads_or(tid == 0 && atomicAdd(a.done, 1u) == gridDim.x - 1)) {
    __threadfence();  // every other block's partials are visible
    for (int64_t b = tid; b < a.B; b += kThreads) {
      double sum = 0.0;
#pragma unroll 8
      for (unsigned int g = 0; g < gridDim.x; ++g)
        sum += __ldcg(a.partials + int64_t(g) * a.Bp + b);
      a.out[b] = static_cast<float>(sum * a.scale);
    }
    if (tid == 0) *a.done = 0;  // every block has counted: ready for the next launch
  }
}

// One launch over all tiles: the card's resident blocks, at most one per
// tile and at most `capacity` (the partials' rows the caller allocated).
template <int BM, int BN>
int launch(const Args& a, int64_t capacity, void* stream) {
  auto kernel = &batched_fold_kernel<BM, BN>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = a.nentries * (a.Bp / BM);
  int64_t grid = int64_t(per_sm > 0 ? per_sm : 1) * sms;
  if (ntiles < grid) grid = ntiles;
  if (capacity < grid) grid = capacity;
  kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tiles: the nentries x 6 table of kernels/batched_eval.py:tile_list for
// tile width bn; tri (Ttri, Bp), Bp a multiple of bm; M (B, N); x (B, dim);
// heads (N,) int32; corr (r - 2, 3) float64; partials (capacity, Bp)
// float64; done: one unsigned int, zero; out (B,) float32.
int batched_fold_f32(const void* vals, const void* tri, const void* M,
                     const void* x, const void* heads, const void* corr,
                     const void* tiles, int64_t nentries, int64_t B,
                     int64_t Bp, int64_t N, int64_t dim, int64_t bm,
                     int64_t bn, double scale, void* partials,
                     int64_t capacity, void* done, void* out, void* stream) {
  if (nentries <= 0 || B <= 0 || capacity <= 0 || Bp < B || Bp % bm != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.vals = static_cast<const float*>(vals);
  a.tri = static_cast<const float*>(tri);
  a.M = static_cast<const float*>(M);
  a.x = static_cast<const float*>(x);
  a.heads = static_cast<const int32_t*>(heads);
  a.corr = static_cast<const double*>(corr);
  a.tiles = static_cast<const int64_t*>(tiles);
  a.nentries = nentries;
  a.B = B;
  a.Bp = Bp;
  a.N = N;
  a.dim = dim;
  a.partials = static_cast<double*>(partials);
  a.done = static_cast<unsigned int*>(done);
  a.out = static_cast<float*>(out);
  a.scale = scale;
  switch (bm * 1000 + bn) {
    case 128128: return launch<128, 128>(a, capacity, stream);
    case 128032: return launch<128, 32>(a, capacity, stream);
    case 64128: return launch<64, 128>(a, capacity, stream);
    case 64032: return launch<64, 32>(a, capacity, stream);
    case 16128: return launch<16, 128>(a, capacity, stream);
    case 16032: return launch<16, 32>(a, capacity, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
