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
// What bounds it: operations. 2 * B * n of them (3.30e12 for rank 6 at
// dim 100 and B = 1024), at float32 accuracy. On the FP32 cores (67
// TFLOP/s) that is 49 ms, and one TF32 product, which keeps 11 bits of
// each operand, loses the float32 result's accuracy. So the product is
// split-TF32 on the tensor cores: each float32 operand a becomes
// hi = tf32(a) plus lo = tf32(a - hi), both rounded to nearest, ties away
// (cvt.rna.tf32.f32's rounding; a - hi is exact), and a * b is taken as
// lo * hi + hi * lo + hi * hi, three TF32 wgmma products into the float32
// accumulators, the cross products first, as CUTLASS's 3xTF32 orders
// them. That keeps 22 bits of each operand and drops only lo * lo, about
// 2^-22 of the product. But the tensor cores' float32 additions truncate,
// so their sums drift one way, by about half a unit of the sum an
// addition: 3 * T_j / 8 additions (1 900 at T_j = 5 050) read err 5e-5 in
// the batch cell against 2.5e-6 for FP32 FMA. So no tile sums more than
// 256 columns of t on the tensor cores (kernels/batched_eval.py:
// ENTRY_COLUMNS): longer groups are cut into runs, each its own tile,
// whose sums go into float64 at its epilogue. Three TF32 products at 495
// TFLOP/s bound rank 6 at 20 ms. Besides the values (6.4 GB, read about
// once a batch), the epilogue reads M once a tile: 18.1 GB a batch at
// rank 6 before the runs. The design is a Hopper GEMM's, with the fold
// around it:
//   * output tiles run over (b, p), BM x BN, and the reduction over a run
//     of t, so K <= 256 and every tile's work is bounded. A host table
//     lists one entry per (group, BN rows, run), ordered by the run's
//     length from the largest down (kernels/batched_eval.py:tile_list); a
//     tile is an entry and one of the Bp / BM batch tiles, the batch tile
//     varying fastest, so the blocks that share a value tile run together
//     and read it, and the runs of one (group, rows) their M rows, from
//     L2. Persistent blocks (two an SM) take tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ...: largest first, so the walk balances;
//   * 256 threads, two warpgroups; each holds the sums of 64 inputs (the
//     first only, where BM < 128) by BN rows in its wgmma accumulators.
//     A stage is BK columns of t (16, or 32 for the small tiles of 32
//     rows). Its copies (cp.async, 16 bytes each) run S - 1 stages ahead,
//     S as many as two blocks an SM leave room for (2 at 128 x 128, else
//     4): tri rows as they are; value rows in 16-byte chunks from the
//     boundary at or before the stage's first column, since rows of T_j
//     floats need not be aligned;
//   * all threads split the stage in shared memory: tri as it is, the
//     values weighted by w_j(p, t) in _folded's order (v * w1, plus
//     v * w2, plus v * w3, each rounded, no FMA); each (hi, lo) goes to the
//     wgmma's K-major layout with the swizzle of a row of BK floats. No
//     folded value reaches device memory. Two stages of the split, so that
//     a warpgroup's products of stage kt - 1 run while stage kt is split;
//     two barriers a stage;
//   * tile_product is the tile's whole inner product over a stage. The
//     branch around it is on a warpgroup index the compiler knows to be
//     warp-uniform (a shuffle): taken as divergent, it made ptxas
//     serialise the wgmma (warning C7518), about 4 ms at rank 6;
//   * the epilogue: the tile's M rows are copied into shared memory in
//     whole 16-byte chunks (reads of 8 floats a row and fragment from
//     device memory thrashed the little L1 that shared memory leaves);
//     each thread weights its sums by M[b, p] (float32), the four threads
//     of a row add theirs by shuffle in float64, and one thread adds
//     x[b, j] times that to the block's float64 partial of input b
//     (scratch: one row of Bp per block, owned by one thread per b, so no
//     atomics). The last block to finish (a threadfence and a done
//     counter, as in group_pass.cu) sums the partials in block order,
//     scales by r! and writes the (B,) result. No (B, P_j) intermediate
//     exists, and two runs give the same bits;
//   * ragged edges are masked: rows past P_j and columns past the run
//     are zero, inputs past B are zero columns of tri and are not written, and
//     the split rows past BM feed sums that are never read.
//
// Tile shapes: BM in {16, 64, 128} and BN in {32, 128}, chosen by the
// wrapper from B and the groups' P_j and T_j
// (kernels/batched_eval.py:tile_shape).
//
// Interface: one plain C function taking device pointers, int64 sizes,
// r! and a cudaStream_t; it returns a cudaError_t code (0 on success)
// after its launch.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kSmemBudget = 113 * 1024;  // shared memory a block, two an SM
constexpr int kTileFields = 8;    // int64 fields of a table entry
constexpr int kHeadShift = 8;     // head code: maxel << 8 | maxrun
// Columns of t a stage: 32 for tiles of up to 64 inputs by 32 rows (fewer
// stages where the work is all in the walk), else 16.
template <int BM, int BN>
constexpr int kBKOf = BN == 32 && BM <= 64 ? 32 : 16;

// The split operands' layout, the wgmma's K-major one with the swizzle of
// a stage's row (BK floats: 64 or 128 bytes): row r at byte r * 4 BK, its
// 16-byte chunk c at chunk c ^ (bits 7 and up of the row's byte offset),
// in atoms of 8 rows aligned to their size.
template <int BK>
struct Layout {
  static constexpr int kRow = 4 * BK, kAtom = 8 * kRow;
  static_assert(BK == 16 || BK == 32, "the 64- and 128-byte swizzles");
  // Float offset of element (r, k), k a multiple of 4.
  static __device__ __forceinline__ int at(int r, int k) {
    return (r * kRow + (((k >> 2) ^ ((r * kRow >> 7) & (BK / 4 - 1))) << 4)) / 4;
  }
};

// Table entry (int64): group j, first row p0, rows np (<= BN), T_j, the
// element offset of row p0 (goff_j + p0 * T_j), tri's first row toff_j,
// and the entry's columns of t: nt of them from t0.
enum { kJ, kP0, kNp, kT, kVoff, kToff, kT0, kNt };

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

// Rows of the split tri: 64 a warpgroup, so at least 64; rows past BM are
// not written, and only sums of rows below BM are read.
template <int BM>
constexpr int kARows = BM < 64 ? 64 : BM;

// Shared memory of a block: two stages of the split operands, hi and lo
// of each, in the wgmma layout, and S stages of the copies (tri rows of BM
// inputs; value rows of BK columns, each in BK / 4 + 1 chunks from the
// 16-byte boundary at or before its first column).
template <int BM, int BN, int S>
struct Smem {
  static constexpr int kStages = S, kBK = kBKOf<BM, BN>, kChunks = kBK / 4 + 1;
  static constexpr int kAtom = Layout<kBK>::kAtom;
  alignas(kAtom) float ahi[2][kARows<BM> * kBK];
  alignas(kAtom) float alo[2][kARows<BM> * kBK];
  alignas(kAtom) float bhi[2][BN * kBK];
  alignas(kAtom) float blo[2][BN * kBK];
  float tri[S][kBK][BM];
  float vals[S][BN][4 * kChunks];
};

// The stages of copies a BM x BN tile keeps: as many as two blocks an SM
// leave room for, up to four (three in flight while one is split).
template <int BM, int BN>
using SmemOf = std::conditional_t<
    sizeof(Smem<BM, BN, 4>) <= kSmemBudget, Smem<BM, BN, 4>,
    std::conditional_t<sizeof(Smem<BM, BN, 3>) <= kSmemBudget, Smem<BM, BN, 3>,
                       Smem<BM, BN, 2>>>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The floats from p back to the 16-byte boundary at or before it.
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's groups are in flight.
template <int pending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// x rounded to nearest TF32, ties away from zero (cvt.rna.tf32.f32's
// rounding, as two integer operations), in a float32 container.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Four floats split as hi + lo, two TF32 values each, to 22 bits (x - hi
// is exact), stored as 16 bytes each.
__device__ __forceinline__ void split4(const float (&x)[4], float* hi, float* lo) {
  float h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = to_tf32(x[i]);
    l[i] = to_tf32(__fsub_rn(x[i], h[i]));
  }
  *reinterpret_cast<float4*>(hi) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(lo) = make_float4(l[0], l[1], l[2], l[3]);
}

// The wgmma descriptor of a K-major split stage at p: 8-row atoms
// kAtom bytes apart, the swizzle of BK's rows (layout type 2
// for 64 bytes, 1 for 128).
template <int BK>
__device__ __forceinline__ uint64_t descriptor(const float* p) {
  return uint64_t((smem_addr(p) & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(Layout<BK>::kAtom >> 4) << 32) | (uint64_t(BK == 16 ? 2 : 1) << 62);
}

// d += a * b over one stage: a 64 x 8 A and an N x 8 B, both K-major TF32
// in shared memory, into the warpgroup's 64 x N float32 sums.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, acc, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, acc, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}

// The tile's inner product over one split stage, split-TF32, for
// warpgroup wg's 64 rows: lo * hi, hi * lo, then hi * hi into its sums,
// committed as one group.
template <int BM, int BN, class Smem>
__device__ __forceinline__ void tile_product(const Smem& s, int buf, int wg,
                                             float (&acc)[BN / 2]) {
  constexpr int BK = Smem::kBK;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < BK; k += 8) {  // each wgmma depth, k floats into the rows
    const uint64_t ah = descriptor<BK>(s.ahi[buf] + wg * 64 * BK + k);
    const uint64_t al = descriptor<BK>(s.alo[buf] + wg * 64 * BK + k);
    const uint64_t bh = descriptor<BK>(s.bhi[buf] + k);
    const uint64_t bl = descriptor<BK>(s.blo[buf] + k);
    wgmma_tf32<BN>(acc, al, bh);
    wgmma_tf32<BN>(acc, ah, bl);
    wgmma_tf32<BN>(acc, ah, bh);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most `pending` of the warpgroup's product groups are in
// flight.
template <int pending>
__device__ __forceinline__ void products_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    batched_fold_kernel(const Args a) {
  using Shared = SmemOf<BM, BN>;
  constexpr int kStages = Shared::kStages, kBK = Shared::kBK;
  static_assert(sizeof(Shared) <= kSmemBudget, "two blocks an SM");
  constexpr int kGroups = BM == 128 ? 2 : 1;  // warpgroups with products
  constexpr int kACopies = kBK * BM / 4;      // 16 bytes of tri a copy
  constexpr int kBCopies = BN * Shared::kChunks;  // 16 bytes of values a copy
  constexpr int kBSlots = (kBCopies + kThreads - 1) / kThreads;
  constexpr int kAQuads = BM * kBK / 4, kBQuads = BN * kBK / 4;  // split quads
  static_assert(kThreads % BN == 0, "a thread's value quads on one row");
  extern __shared__ __align__(1024) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);

  // The warpgroup, known to the compiler to be the same across a warp, so
  // that the branch on it around the products is not taken as divergent
  // (which would serialise the wgmma).
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0), lane = tid & 31;
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
    const int T = static_cast<int>(e[kT]);  // a value row's length
    const int t0 = static_cast<int>(e[kT0]), nt = static_cast<int>(e[kNt]);
    const int rl = static_cast<int>(a.dim) - j;  // t < rl: the row term
    const float* tri = a.tri + (e[kToff] + t0) * a.Bp + b0;
    const float* vals = a.vals + e[kVoff] + t0;  // column t0 of row p0
    const int nk = (nt + kBK - 1) / kBK;

    // Stage kt's copies into slot kt % kStages, one group a stage (empty
    // past the last), columns k0 on of the run: tri rows, zero past the
    // run; value row n's 16-byte chunks from the boundary at or before
    // column t0 + k0 (rows of T_j floats need not be aligned), zero past np
    // rows and where a chunk starts past the run. A chunk that holds a
    // value of the row never crosses a page, so its bytes outside the row
    // are safe to read; the split leaves them.
    auto copy_stage = [&](int kt) {
      const int slot = kt % kStages, k0 = kt * kBK;
      if (kt < nk) {
        for (int q = tid; q < kACopies; q += kThreads) {
          const int k = q / (BM / 4), m = (q % (BM / 4)) * 4;
          const bool valid = k0 + k < nt;
          copy16(&s.tri[slot][k][m], valid ? tri + int64_t(k0 + k) * a.Bp + m : a.tri,
                 valid);
        }
#pragma unroll
        for (int i = 0; i < kBSlots; ++i) {
          const int q = tid + i * kThreads, n = q / Shared::kChunks;
          const int c = q % Shared::kChunks;
          if (q < kBCopies) {
            const float* first = vals + int64_t(n) * T + k0;
            const int start = 4 * c - misalign(first);  // the chunk's first column - k0
            const bool valid = n < np && k0 + start < nt;
            copy16(&s.vals[slot][n][4 * c], valid ? first + start : a.tri, valid);
          }
        }
      }
      copies_commit();
    };
#pragma unroll
    for (int kt = 0; kt < kStages - 1; ++kt) copy_stage(kt);

    // The split takes quads of 4 columns of a row: tri quad q is row q % BM,
    // columns 4 (q / BM) to 4 (q / BM) + 3; value quads likewise over BN
    // rows, so that this thread's are all on row vn, whose fold weights it
    // holds.
    const int vn = tid % BN;
    const int voff = misalign(vals + int64_t(vn) * T);  // the same at every k0
    float w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;
    if (tid < kBQuads && vn < np) {
      const int h = __ldg(a.heads + p0 + vn);
      const int run = (h >> kHeadShift) == j ? (h & ((1 << kHeadShift) - 1)) : 0;
      w1 = static_cast<float>(__ldg(a.corr + 3 * run));
      w2 = static_cast<float>(__ldg(a.corr + 3 * run + 1));
      w3 = static_cast<float>(__ldg(a.corr + 3 * run + 2));
    }

    // Stage kt from its slot into split stage kt % 2: tri as it came, the
    // values weighted by w_j(p, t) in _folded's order (v * w1, plus v * w2,
    // plus v * w3, each rounded, no FMA).
    auto split_stage = [&](int kt) {
      const int slot = kt % kStages, buf = kt & 1, k0 = kt * kBK;
#pragma unroll
      for (int i = 0; i < (kAQuads + kThreads - 1) / kThreads; ++i) {
        const int q = tid + i * kThreads, am = q % BM, ak = 4 * (q / BM);
        if (kAQuads % kThreads == 0 || q < kAQuads) {
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = s.tri[slot][ak + u][am];
          const int off = Layout<kBK>::at(am, ak);
          split4(x, s.ahi[buf] + off, s.alo[buf] + off);
        }
      }
      const bool full = k0 + kBK <= nt;  // no column past the run
      const bool rest = t0 + k0 >= rl;   // every column past the row term: w1 alone
#pragma unroll
      for (int i = 0; i < (kBQuads + kThreads - 1) / kThreads; ++i) {
        const int q = tid + i * kThreads, vk = 4 * (q / BN);
        if (kBQuads % kThreads == 0 || q < kBQuads) {
          float f[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = k0 + vk + u, t = t0 + k;
            const float v = full || k < nt ? s.vals[slot][vn][voff + vk + u] : 0.0f;
            f[u] = __fmul_rn(v, w1);
            if (!rest) {
              if (t < rl) f[u] = __fadd_rn(f[u], __fmul_rn(v, w2));
              if (t == 0) f[u] = __fadd_rn(f[u], __fmul_rn(v, w3));
            }
          }
          const int off = Layout<kBK>::at(vn, vk);
          split4(f, s.bhi[buf] + off, s.blo[buf] + off);
        }
      }
      // the products read the split stage through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

    // Stage kt is split while stages kt + 1 to kt + kStages - 1 are copied
    // and stage kt - 1's products run.
    for (int kt = 0; kt < nk; ++kt) {
      copies_wait<kStages - 2>();  // this thread's copies of stage kt
      __syncthreads();  // everyone's; kt - 1's slot and kt - 2's split free
      copy_stage(kt + kStages - 1);
      split_stage(kt);
      __syncthreads();  // split stage kt complete
      if (wg < kGroups) {
        tile_product<BM, BN>(s, kt & 1, wg, acc);
        products_wait<1>();  // stage kt - 1's products done
      }
    }
    if (wg < kGroups) products_wait<0>();
    copies_wait<0>();
    __syncthreads();  // every product done: shared memory is free

    // The tile's M rows into shared memory, 16-byte copies of each row
    // from the boundary at or before M[b, p0] (rows of N floats need not be
    // aligned), whole lines of device memory where reads of 8 floats a
    // row and fragment were not.
    constexpr int kMChunks = BN / 4 + 1;
    float (*Ms)[4 * kMChunks] = reinterpret_cast<float (*)[4 * kMChunks]>(smem);
    static_assert(sizeof(float) * BM * 4 * kMChunks <= sizeof(Shared), "M fits");
    for (int q = tid; q < BM * kMChunks; q += kThreads) {
      const int m = q / kMChunks, c = q % kMChunks;
      const int64_t b = b0 + m;
      const float* first = a.M + b * a.N + p0;
      const int start = 4 * c - misalign(first);  // the chunk's first column
      const bool valid = b < a.B && start < np;
      copy16(&Ms[m][4 * c], valid ? first + start : a.tri, valid);
    }
    copies_commit();
    copies_wait<0>();
    __syncthreads();

    // Epilogue: sum_p M[b, p] * S[b, p] over the thread's columns in
    // float32, then over the four threads of a row by shuffle in float64.
    // The wgmma layout: warp w of the group holds rows 16 w + g and
    // 16 w + g + 8 (lane 4 g + c), columns 8 q + 2 c and 8 q + 2 c + 1 of
    // each 8 in acc[4 q + 2 h + u].
    if (wg < kGroups) {
      const int g = lane >> 2, c = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wg * 64 + ((tid >> 5) & 3) * 16 + g + 8 * h;
        const int64_t b = b0 + m;
        float dot = 0.0f;
        if (m < BM && b < a.B) {
          const float* Mrow = Ms[m] + misalign(a.M + b * a.N + p0);
#pragma unroll
          for (int q = 0; q < BN / 8; ++q)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int n = 8 * q + 2 * c + u;
              if (n < np) dot = fmaf(Mrow[n], acc[4 * q + 2 * h + u], dot);
            }
        }
        double sum = dot;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (c == 0 && m < BM && b < a.B)
          part[b] += sum * double(__ldg(a.x + b * a.dim + j));
      }
    }
    __syncthreads();  // M read: shared memory free for the next tile
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
  constexpr int kSmem = sizeof(SmemOf<BM, BN>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = a.nentries * (a.Bp / BM);
  int64_t grid = int64_t(per_sm > 0 ? per_sm : 1) * sms;
  if (ntiles < grid) grid = ntiles;
  if (capacity < grid) grid = capacity;
  kernel<<<static_cast<unsigned int>(grid), kThreads, kSmem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tiles: the nentries x kTileFields (8) table of
// kernels/batched_eval.py:tile_list for
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
