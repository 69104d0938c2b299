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
// for all d groups in ONE launch (the group_pass_* entries; gradients
// take this mode, since their backward needs the per-row sums).
//
// The group_eval_* entries are the same kernel in a second compile-time
// mode that also does the single-input evaluation's epilogue, which the
// TPU kernel left to jnp: where the first mode stores a row's three sums,
// it weights them in float64 and adds them to the thread's accumulator,
//
//     acc += M[p] * x[j] * (c1(q) * full + c2(q) * row + c3(q) * cell)
//
// for row p of group j (head p in colex order), with q the head's trailing
// run of j (q = maxrun[p] where maxel[p] == j, else 0) and c(q) the
// corrections of kernels/group_pass.py:corrections at x_j = 1. The
// accumulators are reduced in a fixed order: lanes by shuffle, warps
// through shared memory, one float64 partial per block, and the last block
// to finish (a threadfence and a done counter) sums the partials in block
// order and writes r! times the sum. So one float64 scalar comes out of one
// pass over the values, the same bits on every call, and nothing of the
// ΣP_j rows touches device memory.
//
// What bounds it: bytes read. Each packed value is used exactly once
// (about 2 flops per 4 bytes at float32), so the kernel is one streaming
// pass over the values, and its speed is the number of bytes it keeps in
// flight per SM. Loads issued by threads hold those bytes in registers,
// which caps them (a first version with 4 rows per lane reached 65-69 % of
// the bound in float32 and 36 % in bfloat16). This design keeps them in
// shared memory instead, with Hopper's bulk copies:
//   * a TILE is one contiguous span of the values: as many whole rows
//     row0 .. row0+nrows of group j as fill a stage, or, for a row longer
//     than a stage, one column range of one row. A host-built int64 table
//     lists the tiles (kTileFields fields each), then where each chunk of
//     kChunk tiles starts;
//   * one elected thread of a producer warp copies each tile's 16-byte
//     aligned interior with one 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx::bytes) into one stage of a
//     ring of kStages stages in dynamic shared memory, keeping
//     kStages - 1 tiles in flight; the copy engine, not registers, holds
//     the bytes in flight;
//   * the producer warp's lanes load the table entries kEntryAhead tiles
//     ahead and each tile's head and tail fragments (the <= 15 bytes
//     before the first and after the last 16-byte boundary) kFragAhead
//     tiles ahead with ordinary loads, and store the fragments beside the
//     interior. No load latency sits in the producer's loop, nothing
//     outside the tile is read, and `vals` need not be 16-byte aligned.
//     Misaligned row starts stop mattering, since rows are read from
//     shared memory;
//   * sixteen consumer warps wait on the stage's full barrier
//     (mbarrier.try_wait.parity), reduce, and each releases the stage on
//     its empty barrier. tri_j is staged in shared memory once (per column
//     range for split rows), never reloaded per step from global memory;
//   * inside a stage, L lanes own a row and the row/rest split is at
//     d - j. L is the largest power of two <= T_j / 32 (at least 1, at
//     most 32; the tile table's field): each lane sums 32 or more values
//     of a row where T_j allows, so that the shuffle steps that end each
//     row stay few. bfloat16 stages hold raw bfloat16 bytes, converted to
//     float32 on the read.
//     Whole-row tiles need no barrier among the consumers: a warp past the
//     tile's last row releases it at once and goes on to the next stage,
//     and the first row of each tile goes to the warp after the last one
//     the previous tile used, so tiles of a few wide rows are reduced by
//     different warps at the same time;
//   * a row split across tiles is reduced by the whole block, and its
//     three partial sums are carried in registers of consumer thread 0
//     from piece to piece, so any dim works;
//   * a persistent grid (the resident blocks of the card) walks the
//     chunks: block b takes chunks b, b + grid, ...; the host starts every
//     chunk at a row's first piece, so a split row stays in one block.
//     Every output belongs to one block and one lane, no atomics on the
//     sums (the evaluation mode's one counter only finds the last block),
//     the same bits on every run.
//
// Offsets: every element offset is int64 (a packed tensor at rank 6,
// dim 110 holds more than 2^31 values), and the tile table is int64.
//
// Types: float32 and float64 storage accumulate in their own type;
// bfloat16 storage accumulates and writes float32. The evaluation mode
// converts each row's three sums to float64 before it weights them.
//
// Interface: plain C functions taking device pointers, int64 sizes and a
// cudaStream_t; each returns a cudaError_t code (0 on success) after its
// launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;    // threads that reduce
constexpr int kThreads = kConsumers + 32;          // plus one producer warp
constexpr int kStages = 4;                         // ring depth
constexpr int kStageBytes = 32 * 1024;             // values per stage
constexpr int kStageAlloc = kStageBytes + 32;      // + head and tail pads
constexpr int kTriBytes = 40 * 1024;               // tri, or a slice of it
constexpr int kTileFields = 12;                    // int64 fields per tile
constexpr int kDescFields = 16;                    // a stage's entry + valid
constexpr int kValid = kTileFields;                // 0: no more tiles
constexpr int kChunk = 8;                          // tiles a block takes in turn
constexpr int kEntryAhead = 8;                     // table entries loaded ahead
constexpr int kFragAhead = 4;                      // fragments loaded ahead
constexpr int kBarId = 1;                          // consumers' named barrier

// Tile entry (int64): j, row0, nrows, c0, c1, T, start, count, toff, prow,
// L, flags. The tile covers columns [c0, c1) of rows row0 .. row0+nrows of
// group j; start is the element offset of its first value and count its
// number of values (nrows * T for whole rows, c1 - c0 for a piece); flags
// bit 0 marks a row's first piece and bit 1 its last (both for whole
// rows).
enum { kJ, kRow0, kNrows, kC0, kC1, kT, kStart, kCount, kToff, kProw, kL,
       kFlags };

// Shared-memory layout: the ring, tri (whole, or the tile's slice), the
// tile entry of each stage, each stage's per-warp partial sums (for split
// rows), the evaluation mode's per-warp float64 sums, the barriers.
constexpr int kTriOff = kStages * kStageAlloc;
constexpr int kDescOff = kTriOff + kTriBytes;
constexpr int kRedOff = kDescOff + kStages * kDescFields * 8;
constexpr int kEvalOff = kRedOff + kStages * kConsumerWarps * 2 * 8;
constexpr int kBarOff = kEvalOff + kConsumerWarps * 8;
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;

// What the evaluation mode reads beyond the values and tri, and where it
// writes. M: the head monomials (N_{r-3} float64, colex); heads: per head
// maxel * 256 + maxrun (int32; maxel = -1 for rank 3's empty head); x: the
// input (d float64); corr: c1, c2, c3 for q = 0 .. r-3 (float64);
// partials: one float64 per block; done: the counter of finished blocks,
// zero at launch and set back to zero by the last block, so the caller
// keeps one work buffer per stream; result: r! times the sum (scale = r!).
struct Eval {
  const double* M;
  const int32_t* heads;
  const double* x;
  const double* corr;
  double* partials;
  unsigned int* done;
  double* result;
  double scale;
};

// What weights row p of group j: M[p] and heads[p], whose loads are
// issued before the row's sums and first used after them. A warp stalls
// only where it uses a load's result, and the warps of a stage start
// their rows together: a use before the sums (M[p] x_j, or the corrections'
// row, which depends on heads[p]) would stall them all at once.
struct Weights {
  double m = 0.0;
  int32_t h = 0;

  __device__ __forceinline__ void load(const Eval& ev, int64_t p) {
    m = __ldg(ev.M + p);
    h = __ldg(ev.heads + p);
  }

  // (M[p] x_j) (c1 full + c2 row + c3 cell) with c the corrections of the
  // head's trailing run q of j, the sums taken to float64
  template <typename A>
  __device__ __forceinline__ double of(const Eval& ev, int64_t j, double xj,
                                       A full, A row, A cell) const {
    const double* c = ev.corr + 3 * ((h >> 8) == j ? (h & 255) : 0);
    return (m * xj) * (__ldg(c) * double(full) + __ldg(c + 1) * double(row)
                       + __ldg(c + 2) * double(cell));
  }
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity has completed. On a fresh
// barrier, parity 1 counts as completed (the producer's first pass).
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Generic-proxy writes to shared memory, ordered before later bulk copies
// into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;" :: "n"(kBarId), "n"(kConsumers) : "memory");
}

// How a span of `count` elements at `p` splits: the interior
// [a0, a1) between its first and last 16-byte boundary goes by bulk copy;
// elements [0, head) and [tail0, count) are fragments. In the stage, the
// byte at address x of the span sits at 16 + (x - a0): the head fills the
// pad before the interior, the tail the pad after it.
struct Split {
  int head;        // elements before the interior (or the whole span)
  int tail0;       // first element after the interior
  uint32_t bytes;  // interior bytes (a multiple of 16, possibly 0)
  int base;        // stage byte offset of element 0
};

template <typename S>
__device__ __forceinline__ Split split_span(const S* p, int64_t count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t e = a + uintptr_t(count) * sizeof(S);
  const uintptr_t a0 = (a + 15) & ~uintptr_t(15);
  const uintptr_t a1 = e & ~uintptr_t(15);
  Split s;
  const uintptr_t h = a0 < e ? a0 : e;
  s.head = static_cast<int>((h - a) / sizeof(S));
  s.bytes = a1 > a0 ? static_cast<uint32_t>(a1 - a0) : 0u;
  s.tail0 = a1 > a0 ? static_cast<int>((a1 - a) / sizeof(S)) : s.head;
  s.base = 16 - static_cast<int>(a0 - a);
  return s;
}

// Whole rows of one tile: L lanes per row, kConsumers / L rows a pass.
// `slot` is the warp's place in the pass (the tile's first row goes to
// slot 0). A warp whose first row of a pass lies past the tile's end is
// done; in a live warp, a row past the end rereads row 0 and is neither
// stored nor weighted, so every lane of the warp reaches the shuffles.
// Without kEval a row's sums go to out at column prow + r; with it, row
// p = row0 + r of group j is weighted into acc (its Weights loaded before
// the row's sums, so that their latency hides behind them).
template <int L, bool kEval, typename S, typename A>
__device__ __forceinline__ void whole_rows(const S* sv, const A* tri_t,
                                           int nrows, int T, int row_len,
                                           int64_t prow, int64_t ncols,
                                           A* __restrict__ out,
                                           const Eval& ev, int64_t j,
                                           int64_t row0, double xj,
                                           double& acc, int slot, int lane) {
  constexpr int kSeg = kConsumers / L;
  const int sub = lane & (L - 1);
  const int r_in = (slot * 32 + lane) / L;
  for (int base = 0; base + slot * (32 / L) < nrows; base += kSeg) {
    const int r = base + r_in;
    const S* v = sv + (r < nrows ? r : 0) * T;
    Weights w;
    if constexpr (kEval) {
      if (r < nrows && sub == 0) w.load(ev, row0 + r);
    }
    A part = A(0), rest = A(0), rest2 = A(0);
    int t = sub;
    for (; t < row_len; t += L) part += to_acc(v[t]) * tri_t[t];
    // two sums in turn, so that a long row is not one chain of adds
    for (; t + L < T; t += 2 * L) {
      rest += to_acc(v[t]) * tri_t[t];
      rest2 += to_acc(v[t + L]) * tri_t[t + L];
    }
    if (t < T) rest += to_acc(v[t]) * tri_t[t];
    rest += rest2;
#pragma unroll
    for (int o = L >> 1; o > 0; o >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
      rest += __shfl_xor_sync(0xffffffffu, rest, o);
    }
    if (r < nrows && sub == 0) {
      if constexpr (kEval) {
        acc += w.of(ev, j, xj, part + rest, part, to_acc(v[0]) * tri_t[0]);
      } else {
        const int64_t c = prow + r;
        out[c] = part + rest;
        out[ncols + c] = part;
        out[2 * ncols + c] = to_acc(v[0]) * tri_t[0];
      }
    }
  }
}

template <typename S, typename A, bool kEval>
__global__ void __launch_bounds__(kThreads, 1)
group_pass_kernel(const S* __restrict__ vals, const A* __restrict__ tri,
                  const int64_t* __restrict__ tiles, int64_t ntiles,
                  int64_t dim, int64_t ncols, A* __restrict__ out,
                  const Eval ev) {
  extern __shared__ __align__(128) unsigned char smem[];
  A* tri_s = reinterpret_cast<A*>(smem + kTriOff);
  int64_t* desc = reinterpret_cast<int64_t*>(smem + kDescOff);
  A* red = reinterpret_cast<A*>(smem + kRedOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // tri whole in shared memory when it fits (dim <= 100 in float64, 142 in
  // float32): staged once, never reloaded. Otherwise each tile's slice.
  const int64_t ntri = dim * (dim + 1) / 2;
  const bool tri_whole = ntri * int64_t(sizeof(A)) <= kTriBytes;
  if (tri_whole)
    for (int64_t t = threadIdx.x; t < ntri; t += kThreads) tri_s[t] = tri[t];
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---------------------------------------------------------- producer
    // The block takes chunks blockIdx.x, blockIdx.x + gridDim.x, ...; the
    // table ends with the first tile of every chunk (nchunks + 1 entries).
    // The bounds of the block's next chunk are loaded on entering a chunk.
    const int64_t nchunks = (ntiles + kChunk - 1) / kChunk;
    const int64_t* cstart = tiles + ntiles * kTileFields;
    int64_t t = 0, tend = 0;                   // the current chunk's tiles
    int64_t next = blockIdx.x, n0 = 0, n1 = 0;  // the next chunk's
    if (next < nchunks) {
      n0 = cstart[next];
      n1 = cstart[next + 1];
    }
    auto next_tile = [&]() -> int64_t {
      while (t >= tend && next < nchunks) {
        t = n0;
        tend = n1;
        next += gridDim.x;
        if (next < nchunks) {
          n0 = cstart[next];
          n1 = cstart[next + 1];
        }
      }
      return t < tend ? t++ : int64_t(-1);
    };
    // Lane f < kTileFields holds field f of an entry, lane kValid whether
    // there is one (0 past the block's last tile).
    auto entry = [&]() -> int64_t {
      const int64_t k = next_tile();
      if (k < 0) return 0;
      return lane < kTileFields ? tiles[k * kTileFields + lane]
                                : int64_t(lane == kValid);
    };
    // Lane k < 16 loads head element k, lane 16 + k tail element
    // tail0 + k; `at` is its stage byte offset, or -1.
    auto fragment = [&](int64_t e, S& v, int& at) {
      const bool live = __shfl_sync(0xffffffffu, e, kValid) != 0;
      const int64_t start = __shfl_sync(0xffffffffu, e, kStart);
      const int64_t count = __shfl_sync(0xffffffffu, e, kCount);
      at = -1;
      if (!live) return;
      const Split sp = split_span(vals + start, count);
      const int k = lane < 16 ? lane : sp.tail0 + (lane - 16);
      if ((lane < 16 && k < sp.head) || (lane >= 16 && k < count)) {
        v = vals[start + k];
        at = sp.base + k * static_cast<int>(sizeof(S));
      }
    };
    // e[q] is the entry of the q-th tile from now, f[q] / at[q] its
    // fragments (q < kFragAhead). Each load is first used kEntryAhead -
    // kFragAhead or kFragAhead - 1 tiles after it was issued.
    int64_t e[kEntryAhead];
    S f[kFragAhead];
    int at[kFragAhead];
#pragma unroll
    for (int q = 0; q < kEntryAhead; ++q) e[q] = entry();
#pragma unroll
    for (int q = 0; q < kFragAhead; ++q) fragment(e[q], f[q], at[q]);
    for (int64_t i = 0;; ++i) {
      const int s = static_cast<int>(i % kStages);
      const uint32_t round = static_cast<uint32_t>(i / kStages);
      const bool valid = __shfl_sync(0xffffffffu, e[0], kValid) != 0;
      const int64_t start = __shfl_sync(0xffffffffu, e[0], kStart);
      const int64_t count = __shfl_sync(0xffffffffu, e[0], kCount);
      bar_wait(&empty[s], (round & 1) ^ 1);
      unsigned char* stage = smem + s * kStageAlloc;
      if (lane <= kValid) desc[s * kDescFields + lane] = e[0];
      if (at[0] >= 0) {
        *reinterpret_cast<S*>(stage + at[0]) = f[0];
        fence_proxy_async();  // a later bulk copy may overwrite these bytes
      }
      __syncwarp();
      if (lane == 0) {
        const Split sp = split_span(vals + start, count);
        if (valid && sp.bytes) {
          bar_arrive_tx(&full[s], sp.bytes);
          bulk_copy(stage + 16, vals + start + sp.head, sp.bytes, &full[s]);
        } else {
          bar_arrive(&full[s]);  // no interior, or the end mark
        }
      }
      if (!valid) return;
#pragma unroll
      for (int q = 0; q + 1 < kEntryAhead; ++q) e[q] = e[q + 1];
      e[kEntryAhead - 1] = entry();
#pragma unroll
      for (int q = 0; q + 1 < kFragAhead; ++q) {
        f[q] = f[q + 1];
        at[q] = at[q + 1];
      }
      fragment(e[kFragAhead - 1], f[kFragAhead - 1], at[kFragAhead - 1]);
    }
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x;
  int64_t tri_j = -1, tri_c0 = -1;  // the slice in tri_s, if not whole
  int rot = 0;                      // the warp that takes a tile's first row
  A carry_full = A(0), carry_row = A(0), carry_cell = A(0);
  double acc = 0.0;  // the evaluation mode's weighted rows
  for (int64_t i = 0;; ++i) {
    const int s = static_cast<int>(i % kStages);
    bar_wait(&full[s], static_cast<uint32_t>(i / kStages) & 1);
    const int64_t* d = desc + s * kDescFields;
    if (!d[kValid]) break;
    const int64_t j = d[kJ], row0 = d[kRow0];
    const int64_t c0 = d[kC0], c1 = d[kC1];
    const int64_t start = d[kStart], count = d[kCount];
    const int64_t flags = d[kFlags];
    const int64_t prow = d[kProw] + row0;
    const A* tri_t = tri_s + (tri_whole ? d[kToff] + c0 : 0);
    if (!tri_whole && (j != tri_j || c0 != tri_c0)) {
      consumers_sync();  // every consumer is done with the old slice
      for (int64_t t = c0 + tid; t < c1; t += kConsumers)
        tri_s[t - c0] = tri[d[kToff] + t];
      consumers_sync();
      tri_j = j;
      tri_c0 = c0;
    }
    const S* sv = reinterpret_cast<const S*>(
        smem + s * kStageAlloc + split_span(vals + start, count).base);
    const int row_len = static_cast<int>(dim - j - c0);  // row part, local
    const double xj = kEval ? __ldg(ev.x + j) : 0.0;

    if ((flags & 3) == 3) {
      const int nrows = static_cast<int>(d[kNrows]);
      const int T = static_cast<int>(d[kT]);
      const int L = static_cast<int>(d[kL]);
      const int slot = (warp - rot + kConsumerWarps) % kConsumerWarps;
#define GP_ROWS(L_) \
  whole_rows<L_, kEval>(sv, tri_t, nrows, T, row_len, prow, ncols, out, ev, \
                        j, row0, xj, acc, slot, lane)
      switch (L) {
        case 1: GP_ROWS(1); break;
        case 2: GP_ROWS(2); break;
        case 4: GP_ROWS(4); break;
        case 8: GP_ROWS(8); break;
        case 16: GP_ROWS(16); break;
        default: GP_ROWS(32); break;
      }
#undef GP_ROWS
      // the next tile starts at the warp after the last one this one used
      const int per_warp = 32 / L, per_pass = kConsumers / L;
      rot = (rot + (nrows - 1) % per_pass / per_warp + 1) % kConsumerWarps;
    } else {
      // One piece of a split row: the whole block reduces columns
      // [c0, c1); consumer thread 0 carries the sums across pieces. Each
      // stage's partials are rewritten only after every consumer warp has
      // released the stage, so reading them after the sync is safe.
      A* rb = red + s * kConsumerWarps * 2;
      const int w = static_cast<int>(c1 - c0);
      A part = A(0), rest = A(0);
      for (int t = tid; t < w; t += kConsumers) {
        const A x = to_acc(sv[t]) * tri_t[t];
        if (t < row_len) part += x; else rest += x;
      }
      for (int o = 16; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
        rest += __shfl_xor_sync(0xffffffffu, rest, o);
      }
      if (lane == 0) {
        rb[2 * warp] = part;
        rb[2 * warp + 1] = rest;
      }
      if (tid == 0 && (flags & 1)) {
        carry_full = carry_row = A(0);
        carry_cell = to_acc(sv[0]) * tri_t[0];
      }
      consumers_sync();
      if (tid == 0) {
        for (int k = 0; k < kConsumerWarps; ++k) {
          carry_full += rb[2 * k] + rb[2 * k + 1];
          carry_row += rb[2 * k];
        }
        if (flags & 2) {  // the row's last piece: p = row0
          if constexpr (kEval) {
            Weights wt;
            wt.load(ev, row0);
            acc += wt.of(ev, j, xj, carry_full, carry_row, carry_cell);
          } else {
            out[prow] = carry_full;
            out[ncols + prow] = carry_row;
            out[2 * ncols + prow] = carry_cell;
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of the stage are done
    if (lane == 0) bar_arrive(&empty[s]);
  }

  if constexpr (kEval) {
    // Fixed-order reduction: lanes by shuffle, the warps' sums by warp 0
    // in shared memory, one partial per block; the last block to finish
    // sums the partials (lane k takes blocks k, k + 32, ...; then a
    // shuffle) and writes r! times the sum.
    double* wsum = reinterpret_cast<double*>(smem + kEvalOff);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) wsum[warp] = acc;
    consumers_sync();
    if (warp == 0) {
      double b = lane < kConsumerWarps ? wsum[lane] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) b += __shfl_xor_sync(0xffffffffu, b, o);
      unsigned int last = 0;
      if (lane == 0) {
        ev.partials[blockIdx.x] = b;
        __threadfence();  // the partial is visible before the count
        last = atomicAdd(ev.done, 1u) == gridDim.x - 1;
      }
      if (__shfl_sync(0xffffffffu, last, 0)) {
        __threadfence();  // every other block's partial is visible
        double sum = 0.0;
        for (unsigned int k = lane; k < gridDim.x; k += 32)
          sum += __ldcg(ev.partials + k);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          *ev.result = sum * ev.scale;
          *ev.done = 0;  // every block has counted: ready for the next launch
        }
      }
    }
  }
}

// One launch over all tiles. The grid is the card's resident blocks, at
// most one per chunk, and in the evaluation mode at most `capacity` (the
// partials the caller allocated).
template <typename S, typename A, bool kEval>
int launch(const void* vals, const void* tri, const void* tiles,
           int64_t ntiles, int64_t dim, int64_t ncols, void* out,
           const Eval& ev, int64_t capacity, void* stream) {
  if (ntiles <= 0 || (kEval && capacity <= 0)) return cudaErrorInvalidValue;
  auto kernel = &group_pass_kernel<S, A, kEval>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nchunks = (ntiles + kChunk - 1) / kChunk;
  int64_t grid = int64_t(per_sm > 0 ? per_sm : 1) * sms;
  if (nchunks < grid) grid = nchunks;
  if (kEval && capacity < grid) grid = capacity;
  kernel<<<static_cast<unsigned int>(grid), kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(vals), static_cast<const A*>(tri),
      static_cast<const int64_t*>(tiles), ntiles, dim, ncols,
      static_cast<A*>(out), ev);
  return static_cast<int>(cudaGetLastError());
}

// The evaluation mode's inputs; `work` holds capacity float64 partials,
// then the done counter in the first 4 bytes of one more slot (zero).
Eval eval_args(const void* M, const void* heads, const void* x,
               const void* corr, double scale, void* work, int64_t capacity,
               void* result) {
  Eval ev;
  ev.M = static_cast<const double*>(M);
  ev.heads = static_cast<const int32_t*>(heads);
  ev.x = static_cast<const double*>(x);
  ev.corr = static_cast<const double*>(corr);
  ev.partials = static_cast<double*>(work);
  ev.done = reinterpret_cast<unsigned int*>(static_cast<double*>(work) +
                                            capacity);
  ev.result = static_cast<double*>(result);
  ev.scale = scale;
  return ev;
}

}  // namespace

extern "C" {

// `tiles` holds the ntiles x kTileFields table, then the first tile of
// each of the ceil(ntiles / kChunk) chunks and ntiles
// (kernels/group_pass.py: tile_table, chunk_starts).
int group_pass_f32(const void* vals, const void* tri, const void* tiles,
                   int64_t ntiles, int64_t dim, int64_t ncols, void* out,
                   void* stream) {
  return launch<float, float, false>(vals, tri, tiles, ntiles, dim, ncols,
                                     out, Eval{}, 0, stream);
}

int group_pass_bf16(const void* vals, const void* tri, const void* tiles,
                    int64_t ntiles, int64_t dim, int64_t ncols, void* out,
                    void* stream) {
  return launch<__nv_bfloat16, float, false>(vals, tri, tiles, ntiles, dim,
                                             ncols, out, Eval{}, 0, stream);
}

int group_pass_f64(const void* vals, const void* tri, const void* tiles,
                   int64_t ntiles, int64_t dim, int64_t ncols, void* out,
                   void* stream) {
  return launch<double, double, false>(vals, tri, tiles, ntiles, dim, ncols,
                                       out, Eval{}, 0, stream);
}

// The evaluation mode: the same tiles, then M, heads, x, corr and r! as
// the Eval struct describes them, `work` (capacity + 1 float64, the last
// zero at launch and left zero) and the float64 result.
#define GROUP_EVAL(name, S, A)                                               \
  int name(const void* vals, const void* tri, const void* tiles,             \
           int64_t ntiles, int64_t dim, const void* M, const void* heads,    \
           const void* x, const void* corr, double scale, void* work,        \
           int64_t capacity, void* result, void* stream) {                   \
    return launch<S, A, true>(                                               \
        vals, tri, tiles, ntiles, dim, 0, nullptr,                           \
        eval_args(M, heads, x, corr, scale, work, capacity, result),         \
        capacity, stream);                                                   \
  }

GROUP_EVAL(group_eval_f32, float, float)
GROUP_EVAL(group_eval_bf16, __nv_bfloat16, float)
GROUP_EVAL(group_eval_f64, double, double)

#undef GROUP_EVAL

}  // extern "C"
