// Pair-count kernels for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes, see ops/cuda_paircount.py).
//
// Replaces yet_another_wizz_tpu/ops/pallas_paircount.py::_paircount_kernel
// in all of its variants:
//
//   K1.1  cumulative counting, unbinned columns (crosscorrelate DD/DR/RD/RR)
//   K1.2  cumulative counting, binned columns (autocorrelate DD/DR/RR): a
//         column's weight counts only where its bin equals the row's bin
//   K1.3  direct separation-weighted counting, small-angle index
//   K1.4  direct separation-weighted counting, arcsine index (grids wider
//         than THETA_POLY_MAX = 1.2 rad)
//   K1.5  signed (kappa) weights: no code of its own; nothing here treats a
//         weight <= 0 as padding (padding carries weight 0 and adds 0)
//
// and the exactness audit's flag pass K2.1, which the JAX package runs in
// XLA (kernel C below).
//
//   A. One thread block per entry k of the tile-pair list. The column tile
//      and the table are staged in shared memory; each thread owns rows of
//      the row tile, gathers its row's thresholds by the row's bin id (an
//      exact gather), walks the T columns with the compensated (hi, lo)
//      squared chord, and counts the weighted pairs at or below each
//      threshold. The rows are then reduced into the (bin,
//      edge) block by row weight, in a fixed order, and written to
//      partial[k]. No float atomics: the result is the same on every run.
//      - paircount_partials_kernel (cumulative, K1.1/K1.2): bound by float32
//        issue, 15 operations for the chord, 1 for the column weight and 3
//        per counting edge per evaluated pair, about 20 instructions, none
//        of which can be an FMA. On the main path under 4 % of candidate
//        pairs lie within their row's largest threshold. The TPU kernel
//        evaluates the full (T, T) block, since its vector unit cannot
//        branch per sub-block; a warp can, so this kernel evaluates only
//        the column chunks a warp can reach. A warp owns 32 consecutive
//        (Morton-ordered) rows, one chunk, per pass: one row per thread
//        (two rows per thread and a per-column warp vote before the edge
//        compares were measured slower, PERF.md). The wrapper derives the
//        chunk caps of both tile sets from their lanes
//        (ops/tiles.py::chunk_caps): per run of kChunk points a float32
//        sphere (center, radius) around its points of nonzero weight, the
//        radius rounded up and widened by CAP_SLACK, and their bin range.
//        The block stages the column tile's caps in
//        shared memory; the warp takes its row chunk's cap, the largest
//        threshold of its rows of nonzero weight (a warp max) and its
//        reach, sqrt(largest) + radius. A column chunk is skipped, as a
//        warp, when |c_row - c_col| > reach + r_col, or with binned
//        columns when the bin ranges are disjoint (chunk_reaches; its
//        plain mirror is ops/paircount.py::chunk_keep_mask). The decision
//        depends on warp-wide values only, so no lane diverges. Exact,
//        bit for bit:
//        (1) a skipped pair of nonzero weights lies beyond every threshold
//            of its row: the caps cover both points, and CAP_SLACK dwarfs
//            the float32 rounding of the chord and of the test, so the
//            chord the kernel would compute exceeds the threshold, and the
//            pair would add +0 (with binned columns, its bins differ: +0);
//        (2) a pair with a zero-weight column adds +-0 wherever it lies;
//            a zero-weight row's accumulators are multiplied by its weight
//            0, so its pairs move nothing but the sign of a zero;
//        (3) an accumulator starts at +0 and is never -0, so adding +-0 is
//            the identity, and so is a +-0 row value in the (bin, edge)
//            sum, which starts at +0;
//        (4) the columns of a row are still added in ascending order, and
//            the (B, E) row reduction and kernel B are unchanged.
//      - paircount_direct_kernel (K1.3/K1.4): every pair that an edge
//        counts needs its separation weight, log10(theta) -> sub-interval
//        index -> weight, which costs more issue slots than the counting.
//        The design issues as few of them as the result allows:
//        (a) the base weight exp(gc0 + gc1 * idx) takes num_sub values per
//            bin: the block's prologue fills a shared (bin, idx) table with
//            the same expf of the same operands, so a pair loads it;
//        (b) the below/above entries are grouped on the host by (bin,
//            sub-interval) (ops/gweight.py::entry_layout); a pair walks
//            only its own sub-interval's entries, usually none, in table
//            order with the table's predicates, and the entries live in
//            shared memory, so neither their number nor registers limit
//            the kernel;
//        (c) a pair beyond its row's largest threshold of the launch (or,
//            with binned columns, in another bin) adds 0 to every
//            accumulator, so its weight is not computed at all.
//        Only the row's bin and its largest threshold stay per row in
//        registers beside the accumulators (the bin's thresholds, inv_d
//        and lo_scaled are loaded from shared memory per weighted pair),
//        so the direct instances fit 64 registers without spilling (4
//        blocks of 256 threads per SM). What bounds them is the weight
//        path of the warps in which any lane's pair is in reach: a warp
//        runs it for all its lanes when one of them needs it.
//   B. segment_sum: the pair list is sorted by patch-pair slot, so each
//      slot owns a contiguous run of partials. One block per slot reads its
//      run in coalesced loads: with W = B * E values per entry and
//      cols = min(W, 256) columns per pass, the block's 256 / cols groups
//      of threads take consecutive entries, and thread (group, c) sums
//      column c of the entries group, group + groups, ... in entry order.
//      The groups' sums are combined by a fixed pairwise tree (group g
//      adds group g + h for h = 1, 2, 4, ...). The order of the sum is
//      therefore fixed by W and the run's length, not list order; two runs
//      are bitwise equal. A slot without entries gets zero. Bound by device memory
//      bytes (each partial read once).
//   C. boundary_flags_kernel (K2.1, the exactness audit's flag pass) replaces
//      yet_another_wizz_tpu/ops/paircount.py::_pair_block_boundary /
//      _boundary_flags_xla / _boundary_flags_gathered (XLA, not Pallas). It
//      writes flags[k] = 1 when any valid pair of entry k lies near an edge,
//      |chord2 - t[b, e]| <= band[b, e] for an edge e of the row's bin b; a
//      pair is valid when both weights are nonzero (zero marks padding, a
//      negative weight is real data) and, with binned columns, its bins are
//      equal. Its structure is paircount_partials_kernel's (one block per
//      entry, the column tile and its caps in shared memory, one row per
//      thread, a warp's 32 rows per pass, the same compensated chord), with
//      less work per pair (16 + 3E float32 operations: the chord, the
//      column weight test, and a subtraction, absolute value and compare per
//      edge) and nothing to reduce. Bound by float32 issue on the pairs in
//      reach, which these do about:
//      - the widened chunk skip: a row chunk reaches sqrt(m) + r_row, m the
//        largest t[b, e] + band[b, e] (float32 sum) over its rows of nonzero
//        weight and their edges, and a column chunk out of chunk_reaches of
//        that (or, with binned columns, of a disjoint bin range) is skipped
//        as a warp. Exact: the caps cover both points of a skipped pair of
//        nonzero weights, CAP_SLACK included, so its true chord exceeds
//        sqrt(m) by at least 2 CAP_SLACK less the float32 rounding of the
//        test, and the chord the kernel would compute exceeds t + band by
//        far more than the rounding of the chord, of chord2 - t and of t +
//        band (relative ~1e-7 of values below 4): |chord2 - t| > band for
//        every edge, so the pair cannot hit ((1) of A, with t + band for t);
//        a pair with a zero weight is not valid wherever it lies, and with
//        binned columns neither is a pair of unequal bins;
//      - the early exit: a warp that finds a hit sets a flag in shared
//        memory, and every warp stops at its next chunk once it reads the
//        flag (warp-uniform, by a vote). The flag is an OR over the pairs,
//        so the order of evaluation cannot change it.
//      Tables wider than 16 edges take one launch per group of 16; a later
//      group skips the entries an earlier one flagged. Its plain mirror is
//      ops/paircount.py::boundary_flags_torch, and chunk_keep_mask with a
//      band table mirrors the skip.
//
// The source is compiled once per counting mode (-DYAWT_DIRECT=0, 1 or 2:
// cumulative, direct small-angle, direct arcsine), each build into its own
// library with the same C interface, so the builds run in parallel. Within
// a build the variants are template instances: NE (counting edges per
// launch) and COLS_BINNED. Kernels B and C are in the cumulative build only.
//
// Numerics: the arithmetic uses __fsub_rn / __fadd_rn / __fmul_rn and the
// library is built with --fmad=false and without fast-math, so no FMA
// contraction or approximate logf/expf/sqrtf changes its rounding, and
// denormals are kept: it matches the plain PyTorch version operation for
// operation, up to the order of float32 sums, and (1)-(4) and (a)-(c)
// leave every pair's contribution bit for bit as the per-pair evaluation
// gives it.

#include <cuda_runtime.h>
#include <math_constants.h>

#ifndef YAWT_DIRECT
#define YAWT_DIRECT 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
// points per chunk cap, one warp's rows (ops/tiles.py::CHUNK_SIZE, checked
// through yawt_paircount_chunk when the library is loaded)
constexpr int kChunk = kWarp;
constexpr int kCapWidth = 8;  // floats per chunk cap (ops/tiles.py::CAP_WIDTH)
constexpr int kDirectMinBlocks = 4;  // blocks per SM: at most 64 registers
constexpr int kSegmentThreads = 256;
// returned instead of a CUDA error when a launch needs more shared memory
// than one block may have
constexpr int kErrorSharedMemory = -1;

constexpr int kCumulative = 0;
constexpr int kSmallAngle = 1;
constexpr int kArcsine = 2;

constexpr float kInvLn10 = 0.43429448190325176f;
constexpr float kHalfInvLn10 = static_cast<float>(0.5 * 0.43429448190325176);
constexpr float kPi2 = 1.5707963267948966f;
// h(y)/y = a0 + a1 y + ... + a4 y^4 (ops/gweight.py::_H_POLY)
constexpr float kH0 = 0.072382861485278921f;
constexpr float kH1 = 0.026515311180259658f;
constexpr float kH2 = 0.015040318719047438f;
constexpr float kH3 = 0.0068128827079525812f;
constexpr float kH4 = 0.014413456335465801f;

// Branchless float32 arcsine on [0, 1] (ops/gweight.py::_asin_f32): the
// Cephes single-precision minimax polynomial on [0, 0.5], and
// asin(s) = pi/2 - 2 asin(sqrt((1 - s) / 2)) above.
__device__ __forceinline__ float asin_f32(float s) {
  const bool big = s > 0.5f;
  float t = s;
  if (big) {
    t = sqrtf(fmaxf(__fmul_rn(0.5f, __fsub_rn(1.0f, s)), 0.0f));
  }
  const float z = __fmul_rn(t, t);
  float p = __fmul_rn(4.2163199048e-2f, z);
  p = __fmul_rn(__fadd_rn(p, 2.4181311049e-2f), z);
  p = __fmul_rn(__fadd_rn(p, 4.5470025998e-2f), z);
  p = __fmul_rn(__fadd_rn(p, 7.4953002686e-2f), z);
  p = __fadd_rn(p, 1.6666752422e-1f);
  const float r = __fadd_rn(t, __fmul_rn(__fmul_rn(t, z), p));
  return big ? __fsub_rn(kPi2, __fmul_rn(2.0f, r)) : r;
}

// log10(theta) of a pair from its squared chord (ops/gweight.py).
template <int DIRECT>
__device__ __forceinline__ float log10_theta(float chord2) {
  if constexpr (DIRECT == kSmallAngle) {
    const float y = __fmul_rn(0.25f, chord2);
    float p = __fmul_rn(kH4, y);
    p = __fmul_rn(__fadd_rn(p, kH3), y);
    p = __fmul_rn(__fadd_rn(p, kH2), y);
    p = __fmul_rn(__fadd_rn(p, kH1), y);
    p = __fadd_rn(p, kH0);
    // clamp to a float32-normal value: log(0) would give -inf
    return __fadd_rn(__fmul_rn(kHalfInvLn10, logf(fmaxf(chord2, 1e-37f))),
                     __fmul_rn(p, y));
  } else {
    const float s = fminf(__fmul_rn(0.5f, sqrtf(chord2)), 1.0f);
    const float theta = __fmul_rn(2.0f, asin_f32(s));
    return __fmul_rn(logf(fmaxf(theta, 1e-30f)), kInvLn10);
  }
}

// The column tile into shared memory: col_a = (x_hi, y_hi, z_hi, weight),
// col_b = (x_lo, y_lo, z_lo, bin).
__device__ __forceinline__ void stage_columns(const float* __restrict__ cols,
                                              int tile_size, float4* col_a,
                                              float4* col_b) {
  for (int j = threadIdx.x; j < tile_size; j += blockDim.x) {
    col_a[j] = make_float4(cols[j], cols[tile_size + j],
                           cols[2 * tile_size + j], cols[6 * tile_size + j]);
    col_b[j] = make_float4(cols[3 * tile_size + j], cols[4 * tile_size + j],
                           cols[5 * tile_size + j], cols[7 * tile_size + j]);
  }
}

// The launch's edge group of the table into shared memory, (B, NE). Edges
// beyond the group get a negative threshold: a squared chord is never
// below it, and those slots are never written.
template <int NE>
__device__ __forceinline__ void stage_thresholds(const float* __restrict__ table,
                                                 int num_bins, int table_width,
                                                 int edge0, int num_group,
                                                 float* thr_s) {
  for (int i = threadIdx.x; i < num_bins * NE; i += blockDim.x) {
    const int b = i / NE;
    const int e = i % NE;
    thr_s[i] = e < num_group ? table[b * table_width + edge0 + e] : -1.0f;
  }
}

// (bin, edge) reduction over the rows in a fixed order: each warp owns
// whole (bin, edge) entries, each lane a fixed stride of rows, then a
// fixed shuffle tree.
template <int NE>
__device__ __forceinline__ void reduce_rows(const float* row_val,
                                            const int* row_bin, int tile_size,
                                            int num_bins, int num_edges,
                                            int edge0, int num_group,
                                            long long k,
                                            float* __restrict__ partial) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int num_warps = blockDim.x / kWarp;
  for (int be = warp; be < num_bins * num_group; be += num_warps) {
    const int b = be / num_group;
    const int e = be % num_group;
    float s = 0.0f;
    for (int r = lane; r < tile_size; r += kWarp) {
      s = __fadd_rn(s, row_bin[r] == b ? row_val[r * NE + e] : 0.0f);
    }
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, offset));
    }
    if (lane == 0) {
      partial[(k * num_bins + b) * num_edges + edge0 + e] = s;
    }
  }
}

// Whether a row chunk can reach a column chunk (warp-uniform): the caps'
// centers lie within reach + r_col, reach = sqrt(largest threshold) +
// r_row, or -inf for a chunk that counts nothing. The float32 operations
// and their order are ops/paircount.py::chunk_keep_mask's.
__device__ __forceinline__ bool chunk_reaches(float reach, float4 row_cap,
                                              float4 col_cap) {
  const float limit = __fadd_rn(reach, col_cap.w);
  const float dx = __fsub_rn(row_cap.x, col_cap.x);
  const float dy = __fsub_rn(row_cap.y, col_cap.y);
  const float dz = __fsub_rn(row_cap.z, col_cap.z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return limit >= 0.0f && d2 <= __fmul_rn(limit, limit);
}

template <int NE, bool COLS_BINNED>
__global__ void __launch_bounds__(kThreads) paircount_partials_kernel(
    const float* __restrict__ lanes1,  // (N1, 8, T) row tiles
    const float* __restrict__ lanes2,  // (N2, 8, T) column tiles
    const float* __restrict__ caps1,   // (N1, T / kChunk, kCapWidth)
    const float* __restrict__ caps2,   // (N2, T / kChunk, kCapWidth)
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    const float* __restrict__ table,   // (B, W): E thresholds
    int num_bins, int table_width, int num_edges, int edge0, int num_group,
    int tile_size,
    float* __restrict__ partial) {     // (P, B, E)
  const int num_chunks = tile_size / kChunk;
  extern __shared__ float4 smem[];
  float4* col_a = smem;              // (T)
  float4* col_b = smem + tile_size;  // (T)
  float4* cap_s = smem + 2 * tile_size;  // (T / kChunk, 2) column caps
  float* row_val = reinterpret_cast<float*>(cap_s + 2 * num_chunks);  // (T, NE)
  int* row_bin = reinterpret_cast<int*>(row_val + tile_size * NE);  // (T)
  float* thr_s = reinterpret_cast<float*>(row_bin + tile_size);     // (B, NE)

  const long long k = blockIdx.x;
  const float* rows = lanes1 + static_cast<long long>(tile1[k]) * 8 * tile_size;
  const float* cols = lanes2 + static_cast<long long>(tile2[k]) * 8 * tile_size;
  const float4* row_caps = reinterpret_cast<const float4*>(
      caps1 + static_cast<long long>(tile1[k]) * num_chunks * kCapWidth);
  const float4* col_caps = reinterpret_cast<const float4*>(
      caps2 + static_cast<long long>(tile2[k]) * num_chunks * kCapWidth);
  stage_columns(cols, tile_size, col_a, col_b);
  stage_thresholds<NE>(table, num_bins, table_width, edge0, num_group, thr_s);
  for (int i = threadIdx.x; i < 2 * num_chunks; i += blockDim.x) {
    cap_s[i] = col_caps[i];
  }
  __syncthreads();

  for (int base = 0; base < tile_size; base += blockDim.x) {
    // one row per thread: the warp's rows are one chunk, all of them
    // valid or none (T is a multiple of kChunk)
    const int row = base + threadIdx.x;
    const bool valid = row < tile_size;
    const int at = valid ? row : 0;
    const float xh = rows[at];
    const float yh = rows[tile_size + at];
    const float zh = rows[2 * tile_size + at];
    const float xl = rows[3 * tile_size + at];
    const float yl = rows[4 * tile_size + at];
    const float zl = rows[5 * tile_size + at];
    const float w_row = rows[6 * tile_size + at];
    const float zr = rows[7 * tile_size + at];
    const int bin = min(max(static_cast<int>(zr), 0), num_bins - 1);
    float thr[NE];
    float acc[NE];
    float largest = -1.0f;  // the row's largest threshold
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      thr[e] = valid ? thr_s[bin * NE + e] : -1.0f;
      acc[e] = 0.0f;
      largest = fmaxf(largest, thr[e]);
    }
    // the chunk reaches as far as its rows of nonzero weight ((2))
    largest = w_row != 0.0f ? largest : -1.0f;
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
      largest = fmaxf(largest, __shfl_xor_sync(0xffffffffu, largest, offset));
    }
    const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 row_cap = valid ? row_caps[2 * (row / kChunk)] : none;
    const float4 row_bins = valid ? row_caps[2 * (row / kChunk) + 1] : none;
    // -inf for a chunk that counts nothing
    const float reach = largest < 0.0f ? -CUDART_INF_F
                                       : __fadd_rn(sqrtf(largest), row_cap.w);

    for (int chunk = 0; chunk < num_chunks; ++chunk) {
      bool keep = chunk_reaches(reach, row_cap, cap_s[2 * chunk]);
      if constexpr (COLS_BINNED) {
        const float4 col_bins = cap_s[2 * chunk + 1];
        keep = keep && !(row_bins.y < col_bins.x || col_bins.y < row_bins.x);
      }
      if (!keep) continue;  // (1)-(3): every pair of the chunk adds +-0
      for (int j = chunk * kChunk; j < (chunk + 1) * kChunk; ++j) {
        const float4 a = col_a[j];
        const float4 c = col_b[j];
        // compensated difference: (hi1 - hi2) + (lo1 - lo2)
        const float dx = __fadd_rn(__fsub_rn(xh, a.x), __fsub_rn(xl, c.x));
        const float dy = __fadd_rn(__fsub_rn(yh, a.y), __fsub_rn(yl, c.y));
        const float dz = __fadd_rn(__fsub_rn(zh, a.z), __fsub_rn(zl, c.z));
        float chord2 = __fmul_rn(dx, dx);
        chord2 = __fadd_rn(chord2, __fmul_rn(dy, dy));
        chord2 = __fadd_rn(chord2, __fmul_rn(dz, dz));

        float w = a.w;
        if constexpr (COLS_BINNED) {
          // exact compare of the float bin lanes
          w = c.w == zr ? w : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          acc[e] = __fadd_rn(acc[e], chord2 <= thr[e] ? w : 0.0f);
        }
      }
    }

    if (valid) {
      row_bin[row] = bin;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        row_val[row * NE + e] = __fmul_rn(w_row, acc[e]);
      }
    }
  }
  __syncthreads();
  reduce_rows<NE>(row_val, row_bin, tile_size, num_bins, num_edges, edge0,
                  num_group, k, partial);
}

// The NE thresholds of one bin from shared memory in 16- or 8-byte loads
// (NE is even and the bin's row is aligned to its width).
template <int NE>
__device__ __forceinline__ void load_thresholds(const float* thr,
                                                float (&out)[NE]) {
  if constexpr (NE % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NE / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(thr)[q];
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NE / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(thr)[q];
      out[2 * q] = v.x;
      out[2 * q + 1] = v.y;
    }
  }
}

// The direct weight of one pair and its addition to a row's accumulators.
// The bin's thresholds, inv_d and lo_scaled are loaded here, not held per
// row, to keep the registers of two rows within 64.
template <int NE, int DIRECT>
__device__ __forceinline__ void add_weighted(float chord2, float w_col,
                                             const float* thr_bin,
                                             float2 coef,
                                             const int4* span_bin,
                                             const float2* entry_s,
                                             float last_sub,
                                             float (&acc)[NE]) {
  const float l10 = log10_theta<DIRECT>(chord2);
  float idx = floorf(__fsub_rn(__fmul_rn(l10, coef.x), coef.y));
  idx = fminf(fmaxf(idx, 0.0f), last_sub);
  const int4 span = span_bin[static_cast<int>(idx)];
  float g = __int_as_float(span.x);
  // the sub-interval's below-entries, then its ascending above-entries (a
  // pair lands on the highest limit below it)
#pragma unroll 1
  for (int n = span.y; n < span.z; ++n) {
    const float2 entry = entry_s[n];
    g = chord2 <= entry.x ? entry.y : g;
  }
#pragma unroll 1
  for (int n = span.z; n < span.w; ++n) {
    const float2 entry = entry_s[n];
    g = chord2 > entry.x ? entry.y : g;
  }
  const float w = __fmul_rn(w_col, g);
  float thr[NE];
  load_thresholds<NE>(thr_bin, thr);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    acc[e] = __fadd_rn(acc[e], chord2 <= thr[e] ? w : 0.0f);
  }
}

template <int NE, bool COLS_BINNED, int DIRECT>
__global__ void __launch_bounds__(kThreads, kDirectMinBlocks)
paircount_direct_kernel(
    const float* __restrict__ lanes1,  // (N1, 8, T) row tiles
    const float* __restrict__ lanes2,  // (N2, 8, T) column tiles
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    const float* __restrict__ table,   // (B, W): E thresholds + parameters
    const int* __restrict__ layout,    // spans (B, S, 3), entries (N, 2)
    int num_bins, int table_width, int num_edges, int edge0, int num_group,
    int tile_size, int num_sub, int num_entries,
    float* __restrict__ partial) {     // (P, B, E)
  // rows per thread: two rows share each column load while their
  // thresholds and accumulators fit the register budget
  constexpr int kRows = NE <= 4 ? 2 : 1;
  const int num_spans = num_bins * num_sub;
  extern __shared__ float4 smem[];
  float4* col_a = smem;              // (T)
  float4* col_b = smem + tile_size;  // (T)
  // (B * S) base weight bits, start, split, stop of the entries
  int4* span_s = reinterpret_cast<int4*>(smem + 2 * tile_size);
  float* thr_s = reinterpret_cast<float*>(span_s + num_spans);  // (B, NE)
  float2* entry_s = reinterpret_cast<float2*>(thr_s + num_bins * NE);  // (N)
  float2* coef_s = entry_s + num_entries;  // (B) inv_d, lo_scaled
  float* row_val = reinterpret_cast<float*>(coef_s + num_bins);     // (T, NE)
  int* row_bin = reinterpret_cast<int*>(row_val + tile_size * NE);  // (T)

  const long long k = blockIdx.x;
  const float* rows = lanes1 + static_cast<long long>(tile1[k]) * 8 * tile_size;
  const float* cols = lanes2 + static_cast<long long>(tile2[k]) * 8 * tile_size;
  stage_columns(cols, tile_size, col_a, col_b);
  stage_thresholds<NE>(table, num_bins, table_width, edge0, num_group, thr_s);
  // (a): the base weight of each (bin, sub-interval), from the operands a
  // pair in it gives expf; (b): its span of entries
  for (int s = threadIdx.x; s < num_spans; s += blockDim.x) {
    const float* p = table + (s / num_sub) * table_width + num_edges;
    const float idx = static_cast<float>(s % num_sub);
    const float g = expf(__fadd_rn(p[2], __fmul_rn(p[3], idx)));
    span_s[s] = make_int4(__float_as_int(g), layout[3 * s], layout[3 * s + 1],
                          layout[3 * s + 2]);
  }
  const int* entries = layout + 3 * num_spans;
  for (int n = threadIdx.x; n < num_entries; n += blockDim.x) {
    entry_s[n] = make_float2(__int_as_float(entries[2 * n]),
                             __int_as_float(entries[2 * n + 1]));
  }
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    const float* p = table + b * table_width + num_edges;
    coef_s[b] = make_float2(p[0], p[1]);
  }
  __syncthreads();

  const float last_sub = static_cast<float>(num_sub - 1);
  for (int base = 0; base < tile_size; base += kRows * blockDim.x) {
    float xh[kRows], yh[kRows], zh[kRows];
    float xl[kRows], yl[kRows], zl[kRows];
    float zr[kRows];
    float acc[kRows][NE];
    float reach[kRows];  // the row's largest threshold of this launch
    int bin[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * blockDim.x + threadIdx.x;
      const bool valid = row < tile_size;
      const int at = valid ? row : 0;
      xh[r] = rows[at];
      yh[r] = rows[tile_size + at];
      zh[r] = rows[2 * tile_size + at];
      xl[r] = rows[3 * tile_size + at];
      yl[r] = rows[4 * tile_size + at];
      zl[r] = rows[5 * tile_size + at];
      zr[r] = rows[7 * tile_size + at];
      bin[r] = min(max(static_cast<int>(zr[r]), 0), num_bins - 1);
      reach[r] = -1.0f;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        acc[r][e] = 0.0f;
        reach[r] = fmaxf(reach[r], thr_s[bin[r] * NE + e]);
      }
      reach[r] = valid ? reach[r] : -1.0f;
    }

    for (int j = 0; j < tile_size; ++j) {
      const float4 a = col_a[j];
      const float4 c = col_b[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // compensated difference: (hi1 - hi2) + (lo1 - lo2)
        const float dx = __fadd_rn(__fsub_rn(xh[r], a.x), __fsub_rn(xl[r], c.x));
        const float dy = __fadd_rn(__fsub_rn(yh[r], a.y), __fsub_rn(yl[r], c.y));
        const float dz = __fadd_rn(__fsub_rn(zh[r], a.z), __fsub_rn(zl[r], c.z));
        float chord2 = __fmul_rn(dx, dx);
        chord2 = __fadd_rn(chord2, __fmul_rn(dy, dy));
        chord2 = __fadd_rn(chord2, __fmul_rn(dz, dz));

        // (c): a pair no edge counts (beyond the row's largest threshold
        // or, with binned columns, in another bin) would add 0 to every
        // accumulator, and an accumulator that starts at +0 is never -0,
        // so adding +0 is the identity: its weight is skipped
        bool counted = chord2 <= reach[r];
        if constexpr (COLS_BINNED) {
          // exact compare of the float bin lanes
          counted = counted && c.w == zr[r];
        }
        if (counted) {
          add_weighted<NE, DIRECT>(chord2, a.w, thr_s + bin[r] * NE,
                                   coef_s[bin[r]], span_s + bin[r] * num_sub,
                                   entry_s, last_sub, acc[r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * blockDim.x + threadIdx.x;
      if (row < tile_size) {
        const float w_row = rows[6 * tile_size + row];
        row_bin[row] = bin[r];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          row_val[row * NE + e] = __fmul_rn(w_row, acc[r][e]);
        }
      }
    }
  }
  __syncthreads();
  reduce_rows<NE>(row_val, row_bin, tile_size, num_bins, num_edges, edge0,
                  num_group, k, partial);
}

struct Launch {
  const float* lanes1;
  const float* lanes2;
  const float* caps1;
  const float* caps2;
  const int* tile1;
  const int* tile2;
  long long num_pairs;
  const float* table;
  int num_bins, table_width, num_edges, edge0, num_group, tile_size;
  int num_sub;
  const int* layout;
  int num_entries;
  float* partial;
  cudaStream_t stream;
};

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  int device = 0;
  int limit = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  if (smem > static_cast<size_t>(limit)) return kErrorSharedMemory;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int NE, bool COLS_BINNED>
int launch_partials(const Launch& a) {
  const size_t tile = static_cast<size_t>(a.tile_size);
  const size_t bins = static_cast<size_t>(a.num_bins);
  size_t smem = 2 * tile * sizeof(float4) + tile * NE * sizeof(float) +
                tile * sizeof(int) + bins * NE * sizeof(float);
  const unsigned int blocks = static_cast<unsigned int>(a.num_pairs);
  int status;
  if constexpr (YAWT_DIRECT == kCumulative) {
    smem += 2 * (tile / kChunk) * sizeof(float4);
    auto kernel = paircount_partials_kernel<NE, COLS_BINNED>;
    status = prepare(kernel, smem);
    if (status != 0) return status;
    kernel<<<blocks, kThreads, smem, a.stream>>>(
        a.lanes1, a.lanes2, a.caps1, a.caps2, a.tile1, a.tile2, a.table,
        a.num_bins, a.table_width, a.num_edges, a.edge0, a.num_group,
        a.tile_size, a.partial);
  } else {
    smem += bins * a.num_sub * sizeof(int4) +
            static_cast<size_t>(a.num_entries) * sizeof(float2) +
            bins * sizeof(float2);
    auto kernel = paircount_direct_kernel<NE, COLS_BINNED, YAWT_DIRECT>;
    status = prepare(kernel, smem);
    if (status != 0) return status;
    kernel<<<blocks, kThreads, smem, a.stream>>>(
        a.lanes1, a.lanes2, a.tile1, a.tile2, a.table, a.layout, a.num_bins,
        a.table_width, a.num_edges, a.edge0, a.num_group, a.tile_size,
        a.num_sub, a.num_entries, a.partial);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool COLS_BINNED>
int dispatch_edges(const Launch& a) {
  if constexpr (YAWT_DIRECT == kCumulative) {
    if (a.num_group <= 1) return launch_partials<1, COLS_BINNED>(a);
  }
  if (a.num_group <= 2) return launch_partials<2, COLS_BINNED>(a);
  if (a.num_group <= 4) return launch_partials<4, COLS_BINNED>(a);
  if (a.num_group <= 8) return launch_partials<8, COLS_BINNED>(a);
  return launch_partials<16, COLS_BINNED>(a);
}

#if YAWT_DIRECT == 0
__global__ void __launch_bounds__(kSegmentThreads) segment_sum_kernel(
    const float* __restrict__ partial,       // (P, width)
    const long long* __restrict__ offsets,   // (S + 1,) run bounds
    int width,
    float* __restrict__ out) {               // (S, width)
  __shared__ float sums[kSegmentThreads];
  const long long slot = blockIdx.x;
  const long long begin = offsets[slot];
  const long long end = offsets[slot + 1];
  const int cols = min(width, static_cast<int>(blockDim.x));
  const int groups = blockDim.x / cols;
  const int group = threadIdx.x / cols;
  const int lane = threadIdx.x % cols;
  const long long stride = static_cast<long long>(groups) * width;
  for (int c0 = 0; c0 < width; c0 += cols) {
    const int column = c0 + lane;
    const bool active = group < groups && column < width;
    float acc = 0.0f;
    if (active) {
      long long n = begin + group;
      const float* p = partial + n * width + column;
      // four loads in flight, added in entry order
      for (; n + 3 * groups < end; n += 4 * groups, p += 4 * stride) {
        const float v0 = p[0];
        const float v1 = p[stride];
        const float v2 = p[2 * stride];
        const float v3 = p[3 * stride];
        acc = __fadd_rn(acc, v0);
        acc = __fadd_rn(acc, v1);
        acc = __fadd_rn(acc, v2);
        acc = __fadd_rn(acc, v3);
      }
      for (; n < end; n += groups, p += stride) {
        acc = __fadd_rn(acc, *p);
      }
    }
    sums[threadIdx.x] = acc;
    __syncthreads();
    for (int h = 1; h < groups; h *= 2) {
      if (active && group % (2 * h) == 0 && group + h < groups) {
        sums[threadIdx.x] = __fadd_rn(sums[threadIdx.x],
                                      sums[threadIdx.x + h * cols]);
      }
      __syncthreads();
    }
    if (active && group == 0) {
      out[slot * width + column] = sums[threadIdx.x];
    }
    __syncthreads();
  }
}

// Kernel C (K2.1): see the note at the top.
template <int NE, bool COLS_BINNED>
__global__ void __launch_bounds__(kThreads) boundary_flags_kernel(
    const float* __restrict__ lanes1,  // (N1, 8, T) row tiles
    const float* __restrict__ lanes2,  // (N2, 8, T) column tiles
    const float* __restrict__ caps1,   // (N1, T / kChunk, kCapWidth)
    const float* __restrict__ caps2,   // (N2, T / kChunk, kCapWidth)
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    const float* __restrict__ table,   // (B, E) thresholds
    const float* __restrict__ band,    // (B, E) half-widths
    int num_bins, int num_edges, int edge0, int num_group, int tile_size,
    unsigned char* __restrict__ flags) {  // (P,)
  const int num_chunks = tile_size / kChunk;
  extern __shared__ float4 smem[];
  float4* col_a = smem;              // (T)
  float4* col_b = smem + tile_size;  // (T)
  float4* cap_s = smem + 2 * tile_size;  // (T / kChunk, 2) column caps
  float* thr_s = reinterpret_cast<float*>(cap_s + 2 * num_chunks);  // (B, NE)
  float* band_s = thr_s + num_bins * NE;                              // (B, NE)
  __shared__ int found;

  const long long k = blockIdx.x;
  // an earlier edge group flagged this entry (the whole block returns)
  if (edge0 > 0 && flags[k]) return;
  const float* rows = lanes1 + static_cast<long long>(tile1[k]) * 8 * tile_size;
  const float* cols = lanes2 + static_cast<long long>(tile2[k]) * 8 * tile_size;
  const float4* row_caps = reinterpret_cast<const float4*>(
      caps1 + static_cast<long long>(tile1[k]) * num_chunks * kCapWidth);
  const float4* col_caps = reinterpret_cast<const float4*>(
      caps2 + static_cast<long long>(tile2[k]) * num_chunks * kCapWidth);
  stage_columns(cols, tile_size, col_a, col_b);
  // edges beyond the group: t = band = -1, |chord2 + 1| <= -1 never holds
  stage_thresholds<NE>(table, num_bins, num_edges, edge0, num_group, thr_s);
  stage_thresholds<NE>(band, num_bins, num_edges, edge0, num_group, band_s);
  for (int i = threadIdx.x; i < 2 * num_chunks; i += blockDim.x) {
    cap_s[i] = col_caps[i];
  }
  if (threadIdx.x == 0) found = 0;
  __syncthreads();

  const volatile int* seen = &found;
  for (int base = 0; base < tile_size; base += blockDim.x) {
    if (__any_sync(0xffffffffu, *seen != 0)) break;
    // one row per thread: the warp's rows are one chunk, all of them
    // valid or none (T is a multiple of kChunk)
    const int row = base + threadIdx.x;
    const bool valid = row < tile_size;
    const int at = valid ? row : 0;
    const float xh = rows[at];
    const float yh = rows[tile_size + at];
    const float zh = rows[2 * tile_size + at];
    const float xl = rows[3 * tile_size + at];
    const float yl = rows[4 * tile_size + at];
    const float zl = rows[5 * tile_size + at];
    const float w_row = rows[6 * tile_size + at];
    const float zr = rows[7 * tile_size + at];
    const bool row_ok = valid && w_row != 0.0f;
    const int bin = min(max(static_cast<int>(zr), 0), num_bins - 1);
    float thr[NE];
    float bnd[NE];
    float largest = -1.0f;  // the row's largest t + band
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      thr[e] = thr_s[bin * NE + e];
      bnd[e] = band_s[bin * NE + e];
      largest = fmaxf(largest, __fadd_rn(thr[e], bnd[e]));
    }
    // the chunk reaches as far as its rows of nonzero weight
    largest = row_ok ? largest : -1.0f;
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
      largest = fmaxf(largest, __shfl_xor_sync(0xffffffffu, largest, offset));
    }
    const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 row_cap = valid ? row_caps[2 * (row / kChunk)] : none;
    const float4 row_bins = valid ? row_caps[2 * (row / kChunk) + 1] : none;
    // -inf for a chunk that can flag nothing
    const float reach = largest < 0.0f ? -CUDART_INF_F
                                       : __fadd_rn(sqrtf(largest), row_cap.w);

    for (int chunk = 0; chunk < num_chunks; ++chunk) {
      if (__any_sync(0xffffffffu, *seen != 0)) break;
      bool keep = chunk_reaches(reach, row_cap, cap_s[2 * chunk]);
      if constexpr (COLS_BINNED) {
        const float4 col_bins = cap_s[2 * chunk + 1];
        keep = keep && !(row_bins.y < col_bins.x || col_bins.y < row_bins.x);
      }
      if (!keep) continue;  // no pair of the chunk can hit
      bool hit = false;
      for (int j = chunk * kChunk; j < (chunk + 1) * kChunk; ++j) {
        const float4 a = col_a[j];
        const float4 c = col_b[j];
        // compensated difference: (hi1 - hi2) + (lo1 - lo2)
        const float dx = __fadd_rn(__fsub_rn(xh, a.x), __fsub_rn(xl, c.x));
        const float dy = __fadd_rn(__fsub_rn(yh, a.y), __fsub_rn(yl, c.y));
        const float dz = __fadd_rn(__fsub_rn(zh, a.z), __fsub_rn(zl, c.z));
        float chord2 = __fmul_rn(dx, dx);
        chord2 = __fadd_rn(chord2, __fmul_rn(dy, dy));
        chord2 = __fadd_rn(chord2, __fmul_rn(dz, dz));

        bool near = false;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          near = near || fabsf(__fsub_rn(chord2, thr[e])) <= bnd[e];
        }
        bool ok = a.w != 0.0f;
        if constexpr (COLS_BINNED) {
          ok = ok && c.w == zr;  // exact compare of the float bin lanes
        }
        hit = hit || (ok && near);
      }
      if (__any_sync(0xffffffffu, hit && row_ok)) {
        if (threadIdx.x % kWarp == 0) found = 1;
        break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) flags[k] = found ? 1 : 0;
}

struct FlagLaunch {
  const float* lanes1;
  const float* lanes2;
  const float* caps1;
  const float* caps2;
  const int* tile1;
  const int* tile2;
  long long num_pairs;
  const float* table;
  const float* band;
  int num_bins, num_edges, edge0, num_group, tile_size;
  unsigned char* flags;
  cudaStream_t stream;
};

template <int NE, bool COLS_BINNED>
int launch_flags(const FlagLaunch& a) {
  const size_t tile = static_cast<size_t>(a.tile_size);
  const size_t smem = 2 * tile * sizeof(float4) +
                      2 * (tile / kChunk) * sizeof(float4) +
                      2 * static_cast<size_t>(a.num_bins) * NE * sizeof(float);
  auto kernel = boundary_flags_kernel<NE, COLS_BINNED>;
  const int status = prepare(kernel, smem);
  if (status != 0) return status;
  kernel<<<static_cast<unsigned int>(a.num_pairs), kThreads, smem, a.stream>>>(
      a.lanes1, a.lanes2, a.caps1, a.caps2, a.tile1, a.tile2, a.table, a.band,
      a.num_bins, a.num_edges, a.edge0, a.num_group, a.tile_size, a.flags);
  return static_cast<int>(cudaGetLastError());
}

template <bool COLS_BINNED>
int dispatch_flags(const FlagLaunch& a) {
  if (a.num_group <= 1) return launch_flags<1, COLS_BINNED>(a);
  if (a.num_group <= 2) return launch_flags<2, COLS_BINNED>(a);
  if (a.num_group <= 4) return launch_flags<4, COLS_BINNED>(a);
  if (a.num_group <= 8) return launch_flags<8, COLS_BINNED>(a);
  return launch_flags<16, COLS_BINNED>(a);
}
#endif

}  // namespace

extern "C" {

// The counting mode this library was built for: 0 cumulative, 1 direct
// small-angle, 2 direct arcsine.
int yawt_paircount_mode() { return YAWT_DIRECT; }

// Points per chunk cap that yawt_paircount_partials reads (caps1 / caps2).
int yawt_paircount_chunk() { return kChunk; }

// One launch of kernel A for the counting edges [edge0, edge0 + num_group)
// of a (num_bins, table_width) table whose first num_edges columns are
// squared-chord thresholds and, in direct mode, whose remaining columns
// are the weight parameters [inv_d, lo_scaled, gc0, gc1, entries...]
// (num_sub uniform sub-intervals). The cumulative build reads the tiles'
// chunk caps caps1 / caps2, (N, T / 32, 8) float32 each
// (ops/tiles.py::chunk_caps; T a multiple of 32); the direct builds ignore
// them. In direct mode, layout holds the
// int32 (num_bins, num_sub, 3) entry spans followed by the num_entries
// (thr, g) float32 entries (ops/gweight.py::EntryLayout.packed); the
// cumulative build ignores num_sub, layout and num_entries.
// 1 <= num_group <= 16. Returns cudaGetLastError() after the launch, the
// error of raising the kernel's shared-memory limit, or -1 when the launch
// needs more shared memory than one block may have (a tile, table or
// entry layout too large).
int yawt_paircount_partials(const float* lanes1, const float* lanes2,
                            const float* caps1, const float* caps2,
                            const int* tile1, const int* tile2,
                            long long num_pairs, const float* table,
                            int num_bins, int table_width, int num_edges,
                            int edge0, int num_group, int tile_size,
                            int cols_binned, int num_sub, const int* layout,
                            int num_entries, float* partial, void* stream) {
  const Launch a{lanes1, lanes2, caps1, caps2, tile1, tile2, num_pairs, table,
                 num_bins, table_width, num_edges, edge0, num_group,
                 tile_size, num_sub, layout, num_entries, partial,
                 static_cast<cudaStream_t>(stream)};
  return cols_binned ? dispatch_edges<true>(a) : dispatch_edges<false>(a);
}

#if YAWT_DIRECT == 0
// One launch of kernel C (the audit's flag pass) for the edges [edge0, edge0
// + num_group) of the (num_bins, num_edges) float32 table and band, 1 <=
// num_group <= 16, into the (num_pairs,) bytes flags (0 or 1; a launch with
// edge0 > 0 keeps the entries an earlier group set). caps1 / caps2 as for
// yawt_paircount_partials. Returns cudaGetLastError() after the launch, the
// error of raising the kernel's shared-memory limit, or -1 when the tile and
// table need more shared memory than one block may have.
int yawt_boundary_flags(const float* lanes1, const float* lanes2,
                        const float* caps1, const float* caps2,
                        const int* tile1, const int* tile2,
                        long long num_pairs, const float* table,
                        const float* band, int num_bins, int num_edges,
                        int edge0, int num_group, int tile_size,
                        int cols_binned, unsigned char* flags, void* stream) {
  const FlagLaunch a{lanes1, lanes2, caps1, caps2, tile1, tile2, num_pairs,
                     table, band, num_bins, num_edges, edge0, num_group,
                     tile_size, flags, static_cast<cudaStream_t>(stream)};
  return cols_binned ? dispatch_flags<true>(a) : dispatch_flags<false>(a);
}

// One launch of kernel B. Returns cudaGetLastError() after the launch.
int yawt_segment_sum(const float* partial, const long long* offsets,
                     long long num_slots, int width, float* out, void* stream) {
  segment_sum_kernel<<<static_cast<unsigned int>(num_slots), kSegmentThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      partial, offsets, width, out);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // extern "C"
