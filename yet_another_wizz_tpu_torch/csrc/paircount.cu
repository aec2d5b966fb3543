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
//        A warp tests its column chunks 32 at a time, one per lane, and
//        ballots the decisions into a mask (warp-uniform, as each decision
//        is), then walks the mask's set bits in ascending order through
//        the pair loop, in which the caps and the reach are no longer
//        live. The kept blocks are the mask's population count: lane 0
//        adds it to the warp's word in shared memory, and after the rows
//        thread 0 adds the block's words, once per block, to the 64-bit
//        total kept_blocks (one per device, never reset; null: not
//        counted). Counted inside the chunk loop, a register or a
//        shared-memory add per kept block took K1.1 from 48 to 51 or 55
//        registers, 5 to 4 blocks per SM and ~5 % of its time; the ballot
//        instead of every lane running the warp's tests one after another
//        took K1.1 to 40 registers and ~18 % off its time (PERF.md).
//        The host reads the total when it reads its counters
//        (ops/cuda_paircount.py: engine.chunk_blocks_kept; the host counts
//        engine.chunk_blocks, tile pairs x (T / 32)^2 per launch, where it
//        queues the launch). The adds touch no count. The direct instances
//        skip and count by the same rule ((d) below).
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
//            accumulator, so its weight is not computed at all;
//        (d) most pairs lie beyond every threshold (on the main path
//            ~0.06 % of candidate pairs are in reach), so the kernel
//            evaluates only the column chunks a row chunk can reach, by
//            K1.1's rule and in K1.1's form: one row per thread, a warp's
//            32 rows one chunk, the column tile's caps in shared memory,
//            the chunk's reach sqrt(m) + r_row with m the largest of the
//            launch's counting thresholds over its rows of nonzero weight,
//            one chunk test per lane balloted into a mask whose set bits
//            the pair loop walks in ascending order, and the mask's
//            population counted into kept_blocks as K1.1 counts it.
//            Exact, bit for bit, by (1)-(4) with (c) for the threshold
//            test: a skipped pair of nonzero weights lies beyond its row's
//            largest threshold (or, binned, in another bin), where (c)
//            adds nothing; a zero-weight column's pair adds w_col * g =
//            +-0 (g is finite) and a zero-weight row's accumulators are
//            multiplied by its 0; inside a kept block the chord, (c), the
//            weight and its additions are the per-pair evaluation's, and a
//            row's columns still come in ascending order. Two rows per
//            thread in Morton-adjacent chunks, sharing each column load
//            while the warp walks the union of the two chunks' masks,
//            evaluates ~40 % more blocks and was measured 2-11 % slower
//            on K1.3 (PERF.md).
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
//   C. The flag pass (K2.1, the exactness audit's) replaces
//      yet_another_wizz_tpu/ops/paircount.py::_pair_block_boundary /
//      _boundary_flags_xla / _boundary_flags_gathered (XLA, not Pallas). It
//      sets flags[k] = 1 when any valid pair of entry k lies near an edge,
//      |chord2 - t[b, e]| <= band[b, e] for an edge e of the row's bin b; a
//      pair is valid when both weights are nonzero (zero marks padding, a
//      negative weight is real data) and, with binned columns, its bins are
//      equal. Bound by float32 issue on the pairs in reach (16 + 3E
//      operations per pair: the chord, the column weight test, and a
//      subtraction, absolute value and compare per edge). Few pairs are:
//      about 11 % of the 32 x 32 chunk blocks lie within reach of an edge on
//      the main path, and about 1 % of the entries end flagged, so a design
//      that stages the whole column tile for every entry pays a fixed cost
//      per entry several times the chord work. Three launches per group of
//      16 edges, in stream order, no host synchronisation between them:
//      - C0 flag_reach_kernel: the reach of each row chunk of the row tile
//        set, once per launch (not per entry): sqrt(m) + r_row, m the
//        largest t[b, e] + band[b, e] (float32 sum) over the chunk's rows of
//        nonzero weight and the group's edges, -inf without such rows
//        (ops/paircount.py::chunk_reach);
//      - C1 flag_triage_kernel: one warp per entry tests the entry's 16 x 16
//        (row chunk, column chunk) blocks from the chunk caps and C0's reach
//        alone (chunk_reaches; with binned columns also the bin ranges),
//        without touching the lanes, and appends one work item (entry, row
//        chunk and run of 16 column chunks, 16-bit mask of the kept column
//        chunks) per row chunk that keeps any block, through one atomicAdd
//        per warp on the list's length (plain mirror:
//        ops/paircount.py::flag_work_items). An entry without items keeps
//        its 0. Exact: a skipped block holds no near pair, as below;
//      - C2 flag_evaluate_kernel: a persistent grid (blocks per SM from the
//        occupancy) whose warps take items in turn through a second
//        counter, so the host never reads the list's length. A warp drops an
//        item whose entry is already flagged (a volatile load: other
//        blocks' stores), holds the item's 32 rows in registers (lane r, row
//        r: eight coalesced 128-byte loads of the (N, 8, T) lanes) and walks
//        the mask's column chunks, each 1 KB staged with cp.async into its
//        own double-buffered shared-memory slot while the previous chunk's
//        pairs are evaluated (K1.1's operations in K1.1's order, __f*_rn,
//        built with --fmad=false); only __syncwarp and cp.async.wait_group
//        order it. Of a staged chunk, only the quads of 4 columns holding a
//        column that the row chunk needs are evaluated: lane j tests column
//        j's weight, its hi position against the row chunk's cap and reach
//        (chunk_reaches with the column as a cap of radius 0) and, with
//        binned columns, its bin against the chunk's bin range; a warp
//        ballot gives the columns. On the main path this keeps 0.63 / 0.35 /
//        0.57 of the columns of the kept blocks (DD / RD / w_ss DD;
//        scripts/torch_flag_kept_share.py). The
//        columns of weight 0 then get a NaN x in the slot: their chords are
//        NaN, and |NaN - t| <= band is false, so they are never near, as a
//        pair with a zero weight is never valid. The first hit (a warp
//        vote) stores 1 and ends the item.
//      The flags cannot depend on the order of the items: each is an OR over
//      the entry's pairs, a store only ever writes 1, and a dropped item
//      belongs to an entry already 1. Two runs give the same bits although
//      the list's order is the atomics'.
//      The skip is exact: a row chunk reaching sqrt(m) + r_row drops a
//      column chunk when |c_row - c_col| > reach + r_col. The caps cover
//      both points of a skipped pair of nonzero weights, CAP_SLACK included,
//      so its true chord exceeds sqrt(m) by at least 2 CAP_SLACK less the
//      float32 rounding of the test, and the chord the kernel would compute
//      exceeds t + band by far more than the rounding of the chord, of
//      chord2 - t and of t + band (relative ~1e-7 of values below 4):
//      |chord2 - t| > band for every edge, so the pair cannot hit ((1) of A,
//      with t + band for t); a pair with a zero weight is not valid wherever
//      it lies, and with binned columns neither is a pair of unequal bins.
//      The column test is exact by the same argument with one cap: the row
//      cap covers its points with CAP_SLACK to spare, and a column's hi
//      position lies within ~1e-7 of the point, so a skipped column lies
//      farther than sqrt(m) + CAP_SLACK / 2 from every row of nonzero weight
//      of the chunk.
//      A tighter, band-aware test (keep a block only if some edge's band
//      [t - band, t + band] meets the caps' chord interval [D - r_r - r_c,
//      D + r_r + r_c]) drops no block of the main path's lists, whose chunk
//      radii exceed the edges' chords (scripts/torch_flag_kept_share.py),
//      so it is not used.
//      No tensor cores: a chord from a Gram matrix on wgmma (TF32 or
//      3xTF32) rounds differently from the compensated chord the flags rest
//      on, and the port allows no TF32.
//      Tables wider than 16 edges take one set of launches per group of 16;
//      a later group's triage skips the entries an earlier one flagged. The
//      plain version is ops/paircount.py::boundary_flags_torch.
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
// operation, up to the order of float32 sums, and (1)-(4) and (a)-(d)
// leave every pair's contribution bit for bit as the per-pair evaluation
// gives it.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <atomic>

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
// column chunks per work item of kernel C (the bits of its mask;
// ops/paircount.py::FLAG_ITEM_CHUNKS)
constexpr int kItemChunks = 16;
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

// The column tile's chunk caps into shared memory, (T / kChunk, 2).
__device__ __forceinline__ void stage_caps(const float4* __restrict__ col_caps,
                                           int num_chunks, float4* cap_s) {
  for (int i = threadIdx.x; i < 2 * num_chunks; i += blockDim.x) {
    cap_s[i] = col_caps[i];
  }
}

// How far the warp's row chunk reaches: sqrt(m) + r_row, m the largest of
// its rows' largest thresholds (kernel C: t + band) over the rows of
// nonzero weight ((2)), -inf for a chunk that counts nothing
// (ops/paircount.py::chunk_reach).
__device__ __forceinline__ float warp_reach(float largest, float w_row,
                                            float radius) {
  largest = w_row != 0.0f ? largest : -1.0f;
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    largest = fmaxf(largest, __shfl_xor_sync(0xffffffffu, largest, offset));
  }
  return largest < 0.0f ? -CUDART_INF_F : __fadd_rn(sqrtf(largest), radius);
}

// The column chunks chunk0 + c, c < 32, that the warp's row chunk keeps, as
// a mask: lane c tests chunk chunk0 + c (chunk_reaches and, with binned
// columns, the bin ranges) and a ballot gathers the decisions (warp-uniform,
// as each decision is); a skipped chunk's pairs would add +-0 ((1)-(3)).
// Lane 0 adds the mask's population to the warp's word of kept_s when the
// blocks are counted.
template <bool COLS_BINNED>
__device__ __forceinline__ unsigned int kept_chunks(
    int chunk0, int num_chunks, float reach, float4 row_cap, float4 row_bins,
    const float4* cap_s, unsigned int* kept_s, bool counted) {
  const int tested = chunk0 + threadIdx.x % kWarp;
  bool keep = tested < num_chunks &&
              chunk_reaches(reach, row_cap, cap_s[2 * tested]);
  if constexpr (COLS_BINNED) {
    const float4 col_bins = tested < num_chunks ? cap_s[2 * tested + 1]
                                                : row_bins;
    keep = keep && !(row_bins.y < col_bins.x || col_bins.y < row_bins.x);
  }
  const unsigned int kept = __ballot_sync(0xffffffffu, keep);
  if (counted && threadIdx.x % kWarp == 0) {
    kept_s[threadIdx.x / kWarp] += __popc(kept);
  }
  return kept;
}

// Thread 0 adds the block's kept blocks (the warps' words, after a
// __syncthreads) to the device's total, once per block; null: not counted.
__device__ __forceinline__ void add_kept(const unsigned int* kept_s,
                                         unsigned long long* kept_blocks) {
  if (kept_blocks != nullptr && threadIdx.x == 0) {
    unsigned long long kept = 0;
    for (int w = 0; w < kThreads / kWarp; ++w) kept += kept_s[w];
    if (kept > 0) atomicAdd(kept_blocks, kept);
  }
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
    float* __restrict__ partial,       // (P, B, E)
    unsigned long long* kept_blocks) { // the device's total, or null
  const int num_chunks = tile_size / kChunk;
  extern __shared__ float4 smem[];
  __shared__ unsigned int kept_s[kThreads / kWarp];  // blocks kept per warp
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
  stage_caps(col_caps, num_chunks, cap_s);
  if (threadIdx.x < kThreads / kWarp) kept_s[threadIdx.x] = 0;
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
    const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 row_cap = valid ? row_caps[2 * (row / kChunk)] : none;
    const float4 row_bins = valid ? row_caps[2 * (row / kChunk) + 1] : none;
    const float reach = warp_reach(largest, w_row, row_cap.w);

    for (int chunk0 = 0; chunk0 < num_chunks; chunk0 += kWarp) {
      unsigned int kept = kept_chunks<COLS_BINNED>(
          chunk0, num_chunks, reach, row_cap, row_bins, cap_s, kept_s,
          kept_blocks != nullptr);
      for (; kept != 0u; kept &= kept - 1u) {  // ascending chunks ((4))
        const int chunk = chunk0 + __ffs(kept) - 1;
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
  add_kept(kept_s, kept_blocks);
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
// row, to keep a row's registers beside the chunk mask within 64.
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
    const float* __restrict__ caps1,   // (N1, T / kChunk, kCapWidth)
    const float* __restrict__ caps2,   // (N2, T / kChunk, kCapWidth)
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    const float* __restrict__ table,   // (B, W): E thresholds + parameters
    const int* __restrict__ layout,    // spans (B, S, 3), entries (N, 2)
    int num_bins, int table_width, int num_edges, int edge0, int num_group,
    int tile_size, int num_sub, int num_entries,
    float* __restrict__ partial,       // (P, B, E)
    unsigned long long* kept_blocks) { // the device's total, or null
  const int num_chunks = tile_size / kChunk;
  const int num_spans = num_bins * num_sub;
  extern __shared__ float4 smem[];
  __shared__ unsigned int kept_s[kThreads / kWarp];  // blocks kept per warp
  float4* col_a = smem;              // (T)
  float4* col_b = smem + tile_size;  // (T)
  float4* cap_s = smem + 2 * tile_size;  // (T / kChunk, 2) column caps
  // (B * S) base weight bits, start, split, stop of the entries
  int4* span_s = reinterpret_cast<int4*>(cap_s + 2 * num_chunks);
  float* thr_s = reinterpret_cast<float*>(span_s + num_spans);  // (B, NE)
  float2* entry_s = reinterpret_cast<float2*>(thr_s + num_bins * NE);  // (N)
  float2* coef_s = entry_s + num_entries;  // (B) inv_d, lo_scaled
  float* row_val = reinterpret_cast<float*>(coef_s + num_bins);     // (T, NE)
  int* row_bin = reinterpret_cast<int*>(row_val + tile_size * NE);  // (T)

  const long long k = blockIdx.x;
  const float* rows = lanes1 + static_cast<long long>(tile1[k]) * 8 * tile_size;
  const float* cols = lanes2 + static_cast<long long>(tile2[k]) * 8 * tile_size;
  const float4* row_caps = reinterpret_cast<const float4*>(
      caps1 + static_cast<long long>(tile1[k]) * num_chunks * kCapWidth);
  const float4* col_caps = reinterpret_cast<const float4*>(
      caps2 + static_cast<long long>(tile2[k]) * num_chunks * kCapWidth);
  stage_columns(cols, tile_size, col_a, col_b);
  stage_thresholds<NE>(table, num_bins, table_width, edge0, num_group, thr_s);
  stage_caps(col_caps, num_chunks, cap_s);
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
  if (threadIdx.x < kThreads / kWarp) kept_s[threadIdx.x] = 0;
  __syncthreads();

  const float last_sub = static_cast<float>(num_sub - 1);
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
    const float zr = rows[7 * tile_size + at];
    const int bin = min(max(static_cast<int>(zr), 0), num_bins - 1);
    float acc[NE];
    float reach = -1.0f;  // the row's largest threshold of this launch
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      acc[e] = 0.0f;
      reach = fmaxf(reach, thr_s[bin * NE + e]);
    }
    reach = valid ? reach : -1.0f;
    const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 row_cap = valid ? row_caps[2 * (row / kChunk)] : none;
    const float4 row_bins = valid ? row_caps[2 * (row / kChunk) + 1] : none;
    const float chunk_reach =
        warp_reach(reach, rows[6 * tile_size + at], row_cap.w);

    for (int chunk0 = 0; chunk0 < num_chunks; chunk0 += kWarp) {
      // (d): only the kept column chunks, in ascending order
      unsigned int kept = kept_chunks<COLS_BINNED>(
          chunk0, num_chunks, chunk_reach, row_cap, row_bins, cap_s, kept_s,
          kept_blocks != nullptr);
      for (; kept != 0u; kept &= kept - 1u) {
        const int chunk = chunk0 + __ffs(kept) - 1;
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

          // (c): a pair no edge counts (beyond the row's largest threshold
          // or, with binned columns, in another bin) would add 0 to every
          // accumulator, and an accumulator that starts at +0 is never -0,
          // so adding +0 is the identity: its weight is skipped
          bool counted = chord2 <= reach;
          if constexpr (COLS_BINNED) {
            // exact compare of the float bin lanes
            counted = counted && c.w == zr;
          }
          if (counted) {
            add_weighted<NE, DIRECT>(chord2, a.w, thr_s + bin * NE,
                                     coef_s[bin], span_s + bin * num_sub,
                                     entry_s, last_sub, acc);
          }
        }
      }
    }

    if (valid) {
      const float w_row = rows[6 * tile_size + row];
      row_bin[row] = bin;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        row_val[row * NE + e] = __fmul_rn(w_row, acc[e]);
      }
    }
  }
  __syncthreads();
  add_kept(kept_s, kept_blocks);
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
  unsigned long long* kept_blocks;
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
                tile * sizeof(int) + bins * NE * sizeof(float) +
                2 * (tile / kChunk) * sizeof(float4);
  const unsigned int blocks = static_cast<unsigned int>(a.num_pairs);
  int status;
  if constexpr (YAWT_DIRECT == kCumulative) {
    auto kernel = paircount_partials_kernel<NE, COLS_BINNED>;
    status = prepare(kernel, smem);
    if (status != 0) return status;
    kernel<<<blocks, kThreads, smem, a.stream>>>(
        a.lanes1, a.lanes2, a.caps1, a.caps2, a.tile1, a.tile2, a.table,
        a.num_bins, a.table_width, a.num_edges, a.edge0, a.num_group,
        a.tile_size, a.partial, a.kept_blocks);
  } else {
    smem += bins * a.num_sub * sizeof(int4) +
            static_cast<size_t>(a.num_entries) * sizeof(float2) +
            bins * sizeof(float2);
    auto kernel = paircount_direct_kernel<NE, COLS_BINNED, YAWT_DIRECT>;
    status = prepare(kernel, smem);
    if (status != 0) return status;
    kernel<<<blocks, kThreads, smem, a.stream>>>(
        a.lanes1, a.lanes2, a.caps1, a.caps2, a.tile1, a.tile2, a.table,
        a.layout, a.num_bins, a.table_width, a.num_edges, a.edge0,
        a.num_group, a.tile_size, a.num_sub, a.num_entries, a.partial,
        a.kept_blocks);
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

// Kernel C (K2.1): see the note at the top. C0, the reach of every row
// chunk for this launch's edge group: one warp per chunk, one row per lane,
// in chunk_keep_mask's float32 operations (ops/paircount.py::chunk_reach).
// Thread 0 also zeroes the work list's length and its next item for C1 and
// C2, which follow on the stream.
__global__ void __launch_bounds__(kThreads) flag_reach_kernel(
    const float* __restrict__ lanes1,  // (N1, 8, T) row tiles
    const float* __restrict__ caps1,   // (N1, T / kChunk, kCapWidth)
    long long num_chunks_total,        // N1 * T / kChunk
    const float* __restrict__ table,   // (B, E) thresholds
    const float* __restrict__ band,    // (B, E) half-widths
    int num_bins, int num_edges, int edge0, int num_group, int tile_size,
    float* __restrict__ reach,         // (N1, T / kChunk)
    int* __restrict__ counters) {      // work-list length, next item
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counters[0] = 0;
    counters[1] = 0;
  }
  const long long chunk =
      static_cast<long long>(blockIdx.x) * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (chunk >= num_chunks_total) return;  // warp-uniform
  const int num_chunks = tile_size / kChunk;
  const long long tile = chunk / num_chunks;
  const int row = static_cast<int>(chunk % num_chunks) * kChunk + threadIdx.x % kWarp;
  const float* rows = lanes1 + tile * 8 * tile_size;
  const float w_row = rows[6 * tile_size + row];
  const float zr = rows[7 * tile_size + row];
  const int bin = min(max(static_cast<int>(zr), 0), num_bins - 1);
  float largest = -1.0f;  // the row's largest t + band
  for (int e = 0; e < num_group; ++e) {
    const int at = bin * num_edges + edge0 + e;
    largest = fmaxf(largest, __fadd_rn(table[at], band[at]));
  }
  // -inf for a chunk that can flag nothing
  const float chunk_reach =
      warp_reach(largest, w_row, caps1[chunk * kCapWidth + 3]);
  if (threadIdx.x % kWarp == 0) reach[chunk] = chunk_reach;
}

// C1, the triage: one warp per entry, from the chunk caps and C0's reach
// alone. Lane u tests work unit u = (row chunk r, run g of kItemChunks
// column chunks) against each column chunk of the run (chunk_reaches, and
// with binned columns the bin ranges: chunk_keep_mask's rule) and, where it
// keeps any, appends the item (entry, u << 16 | mask) through one atomicAdd
// per warp. An entry an earlier edge group flagged gets no items.
template <bool COLS_BINNED>
__global__ void __launch_bounds__(kThreads) flag_triage_kernel(
    const float* __restrict__ caps1,   // (N1, T / kChunk, kCapWidth)
    const float* __restrict__ caps2,   // (N2, T / kChunk, kCapWidth)
    const float* __restrict__ reach,   // (N1, T / kChunk), from C0
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    long long num_pairs, int tile_size, int edge0,
    const unsigned char* __restrict__ flags,  // (P,)
    uint2* __restrict__ items,         // (P * K * G) work list
    int* __restrict__ counters) {      // work-list length, next item
  const long long k =
      static_cast<long long>(blockIdx.x) * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (k >= num_pairs) return;            // warp-uniform
  if (edge0 > 0 && flags[k]) return;     // flagged by an earlier group
  const int lane = threadIdx.x % kWarp;
  const int num_chunks = tile_size / kChunk;
  const int num_runs = (num_chunks + kItemChunks - 1) / kItemChunks;
  const float4* row_caps = reinterpret_cast<const float4*>(
      caps1 + static_cast<long long>(tile1[k]) * num_chunks * kCapWidth);
  const float4* col_caps = reinterpret_cast<const float4*>(
      caps2 + static_cast<long long>(tile2[k]) * num_chunks * kCapWidth);
  const float* row_reach = reach + static_cast<long long>(tile1[k]) * num_chunks;
  for (int base = 0; base < num_chunks * num_runs; base += kWarp) {
    const int unit = base + lane;
    unsigned int mask = 0;
    if (unit < num_chunks * num_runs) {
      const int r = unit / num_runs;
      const int c0 = (unit % num_runs) * kItemChunks;
      const float4 row_cap = row_caps[2 * r];
      const float4 row_bins = row_caps[2 * r + 1];
      const float row_far = row_reach[r];
      for (int i = 0; i < kItemChunks && c0 + i < num_chunks; ++i) {
        bool keep = chunk_reaches(row_far, row_cap, col_caps[2 * (c0 + i)]);
        if constexpr (COLS_BINNED) {
          const float4 col_bins = col_caps[2 * (c0 + i) + 1];
          keep = keep && !(row_bins.y < col_bins.x || col_bins.y < row_bins.x);
        }
        mask |= keep ? 1u << i : 0u;
      }
    }
    const unsigned int emit = __ballot_sync(0xffffffffu, mask != 0);
    if (emit == 0) continue;  // warp-uniform
    int at = 0;
    if (lane == 0) at = atomicAdd(counters, __popc(emit));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (mask != 0) {
      at += __popc(emit & ((1u << lane) - 1));
      items[at] = make_uint2(static_cast<unsigned int>(k),
                             static_cast<unsigned int>(unit) << 16 | mask);
    }
  }
}

// One column chunk (8 channels x kChunk floats, 1 KB) of the column tile
// into a warp's shared-memory slot, channel-major, as 64 16-byte cp.async
// copies, two per lane. T is a multiple of kChunk and the lanes 16-byte
// aligned, so every source is.
__device__ __forceinline__ void stage_chunk(float* slot, const float* cols,
                                            int tile_size, int lane) {
#pragma unroll
  for (int i = 0; i < 8 * kChunk / 4 / kWarp; ++i) {
    const int piece = lane + i * kWarp;
    const int channel = piece / (kChunk / 4);
    const int quad = piece % (kChunk / 4);
    const unsigned int to = static_cast<unsigned int>(
        __cvta_generic_to_shared(slot + channel * kChunk + 4 * quad));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(cols + channel * tile_size + 4 * quad));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Which columns of the staged chunk a row chunk needs (a warp ballot,
// lane j for column j): nonzero weight, within the chunk's reach of its
// cap's center (chunk_reaches with the column's hi position as a cap of
// radius 0) and, with binned columns, a bin in the chunk's bin range.
template <bool COLS_BINNED>
__device__ __forceinline__ unsigned int needed_columns(const float* slot,
                                                       float row_far,
                                                       float4 row_cap,
                                                       float4 row_bins,
                                                       int lane) {
  const float4 point = make_float4(slot[lane], slot[kChunk + lane],
                                   slot[2 * kChunk + lane], 0.0f);
  bool need = slot[6 * kChunk + lane] != 0.0f &&
              chunk_reaches(row_far, row_cap, point);
  if constexpr (COLS_BINNED) {
    const float bin = slot[7 * kChunk + lane];
    need = need && !(bin < row_bins.x || row_bins.y < bin);
  }
  return __ballot_sync(0xffffffffu, need);
}

// Whether any valid pair of a lane's row and the staged chunk's columns in
// the quads (groups of 4 columns) of quad_mask lies within the band of an
// edge: K1.1's chord in its operations and order, 16 + 3E float32
// operations per pair. The columns of weight 0 hold a NaN x, so their
// chords are NaN and never near: no pair tests the column weight.
template <int NE, bool COLS_BINNED>
__device__ __forceinline__ bool chunk_hits(const float* slot,
                                           unsigned int quad_mask, float xh,
                                           float yh, float zh, float xl,
                                           float yl, float zl, float zr,
                                           const float (&thr)[NE],
                                           const float (&bnd)[NE]) {
  const float4* s = reinterpret_cast<const float4*>(slot);
  constexpr int kQuads = kChunk / 4;
  bool hit = false;
  for (; quad_mask != 0; quad_mask &= quad_mask - 1) {
    const int q = __ffs(quad_mask) - 1;
    const float4 axh = s[0 * kQuads + q];
    const float4 ayh = s[1 * kQuads + q];
    const float4 azh = s[2 * kQuads + q];
    const float4 axl = s[3 * kQuads + q];
    const float4 ayl = s[4 * kQuads + q];
    const float4 azl = s[5 * kQuads + q];
    float4 az = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (COLS_BINNED) az = s[7 * kQuads + q];
    const float cxh[4] = {axh.x, axh.y, axh.z, axh.w};
    const float cyh[4] = {ayh.x, ayh.y, ayh.z, ayh.w};
    const float czh[4] = {azh.x, azh.y, azh.z, azh.w};
    const float cxl[4] = {axl.x, axl.y, axl.z, axl.w};
    const float cyl[4] = {ayl.x, ayl.y, ayl.z, ayl.w};
    const float czl[4] = {azl.x, azl.y, azl.z, azl.w};
    const float cz[4] = {az.x, az.y, az.z, az.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // compensated difference: (hi1 - hi2) + (lo1 - lo2)
      const float dx = __fadd_rn(__fsub_rn(xh, cxh[j]), __fsub_rn(xl, cxl[j]));
      const float dy = __fadd_rn(__fsub_rn(yh, cyh[j]), __fsub_rn(yl, cyl[j]));
      const float dz = __fadd_rn(__fsub_rn(zh, czh[j]), __fsub_rn(zl, czl[j]));
      float chord2 = __fmul_rn(dx, dx);
      chord2 = __fadd_rn(chord2, __fmul_rn(dy, dy));
      chord2 = __fadd_rn(chord2, __fmul_rn(dz, dz));
      bool near = false;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        near = near || fabsf(__fsub_rn(chord2, thr[e])) <= bnd[e];
      }
      bool ok = true;  // columns of weight 0 hold NaN (flag_evaluate_kernel)
      if constexpr (COLS_BINNED) {
        ok = cz[j] == zr;  // exact compare of the float bin lanes
      }
      hit = hit || (ok && near);
    }
  }
  return hit;
}

// C2, the evaluation: a persistent grid whose warps take C1's items in turn
// (a warp-level atomicAdd on the next item, fetched one item ahead). An
// item whose entry is flagged already is dropped; otherwise lane r holds
// row r of the item's row chunk in registers and the warp walks the mask's
// column chunks, staging chunk i + 1 with cp.async into the other half of
// its double buffer while it evaluates chunk i: first which of its columns
// the row chunk needs (needed_columns), then the pairs of the quads of 4
// columns that hold one. The first hit stores 1 into flags[entry] and ends
// the item. Only __syncwarp and cp.async.wait_group order the warp; there
// is no block-wide barrier.
template <int NE, bool COLS_BINNED>
__global__ void __launch_bounds__(kThreads) flag_evaluate_kernel(
    const float* __restrict__ lanes1,  // (N1, 8, T) row tiles
    const float* __restrict__ lanes2,  // (N2, 8, T) column tiles
    const float* __restrict__ caps1,   // (N1, T / kChunk, kCapWidth)
    const float* __restrict__ reach,   // (N1, T / kChunk), from C0
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    const float* __restrict__ table,   // (B, E) thresholds
    const float* __restrict__ band,    // (B, E) half-widths
    int num_bins, int num_edges, int edge0, int num_group, int tile_size,
    const uint2* __restrict__ items,   // from C1
    int* __restrict__ counters,        // work-list length, next item
    unsigned char* flags) {            // (P,), read and written by many warps
  __shared__ __align__(16) float stage[kThreads / kWarp][2][8 * kChunk];
  const int lane = threadIdx.x % kWarp;
  float* slots = stage[threadIdx.x / kWarp][0];
  const int num_items = counters[0];
  const int num_chunks = tile_size / kChunk;
  const int num_runs = (num_chunks + kItemChunks - 1) / kItemChunks;
  volatile unsigned char* seen = flags;  // other blocks' stores included

  int item = 0;
  if (lane == 0) item = atomicAdd(counters + 1, 1);
  item = __shfl_sync(0xffffffffu, item, 0);
  while (item < num_items) {
    int next = 0;
    if (lane == 0) next = atomicAdd(counters + 1, 1);  // in flight meanwhile
    const uint2 work = items[item];
    const unsigned int entry = work.x;
    if (!seen[entry]) {  // warp-uniform: one address
      const unsigned int unit = work.y >> 16;
      unsigned int mask = work.y & 0xffffu;
      const int r = static_cast<int>(unit) / num_runs;
      const int c0 = (static_cast<int>(unit) % num_runs) * kItemChunks;
      const long long row_chunk = static_cast<long long>(tile1[entry]) * num_chunks + r;
      const float* rows = lanes1 + static_cast<long long>(tile1[entry]) * 8 * tile_size +
                          r * kChunk + lane;
      const float* cols = lanes2 + static_cast<long long>(tile2[entry]) * 8 * tile_size +
                          c0 * kChunk;
      int chunk = __ffs(mask) - 1;
      mask &= mask - 1;
      stage_chunk(slots, cols + chunk * kChunk, tile_size, lane);
      // one row per lane: 8 coalesced 128-byte loads
      const float xh = rows[0];
      const float yh = rows[tile_size];
      const float zh = rows[2 * tile_size];
      const float xl = rows[3 * tile_size];
      const float yl = rows[4 * tile_size];
      const float zl = rows[5 * tile_size];
      const float w_row = rows[6 * tile_size];
      const float zr = rows[7 * tile_size];
      const int bin = min(max(static_cast<int>(zr), 0), num_bins - 1);
      const float4* row_caps = reinterpret_cast<const float4*>(caps1) + 2 * row_chunk;
      const float4 row_cap = row_caps[0];
      const float4 row_bins = row_caps[1];
      const float row_far = reach[row_chunk];
      // edges beyond the group: t = band = -1, |chord2 + 1| <= -1 never holds
      float thr[NE];
      float bnd[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        thr[e] = -1.0f;
        bnd[e] = -1.0f;
        if (e < num_group) {
          thr[e] = table[bin * num_edges + edge0 + e];
          bnd[e] = band[bin * num_edges + edge0 + e];
        }
      }
      const bool row_ok = w_row != 0.0f;
      int buffer = 0;
      bool found = false;
      while (true) {
        const bool more = mask != 0;
        if (more) {
          chunk = __ffs(mask) - 1;
          mask &= mask - 1;
          stage_chunk(slots + (buffer ^ 1) * 8 * kChunk, cols + chunk * kChunk,
                      tile_size, lane);
          wait_staged<1>();
        } else {
          wait_staged<0>();
        }
        __syncwarp();
        float* slot = slots + buffer * 8 * kChunk;
        const unsigned int columns =
            needed_columns<COLS_BINNED>(slot, row_far, row_cap, row_bins, lane);
        // a column of weight 0 is never near: NaN chords compare false
        if (slot[6 * kChunk + lane] == 0.0f) slot[lane] = CUDART_NAN_F;
        __syncwarp();
        // lane q < 8: does quad q hold a needed column?
        const unsigned int quads = __ballot_sync(
            0xffffffffu,
            lane < kChunk / 4 && ((columns >> (4 * (lane % 8))) & 0xfu) != 0);
        const bool hit = chunk_hits<NE, COLS_BINNED>(
            slot, quads, xh, yh, zh, xl, yl, zl, zr, thr, bnd);
        found = __any_sync(0xffffffffu, hit && row_ok);
        __syncwarp();  // the chunk is read before its slot is staged again
        if (found || !more) break;
        buffer ^= 1;
      }
      wait_staged<0>();  // a chunk still in flight after a hit
      __syncwarp();
      if (found && lane == 0) seen[entry] = 1;
    }
    item = __shfl_sync(0xffffffffu, next, 0);
  }
}

struct FlagLaunch {
  const float* lanes1;
  const float* lanes2;
  const float* caps1;
  const float* caps2;
  const int* tile1;
  const int* tile2;
  long long num_tiles1;
  long long num_pairs;
  const float* table;
  const float* band;
  int num_bins, num_edges, edge0, num_group, tile_size;
  float* reach;
  uint2* items;
  int* counters;
  unsigned char* flags;
  cudaStream_t stream;
};

unsigned int warp_blocks(long long warps) {
  constexpr long long per_block = kThreads / kWarp;
  return static_cast<unsigned int>((warps + per_block - 1) / per_block);
}

int launch_reach(const FlagLaunch& a) {
  const long long chunks = a.num_tiles1 * (a.tile_size / kChunk);
  flag_reach_kernel<<<warp_blocks(chunks), kThreads, 0, a.stream>>>(
      a.lanes1, a.caps1, chunks, a.table, a.band, a.num_bins, a.num_edges,
      a.edge0, a.num_group, a.tile_size, a.reach, a.counters);
  return static_cast<int>(cudaGetLastError());
}

int launch_triage(const FlagLaunch& a, bool cols_binned) {
  auto kernel = cols_binned ? flag_triage_kernel<true> : flag_triage_kernel<false>;
  kernel<<<warp_blocks(a.num_pairs), kThreads, 0, a.stream>>>(
      a.caps1, a.caps2, a.reach, a.tile1, a.tile2, a.num_pairs, a.tile_size,
      a.edge0, a.flags, a.items, a.counters);
  return static_cast<int>(cudaGetLastError());
}

// A persistent grid: as many blocks as fit the SMs at once (from the
// kernel's occupancy, queried at its first launch, so that later launches
// can be captured in a CUDA graph), but no more warps than items the list
// can hold.
template <int NE, bool COLS_BINNED>
int launch_evaluate(const FlagLaunch& a) {
  auto kernel = flag_evaluate_kernel<NE, COLS_BINNED>;
  static std::atomic<int> occupancy{0};  // blocks per SM, 0 until queried
  int device = 0;
  int sms = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (status == cudaSuccess && occupancy.load() == 0) {
    int per_sm = 0;
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, 0);
    occupancy.store(std::max(per_sm, 1));
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  const int chunks = a.tile_size / kChunk;
  const long long capacity =
      a.num_pairs * chunks * ((chunks + kItemChunks - 1) / kItemChunks);
  const unsigned int blocks = static_cast<unsigned int>(std::min<long long>(
      static_cast<long long>(occupancy.load()) * sms, warp_blocks(capacity)));
  kernel<<<blocks, kThreads, 0, a.stream>>>(
      a.lanes1, a.lanes2, a.caps1, a.reach, a.tile1, a.tile2, a.table, a.band,
      a.num_bins, a.num_edges, a.edge0, a.num_group, a.tile_size, a.items,
      a.counters, a.flags);
  return static_cast<int>(cudaGetLastError());
}

template <bool COLS_BINNED>
int dispatch_evaluate(const FlagLaunch& a) {
  if (a.num_group <= 1) return launch_evaluate<1, COLS_BINNED>(a);
  if (a.num_group <= 2) return launch_evaluate<2, COLS_BINNED>(a);
  if (a.num_group <= 4) return launch_evaluate<4, COLS_BINNED>(a);
  if (a.num_group <= 8) return launch_evaluate<8, COLS_BINNED>(a);
  return launch_evaluate<16, COLS_BINNED>(a);
}
#endif

}  // namespace

extern "C" {

// The counting mode this library was built for: 0 cumulative, 1 direct
// small-angle, 2 direct arcsine.
int yawt_paircount_mode() { return YAWT_DIRECT; }

// Points per chunk cap that yawt_paircount_partials reads (caps1 / caps2).
int yawt_paircount_chunk() { return kChunk; }

// Bytes of the kept-block total that yawt_paircount_partials adds to (an
// unsigned 64-bit integer).
int yawt_kept_total_bytes() { return sizeof(unsigned long long); }

// One launch of kernel A for the counting edges [edge0, edge0 + num_group)
// of a (num_bins, table_width) table whose first num_edges columns are
// squared-chord thresholds and, in direct mode, whose remaining columns
// are the weight parameters [inv_d, lo_scaled, gc0, gc1, entries...]
// (num_sub uniform sub-intervals). Every build reads the tiles' chunk caps
// caps1 / caps2, (N, T / 32, 8) float32 each (ops/tiles.py::chunk_caps; T
// a multiple of 32). In direct mode, layout holds the
// int32 (num_bins, num_sub, 3) entry spans followed by the num_entries
// (thr, g) float32 entries (ops/gweight.py::EntryLayout.packed); the
// cumulative build ignores num_sub, layout and num_entries.
// The launch adds the 32 x 32 chunk blocks it evaluates to *kept_blocks
// unless it is null.
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
                            int num_entries, float* partial,
                            unsigned long long* kept_blocks, void* stream) {
  const Launch a{lanes1, lanes2, caps1, caps2, tile1, tile2, num_pairs, table,
                 num_bins, table_width, num_edges, edge0, num_group,
                 tile_size, num_sub, layout, num_entries, partial,
                 kept_blocks, static_cast<cudaStream_t>(stream)};
  return cols_binned ? dispatch_edges<true>(a) : dispatch_edges<false>(a);
}

#if YAWT_DIRECT == 0
// Column chunks per work item of kernel C (checked when the library is
// loaded).
int yawt_flag_item_chunks() { return kItemChunks; }

// Kernel C (the audit's flag pass) for the edges [edge0, edge0 + num_group)
// of the (num_bins, num_edges) float32 table and band, 1 <= num_group <=
// 16: three launches on the stream, C0 (the reach of each row chunk), C1
// (the triage into a work list) and C2 (the evaluation), with no host
// synchronisation between them. flags, (num_pairs,) bytes, must hold 0 for
// the first group (edge0 = 0) and the earlier groups' flags for a later one:
// the launch only stores 1, into the entries with a valid pair within the
// band of one of its edges. caps1 / caps2 as for yawt_paircount_partials;
// the workspace comes from the caller: reach, (num_tiles1, T / 32) float32;
// items, (num_pairs * K * G) pairs of uint32 with K = T / 32 and G = ceil(K
// / 16) (K * G < 65536); counters, 2 int32. Returns cudaGetLastError()
// after the first launch that fails, or 0.
int yawt_boundary_flags(const float* lanes1, const float* lanes2,
                        const float* caps1, const float* caps2,
                        const int* tile1, const int* tile2,
                        long long num_tiles1, long long num_pairs,
                        const float* table, const float* band, int num_bins,
                        int num_edges, int edge0, int num_group,
                        int tile_size, int cols_binned, float* reach,
                        unsigned int* items, int* counters,
                        unsigned char* flags, void* stream) {
  const FlagLaunch a{lanes1, lanes2, caps1, caps2, tile1, tile2, num_tiles1,
                     num_pairs, table, band, num_bins, num_edges, edge0,
                     num_group, tile_size, reach,
                     reinterpret_cast<uint2*>(items), counters, flags,
                     static_cast<cudaStream_t>(stream)};
  int status = launch_reach(a);
  if (status == 0) status = launch_triage(a, cols_binned != 0);
  if (status == 0) {
    status = cols_binned ? dispatch_evaluate<true>(a) : dispatch_evaluate<false>(a);
  }
  return status;
}

// C0 alone, as in yawt_boundary_flags (it also zeroes counters).
int yawt_flag_reach(const float* lanes1, const float* caps1,
                    long long num_tiles1, const float* table,
                    const float* band, int num_bins, int num_edges, int edge0,
                    int num_group, int tile_size, float* reach, int* counters,
                    void* stream) {
  FlagLaunch a{};
  a.lanes1 = lanes1;
  a.caps1 = caps1;
  a.num_tiles1 = num_tiles1;
  a.table = table;
  a.band = band;
  a.num_bins = num_bins;
  a.num_edges = num_edges;
  a.edge0 = edge0;
  a.num_group = num_group;
  a.tile_size = tile_size;
  a.reach = reach;
  a.counters = counters;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_reach(a);
}

// C1 alone, as in yawt_boundary_flags, after C0 (counters zeroed): the
// work list's length ends in counters[0].
int yawt_flag_triage(const float* caps1, const float* caps2,
                     const float* reach, const int* tile1, const int* tile2,
                     long long num_pairs, int tile_size, int edge0,
                     int cols_binned, const unsigned char* flags,
                     unsigned int* items, int* counters, void* stream) {
  FlagLaunch a{};
  a.caps1 = caps1;
  a.caps2 = caps2;
  a.reach = const_cast<float*>(reach);
  a.tile1 = tile1;
  a.tile2 = tile2;
  a.num_pairs = num_pairs;
  a.tile_size = tile_size;
  a.edge0 = edge0;
  a.flags = const_cast<unsigned char*>(flags);
  a.items = reinterpret_cast<uint2*>(items);
  a.counters = counters;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_triage(a, cols_binned != 0);
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
