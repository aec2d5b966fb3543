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
//   A. paircount_partials: one thread block per entry k of the tile-pair
//      list. The column tile is staged in shared memory; each thread owns
//      rows of the row tile, gathers its row's thresholds (and, in direct
//      mode, the row bin's weight parameters) from the table by the row's
//      bin id (an exact gather) into registers, walks the T columns with
//      the compensated (hi, lo) squared chord, and counts the weighted
//      pairs at or below each threshold. The rows are then reduced into the
//      (bin, edge) block by row weight, in a fixed order, and written to
//      partial[k]. No float atomics: the result is the same on every run.
//   B. segment_sum: the pair list is sorted by patch-pair slot, so each
//      slot owns a contiguous run of partials. One thread per output
//      element sums its run in list order (the order in which the TPU
//      kernel revisit-accumulates). A slot without entries gets zero.
//
// The source is compiled once per counting mode (-DYAWT_DIRECT=0, 1 or 2:
// cumulative, direct small-angle, direct arcsine), each build into its own
// library with the same C interface, so the builds run in parallel. Within
// a build the variants are template instances: NE (counting edges per
// launch), COLS_BINNED, and in direct mode ADJ (adjustment entries per
// side held in registers).
//
// Bound: float32 ALU work per candidate pair: 15 operations for the
// compensated chord, 1 for the column weight, 3 per counting edge, and in
// direct mode about 12 (small-angle) or 18 (arcsine) for the weight plus 3
// per adjustment entry; 512 x 512 pairs per tile pair. Device memory
// traffic is 32 B per point per tile pair. The arithmetic uses
// __fsub_rn / __fadd_rn / __fmul_rn and the library is built with
// --fmad=false and without fast-math, so no FMA contraction or approximate
// logf/expf changes its rounding: it matches the plain PyTorch version
// operation for operation, up to the order of float32 sums.

#include <cuda_runtime.h>

#ifndef YAWT_DIRECT
#define YAWT_DIRECT 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr int kWarp = 32;

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
  const float t =
      big ? sqrtf(fmaxf(__fmul_rn(0.5f, __fsub_rn(1.0f, s)), 0.0f)) : s;
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

// Per-row weight parameters of the direct mode, for ADJ below- and ADJ
// above-entries (unused entries carry k = -1, which no index equals).
template <int ADJ>
struct DirectRow {
  float inv_d, lo_scaled, gc0, gc1;
  float bk[ADJ], bt[ADJ], bv[ADJ];
  float ak[ADJ], at[ADJ], av[ADJ];
};

template <>
struct DirectRow<0> {};

template <int NE, bool COLS_BINNED, int DIRECT, int ADJ>
__global__ void __launch_bounds__(kThreads) paircount_partials_kernel(
    const float* __restrict__ lanes1,  // (N1, 8, T) row tiles
    const float* __restrict__ lanes2,  // (N2, 8, T) column tiles
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    const float* __restrict__ table,   // (B, W): E thresholds [+ parameters]
    int num_bins, int table_width, int num_edges, int edge0, int num_group,
    int tile_size, int num_grid, int num_below, int num_above,
    float* __restrict__ partial) {     // (P, B, E)
  constexpr int kParamWidth = DIRECT == kCumulative ? 0 : 4 + 6 * ADJ;
  extern __shared__ float4 smem[];
  float4* col_a = smem;              // (T) x_hi, y_hi, z_hi, weight
  float4* col_b = smem + tile_size;  // (T) x_lo, y_lo, z_lo, bin
  float* row_val = reinterpret_cast<float*>(smem + 2 * tile_size);  // (T, NE)
  int* row_bin = reinterpret_cast<int*>(row_val + tile_size * NE);  // (T)
  float* thr_s = reinterpret_cast<float*>(row_bin + tile_size);     // (B, NE)
  float* par_s = thr_s + num_bins * NE;  // (B, kParamWidth), direct mode

  const long long k = blockIdx.x;
  const float* rows = lanes1 + static_cast<long long>(tile1[k]) * 8 * tile_size;
  const float* cols = lanes2 + static_cast<long long>(tile2[k]) * 8 * tile_size;

  for (int j = threadIdx.x; j < tile_size; j += blockDim.x) {
    col_a[j] = make_float4(cols[j], cols[tile_size + j],
                           cols[2 * tile_size + j], cols[6 * tile_size + j]);
    col_b[j] = make_float4(cols[3 * tile_size + j], cols[4 * tile_size + j],
                           cols[5 * tile_size + j], cols[7 * tile_size + j]);
  }
  // edges beyond this launch's group get a negative threshold: a squared
  // chord is never below it, and those slots are never written
  for (int i = threadIdx.x; i < num_bins * NE; i += blockDim.x) {
    const int b = i / NE;
    const int e = i % NE;
    thr_s[i] = e < num_group ? table[b * table_width + edge0 + e] : -1.0f;
  }
  if constexpr (DIRECT != kCumulative) {
    // [inv_d, lo_scaled, gc0, gc1, below (k, thr, g) x ADJ, above x ADJ],
    // padded from the table's num_below / num_above entries with k = -1
    for (int i = threadIdx.x; i < num_bins * kParamWidth; i += blockDim.x) {
      const int b = i / kParamWidth;
      const int c = i % kParamWidth;
      const float* src = table + b * table_width + num_edges;
      float value;
      if (c < 4) {
        value = src[c];
      } else {
        const int entry = (c - 4) / 3;  // 0 .. 2 * ADJ - 1
        const int field = (c - 4) % 3;
        const bool above = entry >= ADJ;
        const int n = above ? entry - ADJ : entry;
        const bool used = n < (above ? num_above : num_below);
        const int col = 4 + 3 * (above ? num_below + n : n) + field;
        value = used ? src[col] : (field == 0 ? -1.0f : 0.0f);
      }
      par_s[i] = value;
    }
  }
  __syncthreads();

  for (int base = 0; base < tile_size; base += kRowsPerThread * blockDim.x) {
    float xh[kRowsPerThread], yh[kRowsPerThread], zh[kRowsPerThread];
    float xl[kRowsPerThread], yl[kRowsPerThread], zl[kRowsPerThread];
    float zr[kRowsPerThread];
    float thr[kRowsPerThread][NE];
    float acc[kRowsPerThread][NE];
    DirectRow<DIRECT == kCumulative ? 0 : ADJ> dp[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
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
      const int bin = min(max(static_cast<int>(zr[r]), 0), num_bins - 1);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        thr[r][e] = valid ? thr_s[bin * NE + e] : -1.0f;
        acc[r][e] = 0.0f;
      }
      if constexpr (DIRECT != kCumulative) {
        const float* p = par_s + bin * kParamWidth;
        dp[r].inv_d = p[0];
        dp[r].lo_scaled = p[1];
        dp[r].gc0 = p[2];
        dp[r].gc1 = p[3];
#pragma unroll
        for (int n = 0; n < ADJ; ++n) {
          dp[r].bk[n] = p[4 + 3 * n];
          dp[r].bt[n] = p[5 + 3 * n];
          dp[r].bv[n] = p[6 + 3 * n];
          dp[r].ak[n] = p[4 + 3 * (ADJ + n)];
          dp[r].at[n] = p[5 + 3 * (ADJ + n)];
          dp[r].av[n] = p[6 + 3 * (ADJ + n)];
        }
      }
    }

    for (int j = 0; j < tile_size; ++j) {
      const float4 a = col_a[j];
      const float4 c = col_b[j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        // compensated difference: (hi1 - hi2) + (lo1 - lo2)
        const float dx = __fadd_rn(__fsub_rn(xh[r], a.x), __fsub_rn(xl[r], c.x));
        const float dy = __fadd_rn(__fsub_rn(yh[r], a.y), __fsub_rn(yl[r], c.y));
        const float dz = __fadd_rn(__fsub_rn(zh[r], a.z), __fsub_rn(zl[r], c.z));
        float chord2 = __fmul_rn(dx, dx);
        chord2 = __fadd_rn(chord2, __fmul_rn(dy, dy));
        chord2 = __fadd_rn(chord2, __fmul_rn(dz, dz));

        float w = a.w;
        if constexpr (COLS_BINNED) {
          // exact compare of the float bin lanes
          w = c.w == zr[r] ? w : 0.0f;
        }
        if constexpr (DIRECT != kCumulative) {
          const float l10 = log10_theta<DIRECT>(chord2);
          float idx = floorf(__fsub_rn(__fmul_rn(l10, dp[r].inv_d),
                                       dp[r].lo_scaled));
          idx = fminf(fmaxf(idx, 0.0f), static_cast<float>(num_grid - 1));
          float g = expf(__fadd_rn(dp[r].gc0, __fmul_rn(dp[r].gc1, idx)));
#pragma unroll
          for (int n = 0; n < ADJ; ++n) {
            g = (idx == dp[r].bk[n] && chord2 <= dp[r].bt[n]) ? dp[r].bv[n] : g;
          }
          // ascending above-entries: a pair lands on the highest limit
          // below it
#pragma unroll
          for (int n = 0; n < ADJ; ++n) {
            g = (idx == dp[r].ak[n] && chord2 > dp[r].at[n]) ? dp[r].av[n] : g;
          }
          w = __fmul_rn(w, g);
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          acc[r][e] = __fadd_rn(acc[r][e], chord2 <= thr[r][e] ? w : 0.0f);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = base + r * blockDim.x + threadIdx.x;
      if (row < tile_size) {
        const float w_row = rows[6 * tile_size + row];
        row_bin[row] = min(max(static_cast<int>(zr[r]), 0), num_bins - 1);
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          row_val[row * NE + e] = __fmul_rn(w_row, acc[r][e]);
        }
      }
    }
  }
  __syncthreads();

  // (bin, edge) reduction over the rows in a fixed order: each warp owns
  // whole (bin, edge) entries, each lane a fixed stride of rows, then a
  // fixed shuffle tree
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

struct Launch {
  const float* lanes1;
  const float* lanes2;
  const int* tile1;
  const int* tile2;
  long long num_pairs;
  const float* table;
  int num_bins, table_width, num_edges, edge0, num_group, tile_size;
  int num_grid, num_below, num_above;
  float* partial;
  cudaStream_t stream;
};

template <int NE, bool COLS_BINNED, int ADJ>
int launch_partials(const Launch& a) {
  constexpr int kParamWidth = YAWT_DIRECT == kCumulative ? 0 : 4 + 6 * ADJ;
  const size_t smem = 2 * a.tile_size * sizeof(float4) +
                      static_cast<size_t>(a.tile_size) * NE * sizeof(float) +
                      a.tile_size * sizeof(int) +
                      static_cast<size_t>(a.num_bins) * (NE + kParamWidth) *
                          sizeof(float);
  auto kernel = paircount_partials_kernel<NE, COLS_BINNED, YAWT_DIRECT, ADJ>;
  cudaError_t status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<static_cast<unsigned int>(a.num_pairs), kThreads, smem,
           a.stream>>>(a.lanes1, a.lanes2, a.tile1, a.tile2, a.table,
                       a.num_bins, a.table_width, a.num_edges, a.edge0,
                       a.num_group, a.tile_size, a.num_grid, a.num_below,
                       a.num_above, a.partial);
  return static_cast<int>(cudaGetLastError());
}

template <bool COLS_BINNED, int ADJ>
int dispatch_edges(const Launch& a) {
  if constexpr (YAWT_DIRECT == kCumulative) {
    if (a.num_group <= 1) return launch_partials<1, COLS_BINNED, ADJ>(a);
  }
  if (a.num_group <= 2) return launch_partials<2, COLS_BINNED, ADJ>(a);
  if (a.num_group <= 4) return launch_partials<4, COLS_BINNED, ADJ>(a);
  if (a.num_group <= 8) return launch_partials<8, COLS_BINNED, ADJ>(a);
  return launch_partials<16, COLS_BINNED, ADJ>(a);
}

template <bool COLS_BINNED>
int dispatch_adjustments(const Launch& a) {
  if constexpr (YAWT_DIRECT == kCumulative) {
    return dispatch_edges<COLS_BINNED, 0>(a);
  } else {
    const int entries = a.num_below > a.num_above ? a.num_below : a.num_above;
    if (entries <= 4) return dispatch_edges<COLS_BINNED, 4>(a);
    return dispatch_edges<COLS_BINNED, 16>(a);
  }
}

#if YAWT_DIRECT == 0
__global__ void segment_sum_kernel(
    const float* __restrict__ partial,       // (P, width)
    const long long* __restrict__ offsets,   // (S + 1,) run bounds
    long long num_slots, int width,
    float* __restrict__ out) {               // (S, width)
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_slots * width) return;
  const long long slot = i / width;
  const long long column = i % width;
  float acc = 0.0f;
  for (long long k = offsets[slot]; k < offsets[slot + 1]; ++k) {
    acc = __fadd_rn(acc, partial[k * width + column]);
  }
  out[i] = acc;
}
#endif

}  // namespace

extern "C" {

// The counting mode this library was built for: 0 cumulative, 1 direct
// small-angle, 2 direct arcsine.
int yawt_paircount_mode() { return YAWT_DIRECT; }

// One launch of kernel A for the counting edges [edge0, edge0 + num_group)
// of a (num_bins, table_width) table whose first num_edges columns are
// squared-chord thresholds and, in direct mode, whose remaining columns
// are the weight parameters [inv_d, lo_scaled, gc0, gc1] followed by
// num_below + num_above (k, thr, g) entries (num_grid uniform
// sub-intervals). 1 <= num_group <= 16; in direct mode num_below and
// num_above are at most 16. Returns cudaGetLastError() after the launch,
// or the error of raising the kernel's shared-memory limit (a tile or
// table too large for one block).
int yawt_paircount_partials(const float* lanes1, const float* lanes2,
                            const int* tile1, const int* tile2,
                            long long num_pairs, const float* table,
                            int num_bins, int table_width, int num_edges,
                            int edge0, int num_group, int tile_size,
                            int cols_binned, int num_grid, int num_below,
                            int num_above, float* partial, void* stream) {
  const Launch a{lanes1, lanes2, tile1, tile2, num_pairs, table,
                 num_bins, table_width, num_edges, edge0, num_group,
                 tile_size, num_grid, num_below, num_above, partial,
                 static_cast<cudaStream_t>(stream)};
  return cols_binned ? dispatch_adjustments<true>(a)
                     : dispatch_adjustments<false>(a);
}

#if YAWT_DIRECT == 0
// One launch of kernel B. Returns cudaGetLastError() after the launch.
int yawt_segment_sum(const float* partial, const long long* offsets,
                     long long num_slots, int width, float* out, void* stream) {
  const long long total = num_slots * width;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  segment_sum_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      partial, offsets, num_slots, width, out);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // extern "C"
