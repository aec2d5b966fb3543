// Pair-count kernels for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes, see ops/cuda_paircount.py).
//
// Replaces yet_another_wizz_tpu/ops/pallas_paircount.py::_paircount_kernel
// in its cumulative, unbinned-column variant (crosscorrelate DD, DR, RD):
//
//   A. paircount_partials: one thread block per entry k of the tile-pair
//      list. The column tile is staged in shared memory; each thread owns
//      rows of the row tile, gathers its row's thresholds from the table
//      by the row's bin id (an exact gather), walks the T columns with the
//      compensated (hi, lo) squared chord, and counts the weighted pairs
//      at or below each threshold. The rows are then reduced into the
//      (bin, edge) block by row weight, in a fixed order, and written to
//      partial[k]. No float atomics: the result is the same on every run.
//   B. segment_sum: the pair list is sorted by patch-pair slot, so each
//      slot owns a contiguous run of partials. One thread per output
//      element sums its run in list order (the order in which the TPU
//      kernel revisit-accumulates). A slot without entries gets zero.
//
// Bound: float32 ALU work, about 20 operations per candidate pair (15 for
// the compensated chord, 1 compare and 1 add per edge) for 512 x 512 pairs
// per tile pair; device memory traffic is 32 B per point per tile pair.
// The chord arithmetic uses __fsub_rn / __fadd_rn / __fmul_rn, and the
// library is built with --fmad=false, so no FMA contraction changes its
// rounding: it matches the plain PyTorch version operation for operation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr int kWarp = 32;

template <int NE>
__global__ void __launch_bounds__(kThreads) paircount_partials_kernel(
    const float* __restrict__ lanes1,  // (N1, 8, T) row tiles
    const float* __restrict__ lanes2,  // (N2, 8, T) column tiles
    const int* __restrict__ tile1,     // (P,) row tile of each pair
    const int* __restrict__ tile2,     // (P,) column tile of each pair
    const float* __restrict__ table,   // (B, E) squared-chord thresholds
    int num_bins, int num_edges, int edge0, int num_sub, int tile_size,
    float* __restrict__ partial) {     // (P, B, E)
  extern __shared__ float4 smem[];
  float4* col_a = smem;              // (T) x_hi, y_hi, z_hi, weight
  float4* col_b = smem + tile_size;  // (T) x_lo, y_lo, z_lo, unused
  float* row_val = reinterpret_cast<float*>(smem + 2 * tile_size);  // (T, NE)
  int* row_bin = reinterpret_cast<int*>(row_val + tile_size * NE);  // (T)
  float* thr_s = reinterpret_cast<float*>(row_bin + tile_size);     // (B, NE)

  const long long k = blockIdx.x;
  const float* rows = lanes1 + static_cast<long long>(tile1[k]) * 8 * tile_size;
  const float* cols = lanes2 + static_cast<long long>(tile2[k]) * 8 * tile_size;

  for (int j = threadIdx.x; j < tile_size; j += blockDim.x) {
    col_a[j] = make_float4(cols[j], cols[tile_size + j],
                           cols[2 * tile_size + j], cols[6 * tile_size + j]);
    col_b[j] = make_float4(cols[3 * tile_size + j], cols[4 * tile_size + j],
                           cols[5 * tile_size + j], 0.0f);
  }
  // edges beyond this launch's group get a negative threshold: a squared
  // chord is never below it, and those slots are never written
  for (int i = threadIdx.x; i < num_bins * NE; i += blockDim.x) {
    const int b = i / NE;
    const int e = i % NE;
    thr_s[i] = e < num_sub ? table[b * num_edges + edge0 + e] : -1.0f;
  }
  __syncthreads();

  for (int base = 0; base < tile_size; base += kRowsPerThread * blockDim.x) {
    float xh[kRowsPerThread], yh[kRowsPerThread], zh[kRowsPerThread];
    float xl[kRowsPerThread], yl[kRowsPerThread], zl[kRowsPerThread];
    float thr[kRowsPerThread][NE];
    float acc[kRowsPerThread][NE];
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
      int bin = static_cast<int>(rows[7 * tile_size + at]);
      bin = min(max(bin, 0), num_bins - 1);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        thr[r][e] = valid ? thr_s[bin * NE + e] : -1.0f;
        acc[r][e] = 0.0f;
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
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          acc[r][e] = __fadd_rn(acc[r][e], chord2 <= thr[r][e] ? a.w : 0.0f);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = base + r * blockDim.x + threadIdx.x;
      if (row < tile_size) {
        const float w_row = rows[6 * tile_size + row];
        int bin = static_cast<int>(rows[7 * tile_size + row]);
        row_bin[row] = min(max(bin, 0), num_bins - 1);
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
  for (int be = warp; be < num_bins * num_sub; be += num_warps) {
    const int b = be / num_sub;
    const int e = be % num_sub;
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

template <int NE>
int launch_partials(const float* lanes1, const float* lanes2, const int* tile1,
                    const int* tile2, long long num_pairs, const float* table,
                    int num_bins, int num_edges, int edge0, int num_sub,
                    int tile_size, float* partial, cudaStream_t stream) {
  const size_t smem = 2 * tile_size * sizeof(float4) +
                      static_cast<size_t>(tile_size) * NE * sizeof(float) +
                      tile_size * sizeof(int) +
                      static_cast<size_t>(num_bins) * NE * sizeof(float);
  cudaError_t status = cudaFuncSetAttribute(
      paircount_partials_kernel<NE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (status != cudaSuccess) return static_cast<int>(status);
  paircount_partials_kernel<NE><<<static_cast<unsigned int>(num_pairs),
                                  kThreads, smem, stream>>>(
      lanes1, lanes2, tile1, tile2, table, num_bins, num_edges, edge0,
      num_sub, tile_size, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of kernel A for the edges [edge0, edge0 + num_sub), with
// 1 <= num_sub <= 16. Returns cudaGetLastError() after the launch, or the
// error of raising the kernel's shared-memory limit (a tile or table too
// large for one block).
int yawt_paircount_partials(const float* lanes1, const float* lanes2,
                            const int* tile1, const int* tile2,
                            long long num_pairs, const float* table,
                            int num_bins, int num_edges, int edge0,
                            int num_sub, int tile_size, float* partial,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_sub <= 1)
    return launch_partials<1>(lanes1, lanes2, tile1, tile2, num_pairs, table,
                              num_bins, num_edges, edge0, num_sub, tile_size,
                              partial, s);
  if (num_sub <= 2)
    return launch_partials<2>(lanes1, lanes2, tile1, tile2, num_pairs, table,
                              num_bins, num_edges, edge0, num_sub, tile_size,
                              partial, s);
  if (num_sub <= 4)
    return launch_partials<4>(lanes1, lanes2, tile1, tile2, num_pairs, table,
                              num_bins, num_edges, edge0, num_sub, tile_size,
                              partial, s);
  if (num_sub <= 8)
    return launch_partials<8>(lanes1, lanes2, tile1, tile2, num_pairs, table,
                              num_bins, num_edges, edge0, num_sub, tile_size,
                              partial, s);
  return launch_partials<16>(lanes1, lanes2, tile1, tile2, num_pairs, table,
                             num_bins, num_edges, edge0, num_sub, tile_size,
                             partial, s);
}

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

}  // extern "C"
