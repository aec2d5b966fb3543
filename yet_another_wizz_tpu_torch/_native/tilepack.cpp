// Native data-loader kernels for catalog -> device-tile packing.
//
// The reference delegates its ingestion hot path to native third-party code
// (scipy C++, Arrow C++); here the framework's own hot path — Morton codes,
// the scatter of sorted points into padded (tile, channel, lane) float32
// layout with (hi, lo) coordinate splitting, and tile bounding-cap
// computation — is implemented in C++ with OpenMP and exposed through
// ctypes (see __init__.py). A pure-numpy fallback exists in ops/tiles.py.
//
// Build: g++ -O3 -ffp-contract=off -fopenmp -shared -fPIC tilepack.cpp -o libtilepack.so
// (no -march/-mfma and contraction pinned off: the tile-pair filter's
// numpy parity tests assume the exact two-op a*b - c*d evaluation)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Interleaved-bit Morton codes of points in [-1, 1]^3, `bits` bits/axis.
void morton_codes(const double* xyz, int64_t n, int32_t bits, int64_t* out) {
    const double scale = 0.5 * (double)(1ll << bits);
    const int64_t maxq = (1ll << bits) - 1;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        int64_t code = 0;
        for (int dim = 0; dim < 3; ++dim) {
            double v = (xyz[3 * i + dim] + 1.0) * scale;
            int64_t q = (int64_t)v;
            if (q < 0) q = 0;
            if (q > maxq) q = maxq;
            for (int bit = 0; bit < bits; ++bit) {
                code |= ((q >> bit) & 1ll) << (3 * bit + dim);
            }
        }
        out[i] = code;
    }
}

// Scatter sorted points into the packed lane layout (num_tiles, 8, T):
// channels [x_hi, y_hi, z_hi, x_lo, y_lo, z_lo, weight, zbin]. `dest` maps
// each input row to its padded global position; lane_data must be
// zero-initialised by the caller (padding rows keep weight zero).
void pack_tiles(const double* xyz, const double* weights, const double* zbins,
                const int64_t* dest, int64_t n, int64_t tile_size,
                float* lane_data) {
    const int64_t stride = 8 * tile_size;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const int64_t tile = dest[i] / tile_size;
        const int64_t lane = dest[i] - tile * tile_size;
        float* base = lane_data + tile * stride + lane;
        for (int dim = 0; dim < 3; ++dim) {
            const double value = xyz[3 * i + dim];
            const float hi = (float)value;
            base[dim * tile_size] = hi;
            base[(3 + dim) * tile_size] = (float)(value - (double)hi);
        }
        base[6 * tile_size] = (float)weights[i];
        base[7 * tile_size] = (float)zbins[i];
    }
}

// Per-tile bounding caps: unnormalised center sums and (after the caller
// normalises the centers) the maximum chord distance of the real points.
void tile_center_sums(const double* xyz, const int64_t* dest, int64_t n,
                      int64_t tile_size, double* sums /* (num_tiles, 3) */) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t tile = dest[i] / tile_size;
        for (int dim = 0; dim < 3; ++dim)
            sums[3 * tile + dim] += xyz[3 * i + dim];
    }
}

void tile_max_chord(const double* xyz, const int64_t* dest, int64_t n,
                    int64_t tile_size, const double* centers,
                    double* max_chord /* (num_tiles,) zero-init */) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t tile = dest[i] / tile_size;
        double d2 = 0.0;
        for (int dim = 0; dim < 3; ++dim) {
            const double d = xyz[3 * i + dim] - centers[3 * tile + dim];
            d2 += d * d;
        }
        const double chord = sqrt(d2);
        if (chord > max_chord[tile]) max_chord[tile] = chord;
    }
}

// Fixed-point lane encoding (ops/tiles.py:encode_fixedpoint_lanes): per
// tile, reconstruct the float64 coordinates from the (hi, lo) float32
// channels, pick the smallest power-of-two scale with |offset| <=
// scale * 2^30, quantise the tile-relative offsets to int32
// (round-half-even, matching np.rint), bit-copy the weight float32
// channel into the fourth int32 channel, and narrow the redshift-bin
// channel (small integer indices) to a lossless int8 side array.
// `params` rows are [cx_hi, cy_hi, cz_hi, cx_lo, cy_lo, cz_lo, scale, 0].
void encode_fixedpoint(const float* lane_data, const double* centers,
                       int64_t num_tiles, int64_t tile_size,
                       double scale_floor, int32_t* packed, float* params,
                       int8_t* zbins) {
    const int64_t in_stride = 8 * tile_size;
    const int64_t out_stride = 4 * tile_size;
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < num_tiles; ++t) {
        const float* in = lane_data + t * in_stride;
        int32_t* out = packed + t * out_stride;
        std::vector<double> offsets(3 * tile_size);
        double maxabs = 0.0;
        for (int dim = 0; dim < 3; ++dim) {
            const double c = centers[3 * t + dim];
            const float* hi = in + dim * tile_size;
            const float* lo = in + (3 + dim) * tile_size;
            double* off = offsets.data() + dim * tile_size;
            for (int64_t j = 0; j < tile_size; ++j) {
                const double v = ((double)hi[j] + (double)lo[j]) - c;
                off[j] = v;
                const double a = std::fabs(v);
                if (a > maxabs) maxabs = a;
            }
        }
        if (maxabs < scale_floor) maxabs = scale_floor;
        // smallest power of two >= maxabs (frexp: maxabs = m * 2^e with
        // m in [0.5, 1) -> 2^e, except exactly-2^(e-1) -> itself)
        int e;
        const double m = std::frexp(maxabs, &e);
        const double scale = std::ldexp(1.0, (m == 0.5 ? e - 1 : e) - 30);
        const double inv = 1.0 / scale;  // power of two: exact
        for (int dim = 0; dim < 3; ++dim) {
            const double* off = offsets.data() + dim * tile_size;
            int32_t* q = out + dim * tile_size;
            for (int64_t j = 0; j < tile_size; ++j) {
                q[j] = (int32_t)std::nearbyint(off[j] * inv);
            }
        }
        std::memcpy(out + 3 * tile_size, in + 6 * tile_size,
                    sizeof(float) * tile_size);
        const float* zb = in + 7 * tile_size;
        int8_t* zq = zbins + t * tile_size;
        for (int64_t j = 0; j < tile_size; ++j) {
            zq[j] = (int8_t)zb[j];
        }
        float* p = params + 8 * t;
        for (int dim = 0; dim < 3; ++dim) {
            const double c = centers[3 * t + dim];
            // volatile forces the narrowing round-trip: gcc 12's -O3 SLP
            // vectorizer otherwise elides the float rounding and folds
            // the residual c - (double)(float)c to zero
            volatile float c_hi = (float)c;
            p[dim] = c_hi;
            p[3 + dim] = (float)(c - (double)c_hi);
        }
        p[6] = (float)scale;
        p[7] = 0.0f;
    }
}

void radec_to_xyz(const double* ra, const double* dec, int64_t n,
                  double* out) {
    // unit-sphere 3-vectors; one output allocation, one write pass
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double cd = std::cos(dec[i]);
        out[3 * i + 0] = cd * std::cos(ra[i]);
        out[3 * i + 1] = cd * std::sin(ra[i]);
        out[3 * i + 2] = std::sin(dec[i]);
    }
}

void min_dist2_update(const double* xyz, int64_t n, const double* center,
                      double* min_d2) {
    // in-place: min_d2[i] = min(min_d2[i], |xyz_i - center|^2)
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double dx = xyz[3 * i + 0] - center[0];
        const double dy = xyz[3 * i + 1] - center[1];
        const double dz = xyz[3 * i + 2] - center[2];
        const double d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < min_d2[i]) min_d2[i] = d2;
    }
}

int interleave_columns(const double* const* columns, int64_t num_cols,
                       int64_t n, int64_t row_stride_doubles, double* out) {
    // strided interleave of column arrays into row-major records with a
    // fused finite check; returns the LOWEST index of any non-finite
    // column (matching the numpy fallback, which raises on the first bad
    // column in field order) or -1 on success. Row-major outer loop:
    // sequential output writes, k sequential column read streams.
    int bad = static_cast<int>(num_cols);
    #pragma omp parallel for schedule(static) reduction(min : bad)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t c = 0; c < num_cols; ++c) {
            const double v = columns[c][i];
            if (!std::isfinite(v) && static_cast<int>(c) < bad) {
                bad = static_cast<int>(c);
            }
            out[i * row_stride_doubles + c] = v;
        }
    }
    return bad == static_cast<int>(num_cols) ? -1 : bad;
}

void patch_geometry(const double* xyz, const double* weights,
                    const int32_t* ids, int64_t n, int64_t num_patches,
                    double* centers_out, double* radii_out) {
    // pass 1: weighted coordinate sums per patch
    std::vector<double> sums(3 * num_patches, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        const double w = weights ? weights[i] : 1.0;
        const int64_t p = ids[i];
        sums[3 * p + 0] += w * xyz[3 * i + 0];
        sums[3 * p + 1] += w * xyz[3 * i + 1];
        sums[3 * p + 2] += w * xyz[3 * i + 2];
    }
    for (int64_t p = 0; p < num_patches; ++p) {
        const double norm = std::sqrt(sums[3 * p] * sums[3 * p] +
                                      sums[3 * p + 1] * sums[3 * p + 1] +
                                      sums[3 * p + 2] * sums[3 * p + 2]);
        if (norm > 0.0) {
            centers_out[3 * p + 0] = sums[3 * p + 0] / norm;
            centers_out[3 * p + 1] = sums[3 * p + 1] / norm;
            centers_out[3 * p + 2] = sums[3 * p + 2] / norm;
        } else {
            centers_out[3 * p + 0] = 1.0;
            centers_out[3 * p + 1] = 0.0;
            centers_out[3 * p + 2] = 0.0;
        }
    }
    // pass 2: maximum chord distance to the patch center
    std::vector<double> max_chord2(num_patches, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p = ids[i];
        const double dx = xyz[3 * i + 0] - centers_out[3 * p + 0];
        const double dy = xyz[3 * i + 1] - centers_out[3 * p + 1];
        const double dz = xyz[3 * i + 2] - centers_out[3 * p + 2];
        const double c2 = dx * dx + dy * dy + dz * dz;
        if (c2 > max_chord2[p]) max_chord2[p] = c2;
    }
    for (int64_t p = 0; p < num_patches; ++p) {
        double half = std::sqrt(max_chord2[p]) / 2.0;
        if (half > 1.0) half = 1.0;
        radii_out[p] = 2.0 * std::asin(half);
    }
}

}  // extern "C"

extern "C" {

// Tile-pair candidate filtering (ops/linkage.py:build_tile_pairs): for
// every linked patch-pair slot, walk its dense (n1 x n2) tile grid in
// row-major order and keep pairs whose cap distance can reach the
// angular cutoff. Replaces the numpy group pass, whose ~10 array
// temporaries per candidate dominate the host wall at survey scale
// (31.6 s of a 63 s warm 40M-row measurement). Bit-identical predicate:
// sequential 3-term dot, clip, 2*asin(sqrt(max(0.5*(1-d), 0))) against
// radii + theta — the build pins -ffp-contract=off (and omits
// -march/-mfma) so gcc cannot FMA-contract the arithmetic differently
// from numpy on any target ISA.
//
// per_tile: 0 = global cutoff_angle; 1 = row tiles binned (theta from
// range_max[zmin1, zmax1]); 2 = both binned (theta from the overlapping
// bin range). Invalid/disjoint ranges drop the pair outright, matching
// the numpy `valid` mask. Two modes of operation: with `out1 == null`
// per-slot kept counts are written to slot_counts (sizing pass);
// otherwise slot_counts must hold the sizing pass's counts — they become
// per-slot write offsets, so the fill runs slot-parallel into disjoint
// output ranges. Both passes are OpenMP-parallel over slots (the
// predicate is deterministic, so the fill reproduces the sizing counts
// exactly). Returns the total kept.
//
// The cap test `dist(c1,c2) < r1 + r2 + theta` is evaluated in COSINE
// form: cos is strictly decreasing on [0, pi] and cos(dist) == dot
// identically (dist = 2*asin(sqrt(0.5*(1-dot)))), so the condition is
// `dot > cos(r1 + r2 + theta)` — no sqrt/asin per candidate. The bound
// expands through precomputed per-tile trig (cosr/sinr arrays, cos/sin
// of the theta table/cutoff — all computed by NUMPY in the wrapper so
// the numpy fallback sees bit-identical inputs):
//   cos(r1+r2+theta) = (cr1*cr2 - sr1*sr2)*ct - (sr1*cr2 + cr1*sr2)*st
// with the identical operation order in ops/linkage.py. Angle sums
// >= pi always link (cos wraps), and a shared conservative margin
// absorbs the formula's last-ulp rounding: the filter is a PRUNE, so
// admitting a boundary-ulp pair is free while dropping one could lose
// counted point pairs in degenerate tangent configurations.
static const double kFilterMargin = 1e-12;

static inline int64_t filter_one_slot(
    int64_t s, const int64_t* start1, const int64_t* start2,
    const int64_t* n1, const int64_t* n2,
    const double* centers1, const double* radii1,
    const double* cosr1, const double* sinr1,
    const double* centers2, const double* radii2,
    const double* cosr2, const double* sinr2,
    double cutoff_angle, double cos_cutoff, double sin_cutoff,
    int32_t per_tile,
    const int32_t* zmin1, const int32_t* zmax1,
    const int32_t* zmin2, const int32_t* zmax2,
    const double* range_max, const double* cos_range,
    const double* sin_range, int64_t num_bins,
    int64_t write_at, int32_t* out1, int32_t* out2, int32_t* out_slot) {
    const double pi = 3.14159265358979323846;
    const int64_t s1 = start1[s], s2 = start2[s];
    const int64_t m1 = n1[s], m2 = n2[s];
    int64_t kept = 0;
    for (int64_t i = 0; i < m1; ++i) {
        const int64_t t1 = s1 + i;
        const double* c1 = centers1 + 3 * t1;
        const double r1 = radii1[t1];
        const double cr1 = cosr1[t1], sr1 = sinr1[t1];
        double theta_row = cutoff_angle;
        double ct_row = cos_cutoff, st_row = sin_cutoff;
        int32_t lo1 = 0, hi1 = 0;
        if (per_tile >= 1) {
            lo1 = zmin1[t1];
            hi1 = zmax1[t1];
            if (hi1 < lo1) continue;  // empty tile: never links
            if (per_tile == 1) {
                const int64_t at = lo1 * num_bins + hi1;
                theta_row = range_max[at];
                ct_row = cos_range[at];
                st_row = sin_range[at];
            }
        }
        for (int64_t j = 0; j < m2; ++j) {
            const int64_t t2 = s2 + j;
            double theta = theta_row, ct = ct_row, st = st_row;
            if (per_tile == 2) {
                int32_t lo = lo1 > zmin2[t2] ? lo1 : zmin2[t2];
                int32_t hi = hi1 < zmax2[t2] ? hi1 : zmax2[t2];
                if (lo > hi) continue;  // disjoint bin ranges
                const int64_t at = lo * num_bins + hi;
                theta = range_max[at];
                ct = cos_range[at];
                st = sin_range[at];
            }
            const double* c2 = centers2 + 3 * t2;
            double dot = c1[0] * c2[0];
            dot += c1[1] * c2[1];
            dot += c1[2] * c2[2];
            const double cr2 = cosr2[t2], sr2 = sinr2[t2];
            const double ca = cr1 * cr2 - sr1 * sr2;   // cos(r1+r2)
            const double sa = sr1 * cr2 + cr1 * sr2;   // sin(r1+r2)
            const double bound = ca * ct - sa * st;    // cos(r1+r2+theta)
            const bool wrap = r1 + radii2[t2] + theta >= pi;
            if (dot > bound - kFilterMargin || wrap) {
                if (out1 != nullptr) {
                    const int64_t k = write_at + kept;
                    out1[k] = (int32_t)t1;
                    out2[k] = (int32_t)t2;
                    out_slot[k] = (int32_t)s;
                }
                ++kept;
            }
        }
    }
    return kept;
}

int64_t filter_tile_pairs(
    const int64_t* start1, const int64_t* start2,
    const int64_t* n1, const int64_t* n2, int64_t num_slots,
    const double* centers1, const double* radii1,
    const double* cosr1, const double* sinr1,
    const double* centers2, const double* radii2,
    const double* cosr2, const double* sinr2,
    double cutoff_angle, double cos_cutoff, double sin_cutoff,
    int32_t per_tile,
    const int32_t* zmin1, const int32_t* zmax1,
    const int32_t* zmin2, const int32_t* zmax2,
    const double* range_max, const double* cos_range,
    const double* sin_range, int64_t num_bins,
    int64_t* slot_counts, int32_t* out1, int32_t* out2, int32_t* out_slot) {
    if (out1 == nullptr) {
        // sizing pass: dynamic schedule — slot grids vary wildly in size
#pragma omp parallel for schedule(dynamic, 1)
        for (int64_t s = 0; s < num_slots; ++s)
            slot_counts[s] = filter_one_slot(
                s, start1, start2, n1, n2, centers1, radii1, cosr1, sinr1,
                centers2, radii2, cosr2, sinr2, cutoff_angle, cos_cutoff,
                sin_cutoff, per_tile, zmin1, zmax1, zmin2, zmax2,
                range_max, cos_range, sin_range, num_bins,
                0, nullptr, nullptr, nullptr);
        int64_t kept_total = 0;
        for (int64_t s = 0; s < num_slots; ++s) kept_total += slot_counts[s];
        return kept_total;
    }
    // fill pass: exclusive prefix sums of the sizing counts give every
    // slot its disjoint output range
    std::vector<int64_t> offsets((size_t)num_slots);
    int64_t kept_total = 0;
    for (int64_t s = 0; s < num_slots; ++s) {
        offsets[(size_t)s] = kept_total;
        kept_total += slot_counts[s];
    }
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t s = 0; s < num_slots; ++s)
        filter_one_slot(
            s, start1, start2, n1, n2, centers1, radii1, cosr1, sinr1,
            centers2, radii2, cosr2, sinr2, cutoff_angle, cos_cutoff,
            sin_cutoff, per_tile, zmin1, zmax1, zmin2, zmax2,
            range_max, cos_range, sin_range, num_bins,
            offsets[(size_t)s], out1, out2, out_slot);
    return kept_total;
}

// Composite sort keys for the tile layout: (patch, zbin, morton) packed
// into one uint64 so ONE radix sort replaces the three stable argsort
// passes of np.lexsort. Bit budget: patch ids are int16-bounded (15
// bits), zbin uses 16 bits (int16 bin lane bound), morton uses
// 3 * bits/axis (30 at the default 10) — 61 bits total.
void make_sort_keys(const int32_t* patch, const int32_t* zbin,
                    const int64_t* morton, int64_t n, int32_t zbin_bits,
                    int32_t morton_bits, uint64_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = ((uint64_t)(uint32_t)patch[i] << (zbin_bits + morton_bits))
               | ((uint64_t)(uint32_t)zbin[i] << morton_bits)
               | (uint64_t)morton[i];
    }
}

// Stable parallel LSD radix argsort on uint64 keys (8-bit digits,
// constant digits skipped). Matches np.lexsort exactly: both are stable,
// so equal composite keys keep their input order. Each pass is a
// parallel stable counting sort — threads own contiguous chunks,
// histogram them, and scatter through (digit, thread)-ordered offsets,
// which preserves chunk order within every digit bucket.
void radix_argsort(const uint64_t* keys, int64_t n, int64_t* order) {
    if (n <= 0) return;
    std::vector<uint64_t> kbuf1(keys, keys + n), kbuf2(n);
    std::vector<int64_t> obuf(n);
    uint64_t all_or = 0, all_and = ~0ull;
    for (int64_t i = 0; i < n; ++i) {
        obuf[i] = i;
        all_or |= keys[i];
        all_and &= keys[i];
    }
    const uint64_t varying = all_or & ~all_and;
    uint64_t* src_k = kbuf1.data();
    uint64_t* dst_k = kbuf2.data();
    int64_t* src_o = obuf.data();
    int64_t* dst_o = order;
    int num_threads = 1;
#ifdef _OPENMP
#pragma omp parallel
    {
#pragma omp single
        num_threads = omp_get_num_threads();
    }
#endif
    // Histogram rows are keyed by CHUNK index, and chunks are distributed
    // with `omp parallel for` — each iteration runs exactly once whatever
    // team size the runtime actually delivers (OMP_DYNAMIC, thread
    // limits), unlike thread-id-owned chunks, which silently drop work
    // when a later region's team is smaller than the measured one.
    const int64_t chunk = (n + num_threads - 1) / num_threads;
    const int num_chunks = (int)((n + chunk - 1) / chunk);
    std::vector<int64_t> counts((size_t)num_chunks * 256);
    for (int pass = 0; pass < 8; ++pass) {
        const int shift = 8 * pass;
        if (((varying >> shift) & 0xffull) == 0) continue;
        std::fill(counts.begin(), counts.end(), 0);
#pragma omp parallel for schedule(static)
        for (int c = 0; c < num_chunks; ++c) {
            const int64_t lo = (int64_t)c * chunk;
            const int64_t hi = lo + chunk < n ? lo + chunk : n;
            int64_t* cnt = counts.data() + (size_t)c * 256;
            for (int64_t i = lo; i < hi; ++i)
                ++cnt[(src_k[i] >> shift) & 0xff];
        }
        // (digit, chunk)-ordered exclusive prefix sums -> write offsets;
        // in-chunk input order + this ordering keep the sort stable
        int64_t running = 0;
        for (int d = 0; d < 256; ++d) {
            for (int c = 0; c < num_chunks; ++c) {
                int64_t* slot = counts.data() + (size_t)c * 256 + d;
                const int64_t cnt = *slot;
                *slot = running;
                running += cnt;
            }
        }
#pragma omp parallel for schedule(static)
        for (int c = 0; c < num_chunks; ++c) {
            const int64_t lo = (int64_t)c * chunk;
            const int64_t hi = lo + chunk < n ? lo + chunk : n;
            int64_t* off = counts.data() + (size_t)c * 256;
            for (int64_t i = lo; i < hi; ++i) {
                const int64_t pos = off[(src_k[i] >> shift) & 0xff]++;
                dst_k[pos] = src_k[i];
                dst_o[pos] = src_o[i];
            }
        }
        std::swap(src_k, dst_k);
        std::swap(src_o, dst_o);
    }
    if (src_o != order) std::memcpy(order, src_o, sizeof(int64_t) * n);
}

// Parallel permutation gathers: out[i] = src[order[i]] (random reads,
// sequential writes). The width-k variant serves (n, 3) xyz rows; the
// int32 variants fold the dtype conversions np.lexsort paths paid as
// separate astype passes.
void gather_f64(const double* src, const int64_t* order, int64_t n,
                int64_t k, double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double* row = src + order[i] * k;
        double* dst = out + i * k;
        for (int64_t j = 0; j < k; ++j) dst[j] = row[j];
    }
}

void gather_i32(const int32_t* src, const int64_t* order, int64_t n,
                int32_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) out[i] = src[order[i]];
}

void gather_i32_to_f64(const int32_t* src, const int64_t* order, int64_t n,
                       double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) out[i] = (double)src[order[i]];
}

// Strided variant of radec_to_xyz: reads (ra, dec) through byte strides so
// structured-array column views (the catalog ingestion and patch-cache row
// layout) convert without the ascontiguousarray copies the contiguous
// entry point requires. Identical arithmetic per element.
void radec_to_xyz_strided(const char* ra, int64_t ra_stride,
                          const char* dec, int64_t dec_stride,
                          int64_t n, double* out) {
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double r = *reinterpret_cast<const double*>(ra + i * ra_stride);
        const double d = *reinterpret_cast<const double*>(dec + i * dec_stride);
        const double cd = std::cos(d);
        out[3 * i + 0] = cd * std::cos(r);
        out[3 * i + 1] = cd * std::sin(r);
        out[3 * i + 2] = std::sin(d);
    }
}

// Fused ingestion assignment: nearest-center ids straight from strided
// (ra, dec) columns — the unit 3-vector lives in registers, so the
// (n, 3) xyz temporary the radec_to_xyz + assign_patches pair
// materialises (and re-reads) never exists. Same trig and same
// compare order as the unfused pair: bit-identical ids.
void assign_patches_radec(const char* ra, int64_t ra_stride,
                          const char* dec, int64_t dec_stride,
                          int64_t n, const double* centers,
                          int64_t num_centers, int32_t* out) {
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double r = *reinterpret_cast<const double*>(ra + i * ra_stride);
        const double d = *reinterpret_cast<const double*>(dec + i * dec_stride);
        const double cd = std::cos(d);
        const double x = cd * std::cos(r);
        const double y = cd * std::sin(r);
        const double z = std::sin(d);
        double best = -2.0;
        int32_t best_id = 0;
        for (int64_t c = 0; c < num_centers; ++c) {
            const double score = x * centers[3 * c] + y * centers[3 * c + 1]
                               + z * centers[3 * c + 2];
            if (score > best) {
                best = score;
                best_id = (int32_t)c;
            }
        }
        out[i] = best_id;
    }
}

// Stable parallel counting-sort argsort on small non-negative ids (patch
// ids: <= 32768 buckets). One pass of the radix_argsort scheme below with
// the id itself as the digit; counts[id] additionally returns the
// per-bucket histogram so callers derive split offsets without a second
// unique() pass. Matches np.argsort(kind="stable") exactly.
void counting_argsort_ids(const int32_t* ids, int64_t n, int64_t num_ids,
                          int64_t* order, int64_t* counts) {
    for (int64_t d = 0; d < num_ids; ++d) counts[d] = 0;
    if (n <= 0) return;
    int num_threads = 1;
#ifdef _OPENMP
#pragma omp parallel
    {
#pragma omp single
        num_threads = omp_get_num_threads();
    }
#endif
    const int64_t chunk = (n + num_threads - 1) / num_threads;
    const int num_chunks = (int)((n + chunk - 1) / chunk);
    std::vector<int64_t> hist((size_t)num_chunks * num_ids, 0);
#pragma omp parallel for schedule(static)
    for (int c = 0; c < num_chunks; ++c) {
        const int64_t lo = (int64_t)c * chunk;
        const int64_t hi = lo + chunk < n ? lo + chunk : n;
        int64_t* cnt = hist.data() + (size_t)c * num_ids;
        for (int64_t i = lo; i < hi; ++i) ++cnt[ids[i]];
    }
    // (id, chunk)-ordered exclusive prefix -> stable write offsets
    int64_t running = 0;
    for (int64_t d = 0; d < num_ids; ++d) {
        for (int c = 0; c < num_chunks; ++c) {
            int64_t* slot = hist.data() + (size_t)c * num_ids + d;
            const int64_t cnt = *slot;
            counts[d] += cnt;
            *slot = running;
            running += cnt;
        }
    }
#pragma omp parallel for schedule(static)
    for (int c = 0; c < num_chunks; ++c) {
        const int64_t lo = (int64_t)c * chunk;
        const int64_t hi = lo + chunk < n ? lo + chunk : n;
        int64_t* off = hist.data() + (size_t)c * num_ids;
        for (int64_t i = lo; i < hi; ++i) order[off[ids[i]]++] = i;
    }
}

// Parallel permutation gather of raw fixed-size records (structured-array
// rows): out[i] = src[order[i]]. Random reads, sequential writes.
void gather_rows(const char* src, int64_t itemsize, const int64_t* order,
                 int64_t n, char* out) {
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(out + i * itemsize, src + order[i] * itemsize,
                    (size_t)itemsize);
}

// Nearest-center assignment: argmax of xyz . center over centers, with no
// score-matrix temporaries (OpenMP over points).
void assign_patches(const double* xyz, int64_t n, const double* centers,
                    int64_t num_centers, int32_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
        double best = -2.0;
        int32_t best_id = 0;
        for (int64_t c = 0; c < num_centers; ++c) {
            const double score = x * centers[3 * c] + y * centers[3 * c + 1]
                               + z * centers[3 * c + 2];
            if (score > best) {
                best = score;
                best_id = (int32_t)c;
            }
        }
        out[i] = best_id;
    }
}

}  // extern "C"
