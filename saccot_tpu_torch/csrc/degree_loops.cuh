// The two pair loops of the degree kernels, shared by the production kernels
// (compat_degrees.cu, ring_degrees.cu, compat_degrees_tri.cu) and their timing
// variants (compat_ops.cu). Each loop is a template over
//   VALUE   a functor: the value one pair adds to the sums, from the row's and
//           the column's P and Q coordinates (CompatScore in production);
//   MASKED  the production-only steps: the row and column masks, the
//           i != j test and, in the tri loop, skipping the tile pairs the
//           mask leaves empty.
// So a variant differs from the production kernel only by its VALUE and the
// steps MASKED leaves out, and a variant whose VALUE is CompatScore gives
// the production degrees of unmasked input bit for bit.
//
// two-sided (compat_degrees.cu for saccot_tpu/kernels/compat.py
//   _degree_kernel_mxu and _degree_kernel, ring_degrees.cu for
//   saccot_tpu/kernels/ring_compat.py _ring_degree_kernel, compat_ops.cu's
//   two-sided variants). deg[b, i] = sum_j value(i, j) * m_i * m_j over R rows
//   and C columns. Bound: FP32 instruction issue, PAIR_OPS (40) a pair, the
//   two roots 14 of them; the bytes are O(R + C). The loop is templated
//   further over where the points come from (ROWS, COLS: PointsView, the
//   [batch, n, 3] coordinates with an optional [batch, n] mask, or
//   PackedView, the ring's packed [batch, 8, n_pad] block) and where the row
//   sums go (OUT: StoreSums writes them, AddSums adds them to what deg holds,
//   the ring step's accumulate).
//   - Grid (row tiles, column splits, batch), kThreads threads a block, from
//     kernels/compat.py degree_plan. A thread holds ROWS rows (kRowsWide or
//     kRowsNarrow; rows tile * kThreads * ROWS + k * kThreads + thread), so
//     every column read from shared memory feeds ROWS pairs. Columns are
//     staged a segment of kSegment at a time as two float4s, (P xyz, mask)
//     and (Q xyz), read by every thread of the block as broadcasts.
//   - What holds the loop back: as compiled, its sweep issues about 52
//     instructions a pair against the 40 counted (each root's range check,
//     branch and convergence pair, the loads, the loop), and each root's
//     branch around its slow-path call is a point no instruction of another
//     pair is scheduled across, so a thread has little to issue while a root
//     is in flight and the card needs many resident warps. 9 blocks fit a SM
//     at the loop's 52-56 registers (capped lower, it spills and runs
//     slower), and the plan makes blocks small and many: where the row tiles
//     alone give fewer than 64 blocks a SM (every shape the port runs), each
//     block takes one column segment, unless the scratch below would pass
//     1 GiB; in general split s takes segments [s * segs / splits,
//     (s + 1) * segs / splits).
//   - Sum order, fixed by C alone: each row sums each segment in column order
//     from 0, then adds the segment sums in segment order from 0. Unsplit,
//     the block does both in registers. Split, each block writes its
//     segments' sums to the scratch part[b, segment, row] (batch * segs * R
//     floats); the last block of a row tile to finish (a __threadfence and an
//     atomic ticket per (batch, row tile)) adds them in segment order, in the
//     same launch, and puts its ticket back to 0, so the wrapper keeps one
//     zeroed ticket buffer per stream. So deg has the same bits whatever the
//     plan: any batch, row slice, split count or SM count. No float atomics.
//   - The i != j test compares global ids (row_base + i against col_base + j;
//     a caller holding a slice of rows gets that slice of the full result). It
//     runs only in segments whose column ids meet the block's row ids: in
//     every other segment it could not fire, so it is left out of the loop.
//   - Every row has one owner, the block that sums it last, so AddSums'
//     read-modify-write of deg needs no atomic.
//
// tri (rows are the columns; deterministic, no float atomics, since the
// top-A anchor choice is decided by degree order):
//   pass 1: one block of 128 threads per tile pair (ti <= tj) of 128 x 128
//     nodes, enumerated over the upper triangle only. Thread t owns row
//     ti*128 + t; the column tile sits in shared memory. Off the diagonal
//     every pair of the tile counts once: its value goes to the row sum (a
//     register, in column order) and, through a per-warp butterfly
//     transpose-reduce in registers and a fixed-order sum over the four
//     warps, to the column sum. The diagonal tile sums each row over the
//     whole tile (both orders of its pairs) and writes no column sums. So
//     every entry of the scratch part[b, t, n] = sum over j in tile t of
//     value(n, j) is written exactly once, by one block.
//   pass 2: deg[b, n] = sum over t of part[b, t, n], in tile order.
//   A masked block first votes on its tile pair's mask: with no valid row
//   or no valid column every value it would add is multiplied by a zero
//   mask, so it writes the +0.0f sums instead, reads no coordinate and
//   counts itself in skipped[b]. Pass 2 adds those zeros in tile order, so
//   deg keeps its bits; padding at the end of a pair leaves every tile pair
//   past its last valid tile empty, a scattered mask none.
// The ragged edge is masked by index, never by sentinel coordinates.
#pragma once

#include "common.cuh"

namespace saccot {

// The production pair value: the compatibility score of the pair's distances.
struct CompatScore {
    float tau, inv_tau, min_sep;

    __device__ __forceinline__ float operator()(float px, float py, float pz, float qx, float qy,
                                                float qz, float cpx, float cpy, float cpz,
                                                float cqx, float cqy, float cqz) const {
        const float dp = dist3(px, py, pz, cpx, cpy, cpz);
        const float dq = dist3(qx, qy, qz, cqx, cqy, cqz);
        return compat_score(dp, dq, tau, inv_tau, min_sep);
    }
};

// Tile pair (ti, tj), ti <= tj, of block k: k = tj (tj + 1) / 2 + ti.
__device__ __forceinline__ void tile_pair(long long k, int& ti, int& tj) {
    long long j = static_cast<long long>((sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
    while (j * (j + 1) / 2 > k) --j;
    while ((j + 1) * (j + 2) / 2 <= k) ++j;
    tj = static_cast<int>(j);
    ti = static_cast<int>(k - j * (j + 1) / 2);
}

// One step of the warp's butterfly transpose-reduce over v[0 .. 2 OFF): the
// lane keeps the half of its columns selected by its bit OFF, summed with its
// partner's copy of them, in v[0 .. OFF). After steps 16, 8, 4, 2, 1 lane l
// holds column l summed over the 32 lanes, always in the same order. The
// template keeps every index constant, so v stays in registers.
template <int OFF>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int q = 0; q < OFF; ++q) {
        const float send = upper ? v[q] : v[q + OFF];
        const float keep = upper ? v[q + OFF] : v[q];
        v[q] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
}

}  // namespace saccot

namespace {

// ---- two-sided loop ------------------------------------------------------

constexpr int kThreads = 128;    // threads a block
constexpr int kSegment = 256;    // columns a segment: the unit of the sum order and of a split
constexpr int kRowsWide = 2;     // rows a thread, as degree_plan chooses
constexpr int kRowsNarrow = 1;

// Point i of batch element b: P xyz and its mask (1 without a mask) in p,
// Q xyz in q. [batch, n, 3] coordinates and an optional [batch, n] mask.
struct PointsView {
    const float* P;
    const float* Q;
    const float* mask;
    int n;

    __device__ __forceinline__ void load(int b, int i, float4& p, float4& q) const {
        const long long o = static_cast<long long>(b) * n + i;
        p = make_float4(P[3 * o], P[3 * o + 1], P[3 * o + 2], mask ? mask[o] : 1.0f);
        q = make_float4(Q[3 * o], Q[3 * o + 1], Q[3 * o + 2], 0.0f);
    }
};

// The ring's packed, coordinate-major [batch, 8, n_pad] block: rows 0-2 P
// xyz, 3-5 Q xyz, 6 the mask.
struct PackedView {
    const float* blk;
    int n_pad;

    __device__ __forceinline__ void load(int b, int i, float4& p, float4& q) const {
        const long long s = n_pad;
        const float* x = blk + static_cast<long long>(b) * 8 * s + i;
        p = make_float4(x[0], x[s], x[2 * s], x[6 * s]);
        q = make_float4(x[3 * s], x[4 * s], x[5 * s], 0.0f);
    }
};

// deg[b, i] = v.
struct StoreSums {
    float* deg;
    int R;

    __device__ __forceinline__ void operator()(int b, int i, float v) const {
        deg[static_cast<long long>(b) * R + i] = v;
    }
};

// deg[b, i] += v, rounded once (the ring step's accumulate over its steps).
struct AddSums {
    float* deg;
    int R;

    __device__ __forceinline__ void operator()(int b, int i, float v) const {
        float* d = deg + static_cast<long long>(b) * R + i;
        *d = saccot::add_rn(*d, v);
    }
};

// A thread's rows, in registers.
template <int ROWS>
struct RowRegs {
    float px[ROWS], py[ROWS], pz[ROWS], qx[ROWS], qy[ROWS], qz[ROWS], m[ROWS];
};

// seg[k] = the sum of row k's pair values over the n staged columns, in
// column order. SELF: the segment meets the block's row ids, and column
// self[k] (or none, -1) is row k's own id.
template <int ROWS, bool MASKED, bool SELF, class Value>
__device__ __forceinline__ void sweep_segment(const RowRegs<ROWS>& r, const float4* cp,
                                              const float4* cq, int n, const int (&self)[ROWS],
                                              const Value& value, float (&seg)[ROWS]) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) seg[k] = 0.0f;
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
        const float4 a = cp[t];
        const float4 c = cq[t];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            float s = value(r.px[k], r.py[k], r.pz[k], r.qx[k], r.qy[k], r.qz[k], a.x, a.y, a.z,
                            c.x, c.y, c.z);
            if constexpr (MASKED) {
                if constexpr (SELF) {
                    if (t == self[k]) s = 0.0f;
                }
                seg[k] = __fmaf_rn(s, saccot::mul_rn(r.m[k], a.w), seg[k]);
            } else {
                seg[k] = saccot::add_rn(seg[k], s);
            }
        }
    }
}

template <int ROWS, bool MASKED, class Rows, class Cols, class Value, class Out>
__global__ void __launch_bounds__(kThreads)
two_sided_degrees_kernel(Rows rows, Cols cols, int R, int C, long long row_base,
                         long long col_base, float* __restrict__ part, int* __restrict__ tickets,
                         Value value, Out out) {
    __shared__ float4 cp[kSegment];   // column P xyz, mask in .w
    __shared__ float4 cq[kSegment];   // column Q xyz
    __shared__ int is_last;

    const int tile = blockIdx.x;
    const int split = blockIdx.y;
    const int splits = gridDim.y;
    const int b = blockIdx.z;
    const int segs = (C + kSegment - 1) / kSegment;
    const int s_lo = static_cast<int>(static_cast<long long>(split) * segs / splits);
    const int s_hi = static_cast<int>(static_cast<long long>(split + 1) * segs / splits);
    const int r0 = tile * (kThreads * ROWS) + threadIdx.x;   // row k: r0 + k kThreads

    RowRegs<ROWS> r;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int i = r0 + k * kThreads;
        float4 p, q;
        rows.load(b, i < R ? i : 0, p, q);
        r.px[k] = p.x; r.py[k] = p.y; r.pz[k] = p.z; r.m[k] = p.w;
        r.qx[k] = q.x; r.qy[k] = q.y; r.qz[k] = q.z;
    }
    // The block's global row ids [row_lo, row_hi).
    const long long row_lo = row_base + tile * (kThreads * ROWS);
    const long long row_hi = row_base + min(R, (tile + 1) * (kThreads * ROWS));

    float acc[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) acc[k] = 0.0f;
    for (int sg = s_lo; sg < s_hi; ++sg) {
        const int c0 = sg * kSegment;
        const int n = min(kSegment, C - c0);
        for (int t = threadIdx.x; t < n; t += kThreads) cols.load(b, c0 + t, cp[t], cq[t]);
        __syncthreads();
        float seg[ROWS];
        int self[ROWS];
        const long long col_lo = col_base + c0;
        if (MASKED && col_lo < row_hi && row_lo < col_lo + n) {
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
                const long long j = row_base + r0 + k * kThreads - col_lo;
                self[k] = (j >= 0 && j < n) ? static_cast<int>(j) : -1;
            }
            sweep_segment<ROWS, MASKED, MASKED>(r, cp, cq, n, self, value, seg);
        } else {
            sweep_segment<ROWS, MASKED, false>(r, cp, cq, n, self, value, seg);
        }
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            const int i = r0 + k * kThreads;
            if (splits == 1) {
                acc[k] = saccot::add_rn(acc[k], seg[k]);
            } else if (i < R) {
                part[(static_cast<long long>(b) * segs + sg) * R + i] = seg[k];
            }
        }
        __syncthreads();
    }

    if (splits == 1) {
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            if (r0 + k * kThreads < R) out(b, r0 + k * kThreads, acc[k]);
        }
        return;
    }

    // Every segment sum of this split is written; take the tile's ticket.
    __threadfence();
    __syncthreads();
    int* ticket = tickets + static_cast<long long>(b) * gridDim.x + tile;
    if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;

    // The last block of the tile: every split's sums are visible (each writer
    // fenced before taking its ticket); read them past L1, in segment order.
    // Every block of the tile has taken its ticket, so it goes back to 0 for
    // the next launch on this stream.
    if (threadIdx.x == 0) *ticket = 0;
    __threadfence();
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int i = r0 + k * kThreads;
        if (i < R) {
            const float* p = part + static_cast<long long>(b) * segs * R + i;
            float w = 0.0f;
#pragma unroll 8
            for (int sg = 0; sg < segs; ++sg) {
                w = saccot::add_rn(w, __ldcg(p + static_cast<long long>(sg) * R));
            }
            out(b, i, w);
        }
    }
}

template <int ROWS, bool MASKED, class Rows, class Cols, class Value, class Out>
void launch_rows(const Rows& rows, const Cols& cols, int batch, int R, int C, long long row_base,
                 long long col_base, int splits, float* part, int* tickets, const Value& value,
                 const Out& out, cudaStream_t s) {
    const dim3 grid((R + kThreads * ROWS - 1) / (kThreads * ROWS), splits, batch);
    two_sided_degrees_kernel<ROWS, MASKED, Rows, Cols, Value, Out><<<grid, kThreads, 0, s>>>(
        rows, cols, R, C, row_base, col_base, part, tickets, value, out);
}

// The plan (kernels/compat.py degree_plan): rows_per_thread kRowsWide or
// kRowsNarrow, splits of the ceil(C / kSegment) column segments. splits > 1
// needs part of batch * segments * R floats and tickets of batch * row tiles
// ints that are zero (they are zero again when the launch ends).
template <bool MASKED, class Rows, class Cols, class Value, class Out>
int launch_two_sided(const Rows& rows, const Cols& cols, int batch, int R, int C,
                     long long row_base, long long col_base, int rows_per_thread, int splits,
                     float* part, int* tickets, const Value& value, const Out& out,
                     cudaStream_t s) {
    const int segs = (C + kSegment - 1) / kSegment;
    if (splits < 1 || splits > max(segs, 1) || (splits > 1 && (!part || !tickets))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rows_per_thread == kRowsWide) {
        launch_rows<kRowsWide, MASKED>(rows, cols, batch, R, C, row_base, col_base, splits, part,
                                       tickets, value, out, s);
    } else if (rows_per_thread == kRowsNarrow) {
        launch_rows<kRowsNarrow, MASKED>(rows, cols, batch, R, C, row_base, col_base, splits,
                                         part, tickets, value, out, s);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// ---- tri loop ------------------------------------------------------------

constexpr int kTile = 128;
constexpr int kTriThreads = kTile;   // one row per thread
constexpr int kWarps = kTriThreads / 32;

template <bool MASKED, class Value>
__global__ void __launch_bounds__(kTriThreads)
tri_degrees_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                   const float* __restrict__ mask, float* __restrict__ part, int N, int n_tiles,
                   Value value, unsigned long long* __restrict__ skipped) {
    __shared__ float4 cp[kTile];   // column tile: P coordinates, mask in .w
    __shared__ float4 cq[kTile];   // column tile: Q coordinates
    __shared__ float colsum[kWarps][kTile];

    int ti, tj;
    saccot::tile_pair(blockIdx.x, ti, tj);
    const bool diag = ti == tj;
    const int b = blockIdx.y;
    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const float* mb = mask ? mask + static_cast<long long>(b) * N : nullptr;
    float* pb = part + static_cast<long long>(b) * n_tiles * N;

    const int r = ti * kTile + threadIdx.x;
    const bool row_ok = r < N;
    const int c = tj * kTile + threadIdx.x;   // the column this thread stages
    const bool col_ok = c < N;
    const float mr = mb ? mb[row_ok ? r : 0] : 1.0f;
    const float mc = mb ? mb[col_ok ? c : 0] : 1.0f;
    if constexpr (MASKED) {
        if (mb) {   // uniform over the block, so every thread reaches both votes
            const int rows_valid = __syncthreads_or(row_ok && mr != 0.0f);
            const int cols_valid = __syncthreads_or(col_ok && mc != 0.0f);
            if (!rows_valid || !cols_valid) {
                if (!diag && col_ok) pb[static_cast<long long>(ti) * N + c] = 0.0f;
                if (row_ok) pb[static_cast<long long>(tj) * N + r] = 0.0f;
                if (skipped && threadIdx.x == 0) atomicAdd(skipped + b, 1ull);
                return;
            }
        }
    }
    const long long ro = static_cast<long long>(row_ok ? r : 0) * 3;
    const float px = Pb[ro], py = Pb[ro + 1], pz = Pb[ro + 2];
    const float qx = Qb[ro], qy = Qb[ro + 1], qz = Qb[ro + 2];
    {
        const long long co = static_cast<long long>(col_ok ? c : 0) * 3;
        cp[threadIdx.x] = make_float4(Pb[co], Pb[co + 1], Pb[co + 2], mc);
        cq[threadIdx.x] = make_float4(Qb[co], Qb[co + 1], Qb[co + 2], 0.0f);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float acc = 0.0f;
#pragma unroll 1
    for (int g = 0; g < kTile / 32; ++g) {
        float v[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) {
            const int t = g * 32 + q;
            const int j = tj * kTile + t;
            const float4 a = cp[t];
            const float4 d = cq[t];
            float s = value(px, py, pz, qx, qy, qz, a.x, a.y, a.z, d.x, d.y, d.z);
            if constexpr (MASKED) {
                if (!row_ok || j >= N || j == r) s = 0.0f;
                v[q] = s * (mr * a.w);
            } else {
                if (!row_ok || j >= N) s = 0.0f;
                v[q] = s;
            }
            acc += v[q];
        }
        if (!diag) {
            // Lane l ends with column g*32 + l summed over the warp's rows.
            saccot::butterfly_step<16>(v, lane);
            saccot::butterfly_step<8>(v, lane);
            saccot::butterfly_step<4>(v, lane);
            saccot::butterfly_step<2>(v, lane);
            saccot::butterfly_step<1>(v, lane);
            colsum[warp][g * 32 + lane] = v[0];
        }
    }

    if (!diag) {
        __syncthreads();
        if (col_ok) {
            float cs = colsum[0][threadIdx.x];
            for (int w = 1; w < kWarps; ++w) cs += colsum[w][threadIdx.x];
            pb[static_cast<long long>(ti) * N + c] = cs;
        }
    }
    if (row_ok) pb[static_cast<long long>(tj) * N + r] = acc;
}

// Pass 2: deg[b, n] = sum over t of part[b, t, n], in tile order. A template
// only so that a file that takes the two-sided loop alone compiles no copy.
template <typename T>
__global__ void degree_sum_kernel(const T* __restrict__ part, T* __restrict__ deg, int N,
                                  int n_tiles) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const long long b = blockIdx.y;
    const T* p = part + b * n_tiles * N + n;
    T acc = 0;
    for (int t = 0; t < n_tiles; ++t) acc += p[static_cast<long long>(t) * N];
    deg[b * N + n] = acc;
}

// part is scratch of batch * n_tiles * N floats, n_tiles = ceil(N / 128).
// skipped (MASKED with a mask; may be null): batch zeroed counters, to which
// each batch element's empty tile pairs are added.
template <bool MASKED, class Value>
int launch_tri(const float* P, const float* Q, const float* mask, float* part, float* deg,
               int batch, int N, int n_tiles, Value value, cudaStream_t s,
               unsigned long long* skipped = nullptr) {
    if (n_tiles != (N + kTile - 1) / kTile) return static_cast<int>(cudaErrorInvalidValue);
    const long long pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
    tri_degrees_kernel<MASKED, Value><<<dim3(static_cast<unsigned>(pairs), batch), kTriThreads,
                                        0, s>>>(P, Q, mask, part, N, n_tiles, value, skipped);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    degree_sum_kernel<float><<<dim3((N + 255) / 256, batch), 256, 0, s>>>(part, deg, N, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
