// The two pair loops of the degree kernels, shared by the production kernels
// (compat_degrees.cu, compat_degrees_tri.cu) and their timing variants
// (compat_ops.cu). Each loop is a template over
//   VALUE   a functor: the value one pair adds to the sums, from the row's and
//           the column's P and Q coordinates (CompatScore in production);
//   MASKED  the production-only steps: the row and column masks (either
//           pointer may be null) and the i != j test.
// So a variant differs from the production kernel only by its VALUE and the
// steps MASKED leaves out, and a variant whose VALUE is CompatScore gives
// the production degrees of unmasked input bit for bit.
//
// two-sided: grid (row tiles, batch), one row per thread. A block owns whole
//   rows, so the row sum is a register and no atomics are needed. Column
//   tiles of P, Q and the column mask are staged in shared memory as SoA and
//   swept by every thread of the block, row sums in column order. The
//   i != j test uses global row ids (row_offset + i), so a caller holding a
//   slice of rows gets the slice of the full result.
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

constexpr int kRowsPerBlock = 128;
constexpr int kColTile = 256;

template <bool MASKED, class Value>
__global__ void __launch_bounds__(kRowsPerBlock)
two_sided_degrees_kernel(const float* __restrict__ P_rows, const float* __restrict__ Q_rows,
                         const float* __restrict__ P_cols, const float* __restrict__ Q_cols,
                         const float* __restrict__ mask_rows,
                         const float* __restrict__ mask_cols, float* __restrict__ deg, int R,
                         int C, long long row_offset, Value value) {
    __shared__ float cpx[kColTile], cpy[kColTile], cpz[kColTile];
    __shared__ float cqx[kColTile], cqy[kColTile], cqz[kColTile];
    __shared__ float cm[MASKED ? kColTile : 1];

    const int b = blockIdx.y;
    const int i = blockIdx.x * kRowsPerBlock + threadIdx.x;
    const bool row_ok = i < R;
    const long long rbase = (static_cast<long long>(b) * R + (row_ok ? i : 0)) * 3;
    const float px = P_rows[rbase], py = P_rows[rbase + 1], pz = P_rows[rbase + 2];
    const float qx = Q_rows[rbase], qy = Q_rows[rbase + 1], qz = Q_rows[rbase + 2];
    const float mi = MASKED && mask_rows
                         ? mask_rows[static_cast<long long>(b) * R + (row_ok ? i : 0)] : 1.0f;
    const long long gid = row_offset + i;

    const float* pc = P_cols + static_cast<long long>(b) * C * 3;
    const float* qc = Q_cols + static_cast<long long>(b) * C * 3;
    const float* mc = mask_cols ? mask_cols + static_cast<long long>(b) * C : nullptr;

    float acc = 0.0f;
    for (int c0 = 0; c0 < C; c0 += kColTile) {
        const int n = min(kColTile, C - c0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const long long o = static_cast<long long>(c0 + t) * 3;
            cpx[t] = pc[o]; cpy[t] = pc[o + 1]; cpz[t] = pc[o + 2];
            cqx[t] = qc[o]; cqy[t] = qc[o + 1]; cqz[t] = qc[o + 2];
            if constexpr (MASKED) cm[t] = mc ? mc[c0 + t] : 1.0f;
        }
        __syncthreads();
        for (int t = 0; t < n; ++t) {
            float s = value(px, py, pz, qx, qy, qz, cpx[t], cpy[t], cpz[t], cqx[t], cqy[t],
                            cqz[t]);
            if constexpr (MASKED) {
                if (gid == c0 + t) s = 0.0f;
                acc += s * (mi * cm[t]);
            } else {
                acc += s;
            }
        }
        __syncthreads();
    }
    if (row_ok) deg[static_cast<long long>(b) * R + i] = acc;
}

template <bool MASKED, class Value>
int launch_two_sided(const float* P_rows, const float* Q_rows, const float* P_cols,
                     const float* Q_cols, const float* mask_rows, const float* mask_cols,
                     float* deg, int batch, int R, int C, long long row_offset, Value value,
                     cudaStream_t s) {
    const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, batch);
    two_sided_degrees_kernel<MASKED, Value><<<grid, kRowsPerBlock, 0, s>>>(
        P_rows, Q_rows, P_cols, Q_cols, mask_rows, mask_cols, deg, R, C, row_offset, value);
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
                   Value value) {
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

    const int r = ti * kTile + threadIdx.x;
    const bool row_ok = r < N;
    const long long ro = static_cast<long long>(row_ok ? r : 0) * 3;
    const float px = Pb[ro], py = Pb[ro + 1], pz = Pb[ro + 2];
    const float qx = Qb[ro], qy = Qb[ro + 1], qz = Qb[ro + 2];
    const float mr = mb ? mb[row_ok ? r : 0] : 1.0f;
    {
        const int c = tj * kTile + threadIdx.x;
        const long long co = static_cast<long long>(c < N ? c : 0) * 3;
        const float mc = mb ? mb[c < N ? c : 0] : 1.0f;
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
            const int c = tj * kTile + t;
            const float4 a = cp[t];
            const float4 d = cq[t];
            float s = value(px, py, pz, qx, qy, qz, a.x, a.y, a.z, d.x, d.y, d.z);
            if constexpr (MASKED) {
                if (!row_ok || c >= N || c == r) s = 0.0f;
                v[q] = s * (mr * a.w);
            } else {
                if (!row_ok || c >= N) s = 0.0f;
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

    float* pb = part + static_cast<long long>(b) * n_tiles * N;
    if (!diag) {
        __syncthreads();
        const int c = tj * kTile + threadIdx.x;
        if (c < N) {
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
template <bool MASKED, class Value>
int launch_tri(const float* P, const float* Q, const float* mask, float* part, float* deg,
               int batch, int N, int n_tiles, Value value, cudaStream_t s) {
    if (n_tiles != (N + kTile - 1) / kTile) return static_cast<int>(cudaErrorInvalidValue);
    const long long pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
    tri_degrees_kernel<MASKED, Value><<<dim3(static_cast<unsigned>(pairs), batch), kTriThreads,
                                        0, s>>>(P, Q, mask, part, N, n_tiles, value);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    degree_sum_kernel<float><<<dim3((N + 255) / 256, batch), 256, 0, s>>>(part, deg, N, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
