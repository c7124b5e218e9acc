// Hypothesis scoring: per hypothesis k of batch b,
//   count[b, k]  = sum_n [ |R p_n + t - q_n|^2 < tau^2 ] * [m_n > 0]
//   weight[b, k] = sum_n max(0, 1 - |R p_n + t - q_n| * (1/tau)) * [m_n > 0]   (weighted mode)
//
// Replaces saccot_tpu/kernels/score.py::_score_kernel. The TPU kernel folds the
// mask into q by moving masked targets to 1e15; here a masked point is skipped
// explicitly.
//
// Bound: FP32 instructions. SCORE_OPS = 28 per (hypothesis, point) pair (the
// residual 3 x 7, its square 5, the threshold and the count) at 33.45e12
// instructions/s: 1.3e8 pairs per batch at the bench point (128 x 1024
// hypotheses x 1000 points), 2e8 at the kitti point (2 x 2048 x 50,000).
// Device memory traffic is O(K + N) per batch element. As compiled, the
// count-mode inner loop issues about 246 instructions for 4 points x 2
// hypotheses, 30.8 a pair (chip_smoke.py prints the loop sizes).
//
// Design. The grid is (hypothesis tiles, point splits, batch):
//   - A block of 128 threads holds 256 hypotheses, two a thread, 12 floats
//     each in registers. Each point is staged once in shared memory as two
//     float4s, (px, py, pz, qx) and (qy, qz, m, 0), so a point costs two
//     vector loads shared by both hypotheses of a thread (the first design
//     spent 7 scalar loads on every pair).
//   - Where the hypothesis tiles alone do not fill the card (kitti: 8 tiles
//     x batch 2 = 16 blocks on 132 SMs), the wrapper splits the point axis
//     into contiguous chunks, one per blockIdx.y (kernels/score.py
//     score_plan). Each split writes its partial counts to a scratch
//     [batch, splits, K]; the last block of a hypothesis tile to finish (a
//     __threadfence and an atomic ticket per tile) sums them and writes the
//     result, in the same launch, then puts the ticket back to 0, so the
//     wrapper keeps one zeroed ticket buffer per stream and launches nothing
//     else.
//   - Weights are summed in an order fixed by N alone: each segment of
//     kPointTile points (segment s holds points [s kPointTile, (s + 1)
//     kPointTile)) in point order from 0, then the segments in order. A
//     split's chunk is a whole number of segments and writes one partial per
//     segment to a scratch [batch, N / kPointTile, K]; one split adds its
//     segments in registers. So a hypothesis's weight has the same bits at any
//     batch, K, split count or SM count: a tensor-parallel rank that scores
//     K / 2 hypotheses agrees with one rank that scores all K.
//   - `weighted` and "has a mask" are template parameters: the count-mode
//     loop has no branch.
// The residual is formed as ((t - q) + r0 p0) + r1 p1 + r2 p2, the TPU
// kernel's order, with explicitly rounded operations (common.cuh), as the
// plain PyTorch version forms it: no product contracts into an FMA, so every
// inlier decision, and so every count, equals the plain version's. (With
// FMAs, 0.27% of the hypotheses at the kitti point, N = 50,000, counted one
// point differently.)
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHyp = 2;                       // hypotheses per thread
constexpr int kHypTile = kThreads * kHyp;     // hypotheses per block
constexpr int kPointTile = 256;               // also the weights' summation segment

using saccot::add_rn;
using saccot::mul_rn;
using saccot::sub_rn;

// ((t - q) + r0 p0) + r1 p1) + r2 p2, each operation rounded on its own.
__device__ __forceinline__ float residual(float t, float q, float r0, float r1, float r2,
                                          float p0, float p1, float p2) {
    return add_rn(add_rn(add_rn(sub_rn(t, q), mul_rn(r0, p0)), mul_rn(r1, p1)),
                  mul_rn(r2, p2));
}

template <bool kWeighted, bool kMasked>
__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ r9, const float* __restrict__ t3,
             const float* __restrict__ P, const float* __restrict__ Q,
             const float* __restrict__ mask, float* __restrict__ scores,
             int* __restrict__ counts, int* __restrict__ part_c, float* __restrict__ part_w,
             int* __restrict__ tickets, int N, int K, int chunk, float tau2, float inv_tau) {
    __shared__ float4 spq[kPointTile];   // (px, py, pz, qx)
    __shared__ float4 sqm[kPointTile];   // (qy, qz, m, 0)
    __shared__ int is_last;

    const int tile = blockIdx.x;
    const int split = blockIdx.y;
    const int splits = gridDim.y;
    const int b = blockIdx.z;

    float r[kHyp][9], t[kHyp][3];
#pragma unroll
    for (int h = 0; h < kHyp; ++h) {
        const int k = tile * kHypTile + h * kThreads + threadIdx.x;
        const int kk = k < K ? k : 0;
        const long long base9 = static_cast<long long>(b) * 9 * K + kk;
        const long long base3 = static_cast<long long>(b) * 3 * K + kk;
#pragma unroll
        for (int e = 0; e < 9; ++e) r[h][e] = r9[base9 + static_cast<long long>(e) * K];
#pragma unroll
        for (int c = 0; c < 3; ++c) t[h][c] = t3[base3 + static_cast<long long>(c) * K];
    }

    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const float* mb = kMasked ? mask + static_cast<long long>(b) * N : nullptr;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);

    const long long out_b = static_cast<long long>(b) * K;
    const int segs = (N + kPointTile - 1) / kPointTile;
    int count[kHyp];
    float wsum[kHyp];
#pragma unroll
    for (int h = 0; h < kHyp; ++h) { count[h] = 0; wsum[h] = 0.0f; }

    for (int n0 = n_begin; n0 < n_end; n0 += kPointTile) {
        const int n = min(kPointTile, n_end - n0);
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const long long o = static_cast<long long>(n0 + i) * 3;
            spq[i] = make_float4(Pb[o], Pb[o + 1], Pb[o + 2], Qb[o]);
            sqm[i] = make_float4(Qb[o + 1], Qb[o + 2], kMasked ? mb[n0 + i] : 1.0f, 0.0f);
        }
        __syncthreads();
        float wseg[kHyp];
#pragma unroll
        for (int h = 0; h < kHyp; ++h) wseg[h] = 0.0f;
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
            const float4 a = spq[i];
            const float4 c = sqm[i];
            const bool live = !kMasked || c.z > 0.0f;
#pragma unroll
            for (int h = 0; h < kHyp; ++h) {
                const float x0 = residual(t[h][0], a.w, r[h][0], r[h][1], r[h][2], a.x, a.y, a.z);
                const float x1 = residual(t[h][1], c.x, r[h][3], r[h][4], r[h][5], a.x, a.y, a.z);
                const float x2 = residual(t[h][2], c.y, r[h][6], r[h][7], r[h][8], a.x, a.y, a.z);
                const float d2 = add_rn(add_rn(mul_rn(x0, x0), mul_rn(x1, x1)), mul_rn(x2, x2));
                count[h] += (live && d2 < tau2) ? 1 : 0;
                if (kWeighted && live) {
                    wseg[h] += fmaxf(0.0f, sub_rn(1.0f, mul_rn(__fsqrt_rn(d2), inv_tau)));
                }
            }
        }
        if (kWeighted) {
            // This tile is segment n0 / kPointTile (chunks are whole segments).
            const long long seg = (static_cast<long long>(b) * segs + n0 / kPointTile) * K;
#pragma unroll
            for (int h = 0; h < kHyp; ++h) {
                const int k = tile * kHypTile + h * kThreads + threadIdx.x;
                if (splits == 1) {
                    wsum[h] = add_rn(wsum[h], wseg[h]);
                } else if (k < K) {
                    part_w[seg + k] = wseg[h];
                }
            }
        }
        __syncthreads();
    }

    if (splits == 1) {
#pragma unroll
        for (int h = 0; h < kHyp; ++h) {
            const int k = tile * kHypTile + h * kThreads + threadIdx.x;
            if (k < K) {
                counts[out_b + k] = count[h];
                scores[out_b + k] = kWeighted ? wsum[h] : static_cast<float>(count[h]);
            }
        }
        return;
    }

    // This split's partial counts (its segments' weights are written), then
    // the tile's ticket.
    const long long part = (static_cast<long long>(b) * splits + split) * K;
#pragma unroll
    for (int h = 0; h < kHyp; ++h) {
        const int k = tile * kHypTile + h * kThreads + threadIdx.x;
        if (k < K) part_c[part + k] = count[h];
    }
    __threadfence();
    __syncthreads();
    int* ticket = tickets + static_cast<long long>(b) * gridDim.x + tile;
    if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;

    // The last block of the tile: every split's partials are visible (each
    // writer fenced before taking its ticket); read them past L1, the weights
    // in segment order. Every block of the tile has taken its ticket, so it
    // goes back to 0 for the next launch on this stream.
    if (threadIdx.x == 0) *ticket = 0;
    __threadfence();
#pragma unroll
    for (int h = 0; h < kHyp; ++h) {
        const int k = tile * kHypTile + h * kThreads + threadIdx.x;
        if (k < K) {
            int c = 0;
            for (int s = 0; s < splits; ++s) {
                c += __ldcg(part_c + (static_cast<long long>(b) * splits + s) * K + k);
            }
            float w = 0.0f;
            if (kWeighted) {
#pragma unroll 8
                for (int s = 0; s < segs; ++s) {
                    w = add_rn(w, __ldcg(part_w + (static_cast<long long>(b) * segs + s) * K + k));
                }
            }
            counts[out_b + k] = c;
            scores[out_b + k] = kWeighted ? w : static_cast<float>(c);
        }
    }
}

template <bool kWeighted, bool kMasked>
void launch(const dim3& grid, cudaStream_t stream, const float* r9, const float* t3,
            const float* P, const float* Q, const float* mask, float* scores, int* counts,
            int* part_c, float* part_w, int* tickets, int N, int K, int chunk, float tau2,
            float inv_tau) {
    score_kernel<kWeighted, kMasked><<<grid, kThreads, 0, stream>>>(
        r9, t3, P, Q, mask, scores, counts, part_c, part_w, tickets, N, K, chunk, tau2,
        inv_tau);
}

}  // namespace

// splits > 1 needs a chunk that is a multiple of 256 points, part_c of
// [batch, splits, K], in weighted mode part_w of [batch, ceil(N / 256), K],
// and tickets of [batch, ceil(K / 256)] ints that are zero (they are zero
// again when the launch ends).
extern "C" int saccot_score(const void* r9, const void* t3, const void* P, const void* Q,
                            const void* mask, void* scores, void* counts, void* part_c,
                            void* part_w, void* tickets, int batch, int N, int K, int splits,
                            int chunk, float tau2, float inv_tau, int weighted, void* stream) {
    const dim3 grid((K + kHypTile - 1) / kHypTile, splits, batch);
    auto* fn = weighted ? (mask ? launch<true, true> : launch<true, false>)
                        : (mask ? launch<false, true> : launch<false, false>);
    fn(grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(r9),
       static_cast<const float*>(t3), static_cast<const float*>(P),
       static_cast<const float*>(Q), static_cast<const float*>(mask),
       static_cast<float*>(scores), static_cast<int*>(counts), static_cast<int*>(part_c),
       static_cast<float*>(part_w), static_cast<int*>(tickets), N, K, chunk, tau2, inv_tau);
    return static_cast<int>(cudaGetLastError());
}
