// Hypothesis scoring: per hypothesis k of batch b,
//   count[b, k]  = sum_n [ |R p_n + t - q_n|^2 < tau^2 ] * [m_n > 0]
//   weight[b, k] = sum_n max(0, 1 - |R p_n + t - q_n| * (1/tau)) * [m_n > 0]   (weighted mode)
//
// Replaces saccot_tpu/kernels/score.py::_score_kernel. The TPU kernel folds the
// mask into q by moving masked targets to 1e15; here a masked point is skipped
// explicitly.
//
// Bound: FP32 operations. About 1.3e8 (hypothesis, point) pairs per batch at
// the bench point (128 x 1024 hypotheses x 1000 points), 2e8 at the kitti
// point (2 x 2048 x 50,000), ~25 operations each; the points are re-read
// from shared memory, so device memory traffic is O(K + N) per batch.
//
// Design: grid (hypothesis tiles, batch), one hypothesis per thread holding
// its 12 floats in registers, and a loop over point tiles staged in shared
// memory as SoA. The count is an int32 register accumulator; the square root
// of the weighted mode is only computed in that mode. The residual is formed
// as ((t - q) + r0 p0) + r1 p1 + r2 p2, the TPU kernel's order, with explicitly
// rounded operations (common.cuh), as the plain PyTorch version forms it: no
// product contracts into an FMA, so every inlier decision, and so every count,
// equals the plain version's. (With FMAs, 0.27% of the hypotheses at the
// kitti point, N = 50,000, counted one point differently.)
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPointTile = 512;

using saccot::add_rn;
using saccot::mul_rn;
using saccot::sub_rn;

// ((t - q) + r0 p0) + r1 p1) + r2 p2, each operation rounded on its own.
__device__ __forceinline__ float residual(float t, float q, float r0, float r1, float r2,
                                          float p0, float p1, float p2) {
    return add_rn(add_rn(add_rn(sub_rn(t, q), mul_rn(r0, p0)), mul_rn(r1, p1)),
                  mul_rn(r2, p2));
}

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ r9, const float* __restrict__ t3,
             const float* __restrict__ P, const float* __restrict__ Q,
             const float* __restrict__ mask, float* __restrict__ scores,
             int* __restrict__ counts, int N, int K, float tau2, float inv_tau,
             int weighted) {
    __shared__ float spx[kPointTile], spy[kPointTile], spz[kPointTile];
    __shared__ float sqx[kPointTile], sqy[kPointTile], sqz[kPointTile];
    __shared__ float sm[kPointTile];

    const int b = blockIdx.y;
    const int k = blockIdx.x * kThreads + threadIdx.x;
    const bool k_ok = k < K;
    const int kk = k_ok ? k : 0;
    const long long base9 = static_cast<long long>(b) * 9 * K + kk;
    const long long base3 = static_cast<long long>(b) * 3 * K + kk;
    float r[9], t[3];
    for (int e = 0; e < 9; ++e) r[e] = r9[base9 + static_cast<long long>(e) * K];
    for (int c = 0; c < 3; ++c) t[c] = t3[base3 + static_cast<long long>(c) * K];

    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const float* mb = mask ? mask + static_cast<long long>(b) * N : nullptr;

    int count = 0;
    float wsum = 0.0f;
    for (int n0 = 0; n0 < N; n0 += kPointTile) {
        const int n = min(kPointTile, N - n0);
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const long long o = static_cast<long long>(n0 + i) * 3;
            spx[i] = Pb[o]; spy[i] = Pb[o + 1]; spz[i] = Pb[o + 2];
            sqx[i] = Qb[o]; sqy[i] = Qb[o + 1]; sqz[i] = Qb[o + 2];
            sm[i] = mb ? mb[n0 + i] : 1.0f;
        }
        __syncthreads();
        for (int i = 0; i < n; ++i) {
            const float px = spx[i], py = spy[i], pz = spz[i];
            const float x0 = residual(t[0], sqx[i], r[0], r[1], r[2], px, py, pz);
            const float x1 = residual(t[1], sqy[i], r[3], r[4], r[5], px, py, pz);
            const float x2 = residual(t[2], sqz[i], r[6], r[7], r[8], px, py, pz);
            const float d2 = add_rn(add_rn(mul_rn(x0, x0), mul_rn(x1, x1)), mul_rn(x2, x2));
            const bool live = sm[i] > 0.0f;
            count += (live && d2 < tau2) ? 1 : 0;
            if (weighted && live) {
                wsum += fmaxf(0.0f, sub_rn(1.0f, mul_rn(__fsqrt_rn(d2), inv_tau)));
            }
        }
        __syncthreads();
    }
    if (k_ok) {
        const long long o = static_cast<long long>(b) * K + k;
        counts[o] = count;
        scores[o] = weighted ? wsum : static_cast<float>(count);
    }
}

}  // namespace

extern "C" int saccot_score(const void* r9, const void* t3, const void* P, const void* Q,
                            const void* mask, void* scores, void* counts, int batch, int N,
                            int K, float tau2, float inv_tau, int weighted, void* stream) {
    const dim3 grid((K + kThreads - 1) / kThreads, batch);
    score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r9), static_cast<const float*>(t3),
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const float*>(mask), static_cast<float*>(scores),
        static_cast<int*>(counts), N, K, tau2, inv_tau, weighted);
    return static_cast<int>(cudaGetLastError());
}
