// Batched 3-point rigid solves: triples -> (r9, t3), one thread per hypothesis.
//
// Replaces saccot_tpu/kernels/solve3.py::_solve_kernel (and, at any N, its
// streamed form _solve_stream_kernel) and fuses what the TPU left to XLA (the
// Horn quaternion iteration and the rotation/translation assembly,
// saccot_tpu/kernels/solve3.py:254-268). Per hypothesis a thread
//   1. loads the 3 + 3 points by index (the TPU kernel gathered them with a
//      one-hot matmul over split-bf16 coordinates; a direct load is exact),
//   2. forms the centroids and the 9-entry cross-covariance H,
//   3. runs horn.cuh's quaternion_from_cross_covariance, the shift-and-square
//      power iteration of saccot_tpu/engine/svd3.py in its order,
//   4. writes the row-major rotation entries r9[b, :, k] and t = qbar - R pbar.
//
// Every floating-point operation is explicitly rounded (common.cuh helpers,
// IEEE roots, correctly rounded reciprocals), so nothing contracts to FMA and
// the result is the plain PyTorch version's (saccot_tpu_torch/kernels/
// solve3.py) bit for bit; near-degenerate triples, whose column select is
// sensitive to the last bit, then pick the same column in both.
//
// Bound (evaluation/roofline.solve_model): at the bench point (128 x 1,024
// hypotheses, N=1,000) the bytes, 0.0037 ms on an H100: 24 B of triple ids
// and 48 B of r9/t3 a hypothesis, and the point rows; the function's own fit
// is 387 operations a hypothesis, 0.0015 ms. This kernel keeps the
// reference's arithmetic, each operation rounded on its own: its SASS runs
// 1,275 instructions a hypothesis (1,154 of them FP32, 27
// MUFU; horn.cuh writes the eight power steps out and drops the range tests
// of the roots and reciprocals its inner steps cannot need), and at 33.45e12
// lane instructions/s that alone is 0.0050 ms at the bench point, above the
// bound. Where the hypotheses fill the card that issue rate binds it: the
// busiest SM holds 1,024 hypotheses, 8 warps a scheduler, 5.2 us of issue at
// the 1,971-1,985 MHz measured, against 7.6 us of kernel over the launch
// floor in blocks of 256 (PERF.md §6). Where they do not (the kitti
// point: 2 x 2,048 hypotheses, a warp or two an SM) one thread's chain of
// dependent steps does: the index load, the point loads it names, eight
// squarings, each ending in a root and a reciprocal, two polish steps.
//
// Design: grid (ceil(K / threads), batch), a hypothesis a thread, its ids
// and points loaded directly from global memory, in the largest blocks of
// 256 or 128 that cover the SMs, else of 64 (kernels/solve3.py solve_plan).
// The outputs go to the SoA layout [batch, 9, K] / [batch, 3, K] that
// score.cu reads, neighbouring threads on neighbouring k. Index arithmetic
// is 32-bit within a pair (the wrapper raises if 3 N or 9 K reach 2^31); a
// pair's base is a 64-bit offset. Two other forms were measured and lost,
// so neither is kept: four lanes a hypothesis (each lane one row of every
// square, exchanged by warp shuffles) at the kitti point, and a persistent
// grid whose blocks staged their pair's cloud in shared memory with
// cp.async, the next pair's while the current tile ran Horn, at the bench
// and 3DMatch points (PERF.md §6 gives the readings and why).
#include "common.cuh"
#include "horn.cuh"

namespace {

constexpr int kMaxThreads = 256;

using saccot::add_rn;
using saccot::mul_rn;
using saccot::sub_rn;

// The rigid fit of one triple: centroids, H, Horn's quaternion, R (row-major
// r[9]) and t = qbar - R pbar.
__device__ __forceinline__ void fit3(const float p[3][3], const float q[3][3], float r[9],
                                     float t[3]) {
    const float third = 1.0f / 3.0f;
    float pbar[3], qbar[3];
    for (int c = 0; c < 3; ++c) {
        pbar[c] = mul_rn(add_rn(add_rn(p[0][c], p[1][c]), p[2][c]), third);
        qbar[c] = mul_rn(add_rn(add_rn(q[0][c], q[1][c]), q[2][c]), third);
    }
    float pc[3][3], qc[3][3];
    for (int s = 0; s < 3; ++s) {
        for (int c = 0; c < 3; ++c) {
            pc[s][c] = sub_rn(p[s][c], pbar[c]);
            qc[s][c] = sub_rn(q[s][c], qbar[c]);
        }
    }
    float h[9];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            h[3 * i + j] = add_rn(add_rn(mul_rn(pc[0][i], qc[0][j]), mul_rn(pc[1][i], qc[1][j])),
                                  mul_rn(pc[2][i], qc[2][j]));
        }
    }
    float qv[4];
    saccot::quaternion_from_cross_covariance(h, qv);
    saccot::rigid_from_quaternion(qv, pbar, qbar, r, t);
}

__global__ void __launch_bounds__(kMaxThreads)
solve3_kernel(const float* __restrict__ P, const float* __restrict__ Q,
              const long long* __restrict__ triples, float* __restrict__ r9,
              float* __restrict__ t3, int N, int K) {
    const int b = blockIdx.y;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const float* Pb = P + static_cast<size_t>(b) * (3 * N);
    const float* Qb = Q + static_cast<size_t>(b) * (3 * N);
    const long long* tri = triples + (static_cast<size_t>(b) * K + k) * 3;
    float p[3][3], q[3][3], r[9], t[3];
    for (int s = 0; s < 3; ++s) {
        const int row = 3 * static_cast<int>(tri[s]);
        for (int c = 0; c < 3; ++c) {
            p[s][c] = Pb[row + c];
            q[s][c] = Qb[row + c];
        }
    }
    fit3(p, q, r, t);
    float* rb = r9 + static_cast<size_t>(b) * (9 * K) + k;
    float* tb = t3 + static_cast<size_t>(b) * (3 * K) + k;
    for (int e = 0; e < 9; ++e) rb[e * K] = r[e];
    for (int c = 0; c < 3; ++c) tb[c * K] = t[c];
}

}  // namespace

// `threads` a block: a multiple of 32, at most 256.
extern "C" int saccot_solve3(const void* P, const void* Q, const void* triples, void* r9,
                             void* t3, int batch, int N, int K, int threads, void* stream) {
    if (threads < 32 || threads > kMaxThreads || threads % 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((K + threads - 1) / threads, batch);
    solve3_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const long long*>(triples), static_cast<float*>(r9),
        static_cast<float*>(t3), N, K);
    return static_cast<int>(cudaGetLastError());
}
