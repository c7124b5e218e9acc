// The refine after the best hypothesis: `refine_iters` weighted-Umeyama fits
// on the inlier set of (R, t), each followed by its inlier pass, as
// saccot_tpu_torch/engine/sac_cot.refine does it in PyTorch (per pair b,
// w_n = [|R p_n + t - q_n| < tau] [m_n != 0] m_n; a pair with fewer than 3
// inliers keeps its previous fit).
//
// Each fit is two passes over the pair's points, one launch each, on a grid of
// (segments, batch) blocks of kThreads threads, a point a thread; a segment is
// the kThreads points [s kThreads, (s + 1) kThreads):
//   (a) kMoments: the inlier test of the current (R, t), as
//       engine/score.inlier_mask forms it, and the sums Σw, Σw p, Σw q;
//   (b) kCov: the same test again (the same operations on the same inputs give
//       the same bits, so nothing is stored between the passes), and the
//       centred cross-covariance H = Σ w (p - p̄)(q - q̄)^T around p̄ = Σw p /
//       max(Σw, 1e-9) and q̄, the two-pass form of engine/svd3.umeyama (raw
//       second moments would cancel at KITTI's 30 m scale).
// A final kMask pass writes the inlier mask [batch, N] of the last fit. So a
// refine of `refine_iters` fits is 2 refine_iters + 1 launches.
//
// Fixed order: a block sums its segment by one tree (warp shuffles, then the
// warps' sums) and writes one partial; the last block of a pair to finish (a
// __threadfence and an atomic ticket a pair, as score.cu does; the ticket goes
// back to 0, so no launch clears it) reads the partials, each thread adding the
// segments s, s + kThreads, ... in turn, and sums the threads by the same tree.
// The order is fixed by N alone: a pair gets the same bits alone as in any
// batch. Every operation is rounded on its own (common.cuh), so nothing
// contracts to an FMA and the inlier test is engine/score.inlier_mask's.
//
// Without a group, the last block of (a) writes the pair's sums, and the last
// block of (b) runs the fit: horn.cuh's quaternion_from_cross_covariance, R
// and t as engine/svd3.umeyama forms them, and the n >= 3 keep rule (n = Σw).
// It writes R and t to a buffer of their own, so every block of the launch
// reads the fit it started from. Under SP each rank holds a shard of the
// points: (a) writes the shard's sums and (b) its H, the wrapper all-reduces
// each, and the fit runs in saccot_refine_fit, one thread a pair, by the same
// device function.
//
// Bound (evaluation/roofline.refine_model): the bytes. Each pass reads the
// points and the mask, 28 B a point: 64 x 50,000 points at kitti, 1,623 x
// 2,048 at 3DMatch, 90-93 MB a pass.
#include "common.cuh"
#include "horn.cuh"

namespace {

constexpr int kThreads = 256;            // a point a thread; a segment is kThreads points
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 7;                 // Σw, Σw p (3), Σw q (3)
constexpr int kCov = 9;                  // H, row-major

enum Pass { kMomentsPass = 0, kCovPass = 1, kMaskPass = 2 };

using saccot::add_rn;
using saccot::mul_rn;
using saccot::sub_rn;

// ((t - q) + r0 p0) + r1 p1) + r2 p2, each operation rounded on its own.
__device__ __forceinline__ float residual(float t, float q, const float* r, const float p[3]) {
    return add_rn(add_rn(add_rn(sub_rn(t, q), mul_rn(r[0], p[0])), mul_rn(r[1], p[1])),
                  mul_rn(r[2], p[2]));
}

// engine/score.inlier_mask of one point: |R p + t - q| < tau, and m != 0.
__device__ __forceinline__ bool is_inlier(const float R[9], const float t[3], const float p[3],
                                          const float q[3], float m, float tau) {
    const float x0 = residual(t[0], q[0], R, p);
    const float x1 = residual(t[1], q[1], R + 3, p);
    const float x2 = residual(t[2], q[2], R + 6, p);
    const float d = __fsqrt_rn(add_rn(add_rn(mul_rn(x0, x0), mul_rn(x1, x1)), mul_rn(x2, x2)));
    return d < tau && m != 0.0f;
}

// The block's sum of v by a fixed tree, in thread 0; every thread must call it.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*warp_sums)[NV]) {
    const unsigned full = 0xffffffffu;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int e = 0; e < NV; ++e) v[e] = add_rn(v[e], __shfl_down_sync(full, v[e], off));
    }
    if (lane == 0) {
#pragma unroll
        for (int e = 0; e < NV; ++e) warp_sums[warp][e] = v[e];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int e = 0; e < NV; ++e) v[e] = lane < kWarps ? warp_sums[lane][e] : 0.0f;
#pragma unroll
        for (int off = kWarps / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int e = 0; e < NV; ++e) v[e] = add_rn(v[e], __shfl_down_sync(full, v[e], off));
        }
    }
    __syncthreads();  // warp_sums may be written again
}

// p̄ and q̄ from a pair's sums s = (Σw, Σw p, Σw q), with umeyama's
// clamp_min(Σw, 1e-9) (a NaN stays NaN, as in torch).
__device__ __forceinline__ void centroids(const float* s, float pbar[3], float qbar[3]) {
    const float wsum = s[0] < 1e-9f ? 1e-9f : s[0];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        pbar[c] = __fdiv_rn(s[1 + c], wsum);
        qbar[c] = __fdiv_rn(s[4 + c], wsum);
    }
}

// The fit of one pair from its sums s and cross-covariance h, kept where
// n = Σw >= 3, else the previous (R, t).
__device__ __forceinline__ void fit_and_keep(const float* s, const float h[9],
                                             const float* R_in, const float* t_in,
                                             float* R_out, float* t_out) {
    float pbar[3], qbar[3], q[4], r[9], t[3];
    centroids(s, pbar, qbar);
    saccot::quaternion_from_cross_covariance(h, q);
    saccot::rigid_from_quaternion(q, pbar, qbar, r, t);
    const bool keep = s[0] >= 3.0f;
#pragma unroll
    for (int e = 0; e < 9; ++e) R_out[e] = keep ? r[e] : R_in[e];
#pragma unroll
    for (int c = 0; c < 3; ++c) t_out[c] = keep ? t[c] : t_in[c];
}

// One pass over (segment, pair) blocks. R_in [batch, 9], t_in [batch, 3]: the
// fit the pass starts from. kMomentsPass writes sums [batch, 7]; kCovPass
// reads them and, with kFit, writes R_out / t_out, else H [batch, 9];
// kMaskPass writes inl [batch, N]. part [batch, segments, 9] and tickets
// [batch] (zero) are needed where a pair has more than one segment.
template <int kPass, bool kFit>
__global__ void __launch_bounds__(kThreads)
refine_pass_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                   const float* __restrict__ mask, const float* __restrict__ R_in,
                   const float* __restrict__ t_in, float* __restrict__ sums,
                   float* __restrict__ H, float* __restrict__ R_out, float* __restrict__ t_out,
                   unsigned char* __restrict__ inl, float* __restrict__ part,
                   int* __restrict__ tickets, int N, float tau) {
    constexpr int NV = kPass == kMomentsPass ? kSums : kCov;
    __shared__ float warp_sums[kWarps][NV];
    __shared__ int is_last;

    const int seg = blockIdx.x;
    const int segs = gridDim.x;
    const int b = blockIdx.y;
    const int n = seg * kThreads + threadIdx.x;

    float R[9], t[3];
#pragma unroll
    for (int e = 0; e < 9; ++e) R[e] = R_in[b * 9 + e];
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = t_in[b * 3 + c];

    float p[3] = {0.0f, 0.0f, 0.0f}, q[3] = {0.0f, 0.0f, 0.0f}, w = 0.0f;
    bool in = false;
    if (n < N) {
        const long long o = (static_cast<long long>(b) * N + n) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            p[c] = P[o + c];
            q[c] = Q[o + c];
        }
        const float m = mask[static_cast<long long>(b) * N + n];
        in = is_inlier(R, t, p, q, m, tau);
        w = in ? m : 0.0f;
    }
    if (kPass == kMaskPass) {
        if (n < N) inl[static_cast<long long>(b) * N + n] = in ? 1 : 0;
        return;
    }

    float v[NV];
    if (kPass == kMomentsPass) {
        v[0] = w;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            v[1 + c] = mul_rn(w, p[c]);
            v[4 + c] = mul_rn(w, q[c]);
        }
    } else {
        float pbar[3], qbar[3], wpc[3], qc[3];
        centroids(sums + b * kSums, pbar, qbar);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            wpc[c] = mul_rn(w, sub_rn(p[c], pbar[c]));
            qc[c] = sub_rn(q[c], qbar[c]);
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int c = 0; c < 3; ++c) v[3 * a + c] = n < N ? mul_rn(wpc[a], qc[c]) : 0.0f;
        }
    }
    block_sum<NV>(v, warp_sums);

    if (segs > 1) {
        // This segment's partial, then the pair's ticket; the last block of
        // the pair adds the partials (each writer fenced before its ticket),
        // read past L1.
        if (threadIdx.x == 0) {
            float* mine = part + (static_cast<long long>(b) * segs + seg) * kCov;
#pragma unroll
            for (int e = 0; e < NV; ++e) mine[e] = v[e];
            __threadfence();
            is_last = atomicAdd(tickets + b, 1) == segs - 1;
        }
        __syncthreads();
        if (!is_last) return;
        if (threadIdx.x == 0) tickets[b] = 0;  // every block of the pair has its ticket
        __threadfence();
#pragma unroll
        for (int e = 0; e < NV; ++e) v[e] = 0.0f;
        for (int s = threadIdx.x; s < segs; s += kThreads) {
            const float* theirs = part + (static_cast<long long>(b) * segs + s) * kCov;
#pragma unroll
            for (int e = 0; e < NV; ++e) v[e] = add_rn(v[e], __ldcg(theirs + e));
        }
        block_sum<NV>(v, warp_sums);
    }
    if (threadIdx.x != 0) return;

    if (kPass == kMomentsPass) {
#pragma unroll
        for (int e = 0; e < kSums; ++e) sums[b * kSums + e] = v[e];
    } else if (kFit) {
        fit_and_keep(sums + b * kSums, v, R_in + b * 9, t_in + b * 3, R_out + b * 9,
                     t_out + b * 3);
    } else {
#pragma unroll
        for (int e = 0; e < kCov; ++e) H[b * kCov + e] = v[e];
    }
}

// The fit of each pair from its (all-reduced) sums and H, one thread a pair.
__global__ void __launch_bounds__(kThreads)
refine_fit_kernel(const float* __restrict__ sums, const float* __restrict__ H,
                  const float* __restrict__ R_in, const float* __restrict__ t_in,
                  float* __restrict__ R_out, float* __restrict__ t_out, int batch) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b >= batch) return;
    float h[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) h[e] = H[b * kCov + e];
    fit_and_keep(sums + b * kSums, h, R_in + b * 9, t_in + b * 3, R_out + b * 9, t_out + b * 3);
}

template <int kPass, bool kFit>
void launch(int segs, int batch, cudaStream_t stream, const float* P, const float* Q,
            const float* mask, const float* R_in, const float* t_in, float* sums, float* H,
            float* R_out, float* t_out, unsigned char* inl, float* part, int* tickets, int N,
            float tau) {
    refine_pass_kernel<kPass, kFit><<<dim3(segs, batch), kThreads, 0, stream>>>(
        P, Q, mask, R_in, t_in, sums, H, R_out, t_out, inl, part, tickets, N, tau);
}

}  // namespace

// pass: 0 the sums, 1 the cross-covariance (with `fit`, the fit; else H),
// 2 the inlier mask. segs = ceil(N / 256) >= 1 and batch <= 65,535; where segs
// > 1, part holds [batch, segs, 9] floats and tickets [batch] zero ints (zero
// again when the launch ends).
extern "C" int saccot_refine_pass(int pass, int fit, const void* P, const void* Q,
                                  const void* mask, const void* R_in, const void* t_in,
                                  void* sums, void* H, void* R_out, void* t_out, void* inl,
                                  void* part, void* tickets, int batch, int N, int segs,
                                  float tau, void* stream) {
    auto* fn = pass == kMomentsPass ? launch<kMomentsPass, false>
               : pass == kMaskPass  ? launch<kMaskPass, false>
               : fit                ? launch<kCovPass, true>
                                    : launch<kCovPass, false>;
    fn(segs, batch, static_cast<cudaStream_t>(stream), static_cast<const float*>(P),
       static_cast<const float*>(Q), static_cast<const float*>(mask),
       static_cast<const float*>(R_in), static_cast<const float*>(t_in),
       static_cast<float*>(sums), static_cast<float*>(H), static_cast<float*>(R_out),
       static_cast<float*>(t_out), static_cast<unsigned char*>(inl),
       static_cast<float*>(part), static_cast<int*>(tickets), N, tau);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int saccot_refine_fit(const void* sums, const void* H, const void* R_in,
                                 const void* t_in, void* R_out, void* t_out, int batch,
                                 void* stream) {
    refine_fit_kernel<<<(batch + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sums), static_cast<const float*>(H),
        static_cast<const float*>(R_in), static_cast<const float*>(t_in),
        static_cast<float*>(R_out), static_cast<float*>(t_out), batch);
    return static_cast<int>(cudaGetLastError());
}
