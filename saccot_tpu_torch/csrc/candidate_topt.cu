// Per-anchor top-T candidate triangles from gathered neighbour coordinates.
//
// Replaces saccot_tpu/kernels/triangles.py::_candidate_topt_kernel: the
// N-independent second half of the fused anchor kernel, for the streamed
// path (N > 4096), where the neighbours come from anchor_topb_stream.cu and
// their coordinates are gathered by the wrapper ([batch, A, B, 3], an O(A*B)
// gather). Per anchor the block
//   1. loads its B selections (score, node id, coordinates); a selection with
//      score <= 0 is invalid (the TPU kernel's `sv * vm`);
//   2. scores the B x B pair grid and runs the T argmax rounds with the
//      device functions of common.cuh that the fused kernel (anchor_topb.cu)
//      runs, here at block scope (BlockScope), there at warp scope, so on
//      the same selections both give the same bits.
//
// Bound: latency. B*B/2 pair scores and T block-argmax rounds (three
// barriers each) per anchor, 1,024 blocks at the kitti point; device memory
// traffic is O(A * B) in and O(A * T) out.
//
// Design: grid (A, batch), 128 threads per block; everything in static shared
// memory (B <= 32).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxB = 32;

__global__ void __launch_bounds__(kThreads)
candidate_topt_kernel(const float* __restrict__ nbr_s, const long long* __restrict__ nbr_idx,
                      const float* __restrict__ nbr_p, const float* __restrict__ nbr_q,
                      int A, int B, int top_t, float tau, float inv_tau, float min_sep,
                      float* __restrict__ cand, long long* __restrict__ cand_j,
                      long long* __restrict__ cand_k) {
    __shared__ float grid_s[kMaxB * kMaxB];
    __shared__ float sel_s[kMaxB];
    __shared__ int sel_i[kMaxB];
    __shared__ float sp[kMaxB * 3], sq[kMaxB * 3];
    __shared__ float red_v[kThreads / 32];
    __shared__ int red_i[kThreads / 32];

    const long long ab = static_cast<long long>(blockIdx.y) * A + blockIdx.x;
    if (threadIdx.x < B) {
        const int r = threadIdx.x;
        const long long o = ab * B + r;
        sel_s[r] = nbr_s[o];
        sel_i[r] = static_cast<int>(nbr_idx[o]);
        for (int c = 0; c < 3; ++c) {
            sp[3 * r + c] = nbr_p[o * 3 + c];
            sq[3 * r + c] = nbr_q[o * 3 + c];
        }
    }
    __syncthreads();
    const saccot::BlockScope scope{red_v, red_i};
    saccot::candidate_grid(scope, sel_s, sp, sq, B, tau, inv_tau, min_sep, grid_s, nullptr);
    saccot::grid_top_t(scope, grid_s, sel_i, B, top_t, cand + ab * top_t, cand_j + ab * top_t,
                       cand_k + ab * top_t);
}

}  // namespace

extern "C" int saccot_candidate_topt(const void* nbr_s, const void* nbr_idx, const void* nbr_p,
                                     const void* nbr_q, void* cand, void* cand_j,
                                     void* cand_k, int batch, int A, int B, int top_t,
                                     float tau, float inv_tau, float min_sep, void* stream) {
    const dim3 grid(A, batch);
    candidate_topt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(nbr_s), static_cast<const long long*>(nbr_idx),
        static_cast<const float*>(nbr_p), static_cast<const float*>(nbr_q), A, B, top_t, tau,
        inv_tau, min_sep, static_cast<float*>(cand), static_cast<long long*>(cand_j),
        static_cast<long long*>(cand_k));
    return static_cast<int>(cudaGetLastError());
}
