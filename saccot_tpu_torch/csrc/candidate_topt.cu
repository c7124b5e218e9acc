// Per-anchor top-T candidate triangles from the selected neighbours' node ids.
//
// Replaces saccot_tpu/kernels/triangles.py::_candidate_topt_kernel: the
// N-independent second half of the fused anchor kernel, for the streamed
// path (N > 4096), where the neighbours come from anchor_topb_stream.cu. The
// TPU wrapper gathered the neighbours' coordinates in XLA before its kernel;
// here each warp reads them from P and Q by node id (a direct load is exact).
// Per anchor one warp
//   1. loads its B selections (score, node id), then, by id, their
//      coordinates; a selection with score <= 0 is invalid (the TPU kernel's
//      `sv * vm`);
//   2. scores the B x B pair grid and runs the T argmax rounds with the
//      device functions of common.cuh that the fused kernel (anchor_topb.cu)
//      runs in its top-T mode, at the same warp scope, so on the same
//      selections both give the same bits.
//
// Bound: latency. Device memory traffic is O(A * B) in (a selection's score,
// id and 6 coordinates) and O(A * T) out, a fraction of a microsecond at
// the memory rate at the kitti point. A warp's work is a chain: the ids, the
// coordinates they name, B (B - 1) / 2 pair scores over 32 lanes, T arg-max
// rounds; half the anchors take nearly the time of all of them. The first
// design ran one block of 128 threads per anchor, three block barriers in
// each round, on coordinates gathered by two torch launches before it.
//
// Design: one warp per (anchor, batch), W warps a block (kernels/triangles.py
// candidate_plan), grid (ceil(A / W), batch). Each warp's region of dynamic
// shared memory holds its selections (8 B words: scores, ids, coordinates)
// and the B x B grid. The grid scores only the pairs b1 < b2, and the T
// rounds run on the anchor kernels' one selection loop (common.cuh). No
// block barrier: the warps of a block never wait for each other.
#include "common.cuh"

namespace {

constexpr int kMaxB = 32;
constexpr int kMaxWarps = 8;

// Floats of one warp's region (kernels/triangles.make_candidate_plan sizes it alike).
__host__ __device__ __forceinline__ int region_floats(int B) { return 8 * B + B * B; }

__global__ void __launch_bounds__(kMaxWarps * 32)
candidate_topt_kernel(const float* __restrict__ nbr_s, const long long* __restrict__ nbr_idx,
                      const float* __restrict__ P, const float* __restrict__ Q, int N, int A,
                      int B, int top_t, float tau, float inv_tau, float min_sep,
                      float* __restrict__ cand, long long* __restrict__ cand_j,
                      long long* __restrict__ cand_k) {
    extern __shared__ __align__(16) float smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int a = blockIdx.x * warps + warp;
    if (a >= A) return;
    float* sel_s = smem + warp * region_floats(B);
    int* sel_i = reinterpret_cast<int*>(sel_s + B);
    float* sp = sel_s + 2 * B;
    float* sq = sp + 3 * B;
    float* grid_s = sq + 3 * B;

    const int b = blockIdx.y;
    const long long ab = static_cast<long long>(b) * A + a;
    if (lane < B) {
        const long long o = ab * B + lane;
        const long long id = nbr_idx[o];
        sel_s[lane] = nbr_s[o];
        sel_i[lane] = static_cast<int>(id);
        // Ids lie in [0, N); the clamp keeps a stray one inside the pair's rows.
        const long long row = static_cast<long long>(b) * N + min(max(id, 0LL), N - 1LL);
        for (int c = 0; c < 3; ++c) {
            sp[3 * lane + c] = P[row * 3 + c];
            sq[3 * lane + c] = Q[row * 3 + c];
        }
    }
    __syncwarp();
    const saccot::WarpScope scope{};
    saccot::candidate_grid(scope, sel_s, sp, sq, B, tau, inv_tau, min_sep, grid_s, nullptr);
    saccot::grid_top_t(scope, grid_s, sel_i, B, top_t, cand + ab * top_t, cand_j + ab * top_t,
                       cand_k + ab * top_t);
}

}  // namespace

// `warps` anchors per block (1..8); dynamic shared memory is warps x
// 4 (8 B + B * B) bytes, at most 40 KB (B = 32, 8 warps).
extern "C" int saccot_candidate_topt(const void* nbr_s, const void* nbr_idx, const void* P,
                                     const void* Q, void* cand, void* cand_j, void* cand_k,
                                     int batch, int N, int A, int B, int top_t, int warps,
                                     float tau, float inv_tau, float min_sep, void* stream) {
    if (warps < 1 || warps > kMaxWarps || B < 1 || B > kMaxB) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((A + warps - 1) / warps, batch);
    const size_t smem = sizeof(float) * warps * region_floats(B);
    candidate_topt_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(nbr_s), static_cast<const long long*>(nbr_idx),
        static_cast<const float*>(P), static_cast<const float*>(Q), N, A, B, top_t, tau,
        inv_tau, min_sep, static_cast<float*>(cand), static_cast<long long*>(cand_j),
        static_cast<long long*>(cand_k));
    return static_cast<int>(cudaGetLastError());
}
