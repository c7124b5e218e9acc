// Anchor rows of the compatibility matrix -> top-B neighbours -> candidate
// triangles, fused per anchor.
//
// Replaces saccot_tpu/kernels/triangles.py::_anchor_topb_kernel. For one
// anchor a of one batch element the kernel
//   1. recomputes the anchor's score row s(a, j) for all N columns with the
//      shared predicate (common.cuh), the self test and the masks, and keeps
//      it in shared memory (N <= 4096 -> at most 16 KB);
//   2. runs B block-argmax rounds over the key (score desc, column asc) with a
//      -inf knockout, which is lax.top_k's order;
//   3. (modes 1 and 2) loads the B selected neighbours' coordinates by direct
//      index (the TPU kernel used a one-hot matmul to avoid gathers), scores
//      the B x B pair grid (common.cuh, shared with candidate_topt.cu), and
//      either
//        mode 1: writes the B(B-1)/2 candidate scores in np.triu_indices order,
//        mode 2: runs T argmax rounds over the grid (score desc, pair id asc),
//                writing max(score, -1) and the decoded neighbour node ids.
//
// Bound: the row recompute (two square roots per (anchor, column)), about
// 3.3e7 evaluations per batch at the bench point (128 x 256 anchors x 1000
// columns); the B + T argmax rounds are shared-memory sweeps of N / blockDim
// and B*B / blockDim elements per thread. Nothing but O(A*B) results leaves
// the chip.
//
// Design: one block of 128 threads per (anchor, batch); grid (A, batch). The
// row lives in dynamic shared memory, the pair grid (B <= 32) in static shared
// memory. B > 32 is refused by the wrapper.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxB = 32;

__global__ void __launch_bounds__(kThreads)
anchor_topb_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                   const long long* __restrict__ anchors,
                   const float* __restrict__ mask, const float* __restrict__ anchor_mask,
                   int N, int A, int B, int mode, int top_t, int cand_cols,
                   float tau, float inv_tau, float min_sep,
                   float* __restrict__ nbr_s, long long* __restrict__ nbr_idx,
                   float* __restrict__ cand, long long* __restrict__ cand_j,
                   long long* __restrict__ cand_k) {
    extern __shared__ float row[];                 // [N]
    __shared__ float grid_s[kMaxB * kMaxB];
    __shared__ float sel_s[kMaxB];
    __shared__ int sel_i[kMaxB];
    __shared__ float sp[kMaxB][3], sq[kMaxB][3];
    __shared__ float red_v[kThreads / 32];
    __shared__ int red_i[kThreads / 32];

    const int a = blockIdx.x;
    const int b = blockIdx.y;
    const long long ab = static_cast<long long>(b) * A + a;
    const long long aid = anchors[ab];
    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const float* mb = mask ? mask + static_cast<long long>(b) * N : nullptr;
    const float am = anchor_mask ? anchor_mask[ab] : 1.0f;
    const float pax = Pb[aid * 3], pay = Pb[aid * 3 + 1], paz = Pb[aid * 3 + 2];
    const float qax = Qb[aid * 3], qay = Qb[aid * 3 + 1], qaz = Qb[aid * 3 + 2];

    // 1. The anchor's score row: ((s * m_j) * m_a), as the TPU kernel orders it.
    for (int j = threadIdx.x; j < N; j += kThreads) {
        const float dp = saccot::dist3(pax, pay, paz, Pb[j * 3], Pb[j * 3 + 1], Pb[j * 3 + 2]);
        const float dq = saccot::dist3(qax, qay, qaz, Qb[j * 3], Qb[j * 3 + 1], Qb[j * 3 + 2]);
        float s = saccot::compat_score(dp, dq, tau, inv_tau, min_sep);
        if (j == aid) s = 0.0f;
        if (mb) s = s * mb[j];
        row[j] = s * am;
    }
    __syncthreads();

    // 2. B argmax rounds; the winner is knocked out with -inf.
    for (int r = 0; r < B; ++r) {
        float v = -INFINITY;
        int i = N;
        for (int j = threadIdx.x; j < N; j += kThreads) {
            if (saccot::key_before(row[j], j, v, i)) { v = row[j]; i = j; }
        }
        saccot::block_argmax(v, i, red_v, red_i);
        if (threadIdx.x == 0) {
            sel_s[r] = v;
            sel_i[r] = i;
            if (i < N) row[i] = -INFINITY;
        }
        __syncthreads();
    }
    if (threadIdx.x < B) {
        const int r = threadIdx.x;
        nbr_s[ab * B + r] = sel_s[r];
        nbr_idx[ab * B + r] = sel_i[r];
    }
    if (mode == 0) return;

    // 3. Selected neighbours' coordinates by direct index.
    if (threadIdx.x < B) {
        const int r = threadIdx.x;
        const long long j = min(sel_i[r], N - 1);
        for (int c = 0; c < 3; ++c) {
            sp[r][c] = Pb[j * 3 + c];
            sq[r][c] = Qb[j * 3 + c];
        }
    }
    __syncthreads();

    // The B x B pair grid (common.cuh), then mode 1 is done; mode 2 runs the
    // T argmax rounds over it.
    float* cand_row = cand + ab * cand_cols;
    saccot::candidate_grid(sel_s, &sp[0][0], &sq[0][0], B, tau, inv_tau, min_sep, grid_s,
                           mode == 1 ? cand_row : nullptr);
    if (mode == 1) return;
    saccot::grid_top_t(grid_s, sel_i, B, top_t, red_v, red_i, cand_row,
                       cand_j + ab * top_t, cand_k + ab * top_t);
}

}  // namespace

extern "C" int saccot_anchor_topb(const void* P, const void* Q, const void* anchors,
                                  const void* mask, const void* anchor_mask,
                                  void* nbr_s, void* nbr_idx, void* cand, void* cand_j,
                                  void* cand_k, int batch, int N, int A, int B, int mode,
                                  int top_t, int cand_cols, float tau, float inv_tau,
                                  float min_sep, void* stream) {
    const dim3 grid(A, batch);
    const size_t smem = static_cast<size_t>(N) * sizeof(float);
    anchor_topb_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const long long*>(anchors), static_cast<const float*>(mask),
        static_cast<const float*>(anchor_mask), N, A, B, mode, top_t, cand_cols, tau,
        inv_tau, min_sep, static_cast<float*>(nbr_s), static_cast<long long*>(nbr_idx),
        static_cast<float*>(cand), static_cast<long long*>(cand_j),
        static_cast<long long*>(cand_k));
    return static_cast<int>(cudaGetLastError());
}
