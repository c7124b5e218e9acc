// Anchor rows of the compatibility matrix -> top-B neighbours -> candidate
// triangles, fused per anchor.
//
// Replaces saccot_tpu/kernels/triangles.py::_anchor_topb_kernel. For one
// anchor a of one batch element the kernel
//   1. recomputes the anchor's score row s(a, j) for all N columns with the
//      shared predicate (common.cuh), the self test and the masks, and keeps
//      it in shared memory (N <= 4096 -> at most 16 KB);
//   2. runs B argmax rounds over the key (score desc, column asc) with a
//      knockout, which is lax.top_k's order;
//   3. (modes 1 and 2) loads the B selected neighbours' coordinates by direct
//      index (the TPU kernel used a one-hot matmul to avoid gathers), scores
//      the B x B pair grid (common.cuh, shared with candidate_topt.cu), and
//      either
//        mode 1: writes the B(B-1)/2 candidate scores in np.triu_indices order,
//        mode 2: runs T argmax rounds over the grid (score desc, pair id asc),
//                writing max(score, -1) and the decoded neighbour node ids.
//
// Bound: FP32 instructions of the row recompute (PAIR_OPS + 1 per (anchor,
// column): two distances with their roots, the predicate, the self test and
// the masks), 3.3e7 evaluations per call at the bench point (128 x 256
// anchors x 1000 columns), and of the B(B-1)/2 pair scores. Nothing but
// O(A*B) results leaves the chip. The first design (one block of 128 threads
// per anchor, block-argmax rounds) spent about 50 block barriers per anchor
// on the selection and issued more instructions selecting than scoring.
//
// Design: one warp per (anchor, batch), W warps (W anchors of one batch
// element) per block; grid (ceil(A / W), batch). The wrapper chooses W
// (kernels/triangles.py anchor_plan) so that the W per-warp regions fit in
// dynamic shared memory. A region is a WarpScratch (the selections and their
// coordinates) and max(N, B*B) floats: the score row, later overwritten by
// the pair grid. Lane l computes columns l, l+32, ... and keeps the best two
// (score, column) entries of its slice in registers. The B rounds are the
// one selection loop of common.cuh (warp_top_b, shared with
// anchor_topb_stream.cu): a round is one warp_argmax (two REDUX warp
// reductions: the largest score, then the smallest column holding it), after
// which every lane holds the winner; only the lane that holds it moves up
// its second entry (knocking the winner out of the row), and it rescans its
// slice of the row only when both are spent. The candidate grid and the
// top-T rounds run at warp scope (common.cuh, WarpScope). There is no block
// barrier: the warps of a block never wait for each other. As compiled, the
// row costs 87-95 instructions a column (without and with a column mask;
// chip_smoke.py prints the loop sizes) against the 41 counted in the bound:
// the roots' range checks and branches, the loads and their addresses, the
// selection.
#include "common.cuh"

namespace {

constexpr int kMaxB = 32;
constexpr int kMaxWarps = 8;

// Per-warp selections: 256 words (kernels/triangles.py WARP_SCRATCH_WORDS).
struct WarpScratch {
    float sel_s[kMaxB];
    int sel_i[kMaxB];
    float sp[kMaxB * 3];
    float sq[kMaxB * 3];
};

__host__ __device__ __forceinline__ int region_floats(int N, int B) {
    return N > B * B ? N : B * B;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
anchor_topb_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                   const long long* __restrict__ anchors,
                   const float* __restrict__ mask, const float* __restrict__ anchor_mask,
                   int N, int A, int B, int mode, int top_t, int cand_cols,
                   float tau, float inv_tau, float min_sep,
                   float* __restrict__ nbr_s, long long* __restrict__ nbr_idx,
                   float* __restrict__ cand, long long* __restrict__ cand_j,
                   long long* __restrict__ cand_k) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    WarpScratch& ws = reinterpret_cast<WarpScratch*>(smem)[warp];
    float* row = reinterpret_cast<float*>(smem + warps * sizeof(WarpScratch))
                 + static_cast<long long>(warp) * region_floats(N, B);

    const int a = blockIdx.x * warps + warp;
    if (a >= A) return;
    const int b = blockIdx.y;
    const long long ab = static_cast<long long>(b) * A + a;
    const long long aid = anchors[ab];
    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const float* mb = mask ? mask + static_cast<long long>(b) * N : nullptr;
    const float am = anchor_mask ? anchor_mask[ab] : 1.0f;
    const float pax = Pb[aid * 3], pay = Pb[aid * 3 + 1], paz = Pb[aid * 3 + 2];
    const float qax = Qb[aid * 3], qay = Qb[aid * 3 + 1], qaz = Qb[aid * 3 + 2];

    // 1. The anchor's score row, ((s * m_j) * m_a) as the TPU kernel orders
    // it; each lane keeps the best two entries of its own columns.
    saccot::Best2 best;
    for (int j = lane; j < N; j += 32) {
        const float dp = saccot::dist3(pax, pay, paz, Pb[j * 3], Pb[j * 3 + 1], Pb[j * 3 + 2]);
        const float dq = saccot::dist3(qax, qay, qaz, Qb[j * 3], Qb[j * 3 + 1], Qb[j * 3 + 2]);
        float s = saccot::compat_score(dp, dq, tau, inv_tau, min_sep);
        if (j == aid) s = 0.0f;
        if (mb) s = s * mb[j];
        s = s * am;
        row[j] = s;
        best.offer(s, j);
    }

    // 2. B rounds of the one selection loop (common.cuh): lane r keeps
    // selection r; a lane rescans its slice of the row only when both of its
    // entries are spent.
    float my_s = 0.0f;
    int my_i = 0;
    saccot::warp_top_b(
        best, B, -INFINITY, [&](int i) { row[i] = saccot::spent(); },
        [&](float, int, saccot::Best2& bb) {
            for (int j = lane; j < N; j += 32) bb.offer(row[j], j);
        }, my_s, my_i);
    if (lane < B) {
        nbr_s[ab * B + lane] = my_s;
        nbr_idx[ab * B + lane] = my_i;
    }
    if (mode == 0) return;

    // 3. Selected neighbours' coordinates by direct index.
    if (lane < B) {
        const long long j = min(my_i, N - 1);
        ws.sel_s[lane] = my_s;
        ws.sel_i[lane] = my_i;
        for (int c = 0; c < 3; ++c) {
            ws.sp[3 * lane + c] = Pb[j * 3 + c];
            ws.sq[3 * lane + c] = Qb[j * 3 + c];
        }
    }
    __syncwarp();

    // The B x B pair grid over the row's storage, then mode 1 is done; mode 2
    // runs the T argmax rounds over it.
    const saccot::WarpScope scope{};
    float* cand_row = cand + ab * cand_cols;
    saccot::candidate_grid(scope, ws.sel_s, ws.sp, ws.sq, B, tau, inv_tau, min_sep, row,
                           mode == 1 ? cand_row : nullptr);
    if (mode == 1) return;
    saccot::grid_top_t(scope, row, ws.sel_i, B, top_t, cand_row, cand_j + ab * top_t,
                       cand_k + ab * top_t);
}

}  // namespace

// `warps` anchors per block (1..8); dynamic shared memory is warps x
// (sizeof(WarpScratch) + 4 max(N, B*B)) bytes, which anchor_plan keeps within
// the 48 KB a block gets without an opt-in.
extern "C" int saccot_anchor_topb(const void* P, const void* Q, const void* anchors,
                                  const void* mask, const void* anchor_mask,
                                  void* nbr_s, void* nbr_idx, void* cand, void* cand_j,
                                  void* cand_k, int batch, int N, int A, int B, int mode,
                                  int top_t, int cand_cols, int warps, float tau,
                                  float inv_tau, float min_sep, void* stream) {
    if (warps < 1 || warps > kMaxWarps || B < 1 || B > kMaxB) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((A + warps - 1) / warps, batch);
    const size_t smem = static_cast<size_t>(warps)
                        * (sizeof(WarpScratch) + sizeof(float) * region_floats(N, B));
    anchor_topb_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const long long*>(anchors), static_cast<const float*>(mask),
        static_cast<const float*>(anchor_mask), N, A, B, mode, top_t, cand_cols, tau,
        inv_tau, min_sep, static_cast<float*>(nbr_s), static_cast<long long*>(nbr_idx),
        static_cast<float*>(cand), static_cast<long long*>(cand_j),
        static_cast<long long*>(cand_k));
    return static_cast<int>(cudaGetLastError());
}
