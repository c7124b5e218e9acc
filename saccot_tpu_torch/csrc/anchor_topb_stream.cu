// Top-B compatibility neighbours of each anchor, streamed over column tiles:
// no cap on N.
//
// Replaces saccot_tpu/kernels/triangles.py::_anchor_topb_stream_kernel. The
// fused kernel (anchor_topb.cu) holds the anchor's whole score row in shared
// memory, which caps N; here one block per (anchor, batch) walks the columns
// in tiles of `tile_n` and merges each tile into a running top-B list:
//   1. the tile's scores s(a, j) are computed with the shared predicate
//      (common.cuh), the self test and the masks, in the fused kernel's order
//      of operations, into shared memory;
//   2. block-argmax rounds over the key (score desc, column asc) take the
//      tile's best entry; while it precedes the list's last entry it is
//      inserted in order (the last entry drops out) and knocked out with
//      -inf; the first entry that does not precede it ends the tile, since no
//      later entry of the tile can.
// The key is a total order, so the list after the last tile is lax.top_k of
// the whole row, bit-identical to the fused kernel's selection (scores and
// indices) whatever the tile width. The wrapper requires B <= N, so every
// slot holds a real column.
//
// Bound: the score recompute (two IEEE square roots per (anchor, column)),
// 5.1e7 evaluations at the kitti point (2 x 512 anchors x 50,000 columns),
// plus at least one block argmax (three barriers) per tile and one per
// insertion, about B ln(N / B) insertions per anchor. Device memory traffic is
// the point set once per anchor (read through L1/L2) and O(A * B) results.
//
// Design: grid (A, batch), 256 threads; the tile in dynamic shared memory
// (tile_n floats), the running list (B <= 32) in static shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 32;

__global__ void __launch_bounds__(kThreads)
anchor_topb_stream_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                          const long long* __restrict__ anchors,
                          const float* __restrict__ mask,
                          const float* __restrict__ anchor_mask, int N, int A, int B,
                          int tile_n, float tau, float inv_tau, float min_sep,
                          float* __restrict__ nbr_s, long long* __restrict__ nbr_idx) {
    extern __shared__ float tile[];               // [tile_n]
    __shared__ float top_v[kMaxB];
    __shared__ int top_i[kMaxB];
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

    // Every real entry (score >= 0) precedes the empty slots.
    if (threadIdx.x < B) {
        top_v[threadIdx.x] = -INFINITY;
        top_i[threadIdx.x] = N + threadIdx.x;
    }

    for (int c0 = 0; c0 < N; c0 += tile_n) {
        const int n = min(tile_n, N - c0);
        // 1. The tile's scores: ((s * m_j) * m_a), as the fused kernel orders it.
        for (int t = threadIdx.x; t < n; t += kThreads) {
            const long long j = c0 + t;
            const float dp = saccot::dist3(pax, pay, paz, Pb[j * 3], Pb[j * 3 + 1], Pb[j * 3 + 2]);
            const float dq = saccot::dist3(qax, qay, qaz, Qb[j * 3], Qb[j * 3 + 1], Qb[j * 3 + 2]);
            float s = saccot::compat_score(dp, dq, tau, inv_tau, min_sep);
            if (j == aid) s = 0.0f;
            if (mb) s = s * mb[j];
            tile[t] = s * am;
        }
        __syncthreads();

        // 2. Merge: at most B insertions; stop at the first tile entry that
        // does not precede the list's last entry.
        for (int r = 0; r < B; ++r) {
            // Read before block_argmax's barriers, after which thread 0 may
            // rewrite the list: the decision below is uniform across the block.
            const float last_v = top_v[B - 1];
            const int last_i = top_i[B - 1];
            float v = -INFINITY;
            int i = N;
            for (int t = threadIdx.x; t < n; t += kThreads) {
                if (saccot::key_before(tile[t], c0 + t, v, i)) { v = tile[t]; i = c0 + t; }
            }
            saccot::block_argmax(v, i, red_v, red_i);
            if (v == -INFINITY || !saccot::key_before(v, i, last_v, last_i)) break;
            if (threadIdx.x == 0) {
                int p = B - 1;
                while (p > 0 && saccot::key_before(v, i, top_v[p - 1], top_i[p - 1])) {
                    top_v[p] = top_v[p - 1];
                    top_i[p] = top_i[p - 1];
                    --p;
                }
                top_v[p] = v;
                top_i[p] = i;
                tile[i - c0] = -INFINITY;
            }
            __syncthreads();
        }
        __syncthreads();  // the tile is rewritten next
    }
    if (threadIdx.x < B) {
        nbr_s[ab * B + threadIdx.x] = top_v[threadIdx.x];
        nbr_idx[ab * B + threadIdx.x] = top_i[threadIdx.x];
    }
}

}  // namespace

extern "C" int saccot_anchor_topb_stream(const void* P, const void* Q, const void* anchors,
                                         const void* mask, const void* anchor_mask,
                                         void* nbr_s, void* nbr_idx, int batch, int N, int A,
                                         int B, int tile_n, float tau, float inv_tau,
                                         float min_sep, void* stream) {
    const dim3 grid(A, batch);
    const size_t smem = static_cast<size_t>(tile_n) * sizeof(float);
    anchor_topb_stream_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const long long*>(anchors), static_cast<const float*>(mask),
        static_cast<const float*>(anchor_mask), N, A, B, tile_n, tau, inv_tau, min_sep,
        static_cast<float*>(nbr_s), static_cast<long long*>(nbr_idx));
    return static_cast<int>(cudaGetLastError());
}
