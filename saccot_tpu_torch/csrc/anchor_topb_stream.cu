// Top-B compatibility neighbours of each anchor at any N: the column axis is
// split into chunks, each chunk's top-B is selected by one warp, and the
// chunks' lists are merged in the same launch.
//
// Replaces saccot_tpu/kernels/triangles.py::_anchor_topb_stream_kernel. The
// TPU kernel streams column blocks one after another into a running top-B;
// here the chunks run side by side. The key (score desc, column asc) is a
// total order, so the top-B of the chunks' top-Bs is the row's top-B: the
// result is lax.top_k of the whole row, bit-identical to the fused kernel's
// selection (anchor_topb.cu) and the same under every plan.
//
// Bound: the score recompute, PAIR_OPS + 1 FP32 instructions per (anchor,
// column) (two distances with their IEEE roots, the predicate, the self test
// and the masks): 5.1e7 evaluations at the kitti point (2 x 512 anchors x
// 50,000 columns). Device memory traffic is the point set, read through L2
// once per (anchor tile, chunk), and O(A * chunks * B) partial lists.
//
// Design (kernels/triangles.py stream_plan chooses W and chunk_n):
//   - grid (ceil(A / W), chunks, batch); W warps a block, one warp per
//     (anchor, chunk of chunk_n columns); the W warps take W anchors of one
//     batch element over the same chunk, and the blocks of one chunk run
//     together, so they read its coordinates through the same L1 (staging
//     them in shared memory once a block measured no faster: it costs the
//     occupancy that hides the loop's latency);
//   - each warp writes its chunk's scores, in the fused kernel's order of
//     operations ((s * m_j) * m_a), to its own shared region; each lane keeps
//     the best two entries of its columns, then the rounds of the one warp
//     selection loop (common.cuh warp_top_b, shared with anchor_topb.cu),
//     which knocks the winners out of the region; a chunk with fewer than B
//     columns ends in (-inf, kNone);
//   - a floor per anchor (a zeroed buffer of ordered keys): a warp that
//     kept all B rounds raises it to its B-th score, and later chunks of the
//     anchor end their rounds at the first winner below it (those entries
//     are preceded by B of one chunk, so not in the row's top-B). It saves
//     rounds, never changes the result;
//   - with one chunk the warp writes the outputs; else it writes its list to
//     a [batch, A, chunks, B] scratch, fences, and the block takes a ticket
//     of its (batch, anchor tile). The last block of the tile merges, one
//     warp per anchor, with the same selection loop over the chunks x B
//     entries (read past L1), writes the outputs and puts the ticket and the
//     floors back to 0, so the buffer stays zeroed for the next launch.
// The block waits only at its ticket: no barrier runs in the selection.
#include "common.cuh"

namespace {

constexpr int kMaxB = 32;
constexpr int kMaxWarps = 8;

template <bool kMasked>
__global__ void __launch_bounds__(kMaxWarps * 32)
anchor_topb_stream_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                          const long long* __restrict__ anchors,
                          const float* __restrict__ mask,
                          const float* __restrict__ anchor_mask, int N, int A, int B,
                          int chunk_n, float tau, float inv_tau, float min_sep,
                          float* __restrict__ part_s, int* __restrict__ part_i,
                          int* __restrict__ tickets, unsigned* __restrict__ floors,
                          float* __restrict__ nbr_s, long long* __restrict__ nbr_idx) {
    extern __shared__ float rows[];          // [W][chunk_n]: each warp's chunk scores
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int tile = blockIdx.x;
    const int chunk = blockIdx.y;
    const int chunks = gridDim.y;
    const int b = blockIdx.z;
    const int a = tile * warps + warp;
    const int c0 = chunk * chunk_n;
    const int n = min(chunk_n, N - c0);
    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const float* mb = kMasked ? mask + static_cast<long long>(b) * N : nullptr;
    float* row = rows + warp * chunk_n;

    const long long ab = static_cast<long long>(b) * A + a;
    float sel_v = -INFINITY;
    int sel_i = saccot::kNone;
    if (a < A) {
        const long long aid = anchors[ab];
        const float am = anchor_mask ? anchor_mask[ab] : 1.0f;
        const float pax = Pb[aid * 3], pay = Pb[aid * 3 + 1], paz = Pb[aid * 3 + 2];
        const float qax = Qb[aid * 3], qay = Qb[aid * 3 + 1], qaz = Qb[aid * 3 + 2];
        // Read before the chunk's scores, so its latency hides behind them.
        const unsigned floor_k = floors ? __ldcg(floors + ab) : 0u;
        saccot::Best2 best;
        for (int t = lane; t < n; t += 32) {
            const long long j = c0 + t;
            const float dp = saccot::dist3(pax, pay, paz, Pb[j * 3], Pb[j * 3 + 1], Pb[j * 3 + 2]);
            const float dq = saccot::dist3(qax, qay, qaz, Qb[j * 3], Qb[j * 3 + 1], Qb[j * 3 + 2]);
            float s = saccot::compat_score(dp, dq, tau, inv_tau, min_sep);
            if (j == aid) s = 0.0f;
            if (kMasked) s = s * mb[j];
            s = s * am;
            row[t] = s;
            best.offer(s, c0 + t);
        }
        const float floor_v = floor_k ? saccot::ordered_value(floor_k) : -INFINITY;
        const int kept = saccot::warp_top_b(
            best, B, floor_v, [&](int i) { row[i - c0] = saccot::spent(); },
            [&](float, int, saccot::Best2& bb) {
                for (int t = lane; t < n; t += 32) bb.offer(row[t], c0 + t);
            }, sel_v, sel_i);
        if (floors && kept == B && lane == B - 1) {
            atomicMax(floors + ab, saccot::ordered_key(sel_v));
        }
        if (lane < B) {
            if (chunks == 1) {
                nbr_s[ab * B + lane] = sel_v;
                nbr_idx[ab * B + lane] = sel_i;
            } else {
                const long long o = (ab * chunks + chunk) * B + lane;
                part_s[o] = sel_v;
                part_i[o] = sel_i;
            }
        }
    }
    if (chunks == 1) return;

    // This block's lists are written; the last block of the anchor tile to
    // take its ticket merges every chunk's.
    // No static shared memory: a block of 48 KB of rows still launches.
    __threadfence();
    __syncthreads();
    int* ticket = tickets + static_cast<long long>(b) * gridDim.x + tile;
    if (!__syncthreads_or(threadIdx.x == 0 && atomicAdd(ticket, 1) == chunks - 1)) return;
    if (threadIdx.x == 0) *ticket = 0;
    __threadfence();
    if (a >= A) return;

    // The merge: lane l holds entries l, l+32, ... of the anchor's chunks x B
    // (distinct columns, or (-inf, kNone) tails).
    const int m = chunks * B;
    const float* ms = part_s + ab * m;
    const int* mi = part_i + ab * m;
    saccot::Best2 best;
    for (int e = lane; e < m; e += 32) best.offer(__ldcg(ms + e), __ldcg(mi + e));
    saccot::warp_top_b(
        best, B, -INFINITY, [](int) {},
        [&](float v, int i, saccot::Best2& bb) {
            for (int e = lane; e < m; e += 32) {
                const float s = __ldcg(ms + e);
                const int j = __ldcg(mi + e);
                if (saccot::key_before(v, i, s, j)) bb.offer(s, j);
            }
        }, sel_v, sel_i);
    if (floors && lane == 0) atomicExch(floors + ab, 0u);
    if (lane < B) {
        nbr_s[ab * B + lane] = sel_v;
        nbr_idx[ab * B + lane] = sel_i;
    }
}

}  // namespace

// `warps` anchors a block (1..8), chunks of `chunk_n` columns; dynamic shared
// memory is 4 * warps * chunk_n bytes, at most 48 KB. With more than one
// chunk, part_s / part_i hold [batch, A, chunks, B], tickets [batch,
// ceil(A / warps)] zeroed ints and floors, if not null, [batch, A] zeroed
// ints (all zero again when the launch ends).
extern "C" int saccot_anchor_topb_stream(const void* P, const void* Q, const void* anchors,
                                         const void* mask, const void* anchor_mask,
                                         void* nbr_s, void* nbr_idx, void* part_s, void* part_i,
                                         void* tickets, void* floors, int batch, int N, int A,
                                         int B, int warps, int chunk_n, float tau,
                                         float inv_tau, float min_sep, void* stream) {
    const int chunks = chunk_n > 0 ? (N + chunk_n - 1) / chunk_n : 0;
    const size_t smem = sizeof(float) * static_cast<size_t>(chunk_n) * warps;
    if (warps < 1 || warps > kMaxWarps || B < 1 || B > kMaxB || chunks < 1 || chunks > 65535
        || smem > 48 * 1024
        || (chunks > 1 && (part_s == nullptr || part_i == nullptr || tickets == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((A + warps - 1) / warps, chunks, batch);
    auto* kernel = mask ? anchor_topb_stream_kernel<true> : anchor_topb_stream_kernel<false>;
    kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const long long*>(anchors), static_cast<const float*>(mask),
        static_cast<const float*>(anchor_mask), N, A, B, chunk_n, tau, inv_tau, min_sep,
        static_cast<float*>(part_s), static_cast<int*>(part_i), static_cast<int*>(tickets),
        static_cast<unsigned*>(floors), static_cast<float*>(nbr_s),
        static_cast<long long*>(nbr_idx));
    return static_cast<int>(cudaGetLastError());
}
