// Shared device helpers for the SAC-COT kernels.
//
// The compatibility predicate lives here once and is used by every kernel
// that scores a pair (the degree, anchor top-B and candidate kernels):
//
//   s(i, j) = (|dp - dq| < tau  &&  min(dp, dq) > min_sep) ? 1 - |dp - dq| * (1/tau) : 0
//
// with dp, dq the intra-cloud distances of the pair. The caller applies the
// i != j test and the masks. Distances are formed from direct FP32 coordinate
// differences with explicitly rounded operations (__fmul_rn / __fadd_rn never
// contract to FMA), in the same order as the plain PyTorch versions
// (saccot_tpu_torch/engine/compat.py), so the kernels and the plain versions
// produce bit-identical pair scores.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace saccot {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// ((a0*b0 + a1*b1) + a2*b2) + a3*b3, left to right, no contraction.
__device__ __forceinline__ float dot4_rn(float a0, float b0, float a1, float b1,
                                         float a2, float b2, float a3, float b3) {
    return add_rn(add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2)),
                  mul_rn(a3, b3));
}

// Euclidean distance between two points, ((dx*dx + dy*dy) + dz*dz) then an
// IEEE square root.
__device__ __forceinline__ float dist3(float ax, float ay, float az,
                                       float bx, float by, float bz) {
    const float dx = sub_rn(ax, bx);
    const float dy = sub_rn(ay, by);
    const float dz = sub_rn(az, bz);
    return __fsqrt_rn(add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz)));
}

// The one compatibility predicate of the estimator (see the file comment).
__device__ __forceinline__ float compat_score(float dp, float dq, float tau,
                                              float inv_tau, float min_sep) {
    const float delta = fabsf(sub_rn(dp, dq));
    const bool ok = (delta < tau) && (fminf(dp, dq) > min_sep);
    return ok ? sub_rn(1.0f, mul_rn(delta, inv_tau)) : 0.0f;
}

// Selection key of the top-k sweeps: larger value first, and among equal
// values the smaller index, which is lax.top_k's (and a stable descending
// sort's) order. Returns true when (v, i) precedes (bv, bi).
__device__ __forceinline__ bool key_before(float v, int i, float bv, int bi) {
    return (v > bv) || (v == bv && i < bi);
}

// An unsigned key that orders as the float does, for values that are not
// NaN: -0 is first made +0 (x + 0 gives +0 for -0 and x otherwise), since
// key_before treats the two as equal.
__device__ __forceinline__ unsigned ordered_key(float v) {
    const unsigned u = __float_as_uint(v + 0.0f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ordered_value(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Warp-wide arg-max under key_before, with two warp reductions (REDUX): the
// largest value, then the smallest index among the lanes that hold it. Every
// lane gets the warp's best back. No shared memory and no barrier; all 32
// lanes must call it. Values must not be NaN (as for key_before).
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
    const unsigned full = 0xffffffffu;
    const unsigned k = ordered_key(v);
    const unsigned best = __reduce_max_sync(full, k);
    i = static_cast<int>(__reduce_min_sync(full, k == best ? static_cast<unsigned>(i)
                                                           : 0xffffffffu));
    v = ordered_value(best);
}

// The column of an empty slot: every entry with a column precedes
// (-inf, kNone) under key_before.
constexpr int kNone = 0x7fffffff;

// A knocked-out score: key_before never prefers a NaN, so Best2 never takes
// it back.
__device__ __forceinline__ float spent() { return __int_as_float(0x7fffffff); }

// The best two remaining (score, column) entries of a lane's share under
// key_before; an empty slot holds (-inf, kNone).
struct Best2 {
    float v1 = -INFINITY, v2 = -INFINITY;
    int i1 = kNone, i2 = kNone;
    __device__ __forceinline__ void offer(float v, int i) {
        if (key_before(v, i, v2, i2)) {   // rare once the share is under way
            if (key_before(v, i, v1, i1)) {
                v2 = v1; i2 = i1; v1 = v; i1 = i;
            } else {
                v2 = v; i2 = i;
            }
        }
    }
    // Drop the best entry: the second one moves up.
    __device__ __forceinline__ void pop() {
        v1 = v2; i1 = i2;
        v2 = -INFINITY; i2 = kNone;
    }
};

// The one selection loop of the anchor kernels (anchor_topb.cu, and both
// phases of anchor_topb_stream.cu): the top B (B <= 32) of the entries the
// 32 lanes of a warp hold between them, each entry held by one lane, no two
// with the same column. `best` is the lane's Best2 over its share. Rounds of
// warp_argmax; lane r (r < B) returns the winner of round r, so the lanes
// hold lax.top_k's order, and (-inf, kNone) where the warp held fewer than B
// entries. The rounds end early at the first winner below `floor_v` (-inf:
// never), leaving the later lanes' (sel_v, sel_i) as they were; returns the
// rounds kept. Only the lane that holds a round's winner (v, i) gives it up:
// it calls `knock(i)`, moves up its second entry, and when both are spent
// calls `rescan(v, i, best)`, which offers `best` the rest of its share. A
// lane gives up its entries in its own key order, so the rest are the
// entries (v, i) precedes: a share held in shared memory knocks its entries
// out (spent()) and offers all of them again; one that is read only (the
// merge's lists in device memory) knocks nothing and offers those (v, i)
// precedes. All 32 lanes must call it; no block barrier.
template <class Knock, class Rescan>
__device__ __forceinline__ int warp_top_b(Best2 best, int B, float floor_v, const Knock& knock,
                                          const Rescan& rescan, float& sel_v, int& sel_i) {
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < B; ++r) {
        float v = best.v1;
        int i = best.i1;
        warp_argmax(v, i);
        if (v < floor_v) return r;
        if (lane == r) { sel_v = v; sel_i = i; }
        if (r + 1 < B && i != kNone && i == best.i1) {
            knock(i);
            best.pop();
            if (best.i1 == kNone) rescan(v, i, best);
        }
    }
    return B;
}

// The scope the candidate helpers below run at: one warp, one anchor (the
// fused anchor kernel, anchor_topb.cu, and the streamed path's candidate
// kernel, candidate_topt.cu).
struct WarpScope {
    __device__ __forceinline__ int rank() const { return threadIdx.x & 31; }
    __device__ __forceinline__ int size() const { return 32; }
    __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// Candidate triangles of one anchor from its B selected neighbours, shared by
// the fused anchor kernel (anchor_topb.cu) and the streamed path's candidate
// kernel (candidate_topt.cu), so both score and rank candidates bit for bit
// alike. Inputs live in shared memory: sel_s[B] the neighbour scores (a score
// <= 0 marks an invalid selection), sp / sq[3 * B] the neighbours' coordinates
// (x, y, z per neighbour).
// Fills grid_s[B * B]: entry b1 * B + b2 holds (s_b1 + s_b2) + s_b1b2 when
// b1 < b2 and all three edges are positive, -1 otherwise. The lanes fill the
// grid with -1, then score only the B (B - 1) / 2 pairs b1 < b2, walking
// them in np.triu_indices(B, k=1) order, 32 apart (row b1 holds B - 1 - b1
// pairs); with `triu` set each pair's entry also goes to its index in that
// order. Every lane of the warp must call it; it ends with the warp's
// barrier.
__device__ __forceinline__ void candidate_grid(const WarpScope& scope, const float* sel_s,
                                               const float* sp, const float* sq, int B,
                                               float tau, float inv_tau, float min_sep,
                                               float* grid_s, float* triu) {
    for (int pid = scope.rank(); pid < B * B; pid += scope.size()) grid_s[pid] = -1.0f;
    scope.sync();
    int b1 = 0;
    int off = scope.rank();   // this lane's pair w, as row b1 and offset within it
    for (int w = scope.rank(); w < B * (B - 1) / 2; w += scope.size()) {
        while (off >= B - 1 - b1) {
            off -= B - 1 - b1;
            ++b1;
        }
        const int b2 = b1 + 1 + off;
        const float* p1 = sp + 3 * b1;
        const float* p2 = sp + 3 * b2;
        const float* q1 = sq + 3 * b1;
        const float* q2 = sq + 3 * b2;
        const float dp = dist3(p1[0], p1[1], p1[2], p2[0], p2[1], p2[2]);
        const float dq = dist3(q1[0], q1[1], q1[2], q2[0], q2[1], q2[2]);
        const float sjk = compat_score(dp, dq, tau, inv_tau, min_sep);
        const bool valid = sel_s[b1] > 0.0f && sel_s[b2] > 0.0f && sjk > 0.0f;
        const float v = valid ? add_rn(add_rn(sel_s[b1], sel_s[b2]), sjk) : -1.0f;
        grid_s[b1 * B + b2] = v;
        if (triu) triu[w] = v;
        off += scope.size();
    }
    scope.sync();
}

// top_t rounds over the candidate grid in the order of lax.top_k over the
// flattened grid (score desc, pair id asc), on the one selection loop
// (warp_top_b): lane l's share is the grid's entries l, l + 32, ..., each
// winner is knocked out (spent()), at most 32 rounds a pass. Writes
// max(score, -1) and the node ids sel_i[b1], sel_i[b2] of each winner's two
// neighbours. Every lane of the warp must call it.
__device__ __forceinline__ void grid_top_t(const WarpScope& scope, float* grid_s,
                                           const int* sel_i, int B, int top_t, float* cand_row,
                                           long long* j_row, long long* k_row) {
    const int lane = scope.rank();
    const auto offer_share = [&](Best2& best) {
        for (int pid = lane; pid < B * B; pid += 32) best.offer(grid_s[pid], pid);
    };
    for (int t0 = 0; t0 < top_t; t0 += 32) {
        const int rounds = min(32, top_t - t0);
        Best2 best;
        offer_share(best);
        float v = -INFINITY;
        int slot = kNone;
        warp_top_b(best, rounds, -INFINITY, [&](int i) { grid_s[i] = spent(); },
                   [&](float, int, Best2& bb) { offer_share(bb); }, v, slot);
        if (lane < rounds) {
            // top_t < B * B entries, so every round wins a real entry.
            const int b1 = slot / B;
            cand_row[t0 + lane] = fmaxf(v, -1.0f);
            j_row[t0 + lane] = sel_i[b1];
            k_row[t0 + lane] = sel_i[slot - b1 * B];
            // warp_top_b leaves a pass's last winner in the grid.
            if (lane == rounds - 1) grid_s[slot] = spent();
        }
        scope.sync();
    }
}

}  // namespace saccot
