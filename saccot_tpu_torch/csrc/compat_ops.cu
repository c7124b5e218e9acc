// Per-operation attribution of the degree kernels: five timing variants of
// their pair loop, in both forms (two-sided and symmetric upper-triangle).
// Only the `full` mode is a degree; the other modes are NOT semantically
// degrees and exist to be timed. They live in their own file so that no
// route of `register_batch` can reach them.
//
// Replaces scripts/exp_compat_ops.py::variant_kernel (reached through
// run_variant.fn's pallas_call): the TPU script strips its split-bf16 Gram
// degree kernel down to find which instruction class binds it. The port's
// distances are direct FP32 differences, so each mode keeps the script's
// name and means, per pair (every operation rounded on its own, as in
// common.cuh):
//   gram_only     p_i.p_j + q_i.q_j (two direct dot products: the
//                 distance-input stage, comparable in value with the
//                 script's Gp + Gq)
//   d2_only       dp2 + dq2, the squared distances without the roots
//   one_sqrt      sqrt(dp2) + dq2
//   no_sqrt_tail  the predicate's tail on squared distances:
//                 (min(dp2, dq2) > min_sep^2) ? max(1 - |dp2 - dq2| / tau^2, 0) : 0
//   full          compat_score(dist3, dist3) without masks or the i != j
//                 test (a self pair fails min(dp, dq) > min_sep > 0 anyway),
//                 so it equals the production degrees bit for bit.
// The ragged edge is masked by index, never by sentinel coordinates.
//
// Bound: FP32 instruction issue, the mode's operations per pair times N^2
// pairs (two-sided) or about N^2 / 2 (tri); memory traffic is O(N).
//
// Design: both forms are the production loops of degree_loops.cuh, with the
// pair score replaced by Variant<MODE> and without the production-only steps
// (masks, i != j test), so a mode's time differs from another's only by the
// operations the mode adds, and `full` (Variant<kFull> calls the production
// CompatScore) is the production degree by construction:
//   two-sided: kThreads threads a block holding 1 or 2 rows each, the column
//     segments split across blocks, both from kernels/compat.py degree_plan
//     as for compat_degrees.cu; float4 column segments of 256 in shared
//     memory; each row summed in column order within a segment, then segment
//     by segment (in the launch's last block of the row tile when split);
//   tri: 128 x 128 upper-triangle tile pairs, float4 column tiles, row sums
//     in registers, column sums by the warp butterfly, per-tile partials
//     summed in tile order by a second pass.
// Every mode writes its sums, so nvcc cannot delete its loop.
#include "degree_loops.cuh"

namespace {

enum Mode : int { kGramOnly = 0, kD2Only = 1, kOneSqrt = 2, kNoSqrtTail = 3, kFull = 4 };

struct Consts {
    float tau, inv_tau, min_sep;   // the predicate's, as in the degree kernels
    float inv_tau2, min_sep2;      // 1 / tau^2 and min_sep^2 for no_sqrt_tail
};

__device__ __forceinline__ float dot3_rn(float ax, float ay, float az,
                                         float bx, float by, float bz) {
    using namespace saccot;
    return add_rn(add_rn(mul_rn(ax, bx), mul_rn(ay, by)), mul_rn(az, bz));
}

// dist3 of common.cuh without its square root.
__device__ __forceinline__ float sq_dist3(float ax, float ay, float az,
                                          float bx, float by, float bz) {
    using namespace saccot;
    const float dx = sub_rn(ax, bx);
    const float dy = sub_rn(ay, by);
    const float dz = sub_rn(az, bz);
    return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

// The value one pair adds to the sums in mode MODE.
template <int MODE>
struct Variant {
    Consts k;

    __device__ __forceinline__ float operator()(float px, float py, float pz, float qx, float qy,
                                                float qz, float cpx, float cpy, float cpz,
                                                float cqx, float cqy, float cqz) const {
        using namespace saccot;
        if constexpr (MODE == kGramOnly) {
            return add_rn(dot3_rn(px, py, pz, cpx, cpy, cpz),
                          dot3_rn(qx, qy, qz, cqx, cqy, cqz));
        } else if constexpr (MODE == kFull) {
            return CompatScore{k.tau, k.inv_tau, k.min_sep}(px, py, pz, qx, qy, qz, cpx, cpy,
                                                            cpz, cqx, cqy, cqz);
        } else {
            const float dp2 = sq_dist3(px, py, pz, cpx, cpy, cpz);
            const float dq2 = sq_dist3(qx, qy, qz, cqx, cqy, cqz);
            if constexpr (MODE == kD2Only) {
                return add_rn(dp2, dq2);
            } else if constexpr (MODE == kOneSqrt) {
                return add_rn(__fsqrt_rn(dp2), dq2);
            } else {
                const float delta = fabsf(sub_rn(dp2, dq2));
                const float s = fmaxf(sub_rn(1.0f, mul_rn(delta, k.inv_tau2)), 0.0f);
                return fminf(dp2, dq2) > k.min_sep2 ? s : 0.0f;
            }
        }
    }
};

template <int MODE>
int launch(const float* P, const float* Q, float* part, int* tickets, float* deg, int batch,
           int N, int n_tiles, bool tri, int rows_per_thread, int splits, const Consts& k,
           cudaStream_t s) {
    const Variant<MODE> value{k};
    if (tri) return launch_tri<false>(P, Q, nullptr, part, deg, batch, N, n_tiles, value, s);
    const PointsView pts{P, Q, nullptr, N};
    return launch_two_sided<false>(pts, pts, batch, N, N, 0, 0, rows_per_thread, splits, part,
                                   tickets, value, StoreSums{deg, N}, s);
}

}  // namespace

// mode: 0 gram_only, 1 d2_only, 2 one_sqrt, 3 no_sqrt_tail, 4 full.
// tri != 0 takes the upper-triangle form; part is then scratch of
// batch * n_tiles * N floats, n_tiles = ceil(N / 128). The two-sided form
// takes rows_per_thread and splits of degree_plan; with splits > 1, part of
// [batch, ceil(N / 256), N] floats and tickets of batch * row tiles zeroed
// ints (launch_two_sided).
extern "C" int saccot_compat_ops(const void* P, const void* Q, void* part, void* deg,
                                 int batch, int N, int n_tiles, int mode, int tri, float tau,
                                 float inv_tau, float min_sep, float inv_tau2, float min_sep2,
                                 int rows_per_thread, int splits, void* tickets, void* stream) {
    using Launch = int (*)(const float*, const float*, float*, int*, float*, int, int, int, bool,
                           int, int, const Consts&, cudaStream_t);
    constexpr Launch kLaunch[] = {launch<kGramOnly>, launch<kD2Only>, launch<kOneSqrt>,
                                  launch<kNoSqrtTail>, launch<kFull>};
    if (mode < kGramOnly || mode > kFull) return static_cast<int>(cudaErrorInvalidValue);
    return kLaunch[mode](static_cast<const float*>(P), static_cast<const float*>(Q),
                         static_cast<float*>(part), static_cast<int*>(tickets),
                         static_cast<float*>(deg), batch, N, n_tiles, tri != 0, rows_per_thread,
                         splits, Consts{tau, inv_tau, min_sep, inv_tau2, min_sep2},
                         static_cast<cudaStream_t>(stream));
}
