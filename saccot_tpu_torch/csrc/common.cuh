// Shared device helpers for the SAC-COT kernels.
//
// The compatibility predicate lives here once and is used by the degree
// kernel (compat_degrees.cu) and the anchor top-B kernel (anchor_topb.cu):
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

// Block-wide arg-max under key_before. Every thread passes its local best;
// every thread gets the block's best back. `red_v` / `red_i` hold one slot
// per warp. blockDim.x must be a multiple of 32.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
    const unsigned full = 0xffffffffu;
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(full, v, off);
        const int oi = __shfl_down_sync(full, i, off);
        if (key_before(ov, oi, v, i)) { v = ov; i = oi; }
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
    __syncthreads();
    if (threadIdx.x == 0) {
        const int nwarps = blockDim.x >> 5;
        float bv = red_v[0];
        int bi = red_i[0];
        for (int w = 1; w < nwarps; ++w) {
            if (key_before(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
        }
        red_v[0] = bv;
        red_i[0] = bi;
    }
    __syncthreads();
    v = red_v[0];
    i = red_i[0];
    __syncthreads();  // red_* may be rewritten by the next call
}

}  // namespace saccot
