// Weighted compatibility degrees: deg[b, i] = sum_j s(i, j) * m_i * m_j.
//
// Replaces saccot_tpu/kernels/compat.py::_degree_kernel_mxu (the TPU's
// two-sided degree kernel). The TPU version rides its matrix unit with
// split-bf16 Gram dots and pads with 1e15 sentinels; neither exists here:
// distances come from direct FP32 coordinate differences and the ragged edge
// is masked by index.
//
// Bound: FP32 and SFU work. Every pair costs two square roots and ~16 FP32
// operations, about 1.3e8 pairs per batch at the bench point (128 pairs of
// N = 1000); memory traffic is O(N) per batch.
//
// Design: grid (row tiles, batch), one row per thread. A block owns whole
// rows, so the TPU's grid-carried accumulator becomes a register sum and no
// atomics are needed. Column tiles of P, Q and the column mask are staged in
// shared memory as SoA and swept by every thread of the block. The explicit
// i != j test uses global row ids (row_offset + i), so a caller holding a
// slice of rows gets the slice of the full result.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kColTile = 256;

__global__ void __launch_bounds__(kRowsPerBlock)
compat_degrees_kernel(const float* __restrict__ P_rows, const float* __restrict__ Q_rows,
                      const float* __restrict__ P_cols, const float* __restrict__ Q_cols,
                      const float* __restrict__ mask_rows, const float* __restrict__ mask_cols,
                      float* __restrict__ deg, int R, int C, long long row_offset,
                      float tau, float inv_tau, float min_sep) {
    __shared__ float cpx[kColTile], cpy[kColTile], cpz[kColTile];
    __shared__ float cqx[kColTile], cqy[kColTile], cqz[kColTile];
    __shared__ float cm[kColTile];

    const int b = blockIdx.y;
    const int i = blockIdx.x * kRowsPerBlock + threadIdx.x;
    const bool row_ok = i < R;
    const long long rbase = (static_cast<long long>(b) * R + (row_ok ? i : 0)) * 3;
    const float px = P_rows[rbase], py = P_rows[rbase + 1], pz = P_rows[rbase + 2];
    const float qx = Q_rows[rbase], qy = Q_rows[rbase + 1], qz = Q_rows[rbase + 2];
    const float mi = mask_rows ? mask_rows[static_cast<long long>(b) * R + (row_ok ? i : 0)] : 1.0f;
    const long long gid = row_offset + i;

    const float* pc = P_cols + static_cast<long long>(b) * C * 3;
    const float* qc = Q_cols + static_cast<long long>(b) * C * 3;
    const float* mc = mask_cols ? mask_cols + static_cast<long long>(b) * C : nullptr;

    float acc = 0.0f;
    for (int c0 = 0; c0 < C; c0 += kColTile) {
        const int n = min(kColTile, C - c0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const long long o = static_cast<long long>(c0 + t) * 3;
            cpx[t] = pc[o]; cpy[t] = pc[o + 1]; cpz[t] = pc[o + 2];
            cqx[t] = qc[o]; cqy[t] = qc[o + 1]; cqz[t] = qc[o + 2];
            cm[t] = mc ? mc[c0 + t] : 1.0f;
        }
        __syncthreads();
        for (int t = 0; t < n; ++t) {
            const float dp = saccot::dist3(px, py, pz, cpx[t], cpy[t], cpz[t]);
            const float dq = saccot::dist3(qx, qy, qz, cqx[t], cqy[t], cqz[t]);
            float s = saccot::compat_score(dp, dq, tau, inv_tau, min_sep);
            if (gid == c0 + t) s = 0.0f;
            acc += s * (mi * cm[t]);
        }
        __syncthreads();
    }
    if (row_ok) deg[static_cast<long long>(b) * R + i] = acc;
}

}  // namespace

extern "C" int saccot_compat_degrees(const void* P_rows, const void* Q_rows,
                                     const void* P_cols, const void* Q_cols,
                                     const void* mask_rows, const void* mask_cols,
                                     void* deg, int batch, int R, int C,
                                     long long row_offset, float tau, float inv_tau,
                                     float min_sep, void* stream) {
    const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, batch);
    compat_degrees_kernel<<<grid, kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(P_rows), static_cast<const float*>(Q_rows),
        static_cast<const float*>(P_cols), static_cast<const float*>(Q_cols),
        static_cast<const float*>(mask_rows), static_cast<const float*>(mask_cols),
        static_cast<float*>(deg), R, C, row_offset, tau, inv_tau, min_sep);
    return static_cast<int>(cudaGetLastError());
}
