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
// Design: the two-sided loop of degree_loops.cuh with the compatibility score
// and the masks. A block owns whole rows, so the TPU's grid-carried
// accumulator becomes a register sum and no atomics are needed.
#include "degree_loops.cuh"

extern "C" int saccot_compat_degrees(const void* P_rows, const void* Q_rows,
                                     const void* P_cols, const void* Q_cols,
                                     const void* mask_rows, const void* mask_cols,
                                     void* deg, int batch, int R, int C,
                                     long long row_offset, float tau, float inv_tau,
                                     float min_sep, void* stream) {
    return launch_two_sided<true>(
        static_cast<const float*>(P_rows), static_cast<const float*>(Q_rows),
        static_cast<const float*>(P_cols), static_cast<const float*>(Q_cols),
        static_cast<const float*>(mask_rows), static_cast<const float*>(mask_cols),
        static_cast<float*>(deg), batch, R, C, row_offset,
        saccot::CompatScore{tau, inv_tau, min_sep}, static_cast<cudaStream_t>(stream));
}
