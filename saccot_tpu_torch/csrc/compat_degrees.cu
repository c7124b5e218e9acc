// Weighted compatibility degrees: deg[b, i] = sum_j s(i, j) * m_i * m_j.
//
// Replaces saccot_tpu/kernels/compat.py::_degree_kernel_mxu (the TPU's
// two-sided degree kernel) and, through kernels/compat.degrees(mxu=False),
// ::_degree_kernel (its direct form). The TPU version rides its matrix unit
// with split-bf16 Gram dots and pads with 1e15 sentinels; neither exists
// here: distances come from direct FP32 coordinate differences and the ragged
// edge is masked by index, so the two TPU kernels are one CUDA kernel.
//
// Bound: FP32 instruction issue. Every pair costs PAIR_OPS (40)
// instructions, two correctly rounded roots among them; 1.28e8 pairs at the
// bench point (128 pairs of N = 1000), 6.7e7 at the 3DMatch SP slice (32 x
// 1,024 rows x 2,048 columns). Memory traffic is O(R + C) per batch element.
// What holds it back is the roots' latency (degree_loops.cuh).
//
// Design: the two-sided loop of degree_loops.cuh on [batch, n, 3] rows and
// columns (PointsView) with the compatibility score, the masks and the i != j
// test on row_offset + i, writing the row sums (StoreSums). Its grid comes
// from kernels/compat.py degree_plan: 1 or 2 rows a thread, one column
// segment a block where the row tiles alone would not fill the card (the
// bench point: 4,096 blocks of 128 rows x 256 columns). Each row is summed
// over 256-column segments in column order, then segment by segment,
// whatever the plan, so a row slice or a batch slice of the problem gives
// the same bits as the full call.
#include "degree_loops.cuh"

// splits > 1 needs part of [batch, ceil(C / 256), R] floats and tickets of
// batch * row tiles zeroed ints (launch_two_sided).
extern "C" int saccot_compat_degrees(const void* P_rows, const void* Q_rows,
                                     const void* P_cols, const void* Q_cols,
                                     const void* mask_rows, const void* mask_cols,
                                     void* deg, int batch, int R, int C,
                                     long long row_offset, float tau, float inv_tau,
                                     float min_sep, int rows_per_thread, int splits, void* part,
                                     void* tickets, void* stream) {
    const PointsView rows{static_cast<const float*>(P_rows), static_cast<const float*>(Q_rows),
                          static_cast<const float*>(mask_rows), R};
    const PointsView cols{static_cast<const float*>(P_cols), static_cast<const float*>(Q_cols),
                          static_cast<const float*>(mask_cols), C};
    return launch_two_sided<true>(rows, cols, batch, R, C, row_offset, 0, rows_per_thread, splits,
                                  static_cast<float*>(part), static_cast<int*>(tickets),
                                  saccot::CompatScore{tau, inv_tau, min_sep},
                                  StoreSums{static_cast<float*>(deg), R},
                                  static_cast<cudaStream_t>(stream));
}
