// One ring step of the correspondence-sharded compatibility degrees:
// deg[b, i] += sum_j s(row i, column j) * m_i * m_j over one column block.
//
// Replaces saccot_tpu/kernels/ring_compat.py::_ring_degree_kernel (the TPU's
// fused ring program). On the TPU one Pallas program walks the whole ring,
// passing column blocks to the next chip with remote DMAs and semaphores.
// Here the walk is in Python (saccot_tpu_torch/dist/ring.py): each ring
// step launches this compute kernel on the block the rank holds, and
// torch.distributed point-to-point transfers carry the blocks between
// steps on their own stream, posted before the launch so that they overlap it.
//
// Layout: both blocks are the TPU's packed, coordinate-major [batch, 8,
// n_pad] f32 (rows 0-2 source xyz, 3-5 target xyz, 6 mask, 7 pad), so each
// ring hop is one contiguous message and a column segment loads coalesced.
// Columns past n_loc are padding (mask 0) and are not visited; rows past
// n_loc are never written.
//
// Bound: FP32 instruction issue. Every pair costs PAIR_OPS (40)
// instructions, two correctly rounded roots among them: n_loc^2 * batch
// pairs per step (1.25e9 at the kitti shape with two ranks); the bytes are
// O(n_loc) per step. What holds it back is the roots' latency
// (degree_loops.cuh).
//
// Design: the two-sided loop of degree_loops.cuh on packed blocks
// (PackedView) with the compatibility score, the masks and the i != j test
// on global ids (row_base + i against col_base + j, as the TPU kernel does),
// adding each row sum to deg once (AddSums). It has no loop of its own. Its
// grid comes from kernels/compat.py degree_plan: at the kitti step (2 x
// 25,000 rows) 98 row tiles of 2 rows a thread a pair, each block taking one
// of the 98 column segments (19,208 blocks). Each row is summed over
// 256-column segments in column order, then segment by segment, whatever
// the plan, so a step at d = 1 on a zeroed deg gives compat_degrees.cu's
// degrees bit for bit. Every row has one owner, so the in-place add needs no
// atomic.
#include "degree_loops.cuh"

// splits > 1 needs part of [batch, ceil(n_loc / 256), n_loc] floats and
// tickets of batch * row tiles zeroed ints (launch_two_sided).
extern "C" int saccot_ring_degrees(const void* blk_rows, const void* blk_cols, void* deg,
                                   int batch, int n_loc, int n_pad, long long row_base,
                                   long long col_base, float tau, float inv_tau, float min_sep,
                                   int rows_per_thread, int splits, void* part, void* tickets,
                                   void* stream) {
    const PackedView rows{static_cast<const float*>(blk_rows), n_pad};
    const PackedView cols{static_cast<const float*>(blk_cols), n_pad};
    return launch_two_sided<true>(rows, cols, batch, n_loc, n_loc, row_base, col_base,
                                  rows_per_thread, splits, static_cast<float*>(part),
                                  static_cast<int*>(tickets),
                                  saccot::CompatScore{tau, inv_tau, min_sep},
                                  AddSums{static_cast<float*>(deg), n_loc},
                                  static_cast<cudaStream_t>(stream));
}
