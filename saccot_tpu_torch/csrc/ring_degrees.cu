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
// ring hop is one contiguous message and a column tile loads coalesced.
// Columns past n_loc are padding (mask 0) and are not visited; rows past
// n_loc are never written.
//
// Bound: FP32 and SFU work. Every pair costs two IEEE square roots and the
// shared predicate, n_loc^2 * batch pairs per step (1.25e9 at the kitti
// shape with two ranks); the bytes are O(n_loc) per step.
//
// Design: grid (row tiles, batch), one row per thread, as compat_degrees.cu.
// A block owns whole rows, so the row sum stays in a register (no atomics)
// and is added to deg once: every row has exactly one owner, so the in-place
// read-modify-write is safe. Column tiles are staged in shared memory from
// the coordinate-major block. The explicit i != j test compares global ids
// (row_base + i against col_base + j), as the TPU kernel does.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kColTile = 256;
constexpr int kPackedRows = 8;

__global__ void __launch_bounds__(kRowsPerBlock)
ring_degrees_kernel(const float* __restrict__ blk_rows, const float* __restrict__ blk_cols,
                    float* __restrict__ deg, int n_loc, int n_pad, long long row_base,
                    long long col_base, float tau, float inv_tau, float min_sep) {
    __shared__ float cpx[kColTile], cpy[kColTile], cpz[kColTile];
    __shared__ float cqx[kColTile], cqy[kColTile], cqz[kColTile];
    __shared__ float cm[kColTile];

    const int b = blockIdx.y;
    const int i = blockIdx.x * kRowsPerBlock + threadIdx.x;
    const bool row_ok = i < n_loc;
    const int ii = row_ok ? i : 0;
    const long long stride = n_pad;
    const float* rb = blk_rows + static_cast<long long>(b) * kPackedRows * stride;
    const float* cb = blk_cols + static_cast<long long>(b) * kPackedRows * stride;
    const float px = rb[ii], py = rb[stride + ii], pz = rb[2 * stride + ii];
    const float qx = rb[3 * stride + ii], qy = rb[4 * stride + ii], qz = rb[5 * stride + ii];
    const float mi = rb[6 * stride + ii];
    const long long gid = row_base + i;

    float acc = 0.0f;
    for (int c0 = 0; c0 < n_loc; c0 += kColTile) {
        const int n = min(kColTile, n_loc - c0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const long long j = c0 + t;
            cpx[t] = cb[j];
            cpy[t] = cb[stride + j];
            cpz[t] = cb[2 * stride + j];
            cqx[t] = cb[3 * stride + j];
            cqy[t] = cb[4 * stride + j];
            cqz[t] = cb[5 * stride + j];
            cm[t] = cb[6 * stride + j];
        }
        __syncthreads();
        for (int t = 0; t < n; ++t) {
            const float dp = saccot::dist3(px, py, pz, cpx[t], cpy[t], cpz[t]);
            const float dq = saccot::dist3(qx, qy, qz, cqx[t], cqy[t], cqz[t]);
            float s = saccot::compat_score(dp, dq, tau, inv_tau, min_sep);
            if (gid == col_base + c0 + t) s = 0.0f;
            acc += s * (mi * cm[t]);
        }
        __syncthreads();
    }
    if (row_ok) {
        float* d = deg + static_cast<long long>(b) * n_loc + i;
        *d = saccot::add_rn(*d, acc);
    }
}

}  // namespace

extern "C" int saccot_ring_degrees(const void* blk_rows, const void* blk_cols, void* deg,
                                   int batch, int n_loc, int n_pad, long long row_base,
                                   long long col_base, float tau, float inv_tau, float min_sep,
                                   void* stream) {
    const dim3 grid((n_loc + kRowsPerBlock - 1) / kRowsPerBlock, batch);
    ring_degrees_kernel<<<grid, kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(blk_rows), static_cast<const float*>(blk_cols),
        static_cast<float*>(deg), n_loc, n_pad, row_base, col_base, tau, inv_tau, min_sep);
    return static_cast<int>(cudaGetLastError());
}
