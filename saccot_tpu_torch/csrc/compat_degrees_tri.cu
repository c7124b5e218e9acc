// Weighted compatibility degrees of a symmetric problem (the rows are the
// columns): deg[b, i] = sum_{j != i} s(i, j) * m_i * m_j, each unordered pair
// evaluated once.
//
// Replaces saccot_tpu/kernels/compat.py::_degree_kernel_mxu_tri (the TPU's
// upper-triangle degree kernel, routed when rows and columns are the same
// arrays and R > 2048). The TPU version's split-bf16 Gram, centring and 1e15
// pad sentinels exist for its matrix unit and VMEM tiling and are dropped:
// distances come from direct FP32 differences with the shared predicate
// (common.cuh), and the ragged edge is masked by index.
//
// Bound: FP32 and square-root work, about 40 operations per pair and
// N^2 / 2 pairs per batch element (1.25e9 at the kitti point, N = 50,000):
// half of what the two-sided kernel (compat_degrees.cu) evaluates.
//
// Design: the tri loop of degree_loops.cuh with the compatibility score,
// the mask and the i != j test: upper-triangle 128 x 128 tile pairs, row sums
// in registers, column sums by a warp butterfly into a [batch, tiles, N]
// scratch, then a second pass that adds the tiles in order. Deterministic:
// the top-A anchor choice is decided by degree order, so run-to-run bit noise
// would change the pool; no float atomics. With a mask, a tile pair with no
// valid row or no valid column writes zero sums and leaves (a pair padded at
// its end skips every tile pair past its last valid tile), and counts itself
// in skipped[b] (integer atomics).
#include "degree_loops.cuh"

// part is scratch of batch * n_tiles * N floats, n_tiles = ceil(N / 128);
// skipped is null or batch zeroed uint64 counters (used only with a mask).
extern "C" int saccot_compat_degrees_tri(const void* P, const void* Q, const void* mask,
                                         void* part, void* deg, void* skipped, int batch,
                                         int N, int n_tiles, float tau, float inv_tau,
                                         float min_sep, void* stream) {
    return launch_tri<true>(static_cast<const float*>(P), static_cast<const float*>(Q),
                            static_cast<const float*>(mask), static_cast<float*>(part),
                            static_cast<float*>(deg), batch, N, n_tiles,
                            saccot::CompatScore{tau, inv_tau, min_sep},
                            static_cast<cudaStream_t>(stream),
                            static_cast<unsigned long long*>(skipped));
}
