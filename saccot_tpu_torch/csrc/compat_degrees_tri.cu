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
// Design, deterministic (the top-A anchor choice is decided by degree order,
// so run-to-run bit noise would change the pool; no float atomics):
//   pass 1: one block of 128 threads per tile pair (ti <= tj) of 128 x 128
//     nodes, enumerated over the upper triangle only (tiles below the
//     diagonal are never launched). Thread t owns row ti*128 + t; the column
//     tile sits in shared memory. Off the diagonal every pair of the tile
//     counts once: its weight goes to the row sum (a register, in column
//     order) and, through a per-warp butterfly transpose-reduce in registers
//     and a fixed-order sum over the four warps, to the column sum. The
//     diagonal tile sums each row over every j != i of the tile (both
//     orders of its pairs) and writes no column sums. So every entry of the
//     scratch part[b, t, n] = sum over j in tile t of s(n, j) m_n m_j is
//     written exactly once, by one block.
//   pass 2: deg[b, n] = sum over t of part[b, t, n], in tile order.
#include "common.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kThreads = kTile;   // one row per thread
constexpr int kWarps = kThreads / 32;

// Tile pair (ti, tj), ti <= tj, of block k: k = tj (tj + 1) / 2 + ti.
__device__ __forceinline__ void tile_pair(long long k, int& ti, int& tj) {
    long long j = static_cast<long long>((sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
    while (j * (j + 1) / 2 > k) --j;
    while ((j + 1) * (j + 2) / 2 <= k) ++j;
    tj = static_cast<int>(j);
    ti = static_cast<int>(k - j * (j + 1) / 2);
}

// One step of the warp's butterfly transpose-reduce over v[0 .. 2 OFF): the
// lane keeps the half of its columns selected by its bit OFF, summed with its
// partner's copy of them, in v[0 .. OFF). After steps 16, 8, 4, 2, 1 lane l
// holds column l summed over the 32 lanes, always in the same order. The
// template keeps every index constant, so v stays in registers.
template <int OFF>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int q = 0; q < OFF; ++q) {
        const float send = upper ? v[q] : v[q + OFF];
        const float keep = upper ? v[q + OFF] : v[q];
        v[q] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
}

__global__ void __launch_bounds__(kThreads)
compat_degrees_tri_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                          const float* __restrict__ mask, float* __restrict__ part, int N,
                          int n_tiles, float tau, float inv_tau, float min_sep) {
    __shared__ float4 cp[kTile];   // column tile: P coordinates, mask in .w
    __shared__ float4 cq[kTile];   // column tile: Q coordinates
    __shared__ float colsum[kWarps][kTile];

    int ti, tj;
    tile_pair(blockIdx.x, ti, tj);
    const bool diag = ti == tj;
    const int b = blockIdx.y;
    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const float* mb = mask ? mask + static_cast<long long>(b) * N : nullptr;

    const int r = ti * kTile + threadIdx.x;
    const bool row_ok = r < N;
    const long long ro = static_cast<long long>(row_ok ? r : 0) * 3;
    const float px = Pb[ro], py = Pb[ro + 1], pz = Pb[ro + 2];
    const float qx = Qb[ro], qy = Qb[ro + 1], qz = Qb[ro + 2];
    const float mr = mb ? mb[row_ok ? r : 0] : 1.0f;
    {
        const int c = tj * kTile + threadIdx.x;
        const long long co = static_cast<long long>(c < N ? c : 0) * 3;
        const float mc = mb ? mb[c < N ? c : 0] : 1.0f;
        cp[threadIdx.x] = make_float4(Pb[co], Pb[co + 1], Pb[co + 2], mc);
        cq[threadIdx.x] = make_float4(Qb[co], Qb[co + 1], Qb[co + 2], 0.0f);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float acc = 0.0f;
#pragma unroll 1
    for (int g = 0; g < kTile / 32; ++g) {
        float v[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) {
            const int t = g * 32 + q;
            const int c = tj * kTile + t;
            const float4 a = cp[t];
            const float4 d = cq[t];
            const float dp = saccot::dist3(px, py, pz, a.x, a.y, a.z);
            const float dq = saccot::dist3(qx, qy, qz, d.x, d.y, d.z);
            float s = saccot::compat_score(dp, dq, tau, inv_tau, min_sep);
            if (!row_ok || c >= N || c == r) s = 0.0f;
            v[q] = s * (mr * a.w);
            acc += v[q];
        }
        if (!diag) {
            // Lane l ends with column g*32 + l summed over the warp's rows.
            butterfly_step<16>(v, lane);
            butterfly_step<8>(v, lane);
            butterfly_step<4>(v, lane);
            butterfly_step<2>(v, lane);
            butterfly_step<1>(v, lane);
            colsum[warp][g * 32 + lane] = v[0];
        }
    }

    float* pb = part + static_cast<long long>(b) * n_tiles * N;
    if (!diag) {
        __syncthreads();
        const int c = tj * kTile + threadIdx.x;
        if (c < N) {
            float cs = colsum[0][threadIdx.x];
            for (int w = 1; w < kWarps; ++w) cs += colsum[w][threadIdx.x];
            pb[static_cast<long long>(ti) * N + c] = cs;
        }
    }
    if (row_ok) pb[static_cast<long long>(tj) * N + r] = acc;
}

__global__ void degree_sum_kernel(const float* __restrict__ part, float* __restrict__ deg,
                                  int N, int n_tiles) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const long long b = blockIdx.y;
    const float* p = part + b * n_tiles * N + n;
    float acc = 0.0f;
    for (int t = 0; t < n_tiles; ++t) acc += p[static_cast<long long>(t) * N];
    deg[b * N + n] = acc;
}

}  // namespace

// part is scratch of batch * n_tiles * N floats, n_tiles = ceil(N / 128).
extern "C" int saccot_compat_degrees_tri(const void* P, const void* Q, const void* mask,
                                         void* part, void* deg, int batch, int N,
                                         int n_tiles, float tau, float inv_tau,
                                         float min_sep, void* stream) {
    if (n_tiles != (N + kTile - 1) / kTile) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
    compat_degrees_tri_kernel<<<dim3(static_cast<unsigned>(pairs), batch), kThreads, 0, s>>>(
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const float*>(mask), static_cast<float*>(part), N, n_tiles, tau, inv_tau,
        min_sep);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    degree_sum_kernel<<<dim3((N + 255) / 256, batch), 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(deg), N, n_tiles);
    return static_cast<int>(cudaGetLastError());
}
