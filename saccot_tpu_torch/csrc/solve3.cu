// Batched 3-point rigid solves: triples -> (r9, t3), one thread per hypothesis.
//
// Replaces saccot_tpu/kernels/solve3.py::_solve_kernel (and, at any N, its
// streamed form _solve_stream_kernel) and fuses what the TPU left to XLA (the
// Horn quaternion iteration and the rotation/translation assembly,
// saccot_tpu/kernels/solve3.py:254-268). Per hypothesis the thread
//   1. loads the 3 + 3 points by index (the TPU kernel gathered them with a
//      one-hot matmul over split-bf16 coordinates; a direct load is exact),
//   2. forms the centroids and the 9-entry cross-covariance H,
//   3. runs the shift-and-square power iteration of
//      saccot_tpu/engine/svd3.py::quaternion_from_cross_covariance in its
//      order: 8 squarings with renormalisation, the branchless column select,
//      2 polish steps, and the 1e-12 / 1e-30 guards,
//   4. writes the row-major rotation entries r9[b, :, k] and t = qbar - R pbar.
//
// Every floating-point operation is explicitly rounded (common.cuh helpers,
// IEEE sqrt and division), so nothing contracts to FMA and the result is the
// plain PyTorch version's (saccot_tpu_torch/kernels/solve3.py) bit for bit;
// near-degenerate triples, whose column select is sensitive to the last bit,
// then pick the same column in both.
//
// Bound: about 1,350 FP32 operations per hypothesis from registers; loads
// are 3 indices and the 6 scattered points they name, stores 12 floats.
// Where the hypotheses fill the card (the bench point: 1.3e5 of them) the
// instruction rate bounds it. Where they do not (the kitti point: 2 x 2,048
// hypotheses, a warp or two an SM) the time is one thread's chain of
// dependent steps: the index load, the point loads it names, eight
// squarings, each ending in a root and a division, two polish steps.
//
// Design: one thread per hypothesis, grid (ceil(K / threads), batch), with
// `threads` a block from kernels/solve3.py solve_plan: 128 where such blocks
// cover the SMs, 64 where they would leave SMs idle, so few hypotheses
// spread over more SMs. A form with four lanes a hypothesis (each lane one
// row of every square, the entries exchanged by warp shuffles) was measured
// and lost at the kitti point (PERF.md lists the readings).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

using saccot::add_rn;
using saccot::dot4_rn;
using saccot::mul_rn;
using saccot::sub_rn;

struct Sym4 {  // upper triangle of a symmetric 4x4: 00 01 02 03 11 12 13 22 23 33
    float a[10];
};

__device__ __forceinline__ float fro2(const Sym4& m) {
    const float* a = m.a;
    const float d = add_rn(add_rn(add_rn(mul_rn(a[0], a[0]), mul_rn(a[4], a[4])),
                                  mul_rn(a[7], a[7])), mul_rn(a[9], a[9]));
    float o = mul_rn(a[1], a[1]);
    o = add_rn(o, mul_rn(a[2], a[2]));
    o = add_rn(o, mul_rn(a[3], a[3]));
    o = add_rn(o, mul_rn(a[5], a[5]));
    o = add_rn(o, mul_rn(a[6], a[6]));
    o = add_rn(o, mul_rn(a[8], a[8]));
    return add_rn(d, mul_rn(2.0f, o));
}

__device__ __forceinline__ Sym4 square_sym(const Sym4& m) {
    const float a00 = m.a[0], a01 = m.a[1], a02 = m.a[2], a03 = m.a[3], a11 = m.a[4];
    const float a12 = m.a[5], a13 = m.a[6], a22 = m.a[7], a23 = m.a[8], a33 = m.a[9];
    Sym4 c;
    c.a[0] = dot4_rn(a00, a00, a01, a01, a02, a02, a03, a03);
    c.a[1] = dot4_rn(a00, a01, a01, a11, a02, a12, a03, a13);
    c.a[2] = dot4_rn(a00, a02, a01, a12, a02, a22, a03, a23);
    c.a[3] = dot4_rn(a00, a03, a01, a13, a02, a23, a03, a33);
    c.a[4] = dot4_rn(a01, a01, a11, a11, a12, a12, a13, a13);
    c.a[5] = dot4_rn(a01, a02, a11, a12, a12, a22, a13, a23);
    c.a[6] = dot4_rn(a01, a03, a11, a13, a12, a23, a13, a33);
    c.a[7] = dot4_rn(a02, a02, a12, a12, a22, a22, a23, a23);
    c.a[8] = dot4_rn(a02, a03, a12, a13, a22, a23, a23, a33);
    c.a[9] = dot4_rn(a03, a03, a13, a13, a23, a23, a33, a33);
    return c;
}

// Horn quaternion (qw, qx, qy, qz) of the cross-covariance h[3*i + j] = H[i][j].
__device__ void quaternion_from_cross_covariance(const float h[9], float q[4]) {
    const float Sxx = h[0], Sxy = h[1], Sxz = h[2];
    const float Syx = h[3], Syy = h[4], Syz = h[5];
    const float Szx = h[6], Szy = h[7], Szz = h[8];
    Sym4 n;
    n.a[0] = add_rn(add_rn(Sxx, Syy), Szz);
    n.a[1] = sub_rn(Syz, Szy);
    n.a[2] = sub_rn(Szx, Sxz);
    n.a[3] = sub_rn(Sxy, Syx);
    n.a[4] = sub_rn(sub_rn(Sxx, Syy), Szz);
    n.a[5] = add_rn(Sxy, Syx);
    n.a[6] = add_rn(Szx, Sxz);
    n.a[7] = sub_rn(sub_rn(Syy, Sxx), Szz);
    n.a[8] = add_rn(Syz, Szy);
    n.a[9] = sub_rn(sub_rn(Szz, Sxx), Syy);

    const float inv_fro = 1.0f / add_rn(__fsqrt_rn(fro2(n)), 1e-12f);
    Sym4 B;
#pragma unroll
    for (int e = 0; e < 10; ++e) B.a[e] = mul_rn(n.a[e], inv_fro);
    B.a[0] = add_rn(B.a[0], 1.05f);
    B.a[4] = add_rn(B.a[4], 1.05f);
    B.a[7] = add_rn(B.a[7], 1.05f);
    B.a[9] = add_rn(B.a[9], 1.05f);

    Sym4 A = B;
#pragma unroll
    for (int it = 0; it < 8; ++it) {  // A^256, renormalised against overflow
        A = square_sym(A);
        const float inv = 1.0f / add_rn(__fsqrt_rn(fro2(A)), 1e-30f);
#pragma unroll
        for (int e = 0; e < 10; ++e) A.a[e] = mul_rn(A.a[e], inv);
    }

    const float a00 = A.a[0], a01 = A.a[1], a02 = A.a[2], a03 = A.a[3], a11 = A.a[4];
    const float a12 = A.a[5], a13 = A.a[6], a22 = A.a[7], a23 = A.a[8], a33 = A.a[9];
    const float cn[4] = {
        dot4_rn(a00, a00, a01, a01, a02, a02, a03, a03),
        dot4_rn(a01, a01, a11, a11, a12, a12, a13, a13),
        dot4_rn(a02, a02, a12, a12, a22, a22, a23, a23),
        dot4_rn(a03, a03, a13, a13, a23, a23, a33, a33),
    };
    const float cols[4][4] = {
        {a00, a01, a02, a03},
        {a01, a11, a12, a13},
        {a02, a12, a22, a23},
        {a03, a13, a23, a33},
    };
    // Branchless column select: the first column of largest norm.
    float best = cn[0];
    float v[4] = {cols[0][0], cols[0][1], cols[0][2], cols[0][3]};
#pragma unroll
    for (int c = 1; c < 4; ++c) {
        const bool take = cn[c] > best;
        best = take ? cn[c] : best;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = take ? cols[c][e] : v[e];
    }

    const float b00 = B.a[0], b01 = B.a[1], b02 = B.a[2], b03 = B.a[3], b11 = B.a[4];
    const float b12 = B.a[5], b13 = B.a[6], b22 = B.a[7], b23 = B.a[8], b33 = B.a[9];
    for (int it = 0; it < 2; ++it) {  // polish with the shifted original
        const float w0 = dot4_rn(b00, v[0], b01, v[1], b02, v[2], b03, v[3]);
        const float w1 = dot4_rn(b01, v[0], b11, v[1], b12, v[2], b13, v[3]);
        const float w2 = dot4_rn(b02, v[0], b12, v[1], b22, v[2], b23, v[3]);
        const float w3 = dot4_rn(b03, v[0], b13, v[1], b23, v[2], b33, v[3]);
        const float inv = 1.0f / add_rn(__fsqrt_rn(dot4_rn(w0, w0, w1, w1, w2, w2, w3, w3)),
                                        1e-30f);
        v[0] = mul_rn(w0, inv);
        v[1] = mul_rn(w1, inv);
        v[2] = mul_rn(w2, inv);
        v[3] = mul_rn(w3, inv);
    }
    for (int e = 0; e < 4; ++e) q[e] = v[e];
}

__device__ __forceinline__ float one_minus_2(float x, float y) {  // 1 - 2 * (x + y)
    return sub_rn(1.0f, mul_rn(2.0f, add_rn(x, y)));
}

__global__ void __launch_bounds__(kMaxThreads)
solve3_kernel(const float* __restrict__ P, const float* __restrict__ Q,
              const long long* __restrict__ triples, float* __restrict__ r9,
              float* __restrict__ t3, int N, int K) {
    const int b = blockIdx.y;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const float* Pb = P + static_cast<long long>(b) * N * 3;
    const float* Qb = Q + static_cast<long long>(b) * N * 3;
    const long long* tri = triples + (static_cast<long long>(b) * K + k) * 3;

    float p[3][3], q[3][3];
    for (int s = 0; s < 3; ++s) {
        const long long idx = tri[s];
        for (int c = 0; c < 3; ++c) {
            p[s][c] = Pb[idx * 3 + c];
            q[s][c] = Qb[idx * 3 + c];
        }
    }
    const float third = 1.0f / 3.0f;
    float pbar[3], qbar[3];
    for (int c = 0; c < 3; ++c) {
        pbar[c] = mul_rn(add_rn(add_rn(p[0][c], p[1][c]), p[2][c]), third);
        qbar[c] = mul_rn(add_rn(add_rn(q[0][c], q[1][c]), q[2][c]), third);
    }
    float pc[3][3], qc[3][3];
    for (int s = 0; s < 3; ++s) {
        for (int c = 0; c < 3; ++c) {
            pc[s][c] = sub_rn(p[s][c], pbar[c]);
            qc[s][c] = sub_rn(q[s][c], qbar[c]);
        }
    }
    float h[9];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            h[3 * i + j] = add_rn(add_rn(mul_rn(pc[0][i], qc[0][j]), mul_rn(pc[1][i], qc[1][j])),
                                  mul_rn(pc[2][i], qc[2][j]));
        }
    }
    float qv[4];
    quaternion_from_cross_covariance(h, qv);
    const float qw = qv[0], qx = qv[1], qy = qv[2], qz = qv[3];
    float r[9];
    r[0] = one_minus_2(mul_rn(qy, qy), mul_rn(qz, qz));
    r[1] = mul_rn(2.0f, sub_rn(mul_rn(qx, qy), mul_rn(qw, qz)));
    r[2] = mul_rn(2.0f, add_rn(mul_rn(qx, qz), mul_rn(qw, qy)));
    r[3] = mul_rn(2.0f, add_rn(mul_rn(qx, qy), mul_rn(qw, qz)));
    r[4] = one_minus_2(mul_rn(qx, qx), mul_rn(qz, qz));
    r[5] = mul_rn(2.0f, sub_rn(mul_rn(qy, qz), mul_rn(qw, qx)));
    r[6] = mul_rn(2.0f, sub_rn(mul_rn(qx, qz), mul_rn(qw, qy)));
    r[7] = mul_rn(2.0f, add_rn(mul_rn(qy, qz), mul_rn(qw, qx)));
    r[8] = one_minus_2(mul_rn(qx, qx), mul_rn(qy, qy));

    const long long base9 = static_cast<long long>(b) * 9 * K + k;
    for (int e = 0; e < 9; ++e) r9[base9 + static_cast<long long>(e) * K] = r[e];
    const long long base3 = static_cast<long long>(b) * 3 * K + k;
    for (int c = 0; c < 3; ++c) {
        const float rp = add_rn(add_rn(mul_rn(r[3 * c], pbar[0]), mul_rn(r[3 * c + 1], pbar[1])),
                                mul_rn(r[3 * c + 2], pbar[2]));
        t3[base3 + static_cast<long long>(c) * K] = sub_rn(qbar[c], rp);
    }
}

}  // namespace

// `threads` a block: a multiple of 32, at most 256.
extern "C" int saccot_solve3(const void* P, const void* Q, const void* triples, void* r9,
                             void* t3, int batch, int N, int K, int threads, void* stream) {
    if (threads < 32 || threads > kMaxThreads || threads % 32) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((K + threads - 1) / threads, batch);
    solve3_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(P), static_cast<const float*>(Q),
        static_cast<const long long*>(triples), static_cast<float*>(r9),
        static_cast<float*>(t3), N, K);
    return static_cast<int>(cudaGetLastError());
}
