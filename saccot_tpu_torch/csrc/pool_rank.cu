// The exact pool's ranking: cross-anchor dedup, canonical triples and the
// global top-K of the candidate triangles, one block a pair.
//
// Replaces no TPU kernel: the JAX package ranks the exact pool in XLA
// (saccot_tpu/engine/triangles.py: `_mark_cross_anchor_duplicates`, the
// min/max network, the top-K). Its plain version,
// kernels/triangles.pool_rank_reference, is some 45 torch operations: the
// dedup mask as a [batch, A, B, B, B] compare over a gathered [batch, A, B,
// B] int64 copy of the neighbour rows, six min/max passes for the canonical
// (lo, mid, hi) triples and a stable segmented sort of all A * B(B-1)/2
// candidates of a pair (1.7 G compares and a sort of 50 M keys a call at the
// 3DMatch point), where this kernel writes only the K entries it keeps.
//
// Bound: bytes. A pair's candidate scores (4 A P bytes, P = B(B-1)/2), its
// neighbour scores and ids (12 A B), its anchors (8 A) are read once, and K
// triples, scores and flags (29 K bytes) written; the work between is
// integer compares, no FP32 arithmetic.
//
// Design: one block of kThreads threads a pair (grid = batch); every phase
// works in the block's dynamic shared memory (`Layout`):
//   1. the anchors and the neighbour ids as int32 (node ids lie below 2^31;
//      rows at an odd stride, so lanes reading rows of different anchors hit
//      different banks), and for each anchor a word of its valid selections
//      (nbr_s > 0);
//   2. dedup (with `dedup`): the anchors sorted by id with their slots (a
//      rank count). Then each selection (a, b) on its own thread: slot(j)
//      of its node j by a binary search over the sorted anchors (no N-wide
//      map), and where that is a smaller slot x, whether x's valid row
//      holds anchors[a]. Then one warp an anchor a, its held selections one
//      a half-warp (B <= 16): lane t compares row a's id t with row x's
//      valid ids, read four at a time by all its lanes, and the ballot is
//      the word of (a, b): candidate (a, b1, b2) is a duplicate iff bit b2
//      of (a, b1)'s word or bit b1 of (a, b2)'s word is set, which is
//      `mark_cross_anchor_duplicates`' rule. A duplicate's score is -1;
//   3. each candidate's key, the unsigned of its score that orders as the
//      float (common.cuh `ordered_key`), held in shared memory where the
//      plan made room for all A P of them (`kResident`; 120 KB at the
//      3DMatch and 3DLoMatch points: the scores are first copied in with
//      every copy in flight at once, cp.async) and else made again from the
//      scores, read through L2, on each pass (kitti's 61,440 candidates).
//      Each pass walks a warp's range kUnroll x 32 candidates at a time, all
//      loads first, so a lane has kUnroll loads in flight;
//   4. an exact radix select of the K-th largest key, 8 bits a pass (a
//      256-bin histogram of shared-memory atomics; the key pass counts the
//      top byte), then the candidates above it, and of those equal to it
//      the first ones in index order, gathered as (key, ~index) 64-bit
//      words;
//   5. a bitonic sort of those words, descending: score first, then the
//      lower flat index a P + p, which is a stable descending sort's order
//      (stages 32 or more entries apart through shared memory, the others
//      in registers by warp shuffles);
//   6. the K entries written: (lo, mid, hi) of (anchor, j, k) with dedup,
//      (anchor, j, k) without; the score (-1 for a duplicate); valid =
//      score > 0; (0, 0, 0) / -1 past the A P candidates.
// The count of duplicates a pair goes to dups[pair] where dups is given.
// Measured on an H100 at the threedmatch.sweep call (1,623 pairs; PERF.md
// section 6): 1.00 ms by CUDA events, of which step 1 took 0.10, the anchor
// sort 0.05, the slots and holds 0.09, the held rows 0.14, the keys with the
// top byte 0.15, the other radix passes 0.12, the gathering 0.08, the sort
// 0.21 and step 6 0.06. No __match_any_sync: its cost grows with the count
// of distinct values among the lanes, and it lost to the plain loop of step
// 2 (by 0.49 ms there) and to plain atomics in the histograms.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 32;
constexpr int kBins = 256;
constexpr int kUnroll = 4;
// Scalars of the block, then one word a warp (the equal keys of its range).
constexpr int kDigit = 0, kAbove = 1, kAt = 2, kTaken = 3, kDupCount = 4, kScalars = 8;

__host__ __device__ __forceinline__ size_t align8(size_t x) { return (x + 7) & ~size_t(7); }
__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// The block's dynamic shared memory, in bytes from its start
// (kernels/triangles.pool_rank_smem repeats the sum).
struct Layout {
    size_t sel, raw, anc, slot, vmask, gate, ids, pair, hist, words, vids, keys, total;
};

// Row strides of the int32 neighbour ids: odd, so rows of different anchors
// start in different banks; and of their valid ids (-1 where invalid), a
// multiple of 4, read four at a time.
__host__ __device__ __forceinline__ int id_stride(int B) { return B | 1; }
__host__ __device__ __forceinline__ int valid_stride(int B) { return (B + 3) & ~3; }

__host__ __device__ __forceinline__ Layout layout(int A, int B, int k_pow2, bool resident) {
    const size_t a = static_cast<size_t>(A), n_pairs = static_cast<size_t>(B) * (B - 1) / 2;
    Layout L;
    size_t o = 0;
    L.sel = o;   o += 8 * static_cast<size_t>(k_pow2);      // (key, ~index) words
    L.raw = o;   o += align8(4 * a);                        // anchors as given
    L.anc = o;   o += align8(4 * a);                        // anchors sorted by id
    L.slot = o;  o += align8(4 * a);                        // their slots
    L.vmask = o; o += align8(4 * a);                        // valid selections a row
    L.gate = o;  o += align8(4 * a * B);                    // duplicate bits a selection
    L.ids = o;   o += align8(4 * a * id_stride(B));         // neighbour ids
    L.pair = o;  o += align8(2 * n_pairs);                  // (b1, b2) of each pair slot
    L.hist = o;  o += 4 * kBins;
    L.words = o; o += 4 * (kScalars + kWarps);
    L.vids = o = align16(o);                                // valid ids, read as int4
    o += 4 * a * valid_stride(B);
    L.keys = o = align16(o);                                // 16-byte copies land here
    o += resident ? 4 * a * n_pairs : 0;
    L.total = o;
    return L;
}

// Calls use(load(i, a, p), i, in) for the flat candidate indices i =
// a n_pairs + p of the calling warp's range, in index order, 32 at a time:
// each lane first loads its next kUnroll values, then uses them. Every lane
// calls `use` the same number of times (`in` false past the range, `load`
// not called there), so `use` may take warp votes. The ranges of warps 0,
// 1, ... follow each other.
template <typename Load, typename Use>
__device__ __forceinline__ void warp_walk(int M, int n_pairs, Load&& load, Use&& use) {
    using V = decltype(load(0, 0, 0));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int step = 32 * kUnroll;
    const int span = (M + kWarps * step - 1) / (kWarps * step) * step;
    const int lo = min(M, warp * span), hi = min(M, lo + span);
    if (lo >= hi) return;
    int i = lo + lane, a = i / n_pairs, p = i - a * n_pairs;
    const int step_a = 32 / n_pairs, step_p = 32 - step_a * n_pairs;
    for (int i0 = lo; i0 < hi; i0 += step) {
        V v[kUnroll];
        int at[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            at[q] = i;
            v[q] = i < hi ? load(i, a, p) : V(0);
            i += 32;
            a += step_a;
            p += step_p;
            if (p >= n_pairs) {
                p -= n_pairs;
                ++a;
            }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) use(v[q], at[q], at[q] < hi);
    }
}

// One asynchronous copy of 16 or 4 bytes from global to shared memory, and
// the wait for all of a thread's copies.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                 "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src));
}
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                 "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src));
}
__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warp 0: the digit of the radix pass, the largest d such that fewer than
// `need` keys lie in the bins above d and at least `need` in d and above;
// writes d, the count above it and the count in it.
__device__ __forceinline__ void pick_digit(const unsigned* hist, unsigned need, unsigned* words) {
    const int lane = threadIdx.x & 31;
    unsigned c[8], s = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        c[q] = hist[kBins - 1 - 8 * lane - q];
        s += c[q];
    }
    unsigned incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
    }
    unsigned acc = incl - s;
    if (acc < need && need <= incl) {
        bool found = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            if (found) continue;
            if (acc + c[q] >= need) {
                found = true;
                words[kDigit] = kBins - 1 - 8 * lane - q;
                words[kAbove] = acc;
                words[kAt] = c[q];
            } else {
                acc += c[q];
            }
        }
    }
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1) pool_rank_kernel(
        const long long* __restrict__ anchors, const float* __restrict__ nbr_s,
        const long long* __restrict__ nbr_idx, const float* __restrict__ cand, int A, int B,
        int K, int k_pow2, int dedup, long long* __restrict__ triples,
        float* __restrict__ scores, bool* __restrict__ valid, long long* __restrict__ dups) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L = layout(A, B, k_pow2, kResident);
    unsigned long long* sel = reinterpret_cast<unsigned long long*>(smem + L.sel);
    int* raw = reinterpret_cast<int*>(smem + L.raw);
    int* anc = reinterpret_cast<int*>(smem + L.anc);
    int* slot = reinterpret_cast<int*>(smem + L.slot);
    unsigned* vmask = reinterpret_cast<unsigned*>(smem + L.vmask);
    unsigned* gate = reinterpret_cast<unsigned*>(smem + L.gate);
    int* ids = reinterpret_cast<int*>(smem + L.ids);
    int* vids = reinterpret_cast<int*>(smem + L.vids);
    unsigned short* pair = reinterpret_cast<unsigned short*>(smem + L.pair);
    unsigned* hist = reinterpret_cast<unsigned*>(smem + L.hist);
    unsigned* words = reinterpret_cast<unsigned*>(smem + L.words);
    unsigned* keys = reinterpret_cast<unsigned*>(smem + L.keys);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int n_pairs = B * (B - 1) / 2, rs = id_stride(B), vs = valid_stride(B);
    const int M = A * n_pairs;
    const int Kp = min(K, M);                 // entries ranked; the rest is padding
    const long long pb = blockIdx.x;
    anchors += pb * A;
    nbr_s += pb * A * B;
    nbr_idx += pb * A * B;
    cand += pb * M;

    // -- 1. anchors, neighbour ids, valid selections, the pair table -------
    for (int e = tid; e < A * B; e += kThreads) {
        const int a = e / B;
        ids[a * rs + e - a * B] = static_cast<int>(nbr_idx[e]);
    }
    for (int e = tid; dedup && e < A * vs; e += kThreads) {
        const int a = e / vs, u = e - a * vs, f = a * B + u;
        vids[e] = u < B && nbr_s[f] > 0.0f ? static_cast<int>(nbr_idx[f]) : -1;
    }
    for (int i = tid; i < A; i += kThreads) {
        raw[i] = static_cast<int>(anchors[i]);
        unsigned m = 0;
        for (int t = 0; t < B; ++t) m |= static_cast<unsigned>(nbr_s[i * B + t] > 0.0f) << t;
        vmask[i] = m;
    }
    for (int p = tid; p < n_pairs; p += kThreads) {
        int b1 = 0, first = 0;
        while (p >= first + B - 1 - b1) first += B - 1 - b1++;
        pair[p] = static_cast<unsigned short>((b1 << 8) | (b1 + 1 + p - first));
    }
    if (tid < kScalars) words[tid] = 0;
    for (int q = tid; q < kBins; q += kThreads) hist[q] = 0;
    __syncthreads();

    // -- 2. dedup words ------------------------------------------------------
    if (dedup) {
        for (int i = tid; i < A; i += kThreads) {
            const int v = raw[i];
            int r = 0;
            for (int j = 0; j < A; ++j) {
                const int w = raw[j];
                r += (w < v) || (w == v && j < i);
            }
            anc[r] = v;
            slot[r] = i;
        }
        __syncthreads();
        // Each selection (a, b) on its own: gate[a B + b] = x + 1 where its
        // node is the anchor of a smaller slot x whose valid row holds
        // anchors[a], else 0.
        for (int e = tid; e < A * B; e += kThreads) {
            const int a = e / B, b = e - a * B;
            int held = 0;
            if ((vmask[a] >> b) & 1u) {
                const int j = ids[a * rs + b];
                int lo = 0, hi = A;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (anc[mid] < j) lo = mid + 1; else hi = mid;
                }
                const int x = lo < A && anc[lo] == j ? slot[lo] : A;
                if (x < a) {
                    const unsigned vx = vmask[x];
                    const int anchor = raw[a];
                    bool holds = false;
                    for (int u = 0; u < B; ++u) {
                        holds |= ((vx >> u) & 1u) && ids[x * rs + u] == anchor;
                    }
                    held = holds ? x + 1 : 0;
                }
            }
            gate[e] = held;
        }
        __syncthreads();
        // One warp an anchor a, its held selections one a sub-warp of hw
        // lanes (two at once where B <= 16): lane t of a sub-warp compares
        // row a's id t with row x's valid ids, four at a time, all its lanes
        // reading the same ones; the sub-warp's ballot is the word of (a, b).
        const int hw = B <= 16 ? 16 : 32, sub = lane / hw, t = lane % hw;
        const unsigned low = hw == 16 ? 0xffffu : 0xffffffffu;
        for (int a = warp; a < A; a += kWarps) {
            const int mine = t < B ? ids[a * rs + t] : -2;   // -2 matches no valid id
            const int xl = lane < B ? static_cast<int>(gate[a * B + lane]) - 1 : -1;
            unsigned todo = __ballot_sync(0xffffffffu, xl >= 0);
            unsigned word = 0;
            while (todo) {
                const int b0 = __ffs(todo) - 1;
                todo &= todo - 1;
                const int b1 = hw == 16 && todo ? __ffs(todo) - 1 : -1;
                if (b1 >= 0) todo &= todo - 1;
                const int b = sub == 0 ? b0 : b1;
                const int xb = __shfl_sync(0xffffffffu, xl, b < 0 ? 0 : b);
                bool found = false;
                if (b >= 0) {
                    const int* row = vids + xb * vs;
                    for (int u = 0; u < B; u += 4) {
                        const int4 v = *reinterpret_cast<const int4*>(row + u);
                        found |= (v.x == mine) | (v.y == mine) | (v.z == mine) | (v.w == mine);
                    }
                }
                const unsigned bits = __ballot_sync(0xffffffffu, found);
                if (lane == b0) word = bits & low;
                if (lane == b1) word = bits >> 16;
            }
            if (lane < B) gate[a * B + lane] = word;
        }
        __syncthreads();
    }

    // -- 3. keys and the duplicate count -------------------------------------
    auto is_dup = [&](int a, int p) -> bool {
        const unsigned pr = pair[p], b1 = pr >> 8, b2 = pr & 0xffu;
        const unsigned* g = gate + a * B;
        return dedup && (((g[b1] >> b2) | (g[b2] >> b1)) & 1u);
    };
    auto key_at = [&](int i, int a, int p) -> unsigned {
        if (kResident) return keys[i];
        return saccot::ordered_key(is_dup(a, p) ? -1.0f : __ldg(cand + i));
    };
    // The pass that makes the keys (or, with them not resident, counts the
    // duplicates) also counts the top byte of each key, the first radix pass.
    const bool keyed = M > 0 && (kResident || dups != nullptr);
    const bool top_counted = keyed && Kp < M;
    if (kResident && M > 0) {
        // Every score of the pair in flight at once, into the key array.
        float* staged = reinterpret_cast<float*>(keys);
        if ((M & 3) == 0 && (reinterpret_cast<size_t>(cand) & 15) == 0) {
            for (int c = tid; c < M / 4; c += kThreads) copy_async16(staged + 4 * c, cand + 4 * c);
        } else {
            for (int i = tid; i < M; i += kThreads) copy_async4(staged + i, cand + i);
        }
        copy_async_wait();
        __syncthreads();
    }
    if (keyed) {
        unsigned n_dup = 0;
        // The key, and the duplicate flag above it.
        auto load = [&](int i, int a, int p) -> unsigned long long {
            const bool d = is_dup(a, p);
            const float c = kResident ? reinterpret_cast<const float*>(keys)[i] : __ldg(cand + i);
            return (static_cast<unsigned long long>(d) << 32) | saccot::ordered_key(d ? -1.0f : c);
        };
        warp_walk(M, n_pairs, load, [&](unsigned long long v, int i, bool in) {
            const unsigned k = static_cast<unsigned>(v);
            if (in) {
                n_dup += static_cast<unsigned>(v >> 32);
                if (kResident) keys[i] = k;
            }
            if (top_counted && in) atomicAdd(&hist[k >> 24], 1u);
        });
        n_dup = __reduce_add_sync(0xffffffffu, n_dup);
        if (lane == 0 && n_dup) atomicAdd(&words[kDupCount], n_dup);
        __syncthreads();
    }
    if (dups != nullptr && tid == 0) dups[pb] = words[kDupCount];

    // -- 4. the K-th key, then the entries kept -------------------------------
    unsigned T = 0, need = static_cast<unsigned>(Kp);
    bool ties = false;          // keys equal to T beyond those kept
    if (Kp < M) {
        unsigned prefix = 0, pmask = 0;
        for (int shift = 24; shift >= 0; shift -= 8) {
            if (shift < 24 || !top_counted) {
                for (int q = tid; q < kBins; q += kThreads) hist[q] = 0;
                __syncthreads();
                warp_walk(M, n_pairs, key_at, [&](unsigned k, int, bool in) {
                    if (in && (k & pmask) == prefix) atomicAdd(&hist[(k >> shift) & 0xffu], 1u);
                });
            }
            __syncthreads();
            if (warp == 0) pick_digit(hist, need, words);
            __syncthreads();
            prefix |= words[kDigit] << shift;
            pmask |= 0xffu << shift;
            need -= words[kAbove];
            ties = words[kAt] > need;
            __syncthreads();
        }
        T = prefix;
    }
    unsigned eq_before = 0;     // keys equal to T in the ranges of the warps before
    if (ties) {
        unsigned n_eq = 0;
        warp_walk(M, n_pairs, key_at, [&](unsigned k, int, bool in) {
            n_eq += __popc(__ballot_sync(0xffffffffu, in && k == T));
        });
        if (lane == 0) words[kScalars + warp] = n_eq;
        __syncthreads();
        for (int w = 0; w < warp; ++w) eq_before += words[kScalars + w];
    }
    warp_walk(M, n_pairs, key_at, [&](unsigned k, int i, bool in) {
        const bool eq = in && k == T;
        bool take = in && k > T;
        if (ties) {
            const unsigned eqs = __ballot_sync(0xffffffffu, eq);
            take |= eq && eq_before + __popc(eqs & below) < need;
            eq_before += __popc(eqs);
        } else {
            take |= eq;
        }
        const unsigned takes = __ballot_sync(0xffffffffu, take);
        if (!takes) return;
        unsigned base = 0;
        if (lane == 0) base = atomicAdd(&words[kTaken], __popc(takes));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (take) {
            sel[base + __popc(takes & below)] =
                (static_cast<unsigned long long>(k) << 32)
                | (0xffffffffu - static_cast<unsigned>(i));
        }
    });
    for (int r = Kp + tid; r < k_pow2; r += kThreads) sel[r] = 0;   // sorts last
    __syncthreads();

    // -- 5. bitonic sort, descending ------------------------------------------
    // Stages that pair entries 32 or more apart go through shared memory,
    // one barrier each; the last five of each merge pair lanes of one warp
    // and run in registers.
    for (int k = 2; k <= k_pow2; k <<= 1) {
        int j = k >> 1;
        for (; j >= 32; j >>= 1) {
            for (int q = tid; q < k_pow2 / 2; q += kThreads) {
                const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
                const unsigned long long x = sel[i], y = sel[i | j];
                if ((i & k) == 0 ? x < y : x > y) {
                    sel[i] = y;
                    sel[i | j] = x;
                }
            }
            __syncthreads();
        }
        for (int c = 0; c < k_pow2; c += kThreads) {
            const int i = c + tid;
            unsigned long long x = i < k_pow2 ? sel[i] : 0ull;
            for (int jj = j; jj > 0; jj >>= 1) {
                const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, jj);
                // The lower entry of a descending run keeps the larger word.
                x = (((i & jj) != 0) != ((i & k) == 0)) ? max(x, y) : min(x, y);
            }
            if (i < k_pow2) sel[i] = x;
        }
        __syncthreads();
    }

    // -- 6. the pool ------------------------------------------------------------
    triples += pb * K * 3;
    scores += pb * K;
    valid += pb * K;
    for (int r = tid; r < K; r += kThreads) {
        long long t0 = 0, t1 = 0, t2 = 0;
        float s = -1.0f;
        if (r < Kp) {
            const int i = static_cast<int>(0xffffffffu - static_cast<unsigned>(sel[r]));
            const int a = i / n_pairs, p = i - a * n_pairs;
            const unsigned pr = pair[p];
            const long long ia = raw[a];
            const long long j = ids[a * rs + (pr >> 8)];
            const long long k = ids[a * rs + (pr & 0xffu)];
            s = is_dup(a, p) ? -1.0f : __ldg(cand + i);
            if (dedup) {
                const long long a0 = min(ia, j), b0 = max(ia, j);
                const long long lo2 = min(b0, k);
                t0 = min(a0, lo2);
                t1 = max(a0, lo2);
                t2 = max(b0, k);
            } else {
                t0 = ia;
                t1 = j;
                t2 = k;
            }
        }
        triples[3 * r] = t0;
        triples[3 * r + 1] = t1;
        triples[3 * r + 2] = t2;
        scores[r] = s;
        valid[r] = s > 0.0f;
    }
}

}  // namespace

// anchors [batch, A] int64, nbr_s [batch, A, B] float32, nbr_idx [batch, A,
// B] int64 (node ids in [0, 2^31)), cand [batch, A, B(B-1)/2] float32 in;
// triples [batch, K, 3] int64, scores [batch, K] float32, valid [batch, K]
// bool out; dups null or [batch] int64. k_pow2 is the power of two at or
// above min(K, A B(B-1)/2) (at least 1); smem_bytes the plan's sum of
// `layout`, checked here.
extern "C" int saccot_pool_rank(const void* anchors, const void* nbr_s, const void* nbr_idx,
                                const void* cand, void* triples, void* scores, void* valid,
                                void* dups, int batch, int A, int B, int K, int k_pow2,
                                int dedup, int resident, long long smem_bytes, void* stream) {
    if (A < 1 || B < 1 || B > kMaxB || K < 1 || k_pow2 < 1 || (k_pow2 & (k_pow2 - 1))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Layout L = layout(A, B, k_pow2, resident != 0);
    if (static_cast<long long>(L.total) != smem_bytes) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto kernel = resident ? pool_rank_kernel<true> : pool_rank_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(L.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<batch, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(anchors), static_cast<const float*>(nbr_s),
        static_cast<const long long*>(nbr_idx), static_cast<const float*>(cand), A, B, K, k_pow2,
        dedup, static_cast<long long*>(triples), static_cast<float*>(scores),
        static_cast<bool*>(valid), static_cast<long long*>(dups));
    return static_cast<int>(cudaGetLastError());
}
