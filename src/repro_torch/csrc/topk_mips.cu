// Top-k maximum-inner-product search for Hopper (sm_90a): two variants.
//
// Replaces: topk_mips_pallas / _mips_kernel in src/repro/kernels/topk_mips.py,
// the TPU kernel that sweeps corpus blocks in grid order and keeps one
// running [block_q, kp] top-k per query tile resident in VMEM.
//
// Contract (the reference's topk_mips_ref): for each query, the k corpus rows
// of largest fp32 inner product, sorted by score descending, ties by the
// smaller corpus index; rows at or past n_valid never surface, and slots left
// over when fewer than k rows are live come back as (-inf, -1). Every score is
// one dot product over the full D, plain fp32 FMA in ascending d: no TF32 and
// no tensor cores, so kernel and oracle are bitwise equal on dyadic data.
// NaN scores rank after every -inf score, as in a stable argsort of -scores.
//
// Both variants rank one 64-bit key per (query, row): (order-preserving score
// bits << 32 | row), so "score desc, index asc" is plain unsigned order, a
// smaller key is better, and no two rows share a key. The result is the same
// bits whatever the grid, the thread schedule or the order of atomics.
//
// What bounds it on this card: 2*Q*n*D fp32 operations outside the tensor
// cores (the corpus is read once per query tile, from L2 after the first);
// at the paper's emb_dim 8 the corpus is 19.2 MB per 600k rows, so the FMAs,
// not the bytes, set the floor. D is padded by the caller only to a multiple
// of 4 floats (one float4 load), not to the TPU's 128 lanes.
//
// "threshold" variant (the default; kernels/topk_mips.py topk_plan picks it
// whenever its buffers fit shared memory). TPU grid steps carry a running
// top-k from step to step; Hopper's blocks share nothing, and keeping a
// sorted list per block costs barriers and sorts on every round of rows. So
// the search is an exact threshold, found from one sweep over the corpus,
// and a second look at only the few rows that can pass it. Four launches:
//   1. mips_group_min: grid (16-query tiles, corpus splits), NT = 256
//      threads a block. The rows < n are cut into G = S * NT disjoint groups:
//      split s holds rows [s * rows_per_split, (s + 1) * rows_per_split), and
//      thread t of it the rows s * rows_per_split + t + i * NT. Each thread
//      scores its rows against the tile's queries and keeps per query its
//      smallest key (no buffers, ballots or barriers in the row loop):
//      gmin [Q, G].
//   2. mips_threshold: one block per query. T = the k-th smallest of the G
//      group minima (EMPTY_KEY if fewer than k groups hold a row), and the k
//      smallest minima, those of the winning groups; zeroes the query's
//      candidate count. It sorts 1,024 per-thread minima and then only the
//      few minima below their k-th, not all G keys (see the kernel).
//   3. mips_filter: one thread per row slot of a winning group. Every row
//      whose key is <= T lies in a winning group (below), so only their rows
//      are scored again, by the same score_row as step 1 (the same fmaf
//      sequence, so the same bits); a row with key <= T is appended to the
//      query's candidates at an atomicAdd on its count.
//   4. mips_select: one block per query sorts its candidates (bitonic, padded
//      with EMPTY_KEY to a power of two) and writes the first k, as mips_merge
//      does. Keys are distinct, so the output has the same bits whatever order
//      the atomics appended them in.
//
// Why it is exact, and why C = (k - 1) * max_group_rows + 1 candidates is
// enough (max_group_rows = ceil(rows_per_split / NT), the most rows a group
// holds; the host computes both from the same rows_per_split and NT):
//   (a) The k smallest group minima are keys of k distinct rows, all <= T.
//       So the k-th smallest key overall is <= T, and every row of the top k
//       passes the filter. If fewer than k groups hold a row, T = EMPTY_KEY
//       and every live row passes. The final sort sees a superset of the top k.
//   (b) A row whose key is <= T lies in a group whose minimum is <= T. Keys
//       are distinct, so exactly k groups (the winning ones) have such a
//       minimum, and the group whose minimum is T contributes that one row:
//       every other row of it has a larger key. So at most (k - 1) *
//       max_group_rows + 1 rows pass. If fewer than k groups hold a row, all
//       n live rows pass, and n <= (k - 1) * max_group_rows.
// The bound is reached: k - 1 full groups whose rows all beat every other
// row, and a k-th group whose first row is next. The host sizes the
// candidate buffer and the select's shared memory from C before the launch;
// no data can exceed it, so there is no retry and no second pass. Should the
// invariant ever break, nothing is written past C and the kernel executes
// __trap(): the launch fails, and no partial top-k is ever returned.

// "stream" variant (the first port of the TPU kernel; taken where the
// threshold variant's buffers do not fit at any split count, e.g. k = 512
// over 2M rows):
//   1. mips_partial: one block per (8-query tile, corpus split). Each thread
//      scores one corpus row against the 8 queries per round. A score enters a
//      query's candidate buffer only if it beats that query's current k-th
//      best (a filter, exact because the k-th best only improves); buffers are
//      compacted with warp ballots and per-warp prefix sums, so every position
//      is decided without atomics. A full buffer is bitonic-sorted and merged
//      into the block's sorted top-K list (K = k rounded up to a power of two).
//   2. mips_merge: one block per query sorts the splits' top-K lists and
//      writes the first k.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define TQ 8             // queries per block in mips_partial
#define NTHREADS 256     // threads per block (both kernels)
#define NWARPS (NTHREADS / 32)
#define BUFP 512         // candidate buffer per query (power of two, >= K)
#define EMPTY_KEY 0xFFFFFFFFFFFFFFFFull

// 32 bits whose ascending unsigned order is descending score.
__device__ __forceinline__ unsigned desc_bits(float s) {
    if (s != s) return 0xFF800001u;  // NaN: just after -inf
    if (s == 0.0f) s = 0.0f;         // -0.0 ties with +0.0 by index
    unsigned u = __float_as_uint(s);
    unsigned asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ~asc;
}

__device__ __forceinline__ float score_of(unsigned desc) {
    unsigned asc = ~desc;
    unsigned u = (asc & 0x80000000u) ? (asc & 0x7FFFFFFFu) : ~asc;
    return __uint_as_float(u);
}

// One output slot: (-inf, -1) for an empty key or a -inf score.
__device__ __forceinline__ void write_key(u64 key, float* val, int* ix) {
    float sc = -INFINITY;
    int i = -1;
    if (key != EMPTY_KEY) {
        sc = score_of((unsigned)(key >> 32));
        if (sc != -INFINITY) i = (int)(unsigned)(key & 0xFFFFFFFFu);
    }
    *val = sc;
    *ix = i;
}

// Sort nseg independent segments of len (a power of two) keys ascending.
__device__ void bitonic_sort(u64* s, int nseg, int len) {
    const int half = len >> 1;
    for (int size = 2; size <= len; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < nseg * half; t += blockDim.x) {
                int seg = t / half, i = t - seg * half;
                int lo = 2 * i - (i & (stride - 1));
                u64* b = s + (size_t)seg * len;
                u64 x = b[lo], y = b[lo + stride];
                bool up = (lo & size) == 0;
                if ((x > y) == up) { b[lo] = y; b[lo + stride] = x; }
            }
            __syncthreads();
        }
    }
}

// Sort nseg independent bitonic segments of len keys ascending.
__device__ void bitonic_merge(u64* s, int nseg, int len) {
    const int half = len >> 1;
    for (int stride = half; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < nseg * half; t += blockDim.x) {
            int seg = t / half, i = t - seg * half;
            int lo = 2 * i - (i & (stride - 1));
            u64* b = s + (size_t)seg * len;
            u64 x = b[lo], y = b[lo + stride];
            if (x > y) { b[lo] = y; b[lo + stride] = x; }
        }
        __syncthreads();
    }
}

// Fold every query's candidate buffer into its sorted top-K list.
__device__ void flush(u64* top, u64* buf, u64* thr, int* cnt, int k, int K) {
    for (int i = threadIdx.x; i < TQ * BUFP; i += blockDim.x)
        if (i % BUFP >= cnt[i / BUFP]) buf[i] = EMPTY_KEY;
    __syncthreads();
    bitonic_sort(buf, TQ, BUFP);
    // min(top[i], buf[K-1-i]) holds the K smallest of both lists, bitonic
    for (int i = threadIdx.x; i < TQ * K; i += blockDim.x) {
        int j = i / K, p = i - j * K;
        u64 a = top[i], b = buf[j * BUFP + K - 1 - p];
        top[i] = a < b ? a : b;
    }
    __syncthreads();
    bitonic_merge(top, TQ, K);
    if (threadIdx.x < TQ) {
        cnt[threadIdx.x] = 0;
        thr[threadIdx.x] = top[threadIdx.x * K + k - 1];
    }
    __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS)
mips_partial(const float* __restrict__ q, const float* __restrict__ c,
             u64* __restrict__ part, int Q, int n, int D, int k, int K,
             int rows_per_split) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* top = reinterpret_cast<u64*>(smem);  // [TQ][K]
    u64* buf = top + TQ * K;                  // [TQ][BUFP]
    u64* thr = buf + TQ * BUFP;               // [TQ]
    float* qs = reinterpret_cast<float*>(thr + TQ);  // [TQ][D]
    int* cnt = reinterpret_cast<int*>(qs + TQ * D);  // [TQ]
    int* wcnt = cnt + TQ;                            // [TQ][NWARPS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * TQ;
    const int split = blockIdx.y, S = gridDim.y;
    const int r0 = split * rows_per_split;
    const int r1 = min(n, r0 + rows_per_split);
    const int D4 = D >> 2;

    for (int i = tid; i < TQ * K; i += NTHREADS) top[i] = EMPTY_KEY;
    for (int i = tid; i < TQ * D; i += NTHREADS) {
        int j = i / D;
        qs[i] = (q0 + j < Q) ? q[(size_t)(q0 + j) * D + (i - j * D)] : 0.0f;
    }
    if (tid < TQ) { cnt[tid] = 0; thr[tid] = EMPTY_KEY; }
    __syncthreads();

    const float4* c4 = reinterpret_cast<const float4*>(c);
    for (int base = r0; base < r1; base += NTHREADS) {
        const int r = base + tid;
        const bool live = r < r1;
        float acc[TQ];
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[j] = 0.0f;
        if (live) {
            for (int d4 = 0; d4 < D4; ++d4) {
                float4 v = c4[(size_t)r * D4 + d4];
#pragma unroll
                for (int j = 0; j < TQ; ++j) {
                    const float* qq = qs + j * D + 4 * d4;
                    acc[j] = fmaf(qq[0], v.x, acc[j]);
                    acc[j] = fmaf(qq[1], v.y, acc[j]);
                    acc[j] = fmaf(qq[2], v.z, acc[j]);
                    acc[j] = fmaf(qq[3], v.w, acc[j]);
                }
            }
        }
        u64 key[TQ];
        unsigned mask[TQ];
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
            key[j] = ((u64)desc_bits(acc[j]) << 32) | (unsigned)r;
            bool take = live && (q0 + j < Q) && key[j] < thr[j];
            mask[j] = __ballot_sync(0xFFFFFFFFu, take);
            if (lane == 0) wcnt[j * NWARPS + warp] = __popc(mask[j]);
        }
        __syncthreads();
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
            if (mask[j] & (1u << lane)) {
                int off = cnt[j] + __popc(mask[j] & below);
                for (int w = 0; w < warp; ++w) off += wcnt[j * NWARPS + w];
                buf[j * BUFP + off] = key[j];
            }
        }
        __syncthreads();
        if (tid < TQ) {
            int total = 0;
            for (int w = 0; w < NWARPS; ++w) total += wcnt[tid * NWARPS + w];
            cnt[tid] += total;
        }
        __syncthreads();
        bool full = false;
        for (int j = 0; j < TQ; ++j) full |= cnt[j] > BUFP - NTHREADS;
        if (full) flush(top, buf, thr, cnt, k, K);
    }
    bool any = false;
    for (int j = 0; j < TQ; ++j) any |= cnt[j] > 0;
    if (any) flush(top, buf, thr, cnt, k, K);

    for (int i = tid; i < TQ * K; i += NTHREADS) {
        int j = i / K, p = i - j * K;
        if (q0 + j < Q) part[((size_t)(q0 + j) * S + split) * K + p] = top[i];
    }
}

__global__ void __launch_bounds__(NTHREADS)
mips_merge(const u64* __restrict__ part, float* __restrict__ vals,
           int* __restrict__ idx, int k, int L) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* s = reinterpret_cast<u64*>(smem);  // [L] = the splits' top-K lists
    const size_t qi = blockIdx.x;
    for (int i = threadIdx.x; i < L; i += NTHREADS) s[i] = part[qi * L + i];
    __syncthreads();
    bitonic_sort(s, 1, L);
    for (int i = threadIdx.x; i < k; i += NTHREADS) write_key(s[i], vals + qi * k + i, idx + qi * k + i);
}

static size_t partial_smem(int D, int K) {
    return (size_t)TQ * (K + BUFP + 1) * sizeof(u64) + (size_t)TQ * D * sizeof(float) +
           (size_t)TQ * (1 + NWARPS) * sizeof(int);
}

// q [Q, D], c [N, D] row-major fp32 with D % 4 == 0; part [Q, S, K] u64 scratch;
// vals [Q, k] fp32, idx [Q, k] int32. K is a power of two with k <= K <= BUFP,
// S a power of two. Returns cudaGetLastError() after both launches.
extern "C" int topk_mips_launch(const float* q, const float* c, u64* part, float* vals,
                                int* idx, int Q, int n, int D, int k, int K, int S,
                                void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows_per_split = (n + S - 1) / S;
    const size_t smem1 = partial_smem(D, K);
    cudaError_t err = cudaFuncSetAttribute(
        mips_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return (int)err;
    dim3 grid1((Q + TQ - 1) / TQ, S);
    mips_partial<<<grid1, NTHREADS, smem1, st>>>(q, c, part, Q, n, D, k, K, rows_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int L = S * K;
    const size_t smem2 = (size_t)L * sizeof(u64);
    err = cudaFuncSetAttribute(
        mips_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return (int)err;
    mips_merge<<<Q, NTHREADS, smem2, st>>>(part, vals, idx, k, L);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------- threshold variant

#define SEL_THREADS 1024    // mips_threshold and mips_select: one block per query
#define SCAN_TQ 16          // mips_group_min: queries a tile
#define SCAN_THREADS 256    // mips_group_min: threads a block, one group each
#define FILTER_THREADS 256  // mips_filter: one row of a winning group a thread

// The scores of row r against TQT queries qv, float4 [TQT][nd4] in shared
// memory: from 0, one fmaf per d in ascending d. Steps 1 and 3 both score
// through it, so a row has the same bits in both. D4C > 0 fixes nd4 at
// compile time (the paper's emb_dim 8: D4C = 2).
template <int TQT, int D4C>
__device__ __forceinline__ void score_row(const float4* qv, const float4* __restrict__ c4, int r,
                                          int nd4, float (&acc)[TQT]) {
    const int n4 = D4C > 0 ? D4C : nd4;
#pragma unroll
    for (int j = 0; j < TQT; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int d4 = 0; d4 < n4; ++d4) {
        const float4 v = __ldg(c4 + (size_t)r * n4 + d4);
#pragma unroll
        for (int j = 0; j < TQT; ++j) {
            const float4 qq = qv[j * n4 + d4];
            acc[j] = fmaf(qq.x, v.x, acc[j]);
            acc[j] = fmaf(qq.y, v.y, acc[j]);
            acc[j] = fmaf(qq.z, v.z, acc[j]);
            acc[j] = fmaf(qq.w, v.w, acc[j]);
        }
    }
}

// Step 1, grid (query tiles of SCAN_TQ, S splits), SCAN_THREADS threads.
// gmin [Q, G], G = S * SCAN_THREADS: per query, the smallest key of each
// group, EMPTY_KEY for a group without rows. Thread t's group is rows r0 + t,
// r0 + t + SCAN_THREADS, ... below r1, in ascending order; a row replaces the
// best so far only if its key is smaller: a larger score, or any number after
// a NaN; equal scores (+0 and -0 too) keep the earlier, smaller row.
template <int D4C>
__global__ void __launch_bounds__(SCAN_THREADS)
mips_group_min(const float* __restrict__ q, const float* __restrict__ c, u64* __restrict__ gmin,
               int Q, int n, int D, int rows_per_split) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem);  // [SCAN_TQ][D], zeros past Q
    const int tid = threadIdx.x, q0 = blockIdx.x * SCAN_TQ;
    const int r0 = blockIdx.y * rows_per_split;
    const int r1 = min(n, r0 + rows_per_split);
    for (int i = tid; i < SCAN_TQ * D; i += SCAN_THREADS) {
        const int j = i / D;
        qs[i] = (q0 + j < Q) ? q[(size_t)(q0 + j) * D + (i - j * D)] : 0.0f;
    }
    __syncthreads();

    float best[SCAN_TQ];
    int brow[SCAN_TQ];
    const int first = r0 + tid < r1 ? r0 + tid : -1;
#pragma unroll
    for (int j = 0; j < SCAN_TQ; ++j) {
        best[j] = __int_as_float(0x7FFFFFFF);  // NaN: any number replaces it
        brow[j] = first;
    }
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const float4* qs4 = reinterpret_cast<const float4*>(qs);
    for (int r = r0 + tid; r < r1; r += SCAN_THREADS) {
        float acc[SCAN_TQ];
        score_row<SCAN_TQ, D4C>(qs4, c4, r, D >> 2, acc);
#pragma unroll
        for (int j = 0; j < SCAN_TQ; ++j) {
            if (!(acc[j] <= best[j]) && acc[j] == acc[j]) {
                best[j] = acc[j];
                brow[j] = r;
            }
        }
    }

    const size_t G = (size_t)gridDim.y * SCAN_THREADS;
    const size_t g = (size_t)blockIdx.y * SCAN_THREADS + tid;
#pragma unroll
    for (int j = 0; j < SCAN_TQ; ++j) {
        if (q0 + j < Q)
            gmin[(size_t)(q0 + j) * G + g] =
                brow[j] < 0 ? EMPTY_KEY
                            : ((u64)desc_bits(best[j]) << 32) | (unsigned)brow[j];
    }
}

// Append x to buf at an atomicAdd on *n where take holds, one atomic per warp.
// Every lane of the warp calls it. A key that would land at or past capacity
// traps: the proven bound broke, so the launch fails and nothing is returned.
__device__ __forceinline__ void append(u64* buf, int* n, int capacity, u64 x, bool take) {
    const int lane = threadIdx.x & 31;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, take);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(n, __popc(m));
    at = __shfl_sync(0xFFFFFFFFu, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (take) {
        if (at >= capacity) __trap();
        buf[at] = x;
    }
}

// Sort buf[0, nk) ascending: pad to the next power of two with EMPTY_KEY.
__device__ void sort_padded(u64* buf, int nk) {
    int L = 1;
    while (L < nk) L <<= 1;
    for (int i = nk + threadIdx.x; i < L; i += blockDim.x) buf[i] = EMPTY_KEY;
    __syncthreads();
    bitonic_sort(buf, 1, L);
}

// Step 2, one block per query: thr[q] = T, the k-th smallest of the G group
// minima (EMPTY_KEY if fewer than k are keys), and win [q, k] = the k smallest
// minima, sorted, EMPTY_KEY past the non-empty ones; count[q] = 0. Without
// sorting G keys: thread t takes the minimum of keys t, t + 1024, ...; T2 =
// the k-th smallest of those 1024 minima; the keys <= T2 are at most (k - 1) *
// ceil(G / 1024) + 1 <= cap (the header's argument (b), threads for groups)
// and hold the k smallest (argument (a)), so sorted, their first k are win.
__global__ void __launch_bounds__(SEL_THREADS)
mips_threshold(const u64* __restrict__ gmin, u64* __restrict__ thr, u64* __restrict__ win,
               int* __restrict__ count, int G, int k, int cap) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* mins = reinterpret_cast<u64*>(smem);  // [SEL_THREADS]
    u64* comp = mins + SEL_THREADS;            // [cap]: the minima <= T2
    __shared__ int ncomp;
    const int tid = threadIdx.x;
    const size_t qi = blockIdx.x;
    const u64* g = gmin + qi * G;
    u64 mn = EMPTY_KEY;
    for (int i = tid; i < G; i += SEL_THREADS) {
        const u64 x = g[i];
        mn = x < mn ? x : mn;
    }
    mins[tid] = mn;
    if (tid == 0) ncomp = 0;
    __syncthreads();
    bitonic_sort(mins, 1, SEL_THREADS);
    const u64 t2 = mins[k - 1];
    for (int base = 0; base < G; base += SEL_THREADS) {
        const u64 x = base + tid < G ? g[base + tid] : EMPTY_KEY;
        append(comp, &ncomp, cap, x, x != EMPTY_KEY && x <= t2);
    }
    __syncthreads();
    const int nc = ncomp;
    sort_padded(comp, nc);
    for (int i = tid; i < k; i += SEL_THREADS) win[qi * k + i] = i < nc ? comp[i] : EMPTY_KEY;
    if (tid == 0) {
        thr[qi] = nc >= k ? comp[k - 1] : EMPTY_KEY;
        count[qi] = 0;
    }
}

// Step 3, grid (Q, row slots / FILTER_THREADS). Every row whose key is <= T
// lies in a winning group (argument (b)), so only their rows are scored
// again: slot e is row e % mgr of winning group e / mgr, whose layout is that
// of the group's minimum's row. score_row gives the bits of step 1; a row
// with key <= T is appended to cand [q, C], at most C of them (argument (b)).
template <int D4C>
__global__ void __launch_bounds__(FILTER_THREADS)
mips_filter(const float* __restrict__ q, const float* __restrict__ c,
            const u64* __restrict__ thr, const u64* __restrict__ win, int* __restrict__ count,
            u64* __restrict__ cand, int n, int D, int k, int rps, int C) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem);  // [D]
    const size_t qi = blockIdx.x;
    for (int i = threadIdx.x; i < D; i += FILTER_THREADS) qs[i] = q[qi * D + i];
    __syncthreads();
    const int mgr = (rps + SCAN_THREADS - 1) / SCAN_THREADS;
    const int e = blockIdx.y * FILTER_THREADS + threadIdx.x;
    const int w = mgr > 0 ? e / mgr : k;
    u64 key = EMPTY_KEY;
    const u64 m = w < k ? win[qi * k + w] : EMPTY_KEY;
    if (m != EMPTY_KEY) {
        const int row0 = (int)(unsigned)(m & 0xFFFFFFFFu);
        const int s0 = row0 / rps * rps;
        const int r = s0 + (row0 - s0) % SCAN_THREADS + (e - w * mgr) * SCAN_THREADS;
        if (r < min(n, s0 + rps)) {
            float acc[1];
            score_row<1, D4C>(reinterpret_cast<const float4*>(qs),
                              reinterpret_cast<const float4*>(c), r, D >> 2, acc);
            key = ((u64)desc_bits(acc[0]) << 32) | (unsigned)r;
        }
    }
    append(cand + qi * C, count + qi, C, key, key != EMPTY_KEY && key <= thr[qi]);
}

// Step 4, one block per query: sort the count[q] candidates and write the
// first k, as mips_merge does. Keys are distinct, so the output has the same
// bits whatever order the atomics appended them in.
__global__ void __launch_bounds__(SEL_THREADS)
mips_select(const u64* __restrict__ cand, const int* __restrict__ count,
            float* __restrict__ vals, int* __restrict__ idx, int k, int C) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* s = reinterpret_cast<u64*>(smem);  // [next power of two >= C]
    const size_t qi = blockIdx.x;
    const int nk = count[qi];
    if (nk > C) __trap();  // step 3 traps first; never sort a partial list
    for (int i = threadIdx.x; i < nk; i += SEL_THREADS) s[i] = cand[qi * C + i];
    sort_padded(s, nk);
    for (int i = threadIdx.x; i < k; i += SEL_THREADS)
        write_key(i < nk ? s[i] : EMPTY_KEY, vals + qi * k + i, idx + qi * k + i);
}

template <class F>
static cudaError_t set_smem(F* kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D4C>
static cudaError_t threshold_launches(const float* q, const float* c, u64* scratch, int* count,
                                      float* vals, int* idx, int Q, int n, int D, int k, int S,
                                      int rps, int C, int cap, int sel_keys, cudaStream_t st) {
    const int G = S * SCAN_THREADS, mgr = (rps + SCAN_THREADS - 1) / SCAN_THREADS;
    u64* gmin = scratch;                 // [Q, G]
    u64* thr = gmin + (size_t)Q * G;     // [Q]
    u64* win = thr + Q;                  // [Q, k]
    u64* cand = win + (size_t)Q * k;     // [Q, C]
    const size_t smq = (size_t)SCAN_TQ * D * sizeof(float);
    const size_t smt = (size_t)(SEL_THREADS + cap) * sizeof(u64);
    const size_t sms = (size_t)sel_keys * sizeof(u64);
    auto* group_min = mips_group_min<D4C>;
    auto* filter = mips_filter<D4C>;
    cudaError_t err;
    if ((err = set_smem(group_min, smq)) != cudaSuccess) return err;
    group_min<<<dim3((Q + SCAN_TQ - 1) / SCAN_TQ, S), SCAN_THREADS, smq, st>>>(q, c, gmin, Q, n,
                                                                                D, rps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = set_smem(mips_threshold, smt)) != cudaSuccess) return err;
    mips_threshold<<<Q, SEL_THREADS, smt, st>>>(gmin, thr, win, count, G, k, cap);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int slots = (k * mgr + FILTER_THREADS - 1) / FILTER_THREADS;
    filter<<<dim3(Q, slots > 0 ? slots : 1), FILTER_THREADS, (size_t)D * sizeof(float), st>>>(
        q, c, thr, win, count, cand, n, D, k, rps, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = set_smem(mips_select, sms)) != cudaSuccess) return err;
    mips_select<<<Q, SEL_THREADS, sms, st>>>(cand, count, vals, idx, k, C);
    return cudaGetLastError();
}

static long long pow2_at_least(long long x) {
    long long p = 1;
    while (p < x) p <<= 1;
    return p;
}

// q [Q, D], c [N, D] row-major fp32 with D % 4 == 0; scratch u64 [Q * (G + 1 +
// k + C)], G = S * SCAN_THREADS (gmin, thr, win, cand, in that order); count
// [Q] int32 (the candidates kept per query); vals [Q, k] fp32, idx [Q, k]
// int32. The plan (kernels/topk_mips.py topk_plan): S splits of rps rows, C
// candidates a query, cap keys for the threshold's compaction and sel_keys for
// the final sort (powers of two). The plan's bounds are checked here against
// the header's argument before anything launches. Returns cudaGetLastError()
// after the four launches.
extern "C" int topk_threshold_launch(const float* q, const float* c, u64* scratch, int* count,
                                     float* vals, int* idx, int Q, int n, int D, int k, int S,
                                     int rps, int C, int cap, int sel_keys, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long mgr = ((long long)rps + SCAN_THREADS - 1) / SCAN_THREADS;
    const long long m = ((long long)S * SCAN_THREADS + SEL_THREADS - 1) / SEL_THREADS;
    const bool ok = S > 0 && S < 65536 && rps >= 0 && (long long)S * rps >= n && k >= 1 &&
                    k <= SEL_THREADS && C >= (k - 1) * mgr + 1 &&
                    sel_keys >= pow2_at_least(C) && cap >= pow2_at_least((k - 1) * m + 1) &&
                    cap == pow2_at_least(cap) && (long long)k * mgr < 65535ll * FILTER_THREADS;
    if (!ok) return (int)cudaErrorInvalidValue;
    if (D == 8)  // the paper's emb_dim
        return (int)threshold_launches<2>(q, c, scratch, count, vals, idx, Q, n, D, k, S, rps, C,
                                          cap, sel_keys, st);
    return (int)threshold_launches<0>(q, c, scratch, count, vals, idx, Q, n, D, k, S, rps, C, cap,
                                      sel_keys, st);
}

extern "C" const char* topk_mips_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
