// Blocked top-k maximum-inner-product search for Hopper (sm_90a).
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
// What bounds it on this card: 2*Q*n*D fp32 operations outside the tensor
// cores (the corpus is read once per 8-query tile, from L2 after the first);
// at the paper's emb_dim 8 the corpus is 19.2 MB per 600k rows, so the FMAs,
// not the bytes, set the floor. In practice the selection bookkeeping costs
// more than either.
//
// Design. TPU grid steps run in order on one core and carry the running top-k
// from step to step; Hopper's blocks run in parallel and share nothing. So:
//   1. mips_partial: one block per (8-query tile, corpus split). Each thread
//      scores one corpus row against the 8 queries per round. A score enters a
//      query's candidate buffer only if it beats that query's current k-th
//      best (a filter, exact because the k-th best only improves); buffers are
//      compacted with warp ballots and per-warp prefix sums, so every position
//      is decided without atomics. A full buffer is bitonic-sorted and merged
//      into the block's sorted top-K list (K = k rounded up to a power of two).
//   2. mips_merge: one block per query sorts the splits' top-K lists and
//      writes the first k.
// Both sort one 64-bit key per candidate, (order-preserving score bits << 32
// | corpus index), so "score desc, index asc" is plain unsigned order and the
// result is the same whatever the split count or thread schedule.
// D is padded by the caller only to a multiple of 4 floats (one float4 load),
// not to the TPU's 128 lanes, which would move 16x the corpus bytes at D=8.

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
    for (int i = threadIdx.x; i < k; i += NTHREADS) {
        u64 key = s[i];
        float sc = -INFINITY;
        int ix = -1;
        if (key != EMPTY_KEY) {
            sc = score_of((unsigned)(key >> 32));
            if (sc != -INFINITY) ix = (int)(unsigned)(key & 0xFFFFFFFFu);
        }
        vals[qi * k + i] = sc;
        idx[qi * k + i] = ix;
    }
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


extern "C" const char* topk_mips_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
