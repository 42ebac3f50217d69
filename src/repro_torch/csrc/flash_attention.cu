// Blockwise (flash) attention forward for Hopper (sm_90a): two kernels.
//
// Replaces: flash_attention_pallas / _flash_fwd_kernel in
// src/repro/kernels/flash_attention.py:106, the TPU kernel whose grid
// (B, H, Sq/bq, Skv/bk) runs the KV axis innermost and carries the running
// softmax state (m, l, acc) in VMEM scratch, skipping KV blocks that the
// causal or sliding-window mask removes whole.
//
// Contract (the reference's, with its NEG_INF semantics), both kernels:
//   q [B, H, Sq, Dh], k and v [B, Hkv, Skv, Dh], all three one dtype, any
//   strides over (b, h, s) and unit stride over d; o [B, H, Sq, Dh]
//   contiguous, q's dtype. Query head h reads KV head (h + off) / g, g the
//   query heads a KV head serves and off the index of the first query head
//   inside its group: the default g = H / Hkv, off = 0 is plain GQA, and a
//   tensor-parallel rank whose heads start or end inside a group passes its
//   own offset (the wrapper checks 0 <= off < g and (H - 1 + off) / g < Hkv).
//   The query at row i has absolute position q_offset + i, key j position j; a score is
//   kept where j < Skv, j <= pos (causal) and j > pos - window (window > 0).
//   Scores are dot(q, k) * scale with scale = 1/sqrt(Dh) rounded to fp32;
//   masked scores become -1e30 (finite, not -inf), and p is zeroed wherever the
//   mask is false, so a tile in which a row keeps nothing adds nothing even
//   while that row's running max is still -1e30. A row that keeps no key at
//   all (l == 0) writes 0. KV tiles the mask removes whole are never visited.
//   Any Sq and Skv: tails are masked by bounds.
//   lse (optional, fp32 [B, H, Sq] contiguous; null: not written) is each row's
//   log-sum-exp in the natural log: lse = log(sum_j exp(s_j)) over the kept
//   keys, s = dot(q, k) * scale, so that p_j = exp(s_j - lse) is the row's
//   softmax; a row that keeps no key stores +inf, which makes every recomputed
//   p exactly 0. The backward (csrc/flash_attention_bwd.cu) recomputes p from
//   it; serving passes null.
//
// What bounds it on this card: operations. Each kept (q, k) pair needs
// 4 * Dh FLOPs (2 * Dh for the score, 2 * Dh for p * v), at the bf16
// tensor-core peak of 989 TFLOP/s. At Yi-9B's prefill (B 4, S 2048, 32 heads
// over 4 KV heads, Dh 128, causal) that is ~137 GFLOP, ~0.14 ms; q, k and v
// read once and o written once are ~151 MB, ~0.045 ms at 3.35 TB/s.
//
// flash_attention_hopper_kernel takes bf16 q, k, v with Dh in {64, 96, 128,
// 192, 256}, 16-byte aligned base pointers and (b, h, s) strides that are
// multiples of 8 elements (what a TMA descriptor can describe). Design:
//   * One CTA of three warpgroups per (128 query rows, head, batch). Warpgroup
//     0 is the producer: one thread issues every TMA load (cp.async.bulk.tensor,
//     4-D descriptors built on the host per launch from the tensors' real
//     strides, 128-byte swizzle, mbarrier completion). Warpgroups 1 and 2 are
//     consumers of 64 query rows each; setmaxnreg moves registers from the
//     producer (40) to the consumers (232).
//   * The q tile is loaded once. K and V tiles of BK keys (128 at Dh <= 128,
//     64 above) go through a ring of 2 stages, each with a "full" barrier for
//     K, one for V and an "empty" barrier the consumers release after their
//     p * v product. TMA zero-fills rows past Sq or Skv and columns past Dh
//     (Dh 96 runs as 128 with zero columns); the bounds mask still decides
//     which scores are kept.
//   * S = Q K^T is a wgmma with both operands in shared memory (K-major, the
//     descriptors' 128-byte swizzle matching TMA's) and fp32 accumulators.
//     The online softmax runs on the accumulator fragment (two rows per
//     thread, a quad per row), in the log2 domain with exp2f; (m, l) and the
//     output accumulator stay fp32. No TF32 anywhere.
//   * P * V is a wgmma with P from registers, converted to bf16 in the
//     accumulator's own fragment layout (the FlashAttention-3 arrangement),
//     and V from shared memory as the transposed (MN-major) B operand. P is
//     split in two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), and both
//     are multiplied into the same accumulator: hi alone is what the TPU's
//     default-precision dot does, and it puts a few percent of the outputs
//     outside the port's stated tolerance against the fp32 plain version
//     (rtol 2^-6, atol 2e-5; tests/test_torch_kernels.py emulates both
//     roundings); hi + lo carries p to ~16 bits. This costs half again the
//     tensor-core work (6 * Dh instead of 4 * Dh FLOPs per kept pair).
//   * Each CTA computes its first and last KV tile from causal, window and
//     q_offset and visits only those; the mask is applied only on tiles that
//     straddle a boundary. Under a causal mask the q tiles are launched
//     heaviest first (the q-tile index is the grid's slowest axis, reversed).
// cuTensorMapEncodeTiled is a driver function: it is reached through the
// runtime's cudaGetDriverEntryPoint(ByVersion), so the library links nothing
// beyond the runtime.
//
// flash_attention_simt_kernel takes everything else (fp32, any Dh up to
// 256, strides TMA cannot describe). It is the port's first kernel, kept as
// it was: one CTA of 256 threads per (64 query rows, head, batch), operands
// staged as fp32 in shared memory, both products on fp32 FMA lanes. At the
// Yi-9B shape above it took 12.07 ms per launch on an H100 80GB HBM3 at
// 700 W, 87x its bound. Its design: the q tile is staged once; for each KV
// tile of 64 keys that the skip test keeps: (1) stage the K tile; every
// thread computes a 4 x 4 block of the 64 x 64 scores (rows ty + 16i, keys
// tx + 16j), scaled and masked, into shared memory; (2) stage the V tile in
// the buffer K used, while four threads per row take the row's max, rescale
// factor, p = exp(s - m) (0 where masked) and sum, updating (m, l) in shared
// memory; (3) every thread rescales and accumulates its 4 rows x ceil(Dh/16)
// columns (d = tx + 16c) of the output in registers. o = acc / l, converted
// to q's dtype once. Rows of K, Q and V are padded to an odd stride, so the
// score loop's loads are free of bank conflicts. Shared memory is
// (64 * ld * 2 + 64 * 65 + 192) floats, ld = Dh rounded up to odd: 83.5 KB at
// Dh 128, 149 KB at Dh 256; above 48 KB it is opted into with
// cudaFuncSetAttribute.
//
// The wrapper (kernels/flash_attention.py, flash_variant) picks the kernel by
// dtype, Dh, alignment and strides; neither gives way to the other on failure.

#include <math.h>

#include "hopper.cuh"

#define NTHREADS 256
#define BQ 64
#define BK 64
#define LDP (BK + 1)
#define MAX_DH 256
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

struct Shape {
    int Sq, Skv, Dh, rep, off;
    long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
    float scale;
    int causal, window, q_offset;
};

__device__ __forceinline__ bool kept(int qpos, int kpos, int Skv, int causal, int window) {
    return kpos < Skv && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// ====================================================================== SIMT
// flash_attention_simt_kernel (see the note).

// Stage rows [r0, r0 + 64) of a [*, Dh] operand (row stride ``ss``) into
// shared memory as fp32 [64][ld]; rows at or past ``n_rows`` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long long ss,
                                      int r0, int n_rows, int Dh, int ld) {
    for (int e = threadIdx.x; e < 64 * Dh; e += NTHREADS) {
        const int r = e / Dh, d = e - r * Dh;
        dst[r * ld + d] = (r0 + r < n_rows) ? to_f32(src[(long long)(r0 + r) * ss + d]) : 0.0f;
    }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       Shape sh) {
    extern __shared__ float smem[];
    const int Dh = sh.Dh;
    const int ld = Dh | 1;
    float* Qs = smem;              // [BQ][ld]
    float* KVs = Qs + BQ * ld;     // [BK][ld]: the K tile, then the V tile
    float* Ps = KVs + BK * ld;     // [BQ][LDP]: scores, then p
    float* m_s = Ps + BQ * LDP;    // [BQ] running max
    float* l_s = m_s + BQ;         // [BQ] running sum
    float* c_s = l_s + BQ;         // [BQ] this tile's rescale factor

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int hk = (h + sh.off) / sh.rep;
    const T* qb = q + b * sh.qsb + h * sh.qsh;
    const T* kb = k + b * sh.ksb + hk * sh.ksh;
    const T* vb = v + b * sh.vsb + hk * sh.vsh;
    const int nc = (Dh + 15) >> 4;  // output columns per thread

    stage(Qs, qb, sh.qss, q0, sh.Sq, Dh, ld);
    if (tid < BQ) {
        m_s[tid] = NEG_INF;
        l_s[tid] = 0.0f;
    }
    float acc[4][MAX_DH / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < MAX_DH / 16; ++c) acc[i][c] = 0.0f;
    __syncthreads();

    const int q_lo = sh.q_offset + q0;
    const int q_hi = sh.q_offset + min(q0 + BQ, sh.Sq) - 1;
    const int n_kt = (sh.Skv + BK - 1) / BK;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        const int k_hi = min(k0 + BK, sh.Skv) - 1;
        if (sh.causal && k0 > q_hi) break;  // every later tile is skipped too
        if (sh.window > 0 && !(k_hi > q_lo - sh.window)) continue;

        // (1) scores of rows ty + 16i against keys tx + 16j
        stage(KVs, kb, sh.kss, k0, sh.Skv, Dh, ld);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
        for (int d = 0; d < Dh; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * ld + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q_lo + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                Ps[(ty + 16 * i) * LDP + tx + 16 * j] =
                    kept(qpos, kpos, sh.Skv, sh.causal, sh.window) ? s[i][j] * sh.scale : NEG_INF;
            }
        }
        __syncthreads();

        // (2) the V tile into the K buffer; online softmax, four threads a row
        stage(KVs, vb, sh.vss, k0, sh.Skv, Dh, ld);
        {
            const int r = tid >> 2, part = tid & 3;
            const int qpos = q_lo + r;
            float* prow = Ps + r * LDP + part * 16;
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_prev = m_s[r];
            const float m_cur = fmaxf(m_prev, mx);
            const float corr = expf(m_prev - m_cur);
            float sum = 0.0f;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const int kpos = k0 + part * 16 + c;
                const float p = kept(qpos, kpos, sh.Skv, sh.causal, sh.window)
                                    ? expf(prow[c] - m_cur) : 0.0f;
                prow[c] = p;
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (part == 0) {
                m_s[r] = m_cur;
                l_s[r] = l_s[r] * corr + sum;
                c_s[r] = corr;
            }
        }
        __syncthreads();

        // (3) acc = acc * corr + p @ v for rows ty + 16i, columns tx + 16c
        float corr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) corr[i] = c_s[ty + 16 * i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < MAX_DH / 16; ++c)
                if (c < nc) acc[i][c] *= corr[i];
        for (int j = 0; j < BK; ++j) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LDP + j];
            const float* vrow = KVs + j * ld + tx;
#pragma unroll
            for (int c = 0; c < MAX_DH / 16; ++c) {
                if (c < nc) {
                    const float vv = (tx + 16 * c < Dh) ? vrow[16 * c] : 0.0f;
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
                }
            }
        }
        __syncthreads();  // the next tile overwrites KVs and Ps
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (q0 + r >= sh.Sq) continue;
        const float l = l_s[r];
        const float safe_l = (l == 0.0f) ? 1.0f : l;  // rows that keep no key -> 0
        T* orow = o + (((long long)b * gridDim.y + h) * sh.Sq + q0 + r) * Dh;
#pragma unroll
        for (int c = 0; c < MAX_DH / 16; ++c) {
            const int d = tx + 16 * c;
            if (c < nc && d < Dh) from_f32(orow + d, acc[i][c] / safe_l);
        }
    }
    if (lse != nullptr && tid < BQ && q0 + tid < sh.Sq) {
        const float l = l_s[tid];
        lse[((long long)b * gridDim.y + h) * sh.Sq + q0 + tid] =
            l == 0.0f ? INFINITY : m_s[tid] + logf(l);
    }
}

static size_t smem_bytes(int Dh) {
    const int ld = Dh | 1;
    return sizeof(float) * ((size_t)BQ * ld + (size_t)BK * ld + (size_t)BQ * LDP + 3 * BQ);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int H, const Shape& sh, cudaStream_t stream) {
    const size_t bytes = smem_bytes(sh.Dh);
    cudaError_t err = cudaFuncSetAttribute(flash_attention_simt_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sh.Sq + BQ - 1) / BQ, H, B);
    flash_attention_simt_kernel<T><<<grid, NTHREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, sh);
    return (int)cudaGetLastError();
}

// Query head h of H reads KV head (h + head_offset) / group of Hkv.
static bool groups_ok(int H, int Hkv, int group, int head_offset) {
    return Hkv >= 1 && group >= 1 && head_offset >= 0 && head_offset < group &&
           (H - 1 + head_offset) / group < Hkv;
}

// q [B, H, Sq, Dh] with strides (qsb, qsh, qss, 1); k, v [B, Hkv, Skv, Dh]
// with strides (.sb, .sh, .ss, 1); o [B, H, Sq, Dh] contiguous; lse fp32
// [B, H, Sq] contiguous or null; query head h reads KV head (h +
// head_offset) / group. dtype 0 is
// fp32, 1 is bf16 (all four tensors). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape or dtype it does not take.
extern "C" int flash_attention_simt_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Hkv, int Sq,
    int Skv, int Dh, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, float scale,
    int causal, int window, int q_offset, int group, int head_offset, int dtype, void* stream) {
    if (B == 0 || H == 0 || Sq == 0) return 0;
    if (Dh < 1 || Dh > MAX_DH || !groups_ok(H, Hkv, group, head_offset) || H > 65535 ||
        B > 65535)
        return (int)cudaErrorInvalidValue;
    Shape sh{Sq, Skv, Dh, group, head_offset, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
             scale, causal, window, q_offset};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    if (dtype == 0) return launch<float>(q, k, v, o, l, B, H, sh, s);
    if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, l, B, H, sh, s);
    return (int)cudaErrorInvalidValue;
}

// ===================================================================== Hopper
// flash_attention_hopper_kernel: wgmma + TMA, bf16 operands (see the note).

#undef NTHREADS
#undef BQ
#undef BK
#undef LDP

namespace hopper {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRowsQ = 128;    // query rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;     // K/V ring depth
constexpr float kLn2 = 0.6931471805599453f;

template <int DHP, int BK>
struct Tiles {
    static constexpr int kChunks = DHP / 64;              // 64-column chunks, 128-byte rows
    static constexpr int kQBytes = kRowsQ * DHP * 2;      // the q tile
    static constexpr int kKVBytes = BK * DHP * 2;         // one K or one V tile
    static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024 + 64;  // + align, barriers
};

struct Params {
    int Sq, Skv, Dh, rep, off, causal, window, q_offset, n_qt;
    float scale_log2;  // scale * log2(e): the softmax runs in the log2 domain
};

__device__ __forceinline__ bool kept(int qpos, int kpos, const Params& p) {
    return kpos < p.Skv && (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
}

template <int DHP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                              const Params p) {
    using T = Tiles<DHP, BK>;
    extern __shared__ uint8_t smem_raw[];
    // 1024-byte alignment: the 128-byte swizzle pattern repeats every 8 rows
    uint8_t* Qs = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint8_t* Ks = Qs + T::kQBytes;              // [stage][chunk][BK rows][128 bytes]
    uint8_t* Vs = Ks + kStages * T::kKVBytes;   // the same for V
    uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * T::kKVBytes);
    uint64_t* full_q = bars;
    uint64_t* full_k = bars + 1;
    uint64_t* full_v = bars + 1 + kStages;
    uint64_t* empty = bars + 1 + 2 * kStages;

    const int h = blockIdx.x, b = blockIdx.y;
    const int qt = p.causal ? p.n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;  // heaviest first
    const int q0 = qt * kRowsQ;
    // the KV tiles this CTA's rows can keep
    const int pos_first = p.q_offset + q0;
    const int pos_last = p.q_offset + min(q0 + kRowsQ, p.Sq) - 1;
    const int k_begin = p.window > 0 ? max(0, pos_first - p.window + 1) : 0;
    const int k_end = p.causal ? min(p.Skv, pos_last + 1) : p.Skv;
    const int t_begin = k_begin / BK;
    const int n_tiles = k_end > t_begin * BK ? (k_end - t_begin * BK + BK - 1) / BK : 0;

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full_k[s], 1);
            mbar_init(&full_v[s], 1);
            mbar_init(&empty[s], 2 * 128);  // every consumer thread arrives
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---------------------------------------------------------- producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            const int hk = (h + p.off) / p.rep;
            mbar_expect_tx(full_q, T::kQBytes);
            for (int c = 0; c < T::kChunks; ++c)
                tma_load_4d(Qs + c * kRowsQ * 128, &tq, full_q, c * 64, q0, h, b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % kStages;
                mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
                const int k0 = (t_begin + i) * BK;
                uint8_t* kd = Ks + s * T::kKVBytes;
                uint8_t* vd = Vs + s * T::kKVBytes;
                mbar_expect_tx(&full_k[s], T::kKVBytes);
                for (int c = 0; c < T::kChunks; ++c)
                    tma_load_4d(kd + c * BK * 128, &tk, &full_k[s], c * 64, k0, hk, b);
                mbar_expect_tx(&full_v[s], T::kKVBytes);
                for (int c = 0; c < T::kChunks; ++c)
                    tma_load_4d(vd + c * BK * 128, &tv, &full_v[s], c * 64, k0, hk, b);
            }
        }
    } else {
        // --------------------------------------------------------- consumers
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int cw = wg - 1;  // rows 64 * cw .. of the q tile
        const int t = threadIdx.x - 128 * wg;
        const int warp = t / 32, lane = t % 32;
        const int r_lo = 16 * warp + lane / 4;  // fragment rows r_lo and r_lo + 8
        const int row0 = q0 + 64 * cw + r_lo;
        const int pos0 = p.q_offset + row0, pos1 = pos0 + 8;
        const int wpos_first = p.q_offset + q0 + 64 * cw, wpos_last = wpos_first + 63;
        const int col_lane = 2 * (lane % 4);

        float acc[DHP / 2];
#pragma unroll
        for (int j = 0; j < DHP / 2; ++j) acc[j] = 0.0f;
        float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
        const uint32_t q_addr = smem_u32(Qs) + cw * 64 * 128;
        mbar_wait(full_q, 0);

        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % kStages;
            const uint32_t parity = (i / kStages) & 1;
            const int k0 = (t_begin + i) * BK;
            const uint32_t k_addr = smem_u32(Ks + s * T::kKVBytes);
            const uint32_t v_addr = smem_u32(Vs + s * T::kKVBytes);

            // S = Q K^T over DHP / 16 k-steps of 32 bytes within each 128-byte row
            float sc[BK / 2];
#pragma unroll
            for (int j = 0; j < BK / 2; ++j) sc[j] = 0.0f;
            mbar_wait(&full_k[s], parity);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < DHP / 16; ++kk) {
                const uint32_t in_row = (kk % 4) * 32;
                wgmma_ss(sc, desc_sw128(q_addr + (kk / 4) * kRowsQ * 128 + in_row, 16, 1024),
                         desc_sw128(k_addr + (kk / 4) * BK * 128 + in_row, 16, 1024), kk > 0);
            }
            wg_commit();
            wg_wait<0>();
            fence_regs(sc);

            // scale, mask (only on a tile that straddles a boundary), row max
            const bool need_mask = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > wpos_first) ||
                                   (p.window > 0 && k0 <= wpos_last - p.window);
            float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
            for (int j = 0; j < BK / 2; ++j) {
                const bool hi = (j & 2) != 0;
                float x = sc[j] * p.scale_log2;
                if (need_mask) {
                    const int kpos = k0 + 8 * (j / 4) + col_lane + (j & 1);
                    if (!kept(hi ? pos1 : pos0, kpos, p)) x = NEG_INF;
                }
                sc[j] = x;
                if (hi) mx1 = fmaxf(mx1, x);
                else mx0 = fmaxf(mx0, x);
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
            m0 = mn0;
            m1 = mn1;

            // p = exp2(s - m), 0 where masked; split into bf16 hi + lo pairs
            uint32_t p_hi[BK / 4], p_lo[BK / 4];
            float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
            for (int j = 0; j < BK / 2; j += 2) {
                const bool hi = (j & 2) != 0;
                const float m = hi ? mn1 : mn0;
                const float a = sc[j] == NEG_INF ? 0.0f : exp2f(sc[j] - m);
                const float bb = sc[j + 1] == NEG_INF ? 0.0f : exp2f(sc[j + 1] - m);
                if (hi) sum1 += a + bb;
                else sum0 += a + bb;
                const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, bb);
                const float2 back = __bfloat1622float2(h2);
                const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - back.x, bb - back.y);
                p_hi[j / 2] = *reinterpret_cast<const uint32_t*>(&h2);
                p_lo[j / 2] = *reinterpret_cast<const uint32_t*>(&l2);
            }
            l0 = l0 * c0 + sum0;  // per-thread partial sums, reduced over the quad at the end
            l1 = l1 * c1 + sum1;
#pragma unroll
            for (int j = 0; j < DHP / 2; ++j) acc[j] *= (j & 2) ? c1 : c0;

            // O += P V: per k-step of 16 keys (2048 bytes of V rows), hi then lo
            mbar_wait(&full_v[s], parity);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t dv = desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024);
                const uint32_t ah[4] = {p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                                        p_hi[4 * kk + 3]};
                const uint32_t al[4] = {p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                                        p_lo[4 * kk + 3]};
                wgmma_rs(acc, ah, dv);
                wgmma_rs(acc, al, dv);
            }
            wg_commit();
            wg_wait<0>();
            fence_regs(acc);
            fence_regs(p_hi);
            fence_regs(p_lo);
            mbar_arrive(&empty[s]);
        }

        // o = acc / l (0 for a row that keeps no key), bf16
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float d0 = l0 == 0.0f ? 1.0f : l0, d1 = l1 == 0.0f ? 1.0f : l1;
        if (lse != nullptr && (lane & 3) == 0) {  // (m, l) are log2-domain: lse = ln 2 (m + log2 l)
            float* lb = lse + ((size_t)b * gridDim.x + h) * (size_t)p.Sq;
            if (row0 < p.Sq) lb[row0] = l0 == 0.0f ? INFINITY : (m0 + log2f(l0)) * kLn2;
            if (row0 + 8 < p.Sq) lb[row0 + 8] = l1 == 0.0f ? INFINITY : (m1 + log2f(l1)) * kLn2;
        }
        __nv_bfloat16* ob = o + ((size_t)b * gridDim.x + h) * (size_t)p.Sq * p.Dh;
#pragma unroll
        for (int j = 0; j < DHP / 2; j += 2) {
            const bool hi = (j & 2) != 0;
            const int row = hi ? row0 + 8 : row0;
            const int col = 8 * (j / 4) + col_lane;
            if (row < p.Sq && col < p.Dh) {
                const float d = hi ? d1 : d0;
                *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * p.Dh + col) =
                    __floats2bfloat162_rn(acc[j] / d, acc[j + 1] / d);
            }
        }
    }
}

template <int DHP, int BK>
static int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int H, int Hkv, int Sq, int Skv, int Dh, const long long* qs, const long long* ks,
                  const long long* vs, float scale, int causal, int window, int q_offset,
                  int group, int head_offset, cudaStream_t stream) {
    int err;
    CUtensorMap tq, tk, tv;
    if ((err = make_map_bhsd(&tq, q, Dh, Sq, H, B, qs[2], qs[1], qs[0], kRowsQ))) return err;
    if ((err = make_map_bhsd(&tk, k, Dh, Skv, Hkv, B, ks[2], ks[1], ks[0], BK))) return err;
    if ((err = make_map_bhsd(&tv, v, Dh, Skv, Hkv, B, vs[2], vs[1], vs[0], BK))) return err;
    using T = Tiles<DHP, BK>;
    cudaError_t e = cudaFuncSetAttribute(flash_attention_hopper_kernel<DHP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return (int)e;
    const int n_qt = (Sq + kRowsQ - 1) / kRowsQ;
    const Params p{Sq, Skv, Dh, group, head_offset, causal, window, q_offset, n_qt,
                   scale * 1.4426950408889634f};
    flash_attention_hopper_kernel<DHP, BK><<<dim3(H, B, n_qt), kThreads, T::kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, p);
    return (int)cudaGetLastError();
}

}  // namespace hopper

// bf16 q [B, H, Sq, Dh] with element strides (qsb, qsh, qss, 1); k, v [B,
// Hkv, Skv, Dh] with strides (.sb, .sh, .ss, 1); o [B, H, Sq, Dh] contiguous
// bf16; lse fp32 [B, H, Sq] contiguous or null. Dh in {64, 96, 128, 192,
// 256}; base pointers 16-byte aligned and strides multiples of 8 (the
// wrapper's flash_variant checks both). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape it
// does not take, or an error of the tensor-map encoding (see the error string).
// Query head h reads KV head (h + head_offset) / group.
extern "C" int flash_attention_hopper_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Hkv, int Sq,
    int Skv, int Dh, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, float scale,
    int causal, int window, int q_offset, int group, int head_offset, void* stream) {
    if (B == 0 || H == 0 || Sq == 0) return 0;
    if (!groups_ok(H, Hkv, group, head_offset) || B > 65535 ||
        (Sq + hopper::kRowsQ - 1) / hopper::kRowsQ > 65535)
        return (int)cudaErrorInvalidValue;
    const long long qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    switch (Dh) {
        case 64: return hopper::launch<64, 128>(q, k, v, o, l, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                scale, causal, window, q_offset, group,
                                                head_offset, s);
        case 96:  // runs as 128, TMA zero-fills columns 96..127
        case 128: return hopper::launch<128, 128>(q, k, v, o, l, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                  scale, causal, window, q_offset, group,
                                                  head_offset, s);
        case 192: return hopper::launch<192, 64>(q, k, v, o, l, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                 scale, causal, window, q_offset, group,
                                                 head_offset, s);
        case 256: return hopper::launch<256, 64>(q, k, v, o, l, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                 scale, causal, window, q_offset, group,
                                                 head_offset, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* flash_attention_error_string(int err) {
    return hopper::error_string(err);
}
