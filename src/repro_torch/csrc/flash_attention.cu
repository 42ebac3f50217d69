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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

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
                       const T* __restrict__ v, T* __restrict__ o, Shape sh) {
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
}

static size_t smem_bytes(int Dh) {
    const int ld = Dh | 1;
    return sizeof(float) * ((size_t)BQ * ld + (size_t)BK * ld + (size_t)BQ * LDP + 3 * BQ);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                  const Shape& sh, cudaStream_t stream) {
    const size_t bytes = smem_bytes(sh.Dh);
    cudaError_t err = cudaFuncSetAttribute(flash_attention_simt_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sh.Sq + BQ - 1) / BQ, H, B);
    flash_attention_simt_kernel<T><<<grid, NTHREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), sh);
    return (int)cudaGetLastError();
}

// Query head h of H reads KV head (h + head_offset) / group of Hkv.
static bool groups_ok(int H, int Hkv, int group, int head_offset) {
    return Hkv >= 1 && group >= 1 && head_offset >= 0 && head_offset < group &&
           (H - 1 + head_offset) / group < Hkv;
}

// q [B, H, Sq, Dh] with strides (qsb, qsh, qss, 1); k, v [B, Hkv, Skv, Dh]
// with strides (.sb, .sh, .ss, 1); o [B, H, Sq, Dh] contiguous; query head h
// reads KV head (h + head_offset) / group. dtype 0 is
// fp32, 1 is bf16 (all four tensors). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape or dtype it does not take.
extern "C" int flash_attention_simt_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Sq,
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
    if (dtype == 0) return launch<float>(q, k, v, o, B, H, sh, s);
    if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, B, H, sh, s);
    return (int)cudaErrorInvalidValue;
}

// ===================================================================== Hopper
// flash_attention_hopper_kernel: wgmma + TMA, bf16 operands (see the note).

#undef NTHREADS
#undef BQ
#undef BK
#undef LDP

#include <cuda.h>  // CUtensorMap and its enums; the driver function comes by entry point

namespace hopper {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRowsQ = 128;    // query rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;     // K/V ring depth
constexpr int kErrEncode = 100000;  // + CUresult: cuTensorMapEncodeTiled failed
constexpr int kErrEntry = 200000;   // + cudaError_t: the driver entry point was not found

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    }
}

// One 4-D TMA tile load into shared memory, completion counted on ``bar``.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: rows
// of 128 bytes, 8-row groups ``sbo`` = 1024 bytes apart (``lbo`` unused).
// MN-major (V as B): ``lbo`` is the distance between 64-column chunks, ``sbo``
// between groups of 8 k-rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma results above the wait, or
// reusing the registers of an in-flight wgmma's operands.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma m64nNk16, fp32 += bf16 * bf16. wgmma_ss: A and B from shared memory,
// both K-major. wgmma_rs: A (4 registers of packed bf16 pairs, the
// accumulator's fragment layout) from registers, B MN-major from shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
                              __nv_bfloat16* __restrict__ o, const Params p) {
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
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
            wg_wait0();
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
            wg_wait0();
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static int encode_fn(EncodeTiled* out) {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                                  &q);
#endif
        if (err != cudaSuccess) return kErrEntry + (int)err;
        if (q != cudaDriverEntryPointSuccess || f == nullptr)
            return kErrEntry + (int)cudaErrorSymbolNotFound;
        fn = reinterpret_cast<EncodeTiled>(f);
    }
    *out = fn;
    return 0;
}

// A 4-D map over [B][heads][S][Dh] (innermost first: Dh, S, heads, B) with
// the given element strides, boxes of 64 columns x ``rows`` rows.
static int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int Dh, int S, int heads,
                    int B, long long ss, long long sh, long long sb, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                           strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int DHP, int BK>
static int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                  int Sq, int Skv, int Dh, const long long* qs, const long long* ks,
                  const long long* vs, float scale, int causal, int window, int q_offset,
                  int group, int head_offset, cudaStream_t stream) {
    EncodeTiled enc;
    int err = encode_fn(&enc);
    if (err) return err;
    CUtensorMap tq, tk, tv;
    if ((err = make_map(enc, &tq, q, Dh, Sq, H, B, qs[2], qs[1], qs[0], kRowsQ))) return err;
    if ((err = make_map(enc, &tk, k, Dh, Skv, Hkv, B, ks[2], ks[1], ks[0], BK))) return err;
    if ((err = make_map(enc, &tv, v, Dh, Skv, Hkv, B, vs[2], vs[1], vs[0], BK))) return err;
    using T = Tiles<DHP, BK>;
    cudaError_t e = cudaFuncSetAttribute(flash_attention_hopper_kernel<DHP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return (int)e;
    const int n_qt = (Sq + kRowsQ - 1) / kRowsQ;
    const Params p{Sq, Skv, Dh, group, head_offset, causal, window, q_offset, n_qt,
                   scale * 1.4426950408889634f};
    flash_attention_hopper_kernel<DHP, BK><<<dim3(H, B, n_qt), kThreads, T::kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
    return (int)cudaGetLastError();
}

}  // namespace hopper

// bf16 q [B, H, Sq, Dh] with element strides (qsb, qsh, qss, 1); k, v [B,
// Hkv, Skv, Dh] with strides (.sb, .sh, .ss, 1); o [B, H, Sq, Dh] contiguous
// bf16. Dh in {64, 96, 128, 192, 256}; base pointers 16-byte aligned and
// strides multiples of 8 (the wrapper's flash_variant checks both). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape it
// does not take, or an error of the tensor-map encoding (see the error string).
// Query head h reads KV head (h + head_offset) / group.
extern "C" int flash_attention_hopper_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Sq,
    int Skv, int Dh, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, float scale,
    int causal, int window, int q_offset, int group, int head_offset, void* stream) {
    if (B == 0 || H == 0 || Sq == 0) return 0;
    if (!groups_ok(H, Hkv, group, head_offset) || B > 65535 ||
        (Sq + hopper::kRowsQ - 1) / hopper::kRowsQ > 65535)
        return (int)cudaErrorInvalidValue;
    const long long qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (Dh) {
        case 64: return hopper::launch<64, 128>(q, k, v, o, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                scale, causal, window, q_offset, group,
                                                head_offset, s);
        case 96:  // runs as 128, TMA zero-fills columns 96..127
        case 128: return hopper::launch<128, 128>(q, k, v, o, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                  scale, causal, window, q_offset, group,
                                                  head_offset, s);
        case 192: return hopper::launch<192, 64>(q, k, v, o, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                 scale, causal, window, q_offset, group,
                                                 head_offset, s);
        case 256: return hopper::launch<256, 64>(q, k, v, o, B, H, Hkv, Sq, Skv, Dh, qs, ks, vs,
                                                 scale, causal, window, q_offset, group,
                                                 head_offset, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* flash_attention_error_string(int err) {
    static thread_local char buf[160];
    if (err >= hopper::kErrEntry) {
        snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled entry point not found: %s",
                 cudaGetErrorString(static_cast<cudaError_t>(err - hopper::kErrEntry)));
        return buf;
    }
    if (err >= hopper::kErrEncode) {
        snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d",
                 err - hopper::kErrEncode);
        return buf;
    }
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
