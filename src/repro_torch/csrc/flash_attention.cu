// Blockwise (flash) attention forward for Hopper (sm_90a), fp32 math.
//
// Replaces: flash_attention_pallas / _flash_fwd_kernel in
// src/repro/kernels/flash_attention.py, the TPU kernel whose grid
// (B, H, Sq/bq, Skv/bk) runs the KV axis innermost and carries the running
// softmax state (m, l, acc) in VMEM scratch, skipping KV blocks that the
// causal or sliding-window mask removes whole.
//
// Contract (the reference's, with its NEG_INF semantics):
//   q [B, H, Sq, Dh], k and v [B, Hkv, Skv, Dh], fp32 or bf16 (all three the
//   same), any strides over (b, h, s) and unit stride over d; o [B, H, Sq, Dh]
//   contiguous, q's dtype. Query head h reads KV head h / (H / Hkv). The query
//   at row i has absolute position q_offset + i, key j position j; a score is
//   kept where j < Skv, j <= pos (causal) and j > pos - window (window > 0).
//   Scores are dot(q, k) * scale with scale = 1/sqrt(Dh) rounded to fp32;
//   masked scores become -1e30 (finite, not -inf), and p is zeroed wherever the
//   mask is false, so a tile in which a row keeps nothing adds nothing even
//   while that row's running max is still -1e30. A row that keeps no key at
//   all (l == 0) writes 0. A KV tile is skipped whole where the reference
//   skips its block: k_lo <= q_hi when causal, k_hi > q_lo - window with a
//   window, positions offset by q_offset. Any Sq and Skv: tails are masked by
//   bounds (the reference asserts that both tile). Dh from 1 to 256.
//
// What bounds it on this card: operations. At Yi-9B's prefill (B 4, S 2048,
// 32 heads over 4 KV heads, Dh 128, causal) the kept (q, k) pairs need
// 4 * Dh = 512 FLOPs each, ~137 GFLOP, ~0.14 ms at the bf16 tensor-core
// peak; q, k and v read once and o written once are ~151 MB, ~0.045 ms at
// 3.35 TB/s. This first kernel does its products on fp32 FMA lanes (no
// tensor cores, no TF32), reading operands from shared memory, so it sits
// far above that bound: 12.07 ms per launch at that shape on an H100 80GB
// HBM3 at 700 W (chip_smoke.py's lm phase), 87x. wgmma and TMA are later
// work.
//
// Design. One CTA of 256 threads per (q tile of 64 rows, head, batch). The q
// tile is staged once in shared memory as fp32; the CTA then walks the KV
// tiles of 64 keys that the skip test keeps. For each: (1) stage the K tile;
// every thread computes a 4 x 4 block of the 64 x 64 scores (rows ty + 16i,
// keys tx + 16j), scaled and masked, into shared memory; (2) stage the V tile
// in the buffer K used, while four threads per row take the row's max,
// rescale factor, p = exp(s - m) (0 where masked) and sum, updating (m, l) in
// shared memory; (3) every thread rescales and accumulates its 4 rows x
// ceil(Dh/16) columns (d = tx + 16c) of the output in registers. The running
// state is fp32 throughout; o = acc / l, converted to q's dtype once. Rows of
// K, Q and V are padded to an odd stride, so the score loop's loads are free
// of bank conflicts. Shared memory is (64 * ld * 2 + 64 * 65 + 192) floats,
// ld = Dh rounded up to odd: 83.5 KB at Dh 128 (two CTAs per SM), 149 KB at
// Dh 256; above 48 KB it is opted into with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    int Sq, Skv, Dh, rep;
    long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
    float scale;
    int causal, window, q_offset;
};

__device__ __forceinline__ bool kept(int qpos, int kpos, int Skv, int causal, int window) {
    return kpos < Skv && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

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
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
    const int hk = h / sh.rep;
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
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sh.Sq + BQ - 1) / BQ, H, B);
    flash_attention_kernel<T><<<grid, NTHREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), sh);
    return (int)cudaGetLastError();
}

// q [B, H, Sq, Dh] with strides (qsb, qsh, qss, 1); k, v [B, Hkv, Skv, Dh]
// with strides (.sb, .sh, .ss, 1); o [B, H, Sq, Dh] contiguous. dtype 0 is
// fp32, 1 is bf16 (all four tensors). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape or dtype it does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Sq,
    int Skv, int Dh, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, float scale,
    int causal, int window, int q_offset, int dtype, void* stream) {
    if (B == 0 || H == 0 || Sq == 0) return 0;
    if (Dh < 1 || Dh > MAX_DH || Hkv < 1 || H % Hkv != 0 || H > 65535 || B > 65535)
        return (int)cudaErrorInvalidValue;
    Shape sh{Sq, Skv, Dh, H / Hkv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
             scale, causal, window, q_offset};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(q, k, v, o, B, H, sh, s);
    if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, B, H, sh, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
