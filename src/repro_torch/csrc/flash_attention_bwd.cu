// Blockwise (flash) attention backward for Hopper (sm_90a): dq, dk, dv from the
// saved output o and log-sum-exp lse of the forward (csrc/flash_attention.cu).
//
// Replaces: _flash_bwd in src/repro/kernels/ops.py:479, the custom VJP of the
// reference's Pallas flash kernel (flash_attention_pallas,
// src/repro/kernels/flash_attention.py:106), which takes the vector-Jacobian
// product of attention_blockwise by recomputing it. The gradient is the same
// function: with s = dot(q, k) * scale, p = exp(s - lse) (0 where masked),
//   delta_i = sum_d dO_id * O_id,
//   dV_j = sum_i p_ij dO_i,      dP_ij = dot(dO_i, V_j),
//   dS_ij = p_ij (dP_ij - delta_i),
//   dQ_i = scale * sum_j dS_ij K_j,   dK_j = scale * sum_i dS_ij Q_i,
// the GQA sum over the query heads that read a KV head included.
//
// Contract, all three variants: q, o, dO [B, H, Sq, Dh], k, v [B, Hkv, Skv, Dh], one
// dtype (fp32 or bf16), any strides over (b, h, s) and unit stride over d; lse
// fp32 [B, H, Sq] contiguous, in the forward's convention: the natural log of
// the row's sum of exp(s) over its kept keys, +inf for a row that keeps no key
// (so every recomputed p of that row is exactly 0). delta fp32 [B, H, Sq] is
// scratch the first launch writes. dq [B, H, Sq, Dh] and dk, dv [B, Hkv, Skv,
// Dh] are contiguous, in q's dtype, each written once. The masks are the
// forward's: query row i at position q_offset + i keeps key j where j < Skv,
// j <= pos (causal) and j > pos - window (window > 0); query head h reads KV
// head (h + off) / group. Tiles the mask removes whole are never visited.
//
// Three launches a backward, no float atomics, so a result is the same bit
// for bit from run to run:
//   1. delta: one warp a row, a fixed shuffle tree.
//   2. dK, dV: one CTA per key tile (128 keys in the hopper variant at head
//      dims up to 128, 64 at 192 and 256 and in mma, 32 in simt), KV head and
//      batch keeps its K and V tile on chip and loops, in a fixed order, over
//      the query heads that read its KV head and, for each, over the q tiles
//      its keys can be kept by (the inverse of the forward's KV-tile range:
//      from causal, window, q_offset and the tails). The GQA sum stays inside
//      the CTA (at 192 and 256, inside a cluster of two CTAs that split the
//      steps, see below); dk and dv are written once.
//   3. dQ: one CTA per q tile (128 rows, 64, 32), head and batch loops over
//      the KV tiles its rows keep (the forward's range) and writes dq once.
//
// What bounds it on this card: operations. Each kept (q, k) pair needs 10 * Dh
// FLOPs (S, dP, dV, dK and dQ, 2 * Dh each) at the bf16 tensor-core peak of
// 989 TFLOP/s. At Yi-9B's (B 4, S 2048, 32 heads over 4 KV heads, Dh 128,
// causal) that is ~344 GFLOP, ~0.35 ms; q, k, v, o, dO read, lse and delta,
// and dq, dk, dv written once are ~304 MB, ~0.09 ms at 3.35 TB/s. The
// kernels do more tensor-core work than that. dS enters dK and dQ as two
// bf16 terms, hi = bf16(ds) and lo = bf16(ds - hi) (+4 * Dh FLOPs a pair): a
// CPU emulation of the roundings (tests/test_torch_flash_bwd.py) puts dq and
// dk at up to 7.6e-3 of their largest magnitude with dS in bf16 alone, three
// quarters of the card's tolerance (1e-2), and at 1.3e-3 with the split. The
// mma variant rounds P to bf16 once as dV's operand, which puts dv at up to
// 5.2e-3 (Dh 96, 512 keys, not causal), past half the tolerance; the hopper
// variant splits P too, as the forward does in P V (+2 * Dh). The dQ kernel
// recomputes S and dP (+4 * Dh), the price of no atomics: 18 * Dh FLOPs a
// pair in the mma variant, 20 * Dh in the hopper one. p is recomputed as
// exp2(s * scale * log2(e) - lse * log2(e)).
//
// hopper variant (bf16, Dh 64, 96, 128, 192 or 256, 16-byte aligned data,
// (b, h, s) strides positive multiples of 8 elements, at least one key):
// wgmma + TMA, warp-specialised, the forward's (csrc/flash_attention.cu)
// building blocks (csrc/hopper.cuh). Dh 96 runs as 128: TMA zero-fills
// columns 96..127, which add nothing to any product, and only 96 columns are
// stored.
//   * dK/dV kernel, Dh up to 128: one CTA of three warpgroups per (KV head,
//     batch, 128-key tile); the key tiles are the grid's slowest axis, so
//     under a causal mask the heaviest launch first. Warpgroup 0 produces:
//     one thread loads the K and V tiles once and then streams (Q, dO) tiles
//     of 64 query rows through a ring of 3 stages by TMA (4-D descriptors
//     over the tensors' own strides, 128-byte swizzle, mbarrier completion),
//     in a fixed order over the query heads of the KV group and the q tiles
//     the keys can be kept by; warp 1 writes each step's lse (log2 domain,
//     +inf past Sq) and delta rows beside them and arrives on the same
//     barrier. setmaxnreg moves registers from the producer (24) to the
//     consumers (240). Consumer warpgroups 1 and 2 own 64 keys each, dK and dV
//     in fp32 registers. Per step: S^T = K Q^T and dP^T = V dO^T are wgmmas
//     with both operands in shared memory, K-major over Dh, issued together;
//     exp2 and the mask run on S^T while dP^T is still in the tensor cores
//     (wait_group 1); then dS^T = P^T (dP^T - delta). P^T and dS^T, split
//     into bf16 hi + lo in the accumulator's own fragment layout, are the
//     register A operands of dV += P^T dO and dK += dS^T Q, issued together,
//     with dO and Q read MN-major (the transpose bit) from the same stage.
//     (Forming dS^T while dV runs would keep P^T's fp32 and bf16 registers
//     live together: at Dh 128 that is past 240 registers, and ptxas
//     serialises the wgmmas.) One TMA load of Q and dO feeds both of its
//     products. A warpgroup whose keys the mask removes whole from a step
//     skips it.
//   * dK/dV kernel, Dh 192 and 256: the same producer over 64-key tiles, but
//     the consumers split the work by gradient, not by key. dK and dV of 64
//     keys by the whole head dim take 64 * Dh * 2 / 128 = Dh fp32 registers a
//     thread (192, 256), past setmaxnreg's 240 beside the score products; one
//     of them takes Dh / 2 (96, 128). So warpgroup 1 computes S^T = K Q^T,
//     P^T and dV += P^T dO, and warpgroup 2 dP^T = V dO^T, dS^T = P^T (dP^T -
//     delta) and dK += dS^T Q: each a 64 x 64 score product (m64n64, 32
//     registers) and one m64nDh product from a register A operand (hi + lo),
//     with dO or Q MN-major from the stage, spanning whole 64-column swizzle
//     chunks. (Splitting dK and dV over the head dim instead would start a
//     warpgroup's N at column 96, inside a chunk, and would need P^T and dS^T
//     of all 64 queries in both warpgroups, through shared memory as bf16
//     hi + lo.) P^T goes from warpgroup 1 to 2 in fp32 (exact) through
//     shared memory, in the accumulator's fragment order (element j of
//     thread t at j * 128 + t: both hold the same fragment, so the copy is
//     free of bank conflicts), two buffers deep, on named barriers. Each
//     warpgroup's dV or dK product stays in flight under the next step's
//     score product (wait_group 1), and its stage is freed only then. No step
//     is skipped: the q tiles come from the rows that keep one of these 64
//     keys. Registers a consumer thread: Dh / 2 + 32 + 32 (192 at Dh 256), no
//     spill. Shared memory against 232,448 bytes a block: K and V 2 * 64 * Dh
//     * 2, each (Q, dO) stage 2 * 64 * Dh * 2, P^T 2 * 16 KB, lse and delta
//     512 bytes a stage, 1 KB of alignment: 3 stages at Dh 192 (231,992
//     bytes), 2 at 256 (231,464); a third at 256 would need 297,528.
//     Where a CTA a key tile fills the card less than twice (B * Hkv * tiles
//     < 2 * SMs; 128 CTAs whose causal work runs from 12 to 768 steps at q
//     [2, 12, 4096, 192] over one KV head), the launch makes clusters of two
//     CTAs a key tile: rank r takes steps [r n / 2, (r + 1) n / 2) of the
//     tile's n, and rank 1 hands its dK and dV in fp32 to rank 0 through
//     distributed shared memory (the stages' bytes, after both warpgroups'
//     last products), which adds them to its own, in that order, and writes
//     dk and dv once. The result is the same bit for bit from run to run on
//     one card; the split changes with the SM count. Past that the split
//     only adds its fixed cost a CTA (K and V loaded twice, the hand-over):
//     on an H100, dK/dV 0.091 ms plain against 0.117 split at 288 key tiles
//     of q [2, 8, 1100, 192] over 8 KV heads, 4.20-4.23 against 4.31-4.32 at
//     512 (q [8, 12, 4096, 192] over 1), 4.94-4.95 against 5.00-5.06 at
//     head dim 256; 1.07-1.10 split against 2.08-2.10 plain at 128.
//   * dQ kernel: one CTA of three warpgroups per (head, batch, 128-row q
//     tile), heaviest first under a causal mask, the forward's shape: Q and
//     dO loaded once, K and V tiles streamed through a ring (a barrier each,
//     so S starts when K lands): 64 keys a step and 3 stages at Dh up to
//     128, 2 stages at 192 (Q and dO alone take 96 KB: 197,688 bytes), 32
//     keys and 3 stages at 256 (dQ's 128 registers a thread beside S, dP and
//     the dS operands' 48: 230,480 bytes). Per tile: S = Q K^T and dP = dO
//     V^T from shared memory, P while dP runs, dS hi + lo from registers into
//     dQ += dS K (K MN-major). The dQ product is left in flight under the
//     next tile's S and dP (wait_group 1), and its stage is freed only then.
//     It is the forward kernel with a fixed lse in place of the online
//     softmax, and a second score product.
//   The products the wgmma kernels wait on are a group behind the issue, not
//   every one as in the forward, and the two consumer warpgroups interleave
//   on the tensor cores.
//
// mma variant (PR 30's first tensor-core backward, kept to be timed beside
// it; the rule no longer picks it): bf16, Dh 64 or 128. 4 warps a CTA, each
// owning 16 rows of the 64-row tile it accumulates (keys in dK/dV, queries in
// dQ). Products with mma.sync m16n8k16 (bf16 operands, fp32 accumulators, no
// TF32); operands from shared memory by ldmatrix (.trans where the tile is
// the [k][n] operand); tiles staged by cp.async, double-buffered; rows padded
// by 8 elements so ldmatrix is free of bank conflicts. The K V^T-side
// products are transposed so that each warp holds P^T and dS^T in the
// accumulator layout that feeds the next mma's A operand directly. P enters
// dV as bf16 alone, dS dK and dQ as hi + lo.
//
// simt variant (everything else: fp32, head dims the hopper variant does not
// take, strides TMA cannot take): 256 threads a CTA, 32 x 32 tiles staged as fp32 in
// shared memory (rows padded to an odd stride), every product on fp32 FMA
// lanes, the same loops and the same order. It only has to be right.
//
// The wrapper (kernels/flash_attention.py, flash_bwd_variants) picks the
// variant; none gives way to another, or to a plain version, on failure.

#include <math.h>

#include "hopper.cuh"

namespace {

using hopper::smem_u32;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDh = 256;

struct Bwd {
    const void *q, *k, *v, *o, *dO;
    const float* lse;
    float* delta;
    void *dq, *dk, *dv;
    int B, H, Hkv, Sq, Skv, Dh, group, off, causal, window, q_offset;
    long long qs[3], ks[3], vs[3], os[3], ds[3];  // strides over (b, h, s), in elements
    float scale, scale_log2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
    *dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool kept(const Bwd& a, int qpos, int kpos) {
    return kpos < a.Skv && (!a.causal || kpos <= qpos) && (a.window <= 0 || kpos > qpos - a.window);
}

// Keys [k_begin, k_end) that query rows [i_first, i_last] can keep (the
// forward's KV range).
__device__ __forceinline__ void key_range(const Bwd& a, int i_first, int i_last, int& k_begin,
                                          int& k_end) {
    const int pf = a.q_offset + i_first, pl = a.q_offset + i_last;
    k_begin = a.window > 0 ? max(0, pf - a.window + 1) : 0;
    k_end = a.causal ? min(a.Skv, pl + 1) : a.Skv;
}

// Query rows [i_begin, i_end) that keep some key of [k_first, k_last]: row i
// at pos = q_offset + i keeps one iff pos >= k_first (causal) and pos < k_last
// + window (window > 0).
__device__ __forceinline__ void row_range(const Bwd& a, int k_first, int k_last, int& i_begin,
                                          int& i_end) {
    const long long first = (long long)k_first - a.q_offset;  // can pass 2^31: the sums in 64 bits
    const long long last = (long long)k_last + a.window - a.q_offset;
    i_begin = a.causal ? (int)max(0ll, min(first, (long long)a.Sq)) : 0;
    i_end = a.window > 0 ? (int)max(0ll, min((long long)a.Sq, last)) : a.Sq;
}

// Tiles of ``rows`` covering [begin, end): the first tile and how many.
__device__ __forceinline__ void tiles(int begin, int end, int rows, int& first, int& n) {
    first = max(begin, 0) / rows;
    n = end > begin ? (end - 1) / rows - first + 1 : 0;
}

// Whether a (query tile at i0, key tile at k0) of the given sizes holds a pair
// the mask drops, or a tail: only such tiles test each pair.
__device__ __forceinline__ bool straddles(const Bwd& a, int i0, int nq, int k0, int nk) {
    const int pf = a.q_offset + i0, pl = pf + nq - 1;
    return k0 + nk > a.Skv || i0 + nq > a.Sq || (a.causal && k0 + nk - 1 > pf) ||
           (a.window > 0 && k0 <= pl - a.window);
}

// ======================================================================= delta
// delta[b, h, i] = sum_d dO * O in fp32: one warp a row.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const Bwd a) {
    const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= (long long)a.B * a.H * a.Sq) return;
    const int i = (int)(row % a.Sq);
    const long long bh = row / a.Sq;
    const int h = (int)(bh % a.H), b = (int)(bh / a.H);
    const T* o = static_cast<const T*>(a.o) + b * a.os[0] + h * a.os[1] + i * a.os[2];
    const T* d = static_cast<const T*>(a.dO) + b * a.ds[0] + h * a.ds[1] + i * a.ds[2];
    float sum = 0.0f;
    for (int c = lane; c < a.Dh; c += 32) sum = fmaf(to_f32(o[c]), to_f32(d[c]), sum);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) a.delta[row] = sum;
}

// ========================================================================= mma
// mma.sync kernels, bf16 (see the note).

typedef __nv_bfloat16 bf16;
constexpr int kRows = 64;  // rows of every tile, 16 a warp
constexpr int kMmaThreads = 128;

// 16 bytes global -> shared, zero-filled where ``valid`` is false (no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

// d += a * b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using hopper::pack_bf16;

template <int DH>
struct MmaTiles {
    static constexpr int kPitch = DH + 8;         // elements a row: ldmatrix free of bank conflicts
    static constexpr int kTile = kRows * kPitch;  // elements a tile
    static constexpr int kSmem = 6 * kTile * 2 + 4 * kRows * 4;
};

// Stage rows [r0, r0 + 64) of a [*, DH] bf16 operand (row stride ``ss``) into a
// padded tile; rows at or past ``n_rows`` are zero.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ss, int r0,
                                          int n_rows) {
    constexpr int kChunks = DH / 8;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < kRows * kChunks; e += kMmaThreads) {
        const int r = e / kChunks, c = e % kChunks;
        const bool ok = r0 + r < n_rows;
        cp_async16(dst + r * MmaTiles<DH>::kPitch + c * 8,
                   ok ? src + (long long)(r0 + r) * ss + c * 8 : src, ok);
    }
}

// acc[16 x 64] = A[16 rows of this warp, DH] * B[64 rows, DH]^T, both row-major
// tiles in shared memory: A from ``a_rows`` (this warp's 16 rows), B's rows the
// 64 columns of the result.
template <int DH>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* a_rows, const bf16* b,
                                        int lane) {
    constexpr int P = MmaTiles<DH>::kPitch;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, a_rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t bf[4];
            ldsm_x4(bf, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P + kk * 16 +
                            ((lane >> 3) & 1) * 8);
            mma(acc[2 * np], af, bf[0], bf[1]);
            mma(acc[2 * np + 1], af, bf[2], bf[3]);
        }
    }
}

// The bf16 remainder of x after its own bf16 rounding.
__device__ __forceinline__ float lo_of(float x) {
    return x - __bfloat162float(__float2bfloat16_rn(x));
}

// out[16 x DH] += X[16 x 64] * B[64 rows, DH]: X in registers in the
// accumulator layout, rounded to bf16 here (SPLIT: as hi = bf16(x) plus lo =
// bf16(x - hi), both multiplied into out), B a row-major tile ([k][n]).
template <int DH, bool SPLIT>
__device__ __forceinline__ void mma_xb(float (&out)[DH / 8][4], const float (&x)[8][4],
                                       const bf16* b, int lane) {
    constexpr int P = MmaTiles<DH>::kPitch;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const float(&x0)[4] = x[2 * kk];
        const float(&x1)[4] = x[2 * kk + 1];
        const uint32_t ah[4] = {pack_bf16(x0[0], x0[1]), pack_bf16(x0[2], x0[3]),
                                pack_bf16(x1[0], x1[1]), pack_bf16(x1[2], x1[3])};
        uint32_t al[4] = {0u, 0u, 0u, 0u};
        if (SPLIT) {
            al[0] = pack_bf16(lo_of(x0[0]), lo_of(x0[1]));
            al[1] = pack_bf16(lo_of(x0[2]), lo_of(x0[3]));
            al[2] = pack_bf16(lo_of(x1[0]), lo_of(x1[1]));
            al[3] = pack_bf16(lo_of(x1[2]), lo_of(x1[3]));
        }
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
            uint32_t bf[4];
            ldsm_x4_t(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + dp * 16 +
                              (lane >> 4) * 8);
            mma(out[2 * dp], ah, bf[0], bf[1]);
            mma(out[2 * dp + 1], ah, bf[2], bf[3]);
            if (SPLIT) {
                mma(out[2 * dp], al, bf[0], bf[1]);
                mma(out[2 * dp + 1], al, bf[2], bf[3]);
            }
        }
    }
}

// Write a warp's [16 x DH] fp32 fragment times ``mul`` as bf16 rows r0, r0 + 8
// of a contiguous [n_rows, DH] matrix.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&x)[DH / 8][4], int r0,
                                           int n_rows, float mul, int tig) {
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
        const int col = nt * 8 + 2 * tig;
        if (r0 < n_rows)
            *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r0 * DH + col) =
                __floats2bfloat162_rn(x[nt][0] * mul, x[nt][1] * mul);
        if (r0 + 8 < n_rows)
            *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(r0 + 8) * DH + col) =
                __floats2bfloat162_rn(x[nt][2] * mul, x[nt][3] * mul);
    }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_bwd_dkdv_mma_kernel(const Bwd a) {
    constexpr int P = MmaTiles<DH>::kPitch, T = MmaTiles<DH>::kTile;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + T;
    bf16* Qs = Vs + T;      // [2 stages][T]
    bf16* dOs = Qs + 2 * T;  // [2 stages][T]
    float* lse_s = reinterpret_cast<float*>(dOs + 2 * T);  // [2][64], lse * log2(e)
    float* dl_s = lse_s + 2 * kRows;                       // [2][64], delta

    const int j = blockIdx.y, b = blockIdx.z;
    const int k0 = blockIdx.x * kRows;  // causal: the heavy tiles first
    int i_begin, i_end, qt_first, n_qt;
    row_range(a, k0, min(k0 + kRows, a.Skv) - 1, i_begin, i_end);
    tiles(i_begin, i_end, kRows, qt_first, n_qt);
    const int h_begin = max(0, j * a.group - a.off), h_end = min(a.H, (j + 1) * a.group - a.off);
    const int n_steps = h_end > h_begin ? (h_end - h_begin) * n_qt : 0;

    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0];
    const bf16* db = static_cast<const bf16*>(a.dO) + b * a.ds[0];
    load_tile<DH>(Ks, static_cast<const bf16*>(a.k) + b * a.ks[0] + j * a.ks[1], a.ks[2], k0,
                  a.Skv);
    load_tile<DH>(Vs, static_cast<const bf16*>(a.v) + b * a.vs[0] + j * a.vs[1], a.vs[2], k0,
                  a.Skv);
    // step s: head h_begin + s / n_qt, q tile qt_first + s % n_qt, into stage s & 1
    auto issue = [&](int s) {
        const int h = h_begin + s / n_qt, i0 = (qt_first + s % n_qt) * kRows, st = s & 1;
        load_tile<DH>(Qs + st * T, qb + h * a.qs[1], a.qs[2], i0, a.Sq);
        load_tile<DH>(dOs + st * T, db + h * a.ds[1], a.ds[2], i0, a.Sq);
        if (threadIdx.x < kRows) {
            const int i = i0 + threadIdx.x;
            const long long row = ((long long)b * a.H + h) * a.Sq + i;
            lse_s[st * kRows + threadIdx.x] = i < a.Sq ? a.lse[row] * kLog2e : INFINITY;
            dl_s[st * kRows + threadIdx.x] = i < a.Sq ? a.delta[row] : 0.0f;
        }
    };
    if (n_steps > 0) issue(0);
    cp_async_commit();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane % 4;
    const int kr0 = k0 + 16 * warp + lane / 4;  // this thread's key rows: kr0, kr0 + 8
    const bf16* k_rows = Ks + 16 * warp * P;
    const bf16* v_rows = Vs + 16 * warp * P;
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

    for (int s = 0; s < n_steps; ++s) {
        if (s + 1 < n_steps) {
            issue(s + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int st = s & 1, i0 = (qt_first + s % n_qt) * kRows;
        const bf16* Qt = Qs + st * T;
        const bf16* dOt = dOs + st * T;
        const float* lse_t = lse_s + st * kRows;
        const float* dl_t = dl_s + st * kRows;

        // P^T = exp2(K Q^T * scale log2(e) - lse log2(e)), 0 where masked
        float pt[8][4];
        mma_abt<DH>(pt, k_rows, Qt, lane);
        const bool mask = straddles(a, i0, kRows, k0, kRows);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = nt * 8 + 2 * tig + (e & 1);
                const float x = exp2f(pt[nt][e] * a.scale_log2 - lse_t[col]);
                const bool drop = mask && !kept(a, a.q_offset + i0 + col, kr0 + 8 * (e >> 1));
                pt[nt][e] = drop ? 0.0f : x;
            }
        mma_xb<DH, false>(dv, pt, dOt, lane);  // dV += P^T dO

        // dS^T = P^T (V dO^T - delta)
        float dst[8][4];
        mma_abt<DH>(dst, v_rows, dOt, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dst[nt][e] = pt[nt][e] * (dst[nt][e] - dl_t[nt * 8 + 2 * tig + (e & 1)]);
        mma_xb<DH, true>(dk, dst, Qt, lane);  // dK += dS^T Q (scaled at the end)
        __syncthreads();                // the next step's loads reuse this stage
    }
    cp_async_wait<0>();

    const size_t base = ((size_t)b * a.Hkv + j) * (size_t)a.Skv * DH;
    store_rows<DH>(static_cast<bf16*>(a.dk) + base, dk, kr0, a.Skv, a.scale, tig);
    store_rows<DH>(static_cast<bf16*>(a.dv) + base, dv, kr0, a.Skv, 1.0f, tig);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_bwd_dq_mma_kernel(const Bwd a) {
    constexpr int P = MmaTiles<DH>::kPitch, T = MmaTiles<DH>::kTile;
    extern __shared__ __align__(16) uint8_t smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* dOs = Qs + T;
    bf16* Ks = dOs + T;     // [2 stages][T]
    bf16* Vs = Ks + 2 * T;  // [2 stages][T]

    const int h = blockIdx.x, b = blockIdx.y;
    const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
    const int i0 = qt * kRows;
    int k_begin, k_end, t_first, n_tiles;
    key_range(a, i0, min(i0 + kRows, a.Sq) - 1, k_begin, k_end);
    tiles(k_begin, k_end, kRows, t_first, n_tiles);
    const int hk = (h + a.off) / a.group;

    load_tile<DH>(Qs, static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1], a.qs[2], i0, a.Sq);
    load_tile<DH>(dOs, static_cast<const bf16*>(a.dO) + b * a.ds[0] + h * a.ds[1], a.ds[2], i0,
                  a.Sq);
    const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
    const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
    auto issue = [&](int t) {
        const int k0 = (t_first + t) * kRows, st = t & 1;
        load_tile<DH>(Ks + st * T, kb, a.ks[2], k0, a.Skv);
        load_tile<DH>(Vs + st * T, vb, a.vs[2], k0, a.Skv);
    };
    if (n_tiles > 0) issue(0);
    cp_async_commit();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane % 4;
    const int r0 = i0 + 16 * warp + lane / 4;  // this thread's query rows: r0, r0 + 8
    float lse2[2], dl[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int i = r0 + 8 * u;
        const long long row = ((long long)b * a.H + h) * a.Sq + i;
        lse2[u] = i < a.Sq ? a.lse[row] * kLog2e : INFINITY;
        dl[u] = i < a.Sq ? a.delta[row] : 0.0f;
    }
    const bf16* q_rows = Qs + 16 * warp * P;
    const bf16* do_rows = dOs + 16 * warp * P;
    float dq[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

    for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            issue(t + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = (t_first + t) * kRows;
        const bf16* Kt = Ks + (t & 1) * T;
        const bf16* Vt = Vs + (t & 1) * T;

        float p[8][4];
        mma_abt<DH>(p, q_rows, Kt, lane);  // S = Q K^T
        const bool mask = straddles(a, i0, kRows, k0, kRows);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int u = e >> 1;
                const float x = exp2f(p[nt][e] * a.scale_log2 - lse2[u]);
                p[nt][e] = (mask && !kept(a, a.q_offset + r0 + 8 * u,
                                          k0 + nt * 8 + 2 * tig + (e & 1))) ? 0.0f : x;
            }
        float ds[8][4];
        mma_abt<DH>(ds, do_rows, Vt, lane);  // dP = dO V^T
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) ds[nt][e] = p[nt][e] * (ds[nt][e] - dl[e >> 1]);
        mma_xb<DH, true>(dq, ds, Kt, lane);  // dQ += dS K (scaled at the end)
        __syncthreads();               // the next tile's loads reuse this stage
    }
    cp_async_wait<0>();
    store_rows<DH>(static_cast<bf16*>(a.dq) + ((size_t)b * a.H + h) * (size_t)a.Sq * DH, dq, r0,
                   a.Sq, a.scale, tig);
}

// ====================================================================== hopper
// wgmma + TMA kernels, bf16 (see the note).

namespace wgk {

using namespace hopper;

constexpr int kThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kQStep = 64;     // dK/dV: query rows a step
constexpr int kRowsQ = 128;    // dQ: query rows a CTA, 64 a consumer warpgroup
constexpr int kBarPFull = 1;   // dK/dV at DHP 192, 256: named barriers of the P^T hand-over,
constexpr int kBarPEmpty = 3;  // + the buffer (0, 1),
constexpr int kBarDone = 5;    // and of both consumer warpgroups' last product

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {  // the 128-byte swizzle's period
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                      ~static_cast<uintptr_t>(1023));
}

// The fragment of a thread in an m64nN accumulator: element j sits at row
// r_lo + 8 * hi(j) of the warpgroup's 64 and column 8 * (j / 4) + 2 * (lane
// % 4) + (j & 1).
__device__ __forceinline__ int frag_hi(int j) { return (j >> 1) & 1; }
__device__ __forceinline__ int frag_col(int j, int col_lane) {
    return 8 * (j >> 2) + col_lane + (j & 1);
}

// The pair (x0, x1) of a fragment (p, or ds = p (dp - delta)) as two packed
// bf16 terms, hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
    const float2 back = __bfloat1622float2(h2);
    const __nv_bfloat162 l2 = __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
    hi = *reinterpret_cast<const uint32_t*>(&h2);
    lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// A warpgroup's [64 x DHP] fp32 fragment times ``mul`` as bf16 rows of a
// contiguous [n_rows, Dh] matrix from ``row0``: this thread's rows r and r + 8
// (r = row0 + r_lo), columns below Dh.
template <int DHP>
__device__ __forceinline__ void store_frag(bf16* dst, const float (&x)[DHP / 2], int r, int n_rows,
                                           int Dh, float mul, int col_lane) {
#pragma unroll
    for (int j = 0; j < DHP / 2; j += 2) {
        const int row = r + 8 * frag_hi(j), col = frag_col(j, col_lane);
        if (row < n_rows && col < Dh)
            *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * Dh + col) =
                __floats2bfloat162_rn(x[j] * mul, x[j + 1] * mul);
    }
}

// The dK/dV kernel's tiles. DHP 64 and 128: 128 keys a CTA, 64 a consumer
// warpgroup. DHP 192 and 256 (kByGrad): 64 keys a CTA, one warpgroup's dV and
// the other's dK, with P^T handed between them through a double buffer.
template <int DHP>
struct DkdvTiles {
    static constexpr bool kByGrad = DHP > 128;
    static constexpr int kKeys = kByGrad ? 64 : 128;
    static constexpr int kStages = DHP == 256 ? 2 : 3;   // the (Q, dO) ring
    static constexpr int kChunks = DHP / 64;             // 64-column chunks, 128-byte rows
    static constexpr int kKVBytes = kKeys * DHP * 2;     // the K tile; V's the same
    static constexpr int kQBytes = kQStep * DHP * 2;     // one Q or dO tile
    static constexpr int kStageBytes = 2 * kQBytes;      // Q, then dO
    static constexpr int kVecFloats = 2 * kQStep;        // lse * log2(e), then delta
    static constexpr int kPBytes = kByGrad ? 2 * 64 * kQStep * 4 : 0;  // P^T, fp32, 2 buffers
    static constexpr int kSmem = 2 * kKVBytes + kStages * (kStageBytes + kVecFloats * 4) + kPBytes +
                                 1024 + 8 * (1 + 2 * kStages);
    static_assert(kSmem <= 232448, "past a block's shared memory");
};

// dK/dV, DHP 64 and 128, consumer warpgroup cw (keys 64 * cw .. of the tile):
// dK and dV of its 64 keys in registers; S^T, dP^T from shared memory, P^T
// and dS^T the register A operands of dV and dK.
template <int DHP>
__device__ __forceinline__ void dkdv_by_keys(const Bwd& a, uint8_t* Ks, uint8_t* Vs, uint8_t* Qs,
                                             const float* vec, uint64_t* full_kv, uint64_t* full,
                                             uint64_t* empty, int k0, int hk, int b, int n_steps,
                                             int qt_first, int n_qt, int cw) {
    using T = DkdvTiles<DHP>;
    const int t = threadIdx.x - 128 * (cw + 1);
    const int warp = t / 32, lane = t % 32;
    const int r_lo = 16 * warp + lane / 4, col_lane = 2 * (lane % 4);
    const int kw0 = k0 + 64 * cw;  // this warpgroup's first key
    const int key0 = kw0 + r_lo;   // this thread's keys: key0, key0 + 8
    const uint32_t k_addr = smem_u32(Ks) + cw * 64 * 128;
    const uint32_t v_addr = smem_u32(Vs) + cw * 64 * 128;
    float dk[DHP / 2], dv[DHP / 2], sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < DHP / 2; ++j) dk[j] = dv[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
    mbar_wait(full_kv, 0);

    for (int i = 0; i < n_steps; ++i) {
        const int st = i % T::kStages;
        const int i0 = (qt_first + i % n_qt) * kQStep;
        mbar_wait(&full[st], (i / T::kStages) & 1);
        int kb, ke;  // the keys this step's rows can keep
        key_range(a, i0, min(i0 + kQStep, a.Sq) - 1, kb, ke);
        if (!(kw0 < a.Skv && kw0 < ke && kw0 + 64 > kb)) {  // the mask removes it whole
            mbar_arrive(&empty[st]);
            continue;
        }
        const uint32_t q_addr = smem_u32(Qs + st * T::kStageBytes);
        const uint32_t do_addr = q_addr + T::kQBytes;
        const float* lse2 = vec + st * T::kVecFloats;
        const float* dlt = lse2 + kQStep;

        // S^T = K Q^T, then dP^T = V dO^T: both operands K-major over Dh
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
            const uint32_t off = (kk / 4) * T::kKeys * 128 + (kk % 4) * 32;
            const uint32_t qoff = (kk / 4) * kQStep * 128 + (kk % 4) * 32;
            wgmma_ss(sc, desc_sw128(k_addr + off, 16, 1024), desc_sw128(q_addr + qoff, 16, 1024),
                     kk > 0);
        }
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
            const uint32_t off = (kk / 4) * T::kKeys * 128 + (kk % 4) * 32;
            const uint32_t qoff = (kk / 4) * kQStep * 128 + (kk % 4) * 32;
            wgmma_ss(dp, desc_sw128(v_addr + off, 16, 1024),
                     desc_sw128(do_addr + qoff, 16, 1024), kk > 0);
        }
        wg_commit();

        // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked, while
        // dP^T runs
        wg_wait<1>();
        fence_regs(sc);
        const bool mask = straddles(a, i0, kQStep, kw0, 64);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = frag_col(j, col_lane);
            const float x = exp2f(sc[j] * a.scale_log2 - lse2[c]);
            sc[j] = (mask && !kept(a, a.q_offset + i0 + c, key0 + 8 * frag_hi(j))) ? 0.0f : x;
        }
        // dS^T = P^T (dP^T - delta); P^T and dS^T as bf16 hi + lo pairs in
        // the accumulator's fragment layout, the A operand's
        wg_wait<0>();
        fence_regs(dp);
        uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
            const int c = frag_col(j, col_lane);
            split_pair(sc[j] * (dp[j] - dlt[c]), sc[j + 1] * (dp[j + 1] - dlt[c + 1]),
                       dh[j / 2], dl[j / 2]);
            split_pair(sc[j], sc[j + 1], ph[j / 2], pl[j / 2]);
        }

        // dV += P^T dO and dK += dS^T Q (hi, then lo), the A operand from
        // registers, dO and Q MN-major (the transpose bit) from the stage
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dd = desc_sw128(do_addr + kk * 16 * 128, kQStep * 128, 1024);
            const uint32_t ha[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
            const uint32_t la[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
            wgmma_rs(dv, ha, dd);
            wgmma_rs(dv, la, dd);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t qd = desc_sw128(q_addr + kk * 16 * 128, kQStep * 128, 1024);
            const uint32_t ha[4] = {dh[4 * kk], dh[4 * kk + 1], dh[4 * kk + 2], dh[4 * kk + 3]};
            const uint32_t la[4] = {dl[4 * kk], dl[4 * kk + 1], dl[4 * kk + 2], dl[4 * kk + 3]};
            wgmma_rs(dk, ha, qd);
            wgmma_rs(dk, la, qd);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(ph);
        fence_regs(pl);
        fence_regs(dh);
        fence_regs(dl);
        mbar_arrive(&empty[st]);
    }

    const size_t base = ((size_t)b * a.Hkv + hk) * (size_t)a.Skv * a.Dh;
    store_frag<DHP>(static_cast<bf16*>(a.dk) + base, dk, key0, a.Skv, a.Dh, a.scale, col_lane);
    store_frag<DHP>(static_cast<bf16*>(a.dv) + base, dv, key0, a.Skv, a.Dh, 1.0f, col_lane);
}

// dK/dV, DHP 192 and 256, the tile's 64 keys: consumer warpgroup 1 (``dv``)
// computes S^T = K Q^T, P^T and dV += P^T dO; warpgroup 2 dP^T = V dO^T, dS^T
// = P^T (dP^T - delta) and dK += dS^T Q. P^T goes from 1 to 2 in fp32 through
// shared memory, in the accumulator's fragment order (element j of thread t
// at j * 128 + t: both warpgroups hold the same fragment), two buffers deep.
// Each warpgroup's dV or dK product stays in flight under the next step's
// score product, and its stage is freed only then.
template <int DHP>
__device__ __forceinline__ void dkdv_by_grad(const Bwd& a, uint8_t* Ks, uint8_t* Vs, uint8_t* Qs,
                                             const float* vec, float* Ps, uint64_t* full_kv,
                                             uint64_t* full, uint64_t* empty, int k0, int hk,
                                             int b, int step0, int n_steps, int qt_first,
                                             int n_qt, bool dv_role, int split, int rank) {
    using T = DkdvTiles<DHP>;
    const int t = threadIdx.x - (dv_role ? 128 : 256);
    const int warp = t / 32, lane = t % 32;
    const int r_lo = 16 * warp + lane / 4, col_lane = 2 * (lane % 4);
    const int key0 = k0 + r_lo;  // this thread's keys: key0, key0 + 8
    const uint32_t a_addr = smem_u32(dv_role ? Ks : Vs);
    float acc[DHP / 2], x[32];
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int j = 0; j < DHP / 2; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) hi[j] = lo[j] = 0u;
    int pend = -1;  // the stage the in-flight dV or dK product reads
    mbar_wait(full_kv, 0);

    // every step keeps a pair of the tile's keys (the q tiles come from
    // row_range over exactly these 64 keys): no step is skipped
    for (int i = 0; i < n_steps; ++i) {
        const int st = i % T::kStages;
        const int i0 = (qt_first + (step0 + i) % n_qt) * kQStep;
        mbar_wait(&full[st], (i / T::kStages) & 1);
        const uint32_t q_addr = smem_u32(Qs + st * T::kStageBytes);
        const uint32_t do_addr = q_addr + T::kQBytes;
        const float* lse2 = vec + st * T::kVecFloats;
        const float* dlt = lse2 + kQStep;

        // S^T = K Q^T or dP^T = V dO^T: both operands K-major over Dh
        const uint32_t b_addr = dv_role ? q_addr : do_addr;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
            const uint32_t in_row = (kk % 4) * 32;
            wgmma_ss(x, desc_sw128(a_addr + (kk / 4) * T::kKeys * 128 + in_row, 16, 1024),
                     desc_sw128(b_addr + (kk / 4) * kQStep * 128 + in_row, 16, 1024), kk > 0);
        }
        wg_commit();

        // the previous step's dV or dK product is done: free its stage
        wg_wait<1>();
        if (pend >= 0) {
            fence_regs(acc);
            fence_regs(hi);
            fence_regs(lo);
            mbar_arrive(&empty[pend]);
        }
        wg_wait<0>();
        fence_regs(x);

        float* pbuf = Ps + (i & 1) * 32 * 128 + t;
        if (dv_role) {
            // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked
            const bool mask = straddles(a, i0, kQStep, k0, 64);
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                const int c = frag_col(j, col_lane);
                const float p = exp2f(x[j] * a.scale_log2 - lse2[c]);
                x[j] = (mask && !kept(a, a.q_offset + i0 + c, key0 + 8 * frag_hi(j))) ? 0.0f : p;
            }
            if (i >= 2) bar_sync(kBarPEmpty + (i & 1), 256);  // step i - 2's reader is done
#pragma unroll
            for (int j = 0; j < 32; ++j) pbuf[j * 128] = x[j];
            bar_arrive(kBarPFull + (i & 1), 256);
        } else {
            // dS^T = P^T (dP^T - delta)
            bar_sync(kBarPFull + (i & 1), 256);
#pragma unroll
            for (int j = 0; j < 32; ++j) x[j] = pbuf[j * 128] * (x[j] - dlt[frag_col(j, col_lane)]);
            bar_arrive(kBarPEmpty + (i & 1), 256);
        }
#pragma unroll
        for (int j = 0; j < 32; j += 2) split_pair(x[j], x[j + 1], hi[j / 2], lo[j / 2]);

        // dV += P^T dO or dK += dS^T Q (hi, then lo): the A operand from
        // registers, dO or Q MN-major from the stage
        const uint32_t m_addr = dv_role ? do_addr : q_addr;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t md = desc_sw128(m_addr + kk * 16 * 128, kQStep * 128, 1024);
            const uint32_t ha[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
            const uint32_t la[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
            wgmma_rs(acc, ha, md);
            wgmma_rs(acc, la, md);
        }
        wg_commit();
        pend = st;
    }
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    if (dv_role)  // take the last two hand-overs' arrivals: no barrier is left half done
        for (int i = max(0, n_steps - 2); i < n_steps; ++i) bar_sync(kBarPEmpty + (i & 1), 256);
    if (split > 1) {
        // rank 1's share of dV and dK goes to rank 0 through distributed
        // shared memory, in the stages' bytes (every product that read them
        // is done), and rank 0 adds it to its own: one fixed order
        bar_sync(kBarDone, 256);
        float* part = reinterpret_cast<float*>(Qs) + (dv_role ? 0 : DHP / 2 * 128) + t;
        if (rank == 1) {
#pragma unroll
            for (int j = 0; j < DHP / 2; ++j) part[j * 128] = acc[j];
        }
        cluster_sync();
        if (rank == 0) {
#pragma unroll
            for (int j = 0; j < DHP / 2; ++j) acc[j] += ld_peer(part + j * 128, 1);
        }
        cluster_sync();  // rank 1's shared memory stays until rank 0 has read it
        if (rank != 0) return;
    }

    const size_t base = ((size_t)b * a.Hkv + hk) * (size_t)a.Skv * a.Dh;
    store_frag<DHP>(static_cast<bf16*>(dv_role ? a.dv : a.dk) + base, acc, key0, a.Skv, a.Dh,
                    dv_role ? 1.0f : a.scale, col_lane);
}

// dK, dV: one CTA per (KV head, batch, key tile); see the note.
template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Bwd a) {
    using T = DkdvTiles<DHP>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* Ks = align1024(smem_raw);      // [chunk][keys][128 bytes]
    uint8_t* Vs = Ks + T::kKVBytes;
    uint8_t* Qs = Vs + T::kKVBytes;         // [stage][Q tile, dO tile], each [chunk][64][128 B]
    float* Ps = reinterpret_cast<float*>(Qs + T::kStages * T::kStageBytes);  // [2][32][128]
    float* vec = Ps + T::kPBytes / 4;       // [stage][lse2, delta]
    uint64_t* full_kv = reinterpret_cast<uint64_t*>(vec + T::kStages * T::kVecFloats);
    uint64_t* full = full_kv + 1;
    uint64_t* empty = full + T::kStages;

    // DHP 192, 256: a cluster of ``split`` CTAs (1 or 2, the launch's pick)
    // shares a key tile, each taking a contiguous share of its steps
    int split = 1, rank = 0;
    if constexpr (T::kByGrad) {
        split = (int)cluster_size();
        rank = (int)cluster_rank();
    }
    const int hk = blockIdx.x / split, b = blockIdx.y;
    const int k0 = blockIdx.z * T::kKeys;  // causal: the heavy tiles launch first
    int i_begin, i_end, qt_first, n_qt;
    row_range(a, k0, min(k0 + T::kKeys, a.Skv) - 1, i_begin, i_end);
    tiles(i_begin, i_end, kQStep, qt_first, n_qt);
    const int h_begin = max(0, hk * a.group - a.off);
    const int h_end = min(a.H, (hk + 1) * a.group - a.off);
    const int n_all = h_end > h_begin ? (h_end - h_begin) * n_qt : 0;
    const int step0 = n_all * rank / split;  // this CTA's steps: [step0, step0 + n_steps)
    const int n_steps = n_all * (rank + 1) / split - step0;

    if (threadIdx.x == 0) {
        mbar_init(full_kv, 1);
        for (int s = 0; s < T::kStages; ++s) {
            mbar_init(&full[s], 1 + 32);  // the TMA thread's arrival and warp 1's 32
            mbar_init(&empty[s], 2 * 128);  // every consumer thread arrives
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---------------------------------------------------------- producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        if (threadIdx.x == 0) {  // every TMA load
            mbar_expect_tx(full_kv, 2 * T::kKVBytes);
            for (int c = 0; c < T::kChunks; ++c) {
                tma_load_4d(Ks + c * T::kKeys * 128, &tk, full_kv, c * 64, k0, hk, b);
                tma_load_4d(Vs + c * T::kKeys * 128, &tv, full_kv, c * 64, k0, hk, b);
            }
            for (int i = 0; i < n_steps; ++i) {
                const int st = i % T::kStages, s = step0 + i;
                mbar_wait(&empty[st], ((i / T::kStages) & 1) ^ 1);
                const int h = h_begin + s / n_qt, i0 = (qt_first + s % n_qt) * kQStep;
                uint8_t* qd = Qs + st * T::kStageBytes;
                mbar_expect_tx(&full[st], T::kStageBytes);
                for (int c = 0; c < T::kChunks; ++c) {
                    tma_load_4d(qd + c * kQStep * 128, &tq, &full[st], c * 64, i0, h, b);
                    tma_load_4d(qd + T::kQBytes + c * kQStep * 128, &tdo, &full[st], c * 64, i0,
                                h, b);
                }
            }
        } else if (warp == 1) {  // each step's lse (log2 domain) and delta rows
            for (int i = 0; i < n_steps; ++i) {
                const int st = i % T::kStages, s = step0 + i;
                mbar_wait(&empty[st], ((i / T::kStages) & 1) ^ 1);
                const int h = h_begin + s / n_qt, i0 = (qt_first + s % n_qt) * kQStep;
                float* v = vec + st * T::kVecFloats;
                const long long base = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int r = lane + 32 * u, row = i0 + r;
                    v[r] = row < a.Sq ? a.lse[base + row] * kLog2e : INFINITY;
                    v[kQStep + r] = row < a.Sq ? a.delta[base + row] : 0.0f;
                }
                mbar_arrive(&full[st]);
            }
        }
        if (split > 1) {  // the consumers' two cluster barriers
            cluster_sync();
            cluster_sync();
        }
    } else {
        // --------------------------------------------------------- consumers
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        if constexpr (T::kByGrad)
            dkdv_by_grad<DHP>(a, Ks, Vs, Qs, vec, Ps, full_kv, full, empty, k0, hk, b, step0,
                              n_steps, qt_first, n_qt, wg == 1, split, rank);
        else
            dkdv_by_keys<DHP>(a, Ks, Vs, Qs, vec, full_kv, full, empty, k0, hk, b, n_steps,
                              qt_first, n_qt, wg - 1);
    }
}

// The dQ kernel's tiles: 128 query rows a CTA, keys streamed in steps of
// kKStep through a ring of kStages (DHP 192: 2 stages, as Q and dO alone take
// 96 KB; DHP 256: 32-key steps, so that dQ's 128 registers a thread and the
// score products' 48 fit).
template <int DHP>
struct DqTiles {
    static constexpr int kKStep = DHP == 256 ? 32 : 64;
    static constexpr int kStages = DHP == 192 ? 2 : 3;
    static constexpr int kChunks = DHP / 64;
    static constexpr int kQBytes = kRowsQ * DHP * 2;     // the Q tile; dO's the same
    static constexpr int kKVBytes = kKStep * DHP * 2;    // one K or V tile
    static constexpr int kStageBytes = 2 * kKVBytes;     // K, then V
    static constexpr int kSmem = 2 * kQBytes + kStages * kStageBytes + 1024 + 8 * (1 + 3 * kStages);
    static_assert(kSmem <= 232448, "past a block's shared memory");
};

// dQ: one CTA per (head, batch, 128-row q tile); see the note.
template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Bwd a) {
    using T = DqTiles<DHP>;
    constexpr int KS = T::kKStep, NS = T::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* Qs = align1024(smem_raw);  // [chunk][128 rows][128 bytes]
    uint8_t* dOs = Qs + T::kQBytes;
    uint8_t* KVs = dOs + T::kQBytes;    // [stage][K tile, V tile], each [chunk][KS][128 B]
    uint64_t* full_q = reinterpret_cast<uint64_t*>(KVs + NS * T::kStageBytes);
    uint64_t* full_k = full_q + 1;
    uint64_t* full_v = full_k + NS;
    uint64_t* empty = full_v + NS;

    const int h = blockIdx.x, b = blockIdx.y;
    const int qt = a.causal ? (int)gridDim.z - 1 - (int)blockIdx.z : (int)blockIdx.z;  // heaviest first
    const int q0 = qt * kRowsQ;
    int k_begin, k_end, t_first, n_tiles;
    key_range(a, q0, min(q0 + kRowsQ, a.Sq) - 1, k_begin, k_end);
    tiles(k_begin, k_end, KS, t_first, n_tiles);

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int s = 0; s < NS; ++s) {
            mbar_init(&full_k[s], 1);
            mbar_init(&full_v[s], 1);
            mbar_init(&empty[s], 2 * 128);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---------------------------------------------------------- producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            const int hk = (h + a.off) / a.group;
            mbar_expect_tx(full_q, 2 * T::kQBytes);
            for (int c = 0; c < T::kChunks; ++c) {
                tma_load_4d(Qs + c * kRowsQ * 128, &tq, full_q, c * 64, q0, h, b);
                tma_load_4d(dOs + c * kRowsQ * 128, &tdo, full_q, c * 64, q0, h, b);
            }
            for (int i = 0; i < n_tiles; ++i) {
                const int st = i % NS;
                mbar_wait(&empty[st], ((i / NS) & 1) ^ 1);
                const int kt0 = (t_first + i) * KS;
                uint8_t* kd = KVs + st * T::kStageBytes;
                mbar_expect_tx(&full_k[st], T::kKVBytes);
                for (int c = 0; c < T::kChunks; ++c)
                    tma_load_4d(kd + c * KS * 128, &tk, &full_k[st], c * 64, kt0, hk, b);
                mbar_expect_tx(&full_v[st], T::kKVBytes);
                for (int c = 0; c < T::kChunks; ++c)
                    tma_load_4d(kd + T::kKVBytes + c * KS * 128, &tv, &full_v[st], c * 64, kt0,
                                hk, b);
            }
        }
    } else {
        // --------------------------------------------------------- consumers
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int cw = wg - 1;  // rows 64 * cw .. of the q tile
        const int t = threadIdx.x - 128 * wg;
        const int warp = t / 32, lane = t % 32;
        const int r_lo = 16 * warp + lane / 4, col_lane = 2 * (lane % 4);
        const int rw0 = q0 + 64 * cw;   // this warpgroup's first row
        const int row0 = rw0 + r_lo;    // this thread's rows: row0, row0 + 8
        float lse2[2], dlt[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int i = row0 + 8 * u;
            const long long row = ((long long)b * a.H + h) * a.Sq + i;
            lse2[u] = i < a.Sq ? a.lse[row] * kLog2e : INFINITY;
            dlt[u] = i < a.Sq ? a.delta[row] : 0.0f;
        }
        int kb = 0, ke = 0;  // the keys this warpgroup's rows can keep
        if (rw0 < a.Sq) key_range(a, rw0, min(rw0 + 64, a.Sq) - 1, kb, ke);
        const uint32_t q_addr = smem_u32(Qs) + cw * 64 * 128;
        const uint32_t do_addr = smem_u32(dOs) + cw * 64 * 128;
        float dq[DHP / 2], sc[KS / 2], dp[KS / 2];
        uint32_t dh[KS / 4], dl[KS / 4];
#pragma unroll
        for (int j = 0; j < DHP / 2; ++j) dq[j] = 0.0f;
#pragma unroll
        for (int j = 0; j < KS / 2; ++j) sc[j] = dp[j] = 0.0f;
#pragma unroll
        for (int j = 0; j < KS / 4; ++j) dh[j] = dl[j] = 0u;
        int pend = -1;  // the stage the in-flight dQ product reads
        mbar_wait(full_q, 0);

        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % NS;
            const uint32_t parity = (i / NS) & 1;
            const int kt0 = (t_first + i) * KS;
            if (!(kt0 < ke && kt0 + KS > kb)) {  // the mask removes it whole
                mbar_wait(&full_k[st], parity);
                mbar_wait(&full_v[st], parity);
                if (pend >= 0) {
                    wg_wait<0>();
                    fence_regs(dq);
                    fence_regs(dh);
                    fence_regs(dl);
                    mbar_arrive(&empty[pend]);
                    pend = -1;
                }
                mbar_arrive(&empty[st]);
                continue;
            }
            const uint32_t k_addr = smem_u32(KVs + st * T::kStageBytes);
            const uint32_t v_addr = k_addr + T::kKVBytes;

            // S = Q K^T, then dP = dO V^T: both operands K-major over Dh
            mbar_wait(&full_k[st], parity);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < DHP / 16; ++kk) {
                const uint32_t in_row = (kk % 4) * 32;
                wgmma_ss(sc, desc_sw128(q_addr + (kk / 4) * kRowsQ * 128 + in_row, 16, 1024),
                         desc_sw128(k_addr + (kk / 4) * KS * 128 + in_row, 16, 1024), kk > 0);
            }
            wg_commit();
            mbar_wait(&full_v[st], parity);
#pragma unroll
            for (int kk = 0; kk < DHP / 16; ++kk) {
                const uint32_t in_row = (kk % 4) * 32;
                wgmma_ss(dp, desc_sw128(do_addr + (kk / 4) * kRowsQ * 128 + in_row, 16, 1024),
                         desc_sw128(v_addr + (kk / 4) * KS * 128 + in_row, 16, 1024), kk > 0);
            }
            wg_commit();

            // the previous tile's dQ product and S are done: free its stage
            wg_wait<1>();
            fence_regs(sc);
            if (pend >= 0) {
                fence_regs(dh);
                fence_regs(dl);
                mbar_arrive(&empty[pend]);
            }

            // P = exp2(S scale log2(e) - lse log2(e)), 0 where masked, while dP runs
            const bool mask = straddles(a, rw0, 64, kt0, KS);
#pragma unroll
            for (int j = 0; j < KS / 2; ++j) {
                const int u = frag_hi(j);
                const float x = exp2f(sc[j] * a.scale_log2 - lse2[u]);
                sc[j] = (mask && !kept(a, a.q_offset + row0 + 8 * u, kt0 + frag_col(j, col_lane)))
                            ? 0.0f : x;
            }

            // dS = P (dP - delta) as bf16 hi + lo
            wg_wait<0>();
            fence_regs(dp);
#pragma unroll
            for (int j = 0; j < KS / 2; j += 2) {
                const float d = dlt[frag_hi(j)];
                split_pair(sc[j] * (dp[j] - d), sc[j + 1] * (dp[j + 1] - d), dh[j / 2], dl[j / 2]);
            }

            // dQ += dS K (hi, then lo): K MN-major; left in flight under the
            // next tile's S and dP
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < KS / 16; ++kk) {
                const uint64_t kd = desc_sw128(k_addr + kk * 16 * 128, KS * 128, 1024);
                const uint32_t ha[4] = {dh[4 * kk], dh[4 * kk + 1], dh[4 * kk + 2], dh[4 * kk + 3]};
                const uint32_t la[4] = {dl[4 * kk], dl[4 * kk + 1], dl[4 * kk + 2], dl[4 * kk + 3]};
                wgmma_rs(dq, ha, kd);
                wgmma_rs(dq, la, kd);
            }
            wg_commit();
            pend = st;
        }
        wg_wait<0>();
        fence_regs(dq);
        fence_regs(dh);
        fence_regs(dl);
        store_frag<DHP>(static_cast<bf16*>(a.dq) + ((size_t)b * a.H + h) * (size_t)a.Sq * a.Dh, dq,
                        row0, a.Sq, a.Dh, a.scale, col_lane);
    }
}

}  // namespace wgk

// ======================================================================== SIMT
// fp32 FMA kernels for everything else (see the note).

constexpr int kSimtThreads = 256;
constexpr int kSB = 32;         // rows of every tile
constexpr int kLdP = kSB + 1;   // P and dS rows

// Stage rows [r0, r0 + 32) of a [*, Dh] operand into shared memory as fp32
// [32][ld]; rows at or past ``n_rows`` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long long ss, int r0,
                                      int n_rows, int Dh, int ld) {
    for (int e = threadIdx.x; e < kSB * Dh; e += kSimtThreads) {
        const int r = e / Dh, d = e - r * Dh;
        dst[r * ld + d] = (r0 + r < n_rows) ? to_f32(src[(long long)(r0 + r) * ss + d]) : 0.0f;
    }
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads) flash_bwd_dkdv_simt_kernel(const Bwd a) {
    extern __shared__ float smem[];
    const int Dh = a.Dh, ld = Dh | 1, nc = (Dh + 15) >> 4;
    float* Ks = smem;             // [32][ld]
    float* Vs = Ks + kSB * ld;
    float* Qs = Vs + kSB * ld;
    float* dOs = Qs + kSB * ld;
    float* Ps = dOs + kSB * ld;   // [32 keys][33]
    float* dSs = Ps + kSB * kLdP;
    float* lse_s = dSs + kSB * kLdP;  // [32]
    float* dl_s = lse_s + kSB;        // [32]

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int j = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kSB;
    int i_begin, i_end, qt_first, n_qt;
    row_range(a, k0, min(k0 + kSB, a.Skv) - 1, i_begin, i_end);
    tiles(i_begin, i_end, kSB, qt_first, n_qt);
    const int h_begin = max(0, j * a.group - a.off), h_end = min(a.H, (j + 1) * a.group - a.off);
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0];
    const T* db = static_cast<const T*>(a.dO) + b * a.ds[0];
    stage(Ks, static_cast<const T*>(a.k) + b * a.ks[0] + j * a.ks[1], a.ks[2], k0, a.Skv, Dh, ld);
    stage(Vs, static_cast<const T*>(a.v) + b * a.vs[0] + j * a.vs[1], a.vs[2], k0, a.Skv, Dh, ld);

    float dk[2][kMaxDh / 16], dv[2][kMaxDh / 16];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < kMaxDh / 16; ++c) dk[u][c] = dv[u][c] = 0.0f;

    for (int h = h_begin; h < h_end; ++h) {
        for (int qt = qt_first; qt < qt_first + n_qt; ++qt) {
            const int i0 = qt * kSB;
            __syncthreads();  // the previous step's readers are done
            stage(Qs, qb + h * a.qs[1], a.qs[2], i0, a.Sq, Dh, ld);
            stage(dOs, db + h * a.ds[1], a.ds[2], i0, a.Sq, Dh, ld);
            if (tid < kSB) {
                const long long row = ((long long)b * a.H + h) * a.Sq + i0 + tid;
                lse_s[tid] = i0 + tid < a.Sq ? a.lse[row] : INFINITY;
                dl_s[tid] = i0 + tid < a.Sq ? a.delta[row] : 0.0f;
            }
            __syncthreads();
            // S^T and dP^T at keys ty + 16u, queries tx + 16w
            float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
            for (int d = 0; d < Dh; ++d) {
                const float k_0 = Ks[ty * ld + d], k_1 = Ks[(ty + 16) * ld + d];
                const float v_0 = Vs[ty * ld + d], v_1 = Vs[(ty + 16) * ld + d];
                const float q_0 = Qs[tx * ld + d], q_1 = Qs[(tx + 16) * ld + d];
                const float o_0 = dOs[tx * ld + d], o_1 = dOs[(tx + 16) * ld + d];
                s[0][0] = fmaf(k_0, q_0, s[0][0]);
                s[0][1] = fmaf(k_0, q_1, s[0][1]);
                s[1][0] = fmaf(k_1, q_0, s[1][0]);
                s[1][1] = fmaf(k_1, q_1, s[1][1]);
                dp[0][0] = fmaf(v_0, o_0, dp[0][0]);
                dp[0][1] = fmaf(v_0, o_1, dp[0][1]);
                dp[1][0] = fmaf(v_1, o_0, dp[1][0]);
                dp[1][1] = fmaf(v_1, o_1, dp[1][1]);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int w = 0; w < 2; ++w) {
                    const int jj = ty + 16 * u, ii = tx + 16 * w;
                    const float p = kept(a, a.q_offset + i0 + ii, k0 + jj)
                                        ? expf(s[u][w] * a.scale - lse_s[ii]) : 0.0f;
                    Ps[jj * kLdP + ii] = p;
                    dSs[jj * kLdP + ii] = p * (dp[u][w] - dl_s[ii]);
                }
            __syncthreads();
            // dV += P^T dO, dK += dS^T Q at keys ty + 16u, columns tx + 16c
            for (int i = 0; i < kSB; ++i) {
                const float p0 = Ps[ty * kLdP + i], p1 = Ps[(ty + 16) * kLdP + i];
                const float s0 = dSs[ty * kLdP + i], s1 = dSs[(ty + 16) * kLdP + i];
#pragma unroll
                for (int c = 0; c < kMaxDh / 16; ++c) {
                    const int d = tx + 16 * c;
                    if (c < nc && d < Dh) {
                        const float o = dOs[i * ld + d], q = Qs[i * ld + d];
                        dv[0][c] = fmaf(p0, o, dv[0][c]);
                        dv[1][c] = fmaf(p1, o, dv[1][c]);
                        dk[0][c] = fmaf(s0, q, dk[0][c]);
                        dk[1][c] = fmaf(s1, q, dk[1][c]);
                    }
                }
            }
        }
    }
    const size_t base = ((size_t)b * a.Hkv + j) * (size_t)a.Skv * Dh;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int r = k0 + ty + 16 * u;
        if (r >= a.Skv) continue;
        T* dkr = static_cast<T*>(a.dk) + base + (size_t)r * Dh;
        T* dvr = static_cast<T*>(a.dv) + base + (size_t)r * Dh;
#pragma unroll
        for (int c = 0; c < kMaxDh / 16; ++c) {
            const int d = tx + 16 * c;
            if (c < nc && d < Dh) {
                from_f32(dkr + d, dk[u][c] * a.scale);
                from_f32(dvr + d, dv[u][c]);
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads) flash_bwd_dq_simt_kernel(const Bwd a) {
    extern __shared__ float smem[];
    const int Dh = a.Dh, ld = Dh | 1, nc = (Dh + 15) >> 4;
    float* Qs = smem;             // [32][ld]
    float* dOs = Qs + kSB * ld;
    float* Ks = dOs + kSB * ld;
    float* Vs = Ks + kSB * ld;
    float* dSs = Vs + kSB * ld;   // [32 queries][33]

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int i0 = blockIdx.x * kSB, h = blockIdx.y, b = blockIdx.z;
    const int hk = (h + a.off) / a.group;
    int k_begin, k_end, t_first, n_tiles;
    key_range(a, i0, min(i0 + kSB, a.Sq) - 1, k_begin, k_end);
    tiles(k_begin, k_end, kSB, t_first, n_tiles);
    stage(Qs, static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1], a.qs[2], i0, a.Sq, Dh, ld);
    stage(dOs, static_cast<const T*>(a.dO) + b * a.ds[0] + h * a.ds[1], a.ds[2], i0, a.Sq, Dh, ld);
    const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
    const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int i = i0 + ty + 16 * u;
        const long long row = ((long long)b * a.H + h) * a.Sq + i;
        lse_r[u] = i < a.Sq ? a.lse[row] : INFINITY;
        dl_r[u] = i < a.Sq ? a.delta[row] : 0.0f;
    }
    float dq[2][kMaxDh / 16];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < kMaxDh / 16; ++c) dq[u][c] = 0.0f;

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = (t_first + t) * kSB;
        __syncthreads();  // the previous tile's readers are done
        stage(Ks, kb, a.ks[2], k0, a.Skv, Dh, ld);
        stage(Vs, vb, a.vs[2], k0, a.Skv, Dh, ld);
        __syncthreads();
        // S and dP at queries ty + 16u, keys tx + 16w
        float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        for (int d = 0; d < Dh; ++d) {
            const float q_0 = Qs[ty * ld + d], q_1 = Qs[(ty + 16) * ld + d];
            const float o_0 = dOs[ty * ld + d], o_1 = dOs[(ty + 16) * ld + d];
            const float k_0 = Ks[tx * ld + d], k_1 = Ks[(tx + 16) * ld + d];
            const float v_0 = Vs[tx * ld + d], v_1 = Vs[(tx + 16) * ld + d];
            s[0][0] = fmaf(q_0, k_0, s[0][0]);
            s[0][1] = fmaf(q_0, k_1, s[0][1]);
            s[1][0] = fmaf(q_1, k_0, s[1][0]);
            s[1][1] = fmaf(q_1, k_1, s[1][1]);
            dp[0][0] = fmaf(o_0, v_0, dp[0][0]);
            dp[0][1] = fmaf(o_0, v_1, dp[0][1]);
            dp[1][0] = fmaf(o_1, v_0, dp[1][0]);
            dp[1][1] = fmaf(o_1, v_1, dp[1][1]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int w = 0; w < 2; ++w) {
                const int ii = ty + 16 * u, jj = tx + 16 * w;
                const float p = kept(a, a.q_offset + i0 + ii, k0 + jj)
                                    ? expf(s[u][w] * a.scale - lse_r[u]) : 0.0f;
                dSs[ii * kLdP + jj] = p * (dp[u][w] - dl_r[u]);
            }
        __syncthreads();
        // dQ += dS K at queries ty + 16u, columns tx + 16c
        for (int jj = 0; jj < kSB; ++jj) {
            const float s0 = dSs[ty * kLdP + jj], s1 = dSs[(ty + 16) * kLdP + jj];
#pragma unroll
            for (int c = 0; c < kMaxDh / 16; ++c) {
                const int d = tx + 16 * c;
                if (c < nc && d < Dh) {
                    const float kv = Ks[jj * ld + d];
                    dq[0][c] = fmaf(s0, kv, dq[0][c]);
                    dq[1][c] = fmaf(s1, kv, dq[1][c]);
                }
            }
        }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int r = i0 + ty + 16 * u;
        if (r >= a.Sq) continue;
        T* dqr = static_cast<T*>(a.dq) + (((size_t)b * a.H + h) * a.Sq + r) * Dh;
#pragma unroll
        for (int c = 0; c < kMaxDh / 16; ++c) {
            const int d = tx + 16 * c;
            if (c < nc && d < Dh) from_f32(dqr + d, dq[u][c] * a.scale);
        }
    }
}

// ===================================================================== launch

template <typename K>
int set_smem(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

template <typename T>
int launch_delta(const Bwd& a, cudaStream_t s) {
    const long long rows = (long long)a.B * a.H * a.Sq;
    if (rows == 0) return 0;
    flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(a);
    return (int)cudaGetLastError();
}

template <int DH>
int launch_mma(const Bwd& a, cudaStream_t s) {
    int err = launch_delta<bf16>(a, s);
    if (err) return err;
    const size_t kv_bytes = MmaTiles<DH>::kSmem, q_bytes = 6 * MmaTiles<DH>::kTile * 2;
    if ((err = set_smem(flash_bwd_dkdv_mma_kernel<DH>, kv_bytes))) return err;
    if ((err = set_smem(flash_bwd_dq_mma_kernel<DH>, q_bytes))) return err;
    if (a.Skv > 0) {
        flash_bwd_dkdv_mma_kernel<DH><<<dim3((a.Skv + kRows - 1) / kRows, a.Hkv, a.B),
                                           kMmaThreads, kv_bytes, s>>>(a);
        if ((err = (int)cudaGetLastError())) return err;
    }
    if (a.Sq > 0) {
        flash_bwd_dq_mma_kernel<DH><<<dim3(a.H, a.B, (a.Sq + kRows - 1) / kRows), kMmaThreads,
                                         q_bytes, s>>>(a);
        if ((err = (int)cudaGetLastError())) return err;
    }
    return 0;
}

template <int DHP>
int launch_hopper(const Bwd& a, cudaStream_t s) {
    using namespace wgk;
    using DK = DkdvTiles<DHP>;
    using DQ = DqTiles<DHP>;
    if ((a.Skv + DK::kKeys - 1) / DK::kKeys > 65535) return (int)cudaErrorInvalidValue;
    int err = launch_delta<bf16>(a, s);
    if (err) return err;
    // 4-D maps over each operand's own strides: boxes of 64 columns by the
    // rows a tile takes in each kernel (columns past Dh and rows past Sq or
    // Skv zero-filled)
    CUtensorMap q_kv, do_kv, k_kv, v_kv, q_q, do_q, k_q, v_q;
    const int D = a.Dh;
    const int KV = DK::kKeys, KS = DQ::kKStep;
    if ((err = make_map_bhsd(&q_kv, a.q, D, a.Sq, a.H, a.B, a.qs[2], a.qs[1], a.qs[0], kQStep)) ||
        (err = make_map_bhsd(&do_kv, a.dO, D, a.Sq, a.H, a.B, a.ds[2], a.ds[1], a.ds[0], kQStep)) ||
        (err = make_map_bhsd(&k_kv, a.k, D, a.Skv, a.Hkv, a.B, a.ks[2], a.ks[1], a.ks[0], KV)) ||
        (err = make_map_bhsd(&v_kv, a.v, D, a.Skv, a.Hkv, a.B, a.vs[2], a.vs[1], a.vs[0], KV)) ||
        (err = make_map_bhsd(&q_q, a.q, D, a.Sq, a.H, a.B, a.qs[2], a.qs[1], a.qs[0], kRowsQ)) ||
        (err = make_map_bhsd(&do_q, a.dO, D, a.Sq, a.H, a.B, a.ds[2], a.ds[1], a.ds[0], kRowsQ)) ||
        (err = make_map_bhsd(&k_q, a.k, D, a.Skv, a.Hkv, a.B, a.ks[2], a.ks[1], a.ks[0], KS)) ||
        (err = make_map_bhsd(&v_q, a.v, D, a.Skv, a.Hkv, a.B, a.vs[2], a.vs[1], a.vs[0], KS)))
        return err;
    if ((err = set_smem(flash_bwd_dkdv_hopper_kernel<DHP>, DK::kSmem))) return err;
    if ((err = set_smem(flash_bwd_dq_hopper_kernel<DHP>, DQ::kSmem))) return err;
    const int key_tiles = (a.Skv + DK::kKeys - 1) / DK::kKeys;
    int split = 1;  // DHP 192, 256: a cluster of two CTAs a key tile on a small grid (the note)
    if (DK::kByGrad) {
        int dev = 0, n_sm = 0;
        if ((err = (int)cudaGetDevice(&dev)) ||
            (err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)))
            return err;
        if ((long long)a.Hkv * a.B * key_tiles < 2LL * n_sm) split = 2;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = split;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(a.Hkv * split, a.B, key_tiles);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = DK::kSmem;
    cfg.stream = s;
    cfg.attrs = cluster;
    cfg.numAttrs = split > 1 ? 1 : 0;  // no cluster: a plain launch
    if ((err = (int)cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_hopper_kernel<DHP>, q_kv, do_kv, k_kv,
                                       v_kv, a)))
        return err;
    if ((err = (int)cudaGetLastError())) return err;
    flash_bwd_dq_hopper_kernel<DHP><<<dim3(a.H, a.B, (a.Sq + kRowsQ - 1) / kRowsQ), kThreads,
                                      DQ::kSmem, s>>>(q_q, do_q, k_q, v_q, a);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const Bwd& a, cudaStream_t s) {
    int err = launch_delta<T>(a, s);
    if (err) return err;
    const int ld = a.Dh | 1;
    const size_t kv_bytes = sizeof(float) * (4 * (size_t)kSB * ld + 2 * kSB * kLdP + 2 * kSB);
    const size_t q_bytes = sizeof(float) * (4 * (size_t)kSB * ld + kSB * kLdP);
    if ((err = set_smem(flash_bwd_dkdv_simt_kernel<T>, kv_bytes))) return err;
    if ((err = set_smem(flash_bwd_dq_simt_kernel<T>, q_bytes))) return err;
    if (a.Skv > 0) {
        flash_bwd_dkdv_simt_kernel<T><<<dim3((a.Skv + kSB - 1) / kSB, a.Hkv, a.B), kSimtThreads,
                                        kv_bytes, s>>>(a);
        if ((err = (int)cudaGetLastError())) return err;
    }
    if (a.Sq > 0) {
        flash_bwd_dq_simt_kernel<T><<<dim3((a.Sq + kSB - 1) / kSB, a.H, a.B), kSimtThreads,
                                      q_bytes, s>>>(a);
        if ((err = (int)cudaGetLastError())) return err;
    }
    return 0;
}

}  // namespace

// The backward's three launches on ``stream``. variant 2 is the hopper one
// (wgmma + TMA: bf16, Dh 64, 96, 128, 192 or 256, 16-byte aligned data, strides
// multiples of 8 elements, at least one key), 1 the mma one (mma.sync: bf16,
// Dh 64 or 128, the same alignment), 0 the SIMT one: the wrapper's
// flash_bwd_variants checks. dtype 0 is fp32, 1 bf16 (every tensor but lse and
// delta, which are fp32). Strides are in elements over (b, h, s) of q, k, v, o
// and dO (a dim of length 1 may carry a placeholder, a multiple of 8); lse,
// delta, dq, dk and dv are contiguous. Returns 0, the first launch's
// cudaGetLastError(), cudaErrorInvalidValue for a shape, dtype or variant it
// does not take, or an error of the tensor-map encoding (see the error string).
extern "C" int flash_attention_bwd_launch(
    int variant, const void* q, const void* k, const void* v, const void* o, const void* dO,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int Hkv, int Sq,
    int Skv, int Dh, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, long long dsb, long long dsh, long long dss, float scale, int causal,
    int window, int q_offset, int group, int head_offset, int dtype, void* stream) {
    if (B == 0 || H == 0) return 0;
    if (Dh < 1 || Dh > kMaxDh || Hkv < 1 || group < 1 || head_offset < 0 || head_offset >= group ||
        (H - 1 + head_offset) / group >= Hkv || B > 65535 || H > 65535 || Hkv > 65535 ||
        (Sq + kRows - 1) / kRows > 65535)
        return (int)cudaErrorInvalidValue;
    Bwd a{q, k, v, o, dO, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
          B, H, Hkv, Sq, Skv, Dh, group, head_offset, causal, window, q_offset,
          {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss}, {dsb, dsh, dss},
          scale, scale * kLog2e};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == 2) {
        if (dtype != 1 || Skv < 1 || Sq < 1) return (int)cudaErrorInvalidValue;
        if (Dh == 64) return launch_hopper<64>(a, s);
        if (Dh == 96 || Dh == 128) return launch_hopper<128>(a, s);  // 96: zero columns 96..127
        if (Dh == 192) return launch_hopper<192>(a, s);
        if (Dh == 256) return launch_hopper<256>(a, s);
        return (int)cudaErrorInvalidValue;
    }
    if (variant == 1) {
        if (dtype != 1) return (int)cudaErrorInvalidValue;
        if (Dh == 64) return launch_mma<64>(a, s);
        if (Dh == 128) return launch_mma<128>(a, s);
        return (int)cudaErrorInvalidValue;
    }
    if (variant != 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch_simt<float>(a, s);
    if (dtype == 1) return launch_simt<bf16>(a, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
    return hopper::error_string(err);
}
