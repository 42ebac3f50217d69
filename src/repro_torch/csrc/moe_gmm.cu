// Grouped matmul for Hopper (sm_90a): MoE expert compute, three kernels.
//
// Replaces: gmm_pallas / _gmm_kernel in src/repro/kernels/moe_gmm.py:45, the
// TPU kernel whose grid (T/bt, N/bn, K/bk) runs K innermost with a VMEM fp32
// accumulator, the per-row-tile group id scalar-prefetched so that each tile's
// BlockSpec streams only its own expert's weights; its wrapper
// (repro.kernels.ops.gmm) pads every group to a multiple of block_t so that
// no tile straddles two experts.
//
// Contract, all three kernels: x [T, K] rows sorted into contiguous groups,
// w [E, K, N], both fp32 or both bf16; out [T, N] contiguous, x's dtype, with
//   out[t] = x[t] @ w[group_of(t)]
// summed in fp32 and rounded once. x needs unit column stride (any row
// stride), w unit stride over N (any strides over E and K). The wrapper
// (kernels/moe_gmm.py) hands over a tile plan built on the device: for each
// of ceil(T/bt) + E row tiles its group id, first row and end row. A tile
// never straddles two groups; a group of 1 row gets one tile, an empty group
// none. Group id E marks the rows past the last group, which are written as
// zeros; a tile whose end equals its first row does nothing. A tile's first
// row is any row, not a multiple of bt. No padded copy of x is made.
//
// What bounds it on this card: at the MoE prefill (OLMoE-1B-7B, 4 x 2048
// tokens, K 2048, N 1024) operations. In the reference's capacity layout
// (64 groups of 1280 rows) that is 2 * 81,920 * 2048 * 1024 = 343.6 GFLOP,
// 0.347 ms at the bf16 tensor-core peak; the port's MoE block now hands over
// only the ~60,400 kept rows (models/moe.py), ~0.26 ms. At a decode step
// bytes: the weights of the experts that hold rows, read once.
//
// gmm_hopper_kernel (bf16; K and N multiples of 8, 16-byte aligned base
// pointers, row strides of x and w multiples of 8 elements: what a TMA
// descriptor can describe). Design:
//   * One CTA of three warpgroups per (row tile of 128, column tile of 256).
//     Warpgroup 0 is the producer: one thread issues every TMA load
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion) into a
//     ring of 4 stages, each the x box [128 rows x 64 k] (16 KB) and the w
//     boxes [64 k x 256 n] (32 KB, four 64-column boxes, those past N not
//     loaded). x's box starts at the tile's first row, whatever it is; TMA
//     zero-fills rows past T and columns past K, and w's rows past K.
//     setmaxnreg moves registers from the producer (40) to the consumers (232).
//   * Warpgroups 1 and 2 each run wgmma m64n256k16 (fp32 accumulators in
//     registers, 128 a thread) on 64 rows: x K-major, w[g] [K, N] with N
//     contiguous as the transposed (MN-major) B operand. Each consumer keeps
//     one k-step's wgmmas in flight while it releases the stage before.
//     Where the tile has at most 64 rows (decode, a group's ragged tail) the
//     second consumer exits at once.
//   * Rows of the x box past the tile's end row belong to the next group and
//     are multiplied too; the epilogue stores only the tile's rows, straight
//     from registers: a quad of threads transposes its bf16 pairs with
//     shuffles so that each thread stores 8 columns (16 bytes) of one row.
//     A whole-box store would overwrite the next group's rows.
//   On an H100 80GB HBM3 at 700 W (chip_smoke.py's moe phase) it takes
//   0.39-0.40 ms for the prefill's layer-0 wi product over the 60,381 kept
//   rows (bound 0.256 ms; torch._grouped_mm 0.42-0.43), 0.48-0.49 ms over the
//   reference's 81,920-row capacity layout (torch.bmm 0.44-0.45; the wmma
//   kernel 2.23-2.26) and 0.04 ms for a decode step's 32 rows (bound 0.026).
//
// gmm_bf16_kernel ("wmma", bf16 layouts that TMA cannot describe): one CTA of
// 8 warps per (row tile of 128, column tile of 128), K in steps of 32. The A
// tile [128 x 32] and the B tile [32 x 128] are double-buffered in shared
// memory (rows padded by 8 elements against bank conflicts, 37 KB): the next
// step's tiles are loaded into registers while the tensor cores work on the
// current step, then stored into the other buffer, one barrier per step.
// Loads are 16 bytes a thread where the width, the strides and the base
// pointer allow, elements otherwise; out-of-bounds rows and columns load as
// 0. Each warp owns a 64 x 32 sub-tile: 4 x 2 wmma 16x16x16 bf16 fragments
// with fp32 accumulators (mma.sync). Fragments whose rows lie past the tile's
// end are skipped. The epilogue stages each 16x16 fragment through shared
// memory. It was the port's first gmm kernel: 2.21-2.23 ms at the padded
// prefill shape on an H100 80GB HBM3 at 700 W, 6.4x its bound.
//
// gmm_f32_kernel ("f32"): CUDA-core FMAs (never TF32), one CTA of 256 threads
// per (64-row tile, 64-column tile), K in steps of 16 through shared memory,
// each thread a 4 x 4 block of outputs. It serves fp32 callers such as the
// reference's own tests; the MoE path is bf16.
//
// The wrapper picks the kernel by dtype, shape, alignment and strides
// (gmm_variant); none gives way to another on failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

#define NTHREADS 256

// ---- bf16 tensor-core path
#define BT 128
#define BN 128
#define BK 32
#define A_LD (BK + 8)  // bf16 per shared row of the A tile
#define B_LD (BN + 8)  // bf16 per shared row of the B tile
#define C_LD 20        // floats per row of a warp's 16 x 16 epilogue scratch
#define A_ELEMS (BT * A_LD)
#define B_ELEMS (BK * B_LD)

// ---- fp32 CUDA-core path
#define FT 64
#define FN 64
#define FK 16

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
    return (uint32_t)lo | ((uint32_t)hi << 16);
}

// 8 consecutive bf16 (as bits) of row ``src`` from column ``c``, zero past
// ``n_cols``; 16-byte load when ``vec`` (the caller guarantees alignment
// and that a chunk lies wholly inside or outside the row).
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ src, int c, int n_cols,
                                       bool vec) {
    if (vec) {
        if (c < n_cols) return *reinterpret_cast<const uint4*>(src + c);
        return make_uint4(0u, 0u, 0u, 0u);
    }
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (c + j < n_cols) ? src[c + j] : (uint16_t)0;
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                      pack2(v[6], v[7]));
}

struct Plan {
    const int* gid;   // [n_tiles] group of each row tile (E: rows past the groups)
    const int* row0;  // [n_tiles] first row
    const int* row1;  // [n_tiles] end row (== row0: nothing to do)
    int n_col_tiles;
};

__global__ void __launch_bounds__(NTHREADS)
gmm_bf16_kernel(const uint16_t* __restrict__ x, long long sx, const uint16_t* __restrict__ w,
                long long swe, long long swk, uint16_t* __restrict__ out, Plan plan, int K,
                int N, int E, int vec_x, int vec_w, int vec_out) {
    const int tile = blockIdx.x / plan.n_col_tiles;
    const int n0 = (blockIdx.x % plan.n_col_tiles) * BN;
    const int r0 = plan.row0[tile], r1 = plan.row1[tile];
    if (r0 >= r1) return;
    const int g = plan.gid[tile];
    const int rows = r1 - r0;  // 1..BT
    const int tid = threadIdx.x;
    if (g >= E) {  // rows past the last group
        const int ncols = min(BN, N - n0);
        for (int i = tid; i < rows * ncols; i += NTHREADS)
            out[(long long)(r0 + i / ncols) * N + n0 + i % ncols] = 0;
        return;
    }

    __shared__ __align__(128) uint16_t smem[2 * (A_ELEMS + B_ELEMS)];
    uint16_t* As[2] = {smem, smem + A_ELEMS + B_ELEMS};
    uint16_t* Bs[2] = {smem + A_ELEMS, smem + 2 * A_ELEMS + B_ELEMS};

    const uint16_t* xg = x + (long long)r0 * sx;
    const uint16_t* wg = w + (long long)g * swe + n0;
    const int ncol = N - n0;  // columns of w left from n0 (>= 1)
    // chunk c of the A tile: row c / 4, columns (c % 4) * 8; of the B tile:
    // row c / 16, columns (c % 16) * 8. 512 chunks each, two per thread.
    uint4 ra[2], rb[2];
    auto load = [&](int k0) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int c = tid + q * NTHREADS;
            const int ar = c >> 2, ac = (c & 3) * 8;
            ra[q] = ar < rows ? load8(xg + (long long)ar * sx + k0, ac, K - k0, vec_x)
                              : make_uint4(0u, 0u, 0u, 0u);
            const int br = c >> 4, bc = (c & 15) * 8;
            rb[q] = k0 + br < K ? load8(wg + (long long)(k0 + br) * swk, bc, ncol, vec_w)
                                : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int c = tid + q * NTHREADS;
            *reinterpret_cast<uint4*>(As[buf] + (c >> 2) * A_LD + (c & 3) * 8) = ra[q];
            *reinterpret_cast<uint4*>(Bs[buf] + (c >> 4) * B_LD + (c & 15) * 8) = rb[q];
        }
    };

    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2;  // rows wm * 64 of the tile
    const int wn = warp & 3;   // columns wn * 32
    const int live = min(4, max(0, (rows - wm * 64 + 15) / 16));  // fragments with rows
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    const int nk = (K + BK - 1) / BK;
    if (nk > 0) {
        load(0);
        store(0);
        __syncthreads();
    }
    for (int kt = 0; kt < nk; ++kt) {
        const int cur = kt & 1;
        if (kt + 1 < nk) load((kt + 1) * BK);  // in flight while the tensor cores work
        const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(As[cur]);
        const __nv_bfloat16* b_s = reinterpret_cast<const __nv_bfloat16*>(Bs[cur]);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], b_s + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (i < live) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                    wmma::load_matrix_sync(a, a_s + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
                    for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
                }
            }
        }
        if (kt + 1 < nk) store(cur ^ 1);
        __syncthreads();
    }

    // epilogue: each fragment through a per-warp 16 x 16 fp32 scratch (the
    // operand buffers are free after the loop's last barrier)
    float* scratch = reinterpret_cast<float*>(smem) + warp * 16 * C_LD;
    const int fr = lane >> 1, fc = (lane & 1) * 8;  // this lane's row and 8 columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (i >= live) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(scratch, acc[i][j], C_LD, wmma::mem_row_major);
            __syncwarp();
            const int r = wm * 64 + i * 16 + fr;
            const int col = n0 + wn * 32 + j * 16 + fc;
            if (r < rows && col < N) {
                uint16_t v[8];
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    v[e] = __bfloat16_as_ushort(__float2bfloat16_rn(scratch[fr * C_LD + fc + e]));
                uint16_t* dst = out + (long long)(r0 + r) * N + col;
                if (vec_out) {  // N % 8 == 0: the 8 columns are all inside
                    *reinterpret_cast<uint4*>(dst) = make_uint4(
                        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                        pack2(v[6], v[7]));
                } else {
                    for (int e = 0; e < 8 && col + e < N; ++e) dst[e] = v[e];
                }
            }
            __syncwarp();
        }
    }
}

__global__ void __launch_bounds__(NTHREADS)
gmm_f32_kernel(const float* __restrict__ x, long long sx, const float* __restrict__ w,
               long long swe, long long swk, float* __restrict__ out, Plan plan, int K, int N,
               int E) {
    const int tile = blockIdx.x / plan.n_col_tiles;
    const int n0 = (blockIdx.x % plan.n_col_tiles) * FN;
    const int r0 = plan.row0[tile], r1 = plan.row1[tile];
    if (r0 >= r1) return;
    const int g = plan.gid[tile];
    const int rows = r1 - r0;  // 1..FT
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;  // outputs (ty + 16i, tx + 16j)
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    if (g < E) {
        __shared__ float As[FK][FT + 4];  // transposed: As[k][row]
        __shared__ float Bs[FK][FN + 4];
        const float* xg = x + (long long)r0 * sx;
        const float* wg = w + (long long)g * swe + n0;
        for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int e = tid + q * NTHREADS;
                const int ar = e >> 4, ak = e & 15;
                As[ak][ar] = (ar < rows && k0 + ak < K) ? xg[(long long)ar * sx + k0 + ak] : 0.0f;
                const int bk = e >> 6, bc = e & 63;
                Bs[bk][bc] = (k0 + bk < K && n0 + bc < N) ? wg[(long long)(k0 + bk) * swk + bc]
                                                          : 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < FK; ++kk) {
                float a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
            __syncthreads();
        }
    }
    // a tile past the groups (g == E) writes its zeros here too
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx + 16 * j;
            if (col < N) out[(long long)(r0 + r) * N + col] = acc[i][j];
        }
    }
}

// x [T, K] (row stride sx elements), w [E, K, N] (strides swe, swk), out
// [T, N] contiguous; ``tiles`` int32 [3, n_tiles]: group id, first row, end
// row of each row tile of ``tile_rows`` rows (128 for bf16, 64 for fp32, which
// the wrapper must have planned with). dtype 0 fp32, 1 bf16. vec_x / vec_w /
// vec_out != 0 when the wrapper found 16-byte chunks of x's rows / w's rows
// / out's rows aligned and wholly inside or outside their row (bf16 only).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int gmm_launch(const void* x, long long sx, const void* w, long long swe,
                          long long swk, void* out, const int* tiles, int n_tiles, int tile_rows,
                          int K, int N, int E, int dtype, int vec_x, int vec_w, int vec_out,
                          void* stream) {
    if (n_tiles == 0 || N == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        if (tile_rows != BT) return (int)cudaErrorInvalidValue;
        Plan plan{tiles, tiles + n_tiles, tiles + 2 * n_tiles, (N + BN - 1) / BN};
        const long long blocks = (long long)n_tiles * plan.n_col_tiles;
        if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
        gmm_bf16_kernel<<<(unsigned)blocks, NTHREADS, 0, s>>>(
            static_cast<const uint16_t*>(x), sx, static_cast<const uint16_t*>(w), swe, swk,
            static_cast<uint16_t*>(out), plan, K, N, E, vec_x, vec_w, vec_out);
    } else if (dtype == 0) {
        if (tile_rows != FT) return (int)cudaErrorInvalidValue;
        Plan plan{tiles, tiles + n_tiles, tiles + 2 * n_tiles, (N + FN - 1) / FN};
        const long long blocks = (long long)n_tiles * plan.n_col_tiles;
        if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
        gmm_f32_kernel<<<(unsigned)blocks, NTHREADS, 0, s>>>(
            static_cast<const float*>(x), sx, static_cast<const float*>(w), swe, swk,
            static_cast<float*>(out), plan, K, N, E);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// ===================================================================== Hopper
// gmm_hopper_kernel: wgmma + TMA, bf16 operands (see the note).

#include <cuda.h>  // CUtensorMap and its enums; the driver function comes by entry point
#include <stdio.h>

namespace hopper {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBM = 128;       // rows per tile, 64 per consumer warpgroup
constexpr int kBN = 256;       // columns per tile: four 64-column (128-byte) boxes of w
constexpr int kBK = 64;        // k per stage: one 128-byte row of x
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK * 2;              // 16 KB
constexpr int kBBoxBytes = kBK * 64 * 2;            // one [64 k x 64 n] box, 8 KB
constexpr int kStageBytes = kABytes + (kBN / 64) * kBBoxBytes;  // 48 KB
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;  // + align, barriers
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

// 2-D and 3-D TMA tile loads into shared memory, completion counted on ``bar``.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operand (x): rows
// of 128 bytes, 8-row groups ``sbo`` = 1024 bytes apart (``lbo`` unused).
// MN-major operand (w): ``lbo`` is the distance between 64-column boxes,
// ``sbo`` between groups of 8 k-rows.
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
__device__ __forceinline__ void wg_wait1() {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma results above the wait.
__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64n256k16, fp32 += bf16 * bf16, A (x) K-major and B (w) MN-major
// (transposed), both from shared memory; ``scale_d`` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256_tb(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// v[m] is this thread's bf16 pair of 8-column block m of one row; a quad of
// threads q = 0..3 holds pairs 0..3 of each block. Returns block q's 8
// columns (the pairs of threads 0..3), by two shuffle exchanges.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int q) {
    const bool b0 = q & 1, b1 = q & 2;
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, b0 ? v[0] : v[1], 1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, b0 ? v[2] : v[3], 1);
    const uint32_t k0 = b0 ? v[1] : v[0], k1 = b0 ? v[3] : v[2];
    // pairs of block (q & 1) and (q & 1) + 2 from threads q & ~1 (lo) and q | 1 (hi)
    const uint32_t lo_a = b0 ? r0 : k0, hi_a = b0 ? k0 : r0;
    const uint32_t lo_b = b0 ? r1 : k1, hi_b = b0 ? k1 : r1;
    const uint32_t ra = __shfl_xor_sync(0xffffffffu, b1 ? lo_a : lo_b, 2);
    const uint32_t rb = __shfl_xor_sync(0xffffffffu, b1 ? hi_a : hi_b, 2);
    const uint32_t ka = b1 ? lo_b : lo_a, kb = b1 ? hi_b : hi_a;
    return make_uint4(b1 ? ra : ka, b1 ? rb : kb, b1 ? ka : ra, b1 ? kb : rb);
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_hopper_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  __nv_bfloat16* __restrict__ out, Plan plan, int K, int N, int E) {
    const int tile = blockIdx.x / plan.n_col_tiles;
    const int n0 = (blockIdx.x % plan.n_col_tiles) * kBN;
    const int r0 = plan.row0[tile], r1 = plan.row1[tile];
    if (r0 >= r1) return;
    const int g = plan.gid[tile];
    const int rows = r1 - r0;  // 1..kBM
    if (g >= E) {  // rows past the last group: zeros, 16 bytes a store (N % 8 == 0)
        const int chunks = min(kBN, N - n0) / 8;
        for (int i = threadIdx.x; i < rows * chunks; i += kThreads)
            *reinterpret_cast<uint4*>(out + (size_t)(r0 + i / chunks) * N + n0 + 8 * (i % chunks)) =
                make_uint4(0u, 0u, 0u, 0u);
        return;
    }

    extern __shared__ uint8_t smem_raw[];
    // 1024-byte alignment: the 128-byte swizzle pattern repeats every 8 rows
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
    uint64_t* empty = full + kStages;
    const int n_consumers = rows > 64 ? 2 : 1;
    const int nk = (K + kBK - 1) / kBK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], n_consumers * 128);  // every live consumer thread arrives
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
            const int n_boxes = min(kBN / 64, (N - n0 + 63) / 64);  // w boxes inside N
            const uint32_t tx_bytes = kABytes + n_boxes * kBBoxBytes;
            for (int i = 0; i < nk; ++i) {
                const int s = i % kStages;
                mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
                uint8_t* a = ring + s * kStageBytes;
                uint8_t* b = a + kABytes;
                mbar_expect_tx(&full[s], tx_bytes);
                tma_load_2d(a, &tx, &full[s], i * kBK, r0);
                for (int c = 0; c < n_boxes; ++c)
                    tma_load_3d(b + c * kBBoxBytes, &tw, &full[s], n0 + 64 * c, i * kBK, g);
            }
        }
    } else {
        // --------------------------------------------------------- consumers
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int cw = wg - 1;  // rows 64 * cw .. of the tile
        if (cw < n_consumers) {
            float acc[128];
#pragma unroll
            for (int j = 0; j < 128; ++j) acc[j] = 0.0f;
            for (int i = 0; i < nk; ++i) {
                const int s = i % kStages;
                mbar_wait(&full[s], (i / kStages) & 1);
                const uint32_t a_addr = smem_u32(ring + s * kStageBytes) + cw * 64 * 128;
                const uint32_t b_addr = smem_u32(ring + s * kStageBytes + kABytes);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < kBK / 16; ++kk)
                    wgmma_m64n256_tb(acc, desc_sw128(a_addr + kk * 32, 16, 1024),
                                     desc_sw128(b_addr + kk * 16 * 128, kBBoxBytes, 1024),
                                     (i > 0 || kk > 0) ? 1 : 0);
                wg_commit();
                wg_wait1();  // the step before this one is done: release its stage
                if (i > 0) mbar_arrive(&empty[(i - 1) % kStages]);
            }
            wg_wait0();
            fence_regs(acc);

            // epilogue: rows r_lo and r_lo + 8 of this consumer's 64; only the
            // tile's own rows are stored
            const int t = threadIdx.x - 128 * wg;
            const int warp = t / 32, lane = t % 32, q = lane % 4;
            const int r_lo = 64 * cw + 16 * warp + lane / 4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r_lo + 8 * h;
                __nv_bfloat16* orow = out + (size_t)(r0 + r) * N;
#pragma unroll
                for (int jb = 0; jb < kBN / 32; ++jb) {
                    uint32_t v[4];
#pragma unroll
                    for (int m = 0; m < 4; ++m)
                        v[m] = pack_bf16(acc[4 * (4 * jb + m) + 2 * h],
                                         acc[4 * (4 * jb + m) + 2 * h + 1]);
                    const uint4 o = quad_transpose(v, q);  // every lane takes part
                    const int col = n0 + 8 * (4 * jb + q);
                    if (r < rows && col < N) *reinterpret_cast<uint4*>(orow + col) = o;
                }
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

// A bf16 map of ``rank`` dims (innermost first) with byte strides of the
// outer dims, boxes of ``box``, 128-byte swizzle, zero fill out of bounds.
static int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                           dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

}  // namespace hopper

// bf16 x [T, K] (row stride sx elements), w [E, K, N] (strides swe, swk),
// out [T, N] contiguous; ``tiles`` int32 [3, n_tiles] planned with 128-row
// tiles. K and N multiples of 8, base pointers 16-byte aligned, sx, swe and
// swk multiples of 8 (the wrapper's gmm_variant checks all of it). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape it
// does not take, or an error of the tensor-map encoding (see the error string).
extern "C" int gmm_hopper_launch(const void* x, long long sx, const void* w, long long swe,
                                 long long swk, void* out, const int* tiles, int n_tiles, int T,
                                 int K, int N, int E, void* stream) {
    using namespace hopper;
    if (n_tiles == 0 || N == 0 || T == 0) return 0;
    if (K <= 0 || K % 8 || N % 8 || E <= 0) return (int)cudaErrorInvalidValue;
    EncodeTiled enc;
    int err = encode_fn(&enc);
    if (err) return err;
    CUtensorMap tx, tw;
    const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)T};
    const cuuint64_t x_strides[1] = {(cuuint64_t)sx * 2};
    const cuuint32_t x_box[2] = {kBK, kBM};
    if ((err = make_map(enc, &tx, x, 2, x_dims, x_strides, x_box))) return err;
    const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
    const cuuint64_t w_strides[2] = {(cuuint64_t)swk * 2, (cuuint64_t)swe * 2};
    const cuuint32_t w_box[3] = {64, kBK, 1};
    if ((err = make_map(enc, &tw, w, 3, w_dims, w_strides, w_box))) return err;
    Plan plan{tiles, tiles + n_tiles, tiles + 2 * n_tiles, (N + kBN - 1) / kBN};
    const long long blocks = (long long)n_tiles * plan.n_col_tiles;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(gmm_hopper_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    gmm_hopper_kernel<<<(unsigned)blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
        tx, tw, static_cast<__nv_bfloat16*>(out), plan, K, N, E);
    return (int)cudaGetLastError();
}

extern "C" const char* gmm_error_string(int err) {
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
