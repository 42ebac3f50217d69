// Grouped matmul for Hopper (sm_90a): MoE expert compute.
//
// Replaces: gmm_pallas / _gmm_kernel in src/repro/kernels/moe_gmm.py, the
// TPU kernel whose grid (T/bt, N/bn, K/bk) runs K innermost with a VMEM fp32
// accumulator, the per-row-tile group id scalar-prefetched so that each tile's
// BlockSpec streams only its own expert's weights; its wrapper
// (repro.kernels.ops.gmm) pads every group to a multiple of block_t so that
// no tile straddles two experts.
//
// Contract: x [T, K] rows sorted into contiguous groups, w [E, K, N], both
// fp32 or both bf16; out [T, N] contiguous, x's dtype, with
//   out[t] = x[t] @ w[group_of(t)]
// summed in fp32 and rounded once. x needs unit column stride (any row
// stride), w unit stride over N (any strides over E and K). The wrapper
// (kernels/moe_gmm.py) hands over a tile plan built on the device: for each
// of ceil(T/bt) + E row tiles its group id, first row and end row. A tile
// never straddles two groups; a group of 1 row gets one tile, an empty group
// none. Group id E marks the rows past the last group, which are written as
// zeros; a tile whose end equals its first row does nothing. Any T, K and N:
// the tails are masked by bounds, so no padded copy of x is made (the
// reference needs T, K and N to tile).
//
// What bounds it on this card: at the MoE prefill's shape (OLMoE-1B-7B, 4 x
// 2048 tokens: 64 groups of 1280 capacity rows, K 2048, N 1024) operations,
// 2 * 81,920 * 2048 * 1024 = 343.6 GFLOP, 0.347 ms at the bf16 tensor-core
// peak, against 771 MB of bytes (0.23 ms at 3.35 TB/s). At a decode step's
// shape (64 groups of 32 rows) bytes: the 268 MB of expert weights read once,
// 0.08 ms. On an H100 80GB HBM3 at 700 W (chip_smoke.py's moe phase) this
// kernel takes 2.21 ms at the prefill's shape (6.4x its bound, 155 TFLOP/s;
// torch.bmm on the same equal groups 0.44 ms) and 0.20 ms at the decode's.
//
// Design, bf16: one CTA of 8 warps per (row tile of 128, column tile of 128),
// K in steps of 32. The A tile [128 x 32] and the B tile [32 x 128] are
// double-buffered in shared memory (rows padded by 8 elements against bank
// conflicts, 37 KB): the next step's tiles are loaded from device memory into
// registers while the tensor cores work on the current step, then stored
// into the other buffer, one barrier per step. Loads are 16 bytes a thread
// where the width, the strides and the base pointer allow, elements
// otherwise; out-of-bounds rows and columns load as 0. Each warp owns a
// 64 x 32 sub-tile: 4 x 2 wmma 16x16x16 bf16 fragments with fp32
// accumulators (mma.sync), the products of bf16 values exact in fp32, as the
// TPU's preferred_element_type=f32. Fragments whose rows lie past the tile's
// end are skipped, so a decode step's 32-row groups use a quarter of the
// tile's math. The epilogue stages each 16x16 fragment through shared memory
// and writes bf16 rows of 8 values (16 bytes) where aligned.
//
// Design, fp32: CUDA-core FMAs (never TF32), one CTA of 256 threads per
// (64-row tile, 64-column tile), K in steps of 16 through shared memory, each
// thread a 4 x 4 block of outputs. It serves fp32 callers such as the
// reference's own tests; the MoE path is bf16.
//
// wgmma, TMA and skipping the empty capacity rows of a group are later work.

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

extern "C" const char* gmm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
