// Embedding-row gather for Hopper (sm_90a): out[i] = table[ids[i]].
//
// Replaces: embedding_lookup_pallas / _gather_kernel in
// src/repro/kernels/embedding_lookup.py, the TPU kernel whose grid walks
// (row, d-tile) blocks with the row ids scalar-prefetched, so the pipeline's
// HBM->VMEM DMAs fetch the right rows; its body is a plain copy. It is the
// HBM-PS ``get`` of the working table and the LM's token-embedding gather.
//
// Contract: table [N, D] fp32 or bf16 with unit column stride and any row
// stride (a view of a wider table is fine), ids [B] int32 in [0, N) (not
// checked, not clamped: the caller's contract, as for the bag), out [B, D]
// contiguous, of the table's dtype. The copy moves bits, so out equals
// table[ids] bit for bit. Any D, unlike the reference's D % min(2048, D) == 0.
//
// What bounds it on this card: bytes. It reads B ids and each distinct row
// once and writes B rows, with no arithmetic: at the LM prefill's shape
// (8192 ids into a [3729, 4096] fp32 working table) ~195 MB, 58 us at
// 3.35 TB/s, where a plain device-to-device copy of the output's size runs
// at ~2.9 TB/s on an H100. At small B (896 ids of 384 columns, whisper's
// prefill) the bytes take well under a microsecond, and two dependent trips
// to memory, the id's and then the row's, set the time;
// kernels/embedding_lookup.py's ``embedding_lookup_floor_cuda`` times that
// floor (the same grid loading each row's id and first chunk only).
//
// Design. The wrapper's ``lookup_plan`` fixes every launch number; this file
// takes them as arguments. A row is C chunks: 16 bytes where the row bytes,
// the row strides and both pointers are multiples of 16, else one element
// (uint16 for bf16, uint32 for fp32: still a bit copy). Two kernels:
//
// * ``lookup_kernel_subwarp`` (the path): a row gets L lanes, the smallest
//   power of two >= C up to 32, so a warp serves R = 32 / L rows at once
//   (16 at D = 8 fp32, where a warp a row left 30 lanes idle). A warp's task
//   is up to 8 batches of R rows (rows of at most L chunks), or one piece of
//   up to 4 chunks a lane of a row batch; it loads the task's ids in one
//   coalesced load, hands each row group its id by shuffle, and issues all
//   of a lane's loads (up to 8 16-byte chunks in registers) before any
//   store, so the two dependent trips are made once a task and a lane keeps
//   several loads in flight (the first port's kernel stored each chunk before loading
//   the next). 64 registers at most (4 blocks an SM). The
//   stores are evict-first (st.global.cs), so repeated table rows keep their
//   place in L2 against the output's stream. The plan runs a task a warp (a
//   grid capped at a few resident blocks an SM, each warp looping over tasks,
//   was slower at Yi-9B's prefill: tools/lookup_timing.py's ``plans``
//   sweep), batches fewer rows where there are few, and where there are
//   fewer rows than SMs (a decode step's 4) cuts them into pieces. Indices
//   are 32-bit (the wrapper refuses row strides of 2^32 chunks and more).
// * ``lookup_kernel_warp``: the first port's kernel, one warp a row, each lane's
//   loop storing a chunk before it loads the next; kept by name (variant
//   "warp") to be timed beside the subwarp kernel, on no path.
//
// Wide rows take no TMA path: one elected lane a row moving 16 KB rows
// through a shared-memory ring with 1-D bulk copies was slower than the
// subwarp kernel at Yi-9B's prefill (PERF.md row 3), whose lanes already
// keep four 16-byte loads each in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256
#define WARPS (NTHREADS / 32)
#define UNROLL 8         // chunks a lane holds in registers: kernels/embedding_lookup.py's UNROLL

// ------------------------------------------------- "warp" (the first port's)

template <typename U>
__global__ void __launch_bounds__(NTHREADS)
lookup_kernel_warp(const U* __restrict__ table, const int* __restrict__ ids, U* __restrict__ out,
                   long long row_stride, int n_per_row, int B) {
    const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (i >= B) return;
    const int lane = threadIdx.x & 31;
    const U* src = table + (long long)ids[i] * row_stride;
    U* dst = out + (long long)i * n_per_row;
    for (int c = lane; c < n_per_row; c += 32) dst[c] = src[c];
}

// ---------------------------------------------------------------- "subwarp"

// Task t of ``tasks`` = (row block t / pieces, piece t % pieces). Lane
// (g, l) = (lane / L, lane % L), item i < ITEMS: where BY_ROWS, row base +
// i R + g and chunk piece L + l (a task is ITEMS batches of R rows; pieces
// is 1 unless ITEMS is); else row base + g and chunk piece L ITEMS + i L + l
// (a task is one piece of ITEMS chunks a lane of R rows). Chunks at or past ``C_copy``
// are skipped (C_copy = C, or 1 for the floor probe); out's rows are C
// chunks apart.
template <typename U, int L, int ITEMS, bool BY_ROWS>
__global__ void __launch_bounds__(NTHREADS, 4)
lookup_kernel_subwarp(const U* __restrict__ table, const int* __restrict__ ids,
                      U* __restrict__ out, unsigned row_stride, int C, int C_copy, int B,
                      int pieces, int tasks) {
    constexpr int R = 32 / L;
    constexpr int ROWS = BY_ROWS ? R * ITEMS : R;  // rows a task
    constexpr int IDS = BY_ROWS ? ITEMS : 1;       // row ids a lane needs
    constexpr int K = BY_ROWS ? 1 : ITEMS;         // chunks a lane of one row
    constexpr int IDREGS = (ROWS + 31) / 32;       // a task's ids, 32 to a register
    const int lane = threadIdx.x & 31, g = lane / L, l = lane % L;
    const int n_warps = (gridDim.x * blockDim.x) >> 5;
    for (int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; t < tasks; t += n_warps) {
        const int blk = pieces == 1 ? t : t / pieces, piece = t - blk * pieces;
        const int base = blk * ROWS;
        int idreg[IDREGS];
#pragma unroll
        for (int s = 0; s < IDREGS; ++s) {
            const int r = base + s * 32 + lane;
            idreg[s] = (s * 32 + lane < ROWS && r < B) ? __ldg(ids + r) : 0;
        }
        int rowid[IDS];
#pragma unroll
        for (int j = 0; j < IDS; ++j)  // row j R + g sits in lane (j R + g) % 32 of register j R / 32
            rowid[j] = __shfl_sync(0xffffffffu, idreg[(j * R) >> 5], (j * R + g) & 31);
        const int c0 = piece * L * K + l;
        U buf[ITEMS];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {  // every load of the task first ...
            const int r = base + (BY_ROWS ? i * R : 0) + g, c = c0 + (BY_ROWS ? 0 : i * L);
            if (r < B && c < C_copy)
                buf[i] = __ldg(table + (unsigned long long)(unsigned)rowid[BY_ROWS ? i : 0]
                                          * row_stride + c);
        }
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {  // ... then its stores
            const int r = base + (BY_ROWS ? i * R : 0) + g, c = c0 + (BY_ROWS ? 0 : i * L);
            if (r < B && c < C_copy)
                __stcs(out + (unsigned long long)(unsigned)r * (unsigned)C + c, buf[i]);
        }
    }
}

// ------------------------------------------------------------------- launch

template <typename U, int L, bool BY_ROWS>
static void launch_items(const U* t, const int* ids, U* o, unsigned row_stride, int C,
                         int C_copy, int B, int items, int pieces, int tasks, int grid,
                         int block, cudaStream_t s) {
#define ITEMS_CASE(I)                                                                     \
    case I:                                                                               \
        lookup_kernel_subwarp<U, L, I, BY_ROWS><<<grid, block, 0, s>>>(                    \
            t, ids, o, row_stride, C, C_copy, B, pieces, tasks);                          \
        break;
    switch (items) { ITEMS_CASE(1) ITEMS_CASE(2) ITEMS_CASE(4) ITEMS_CASE(8) }
#undef ITEMS_CASE
}

// Batches of rows (rb > 1, or one chunk a lane) at any L; pieces of k > 1
// chunks a lane only at L = 32 (a row wider than a warp's lanes).
template <typename U>
static int launch_subwarp(const void* table, const int* ids, void* out, unsigned row_stride,
                          int C, int C_copy, int B, int lanes, int rb, int k, int pieces,
                          int tasks, int grid, int block, cudaStream_t s) {
    const int items = rb * k;
    if ((rb != 1 && k != 1) || items > UNROLL || (items & (items - 1)) || (k > 1 && lanes != 32))
        return (int)cudaErrorInvalidValue;
    const U* t = static_cast<const U*>(table);
    U* o = static_cast<U*>(out);
    if (k > 1) {
        launch_items<U, 32, false>(t, ids, o, row_stride, C, C_copy, B, items, pieces, tasks,
                                   grid, block, s);
        return (int)cudaGetLastError();
    }
#define LANES_CASE(LL)                                                                   \
    case LL:                                                                             \
        launch_items<U, LL, true>(t, ids, o, row_stride, C, C_copy, B, items, pieces,    \
                                  tasks, grid, block, s);                                \
        break;
    switch (lanes) {
        LANES_CASE(1) LANES_CASE(2) LANES_CASE(4) LANES_CASE(8) LANES_CASE(16) LANES_CASE(32)
        default: return (int)cudaErrorInvalidValue;
    }
#undef LANES_CASE
    return (int)cudaGetLastError();
}

// table: [N, D] with row stride ``row_stride`` elements; elem_bytes 4 (fp32)
// or 2 (bf16); out [B, D] contiguous. vec16 != 0 when the wrapper found the
// row bytes, the row strides and both pointers 16-byte aligned. variant 0
// "subwarp", 1 "warp"; the other numbers are lookup_plan's (lanes, rb, k,
// pieces, tasks for subwarp; grid and block for both). first_only != 0 copies
// each row's first chunk only (the floor probe, subwarp). Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for numbers
// it does not take).
extern "C" int embedding_lookup_launch(const void* table, const int* ids, void* out,
                                       long long row_stride, int D, int B, int elem_bytes,
                                       int vec16, int variant, int lanes, int rb, int k,
                                       int pieces, int tasks, int grid, int block,
                                       int first_only, void* stream) {
    if (B == 0 || D == 0) return 0;
    if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int per = vec16 ? 16 / elem_bytes : 1;  // elements a chunk
    const int C = D / per;
    const long long stride = row_stride / per;
    if (variant == 0) {
        const int C_copy = first_only ? 1 : C;
        if (stride >= (1ll << 32)) return (int)cudaErrorInvalidValue;
        if (vec16)
            return launch_subwarp<uint4>(table, ids, out, (unsigned)stride, C, C_copy, B, lanes, rb, k,
                                         pieces, tasks, grid, block, s);
        if (elem_bytes == 4)
            return launch_subwarp<uint32_t>(table, ids, out, (unsigned)stride, C, C_copy, B, lanes, rb, k,
                                            pieces, tasks, grid, block, s);
        return launch_subwarp<uint16_t>(table, ids, out, (unsigned)stride, C, C_copy, B, lanes, rb, k,
                                        pieces, tasks, grid, block, s);
    }
    if (variant != 1 || first_only) return (int)cudaErrorInvalidValue;
    if (vec16) {
        lookup_kernel_warp<uint4><<<grid, NTHREADS, 0, s>>>(
            static_cast<const uint4*>(table), ids, static_cast<uint4*>(out), stride, C, B);
    } else if (elem_bytes == 4) {
        lookup_kernel_warp<uint32_t><<<grid, NTHREADS, 0, s>>>(
            static_cast<const uint32_t*>(table), ids, static_cast<uint32_t*>(out), stride, C, B);
    } else {
        lookup_kernel_warp<uint16_t><<<grid, NTHREADS, 0, s>>>(
            static_cast<const uint16_t*>(table), ids, static_cast<uint16_t*>(out), stride, C, B);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* embedding_lookup_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
