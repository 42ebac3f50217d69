// Fused embedding bag for Hopper (sm_90a): row gather + per-(example, slot)
// sum-pool, forward only.
//
// Replaces: embedding_bag_pallas / _bag_kernel in
// src/repro/kernels/embedding_bag.py:63, the TPU kernel whose grid walks
// (example, d-tile, nonzero) in order, DMAs one table row per step and adds it
// into a VMEM-resident [n_slots, block_d] tile.
//
// Contract: out[b, s, :] = sum over n of table[ids[b, n], :] for the nonzeros
// with valid[b, n] and slot_of[b, n] == s, accumulated in fp32 for fp32 and
// bf16 tables and cast to the table's type once. Each (b, s, d) sums in
// ascending n, the TPU kernel's order, so two launches give the same bits and
// dyadic inputs match the oracle bitwise. slot_of outside [0, n_slots) is
// dropped, as the TPU kernel and the one-hot oracle drop it. Invalid nonzeros
// are never read, so their ids may be anything; valid ids must lie in [0, N).
//
// What bounds it on this card: bytes. Per example it reads nnz ids, slots and
// mask bytes and the valid rows (D * 4 bytes each at fp32), and writes
// n_slots * D values; the adds are B * nnz * D, far below the fp32 rate. At
// ctr-C's widths (nnz 500, 125 slots, D 8) that is ~4.6 MB for a
// 512-example mini-batch, ~2.4 us at 3.35 TB/s, so launch overhead and the
// latency of the row loads dominate.
//
// Design: a per-example stable counting sort by slot, so that the work is
// O(nnz * D) per example (the TPU kernel's docstring: no dense one-hot). One
// CTA of 256 threads per (example, range of slots, range of d-vectors): as
// many slots as the CTA has threads for their d-vectors (125 slots x 2
// vectors of 4 floats at ctr-C, one CTA per example). For each chunk of up to
// CHUNK nonzeros:
//   1. Load: each warp takes a contiguous, ascending stretch of the chunk,
//      32 nonzeros a step, and keeps each one's local slot (-1 if invalid,
//      or outside the CTA's slots) and id in registers.
//   2. Stable counting sort in shared memory: per warp and slot counts, from
//      __match_any_sync on the slot (the lowest lane of each set of peers
//      adds their number; integers, so deterministic); an exclusive scan over
//      (slot, warp) gives each warp's first position in each slot's list;
//      each warp walks its stretch again and writes each id at that position
//      plus the number of earlier peers in its step (__popc of the peers
//      below its lane), then advances the position. Lists come out in
//      ascending n.
//   3. Sum: each (slot, d-vector) thread walks its slot's list in order,
//      issuing up to 8 row loads (16 bytes each for fp32 with D % 4 == 0)
//      before their adds, into fp32 registers that carry over to the next
//      chunk. An empty slot writes 0.
// No float atomics and no [B, nnz, D] intermediate. On an H100 80GB HBM3 at
// 700 W (chip_smoke.py) it takes 0.006-0.007 ms for a 256-example serving
// request and 0.013 ms for a 512-example training mini-batch, against
// F.embedding_bag's 0.021-0.034 and 0.036 on bags sorted beforehand; the
// kernel it replaced, one thread per (slot, d) scanning all of an example's
// nonzeros, took 0.072 and 0.139.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define CHUNK 2048                    // nonzeros per pass
#define PER_LANE (CHUNK / NTHREADS)   // nonzeros a lane holds per pass
#define AHEAD 8                       // row loads in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// VEC consecutive elements of a row, loaded at once (the wrapper aligns VEC > 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
    T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
bag_sort_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                const int* __restrict__ slot_of, const unsigned char* __restrict__ valid,
                T* __restrict__ out, int D, int nnz, int n_slots, int slots_cta, int vecs_cta) {
    __shared__ int s_sorted[CHUNK];          // the chunk's kept ids, by slot then n
    __shared__ int s_pos[NWARPS][NTHREADS];  // per warp and local slot: count, then position
    __shared__ int s_start[NTHREADS + 1];    // each local slot's list in s_sorted
    __shared__ int s_wsum[NWARPS];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t b = blockIdx.x;
    const int s0 = blockIdx.y * slots_cta;
    const int n_sl = min(slots_cta, n_slots - s0);  // this CTA's slots
    const int v0 = blockIdx.z * vecs_cta;
    const int n_v = min(vecs_cta, D / VEC - v0);    // and d-vectors
    const bool active = tid < n_sl * n_v;
    const int my_slot = active ? tid / n_v : 0;
    const int my_vec = v0 + (active ? tid % n_v : 0);
    const unsigned lanes_below = (1u << lane) - 1u;

    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;

    for (int c0 = 0; c0 < nnz; c0 += CHUNK) {
        const int len = min(CHUNK, nnz - c0);
        // each warp's stretch: a multiple of 32 nonzeros, at most PER_LANE steps
        const int steps = (len + NTHREADS - 1) / NTHREADS;
        const int first = warp * steps * 32;
        for (int i = tid; i < NWARPS * NTHREADS; i += NTHREADS) (&s_pos[0][0])[i] = 0;
        __syncthreads();  // also: the previous chunk's sum has read s_sorted

        // 1. load, and count per (warp, slot)
        int ls[PER_LANE], id[PER_LANE];
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
            ls[j] = -1;
            id[j] = 0;
            if (j < steps) {  // uniform over the block
                const int i = first + 32 * j + lane;
                if (i < len) {
                    const size_t g = b * nnz + c0 + i;
                    const int s = slot_of[g] - s0;
                    if (valid[g] != 0 && s >= 0 && s < n_sl) {
                        ls[j] = s;
                        id[j] = ids[g];
                    }
                }
                const unsigned peers = __match_any_sync(0xffffffffu, ls[j]);
                if (ls[j] >= 0 && (peers & lanes_below) == 0)
                    s_pos[warp][ls[j]] += __popc(peers);
                __syncwarp();
            }
        }
        __syncthreads();

        // 2. exclusive scan over (slot, warp): thread t owns local slot t
        int total = 0;
        if (tid < n_sl) {
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) {
                const int c = s_pos[w][tid];
                s_pos[w][tid] = total;
                total += c;
            }
        }
        int incl = total;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += y;
        }
        if (lane == 31) s_wsum[warp] = incl;
        __syncthreads();
        int base = incl - total;
        for (int w = 0; w < warp; ++w) base += s_wsum[w];
        if (tid < n_sl) {
            s_start[tid] = base;
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) s_pos[w][tid] += base;
            if (tid == n_sl - 1) s_start[n_sl] = base + total;
        }
        __syncthreads();

        //    place each kept id at its warp's running position in its slot
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
            if (j < steps) {
                const unsigned peers = __match_any_sync(0xffffffffu, ls[j]);
                int at = 0;
                if (ls[j] >= 0) {
                    at = s_pos[warp][ls[j]];
                    s_sorted[at + __popc(peers & lanes_below)] = id[j];
                }
                __syncwarp();
                if (ls[j] >= 0 && (peers & lanes_below) == 0)
                    s_pos[warp][ls[j]] = at + __popc(peers);
                __syncwarp();
            }
        }
        __syncthreads();

        // 3. sum this thread's slot list in ascending n, loads issued ahead
        if (active) {
            const int end = s_start[my_slot + 1];
            const T* col = table + (size_t)my_vec * VEC;
            for (int j = s_start[my_slot]; j < end; j += AHEAD) {
                Vec<T, VEC> r[AHEAD];
#pragma unroll
                for (int u = 0; u < AHEAD; ++u)
                    if (j + u < end)
                        r[u] = *reinterpret_cast<const Vec<T, VEC>*>(
                            col + (size_t)s_sorted[j + u] * D);
#pragma unroll
                for (int u = 0; u < AHEAD; ++u)
                    if (j + u < end) {
#pragma unroll
                        for (int e = 0; e < VEC; ++e) acc[e] += to_f32(r[u].v[e]);
                    }
            }
        }
    }
    if (active) {
        T* dst = out + (b * n_slots + s0 + my_slot) * D + (size_t)my_vec * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) store(dst + e, acc[e]);
    }
}

template <typename T, int VEC>
static int launch(const void* table, const int* ids, const int* slot_of,
                  const unsigned char* valid, void* out, int D, int B, int nnz, int n_slots,
                  cudaStream_t st) {
    const int n_vec = D / VEC;
    const int vecs_cta = n_vec < NTHREADS ? n_vec : NTHREADS;
    const int slots_cta = NTHREADS / vecs_cta;
    const dim3 grid(B, (n_slots + slots_cta - 1) / slots_cta, (n_vec + vecs_cta - 1) / vecs_cta);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    bag_sort_kernel<T, VEC><<<grid, NTHREADS, 0, st>>>(
        static_cast<const T*>(table), ids, slot_of, valid, static_cast<T*>(out), D, nnz, n_slots,
        slots_cta, vecs_cta);
    return (int)cudaGetLastError();
}

// table [N, D] (fp32, or bf16 when is_bf16), ids/slot_of [B, nnz] int32,
// valid [B, nnz] bool, out [B, n_slots, D] of the table's type. vec4 != 0
// when D % 4 == 0 and the table's base is aligned to 4 elements (the
// wrapper checks), so rows load 4 elements at a time. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a grid
// too large.
extern "C" int embedding_bag_launch(const void* table, const int* ids, const int* slot_of,
                                    const unsigned char* valid, void* out, int D, int B,
                                    int nnz, int n_slots, int is_bf16, int vec4, void* stream) {
    if (B == 0 || n_slots == 0 || D == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return vec4 ? launch<__nv_bfloat16, 4>(table, ids, slot_of, valid, out, D, B, nnz,
                                               n_slots, st)
                    : launch<__nv_bfloat16, 1>(table, ids, slot_of, valid, out, D, B, nnz,
                                               n_slots, st);
    return vec4 ? launch<float, 4>(table, ids, slot_of, valid, out, D, B, nnz, n_slots, st)
                : launch<float, 1>(table, ids, slot_of, valid, out, D, B, nnz, n_slots, st);
}

extern "C" const char* embedding_bag_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
