// Fused embedding bag for Hopper (sm_90a): row gather + per-(example, slot)
// sum-pool, forward only.
//
// Replaces: embedding_bag_pallas / _bag_kernel in
// src/repro/kernels/embedding_bag.py, the TPU kernel whose grid walks
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
// the paper's widths (nnz 500, D 8) that is ~6 MB for a 256-example batch,
// a few microseconds at 3.35 TB/s, so launch overhead dominates.
//
// Design. The TPU grid carries the pooled tile from one nonzero step to the
// next; Hopper's blocks run in parallel, so instead each thread owns one
// (slot, d) output element of one example and walks the example's nonzeros in
// order, adding the rows whose slot is its own. The example's ids and slots
// sit in shared memory (in chunks of CHUNK nonzeros), read by the whole block
// as broadcasts. No float atomics and no [B, nnz, D] intermediate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256
#define CHUNK 1024

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
           const int* __restrict__ slot_of, const unsigned char* __restrict__ valid,
           T* __restrict__ out, int D, int nnz, int n_slots) {
    __shared__ int s_id[CHUNK];
    __shared__ int s_slot[CHUNK];
    const size_t b = blockIdx.x;
    const int task = blockIdx.y * NTHREADS + threadIdx.x;  // (slot, d) pair
    const bool active = task < n_slots * D;
    const int s = active ? task / D : -2;
    const int d = active ? task - s * D : 0;
    float acc = 0.0f;
    for (int n0 = 0; n0 < nnz; n0 += CHUNK) {
        const int len = min(CHUNK, nnz - n0);
        __syncthreads();
        for (int i = threadIdx.x; i < len; i += NTHREADS) {
            const size_t g = b * nnz + n0 + i;
            const int sl = slot_of[g];
            // invalid or out-of-range nonzeros get slot -1: no thread owns it
            s_slot[i] = (valid[g] != 0 && sl >= 0 && sl < n_slots) ? sl : -1;
            s_id[i] = ids[g];
        }
        __syncthreads();
        if (active) {
            for (int i = 0; i < len; ++i)
                if (s_slot[i] == s) acc += to_f32(table[(size_t)s_id[i] * D + d]);
        }
    }
    if (active) store(out + (b * n_slots + s) * D + d, acc);
}

// table [N, D] (fp32, or bf16 when is_bf16), ids/slot_of [B, nnz] int32,
// valid [B, nnz] bool, out [B, n_slots, D] of the table's type.
// Returns cudaGetLastError() after the launch.
extern "C" int embedding_bag_launch(const void* table, const int* ids, const int* slot_of,
                                    const unsigned char* valid, void* out, int D, int B,
                                    int nnz, int n_slots, int is_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid(B, (n_slots * D + NTHREADS - 1) / NTHREADS);
    if (is_bf16)
        bag_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(table), ids, slot_of, valid,
            static_cast<__nv_bfloat16*>(out), D, nnz, n_slots);
    else
        bag_kernel<float><<<grid, NTHREADS, 0, st>>>(
            static_cast<const float*>(table), ids, slot_of, valid,
            static_cast<float*>(out), D, nnz, n_slots);
    return (int)cudaGetLastError();
}

extern "C" const char* embedding_bag_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
