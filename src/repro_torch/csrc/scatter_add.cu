// Sorted-id scatter-accumulate for Hopper (sm_90a): table[ids[i]] += grads[i].
//
// Replaces: scatter_add_pallas / _scatter_kernel in
// src/repro/kernels/scatter_add.py, the TPU kernel whose sequential grid walks
// the sorted ids one row at a time and keeps a run of equal ids resident in
// VMEM, so duplicates accumulate in position order and write back once.
//
// Contract: ids [B] int32 sorted ascending (equal ids adjacent), grads [B, D]
// fp32, table [N, D] fp32 updated in place. Each run of equal ids adds onto
// the row's starting value in position order, ((t + g0) + g1) + ..., which is
// what the reference's scatter_add_ref computes on sorted ids, bit for bit.
// Rows no id names are untouched; ids outside [0, N) are skipped (the
// reference's scatter drops them too).
//
// What bounds it on this card: bytes, in principle. It reads ids and grads
// once and reads and writes each touched row once; the adds are B * D, far
// below the fp32 rate. At ctr-C-scaled (256,000 nonzeros per mini-batch,
// D = 8) that is ~17 MB, ~5 us at 3.35 TB/s. In practice the longest run
// bounds it: the sum of one run is one dependent chain of fp32 adds, and at
// ctr-C-scaled the hottest key repeats ~13,000 times in one mini-batch.
//
// Design. No float atomicAdd: its order varies from launch to launch and would
// break the bitwise pipelined == serial contract. One thread per (position,
// d): a thread whose position starts a run (ids[i] != ids[i-1]) walks that run
// in order and writes the row once; every other thread exits after two id
// loads. The walk loads CHUNK ids and grads at a time into registers before
// adding them, so one memory round trip serves CHUNK adds and the run's end is
// found on the way (no search). Neighbouring threads are neighbouring d of one
// position, so their grad loads coalesce. Making hot runs fast while staying
// bitwise (a split that reproduces the serial chain) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256
#define CHUNK 32

__global__ void __launch_bounds__(NTHREADS)
scatter_add_kernel(float* __restrict__ table, const int* __restrict__ ids,
                   const float* __restrict__ grads, int N, int D, int B) {
    const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    if (t >= (long long)B * D) return;
    const int i = (int)(t / D);
    const int d = (int)(t - (long long)i * D);
    const int id = ids[i];
    if (i > 0 && ids[i - 1] == id) return;  // not the first of its run
    if (id < 0 || id >= N) return;
    float* dst = table + (size_t)id * D + d;
    float acc = *dst;
    for (int j0 = i; j0 < B; j0 += CHUNK) {
        int kid[CHUNK];
        float g[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            const int j = j0 + u;
            kid[u] = j < B ? ids[j] : id - 1;  // past the end: ends the run
            g[u] = j < B ? grads[(size_t)j * D + d] : 0.0f;
        }
        bool done = false;
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
            if (!done && kid[u] == id) acc = __fadd_rn(acc, g[u]);
            else done = true;
        }
        if (done) break;
    }
    *dst = acc;
}

// table [N, D] fp32 (updated in place), ids [B] int32 sorted, grads [B, D]
// fp32. Returns cudaGetLastError() after the launch.
extern "C" int scatter_add_launch(void* table, const int* ids, const void* grads,
                                  int N, int D, int B, void* stream) {
    const long long n = (long long)B * D;
    if (n == 0) return 0;
    const long long blocks = (n + NTHREADS - 1) / NTHREADS;
    scatter_add_kernel<<<(unsigned)blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), ids, static_cast<const float*>(grads), N, D, B);
    return (int)cudaGetLastError();
}

extern "C" const char* scatter_add_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
