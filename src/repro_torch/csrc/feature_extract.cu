// Streaming feature extraction for Hopper (sm_90a): splitmix64 key hash
// modulo the key space, then a slot hash of the finished key modulo the slot
// count, one thread per element.
//
// Replaces: feature_extract_pallas / _extract_kernel in
// src/repro/kernels/feature_extract.py, the TPU kernel that carries every
// 64-bit quantity as a pair of u32 planes (16-bit-limb multiplies, 64-step
// binary long division for the modulo) because the TPU has no 64-bit integer
// lanes. Hopper has them: here the math is native unsigned long long, and
// u64 wrap-around and % are exact, so the result equals numpy's u64
// splitmix64 (the host feeder's extract_host) bit for bit by construction.
//
// Contract, per element i (the reference's _extract_math):
//     key  = splitmix64(raw[i] ^ key_seed) % n_keys
//     slot = splitmix64(key ^ slot_seed) % n_slots     (the *finished* key)
//     invalid positions (valid[i] == 0) give key 0 and slot 0.
//
// Layout. The raw ids come in as one u64 plane (an int64 tensor holding the
// bit pattern) and the keys go out as one u64 plane, which is what the
// parameter-server pull wants on the host; the reference's (hi, lo) u32
// pairs exist only for the TPU. The slot goes out as int32; the wrapper
// guarantees n_slots < 2^31, so the cast never turns negative.
//
// What bounds it on this card. Bytes: 1 (valid) in and 8 (key) + 4 (slot)
// out per position, and 8 (raw) in per valid position only, since a padded
// position never loads its id: at ctr-C-scaled (2048 x 500 positions,
// about half of them valid) ~17.4 MB, ~5.2 us at 3.35 TB/s. The integer work is two splitmix64 rounds
// (a few 64-bit multiplies each, 3-4 int32 IMADs apiece) and two 64-bit
// divisions by a runtime modulus, which nvcc emits as a subroutine of many
// instructions; that may put the kernel above the bytes bound. A later
// version can replace the divisions with a precomputed 128-bit reciprocal.
//
// Design. A grid-stride loop, one element per thread per step: neighbouring
// threads read neighbouring 8-byte ids and mask bytes, so every load and
// store is coalesced. No shared memory, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256

typedef unsigned long long u64;

__device__ __forceinline__ u64 splitmix64(u64 z) {
    z += 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

__global__ void __launch_bounds__(NTHREADS)
feature_extract_kernel(const u64* __restrict__ raw, const unsigned char* __restrict__ valid,
                       u64* __restrict__ keys, int* __restrict__ slots, long long n,
                       u64 n_keys, u64 n_slots, u64 key_seed, u64 slot_seed) {
    for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * NTHREADS) {
        u64 key = 0, slot = 0;
        if (valid[i]) {
            key = splitmix64(raw[i] ^ key_seed) % n_keys;
            slot = splitmix64(key ^ slot_seed) % n_slots;
        }
        keys[i] = key;
        slots[i] = (int)slot;
    }
}

// raw [n] u64, valid [n] bytes (0 = padding) -> keys [n] u64, slots [n]
// int32. 0 < n_keys <= 2^63 and 0 < n_slots < 2^31 (checked by the
// wrapper). Returns cudaGetLastError().
extern "C" int feature_extract_launch(const void* raw, const void* valid, void* keys,
                                      void* slots, long long n, u64 n_keys, u64 n_slots,
                                      u64 key_seed, u64 slot_seed, int max_blocks,
                                      void* stream) {
    if (n == 0) return 0;
    const long long want = (n + NTHREADS - 1) / NTHREADS;
    const unsigned grid = (unsigned)(want < max_blocks ? want : max_blocks);
    feature_extract_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const u64*>(raw), static_cast<const unsigned char*>(valid),
        static_cast<u64*>(keys), static_cast<int*>(slots), n, n_keys, n_slots, key_seed,
        slot_seed);
    return (int)cudaGetLastError();
}

extern "C" const char* feature_extract_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
