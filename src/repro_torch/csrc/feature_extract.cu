// Streaming feature extraction for Hopper (sm_90a): splitmix64 key hash
// modulo the key space, then a slot hash of the finished key modulo the slot
// count.
//
// Replaces: feature_extract_pallas / _extract_kernel in
// src/repro/kernels/feature_extract.py, the TPU kernel that carries every
// 64-bit quantity as a pair of u32 planes (16-bit-limb multiplies, 64-step
// binary long division for the modulo) because the TPU has no 64-bit integer
// lanes. Hopper has them: here the math is native unsigned long long, and
// u64 wrap-around is exact, so the result equals numpy's u64 splitmix64
// (the host feeder's extract_host) bit for bit.
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
// about half of them valid) ~17.4 MB, ~5.2 us at 3.35 TB/s. The integer work
// is two splitmix64 rounds and two modulos a valid position.
//
// Design (``feature_extract_kernel_recip``, the path). Each modulo is a
// multiply by a precomputed reciprocal: for a modulus d that is not a power
// of two the wrapper computes, in Python integers, Granlund and
// Montgomery's round-up multiplier m = floor(2^64 (2^l - d) / d) + 1 with
// l = ceil(log2 d) and s = l - 1, exact for every u64 dividend n:
//     t = umulhi(n, m),  q = (t + ((n - t) >> 1)) >> s,  n % d = n - q d;
// a power of two is a mask (d = 1 gives 0). That is a handful of 32-bit
// multiplies where a runtime ``%`` calls a long-division subroutine of many
// instructions (kernels/feature_extract.py's ``umod_model`` is the same
// arithmetic in Python, tested against ``%``). Each thread takes 4
// consecutive positions: ``valid`` in one 4-byte load, the raw ids of the
// valid ones only (8-byte loads, all issued before any hashing), the keys
// out as two 16-byte stores and the slots as one; a ragged tail goes
// position by position. A grid-stride loop; no shared memory, no atomics.
//
// ``feature_extract_kernel_div`` is the first port's kernel, one position a thread
// with the two runtime ``%``; kept by name (variant "div") to be timed
// beside it, on no path.

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

struct Mod {  // n % d by a multiply: m == 0 for a power of two (mask d - 1)
    u64 d, m;
    unsigned s;
};

__device__ __forceinline__ u64 umod(u64 n, const Mod& md) {
    if (md.m == 0) return n & (md.d - 1);
    const u64 t = __umul64hi(n, md.m);
    const u64 q = (t + ((n - t) >> 1)) >> md.s;
    return n - q * md.d;
}

__global__ void __launch_bounds__(NTHREADS)
feature_extract_kernel_recip(const u64* __restrict__ raw, const unsigned char* __restrict__ valid,
                             u64* __restrict__ keys, int* __restrict__ slots, long long n,
                             Mod key_mod, Mod slot_mod, u64 key_seed, u64 slot_seed,
                             int valid_vec) {
    const long long groups = (n + 3) >> 2;
    for (long long gi = (long long)blockIdx.x * NTHREADS + threadIdx.x; gi < groups;
         gi += (long long)gridDim.x * NTHREADS) {
        const long long i0 = gi << 2;
        const int m = n - i0 < 4 ? (int)(n - i0) : 4;  // positions of this group
        uint32_t v4 = 0;
        if (m == 4 && valid_vec) {
            v4 = __ldg(reinterpret_cast<const uint32_t*>(valid + i0));
        } else {
            for (int j = 0; j < m; ++j) v4 |= (uint32_t)__ldg(valid + i0 + j) << (8 * j);
        }
        u64 r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = (v4 >> (8 * j)) & 0xFF ? __ldg(raw + i0 + j) : 0;
        u64 k[4];
        int sl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            k[j] = 0;
            sl[j] = 0;
            if ((v4 >> (8 * j)) & 0xFF) {
                k[j] = umod(splitmix64(r[j] ^ key_seed), key_mod);
                sl[j] = (int)umod(splitmix64(k[j] ^ slot_seed), slot_mod);
            }
        }
        if (m == 4) {
            reinterpret_cast<ulonglong2*>(keys + i0)[0] = make_ulonglong2(k[0], k[1]);
            reinterpret_cast<ulonglong2*>(keys + i0)[1] = make_ulonglong2(k[2], k[3]);
            *reinterpret_cast<int4*>(slots + i0) = make_int4(sl[0], sl[1], sl[2], sl[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < m) {
                    keys[i0 + j] = k[j];
                    slots[i0 + j] = sl[j];
                }
            }
        }
    }
}

__global__ void __launch_bounds__(NTHREADS)
feature_extract_kernel_div(const u64* __restrict__ raw, const unsigned char* __restrict__ valid,
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
// wrapper); (key_m, key_s) and (slot_m, slot_s) their reciprocals
// (kernels/feature_extract.py's umod_magic; m = 0 for a power of two).
// variant 0 "recip", 1 "div". valid_vec != 0 where valid is 4-byte aligned;
// keys and slots must be 16-byte aligned (the wrapper allocates them).
// Returns cudaGetLastError().
extern "C" int feature_extract_launch(const void* raw, const void* valid, void* keys,
                                      void* slots, long long n, u64 n_keys, u64 key_m,
                                      int key_s, u64 n_slots, u64 slot_m, int slot_s,
                                      u64 key_seed, u64 slot_seed, int variant, int valid_vec,
                                      int max_blocks, void* stream) {
    if (n == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const u64* r = static_cast<const u64*>(raw);
    const unsigned char* v = static_cast<const unsigned char*>(valid);
    u64* k = static_cast<u64*>(keys);
    int* s = static_cast<int*>(slots);
    const long long items = variant == 0 ? (n + 3) / 4 : n;
    const long long want = (items + NTHREADS - 1) / NTHREADS;
    const unsigned grid = (unsigned)(want < max_blocks ? want : max_blocks);
    if (variant == 0) {
        feature_extract_kernel_recip<<<grid, NTHREADS, 0, st>>>(
            r, v, k, s, n, Mod{n_keys, key_m, (unsigned)key_s},
            Mod{n_slots, slot_m, (unsigned)slot_s}, key_seed, slot_seed, valid_vec);
    } else if (variant == 1) {
        feature_extract_kernel_div<<<grid, NTHREADS, 0, st>>>(r, v, k, s, n, n_keys, n_slots,
                                                              key_seed, slot_seed);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* feature_extract_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
