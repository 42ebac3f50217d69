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
// once and writes B rows, with no arithmetic. At the LM prefill's shape
// (8192 ids into a [3729, 4096] fp32 working table) that is ~195 MB, 58 us
// at 3.35 TB/s; it took 71-76 us on an H100 80GB HBM3 at 700 W
// (chip_smoke.py's lm phase), rows read again for repeated ids coming from
// L2. A decode step's 4 rows take well under a microsecond of bandwidth, so
// launch latency sets its time (~3 us).
//
// Design. One warp per output row: the warp loads its id once and its 32
// lanes copy neighbouring 16-byte chunks of the row, so every load and store
// is a coalesced 512-byte transaction. When the row's bytes, the two row
// strides and both base pointers are all multiples of 16, the copy is in
// uint4; otherwise it copies element by element in the element's own width
// (uint16 for bf16, uint32 for fp32), which is still a bit copy.

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256
#define WARPS (NTHREADS / 32)

template <typename U>
__global__ void __launch_bounds__(NTHREADS)
lookup_kernel(const U* __restrict__ table, const int* __restrict__ ids, U* __restrict__ out,
              long long row_stride, int n_per_row, int B) {
    const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (i >= B) return;
    const int lane = threadIdx.x & 31;
    const U* src = table + (long long)ids[i] * row_stride;
    U* dst = out + (long long)i * n_per_row;
    for (int c = lane; c < n_per_row; c += 32) dst[c] = src[c];
}

// table: [N, D] with row stride ``row_stride`` elements; elem_bytes 4 (fp32)
// or 2 (bf16); out [B, D] contiguous. vec16 != 0 when the wrapper found the
// row bytes, the row strides and both pointers 16-byte aligned. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for an
// element width it does not take).
extern "C" int embedding_lookup_launch(const void* table, const int* ids, void* out,
                                       long long row_stride, int D, int B, int elem_bytes,
                                       int vec16, void* stream) {
    if (B == 0 || D == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
    if (vec16) {
        const int per = 16 / elem_bytes;
        lookup_kernel<uint4><<<blocks, NTHREADS, 0, s>>>(
            static_cast<const uint4*>(table), ids, static_cast<uint4*>(out),
            row_stride / per, D / per, B);
    } else if (elem_bytes == 4) {
        lookup_kernel<uint32_t><<<blocks, NTHREADS, 0, s>>>(
            static_cast<const uint32_t*>(table), ids, static_cast<uint32_t*>(out),
            row_stride, D, B);
    } else if (elem_bytes == 2) {
        lookup_kernel<uint16_t><<<blocks, NTHREADS, 0, s>>>(
            static_cast<const uint16_t*>(table), ids, static_cast<uint16_t*>(out),
            row_stride, D, B);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* embedding_lookup_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
