// Fused row-Adagrad for Hopper (sm_90a): one flat elementwise pass.
//
// Replaces: adagrad_pallas / _adagrad_kernel in
// src/repro/kernels/fused_adagrad.py, the TPU kernel that tiles [rows, D] into
// (8, 128)-aligned VMEM blocks (its wrapper repacks any working set into a
// [rows, 128] layout to fit them).
//
// Contract, per element, fp32, with exactly these roundings:
//     a' = a + g*g                        (product rounded, then the sum)
//     p' = p - (lr*g) / (sqrt(a') + eps)  (each operation rounded)
// which is the reference's adagrad_ref bit for bit. The __f*_rn intrinsics
// are never contracted into an FMA, whatever -fmad says; a g*g + a FMA would
// reproduce the Pallas kernel in interpret mode, not the reference.
// __fsqrt_rn and __fdiv_rn are the correctly rounded sqrt and division.
//
// What bounds it on this card: bytes. It reads p, a, g and writes p', a':
// 20 bytes per element for ~6 fp32 operations. At ctr-C-scaled (~269k working
// rows x 8) that is ~43 MB, ~13 us at 3.35 TB/s.
//
// Design. The TPU's (8, 128) tiling and repack are gone: the arrays are
// treated as one flat vector of n = rows * D elements. Each thread handles
// four neighbouring elements with 16-byte loads and stores when all five
// pointers are 16-byte aligned (a grid-stride loop), and the last n % 4
// elements, or all of them for unaligned pointers, go through a scalar loop.
// The outputs are separate buffers (the wrapper allocates them), as the
// __restrict__ inputs require.

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256

__device__ __forceinline__ void adagrad1(float p, float a, float g, float lr, float eps,
                                         float* po, float* ao) {
    const float a2 = __fadd_rn(a, __fmul_rn(g, g));
    const float den = __fadd_rn(__fsqrt_rn(a2), eps);
    *ao = a2;
    *po = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g), den));
}

__global__ void __launch_bounds__(NTHREADS)
adagrad_vec4_kernel(const float4* __restrict__ p, const float4* __restrict__ a,
                    const float4* __restrict__ g, float4* po, float4* ao,
                    long long n4, float lr, float eps) {
    for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x; i < n4;
         i += (long long)gridDim.x * NTHREADS) {
        const float4 pv = p[i], av = a[i], gv = g[i];
        float4 pw, aw;
        adagrad1(pv.x, av.x, gv.x, lr, eps, &pw.x, &aw.x);
        adagrad1(pv.y, av.y, gv.y, lr, eps, &pw.y, &aw.y);
        adagrad1(pv.z, av.z, gv.z, lr, eps, &pw.z, &aw.z);
        adagrad1(pv.w, av.w, gv.w, lr, eps, &pw.w, &aw.w);
        po[i] = pw;
        ao[i] = aw;
    }
}

__global__ void __launch_bounds__(NTHREADS)
adagrad_scalar_kernel(const float* __restrict__ p, const float* __restrict__ a,
                      const float* __restrict__ g, float* po, float* ao,
                      long long lo, long long n, float lr, float eps) {
    for (long long i = lo + (long long)blockIdx.x * NTHREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * NTHREADS)
        adagrad1(p[i], a[i], g[i], lr, eps, po + i, ao + i);
}

static unsigned grid_for(long long work, int max_blocks) {
    const long long b = (work + NTHREADS - 1) / NTHREADS;
    return (unsigned)(b < max_blocks ? (b > 0 ? b : 1) : max_blocks);
}

// params, accum, grads -> params_out, accum_out: n fp32 each. vec4 != 0 says
// all five pointers are 16-byte aligned. Returns cudaGetLastError().
extern "C" int fused_adagrad_launch(const void* params, const void* accum, const void* grads,
                                    void* params_out, void* accum_out, long long n, float lr,
                                    float eps, int vec4, int max_blocks, void* stream) {
    if (n == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* p = static_cast<const float*>(params);
    const float* a = static_cast<const float*>(accum);
    const float* g = static_cast<const float*>(grads);
    float* po = static_cast<float*>(params_out);
    float* ao = static_cast<float*>(accum_out);
    long long lo = 0;
    if (vec4) {
        const long long n4 = n / 4;
        if (n4 > 0) {
            adagrad_vec4_kernel<<<grid_for(n4, max_blocks), NTHREADS, 0, st>>>(
                reinterpret_cast<const float4*>(p), reinterpret_cast<const float4*>(a),
                reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(po),
                reinterpret_cast<float4*>(ao), n4, lr, eps);
            const int err = (int)cudaGetLastError();
            if (err) return err;
        }
        lo = n4 * 4;
    }
    if (lo < n)
        adagrad_scalar_kernel<<<grid_for(n - lo, max_blocks), NTHREADS, 0, st>>>(
            p, a, g, po, ao, lo, n, lr, eps);
    return (int)cudaGetLastError();
}

extern "C" const char* fused_adagrad_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
