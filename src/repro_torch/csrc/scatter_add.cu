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
// reference's scatter drops them too). No float atomics: their order varies
// from launch to launch and would break the bitwise pipelined == serial
// contract.
//
// What bounds it on this card. Bytes: it reads ids and grads once and reads
// and writes each touched row once, ~17 MB at ctr-C-scaled (256,000 nonzeros
// per mini-batch, D = 8), ~5 us at 3.35 TB/s. And the serial chain: the sum
// of one run is one dependent chain of fp32 adds, and at ctr-C-scaled the
// hottest key repeats ~13,400 times in one mini-batch; at ~4 cycles of FADD
// latency per add that chain alone takes ~30 us at the card's clock. The
// chain is the larger bound; the design keeps memory latency out of it.
//
// Design. Block x owns the positions [x * SEG, (x + 1) * SEG) and every run
// that starts among them; block y owns a slice of up to 32 columns. All of
// the block's threads stage the segment's ids and grads into shared memory
// with cp.async (16 bytes per thread for the grads where rows are 16-byte
// aligned, D % 4 == 0). A run that starts in the segment and goes on past
// its end (at most one per block) is warp 0's: one thread per column starts
// its chain at once and carries it on through chunks of SEG positions,
// double-buffered, while warps 1 and up stage the next chunk. Those warps
// first sum every other run that starts in the segment: each thread a
// stretch of consecutive positions, all of the slice's columns of a run at
// once (one independent chain per column), the run's end found by a
// galloping search in the staged ids. Warp 0's chains sum from shared
// memory, loading a group of 16 values ahead of the adds, so they wait on
// FADD latency alone (the row stride is a compile-time constant at D = 4, 8
// and 16, so every load has an immediate offset). The grid is fixed by B and D: no host sync, no
// data-dependent launch. SEG is 2048 positions for slices of up to 8 columns
// and shrinks so that a buffer's grads stay at 64 KB; the two buffers take up
// to 144 KB of shared memory, opted into with cudaFuncSetAttribute. The first
// kernel (one thread per column walking each run from device memory, 32
// loads per round trip) took 0.71 ms at the ctr-C-scaled mini-batch on an
// H100 80GB HBM3 at 700 W, bound by ~418 dependent memory round trips.

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256
#define MAX_COLS 32         // columns per block; wider rows take more blocks in y
#define SEG_MAX 2048        // positions per staged segment or chunk, at most
#define SEG_FLOATS 16384    // grads floats per staging buffer (64 KB)
#define UNROLL 16           // staged grads loaded ahead of the adds
#define MAX_PER 10          // positions per thread in a segment: SEG_MAX / (NTHREADS - 32), up

struct Args {
    float* table;
    const int* ids;
    const float* grads;
    int N, D, B, seg;
    int vec;  // D % 4 == 0, grads and table 16-byte aligned: 16-byte loads and stores
    size_t ids_bytes;  // one buffer's ids, rounded up to 16 bytes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Threads ``first`` and up: copy ids [p0, p0 + n) and grads[p0 .. p0 + n,
// c0 .. c0 + dt) into one staging buffer, as one cp.async group.
__device__ __forceinline__ void stage(int* ids_s, float* g_s, const Args& a, long long p0, int n,
                                      int c0, int dt, int first = 0) {
    const int t0 = (int)threadIdx.x - first, nt = NTHREADS - first;
    if (t0 < 0) return;
    for (int e = t0; e < n; e += nt) cp_async4(ids_s + e, a.ids + p0 + e);
    if (a.vec) {
        const int per = dt / 4;
        for (int e = t0; e < n * per; e += nt) {
            const int r = e / per, q = e - r * per;
            cp_async16(g_s + r * dt + 4 * q, a.grads + (p0 + r) * a.D + c0 + 4 * q);
        }
    } else {
        for (int e = t0; e < n * dt; e += nt) {
            const int r = e / dt, c = e - r * dt;
            cp_async4(g_s + r * dt + c, a.grads + (p0 + r) * a.D + c0 + c);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The first index in [lo, hi) whose staged id is not ``id``, given that
// ids_s[lo - 1] == id (ids sorted): galloping probes lo, lo + 1, lo + 3, ...,
// then a binary search in the last gap, so a run of length L costs O(log L)
// loads and the common run of one costs one.
__device__ __forceinline__ int run_end(const int* ids_s, int id, int lo, int hi) {
    int probe = lo, step = 1;
    while (probe < hi && ids_s[probe] == id) {
        lo = probe + 1;
        probe += step;
        step <<= 1;
    }
    hi = min(probe, hi);
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ids_s[mid] == id) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// acc + g[j0][c] + g[j0 + 1][c] + ... + g[j1 - 1][c], in that order, rows of
// ``dt`` floats (DTC when it is a compile-time constant, so every load's
// offset is an immediate). The next group of UNROLL staged values is loaded
// before the current group's adds, so the dependent adds do not wait on
// shared-memory loads.
template <int DTC>
__device__ __forceinline__ float chain(float acc, const float* g, int dt_rt, int c, int j,
                                       int j1) {
    const int dt = DTC > 0 ? DTC : dt_rt;
    const float* p = g + j * dt + c;
    if (j1 - j >= 2 * UNROLL) {
        float x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) x[u] = p[u * dt];
        p += UNROLL * dt;
        j += UNROLL;
        for (; j + UNROLL <= j1; j += UNROLL, p += UNROLL * dt) {
            float y[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) y[u] = p[u * dt];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                acc = __fadd_rn(acc, x[u]);
                x[u] = y[u];
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, x[u]);
    }
    for (; j < j1; ++j, p += dt) acc = __fadd_rn(acc, *p);
    return acc;
}

// row[c] + g[j0][c] + ... + g[j1 - 1][c] for every column c < dt, written
// back to ``row``: one thread, the columns' chains interleaved (each still in
// position order).
template <int DTC>
__device__ __forceinline__ void sum_rows(float* row, const float* g, int dt_rt, int j, int j1) {
    constexpr int COLS = DTC > 0 ? DTC : MAX_COLS;
    const int dt = DTC > 0 ? DTC : dt_rt;
    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = c < dt ? row[c] : 0.0f;
#pragma unroll 4
    for (; j < j1; ++j) {
        const float* gj = g + j * dt;
#pragma unroll
        for (int c = 0; c < COLS; ++c)
            if (c < dt) acc[c] = __fadd_rn(acc[c], gj[c]);
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
        if (c < dt) row[c] = acc[c];
}

// DTC: the block's column count when fixed at compile time (D = 4, 8 or
// 16), else 0 and read from D at run time.
template <int DTC>
__global__ void __launch_bounds__(NTHREADS) scatter_add_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int seg = a.seg;
    const int c0 = blockIdx.y * MAX_COLS;
    const int dt = DTC > 0 ? DTC : min(MAX_COLS, a.D - c0);
    // two staging buffers, each [seg] ids then [seg][dt] grads
    const int buf_words = (int)(a.ids_bytes / 4) + seg * (DTC > 0 ? DTC : min(a.D, MAX_COLS));
    int* const ids0 = reinterpret_cast<int*>(smem);
    float* const g0 = reinterpret_cast<float*>(smem + a.ids_bytes);

    // the segment, and the ids just around it
    const long long p_begin = (long long)blockIdx.x * seg;
    const int n = (int)min((long long)seg, a.B - p_begin);
    stage(ids0, g0, a, p_begin, n, c0, dt);
    const bool has_prev = p_begin > 0, has_next = p_begin + n < a.B;
    const int prev = has_prev ? a.ids[p_begin - 1] : 0;
    const int next = has_next ? a.ids[p_begin + n] : 0;
    cp_async_wait_all();
    __syncthreads();

    // the last run goes on past the segment, and this block owns it (it
    // starts here: not every staged id equals the one before the segment)
    const int last = ids0[n - 1];
    const bool tail = has_next && next == last && last >= 0 && last < a.N &&
                      !(has_prev && prev == last && ids0[0] == last);

    // The owned run that goes on past the segment is warp 0's: one thread
    // per column starts its chain at once, while warps 1 and up fetch the
    // next chunk and sum every other run that starts in the segment.
    int tail_start = n;
    if (tail) {
        int lo = 0, hi = n - 1;  // the run's first staged position
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (ids0[mid] < last) lo = mid + 1;
            else hi = mid;
        }
        tail_start = lo;
    }
    const int first = tail ? 32 : 0;
    float acc = 0.0f;
    if (tail) {
        stage(ids0 + buf_words, g0 + buf_words, a, p_begin + n,
              (int)min((long long)seg, a.B - p_begin - n), c0, dt, 32);
        if (threadIdx.x < dt)
            acc = chain<DTC>(a.table[(size_t)last * a.D + c0 + threadIdx.x], g0, dt, threadIdx.x,
                             tail_start, n);
    }

    // the other runs that start in the segment: each thread takes a stretch
    // of consecutive positions and sums every run that starts in it, all
    // the slice's columns at once (independent chains, one per column)
    const int nt = NTHREADS - first, t = (int)threadIdx.x - first;
    const int per = (tail_start + nt - 1) / nt;  // at most MAX_PER
    if (t >= 0) {
        const int i0 = t * per, i_hi = min(i0 + per, tail_start);
        if (DTC > 0 && a.vec) {
            // rows of the stretch's run starts loaded together, 16 bytes at a
            // time, so their latencies overlap
            constexpr int V = DTC / 4;
            float4 rows[MAX_PER][V > 0 ? V : 1];
            unsigned starts = 0;
#pragma unroll
            for (int u = 0; u < MAX_PER; ++u) {
                const int i = i0 + u;
                if (i < i_hi) {
                    const int id = ids0[i];
                    const bool start = i > 0 ? ids0[i - 1] != id : !(has_prev && prev == id);
                    if (start && id >= 0 && id < a.N) {
                        starts |= 1u << u;
                        const float4* row =
                            reinterpret_cast<const float4*>(a.table + (size_t)id * a.D + c0);
#pragma unroll
                        for (int v = 0; v < V; ++v) rows[u][v] = row[v];
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < MAX_PER; ++u) {
                if (!(starts >> u & 1u)) continue;
                const int i = i0 + u, id = ids0[i];
                const int end = run_end(ids0, id, i + 1, tail_start);
                const float4* g4 = reinterpret_cast<const float4*>(g0);
#pragma unroll 4
                for (int j = i; j < end; ++j) {
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        const float4 x = g4[j * V + v];
                        rows[u][v].x = __fadd_rn(rows[u][v].x, x.x);
                        rows[u][v].y = __fadd_rn(rows[u][v].y, x.y);
                        rows[u][v].z = __fadd_rn(rows[u][v].z, x.z);
                        rows[u][v].w = __fadd_rn(rows[u][v].w, x.w);
                    }
                }
                float4* row = reinterpret_cast<float4*>(a.table + (size_t)id * a.D + c0);
#pragma unroll
                for (int v = 0; v < V; ++v) row[v] = rows[u][v];
            }
        } else {
            for (int i = i0; i < i_hi; ++i) {
                const int id = ids0[i];
                const bool start = i > 0 ? ids0[i - 1] != id : !(has_prev && prev == id);
                if (start && id >= 0 && id < a.N)
                    sum_rows<DTC>(a.table + (size_t)id * a.D + c0, g0, dt, i,
                                  run_end(ids0, id, i + 1, tail_start));
            }
        }
    }
    if (!tail) return;  // the same for every thread of the block

    // the run, chunk by chunk past the segment, double-buffered: warp 0
    // carries the chain, warps 1 and up stage the next chunk
    long long p0 = p_begin + n;
    int buf = 1;
    for (;;) {
        const int m = (int)min((long long)seg, a.B - p0);
        cp_async_wait_all();
        __syncthreads();  // chunk ``buf`` is in; every thread is done with the other buffer
        const long long p_next = p0 + m;
        const int other = (buf ^ 1) * buf_words;
        if (p_next < a.B)  // the run may go on: fetch the next chunk meanwhile
            stage(ids0 + other, g0 + other, a, p_next, (int)min((long long)seg, a.B - p_next), c0,
                  dt, 32);
        const int* ids_b = ids0 + buf * buf_words;
        const int end = ids_b[m - 1] == last ? m : run_end(ids_b, last, 0, m);
        if (threadIdx.x < dt)
            acc = chain<DTC>(acc, g0 + buf * buf_words, dt, threadIdx.x, 0, end);
        if (end < m || p_next >= a.B) {
            if (threadIdx.x < dt) a.table[(size_t)last * a.D + c0 + threadIdx.x] = acc;
            break;
        }
        p0 = p_next;
        buf ^= 1;
    }
    cp_async_wait_all();  // a chunk fetched past the run's end
}

// table [N, D] fp32 (updated in place), ids [B] int32 sorted, grads [B, D]
// fp32. Returns cudaGetLastError() after the launch.
extern "C" int scatter_add_launch(void* table, const int* ids, const void* grads, int N, int D,
                                  int B, void* stream) {
    if (B == 0 || D == 0) return 0;
    const int cols = D < MAX_COLS ? D : MAX_COLS;
    int seg = SEG_FLOATS / cols;
    seg = (seg > SEG_MAX ? SEG_MAX : seg) & ~3;
    const size_t ids_bytes = ((size_t)seg * 4 + 15) & ~(size_t)15;
    const size_t bytes = 2 * (ids_bytes + (size_t)seg * cols * 4);
    void (*kernel)(Args) = D == 8 ? scatter_add_kernel<8>
                           : D == 4 ? scatter_add_kernel<4>
                           : D == 16 ? scatter_add_kernel<16> : scatter_add_kernel<0>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const Args a{static_cast<float*>(table), ids, static_cast<const float*>(grads), N, D, B, seg,
                 (int)(D % 4 == 0 && reinterpret_cast<uintptr_t>(grads) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(table) % 16 == 0),
                 ids_bytes};
    const dim3 grid((unsigned)((B + (long long)seg - 1) / seg),
                    (unsigned)((D + MAX_COLS - 1) / MAX_COLS));
    kernel<<<grid, NTHREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* scatter_add_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
