// Sorted segment sum for Hopper (sm_90a), bound with ctypes from
// deeprank2_tpu_torch/ops/segment_sorted.py.
//
// It replaces the TPU kernel of deeprank2_tpu/ops/pallas_segment.py:
//   segment_sum_sorted_kernel  <- _kernel  (launched by _segment_sum_sorted_impl)
//
//   out[v] = sum over e with rows[e] == v of msg[e],   0 <= v < V
// with msg f32 [E, F] row-major, rows int32 [E] ascending (padding entries,
// any value >= V, sort last) and out f32 [V, F]: the aggregation of every COO
// message-passing layer (GINet's convs, VanillaNetwork's message sums).
//
// What bounds it on an H100 SXM: each message and row id is read once and
// each output row written once, (4F + 4) E + 4 F V bytes, against E*F
// additions and no products. At the COO GINet batch (672,640 sorted rows,
// 82,304 segments, F = 32) that is 99.3 MB, 30 us at 3.35 TB/s, and 21.5
// MFLOP, 0.3 us at 67 TFLOP/s: bytes bound it.
//
// Design (none of the TPU kernel's [F, E] transpose, F padding to 8, one-hot
// MXU matmul at HIGHEST precision, double-buffered 2048-edge DMA blocks,
// scalar-prefetched block ranges or VMEM guard carries over): rows are
// sorted, so the messages of one output row are one contiguous run of msg's
// rows. One warp owns one output row v. It finds the run [lower_bound(v),
// lower_bound(v + 1)) by a 32-ary search in rows, every lane probing one
// position per step and a ballot picking the interval (log32 E steps, about
// 4.4 at E = 4.2M). Its lanes then sit on 32 features (F > 32 runs in slices
// of 32; lanes past F idle), read the run's rows with coalesced loads, four
// in flight, and sum them in f32 in edge order. Each output row is written
// once: no atomics, deterministic, and a row without edges gets exact zeros.
// Padding entries are never read, and E = 0 gives zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps (output rows) per block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// first i in [lo, hi) with rows[i] >= v, or hi; warp-uniform lo and hi
__device__ __forceinline__ long long lower_bound_warp(const int* __restrict__ rows, long long lo, long long hi, int v,
                                                      int lane) {
    while (lo < hi) {
        const long long step = (hi - lo + 31) / 32;
        const long long p = lo + lane * step;
        const bool ge = p >= hi || __ldg(rows + p) >= v;
        const unsigned b = __ballot_sync(FULL, ge);
        const int k = b ? __ffs(b) - 1 : 32;  // first probe at or past the bound
        // the bound lies after probe k - 1 and at or before probe k
        const long long new_lo = k == 0 ? lo : lo + (long long)(k - 1) * step + 1;
        const long long new_hi = k == 32 ? hi : min(lo + (long long)k * step, hi);
        lo = new_lo;
        hi = new_hi;
    }
    return lo;
}

__global__ void __launch_bounds__(THREADS) sum_rows(const float* __restrict__ msg, const int* __restrict__ rows,
                                                    long long E, int V, int F, float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (v >= V) return;  // v is warp-uniform: whole warps leave
    const long long beg = lower_bound_warp(rows, 0, E, v, lane);
    const long long end = lower_bound_warp(rows, beg, E, v + 1, lane);
    for (int f = lane; f < F; f += 32) {  // no shuffles past the search: idle lanes may leave
        const float* p = msg + f;
        float acc = 0.f;
        long long e = beg;
        for (; e + 4 <= end; e += 4) {
            const float a0 = __ldg(p + (size_t)e * F);
            const float a1 = __ldg(p + (size_t)(e + 1) * F);
            const float a2 = __ldg(p + (size_t)(e + 2) * F);
            const float a3 = __ldg(p + (size_t)(e + 3) * F);
            acc += a0;
            acc += a1;
            acc += a2;
            acc += a3;
        }
        for (; e < end; ++e) acc += __ldg(p + (size_t)e * F);
        out[(size_t)v * F + f] = acc;
    }
}

}  // namespace

extern "C" {

// msg [E, F] and out [V, F] f32, rows [E] int32, all contiguous
int segment_sum_sorted_kernel(const void* msg, const void* rows, long long E, int V, int F, void* out, void* stream) {
    if (V <= 0 || F <= 0 || E < 0) return (int)cudaErrorInvalidValue;
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    sum_rows<<<(V + WARPS - 1) / WARPS, THREADS, 0, (cudaStream_t)stream>>>((const float*)msg, (const int*)rows, E, V,
                                                                            F, (float*)out);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
