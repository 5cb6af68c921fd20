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
// MXU matmul at HIGHEST precision, double-buffered 2048-edge DMA blocks or
// VMEM guard carries over). Rows are sorted, so the messages of one output
// row are one contiguous run of msg's rows. Two launches:
//   1. row_offsets: row_ptr[v] = the first e with rows[e] >= v, v = 0 .. V
//      (the JAX wrapper's searchsorted of the block boundaries, at row
//      granularity), in one coalesced pass over rows: element e writes the
//      entries between its predecessor's row and its own (a gap longer than
//      a warp, the whole warp: the empty segments before the padding of the
//      pooled COO rows are one such gap), and the entries past the last row
//      take one thread each. Rows are clamped to [-1, V], so the padding
//      sends everything past the last real row to row_ptr[V].
//   2. sum_rows: lanes sit on feature quads (16-byte loads, when F % 4 == 0
//      and msg and out are 16-byte aligned; single features otherwise): a row
//      takes the next power of two >= its quads (features) as lanes, at most
//      32, so a warp sums 8 rows at F = 16 and 4 at F = 32. Each lane walks
//      its row's run with 8 loads in flight and adds them in ascending edge
//      order in f32. Each output row is written once: no atomics,
//      deterministic, a row without messages gets exact zeros, and the
//      padding is never read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // loads in flight a lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_row(int r, int V) { return min(max(r, -1), V); }

// row_ptr[v] = e for every v in (r(e - 1), r(e)], e = 0 .. E - 1, with
// r(-1) = -1 and r(e) = rows[e] clamped to [-1, V]; and row_ptr[v] = E for
// every v past the last row, r(E - 1) < v <= V (one thread a v). Threads
// t = 0 .. max(E, V) take element t and entry t.
__global__ void __launch_bounds__(THREADS) row_offsets(const int* __restrict__ rows, long long E, int V,
                                                       long long* __restrict__ row_ptr) {
    const int lane = threadIdx.x & 31;
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    int lo = 0, hi = 0;  // element t fills (lo, hi]
    if (t < E) {
        lo = t == 0 ? -1 : clamp_row(__ldg(rows + t - 1), V);
        hi = clamp_row(__ldg(rows + t), V);
    }
    const bool wide = hi - lo > 32;
    if (!wide) {
        for (int v = lo + 1; v <= hi; ++v) row_ptr[v] = t;
    }
    // the warp fills each wide gap together (every lane reaches the ballot)
    unsigned todo = __ballot_sync(FULL, wide);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int l = __shfl_sync(FULL, lo, src);
        const int h = __shfl_sync(FULL, hi, src);
        const long long value = __shfl_sync(FULL, t, src);
        for (int v = l + 1 + lane; v <= h; v += 32) row_ptr[v] = value;
    }
    if (t <= V && t > (E > 0 ? clamp_row(__ldg(rows + E - 1), V) : -1)) row_ptr[t] = E;
}

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}

// T: float4 (a lane on a feature quad) or float (on a feature); W = F
// counted in T
template <typename T>
__global__ void __launch_bounds__(THREADS) sum_rows(const T* __restrict__ msg, const long long* __restrict__ row_ptr,
                                                    long long E, int V, int W, int lanes_log2, T* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int lanes = 1 << lanes_log2;  // lanes a row
    const long long row = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * (32 >> lanes_log2) + (lane >> lanes_log2);
    if (row >= V) return;  // lanes are independent past this point: no shuffles
    const int v = (int)row;
    // clamped, so that rows that break the ascending promise cannot read out of bounds
    const long long beg = min(max(__ldg(row_ptr + v), 0ll), E);
    const long long end = max(min(__ldg(row_ptr + v + 1), E), beg);
    for (int q = lane & (lanes - 1); q < W; q += lanes) {
        const T* p = msg + q;
        T acc{};  // +0 in every lane
        long long e = beg;
        for (; e + UNROLL <= end; e += UNROLL) {
            T t[UNROLL];
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) t[k] = __ldg(p + (size_t)(e + k) * W);
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) add(acc, t[k]);
        }
        if (e < end) {  // the last 1 .. UNROLL - 1 messages, their loads still in flight together
            T t[UNROLL - 1];
#pragma unroll
            for (int k = 0; k < UNROLL - 1; ++k) {
                if (e + k < end) t[k] = __ldg(p + (size_t)(e + k) * W);
            }
#pragma unroll
            for (int k = 0; k < UNROLL - 1; ++k) {
                if (e + k < end) add(acc, t[k]);
            }
        }
        out[(size_t)v * W + q] = acc;
    }
}

template <typename T>
cudaError_t sum(const void* msg, const long long* row_ptr, long long E, int V, int W, void* out, cudaStream_t stream) {
    int lanes_log2 = 0;
    while ((1 << lanes_log2) < W && lanes_log2 < 5) ++lanes_log2;
    const long long rows_per_block = (long long)WARPS * (32 >> lanes_log2);
    const unsigned blocks = (unsigned)((V + rows_per_block - 1) / rows_per_block);
    sum_rows<T><<<blocks, THREADS, 0, stream>>>((const T*)msg, row_ptr, E, V, W, lanes_log2, (T*)out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// msg [E, F] and out [V, F] f32, rows [E] int32, all contiguous; row_ptr:
// scratch [V + 1] int64 (the row offsets, written by the first launch)
int segment_sum_sorted_kernel(const void* msg, const void* rows, long long E, int V, int F, void* row_ptr, void* out,
                              void* stream) {
    if (V <= 0 || F <= 0 || E < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    // the error returned after the launches must be theirs: drop any earlier
    // non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    const long long threads = (E > V ? E : (long long)V) + 1;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    row_offsets<<<blocks, THREADS, 0, s>>>((const int*)rows, E, V, (long long*)row_ptr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const bool vec = F % 4 == 0 && (((uintptr_t)msg | (uintptr_t)out) & 15) == 0;
    e = vec ? sum<float4>(msg, (const long long*)row_ptr, E, V, F / 4, out, s)
            : sum<float>(msg, (const long long*)row_ptr, E, V, F, out, s);
    return (int)e;
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
