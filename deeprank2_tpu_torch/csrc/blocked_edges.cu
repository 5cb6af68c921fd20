// Blocked per-edge-feature message passing for Hopper (sm_90a), bound with
// ctypes from deeprank2_tpu_torch/ops/vanilla.py.
//
// It replaces the TPU kernels of deeprank2_tpu/ops/pallas_vanilla.py:
//   blocked_fwd_kernel  <- _fwd_kernel  (launched by _fwd_call)
//   blocked_bwd_kernel  <- _bwd_kernel  (launched by _bwd_call)
//
// For every destination node v, with e over the real edges into v and
// ew(e) = e_attr(e) . w_e:
//   K6f  out[v] = sum_e relu(xr[v] + xc[col e] + ew(e))
//   K6b  dxr[v] = sum_e g[v] * [xr[v] + xc[col e] + ew(e) > 0]
//        dxc[v] = sum_e g[col e] * [xr[col e] + xc[v] + ew(e) > 0]   (e's mirror message)
//        dw_e   = sum over every edge e of e_attr(e) (x) g[row e] * [pre(e) > 0]
// The mirror form of dxc is the column scatter of the messages' gradients,
// because the edge set is closed under mirroring with equal features; it
// lets the warp that owns a node write both of its gradients.
//
// Two forms, by the type of xr, xc, w_e and g: f32, and the single-pass bf16
// form of the JAX kernels (_make_gdot's bf16 branch, compute_dtype=bfloat16).
// The wrapper hands the bf16 form bf16 copies of those four; the kernel
// widens each value exactly, rounds the edge features to bf16 as it reads
// them (each product of ew is then exact), rounds every forward message
// relu(pre) to bf16 before its f32 sum (JAX's scatter dot), and sums
// everything else in f32. In the backward every dmsg is a bf16 value
// (bf16(g) or 0), so JAX's roundings of it change nothing.
//
// What bounds it on an H100 SXM, per call at the 100k-node atomic graph
// (3,273,930 directed edges, Fe = 6, M = 32): the real edges' index and
// features (8 + 4*Fe bytes each, 105 MB) and xr, xc and out (12.8 MB each)
// are 143 MB, 43 us at 3.35 TB/s, against 2*Fe + 4 operations per edge and
// feature (1.7 GFLOP, 25 us at 67 TFLOP/s). The backward also reads g and
// writes dxr and dxc (169 MB, 50 us) for about twice the operations (3.4
// GFLOP, 50 us). Both are bound by bytes, the backward barely. The bf16
// form reads half the bytes of xr, xc and g.
//
// Design (none of the TPU kernel's one-hot MXU gathers and scatters, bf16
// hi/lo split, out_visited post-mask or VMEM-resident output tile carries
// over): beside its slabs the structure lists the slots of each node's real
// edges in slot order (row_ptr / edge_order, built at collate), so sentinel
// slots and capacity-pad slabs are never read, and neither is xr at a
// sentinel's row. One warp owns one destination node at a time, its lanes
// on 32 features (M > 32 runs in slices of 32; lanes past M idle). The warp
// loads the node's edges 32 at a time, one per lane (slot, source node from
// sub_col and col_local, the Fe features), broadcasts each edge to every
// lane with shuffles and accumulates in registers; each output row is
// written once: no atomics, and each sum runs in slot order. ew is rounded
// product by product in channel order, without fused multiply-adds, as the
// plain version computes it, so both see bit-identical pre-activations and
// the same relu'. dw_e: every lane keeps Fe running sums, a block adds its
// warps' sums in warp order into one partial, and a second kernel adds the
// block partials in a fixed tree: deterministic. The backward's grid is one
// wave of resident blocks striding over the nodes, so the partials are few.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bf16.cuh"

namespace {

using bf16::round_bf16;
using bf16::widen;

constexpr int TILE = 256;     // EDGE_TILE: nodes per tile
constexpr int SUB_SHIFT = 8;  // SUB_E = 256 edge slots per sub-block
constexpr int MAX_FE = 8;     // edge channels held in registers
constexpr int WARPS = 8;      // warps per block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

struct Edges {
    const int* row_ptr;    // [V + 1] start of each node's edges in order
    const int* order;      // [real edges] slots by (destination node, slot)
    const int* col_local;  // [E_cap] source node within its tile
    const int* sub_col;    // [E_cap / 256] source tile of each sub-block
    const float* eattr_t;  // [Fe_pad, E_cap] edge features
    long long ecap;
    int fe;
};

// edge i's source node and features (rounded to bf16 when ROUND), one edge
// per lane; lanes past the node's last edge get node 0 and zero features,
// which no lane uses
template <bool ROUND>
__device__ __forceinline__ int load_edge(const Edges& E, int i, int end, float (&ea)[MAX_FE]) {
    int col = 0;
#pragma unroll
    for (int k = 0; k < MAX_FE; ++k) ea[k] = 0.f;
    if (i < end) {
        const int s = E.order[i];
        col = E.sub_col[s >> SUB_SHIFT] * TILE + E.col_local[s];
#pragma unroll
        for (int k = 0; k < MAX_FE; ++k)
            if (k < E.fe) {
                const float e = E.eattr_t[(size_t)k * E.ecap + s];
                ea[k] = ROUND ? round_bf16(e) : e;
            }
    }
    return col;
}

// edge j's features broadcast from its lane into ej, and ew = e_attr . w_e
// at this lane's feature, rounded as the plain version rounds it
__device__ __forceinline__ float edge_term(const float (&ea)[MAX_FE], const float (&w)[MAX_FE], int j, int fe,
                                           float (&ej)[MAX_FE]) {
    float ew = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_FE; ++k) {
        ej[k] = 0.f;
        if (k < fe) {
            ej[k] = __shfl_sync(FULL, ea[k], j);
            ew = __fadd_rn(ew, __fmul_rn(ej[k], w[k]));
        }
    }
    return ew;
}

template <typename X>
__device__ __forceinline__ void load_weights(const X* we, int fe, int M, int m, bool on, float (&w)[MAX_FE]) {
#pragma unroll
    for (int k = 0; k < MAX_FE; ++k) w[k] = (on && k < fe) ? widen(we[k * M + m]) : 0.f;
}

__device__ __forceinline__ float pre_act(float a, float b, float ew) { return __fadd_rn(__fadd_rn(a, b), ew); }

// X: the type of xr, xc and w_e (float, or bf16 bits: the bf16 form)
template <typename X>
__global__ void __launch_bounds__(THREADS) fwd_nodes(Edges E, const X* __restrict__ xr, const X* __restrict__ xc,
                                                     const X* __restrict__ we, float* __restrict__ out, int V, int M) {
    constexpr bool ROUND = sizeof(X) == 2;
    const int lane = threadIdx.x & 31;
    const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (v >= V) return;
    const int beg = E.row_ptr[v], end = E.row_ptr[v + 1];
    for (int m0 = 0; m0 < M; m0 += 32) {
        const int m = m0 + lane;
        const bool on = m < M;
        float w[MAX_FE], ea[MAX_FE], ej[MAX_FE];
        load_weights(we, E.fe, M, m, on, w);
        const float xv = on ? widen(xr[(size_t)v * M + m]) : 0.f;
        float acc = 0.f;
        for (int base = beg; base < end; base += 32) {
            const int col = load_edge<ROUND>(E, base + lane, end, ea);
            const int n = min(32, end - base);
#pragma unroll 4
            for (int j = 0; j < n; ++j) {
                const int c = __shfl_sync(FULL, col, j);
                const float ew = edge_term(ea, w, j, E.fe, ej);
                if (on) {
                    const float msg = fmaxf(pre_act(xv, widen(xc[(size_t)c * M + m]), ew), 0.f);
                    acc += ROUND ? round_bf16(msg) : msg;
                }
            }
        }
        if (on) out[(size_t)v * M + m] = acc;
    }
}

// X: the type of xr, xc, w_e and g (float, or bf16 bits: the bf16 form)
template <typename X>
__global__ void __launch_bounds__(THREADS) bwd_nodes(Edges E, const X* __restrict__ xr, const X* __restrict__ xc,
                                                     const X* __restrict__ we, const X* __restrict__ g,
                                                     float* __restrict__ dxr, float* __restrict__ dxc,
                                                     float* __restrict__ partial, int V, int M) {
    constexpr bool ROUND = sizeof(X) == 2;
    __shared__ float red[WARPS][MAX_FE][32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int stride = gridDim.x * WARPS;
    for (int m0 = 0; m0 < M; m0 += 32) {
        const int m = m0 + lane;
        const bool on = m < M;
        float w[MAX_FE], ea[MAX_FE], ej[MAX_FE], dw[MAX_FE];
        load_weights(we, E.fe, M, m, on, w);
#pragma unroll
        for (int k = 0; k < MAX_FE; ++k) dw[k] = 0.f;
        for (int v = blockIdx.x * WARPS + warp; v < V; v += stride) {
            const size_t vm = (size_t)v * M + m;
            const float xrv = on ? widen(xr[vm]) : 0.f, xcv = on ? widen(xc[vm]) : 0.f, gv = on ? widen(g[vm]) : 0.f;
            const int beg = E.row_ptr[v], end = E.row_ptr[v + 1];
            float ar = 0.f, ac = 0.f;
            for (int base = beg; base < end; base += 32) {
                const int col = load_edge<ROUND>(E, base + lane, end, ea);
                const int n = min(32, end - base);
#pragma unroll 2
                for (int j = 0; j < n; ++j) {
                    const int c = __shfl_sync(FULL, col, j);
                    const float ew = edge_term(ea, w, j, E.fe, ej);
                    if (on) {
                        const size_t cm = (size_t)c * M + m;
                        const float d = pre_act(xrv, widen(xc[cm]), ew) > 0.f ? gv : 0.f;
                        ar += d;
#pragma unroll
                        for (int k = 0; k < MAX_FE; ++k)
                            if (k < E.fe) dw[k] = fmaf(ej[k], d, dw[k]);
                        if (pre_act(widen(xr[cm]), xcv, ew) > 0.f) ac += widen(g[cm]);
                    }
                }
            }
            if (on) {
                dxr[vm] = ar;
                dxc[vm] = ac;
            }
        }
        // the block's partial of dw_e: its warps' sums in warp order
#pragma unroll
        for (int k = 0; k < MAX_FE; ++k) red[warp][k][lane] = dw[k];
        __syncthreads();
        for (int t = threadIdx.x; t < E.fe * 32; t += THREADS) {
            const int k = t >> 5, l = t & 31;
            if (m0 + l < M) {
                float s = 0.f;
                for (int q = 0; q < WARPS; ++q) s += red[q][k][l];
                partial[((size_t)blockIdx.x * E.fe + k) * M + m0 + l] = s;
            }
        }
        __syncthreads();
    }
}

// dw[o] = the sum over blocks b < nblocks of partial[b * n + o], in a fixed tree
__global__ void __launch_bounds__(THREADS) reduce_partials(const float* __restrict__ partial, int nblocks, int n,
                                                           float* __restrict__ dw) {
    __shared__ float ws[WARPS];
    const int o = blockIdx.x;
    float s = 0.f;
    for (int b = threadIdx.x; b < nblocks; b += THREADS) s += partial[(size_t)b * n + o];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_down_sync(FULL, s, off);
    if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float t = 0.f;
        for (int q = 0; q < WARPS; ++q) t += ws[q];
        dw[o] = t;
    }
}

Edges edges(const void* row_ptr, const void* order, const void* col_local, const void* sub_col, const void* eattr_t,
            long long ecap, int fe) {
    return Edges{(const int*)row_ptr, (const int*)order,   (const int*)col_local, (const int*)sub_col,
                 (const float*)eattr_t, ecap, fe};
}

// the activation types, by their code in ops/diag_spmm.py (ACT_DTYPES)
enum ActType { ACT_F32 = 0, ACT_BF16 = 1 };

template <typename X>
int launch_fwd(const Edges& E, const void* xr, const void* xc, const void* we, void* out, int V, int M,
               cudaStream_t s) {
    fwd_nodes<X><<<(V + WARPS - 1) / WARPS, THREADS, 0, s>>>(E, (const X*)xr, (const X*)xc, (const X*)we,
                                                               (float*)out, V, M);
    return (int)cudaGetLastError();
}

template <typename X>
int launch_bwd(const Edges& E, const void* xr, const void* xc, const void* we, const void* g, void* dxr, void* dxc,
               void* partial, int max_blocks, void* dw, int V, int M, cudaStream_t s) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_nodes<X>, THREADS, 0);
    if (e != cudaSuccess) {
        (void)cudaGetLastError();
        return (int)e;
    }
    const int nblocks = std::min({max_blocks, sms * std::max(per_sm, 1), (V + WARPS - 1) / WARPS});
    bwd_nodes<X><<<nblocks, THREADS, 0, s>>>(E, (const X*)xr, (const X*)xc, (const X*)we, (const X*)g, (float*)dxr,
                                             (float*)dxc, (float*)partial, V, M);
    e = cudaGetLastError();
    if (e != cudaSuccess || E.fe == 0) return (int)e;
    reduce_partials<<<E.fe * M, THREADS, 0, s>>>((const float*)partial, nblocks, E.fe * M, (float*)dw);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xr, xc and w_e [Fe, M] of type `xtype` (0 f32, 1 bf16: the bf16 form),
// out [V, M] f32, contiguous; the index arrays int32
int blocked_fwd_kernel(const void* row_ptr, const void* order, const void* col_local, const void* sub_col,
                       const void* eattr_t, long long ecap, int fe, int xtype, const void* xr, const void* xc,
                       const void* we, void* out, int V, int M, void* stream) {
    if (V <= 0 || M <= 0 || fe < 0 || fe > MAX_FE) return (int)cudaErrorInvalidValue;
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    const Edges E = edges(row_ptr, order, col_local, sub_col, eattr_t, ecap, fe);
    switch (xtype) {
        case ACT_F32:
            return launch_fwd<float>(E, xr, xc, we, out, V, M, (cudaStream_t)stream);
        case ACT_BF16:
            return launch_fwd<uint16_t>(E, xr, xc, we, out, V, M, (cudaStream_t)stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// as blocked_fwd_kernel, plus g [V, M] of type `xtype`, and dxr, dxc [V, M]
// f32; partial has room for max_blocks x [Fe, M] block partials; dw [Fe, M]
int blocked_bwd_kernel(const void* row_ptr, const void* order, const void* col_local, const void* sub_col,
                       const void* eattr_t, long long ecap, int fe, int xtype, const void* xr, const void* xc,
                       const void* we, const void* g, void* dxr, void* dxc, void* partial, int max_blocks, void* dw,
                       int V, int M, void* stream) {
    if (V <= 0 || M <= 0 || fe < 0 || fe > MAX_FE || max_blocks <= 0) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const Edges E = edges(row_ptr, order, col_local, sub_col, eattr_t, ecap, fe);
    switch (xtype) {
        case ACT_F32:
            return launch_bwd<float>(E, xr, xc, we, g, dxr, dxc, partial, max_blocks, dw, V, M, (cudaStream_t)stream);
        case ACT_BF16:
            return launch_bwd<uint16_t>(E, xr, xc, we, g, dxr, dxc, partial, max_blocks, dw, V, M,
                                        (cudaStream_t)stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
