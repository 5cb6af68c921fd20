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
// lets the lanes that own a node write both of its gradients.
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
// (3,273,930 directed edges, Fe = 6, M = 32): the real edges' source nodes
// and features and xr, xc and out (12.8 MB each) are 143 MB or more, 43 us at
// 3.35 TB/s; the work is 2*Fe + 4 operations per edge and feature forward
// and about twice that backward, which also reads g and writes dxr and dxc.
// The edge term is rounded product by product without fused multiply-adds
// (below), so every operation issues as one instruction: ~80 a lane and
// edge forward, ~145 backward, 0.07 and 0.13 ms of the card's issue rate
// (4 warp instructions an SM and clock). The node arrays sit in the 50 MB
// L2; the stream comes from memory once. Measured, the kernels are bound
// by instruction issue and the latency of the gathered rows, not by bytes:
// a warm L2 changes nothing (PERF.md).
//
// Design (none of the TPU kernel's one-hot MXU gathers and scatters, bf16
// hi/lo split, out_visited post-mask or VMEM-resident output tile carries
// over). The first port walked each node's edge slots through an index
// (edge_order -> slot -> col_local, sub_col and Fe rows of eattr_t): a
// chain of three dependent loads an edge, ~150 B of sectors an edge from
// scattered slots, one warp a node, one lane a feature. Now:
// - the structure carries a destination-ordered stream (edge_src, edge_feat:
//   4 + 4*Fe_pad = 36 B an edge, contiguous), so a node's edges are one
//   run, read without indirection; sentinels and pad slabs are not in it;
// - lanes sit on feature quads: a group of G = 2^gs lanes owns one node
//   (G the least power of two with 4G >= M, at least 8 and at most 32;
//   M = 32: 8 lanes a node, 4 nodes a warp), each lane four features (one
//   16-byte f32 or 8-byte bf16 load of a node row where M is a multiple of
//   4 and the rows are aligned, else four masked loads); M > 128 runs in
//   slices of 128 features;
// - a group walks its node's edges in ascending slot order, a batch of U
//   edges at a time, three batches deep: while batch b is summed, the
//   source rows of batch b + 1 and the source nodes and features of batch
//   b + 2 are in flight. Lane k of a group loads feature channel k of an
//   edge (one register an edge, not Fe) and the group shares the channels
//   by shuffles at the edge's turn; so the walk is warp-uniform (the
//   longest of the warp's nodes), a lane's edges past its node's last
//   masked. The forward keeps three blocks an SM (80 registers), the
//   backward two;
// - ew is rounded product by product in channel order, without fused
//   multiply-adds, as the plain version computes it, so both see
//   bit-identical pre-activations and the same relu'; out, dxr and dxc are
//   sums in ascending slot order, an f32 loop in that order bit for bit;
// - each output row is written once, no atomics. dw_e: every lane keeps
//   Fe x 4 running sums; a warp adds its groups' sums in group order, a
//   block its warps' in warp order into one partial, and a second kernel
//   adds the block partials in a fixed tree: deterministic. The backward's
//   grid is one wave of resident blocks striding over the nodes, so the
//   partials are few.
// Fe is a template parameter (0-8), so no channel past Fe costs an issue
// slot. Not done: interleaving xr | xc | g node-major for the backward
// (an edge's three rows take three loads and the same sectors either way).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "bf16.cuh"

namespace {

using bf16::round_bf16;
using bf16::widen;

constexpr int MAX_FE = 8;  // edge channels held in registers
constexpr int WARPS = 8;   // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int W = 4;            // features a lane (a quad: one 16-byte f32 load)
constexpr int MAX_SLICE = 32 * W;  // features a group covers at once
constexpr int FWD_UNROLL = 2;   // edges a batch of the forward's pipeline
constexpr int BWD_UNROLL = 1;   // of the backward's
constexpr int FWD_MIN_BLOCKS = 3;  // resident blocks an SM the register budget allows
constexpr int BWD_MIN_BLOCKS = 2;
constexpr unsigned FULL = 0xffffffffu;

struct Stream {
    const int* row_ptr;  // [V + 1] start of each destination node's edges
    const int* src;      // [E] each edge's global source node, by (destination node, slot)
    const float* feat;   // [E, fe_pad] its features, zero past Fe
    int fe_pad;
};

// a[off .. off + 3] as f32, the entries from the n-th on zero (n <= 0: no
// load). VEC: one 16-byte (f32) or 8-byte (bf16) load, for which the caller
// guarantees n >= 4 whenever n > 0, and the alignment.
template <bool VEC>
__device__ __forceinline__ void loadw(const float* __restrict__ a, size_t off, int n, float (&r)[W]) {
    if (VEC && n > 0) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(a + off));
        r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
    } else {
#pragma unroll
        for (int j = 0; j < W; ++j) r[j] = j < n ? __ldg(a + off + j) : 0.f;
    }
}

template <bool VEC>
__device__ __forceinline__ void loadw(const uint16_t* __restrict__ a, size_t off, int n, float (&r)[W]) {
    if (VEC && n > 0) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(a + off));
        r[0] = __uint_as_float(t.x << 16), r[1] = __uint_as_float(t.x & 0xffff0000u);
        r[2] = __uint_as_float(t.y << 16), r[3] = __uint_as_float(t.y & 0xffff0000u);
    } else {
#pragma unroll
        for (int j = 0; j < W; ++j) r[j] = j < n ? widen(__ldg(a + off + j)) : 0.f;
    }
}

// out[off .. off + 3] = r, the entries from the n-th on not written
template <bool VEC>
__device__ __forceinline__ void storew(float* __restrict__ out, size_t off, int n, const float (&r)[W]) {
    if (VEC && n > 0) {
        *reinterpret_cast<float4*>(out + off) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
        for (int j = 0; j < W; ++j)
            if (j < n) out[off + j] = r[j];
    }
}

// channel `sub` of edge i's features, loaded by the lane that holds it (zero
// past Fe and past the node's last edge): a group's lanes hold one channel
// each of an edge and share them with shuffles at the edge's turn
template <int FE>
__device__ __forceinline__ float channel(const Stream& S, int i, int end, int sub) {
    return i < end && sub < FE ? __ldg(S.feat + (size_t)i * S.fe_pad + sub) : 0.f;
}

// the edge's FE features from the lanes of the group at `base` (each rounded
// to bf16 by its holder when ROUND); every lane of the warp calls it
template <int FE, bool ROUND>
__device__ __forceinline__ void share_features(float held, int base, float (&e)[MAX_FE]) {
    if (ROUND) held = round_bf16(held);
#pragma unroll
    for (int k = 0; k < FE; ++k) e[k] = __shfl_sync(FULL, held, base + k);
}

// w[k][j] = w_e[k, m + j], zero past M
template <int FE, typename X>
__device__ __forceinline__ void load_weights(const X* __restrict__ we, int M, int m, int n, float (&w)[MAX_FE][W]) {
#pragma unroll
    for (int k = 0; k < FE; ++k)
#pragma unroll
        for (int j = 0; j < W; ++j) w[k][j] = j < n ? widen(we[k * M + m + j]) : 0.f;
}

// ew = e_attr . w_e at feature m + j, rounded as the plain version rounds it
template <int FE>
__device__ __forceinline__ float edge_term(const float (&e)[MAX_FE], const float (&w)[MAX_FE][W], int j) {
    float ew = 0.f;
#pragma unroll
    for (int k = 0; k < FE; ++k) ew = __fadd_rn(ew, __fmul_rn(e[k], w[k][j]));
    return ew;
}

__device__ __forceinline__ float pre_act(float a, float b, float ew) { return __fadd_rn(__fadd_rn(a, b), ew); }

// the source node of edge i, or node 0 past the node's last edge (never read)
__device__ __forceinline__ int source(const Stream& S, int i, int end) { return i < end ? __ldg(S.src + i) : 0; }

// Each group walks its node's edges U a batch, three batches deep: while
// batch b is summed, the source rows of batch b + 1 and the source nodes
// and held feature channels of batch b + 2 are in flight. The walk is
// warp-uniform (the longest of the warp's nodes), so the shuffles always
// see every lane; a lane's edges past its node's last are masked.

// X: the type of xr, xc and w_e (float, or bf16 bits: the bf16 form)
template <typename X, int FE, bool VEC>
__global__ void __launch_bounds__(THREADS, FWD_MIN_BLOCKS)
    fwd_nodes(Stream S, const X* __restrict__ xr, const X* __restrict__ xc, const X* __restrict__ we,
              float* __restrict__ out, int V, int M, int gs) {
    constexpr bool ROUND = sizeof(X) == 2;
    constexpr int U = FWD_UNROLL;
    const int lane = threadIdx.x & 31, sub = lane & ((1 << gs) - 1), base = lane - sub;
    const int v = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) >> gs);
    const bool live = v < V;
    const int beg = live ? S.row_ptr[v] : 0, end = live ? S.row_ptr[v + 1] : 0;
    const int steps = __reduce_max_sync(FULL, end - beg);
    for (int m0 = 0; m0 < M; m0 += W << gs) {
        const int m = m0 + W * sub, n = live ? M - m : 0;  // this lane's features m .. m + W - 1, n of them real
        float w[MAX_FE][W], xv[W], acc[W] = {};
        load_weights<FE>(we, M, m, n, w);
        loadw<VEC>(xr, (size_t)v * M + m, n, xv);
        int src1[U], src2[U];
        float f0[U], f1[U], f2[U], rows[U][W], next[U][W];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            src1[u] = source(S, beg + u, end);
            f0[u] = channel<FE>(S, beg + u, end, sub);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            loadw<VEC>(xc, (size_t)src1[u] * M + m, beg + u < end ? n : 0, rows[u]);
            src1[u] = source(S, beg + U + u, end);
            f1[u] = channel<FE>(S, beg + U + u, end, sub);
        }
        for (int t = 0; t < steps; t += U) {
            const int i = beg + t;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                loadw<VEC>(xc, (size_t)src1[u] * M + m, i + U + u < end ? n : 0, next[u]);
                src2[u] = source(S, i + 2 * U + u, end);
                f2[u] = channel<FE>(S, i + 2 * U + u, end, sub);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                float e[MAX_FE];
                share_features<FE, ROUND>(f0[u], base, e);
                if (i + u < end) {
#pragma unroll
                    for (int j = 0; j < W; ++j) {
                        const float msg = fmaxf(pre_act(xv[j], rows[u][j], edge_term<FE>(e, w, j)), 0.f);
                        acc[j] += ROUND ? round_bf16(msg) : msg;
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
#pragma unroll
                for (int j = 0; j < W; ++j) rows[u][j] = next[u][j];
                f0[u] = f1[u];
                f1[u] = f2[u];
                src1[u] = src2[u];
            }
        }
        storew<VEC>(out, (size_t)v * M + m, n, acc);
    }
}

// X: the type of xr, xc, w_e and g (float, or bf16 bits: the bf16 form)
template <typename X, int FE, bool VEC>
__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
    bwd_nodes(Stream S, const X* __restrict__ xr, const X* __restrict__ xc, const X* __restrict__ we,
              const X* __restrict__ g, float* __restrict__ dxr, float* __restrict__ dxc, float* __restrict__ partial,
              int V, int M, int gs) {
    constexpr bool ROUND = sizeof(X) == 2;
    constexpr int U = BWD_UNROLL;
    __shared__ float red[WARPS][FE > 0 ? FE : 1][MAX_SLICE];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int group = 1 << gs, sub = lane & (group - 1), base = lane - sub;
    // the warp's first node, and the nodes all blocks cover in one round
    const int first = (int)(((long long)blockIdx.x * THREADS + (threadIdx.x & ~31)) >> gs);
    const int stride = (int)(((long long)gridDim.x * THREADS) >> gs);
    for (int m0 = 0; m0 < M; m0 += W * group) {
        const int m = m0 + W * sub;
        float w[MAX_FE][W], dw[MAX_FE][W];
        load_weights<FE>(we, M, m, M - m, w);
#pragma unroll
        for (int k = 0; k < FE; ++k)
#pragma unroll
            for (int j = 0; j < W; ++j) dw[k][j] = 0.f;
        for (int v0 = first; v0 < V; v0 += stride) {
            const int v = v0 + (lane >> gs);
            const bool live = v < V;
            const int n = live ? M - m : 0;
            const size_t vm = (size_t)v * M + m;
            float xrv[W], xcv[W], gv[W], ar[W] = {}, ac[W] = {};
            loadw<VEC>(xr, vm, n, xrv);
            loadw<VEC>(xc, vm, n, xcv);
            loadw<VEC>(g, vm, n, gv);
            const int beg = live ? S.row_ptr[v] : 0, end = live ? S.row_ptr[v + 1] : 0;
            const int steps = __reduce_max_sync(FULL, end - beg);
            // per edge of a batch its source rows of xc, xr and g
            int src1[U], src2[U];
            float f0[U], f1[U], f2[U], rows[U][3][W], next[U][3][W];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                src1[u] = source(S, beg + u, end);
                f0[u] = channel<FE>(S, beg + u, end, sub);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const size_t cm = (size_t)src1[u] * M + m;
                const int nu = beg + u < end ? n : 0;
                loadw<VEC>(xc, cm, nu, rows[u][0]);
                loadw<VEC>(xr, cm, nu, rows[u][1]);
                loadw<VEC>(g, cm, nu, rows[u][2]);
                src1[u] = source(S, beg + U + u, end);
                f1[u] = channel<FE>(S, beg + U + u, end, sub);
            }
            for (int t = 0; t < steps; t += U) {
                const int i = beg + t;
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const size_t cm = (size_t)src1[u] * M + m;
                    const int nu = i + U + u < end ? n : 0;
                    loadw<VEC>(xc, cm, nu, next[u][0]);
                    loadw<VEC>(xr, cm, nu, next[u][1]);
                    loadw<VEC>(g, cm, nu, next[u][2]);
                    src2[u] = source(S, i + 2 * U + u, end);
                    f2[u] = channel<FE>(S, i + 2 * U + u, end, sub);
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    float e[MAX_FE];
                    share_features<FE, ROUND>(f0[u], base, e);
                    if (i + u < end) {
#pragma unroll
                        for (int j = 0; j < W; ++j) {
                            const float ew = edge_term<FE>(e, w, j);
                            const float d = pre_act(xrv[j], rows[u][0][j], ew) > 0.f ? gv[j] : 0.f;
                            ar[j] += d;
#pragma unroll
                            for (int k = 0; k < FE; ++k) dw[k][j] = fmaf(e[k], d, dw[k][j]);
                            if (pre_act(rows[u][1][j], xcv[j], ew) > 0.f) ac[j] += rows[u][2][j];
                        }
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
#pragma unroll
                    for (int r = 0; r < 3; ++r)
#pragma unroll
                        for (int j = 0; j < W; ++j) rows[u][r][j] = next[u][r][j];
                    f0[u] = f1[u];
                    f1[u] = f2[u];
                    src1[u] = src2[u];
                }
            }
            storew<VEC>(dxr, vm, n, ar);
            storew<VEC>(dxc, vm, n, ac);
        }
        if (FE > 0) {
            // the block's partial of dw_e for this slice: a warp's groups in
            // group order, then the warps in warp order
#pragma unroll
            for (int k = 0; k < FE; ++k)
#pragma unroll
                for (int j = 0; j < W; ++j) {
                    float s = 0.f;
                    for (int q = 0; q < 32; q += group) s += __shfl_sync(FULL, dw[k][j], q + sub);
                    if (lane < group) red[warp][k][W * sub + j] = s;
                }
            __syncthreads();
            const int width = W * group;
            for (int t = threadIdx.x; t < FE * width; t += THREADS) {
                const int k = t / width, f = t % width;
                if (m0 + f < M) {
                    float s = 0.f;
                    for (int q = 0; q < WARPS; ++q) s += red[q][k][f];
                    partial[((size_t)blockIdx.x * FE + k) * M + m0 + f] = s;
                }
            }
            __syncthreads();
        }
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

// the activation types, by their code in ops/diag_spmm.py (ACT_DTYPES)
enum ActType { ACT_F32 = 0, ACT_BF16 = 1 };

// log2 of the lanes a node: the least power of two with W features a lane
// covering M, at least 8 (a lane for each feature channel) and at most 32
int lane_shift(int M) {
    int gs = 3;
    while ((W << gs) < M && gs < 5) ++gs;
    return gs;
}

// whether every node row can be read W entries at a time
template <typename X>
bool vector_rows(int M, std::initializer_list<const void*> rows) {
    if (M % W) return false;
    for (const void* p : rows)
        if ((uintptr_t)p % (W * sizeof(X))) return false;
    return true;
}

struct FwdArgs {
    Stream S;
    const void *xr, *xc, *we;
    void* out;
    int V, M;
    cudaStream_t stream;
};

struct BwdArgs {
    Stream S;
    const void *xr, *xc, *we, *g;
    void *dxr, *dxc, *partial, *dw;
    int max_blocks, V, M;
    cudaStream_t stream;
};

// the instantiation for Fe = fe (FE counts up from 0)
template <typename X, bool VEC, int FE = 0>
int launch_fwd(const FwdArgs& a, int fe) {
    if constexpr (FE < MAX_FE) {
        if (fe != FE) return launch_fwd<X, VEC, FE + 1>(a, fe);
    }
    const int gs = lane_shift(a.M);
    const long long threads = (long long)a.V << gs;
    fwd_nodes<X, FE, VEC><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
        a.S, (const X*)a.xr, (const X*)a.xc, (const X*)a.we, (float*)a.out, a.V, a.M, gs);
    return (int)cudaGetLastError();
}

template <typename X, bool VEC, int FE = 0>
int launch_bwd(const BwdArgs& a, int fe) {
    if constexpr (FE < MAX_FE) {
        if (fe != FE) return launch_bwd<X, VEC, FE + 1>(a, fe);
    }
    const int gs = lane_shift(a.M);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_nodes<X, FE, VEC>, THREADS, 0);
    if (e != cudaSuccess) {
        (void)cudaGetLastError();
        return (int)e;
    }
    const long long threads = (long long)a.V << gs;
    const int nblocks =
        (int)std::min({(long long)a.max_blocks, (long long)sms * std::max(per_sm, 1), (threads + THREADS - 1) / THREADS});
    bwd_nodes<X, FE, VEC><<<nblocks, THREADS, 0, a.stream>>>(a.S, (const X*)a.xr, (const X*)a.xc, (const X*)a.we,
                                                             (const X*)a.g, (float*)a.dxr, (float*)a.dxc,
                                                             (float*)a.partial, a.V, a.M, gs);
    e = cudaGetLastError();
    if (e != cudaSuccess || FE == 0) return (int)e;
    reduce_partials<<<FE * a.M, THREADS, 0, a.stream>>>((const float*)a.partial, nblocks, FE * a.M, (float*)a.dw);
    return (int)cudaGetLastError();
}

bool bad_stream(const Stream& S, int fe) {
    return S.fe_pad < fe || S.fe_pad % 4 || (uintptr_t)S.feat % 16;
}

}  // namespace

extern "C" {

// the stream: row_ptr [V + 1], edge_src [E] (int32), edge_feat [E, fe_pad]
// (f32, 16-byte aligned, fe_pad a multiple of 4 and at least fe); xr, xc
// [V, M] and w_e [fe, M] of type `xtype` (0 f32, 1 bf16: the bf16 form),
// out [V, M] f32, contiguous
int blocked_fwd_kernel(const void* row_ptr, const void* src, const void* feat, int fe_pad, int fe, int xtype,
                       const void* xr, const void* xc, const void* we, void* out, int V, int M, void* stream) {
    const Stream S{(const int*)row_ptr, (const int*)src, (const float*)feat, fe_pad};
    if (V <= 0 || M <= 0 || fe < 0 || fe > MAX_FE || bad_stream(S, fe)) return (int)cudaErrorInvalidValue;
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    const FwdArgs a{S, xr, xc, we, out, V, M, (cudaStream_t)stream};
    switch (xtype) {
        case ACT_F32:
            return vector_rows<float>(M, {xr, xc}) ? launch_fwd<float, true>(a, fe) : launch_fwd<float, false>(a, fe);
        case ACT_BF16:
            return vector_rows<uint16_t>(M, {xr, xc}) ? launch_fwd<uint16_t, true>(a, fe)
                                                       : launch_fwd<uint16_t, false>(a, fe);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// as blocked_fwd_kernel, plus g [V, M] of type `xtype`, and dxr, dxc [V, M]
// f32; partial has room for max_blocks x [fe, M] block partials; dw [fe, M]
int blocked_bwd_kernel(const void* row_ptr, const void* src, const void* feat, int fe_pad, int fe, int xtype,
                       const void* xr, const void* xc, const void* we, const void* g, void* dxr, void* dxc,
                       void* partial, int max_blocks, void* dw, int V, int M, void* stream) {
    const Stream S{(const int*)row_ptr, (const int*)src, (const float*)feat, fe_pad};
    if (V <= 0 || M <= 0 || fe < 0 || fe > MAX_FE || max_blocks <= 0 || bad_stream(S, fe))
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const BwdArgs a{S, xr, xc, we, g, dxr, dxc, partial, dw, max_blocks, V, M, (cudaStream_t)stream};
    switch (xtype) {
        case ACT_F32:
            return vector_rows<float>(M, {xr, xc, g}) ? launch_bwd<float, true>(a, fe)
                                                      : launch_bwd<float, false>(a, fe);
        case ACT_BF16:
            return vector_rows<uint16_t>(M, {xr, xc, g}) ? launch_bwd<uint16_t, true>(a, fe)
                                                         : launch_bwd<uint16_t, false>(a, fe);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
