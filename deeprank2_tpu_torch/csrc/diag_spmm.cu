// Graph-diagonal aggregation kernels for Hopper (sm_90a), bound with ctypes
// from deeprank2_tpu_torch/ops/diag_spmm.py.
//
// They replace the two TPU kernels of deeprank2_tpu/ops/diag_spmm.py:
//   diag_kernel      <- _diag_kernel      (launched by _diag_spmm_tpu)
//   pool_bwd_kernel  <- _pool_bwd_kernel  (launched by _diag_pool_bwd_tpu)
//
// Both compute, for each graph g of a batch of G graphs padded to N nodes,
//   out[f, g*N + i] = sum_j adj[g, i, j] * u[f, g*N + j]
// on flat transposed f32 activations [F, G*N] and an adjacency [G, N, N] of
// one of three types: int8 0/1 (the unweighted graphs), bf16 or f32 (sGAT's
// edge weights). Each entry enters the products at its exact f32 value, so
// every type is exact up to summation order. Each kernel has two forms, by
// the type of the activations it reads (x, or g_pool for pool_bwd_kernel):
// f32, and the single-pass bf16 form of the JAX kernels (their split=False
// branch, compute_dtype=bfloat16), whose operand the wrapper rounds to bf16
// once; the kernel widens each value exactly, so the bf16 form is the f32
// form on rounded activations, with f32 sums. The bf16 form takes int8 and
// bf16 adjacencies (exact in bf16), as the JAX kernel does. They differ in u
// and in the epilogue:
//   diag_kernel mode 0 (plain)           u = x   out = acc
//   diag_kernel mode 1 (relu_mask)       u = x   out = relu(acc) * mask
//   diag_kernel mode 2 (relu_mask_pool)  u = x   h = relu(acc) * mask;
//                                                sign = (h > 0) as uint8,
//                                                pooled[f, g] = sum_i h
//   pool_bwd_kernel                      u = sign ? g_pool[f, g] : 0,  out = acc
// (in the bf16 form x and g_pool are bf16, so u is bf16(x) or bf16(g_pool)).
// The pooled layer's h is read back only for its sign (the backward), so
// mode 2 stores one byte per value instead of four.
//
// What bounds it on an H100 SXM, per call at the bench shape (G=512, N=160,
// F=32 or 64): the adjacency is read once (13.1 MB int8), one [F, G*N] f32
// slab is read and one written (10.5 or 21 MB each), 34-55 MB in all, about
// 10-16 us at 3.35 TB/s. The dense per-graph product is 2*F*N^2*G = 0.84 or
// 1.68 GFLOP, 12.5 or 25 us at the 67 TFLOP/s f32 CUDA-core peak. So the
// kernel is bound by operations, not bytes: it does the dense product in
// f32 on CUDA cores, exact up to summation order. The bf16 form halves the
// x read (5.2 or 10.5 MB) and does the same operations.
//
// Design: one block per (graph, chunk of 32 features), 128 threads. The block
// stages its graph's [N, 32] slab of u in shared memory once, node-major, so
// that a thread's 8 features are two float4 loads and every warp reads one
// address (a broadcast). It then walks the graph's output nodes in tiles of
// 32; for each tile it streams the adjacency through shared memory in 32x32
// tiles, transposed so that a warp reads 32 consecutive entries (bf16 and f32
// tile rows are padded by one 32-bit word, so that the transposing stores
// do not pile onto one bank). Lane =
// output node, warp = 8 output features: each adjacency value, widened in a
// register, feeds 8 FMAs. Sums run in a fixed order in f32, and the per-graph
// pool stays inside the block (warp shuffles), so there are no atomics and
// every result is deterministic. Tensor cores (wgmma on a bf16 hi/lo split)
// and TMA pipelines are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FC = 32;          // features per block
constexpr int TI = 32;          // output nodes per row tile (one per lane)
constexpr int TJ = 32;          // adjacency columns per staged tile
constexpr int FPW = 8;          // features per warp
constexpr int THREADS = (FC / FPW) * 32;
constexpr int XS = FC + 4;      // slab row stride in floats: float4-aligned, spreads the staging stores over banks

enum Mode { PLAIN = 0, RELU_MASK = 1, RELU_MASK_POOL = 2, POOL_BWD = 3 };
// a bf16 adjacency is handled as its bit patterns (uint16_t): a bf16 is the
// top half of the f32 of the same value
enum AdjType { INT8 = 0, BF16 = 1, F32 = 2 };

// row stride of the adjacency tile in entries: int8 rows unpadded (32
// bytes), bf16 and f32 rows one 32-bit word longer, so that the transposing
// stores of consecutive threads land in different banks
template <typename T>
__host__ __device__ constexpr int tile_row() {
    return sizeof(T) == 1 ? TI : TI + 4 / (int)sizeof(T);
}

// the adjacency tile `at`, the block's only static shared memory
template <typename T>
__host__ __device__ constexpr size_t static_smem() {
    return sizeof(T) * TJ * tile_row<T>();
}

__device__ __forceinline__ float as_float(int8_t a) { return (float)a; }
__device__ __forceinline__ float as_float(uint16_t a) { return __uint_as_float((uint32_t)a << 16); }  // bf16 bits
__device__ __forceinline__ float as_float(float a) { return a; }

// T: the adjacency's entry type; X: the activations' (float, or bf16 bits)
template <int MODE, typename T, typename X>
__global__ void __launch_bounds__(THREADS) diag_aggregate(
    const T* __restrict__ adj, const X* __restrict__ x, const uint8_t* __restrict__ sign_in,
    const X* __restrict__ g_pool, const uint8_t* __restrict__ mask, float* __restrict__ out,
    uint8_t* __restrict__ sign_out, float* __restrict__ pooled, int G, int N, int F) {
    extern __shared__ float4 slab4[];
    float* slab = reinterpret_cast<float*>(slab4);  // [N][XS], u of this graph and feature chunk
    __shared__ T at[TJ][tile_row<T>()];             // adjacency tile, [j][i]

    const int g = blockIdx.x;
    const int f0 = blockIdx.y * FC;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t gn = (size_t)G * N;
    const size_t base = (size_t)g * N;
    const T* adj_g = adj + base * N;

    for (int idx = tid; idx < FC * N; idx += THREADS) {
        const int fl = idx / N;
        const int j = idx - fl * N;
        const int f = f0 + fl;
        float u = 0.f;
        if (f < F) {
            const size_t off = (size_t)f * gn + base + j;
            if (MODE == POOL_BWD) {
                u = sign_in[off] ? as_float(g_pool[(size_t)f * G + g]) : 0.f;
            } else {
                u = as_float(x[off]);
            }
        }
        slab[j * XS + fl] = u;
    }

    float psum[FPW];
#pragma unroll
    for (int k = 0; k < FPW; ++k) psum[k] = 0.f;

    for (int i0 = 0; i0 < N; i0 += TI) {
        float acc[FPW];
#pragma unroll
        for (int k = 0; k < FPW; ++k) acc[k] = 0.f;
        for (int j0 = 0; j0 < N; j0 += TJ) {
            __syncthreads();  // the slab is staged, and the previous tile is consumed
            for (int idx = tid; idx < TI * TJ; idx += THREADS) {
                const int ii = idx / TJ;
                const int jj = idx - ii * TJ;
                const int i = i0 + ii;
                const int j = j0 + jj;
                at[jj][ii] = (i < N && j < N) ? adj_g[(size_t)i * N + j] : T(0);
            }
            __syncthreads();
            const int jn = min(TJ, N - j0);
            for (int jj = 0; jj < jn; ++jj) {
                const float a = as_float(at[jj][lane]);
                const float4* up = reinterpret_cast<const float4*>(slab + (j0 + jj) * XS + warp * FPW);
                const float4 u0 = up[0];
                const float4 u1 = up[1];
                acc[0] = fmaf(a, u0.x, acc[0]);
                acc[1] = fmaf(a, u0.y, acc[1]);
                acc[2] = fmaf(a, u0.z, acc[2]);
                acc[3] = fmaf(a, u0.w, acc[3]);
                acc[4] = fmaf(a, u1.x, acc[4]);
                acc[5] = fmaf(a, u1.y, acc[5]);
                acc[6] = fmaf(a, u1.z, acc[6]);
                acc[7] = fmaf(a, u1.w, acc[7]);
            }
        }
        const int i = i0 + lane;
        if (i < N) {
            const bool masked = MODE == RELU_MASK || MODE == RELU_MASK_POOL;
            const float m = masked ? (mask[base + i] ? 1.f : 0.f) : 1.f;
#pragma unroll
            for (int k = 0; k < FPW; ++k) {
                const int f = f0 + warp * FPW + k;
                if (f < F) {
                    const size_t off = (size_t)f * gn + base + i;
                    if (MODE == PLAIN || MODE == POOL_BWD) {
                        out[off] = acc[k];
                    } else {
                        const float h = fmaxf(acc[k], 0.f) * m;
                        if (MODE == RELU_MASK) {
                            out[off] = h;
                        } else {
                            sign_out[off] = h > 0.f ? 1 : 0;
                            psum[k] += h;
                        }
                    }
                }
            }
        }
    }

    if (MODE == RELU_MASK_POOL) {
#pragma unroll
        for (int k = 0; k < FPW; ++k) {
            float s = psum[k];
            for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
            const int f = f0 + warp * FPW + k;
            if (lane == 0 && f < F) pooled[(size_t)f * G + g] = s;
        }
    }
}

template <int MODE, typename T, typename X>
int launch(const void* adj, const void* x, const void* sign_in, const void* g_pool, const void* mask, void* out,
           void* sign_out, void* pooled, int G, int N, int F, void* stream) {
    if (G <= 0 || N <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    const size_t smem = (size_t)N * XS * sizeof(float);
    if (smem + static_smem<T>() > 48 * 1024) {
        // a block's static and dynamic shared memory together above 48 KB
        // must be opted into (from N = 335 int8, 327 bf16, 313 f32 adjacency;
        // the slab is f32 in both forms); N beyond the card's per-block
        // limit fails here and the wrapper raises
        const cudaError_t e =
            cudaFuncSetAttribute(diag_aggregate<MODE, T, X>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            (void)cudaGetLastError();  // not sticky: clear it so later launches are not blamed
            return (int)e;
        }
    }
    const dim3 grid((unsigned)G, (unsigned)((F + FC - 1) / FC));
    diag_aggregate<MODE, T, X><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)adj, (const X*)x, (const uint8_t*)sign_in, (const X*)g_pool, (const uint8_t*)mask,
        (float*)out, (uint8_t*)sign_out, (float*)pooled, G, N, F);
    return (int)cudaGetLastError();
}

// the activation types, by their code in ops/diag_spmm.py (ACT_DTYPES)
enum ActType { ACT_F32 = 0, ACT_BF16 = 1 };

template <int MODE>
int launch_typed(int dtype, int xtype, const void* adj, const void* x, const void* sign_in, const void* g_pool,
                 const void* mask, void* out, void* sign_out, void* pooled, int G, int N, int F, void* stream) {
    if (xtype == ACT_BF16) {
        // the bf16 form: int8 and bf16 adjacencies only
        switch (dtype) {
            case INT8:
                return launch<MODE, int8_t, uint16_t>(adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
            case BF16:
                return launch<MODE, uint16_t, uint16_t>(adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F,
                                                        stream);
            default:
                return (int)cudaErrorInvalidValue;
        }
    }
    if (xtype != ACT_F32) return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case INT8:
            return launch<MODE, int8_t, float>(adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
        case BF16:
            return launch<MODE, uint16_t, float>(adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
        case F32:
            return launch<MODE, float, float>(adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int max_nodes_typed() {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
        (void)cudaGetLastError();
        return -1;
    }
    return (int)(((size_t)optin - static_smem<T>()) / (XS * sizeof(float)));
}

}  // namespace

extern "C" {

// adj [G, N, N] of type `dtype` (0 int8, 1 bf16, 2 f32); x [F, G*N] of type
// `xtype` (0 f32, 1 bf16: the bf16 form); mode 0 plain (out), 1 relu_mask
// (mask, out), 2 relu_mask_pool (mask, sign, pooled); out and pooled f32
int diag_kernel(const void* adj, int dtype, const void* x, int xtype, const void* mask, void* out, void* sign,
                void* pooled, int G, int N, int F, int mode, void* stream) {
    switch (mode) {
        case PLAIN:
            return launch_typed<PLAIN>(dtype, xtype, adj, x, nullptr, nullptr, nullptr, out, nullptr, nullptr, G, N, F,
                                       stream);
        case RELU_MASK:
            return launch_typed<RELU_MASK>(dtype, xtype, adj, x, nullptr, nullptr, mask, out, nullptr, nullptr, G, N, F,
                                           stream);
        case RELU_MASK_POOL:
            return launch_typed<RELU_MASK_POOL>(dtype, xtype, adj, x, nullptr, nullptr, mask, nullptr, sign, pooled, G,
                                                N, F, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// g_pool [F, G] of type `gtype` (0 f32, 1 bf16: the bf16 form); out f32
int pool_bwd_kernel(const void* adj, int dtype, const void* sign, const void* g_pool, int gtype, void* out, int G,
                    int N, int F, void* stream) {
    return launch_typed<POOL_BWD>(dtype, gtype, adj, nullptr, sign, g_pool, nullptr, out, nullptr, nullptr, G, N, F,
                                  stream);
}

// the largest N the current device runs in the form (adjacency `dtype`,
// activation `xtype`): its shared memory per block with the opt-in, which
// the activation type does not change (the slab is staged as f32); -1 on a
// CUDA error or a form that does not exist
int diag_max_nodes(int dtype, int xtype) {
    if (xtype != ACT_F32 && !(xtype == ACT_BF16 && (dtype == INT8 || dtype == BF16))) return -1;
    switch (dtype) {
        case INT8:
            return max_nodes_typed<int8_t>();
        case BF16:
            return max_nodes_typed<uint16_t>();
        case F32:
            return max_nodes_typed<float>();
        default:
            return -1;
    }
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
