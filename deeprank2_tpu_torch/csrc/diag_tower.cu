// Fused flat GINet tower kernels for Hopper (sm_90a), flat transposed
// [F, G*N] layout, bound with ctypes from deeprank2_tpu_torch/ops/diag_spmm.py.
//
// They replace the two TPU kernels of the fused tower in
// deeprank2_tpu/ops/diag_spmm.py:
//   tower_fwd_kernel  <- _tower_fwd_kernel  (launched by _tower_fwd_tpu)
//   tower_bwd_kernel  <- _tower_bwd_kernel  (launched by _tower_bwd_tpu)
//
// Per graph g (columns [g*N, (g+1)*N)), with the 0/1 adjacency A, the mask m,
// w1 [F, C1] and w2 [C1, C2]:
//   forward   h1 = relu(A (w1^T x_t)) * m          written, f32 [C1, G*N]
//             h2 = relu(A (w2^T h1)) * m           kept as its sign, uint8 [C2, G*N]
//             pooled[:, g] = sum_n h2              [C2, G]
//   backward  t2 = A (sign * g_pool[:, g])         f32 [C2, G*N]
//             t1 = A ((w2 t2) * [h1 > 0])          f32 [C1, G*N]
// The weight gradients dw2 = h1 t2^T and dw1 = x_t t1^T are plain products
// outside the kernels, as in the JAX package.
//
// Two forms (tower_common.cuh): f32, and the bf16 form of JAX's split=False
// branch (compute_dtype=bfloat16). Forward: x_t (read as f32), w1 and w2
// rounded as they are staged, fcx1, h1 and fcx2 rounded before the products
// that take them (h1 written in f32, unrounded). Backward: u2 = sign * bf16(g_pool), t2
// rounded (written as bf16, and the w2 product takes that value), u1
// rounded, t1 written as bf16; w2 rounded. Every sum stays f32.
//
// What bounds it on an H100 SXM at the dense bench shape (G=512, N=160,
// F=38, C1=32, C2=64, about 8 neighbours a node): the forward moves 41.3 MB
// (adjacency 13.1, x_t 12.4, h1 10.5, sign 5.2 MB), 12.3 us at 3.35 TB/s,
// and needs 0.66 GFLOP (weight products 0.54, sparse aggregates 0.12), 9.8
// us at 67 TFLOP/s: bound by bytes. The backward moves 60.3 MB (adjacency,
// sign, h1, t2 and t1), 18 us, for 0.46 GFLOP (the w2 product 0.34, the
// aggregates 0.12), 6.8 us: bound by bytes. The bf16 form writes t2 and t1
// at 2 bytes (backward 44.6 MB, 13.3 us), and its weight products take bf16
// operands (989 TFLOP/s on the tensor cores): both still bound by bytes.
//
// Design: the per-graph block of tower_common.cuh (one block of 512 threads
// a graph, intermediates in shared memory, the adjacency walked as bits);
// the channel-major rows are read and written by warps of 32 consecutive
// nodes, so every global access is coalesced.

#include "tower_common.cuh"

namespace {

using namespace tower;

template <bool BF16>
__global__ void __launch_bounds__(THREADS) tower_bwd(const int8_t* __restrict__ adj, const float* __restrict__ g_pool,
                                                     const uint8_t* __restrict__ sign, const float* __restrict__ h1,
                                                     const float* __restrict__ w2, act_t<BF16>* __restrict__ t2_out,
                                                     act_t<BF16>* __restrict__ t1_out, int G, int N, int C1, int C2) {
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    const Layout L = layout(N, 0, C1, C2);
    float* r1 = sm + L.r1;
    float* r2 = sm + L.r2;
    float* r4 = sm + L.r4;
    uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L.bits);
    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t base = (size_t)g * N;
    const size_t gn = (size_t)G * N;

    load_bits(adj + base * N, N, L.words, bits);
    load_weights<BF16>(nullptr, w2, 0, C1, C2, L, sm);
    // u2 = sign * g_pool[:, g] -> R1 [N][s1], padded channels 0
#pragma unroll 4
    for (int idx = tid; idx < L.c2p * N; idx += blockDim.x) {
        const int c = idx / N;
        const int i = idx - c * N;
        float u = 0.f;
        if (c < C2 && sign[(size_t)c * gn + base + i]) u = at_form<BF16>(g_pool[(size_t)c * G + g]);
        r1[(size_t)i * L.s1 + c] = u;
    }
    __syncthreads();
    const int q1 = L.c1p / 4;
    const int q2 = L.c2p / 4;
    // t2 = A u2 -> R4 and out
    aggregate(bits, L.words, r1, L.s1, N, q2, [&](int i, int q, float4 a) {
        const float4 t = at_form<BF16>(a);
        store4(r4 + (size_t)i * L.s1 + 4 * q, t);
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C2) put(t2_out + (size_t)(4 * q + c) * gn + base + i, lane4(t, c));
        }
    });
    __syncthreads();
    // u1 = (w2 t2) * [h1 > 0] -> R2
    weight_product<true>(r4, L.s1, sm + L.w2, L.ldw2, C2, N, q1, [&](int i, int q, float4 a) {
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < 4; ++c) {
            const int cc = 4 * q + c;
            if (cc < C1 && h1[(size_t)cc * gn + base + i] > 0.f) {
                if (c == 0) u.x = a.x;
                if (c == 1) u.y = a.y;
                if (c == 2) u.z = a.z;
                if (c == 3) u.w = a.w;
            }
        }
        store4(r2 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(u));
    });
    __syncthreads();
    // t1 = A u1 -> out
    aggregate(bits, L.words, r2, L.s2, N, q1, [&](int i, int q, float4 a) {
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C1) put(t1_out + (size_t)(4 * q + c) * gn + base + i, lane4(a, c));
        }
    });
}

template <bool BF16>
cudaError_t fwd(const void* adj, const void* x_t, const void* mask, const void* w1, const void* w2, void* h1, void* sign,
                void* pooled, int G, int N, int F, int C1, int C2, cudaStream_t stream) {
    const size_t smem = layout(N, F, C1, C2).bytes;
    const cudaError_t e = prepare(tower_fwd<true, BF16>, smem);
    if (e != cudaSuccess) return e;
    tower_fwd<true, BF16><<<G, THREADS, smem, stream>>>((const int8_t*)adj, (const float*)x_t, (const uint8_t*)mask,
                                                        (const float*)w1, (const float*)w2, (float*)pooled, (float*)h1,
                                                        (uint8_t*)sign, G, N, F, C1, C2);
    return cudaGetLastError();
}

template <bool BF16>
cudaError_t bwd(const void* adj, const void* g_pool, const void* sign, const void* h1, const void* w2, void* t2, void* t1,
                int G, int N, int C1, int C2, cudaStream_t stream) {
    const size_t smem = layout(N, 0, C1, C2).bytes;
    const cudaError_t e = prepare(tower_bwd<BF16>, smem);
    if (e != cudaSuccess) return e;
    tower_bwd<BF16><<<G, THREADS, smem, stream>>>((const int8_t*)adj, (const float*)g_pool, (const uint8_t*)sign,
                                                  (const float*)h1, (const float*)w2, (act_t<BF16>*)t2, (act_t<BF16>*)t1, G,
                                                  N, C1, C2);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 the f32 form, 1 the bf16 form (x_t, w1 and w2 f32 in both)
int tower_fwd_kernel(const void* adj, const void* x_t, int act, const void* mask, const void* w1, const void* w2, void* h1,
                     void* sign, void* pooled, int G, int N, int F, int C1, int C2, void* stream) {
    if (G <= 0 || N <= 0 || F <= 0 || C1 <= 0 || C2 <= 0) return (int)cudaErrorInvalidValue;
    switch (act) {
        case 0:
            return (int)fwd<false>(adj, x_t, mask, w1, w2, h1, sign, pooled, G, N, F, C1, C2, (cudaStream_t)stream);
        case 1:
            return (int)fwd<true>(adj, x_t, mask, w1, w2, h1, sign, pooled, G, N, F, C1, C2, (cudaStream_t)stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// act: 0 the f32 form (t2, t1 f32), 1 the bf16 form (t2, t1 bf16)
int tower_bwd_kernel(const void* adj, const void* g_pool, const void* sign, const void* h1, const void* w2, int act, void* t2,
                     void* t1, int G, int N, int C1, int C2, void* stream) {
    if (G <= 0 || N <= 0 || C1 <= 0 || C2 <= 0) return (int)cudaErrorInvalidValue;
    switch (act) {
        case 0:
            return (int)bwd<false>(adj, g_pool, sign, h1, w2, t2, t1, G, N, C1, C2, (cudaStream_t)stream);
        case 1:
            return (int)bwd<true>(adj, g_pool, sign, h1, w2, t2, t1, G, N, C1, C2, (cudaStream_t)stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
