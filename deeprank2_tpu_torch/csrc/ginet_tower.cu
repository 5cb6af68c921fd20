// Fused GINet tower kernels for Hopper (sm_90a), batched [G, N, F] layout,
// bound with ctypes from deeprank2_tpu_torch/ops/ginet_tower.py.
//
// They replace the two TPU kernels of deeprank2_tpu/ops/pallas_ginet.py:
//   ginet_tower_fwd  <- _fwd_kernel  (launched by _pooled_fwd_call)
//   ginet_tower_bwd  <- _bwd_kernel  (launched by _pooled_bwd_call)
//
// Per graph g, with x [N, F], the 0/1 adjacency A [N, N], mask [N],
// w1 [F, C1] and w2 [C1, C2]:
//   forward   h1 = relu(A (x w1)),  h2 = relu(A (h1 w2)) * mask,
//             pooled[g] = sum_n h2                               [G, C2]
//   backward  recompute h1 and h2; dfcx2 = A (dpooled[g] * [h2 > 0]);
//             dw2 += h1^T dfcx2;  dh1 = (dfcx2 w2^T) * [h1 > 0];
//             dw1 += x^T (A dh1)                                 [F, C1], [C1, C2]
// (A is symmetric, so A^T v = A v.)
//
// Two forms (tower_common.cuh): f32, and the bf16 form of JAX's
// compute_dtype=bfloat16, which rounds x, w1, w2, fcx, h1, fcx2 (forward),
// then dpooled * [h2 > 0], dfcx2, dh1 and dfcx1 before the products that
// take them (_bmm and the einsums of pallas_ginet.py cast both operands);
// every input and every sum stays f32.
//
// What bounds it on an H100 SXM at the dense bench shape (G=512, N=160,
// F=38, C1=32, C2=64, about 8 neighbours a node): the forward reads the
// adjacency (13.1 MB int8), x (12.4 MB) and the mask once and writes 131 KB;
// 25.8 MB, 7.7 us at 3.35 TB/s. The products these inputs need are the two
// weight products (2*G*N*(F*C1 + C1*C2) = 0.54 GFLOP) and the two sparse
// aggregates (2*nnz*(C1 + C2) = 0.12 GFLOP), 9.8 us at the 67 TFLOP/s f32
// peak; counted dense, the aggregates alone are 2.5 GFLOP. The backward does
// about twice the products. So the f32 form is bound by operations, and a
// kernel that did the aggregates densely would do 4-5x the work: the design
// walks the adjacency's set bits instead (tower_common.cuh). In the bf16 form
// the weight products take bf16 operands, 989 TFLOP/s on the tensor cores
// (forward 0.5 us, backward 1.4 us), and only the aggregates stay at the f32
// rate (1.8 and 3.6 us): both directions are bound by their bytes (7.7 us).
//
// Design: one block of 512 threads per graph; the graph's adjacency (as
// bits), x and every intermediate stay in shared memory (140 KB at N=160,
// one block an SM), so the forward writes only [C2] per graph. The backward
// writes each graph's dw1/dw2 partials ([G, F*C1 + C1*C2], 6.7 MB at the
// bench shape) and a second kernel sums them over graphs in a fixed order:
// no atomics, deterministic. Tensor cores (wgmma) and TMA are later work.

#include "tower_common.cuh"

namespace {

using namespace tower;

template <bool BF16>
__global__ void __launch_bounds__(THREADS) ginet_tower_bwd_partials(
    const int8_t* __restrict__ adj, const float* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ w1, const float* __restrict__ w2, const float* __restrict__ dpooled,
    float* __restrict__ part, int N, int F, int C1, int C2) {
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    const Layout L = layout(N, F, C1, C2);
    float* r1 = sm + L.r1;
    float* r2 = sm + L.r2;
    float* r3 = sm + L.r3;
    float* r4 = sm + L.r4;
    float* msk = sm + L.mask;
    float* dp = sm + L.vec;
    uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L.bits);
    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t base = (size_t)g * N;
    const size_t e1 = (size_t)F * C1;
    float* part_g = part + (size_t)g * (e1 + (size_t)C1 * C2);

    load_bits(adj + base * N, N, L.words, bits);
    load_weights<BF16>(w1, w2, F, C1, C2, L, sm);
    for (int i = tid; i < N; i += blockDim.x) msk[i] = mask[base + i] ? 1.f : 0.f;
    // dpooled rounded once: dh2 = dpooled * [h2 > 0] takes its values or 0
    for (int c = tid; c < L.c2p; c += blockDim.x) dp[c] = c < C2 ? at_form<BF16>(dpooled[(size_t)g * C2 + c]) : 0.f;
    const int f4 = round4(F);
    auto load_x = [&]() {  // x [N][F] -> R1, columns F .. f4 zero
#pragma unroll 4
        for (int idx = tid; idx < N * f4; idx += blockDim.x) {
            const int i = idx / f4;
            const int f = idx - i * f4;
            r1[(size_t)i * L.s1 + f] = f < F ? at_form<BF16>(x[(base + i) * F + f]) : 0.f;
        }
    };
    load_x();
    __syncthreads();
    const int q1 = L.c1p / 4;
    const int q2 = L.c2p / 4;
    // recompute: fcx = x w1 -> R2; h1 = relu(A fcx) -> R3; fcx2 = h1 w2 -> R4
    weight_product<false>(r1, L.s1, sm + L.w1, L.c1p, F, N, q1, [&](int i, int q, float4 a) { store4(r2 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    aggregate(bits, L.words, r2, L.s2, N, q1, [&](int i, int q, float4 a) { store4(r3 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(relu_scale(a, 1.f))); });
    __syncthreads();
    weight_product<false>(r3, L.s2, sm + L.w2, L.ldw2, C1, N, q2, [&](int i, int q, float4 a) { store4(r4 + (size_t)i * L.s1 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    // h2 = relu(A fcx2) * mask; its cotangent dpooled * [h2 > 0] -> R1
    aggregate(bits, L.words, r4, L.s1, N, q2, [&](int i, int q, float4 a) {
        const float4 h = relu_scale(a, msk[i]);
        const float4 d = *reinterpret_cast<const float4*>(dp + 4 * q);
        store4(r1 + (size_t)i * L.s1 + 4 * q,
               make_float4(h.x > 0.f ? d.x : 0.f, h.y > 0.f ? d.y : 0.f, h.z > 0.f ? d.z : 0.f, h.w > 0.f ? d.w : 0.f));
    });
    __syncthreads();
    // dfcx2 = A (dpooled * [h2 > 0]) -> R4
    aggregate(bits, L.words, r1, L.s1, N, q2, [&](int i, int q, float4 a) { store4(r4 + (size_t)i * L.s1 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    // this graph's dw2 = h1^T dfcx2; dh1 = (dfcx2 w2^T) * [h1 > 0] -> R2; x back -> R1
    node_product(r3, L.s2, r4, L.s1, q1, N, q2, [&](int k, int q, float4 a) {
        for (int c = 0; c < 4; ++c) {
            if (k < C1 && 4 * q + c < C2) part_g[e1 + (size_t)k * C2 + 4 * q + c] = lane4(a, c);
        }
    });
    weight_product<true>(r4, L.s1, sm + L.w2, L.ldw2, C2, N, q1, [&](int i, int q, float4 a) {
        const float4 h = *reinterpret_cast<const float4*>(r3 + (size_t)i * L.s2 + 4 * q);
        store4(r2 + (size_t)i * L.s2 + 4 * q,
               at_form<BF16>(make_float4(h.x > 0.f ? a.x : 0.f, h.y > 0.f ? a.y : 0.f, h.z > 0.f ? a.z : 0.f, h.w > 0.f ? a.w : 0.f)));
    });
    load_x();
    __syncthreads();
    // dfcx1 = A dh1 -> R3 (h1 is dead)
    aggregate(bits, L.words, r2, L.s2, N, q1, [&](int i, int q, float4 a) { store4(r3 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    // this graph's dw1 = x^T dfcx1
    node_product(r1, L.s1, r3, L.s2, f4 / 4, N, q1, [&](int k, int q, float4 a) {
        for (int c = 0; c < 4; ++c) {
            if (k < F && 4 * q + c < C1) part_g[(size_t)k * C1 + 4 * q + c] = lane4(a, c);
        }
    });
}

constexpr int SUM_COLS = 32;  // entries per block
constexpr int SUM_ROWS = 8;   // graph lanes per block

// out[e] = sum_g part[g][e]: lane r sums graphs r, r+8, ... in order, then
// the 8 lane sums are added in order
__global__ void __launch_bounds__(SUM_COLS* SUM_ROWS) sum_partials(const float* __restrict__ part, float* __restrict__ out,
                                                                   int G, int E) {
    __shared__ float acc[SUM_ROWS][SUM_COLS + 1];
    const int col = threadIdx.x % SUM_COLS;
    const int row = threadIdx.x / SUM_COLS;
    const int e = blockIdx.x * SUM_COLS + col;
    float s = 0.f;
    if (e < E) {
        for (int g = row; g < G; g += SUM_ROWS) s += part[(size_t)g * E + e];
    }
    acc[row][col] = s;
    __syncthreads();
    if (row == 0 && e < E) {
        float t = 0.f;
        for (int r = 0; r < SUM_ROWS; ++r) t += acc[r][col];
        out[e] = t;
    }
}

template <bool BF16>
cudaError_t fwd(const void* adj, const void* x, const void* mask, const void* w1, const void* w2, void* pooled, int G, int N,
                int F, int C1, int C2, cudaStream_t stream) {
    const size_t smem = layout(N, F, C1, C2).bytes;
    const cudaError_t e = prepare(tower_fwd<false, BF16>, smem);
    if (e != cudaSuccess) return e;
    tower_fwd<false, BF16><<<G, THREADS, smem, stream>>>((const int8_t*)adj, (const float*)x, (const uint8_t*)mask,
                                                         (const float*)w1, (const float*)w2, (float*)pooled, nullptr, nullptr,
                                                         G, N, F, C1, C2);
    return cudaGetLastError();
}

template <bool BF16>
cudaError_t bwd(const void* adj, const void* x, const void* mask, const void* w1, const void* w2, const void* dpooled,
                void* part, void* out, int G, int N, int F, int C1, int C2, cudaStream_t stream) {
    const size_t smem = layout(N, F, C1, C2).bytes;
    cudaError_t e = prepare(ginet_tower_bwd_partials<BF16>, smem);
    if (e != cudaSuccess) return e;
    ginet_tower_bwd_partials<BF16><<<G, THREADS, smem, stream>>>((const int8_t*)adj, (const float*)x, (const uint8_t*)mask,
                                                                 (const float*)w1, (const float*)w2, (const float*)dpooled,
                                                                 (float*)part, N, F, C1, C2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int entries = F * C1 + C1 * C2;
    sum_partials<<<(entries + SUM_COLS - 1) / SUM_COLS, SUM_COLS * SUM_ROWS, 0, stream>>>((const float*)part, (float*)out, G,
                                                                                         entries);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// form: 0 the f32 form, 1 the bf16 form (x, w1 and w2 f32 in both)
int ginet_tower_fwd(const void* adj, const void* x, int form, const void* mask, const void* w1, const void* w2, void* pooled,
                    int G, int N, int F, int C1, int C2, void* stream) {
    if (G <= 0 || N <= 0 || F <= 0 || C1 <= 0 || C2 <= 0) return (int)cudaErrorInvalidValue;
    switch (form) {
        case 0:
            return (int)fwd<false>(adj, x, mask, w1, w2, pooled, G, N, F, C1, C2, (cudaStream_t)stream);
        case 1:
            return (int)fwd<true>(adj, x, mask, w1, w2, pooled, G, N, F, C1, C2, (cudaStream_t)stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// part: scratch [G, F*C1 + C1*C2]; out: [F*C1 + C1*C2] = dw1 then dw2; form
// as for ginet_tower_fwd
int ginet_tower_bwd(const void* adj, const void* x, int form, const void* mask, const void* w1, const void* w2,
                    const void* dpooled, void* part, void* out, int G, int N, int F, int C1, int C2, void* stream) {
    if (G <= 0 || N <= 0 || F <= 0 || C1 <= 0 || C2 <= 0) return (int)cudaErrorInvalidValue;
    switch (form) {
        case 0:
            return (int)bwd<false>(adj, x, mask, w1, w2, dpooled, part, out, G, N, F, C1, C2, (cudaStream_t)stream);
        case 1:
            return (int)bwd<true>(adj, x, mask, w1, w2, dpooled, part, out, G, N, F, C1, C2, (cudaStream_t)stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
