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
// Two forms: f32, and the bf16 form of JAX's split=False branch
// (compute_dtype=bfloat16). Forward: x_t (read as f32), w1 and w2 rounded as
// they are staged, fcx1, h1 and fcx2 rounded before the products that take
// them (h1 written in f32, unrounded). Backward: g_pool rounded (so u2 =
// sign * bf16(g_pool)), t2 rounded (written as bf16, and the w2 product
// takes that value), u1 rounded, t1 written as bf16; w2 rounded. Every sum
// stays f32.
//
// What bounds them on an H100 SXM at the dense bench shape (G=512, N=160,
// F=38, C1=32, C2=64, about 8 neighbours a node): the forward moves 41.3 MB
// (adjacency 13.1, x_t 12.4, h1 10.5, sign 5.2 MB), 12.3 us at 3.35 TB/s,
// and needs 0.66 GFLOP (weight products 0.54, sparse aggregates 0.12), 9.8
// us at 67 TFLOP/s: bound by bytes. The backward moves 60.3 MB (adjacency,
// sign, h1, t2 and t1), 18 us, for 0.46 GFLOP (the w2 product 0.34, the
// aggregates 0.12), 6.8 us: bound by bytes. The bf16 form writes t2 and t1
// at 2 bytes (backward 44.6 MB, 13.3 us), and its weight products take bf16
// operands (989 TFLOP/s on the tensor cores): both still bound by bytes.
//
// Both run one graph a block of 256 threads on a compact plan, with the
// machinery of csrc/tower_common.cuh.
//
// Forward (K9f, tower_fwd), on the plan and steps of the batched forward
// (K8f, csrc/ginet_tower.cu): plan(..., is_forward), 98 KB in f32 at the
// bench shape (two blocks an SM) and 55 KB in bf16, whose slabs hold bf16
// (four blocks an SM: 512 graphs in one wave):
//   0. the adjacency as bits, x staged node-major from the channel-major
//      [F, G*N] rows (stage_flat_x: a warp reads 32 consecutive nodes of
//      one channel, four channels a thread, coalesced), the mask's bits and
//      the weights;
//   1-3. forward_fcx2: fcx = x w1 in register tiles (tile_gemm, ascending
//      k), h1 = relu(A fcx) * m one lane a row by the bit walk in ascending
//      neighbour order, written to h1 from the walk (a warp on 32
//      consecutive nodes of one channel: coalesced), fcx2 = h1 w2;
//   4. pool_rows: h2 = relu(A fcx2) * m one lane a row, its sign written as
//      bytes from the walk (coalesced), and pooled a fixed-order tree (a
//      lane's rows, a warp butterfly, the warps in order).
// These are the old one-block kernel's sums in the same order (ascending k
// in the weight products, ascending neighbours in the aggregates), so h1
// and the sign of h2 are the same bits; only the pool's order is new.
//
// Backward (K9b, tower_bwd): one block of 256 threads a graph on a compact
// plan of its own (bwd_plan: 81 KB in f32 at the bench shape, two blocks an
// SM; 46 KB in bf16, whose slabs hold bf16, four blocks an SM):
//   0. the adjacency, the sign of h2 and h1 > 0 as bits (warp ballots over
//      coalesced rows), w2 and this graph's g_pool;
//   1. t2 = g_pool[c, g] times the count of row i's neighbours whose sign
//      is set at c: popcounts, no slab of u2 and no gather. The product is
//      the exact sum rounded once (in the bf16 form, where g_pool is a bf16
//      value, exact: the plain version's value). Written coalesced (a warp
//      on 32 consecutive nodes of one channel) and kept in a slab;
//   2. u1 = (w2 t2) * [h1 > 0] in register tiles in ascending k (the bf16
//      form rounds u1, and a sum in another order lands on the neighbouring
//      bf16 often enough to fail the gate), the mask from the bits;
//   3. t1 = A u1, one lane a row, written coalesced.

#include "tower_common.cuh"

namespace {

using namespace tower;

// ---------------------------------------------------------------------------
// K9f: the forward on the towers' plan

// 0. x [F, G*N] of graph g (xg: its first column) -> X [rows][ld], node-major,
// columns F .. kx and rows N .. rows zero, rounded in the bf16 form: a thread
// takes four channels of a node, a warp 32 consecutive nodes (its four loads
// coalesced; its 16-byte stores on rows an odd number of 16-byte units apart)
template <bool BF16, typename E>
__device__ __forceinline__ void stage_flat_x(const Plan& L, E* X, const float* __restrict__ xg, size_t gn, int N, int F) {
    const int quads = L.kx / 4;
#pragma unroll 2
    for (int item = threadIdx.x; item < L.rows * quads; item += THREADS) {
        const int q = item / L.rows;
        const int i = item - q * L.rows;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int f = 4 * q + c;
            v[c] = i < N && f < F ? at_form<BF16>(__ldg(xg + (size_t)f * gn + i)) : 0.f;
        }
        put4(X + (size_t)i * L.ldp + 4 * q, make_float4(v[0], v[1], v[2], v[3]));
    }
}

// One graph's forward a block (see the header): h1 [C1, G*N], the sign of
// h2 [C2, G*N] and pooled [C2, G]
template <bool BF16>
__global__ void __launch_bounds__(THREADS, BF16 ? 4 : 2) tower_fwd(const int8_t* __restrict__ adj, const float* __restrict__ x,
                                                                   const uint8_t* __restrict__ mask, const float* __restrict__ w1,
                                                                   const float* __restrict__ w2, float* __restrict__ pooled,
                                                                   float* __restrict__ h1_out, uint8_t* __restrict__ sign_out, int G,
                                                                   int N, int F, int C1, int C2) {
    using E = elem_t<BF16>;
    extern __shared__ float4 smem4[];
    char* sm = reinterpret_cast<char*>(smem4);
    const Plan L = plan(N, F, C1, C2, (int)sizeof(E), true);
    const Slabs<E> s(sm, L);
    float* part = reinterpret_cast<float*>(sm + L.pool);
    const int g = blockIdx.x;
    const size_t base = (size_t)g * N;
    const size_t gn = (size_t)G * N;

    // 0. the graph
    adjacency_bits(adj, adj + base * N, N, L.words, s.bits);
    stage_flat_x<BF16>(L, s.p, x + base, gn, N, F);
    stage_mask_weights<BF16>(L, s, mask + base, w1, w2, N, F, C1, C2);
    __syncthreads();
    // 1-3. fcx, h1 (masked; written from the walk, a warp on 32 consecutive
    // nodes of one channel), fcx2; tile rows 2 in the bf16 form, within the
    // 64 registers four blocks an SM leave a thread
    forward_fcx2<BF16 ? 2 : 8, true>(L, s, N, F, C1, [&](int i, int q, const float4& h) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C1) h1_out[(size_t)(4 * q + c) * gn + base + i] = lane4(h, c);
        }
    });
    // 4. h2 = relu(A fcx2) * mask: its sign written from the walk, its sum
    // over the nodes as the warps' sums, then the warps added in order
    pool_rows<QMAX>(s.bits, s.mbits, L.words, s.p, L.ldp, N, L.c2p / 4, part, [&](int i, int q, const float4& h) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C2) sign_out[(size_t)(4 * q + c) * gn + base + i] = lane4(h, c) > 0.f ? 1 : 0;
        }
    });
    __syncthreads();
    for (int c = threadIdx.x; c < C2; c += THREADS) pooled[(size_t)c * G + g] = pool_total(part, L.c2p, c);
}

// ---------------------------------------------------------------------------
// K9b: the backward on a compact plan

// K9b's shared-memory plan (byte offsets; ops/diag_spmm.py:
// tower_bwd_smem_bytes mirrors it), channels padded to 4 (c1p, c2p) with
// exact zeros: the adjacency's bit rows bits [N][words], the sign of h2
// sgn [c2p][words] and h1 > 0 hb [c1p][words] (uint32), this graph's
// g_pool gp [c2p] (f32); then, of esize bytes each (4 in the f32 form, 2
// in the bf16 form), w2 [c1p][ldt], the t2 slab T [N][ldt] and the u1 slab
// U [N][ldu], each row an odd number of 16-byte units, each part 16-byte
// aligned.
struct BwdPlan {
    int c1p, c2p, words, ldt, ldu;
    size_t bits, sgn, hb, gp, w2, t, u, bytes;
};

__host__ __device__ inline BwdPlan bwd_plan(int n, int c1, int c2, int esize) {
    BwdPlan L;
    L.c1p = round4(c1);
    L.c2p = round4(c2);
    L.words = (n + 31) / 32;
    L.ldt = row_elems(L.c2p, esize);
    L.ldu = row_elems(L.c1p, esize);
    size_t at = 0;
    L.bits = take(at, (size_t)4 * n * L.words);
    L.sgn = take(at, (size_t)4 * L.c2p * L.words);
    L.hb = take(at, (size_t)4 * L.c1p * L.words);
    L.gp = take(at, (size_t)4 * L.c2p);
    L.w2 = take(at, (size_t)esize * L.c1p * L.ldt);
    L.t = take(at, (size_t)esize * n * L.ldt);
    L.u = take(at, (size_t)esize * n * L.ldu);
    L.bytes = at;
    return L;
}

// the words a warp ballots at a time, their loads in flight together: the
// sign's 320 and h1's 160 words at the bench shape take 2 and 1 rounds of
// the block's 8 warps
constexpr int ROW_BITS_ROUND = 20;
// the weight product's tile rows: 4 in the f32 form (at N = 160 and C1 = 32,
// five warps of 32 x 32 tiles; 8 rows would leave five of the eight warps
// idle), 2 in the bf16 form (within the 64 registers four blocks an SM
// leave a thread)
template <bool BF16>
constexpr int TILE_ROWS = BF16 ? 2 : 4;

// the sum of `count` copies of g, the exact sum rounded once: +0 for a
// count of 0, as the plain version's sum over the row gives (an unset sign
// adds +0), and in the bf16 form, where g is a bf16 value and every partial
// sum is exact, that sum bit for bit
__device__ __forceinline__ float copies_sum(float g, int count) { return g * (float)count + 0.f; }

template <bool BF16>
__global__ void __launch_bounds__(THREADS, BF16 ? 4 : 2) tower_bwd(const int8_t* __restrict__ adj, const float* __restrict__ g_pool,
                                                                   const uint8_t* __restrict__ sign, const float* __restrict__ h1,
                                                                   const float* __restrict__ w2, elem_t<BF16>* __restrict__ t2_out,
                                                                   elem_t<BF16>* __restrict__ t1_out, int G, int N, int C1, int C2) {
    using E = elem_t<BF16>;
    extern __shared__ float4 smem4[];
    char* sm = reinterpret_cast<char*>(smem4);
    const BwdPlan L = bwd_plan(N, C1, C2, (int)sizeof(E));
    uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L.bits);
    uint32_t* sgn = reinterpret_cast<uint32_t*>(sm + L.sgn);
    uint32_t* hb = reinterpret_cast<uint32_t*>(sm + L.hb);
    float* gp = reinterpret_cast<float*>(sm + L.gp);
    E* W2 = reinterpret_cast<E*>(sm + L.w2);
    E* T = reinterpret_cast<E*>(sm + L.t);
    E* U = reinterpret_cast<E*>(sm + L.u);
    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int words = L.words;
    const size_t base = (size_t)g * N;
    const size_t gn = (size_t)G * N;

    // 0. the adjacency, the sign of h2 and h1 > 0 as bits; this graph's
    // g_pool and w2 (both rounded in the bf16 form)
    adjacency_bits(adj, adj + base * N, N, words, bits);
    row_bits<ROW_BITS_ROUND>(sign + base, gn, C2, L.c2p, N, words, sgn, [](uint8_t v) { return v != 0; });
    row_bits<ROW_BITS_ROUND>(h1 + base, gn, C1, L.c1p, N, words, hb, [](float v) { return v > 0.f; });
    for (int c = tid; c < L.c2p; c += THREADS) gp[c] = c < C2 ? at_form<BF16>(g_pool[(size_t)c * G + g]) : 0.f;
#pragma unroll 4
    for (int idx = tid; idx < L.c1p * L.c2p; idx += THREADS) {
        const int r = idx / L.c2p;
        const int c = idx - r * L.c2p;
        put(W2 + (size_t)r * L.ldt + c, r < C1 && c < C2 ? at_form<BF16>(w2[(size_t)r * C2 + c]) : 0.f);
    }
    __syncthreads();

    // 1. t2 = A (sign * g_pool): g_pool[c] summed over the count of row i's
    // neighbours j with sign[c][j] -> T and out; a thread takes four channels
    // of a node, a warp 32 consecutive nodes
    for (int item = tid; item < N * (L.c2p / 4); item += THREADS) {
        const int q = item / N;
        const int i = item - q * N;
        int count[4];
        count_signs<4>(bits + i * words, sgn + 4 * q * words, words, count);
        float4 t;
        t.x = at_form<BF16>(copies_sum(gp[4 * q], count[0]));
        t.y = at_form<BF16>(copies_sum(gp[4 * q + 1], count[1]));
        t.z = at_form<BF16>(copies_sum(gp[4 * q + 2], count[2]));
        t.w = at_form<BF16>(copies_sum(gp[4 * q + 3], count[3]));
        put4(T + (size_t)i * L.ldt + 4 * q, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C2) put(t2_out + (size_t)(4 * q + c) * gn + base + i, lane4(t, c));
        }
    }
    __syncthreads();

    // 2. u1 = (w2 t2) * [h1 > 0] -> U (rounded in the bf16 form)
    tile_gemm<TILE_ROWS<BF16>, true>(T, L.ldt, W2, L.ldt, N, L.c1p, L.c2p, [&](int m, int n, float v) {
        put(U + (size_t)m * L.ldu + n, (hb[n * words + (m >> 5)] >> (m & 31)) & 1u ? v : 0.f);
    });
    __syncthreads();

    // 3. t1 = A u1 -> out, one lane a node
    aggregate<QMAX>(bits, words, U, L.ldu, N, N, L.c1p / 4, [&](int i, int q, float4 a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C1) put(t1_out + (size_t)(4 * q + c) * gn + base + i, lane4(a, c));
        }
    });
}

template <bool BF16>
cudaError_t fwd(const void* adj, const void* x_t, const void* mask, const void* w1, const void* w2, void* h1, void* sign,
                void* pooled, int G, int N, int F, int C1, int C2, cudaStream_t stream) {
    const size_t smem = plan(N, F, C1, C2, BF16 ? 2 : 4, true).bytes;
    const cudaError_t e = prepare(tower_fwd<BF16>, smem, true);
    if (e != cudaSuccess) return e;
    tower_fwd<BF16><<<G, THREADS, smem, stream>>>((const int8_t*)adj, (const float*)x_t, (const uint8_t*)mask, (const float*)w1,
                                                  (const float*)w2, (float*)pooled, (float*)h1, (uint8_t*)sign, G, N, F, C1, C2);
    return cudaGetLastError();
}

template <bool BF16>
cudaError_t bwd(const void* adj, const void* g_pool, const void* sign, const void* h1, const void* w2, void* t2, void* t1,
                int G, int N, int C1, int C2, cudaStream_t stream) {
    const size_t smem = bwd_plan(N, C1, C2, BF16 ? 2 : 4).bytes;
    const cudaError_t e = prepare(tower_bwd<BF16>, smem, true);
    if (e != cudaSuccess) return e;
    tower_bwd<BF16><<<G, THREADS, smem, stream>>>((const int8_t*)adj, (const float*)g_pool, (const uint8_t*)sign,
                                                  (const float*)h1, (const float*)w2, (elem_t<BF16>*)t2, (elem_t<BF16>*)t1, G, N,
                                                  C1, C2);
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
