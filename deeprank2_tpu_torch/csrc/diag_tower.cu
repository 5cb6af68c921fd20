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
// Forward (K9f, flat_fwd::tower_fwd): one block of 512 threads a graph on a
// plan of its own (every intermediate an f32 slab in shared memory, 150 KB
// at the bench shape: one block an SM); the channel-major rows are read and
// written by warps of 32 consecutive nodes, so every global access is
// coalesced.
//
// Backward (K9b, tower_bwd): one block of 256 threads a graph on a compact
// plan (bwd_plan: 89 KB in f32 at the bench shape, two blocks an SM; 46 KB
// in bf16, whose slabs hold bf16, four blocks an SM), the machinery of
// csrc/tower_common.cuh:
//   0. the adjacency, the sign of h2 and h1 > 0 as bits (warp ballots over
//      coalesced rows), w2 and this graph's g_pool;
//   1. t2 = g_pool[c, g] summed over the count of row i's neighbours whose
//      sign is set at c: popcounts, no slab of u2 and no gather. The bf16
//      form multiplies (exact: the plain version's value); the f32 form
//      takes the sum of the count's copies added in ascending order from a
//      table built once a graph, the ascending sum over the neighbours bit
//      for bit (the correctly rounded product moved dw1 off chip_smoke.py's
//      CROSS_TOL gate against tower_pooled_ref). Written
//      coalesced (a warp on 32 consecutive nodes of one channel) and kept in
//      a slab;
//   2. u1 = (w2 t2) * [h1 > 0] in register tiles in ascending k (the bf16
//      form rounds u1, and a sum in another order lands on the neighbouring
//      bf16 often enough to fail the gate), the mask from the bits;
//   3. t1 = A u1, one lane a row, written coalesced.

#include "tower_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K9f: the forward on its plan of one block a graph

namespace flat_fwd {

using tower::at_form;
using tower::lane4;
using tower::load_bits;
using tower::round4;

constexpr int THREADS = 512;

__host__ __device__ inline int stride(int v) { return (round4(v) / 4) % 2 ? round4(v) : round4(v) + 4; }

// Shared-memory plan of one block (all of it dynamic), in floats: two wide
// slabs R1, R4 [N][s1] with s1 = stride(max(F, c2p)), two narrow slabs R2,
// R3 [N][s2] with s2 = stride(c1p), w1 [F][c1p], w2 [c1p][stride(c2p)]
// (zero-padded), the mask [N] (rounded to 4), one per-graph vector [c2p] and
// the bit rows [N][ceil(N/32)] (uint32); c1p and c2p are C1 and C2 rounded
// up to 4, so that a thread reads four channels as one float4, and the
// padded channels stay exact zeros. stride(v) rounds v up to an odd number
// of float4s: the 8 lanes of a quarter-warp that read or write one float4
// each on 8 consecutive rows then touch all 32 banks once. x's columns F ..
// round4(F) are staged as zeros. ops/diag_spmm.py:tower_fwd_smem_bytes
// mirrors this plan; a plan above the card's per-block opt-in limit fails
// the cudaFuncSetAttribute call and the wrapper raises.
struct Layout {
    int s1, s2, c1p, c2p, ldw2, words;
    size_t r1, r4, r2, r3, w1, w2, mask, vec, bits;  // offsets in floats
    size_t bytes;
};

__host__ __device__ inline Layout layout(int n, int f, int c1, int c2) {
    Layout L;
    L.c1p = round4(c1);
    L.c2p = round4(c2);
    L.s1 = stride(f > L.c2p ? f : L.c2p);
    L.s2 = stride(L.c1p);
    L.ldw2 = stride(L.c2p);
    L.words = (n + 31) / 32;
    size_t o = 0;
    L.r1 = o;
    o += (size_t)n * L.s1;
    L.r4 = o;
    o += (size_t)n * L.s1;
    L.r2 = o;
    o += (size_t)n * L.s2;
    L.r3 = o;
    o += (size_t)n * L.s2;
    L.w1 = o;
    o += (size_t)f * L.c1p;
    L.w2 = o;
    o += (size_t)L.c1p * L.ldw2;
    L.mask = o;
    o += round4(n);
    L.vec = o;
    o += L.c2p;
    L.bits = o;
    o += (size_t)n * L.words;
    L.bytes = o * sizeof(float);
    return L;
}

template <bool BF16>
__device__ inline float4 at_form(const float4& v) {
    return make_float4(at_form<BF16>(v.x), at_form<BF16>(v.y), at_form<BF16>(v.z), at_form<BF16>(v.w));
}

__device__ inline void store4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }

__device__ inline float4 relu_scale(const float4& a, float m) {
    return make_float4(fmaxf(a.x, 0.f) * m, fmaxf(a.y, 0.f) * m, fmaxf(a.z, 0.f) * m, fmaxf(a.w, 0.f) * m);
}

// w1 [F][C1] -> [F][c1p] and w2 [C1][C2] -> [c1p][ldw2], zero-padded,
// rounded to bf16 in the bf16 form
template <bool BF16>
__device__ inline void load_weights(const float* __restrict__ w1, const float* __restrict__ w2, int f, int c1, int c2,
                                    const Layout& L, float* sm) {
    for (int idx = threadIdx.x; idx < f * L.c1p; idx += blockDim.x) {
        const int k = idx / L.c1p;
        const int c = idx - k * L.c1p;
        sm[L.w1 + idx] = c < c1 ? at_form<BF16>(w1[(size_t)k * c1 + c]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < L.c1p * L.ldw2; idx += blockDim.x) {
        const int r = idx / L.ldw2;
        const int c = idx - r * L.ldw2;
        sm[L.w2 + idx] = (r < c1 && c < c2) ? at_form<BF16>(w2[(size_t)r * c2 + c]) : 0.f;
    }
}

// epi(i, q, sum over the set bits j of row i of v[j][4q .. 4q+3]), ascending
// j; work items (node i, quad q) with i fastest, so that a warp writes 32
// consecutive nodes of one channel
template <class Epi>
__device__ inline void aggregate(const uint32_t* bits, int words, const float* v, int ldv, int n, int quads, Epi epi) {
    for (int item = threadIdx.x; item < n * quads; item += blockDim.x) {
        const int i = item % n;
        const int q = item / n;
        const float* vq = v + 4 * q;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int w = 0; w < words; ++w) {
            uint32_t b = bits[i * words + w];
            while (b) {
                const int j = w * 32 + __ffs(b) - 1;
                b &= b - 1;
                const float4 t = *reinterpret_cast<const float4*>(vq + (size_t)j * ldv);
                acc.x += t.x;
                acc.y += t.y;
                acc.z += t.z;
                acc.w += t.w;
            }
        }
        epi(i, q, acc);
    }
}

__device__ inline void fma4(float a, const float4& w, float4& acc) {
    acc.x = fmaf(a, w.x, acc.x);
    acc.y = fmaf(a, w.y, acc.y);
    acc.z = fmaf(a, w.z, acc.z);
    acc.w = fmaf(a, w.w, acc.w);
}

__device__ inline float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// epi(i, q, sum_{k < kdim} a[i][k] * w[k*ldw + 4q .. 4q+3]), ascending k. A
// thread takes nodes i0 .. i0+3 (rows past n read row n-1 and are not passed
// to epi) and one channel quad (q fastest: the lanes of a warp share the
// nodes' float4 loads and read consecutive weights), 16 FMAs for every 8
// float4 loads; a's rows are read four values at a time (lda and ldw are
// multiples of 4).
template <class Epi>
__device__ inline void weight_product(const float* a, int lda, const float* w, int ldw, int kdim, int n, int quads, Epi epi) {
    const int tiles = (n + 3) / 4;
    for (int item = threadIdx.x; item < tiles * quads; item += blockDim.x) {
        const int q = item % quads;
        const int i0 = (item / quads) * 4;
        const float* ar[4];
        float4 acc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            ar[r] = a + (size_t)min(i0 + r, n - 1) * lda;
            acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        int k = 0;
        for (; k + 4 <= kdim; k += 4) {
            float4 wv[4];  // wv[j] = w(k + j, 4q .. 4q+3)
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = load4(w + (size_t)(k + j) * ldw + 4 * q);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float4 a4 = load4(ar[r] + k);
                fma4(a4.x, wv[0], acc[r]);
                fma4(a4.y, wv[1], acc[r]);
                fma4(a4.z, wv[2], acc[r]);
                fma4(a4.w, wv[3], acc[r]);
            }
        }
        for (; k < kdim; ++k) {
            const float4 wk = load4(w + (size_t)k * ldw + 4 * q);
#pragma unroll
            for (int r = 0; r < 4; ++r) fma4(ar[r][k], wk, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (i0 + r < n) epi(i0 + r, q, acc[r]);
        }
    }
}

// One graph's forward: x_t [F, G*N] in, h1 [C1, G*N], the sign of h2
// [C2, G*N] and pooled [C2, G] out; h1 is masked too. The bf16 form rounds
// x and the weights as it stages them, and fcx, h1 and fcx2 before the
// products that take them (h1 is written in f32, unrounded, as JAX does).
template <bool BF16>
__global__ void __launch_bounds__(THREADS) tower_fwd(const int8_t* __restrict__ adj, const float* __restrict__ x,
                                                     const uint8_t* __restrict__ mask, const float* __restrict__ w1,
                                                     const float* __restrict__ w2, float* __restrict__ pooled,
                                                     float* __restrict__ h1_out, uint8_t* __restrict__ sign_out, int G, int N,
                                                     int F, int C1, int C2) {
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    const Layout L = layout(N, F, C1, C2);
    float* r1 = sm + L.r1;
    float* r2 = sm + L.r2;
    float* r3 = sm + L.r3;
    float* r4 = sm + L.r4;
    float* msk = sm + L.mask;
    uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L.bits);
    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t base = (size_t)g * N;
    const size_t gn = (size_t)G * N;

    load_bits(adj + base * N, N, L.words, bits);
    load_weights<BF16>(w1, w2, F, C1, C2, L, sm);
    for (int i = tid; i < N; i += blockDim.x) msk[i] = mask[base + i] ? 1.f : 0.f;
    const int f4 = round4(F);
#pragma unroll 4
    for (int idx = tid; idx < N * f4; idx += blockDim.x) {
        const int f = idx / N;
        const int i = idx - f * N;
        r1[(size_t)i * L.s1 + f] = f < F ? at_form<BF16>(x[(size_t)f * gn + base + i]) : 0.f;
    }
    __syncthreads();
    const int q1 = L.c1p / 4;
    const int q2 = L.c2p / 4;
    // fcx = x w1 -> R2
    weight_product(r1, L.s1, sm + L.w1, L.c1p, F, N, q1, [&](int i, int q, float4 a) { store4(r2 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    // h1 = relu(A fcx) * mask -> R3
    aggregate(bits, L.words, r2, L.s2, N, q1, [&](int i, int q, float4 a) {
        const float4 h = relu_scale(a, msk[i]);
        store4(r3 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(h));
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C1) h1_out[(size_t)(4 * q + c) * gn + base + i] = lane4(h, c);
        }
    });
    __syncthreads();
    // fcx2 = h1 w2 -> R4
    weight_product(r3, L.s2, sm + L.w2, L.ldw2, C1, N, q2, [&](int i, int q, float4 a) { store4(r4 + (size_t)i * L.s1 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    // h2 = relu(A fcx2) * mask -> R1 (x is dead)
    aggregate(bits, L.words, r4, L.s1, N, q2, [&](int i, int q, float4 a) {
        const float4 h = relu_scale(a, msk[i]);
        store4(r1 + (size_t)i * L.s1 + 4 * q, h);
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < C2) sign_out[(size_t)(4 * q + c) * gn + base + i] = lane4(h, c) > 0.f ? 1 : 0;
        }
    });
    __syncthreads();
    // the per-graph sum over nodes, in node order
    for (int c = tid; c < C2; c += blockDim.x) {
        float s = 0.f;
        for (int i = 0; i < N; ++i) s += r1[(size_t)i * L.s1 + c];
        pooled[(size_t)c * G + g] = s;
    }
}

}  // namespace flat_fwd

// ---------------------------------------------------------------------------
// K9b: the backward on a compact plan

using namespace tower;

// K9b's shared-memory plan (byte offsets; ops/diag_spmm.py:
// tower_bwd_smem_bytes mirrors it), channels padded to 4 (c1p, c2p) with
// exact zeros: the adjacency's bit rows bits [N][words], the sign of h2
// sgn [c2p][words] and h1 > 0 hb [c1p][words] (uint32), this graph's
// g_pool gp [c2p] and, in the f32 form, the ascending sums of its copies
// sums [c2p][SUMS] (f32); then, of esize bytes each (4 in the f32 form, 2
// in the bf16 form), w2 [c1p][ldt], the t2 slab T [N][ldt] and the u1 slab
// U [N][ldu], each row an odd number of 16-byte units, each part 16-byte
// aligned.
struct BwdPlan {
    int c1p, c2p, words, ldt, ldu;
    size_t bits, sgn, hb, gp, sums, w2, t, u, bytes;
};

// the f32 form's table of ascending sums of g_pool's copies a channel:
// sums[c][k] for counts k < SUMS (see copies_sum)
constexpr int SUMS = 32;

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
    L.sums = take(at, esize == 4 ? (size_t)4 * L.c2p * SUMS : 0);
    L.w2 = take(at, (size_t)esize * L.c1p * L.ldt);
    L.t = take(at, (size_t)esize * n * L.ldt);
    L.u = take(at, (size_t)esize * n * L.ldu);
    L.bytes = at;
    return L;
}

// the quads an aggregate's lane holds: C1's 8 at the bench widths
constexpr int QMAX = 8;
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

// the sum of `count` copies of g, added in ascending order from +0: the sum
// over a row's neighbours in ascending order (an unset sign adds +0), bit for
// bit. In the bf16 form g is a bf16 value, every partial sum is exact, and
// the product gives it (+0 for a count of 0, as the sum does); the f32 form
// looks the first SUMS up in its channel's row of the table `sums` and adds
// on from there.
template <bool BF16>
__device__ __forceinline__ float copies_sum(float g, int count, const float* sums) {
    if constexpr (BF16) return g * (float)count + 0.f;
    float s = sums[min(count, SUMS - 1)];
    for (int k = SUMS - 1; k < count; ++k) s += g;
    return s;
}

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
    float* sums = reinterpret_cast<float*>(sm + L.sums);
    for (int c = tid; c < L.c2p; c += THREADS) {
        const float gc = c < C2 ? at_form<BF16>(g_pool[(size_t)c * G + g]) : 0.f;
        gp[c] = gc;
        if (!BF16) {
            float s = 0.f;
            for (int k = 0; k < SUMS; ++k, s += gc) sums[c * SUMS + k] = s;
        }
    }
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
        t.x = at_form<BF16>(copies_sum<BF16>(gp[4 * q], count[0], sums + (4 * q) * SUMS));
        t.y = at_form<BF16>(copies_sum<BF16>(gp[4 * q + 1], count[1], sums + (4 * q + 1) * SUMS));
        t.z = at_form<BF16>(copies_sum<BF16>(gp[4 * q + 2], count[2], sums + (4 * q + 2) * SUMS));
        t.w = at_form<BF16>(copies_sum<BF16>(gp[4 * q + 3], count[3], sums + (4 * q + 3) * SUMS));
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
    const size_t smem = flat_fwd::layout(N, F, C1, C2).bytes;
    const cudaError_t e = prepare(flat_fwd::tower_fwd<BF16>, smem);
    if (e != cudaSuccess) return e;
    flat_fwd::tower_fwd<BF16><<<G, flat_fwd::THREADS, smem, stream>>>((const int8_t*)adj, (const float*)x_t, (const uint8_t*)mask,
                                                                      (const float*)w1, (const float*)w2, (float*)pooled, (float*)h1,
                                                                      (uint8_t*)sign, G, N, F, C1, C2);
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
