// Device code shared by the fused GINet tower kernels for Hopper (sm_90a):
// csrc/ginet_tower.cu (K8f/K8b, the batched [G, N, F] layout) and
// csrc/diag_tower.cu (K9f/K9b, the flat [F, G*N] layout).
//
// Both run the two-layer GINet tower of one graph per thread block,
//   h1 = relu(A (x w1)),  h2 = relu(A (h1 w2)) * mask,  pooled = sum_n h2
// with every intermediate in shared memory, so that a graph's adjacency and
// activations are read from device memory once per pass.
//
// The adjacency is 0/1 and sparse (about 8 neighbours of 160 nodes at the
// dense bench shape), so a block first turns its graph's int8 [N, N] block
// into one bit per entry (warp ballots over coalesced 32-byte rows) and each
// aggregate then walks a row's set bits in ascending column order: it adds
// only the neighbours' rows, in the order a dense sum over all columns would
// add them, and skips the exact zeros. A nonzero int8 entry counts as 1.
//
// Shared-memory plan of one block (all of it dynamic; no static shared
// memory), in floats: two wide slabs R1, R4 [N][s1] with
// s1 = stride(max(F, c2p)), two narrow slabs R2, R3 [N][s2] with
// s2 = stride(c1p), w1 [F][c1p], w2 [c1p][stride(c2p)] (zero-padded), the mask [N]
// (rounded to 4), one per-graph vector [c2p] and the bit rows [N][ceil(N/32)]
// (uint32); c1p and c2p are C1 and C2 rounded up to 4, so that a thread
// reads four channels as one float4, and the padded channels stay exact
// zeros. stride(v) rounds v up to an odd number of float4s: the 8 lanes of a
// quarter-warp that read or write one float4 each on 8 consecutive rows then
// touch all 32 banks once (a stride of 32 or 64 floats would put them all on
// the same 4 banks). x's columns F .. round4(F) are staged as zeros.
// ops/ginet_tower.py:smem_bytes mirrors this plan (the shape rule of
// supports()); a plan above the card's per-block opt-in limit fails the
// cudaFuncSetAttribute call and the wrapper raises.
//
// An aggregate's work items are (node i, four channels q) with i fastest, so
// that a warp writes 32 consecutive nodes of one channel (coalesced in the
// flat layout). The weight products give a thread four nodes and four
// channels (q fastest: the lanes of a warp share the nodes' float4 loads and
// read consecutive weights), 16 FMAs for every 8 float4 loads. Every sum
// runs in a fixed order in f32: results are deterministic and differ from
// the plain PyTorch versions only by summation order. (K8b, the batched
// backward, has a plan and products of its own in csrc/ginet_tower.cu.)
//
// Two forms, by the compile-time flag BF16: f32, and the single-pass bf16
// form of the JAX kernels (compute_dtype=bfloat16), which rounds to bf16
// (nearest even, csrc/bf16.cuh) exactly where the Pallas bodies cast a matmul
// operand to bf16: each value once, as it is staged or produced (x and the
// weights as they are loaded), never inside an FMA loop. Every input, every
// sum and every slab stays f32, so both forms share one shared-memory plan.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"

namespace tower {

using bf16::put;
using bf16::round_bf16;

constexpr int THREADS = 512;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline int stride(int v) { return (round4(v) / 4) % 2 ? round4(v) : round4(v) + 4; }

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

// a value as the form computes with it: itself, or rounded to bf16
template <bool BF16>
__device__ inline float at_form(float v) {
    return BF16 ? round_bf16(v) : v;
}

template <bool BF16>
__device__ inline float4 at_form(const float4& v) {
    return make_float4(at_form<BF16>(v.x), at_form<BF16>(v.y), at_form<BF16>(v.z), at_form<BF16>(v.w));
}

// the type of an output the form writes at its own width (K9b's t2 and
// t1): f32, or bf16 as its bits
template <bool BF16>
using act_t = typename std::conditional<BF16, uint16_t, float>::type;

__device__ inline float lane4(const float4& v, int c) { return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w; }

__device__ inline void store4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }

__device__ inline float4 relu_scale(const float4& a, float m) {
    return make_float4(fmaxf(a.x, 0.f) * m, fmaxf(a.y, 0.f) * m, fmaxf(a.z, 0.f) * m, fmaxf(a.w, 0.f) * m);
}

// bits[i*words + w] bit b <=> adj_g[i][32*w + b] != 0. A warp takes BITS_ROUND
// 32-byte pieces at a time, their loads in flight together, then ballots each.
constexpr int BITS_ROUND = 8;

__device__ inline void load_bits(const int8_t* __restrict__ adj_g, int n, int words, uint32_t* bits) {
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const int total = n * words;
    for (int p0 = threadIdx.x >> 5; p0 < total; p0 += BITS_ROUND * nwarps) {
        bool on[BITS_ROUND];
#pragma unroll
        for (int r = 0; r < BITS_ROUND; ++r) {
            const int p = p0 + r * nwarps;
            const int i = p / words;
            const int j = (p - i * words) * 32 + lane;
            on[r] = p < total && j < n && adj_g[(size_t)i * n + j] != 0;
        }
#pragma unroll
        for (int r = 0; r < BITS_ROUND; ++r) {
            const uint32_t m = __ballot_sync(0xffffffffu, on[r]);
            if (lane == 0 && p0 + r * nwarps < total) bits[p0 + r * nwarps] = m;
        }
    }
}

// w1 [F][C1] -> [F][c1p] and w2 [C1][C2] -> [c1p][ldw2], zero-padded (either
// may be null), rounded to bf16 in the bf16 form
template <bool BF16>
__device__ inline void load_weights(const float* __restrict__ w1, const float* __restrict__ w2, int f, int c1, int c2,
                                    const Layout& L, float* sm) {
    if (w1 != nullptr) {
        for (int idx = threadIdx.x; idx < f * L.c1p; idx += blockDim.x) {
            const int k = idx / L.c1p;
            const int c = idx - k * L.c1p;
            sm[L.w1 + idx] = c < c1 ? at_form<BF16>(w1[(size_t)k * c1 + c]) : 0.f;
        }
    }
    if (w2 != nullptr) {
        for (int idx = threadIdx.x; idx < L.c1p * L.ldw2; idx += blockDim.x) {
            const int r = idx / L.ldw2;
            const int c = idx - r * L.ldw2;
            sm[L.w2 + idx] = (r < c1 && c < c2) ? at_form<BF16>(w2[(size_t)r * c2 + c]) : 0.f;
        }
    }
}

// epi(i, q, sum over the set bits j of row i of v[j][4q .. 4q+3]), ascending j
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

// epi(i, q, sum_{k < kdim} a[i][k] * w(k, 4q .. 4q+3)), ascending k, with
// w(k, c) = w[k*ldw + c], or w[c*ldw + k] when TRANS. A thread takes nodes
// i0 .. i0+3 (rows past n read row n-1 and are not passed to epi) and one
// channel quad; a's rows are read four values at a time (lda and ldw are
// multiples of 4).
template <bool TRANS, class Epi>
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
            if (TRANS) {
                const float4 t0 = load4(w + (size_t)(4 * q) * ldw + k);
                const float4 t1 = load4(w + (size_t)(4 * q + 1) * ldw + k);
                const float4 t2 = load4(w + (size_t)(4 * q + 2) * ldw + k);
                const float4 t3 = load4(w + (size_t)(4 * q + 3) * ldw + k);
                wv[0] = make_float4(t0.x, t1.x, t2.x, t3.x);
                wv[1] = make_float4(t0.y, t1.y, t2.y, t3.y);
                wv[2] = make_float4(t0.z, t1.z, t2.z, t3.z);
                wv[3] = make_float4(t0.w, t1.w, t2.w, t3.w);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) wv[j] = load4(w + (size_t)(k + j) * ldw + 4 * q);
            }
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
            float4 wk;
            if (TRANS) {
                wk = make_float4(w[(size_t)(4 * q) * ldw + k], w[(size_t)(4 * q + 1) * ldw + k], w[(size_t)(4 * q + 2) * ldw + k],
                                 w[(size_t)(4 * q + 3) * ldw + k]);
            } else {
                wk = load4(w + (size_t)k * ldw + 4 * q);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) fma4(ar[r][k], wk, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (i0 + r < n) epi(i0 + r, q, acc[r]);
        }
    }
}

// One graph's forward tower; FLAT selects the layout (x [G, N, F] and
// pooled [G, C2], or x_t [F, G*N], pooled [C2, G], h1 [C1, G*N] and the sign
// of h2 [C2, G*N] written too). The flat tower masks h1 as well. The bf16
// form rounds x and the weights as it stages them, and fcx, h1 and fcx2
// before the products that take them (h1 is written in f32, unrounded, as
// JAX does).
template <bool FLAT, bool BF16>
__global__ void __launch_bounds__(THREADS) tower_fwd(const int8_t* __restrict__ adj, const float* __restrict__ x,
                                                     const uint8_t* __restrict__ mask, const float* __restrict__ w1,
                                                     const float* __restrict__ w2, float* __restrict__ pooled,
                                                     float* __restrict__ h1_out, uint8_t* __restrict__ sign_out, int G,
                                                     int N, int F, int C1, int C2) {
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
        if (FLAT) {
            const int f = idx / N;
            const int i = idx - f * N;
            r1[(size_t)i * L.s1 + f] = f < F ? at_form<BF16>(x[(size_t)f * gn + base + i]) : 0.f;
        } else {
            const int i = idx / f4;
            const int f = idx - i * f4;
            r1[(size_t)i * L.s1 + f] = f < F ? at_form<BF16>(x[(base + i) * F + f]) : 0.f;
        }
    }
    __syncthreads();
    const int q1 = L.c1p / 4;
    const int q2 = L.c2p / 4;
    // fcx = x w1 -> R2
    weight_product<false>(r1, L.s1, sm + L.w1, L.c1p, F, N, q1, [&](int i, int q, float4 a) { store4(r2 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    // h1 = relu(A fcx) (times the mask in the flat tower) -> R3
    aggregate(bits, L.words, r2, L.s2, N, q1, [&](int i, int q, float4 a) {
        const float4 h = relu_scale(a, FLAT ? msk[i] : 1.f);
        store4(r3 + (size_t)i * L.s2 + 4 * q, at_form<BF16>(h));
        if (FLAT) {
            for (int c = 0; c < 4; ++c) {
                if (4 * q + c < C1) h1_out[(size_t)(4 * q + c) * gn + base + i] = lane4(h, c);
            }
        }
    });
    __syncthreads();
    // fcx2 = h1 w2 -> R4
    weight_product<false>(r3, L.s2, sm + L.w2, L.ldw2, C1, N, q2, [&](int i, int q, float4 a) { store4(r4 + (size_t)i * L.s1 + 4 * q, at_form<BF16>(a)); });
    __syncthreads();
    // h2 = relu(A fcx2) * mask -> R1 (x is dead)
    aggregate(bits, L.words, r4, L.s1, N, q2, [&](int i, int q, float4 a) {
        const float4 h = relu_scale(a, msk[i]);
        store4(r1 + (size_t)i * L.s1 + 4 * q, h);
        if (FLAT) {
            for (int c = 0; c < 4; ++c) {
                if (4 * q + c < C2) sign_out[(size_t)(4 * q + c) * gn + base + i] = lane4(h, c) > 0.f ? 1 : 0;
            }
        }
    });
    __syncthreads();
    // the per-graph sum over nodes, in node order
    for (int c = tid; c < C2; c += blockDim.x) {
        float s = 0.f;
        for (int i = 0; i < N; ++i) s += r1[(size_t)i * L.s1 + c];
        if (FLAT) {
            pooled[(size_t)c * G + g] = s;
        } else {
            pooled[(size_t)g * C2 + c] = s;
        }
    }
}

// Clears any earlier non-sticky error and opts the kernel into `smem` bytes
// of dynamic shared memory when that is above the default 48 KB. A plan
// above the card's limit fails here: the caller returns the error.
template <class Kernel>
inline cudaError_t prepare(Kernel* kernel, size_t smem) {
    (void)cudaGetLastError();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            (void)cudaGetLastError();  // not sticky: clear it so later launches are not blamed
            return e;
        }
    }
    return cudaSuccess;
}

}  // namespace tower
