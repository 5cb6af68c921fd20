// Device code shared by the fused GINet tower kernels for Hopper (sm_90a),
// which run one graph a thread block on a compact shared-memory plan: K8f and
// K8b (csrc/ginet_tower.cu, the batched [G, N, F] layout), K9f and K9b
// (csrc/diag_tower.cu, the flat [C, G*N] layout). K8f, K8b and K9f share one
// plan (plan(): node-major slabs, the forward's cut down) and the forward's
// steps (forward_fcx2, pool_rows); each stages its own layout's x.
//
// - The adjacency of a graph is 0/1 and sparse (about 8 neighbours of 160
//   nodes at the dense bench shape). A block turns its int8 [N, N] block
//   into one bit per entry (load_bits16 from 16-byte loads, or load_bits by
//   warp ballots; a nonzero entry counts as 1), and an aggregate A v walks a
//   row's set bits in ascending column order (BitWalk): it adds only the
//   neighbours' rows, in the order a dense sum over all columns would add
//   them, and skips the exact zeros.
// - A channel-major 0/1 array ([C, G*N]: the sign of h2, or h1 > 0) is kept
//   as bits too, a word per 32 nodes and channel (row_bits: a warp ballots
//   32 consecutive nodes of one channel, so its loads are coalesced). Then
//   A (g ⊙ sign) at node i and channel c is g[c] times the count of row i's
//   neighbours whose sign is set at c: popcounts of the adjacency's bit row
//   against the sign's (count_signs).
// - Slabs hold f32, or bf16 (as its bits, E = uint16_t) in the bf16 form,
//   where every value the form stores is rounded to bf16 anyway. A slab row
//   is padded to an odd number of 16-byte units (row_elems), so that 8
//   consecutive rows start in 8 different 16-byte bank groups.
// - aggregate: one lane a row, QMAX channel quads of the row's sum in
//   registers; the lane's 16-byte reads of its neighbours' rows are
//   independent of each other.
// - tile_gemm: the weight products in register tiles (TR x 8 a thread), in
//   f32 FMAs in ascending k: the plain versions' order, so that a bf16 form
//   rounds the same sums (a sum in the tensor cores' order lands on the
//   neighbouring bf16 often enough to flip a sign against the plain
//   version).
//
// Two forms by the compile-time flag BF16: f32, and the single-pass bf16
// form of the JAX kernels (compute_dtype=bfloat16), which rounds to bf16
// (nearest even, csrc/bf16.cuh) exactly where the Pallas bodies cast a matmul
// operand to bf16. Every sum runs in a fixed order in f32: results are
// deterministic and differ from the plain PyTorch versions only by summation
// order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"

namespace tower {

using bf16::put;
using bf16::round_bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// a slab element: f32, or bf16 as its bits
template <bool BF16>
using elem_t = typename std::conditional<BF16, uint16_t, float>::type;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// a slab row of `cols` elements of `esize` bytes, padded to an odd number of
// 16-byte units: 8 consecutive rows then start in 8 different 16-byte bank
// groups (ldmatrix's 8 row reads, the tiles' 8 lanes on 8 rows)
__host__ __device__ inline int row_elems(int cols, int esize) {
    int units = (cols * esize + 15) / 16;
    if (units % 2 == 0) ++units;
    return units * 16 / esize;
}

// the offset of a part of `bytes` bytes at `at`, which moves past it (parts
// 16-byte aligned)
__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
    const size_t here = at;
    at += (bytes + 15) / 16 * 16;
    return here;
}

// a value as the form computes with it: itself, or rounded to bf16
template <bool BF16>
__device__ inline float at_form(float v) {
    return BF16 ? round_bf16(v) : v;
}

__device__ inline float lane4(const float4& v, int c) { return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w; }

// slab elements: f32, or bf16 as its bits (a store rounds to nearest even)
__device__ __forceinline__ float get(const float* p) { return *p; }
__device__ __forceinline__ float get(const uint16_t* p) { return bf16::widen(*p); }
__device__ __forceinline__ float4 get4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 widen4(uint32_t lo, uint32_t hi) {
    return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u), __uint_as_float(hi << 16),
                       __uint_as_float(hi & 0xffff0000u));
}
__device__ __forceinline__ float4 get4(const uint16_t* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return widen4(v.x, v.y);
}
__device__ __forceinline__ void put4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void put4(uint16_t* p, const float4& v) {
    const uint32_t lo = bf16::bf16_bits(v.x) | (uint32_t)bf16::bf16_bits(v.y) << 16;
    const uint32_t hi = bf16::bf16_bits(v.z) | (uint32_t)bf16::bf16_bits(v.w) << 16;
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

__device__ __forceinline__ void add4(float4& acc, const float4& t) {
    acc.x += t.x;
    acc.y += t.y;
    acc.z += t.z;
    acc.w += t.w;
}

// ---------------------------------------------------------------------------
// bits

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

// 4 bits, one per byte of u: bit b <=> byte b != 0
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t u) { return ((__vcmpne4(u, 0u) & 0x08040201u) * 0x01010101u) >> 24; }

__device__ __forceinline__ uint32_t nonzero_bits16(const int4& v) {
    return nonzero_nibble((uint32_t)v.x) | nonzero_nibble((uint32_t)v.y) << 4 | nonzero_nibble((uint32_t)v.z) << 8 |
           nonzero_nibble((uint32_t)v.w) << 12;
}

// load_bits from 16-byte loads, when every adjacency row starts 16-byte
// aligned (N % 16 == 0): a thread builds each word from two pieces
__device__ __forceinline__ void load_bits16(const int8_t* __restrict__ adj_g, int n, int words, uint32_t* bits) {
    const int pieces = n / 16;
#pragma unroll 4
    for (int item = threadIdx.x; item < n * words; item += blockDim.x) {
        const int i = item / words;
        const int w = item - i * words;
        const int4* row = reinterpret_cast<const int4*>(adj_g + (size_t)i * n);
        const int4 lo = __ldg(row + 2 * w);
        const int4 hi = 2 * w + 1 < pieces ? __ldg(row + 2 * w + 1) : make_int4(0, 0, 0, 0);
        bits[item] = nonzero_bits16(lo) | nonzero_bits16(hi) << 16;
    }
}

// the adjacency of one graph (adj: the batch's [G, N, N] base, for the
// alignment test) as bits
__device__ __forceinline__ void adjacency_bits(const int8_t* __restrict__ adj, const int8_t* __restrict__ adj_g, int n, int words,
                                               uint32_t* bits) {
    if (n % 16 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15) == 0) {
        load_bits16(adj_g, n, words, bits);
    } else {
        load_bits(adj_g, n, words, bits);
    }
}

// bits[c*words + w] bit b <=> on(src[c*stride + 32*w + b]) for c < rows and
// 32 w + b < n; rows up to rows_pad are zero. A warp ballots 32 consecutive
// nodes of one row (coalesced), ROUND words at a time with their loads in
// flight together.
template <int ROUND, class T, class On>
__device__ __forceinline__ void row_bits(const T* __restrict__ src, size_t stride, int rows, int rows_pad, int n, int words,
                                         uint32_t* bits, On on) {
    const int lane = threadIdx.x & 31;
    const int total = rows_pad * words;
    for (int p0 = threadIdx.x >> 5; p0 < total; p0 += ROUND * WARPS) {
        T v[ROUND];
#pragma unroll
        for (int r = 0; r < ROUND; ++r) {
            const int p = p0 + r * WARPS;
            const int c = p / words;
            const int j = (p - c * words) * 32 + lane;
            v[r] = p < total && c < rows && j < n ? __ldg(src + c * stride + j) : T(0);
        }
#pragma unroll
        for (int r = 0; r < ROUND; ++r) {
            const uint32_t m = __ballot_sync(FULL, on(v[r]));
            if (lane == 0 && p0 + r * WARPS < total) bits[p0 + r * WARPS] = m;
        }
    }
}

// count[k] = the number of set bits of the bit row `row` that are also set in
// channel k's sign bits (sgn + k*words), k < K
template <int K>
__device__ __forceinline__ void count_signs(const uint32_t* row, const uint32_t* sgn, int words, int (&count)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) count[k] = 0;
    for (int u = 0; u < words; ++u) {
        const uint32_t a = row[u];
#pragma unroll
        for (int k = 0; k < K; ++k) count[k] += __popc(a & sgn[k * words + u]);
    }
}

// ---------------------------------------------------------------------------
// aggregates

// A walk over one bit row's set bits in ascending order; the next word is
// read one word ahead, so that its load is not on the walk's path.
struct BitWalk {
    const uint32_t* row;
    int words, w;
    uint32_t b, ahead;

    __device__ __forceinline__ BitWalk(const uint32_t* r, int n_words, bool live)
        : row(r), words(live ? n_words : 0), w(0), b(live ? r[0] : 0u), ahead(live && n_words > 1 ? r[1] : 0u) {}

    // the next set bit, or -1 past the last word
    __device__ __forceinline__ int next() {
        while (b == 0) {
            if (++w >= words) return -1;
            b = ahead;
            ahead = w + 1 < words ? row[w + 1] : 0u;
        }
        const int j = w * 32 + __ffs(b) - 1;
        b &= b - 1;
        return j;
    }
};

// acc[q] = sum over the set bits j of the bit row (none unless live) of
// v[j][4(q0+q) .. 4(q0+q)+3] for q0 + q < quads (0 past), ascending j
template <int QMAX, typename E>
__device__ __forceinline__ void row_sum(const uint32_t* row, int words, bool live, const E* v, int ldv, int q0, int quads,
                                        float4 (&acc)[QMAX]) {
#pragma unroll
    for (int q = 0; q < QMAX; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    BitWalk walk(row, words, live);
    for (int j = walk.next(); j >= 0; j = walk.next()) {
        const E* vj = v + (size_t)j * ldv + 4 * q0;
        if constexpr (sizeof(E) == 2) {  // bf16: two quads a 16-byte read
#pragma unroll
            for (int q = 0; q < QMAX; q += 2) {
                if (q0 + q + 1 < quads) {
                    const uint4 t = *reinterpret_cast<const uint4*>(vj + 4 * q);
                    add4(acc[q], widen4(t.x, t.y));
                    add4(acc[q + 1], widen4(t.z, t.w));
                } else if (q0 + q < quads) {
                    add4(acc[q], get4(vj + 4 * q));
                }
            }
        } else {
#pragma unroll
            for (int q = 0; q < QMAX; ++q) {
                if (q0 + q < quads) add4(acc[q], get4(vj + 4 * q));
            }
        }
    }
}

// epi(i, q, sum over the set bits j of row i of v[j][4q .. 4q+3]) for every
// row i < rows (0 past N) and quad q < quads, ascending j. One lane a row
// (threads 0 .. rows - 1, then again past THREADS), which walks the row's
// bits once for each QMAX quads and holds their sums in registers: the walk
// costs one lane's instructions, and the lane's 16-byte reads of a
// neighbour's row are independent of each other.
template <int QMAX, typename E, class Epi>
__device__ __forceinline__ void aggregate(const uint32_t* bits, int words, const E* v, int ldv, int n, int rows, int quads,
                                          Epi epi) {
    for (int i = threadIdx.x; i < rows; i += THREADS) {
        for (int q0 = 0; q0 < quads; q0 += QMAX) {
            float4 acc[QMAX];
            row_sum<QMAX>(bits + i * words, words, i < n, v, ldv, q0, quads, acc);
#pragma unroll
            for (int q = 0; q < QMAX; ++q) {
                if (q0 + q < quads) epi(i, q0 + q, acc[q]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// weight products: register tiles on the CUDA cores

// epi(m, n, sum_{k < K} a[m*lda + k] * B(k, n)) for m < M, n < Nn, with
// B(k, n) = b[k*ldb + n], or b[n*ldb + k] when B_NK; K a multiple of 4
// (operands zero-padded there), in f32 FMAs in ascending k: the order of the
// plain versions' products, so that a bf16 form rounds the same sums. A
// thread holds a TR x 8 tile: rows m0 + RL*j and, with CL = the least power
// of two with 8 CL >= Nn (at most 32; RL x CL = 32 lanes), columns
// n0 + 8*cl + i (B(k, n) row-major: two 16-byte reads a row of B) or
// n0 + cl + CL*i (B_NK: one 16-byte read of 4 k a column). A takes one
// 16-byte read of 4 k a row. With row strides of an odd number of 16-byte
// units, each read of a quarter-warp meets each bank once. An 8 x 8 tile
// reads 64 values for 256 FMAs per 4 k.
__device__ __forceinline__ int column_lanes_log2(int Nn) {
    int cl_log2 = 0;
    while (cl_log2 < 5 && (8 << cl_log2) < Nn) ++cl_log2;
    return cl_log2;
}

// the warp tasks of tile_gemm<TR>
__device__ __forceinline__ int tile_tasks(int TR, int M, int Nn) {
    const int cl_log2 = column_lanes_log2(Nn);
    const int RL = 32 >> cl_log2;
    return ((M + TR * RL - 1) / (TR * RL)) * ((Nn + (8 << cl_log2) - 1) / (8 << cl_log2));
}

// warps w0 .. w0 + nw - 1 take part
template <int TR, bool B_NK, typename E, class Epi>
__device__ __forceinline__ void tile_gemm(const E* a, int lda, const E* b, int ldb, int M, int Nn, int K, Epi epi, int w0 = 0,
                                          int nw = WARPS) {
    const int lane = threadIdx.x & 31;
    const int cl_log2 = column_lanes_log2(Nn);
    const int CL = 1 << cl_log2;
    const int RL = 32 >> cl_log2;
    const int cblocks = (Nn + 8 * CL - 1) / (8 * CL);
    const int warp = (threadIdx.x >> 5) - w0;
    if (warp < 0 || warp >= nw) return;
    const int cl = lane & (CL - 1);
    for (int task = warp; task < tile_tasks(TR, M, Nn); task += nw) {
        const int m0 = (task / cblocks) * TR * RL + (lane >> cl_log2);
        const int nb = (task % cblocks) * 8 * CL;
        const auto column = [&](int i) { return B_NK ? nb + cl + CL * i : nb + 8 * cl + i; };
        int ao[TR];  // rows past the end read the last one
#pragma unroll
        for (int j = 0; j < TR; ++j) ao[j] = min(m0 + RL * j, M - 1) * lda;
        int bo[B_NK ? 8 : 1];  // B_NK: each column's row of b (past the end: the last)
#pragma unroll
        for (int i = 0; i < (B_NK ? 8 : 1); ++i) bo[i] = B_NK ? min(column(i), Nn - 1) * ldb : column(0);
        float acc[TR][8];
#pragma unroll
        for (int j = 0; j < TR; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
        for (int k = 0; k < K; k += 4) {
            float4 av[TR];
#pragma unroll
            for (int j = 0; j < TR; ++j) av[j] = get4(a + ao[j] + k);
            if constexpr (B_NK) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float4 bv = get4(b + bo[i] + k);
#pragma unroll
                    for (int j = 0; j < TR; ++j) {
                        acc[j][i] = fmaf(av[j].x, bv.x, acc[j][i]);
                        acc[j][i] = fmaf(av[j].y, bv.y, acc[j][i]);
                        acc[j][i] = fmaf(av[j].z, bv.z, acc[j][i]);
                        acc[j][i] = fmaf(av[j].w, bv.w, acc[j][i]);
                    }
                }
            } else {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const E* bk = b + (size_t)(k + kk) * ldb + bo[0];
                    const float4 b0 = get4(bk);
                    const float4 b1 = get4(bk + 4);
                    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                    for (int j = 0; j < TR; ++j) {
                        const float a_k = lane4(av[j], kk);
#pragma unroll
                        for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(a_k, bv[i], acc[j][i]);
                    }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < TR; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (m0 + RL * j < M && column(i) < Nn) epi(m0 + RL * j, column(i), acc[j][i]);
            }
    }
}

// ---------------------------------------------------------------------------
// the forward plan and steps (K8f, K8b, K9f)

// The shared-memory plan of K8f, K8b and K9f (byte offsets;
// ops/tower_plan.py:plan_bytes mirrors it). Every dimension a product runs
// over is padded to 16 (rows: nodes; kx: features; c1p, c2p: channels) and
// the pads hold exact zeros, so the tensor cores take whole tiles:
//   bits [N][words] and the mask mbits [words] (uint32); the backward's
//   signs of h2 sgn [c2p][words] (uint32) and dpooled dp [c2p] (f32), or the
//   forward's warp sums pool [WARPS][c2p] (f32);
//   w1 [kx][ldw1], w2 [c1p][ldw2];
//   P [rows][ldp]: x, then fcx2, then (backward) dfcx2, then x again;
//   H [rows][ldh]: h1, then dfcx1;  T [rows][ldt]: fcx, then (backward) dh1
//   (the backward's own slab; the forward's fcx sits in P's columns kx ..
//   kx + c1p, beside x, which the product that writes it reads)
// (slabs and weights of esize bytes: 4 in the f32 form, 2 in the bf16 form).
struct Plan {
    int rows, kx, c1p, c2p, words, ldp, ldh, ldt, ldw1, ldw2;
    size_t bits, mbits, sgn, dp, pool, w1, w2, p, h, t, bytes;
};

__host__ __device__ inline Plan plan(int n, int f, int c1, int c2, int esize, bool is_forward) {
    Plan L;
    L.rows = round16(n);
    L.kx = round16(f);
    L.c1p = round16(c1);
    L.c2p = round16(c2);
    L.words = (n + 31) / 32;
    // the forward keeps fcx beside x in P (columns kx .. kx + c1p): no T
    const int pcols = is_forward ? L.kx + L.c1p : L.kx;
    L.ldp = row_elems(L.c2p > pcols ? L.c2p : pcols, esize);
    L.ldh = row_elems(L.c1p, esize);
    L.ldt = is_forward ? L.ldp : L.ldh;
    L.ldw1 = row_elems(L.c1p, esize);
    L.ldw2 = row_elems(L.c2p, esize);
    size_t at = 0;
    L.bits = take(at, (size_t)4 * n * L.words);
    L.mbits = take(at, (size_t)4 * L.words);
    L.sgn = take(at, is_forward ? 0 : (size_t)4 * L.c2p * L.words);
    L.dp = take(at, is_forward ? 0 : (size_t)4 * L.c2p);
    L.pool = take(at, is_forward ? (size_t)4 * WARPS * L.c2p : 0);
    L.w1 = take(at, (size_t)esize * L.kx * L.ldw1);
    L.w2 = take(at, (size_t)esize * L.c1p * L.ldw2);
    L.p = take(at, (size_t)esize * L.rows * L.ldp);
    L.h = take(at, (size_t)esize * L.rows * L.ldh);
    L.t = is_forward ? L.p + (size_t)esize * L.kx : take(at, (size_t)esize * L.rows * L.ldh);
    L.bytes = at;
    return L;
}

// the parts of one block's plan that every kernel on it uses
template <typename E>
struct Slabs {
    uint32_t* bits;
    uint32_t* mbits;
    E* w1;
    E* w2;
    E* p;
    E* h;
    E* t;

    __device__ __forceinline__ Slabs(char* sm, const Plan& L)
        : bits(reinterpret_cast<uint32_t*>(sm + L.bits)),
          mbits(reinterpret_cast<uint32_t*>(sm + L.mbits)),
          w1(reinterpret_cast<E*>(sm + L.w1)),
          w2(reinterpret_cast<E*>(sm + L.w2)),
          p(reinterpret_cast<E*>(sm + L.p)),
          h(reinterpret_cast<E*>(sm + L.h)),
          t(reinterpret_cast<E*>(sm + L.t)) {}
};

// the quads an aggregate's lane holds: C1's 8 at the bench widths
constexpr int QMAX = 8;

__device__ __forceinline__ bool bit_at(const uint32_t* bits, int i) { return (bits[i >> 5] >> (i & 31)) & 1u; }

// 0 (the layout-free part): the mask's bits of one graph (mask_g: its N
// bytes) and the weights, zero-padded, rounded in the bf16 form (no barrier)
template <bool BF16, typename E>
__device__ __forceinline__ void stage_mask_weights(const Plan& L, const Slabs<E>& s, const uint8_t* __restrict__ mask_g,
                                                   const float* __restrict__ w1, const float* __restrict__ w2, int N, int F, int C1,
                                                   int C2) {
    const int tid = threadIdx.x;
    for (int i = tid; i < 32 * L.words; i += THREADS) {  // every lane of a warp reaches the ballot
        const uint32_t m = __ballot_sync(FULL, i < N && mask_g[i] != 0);
        if ((i & 31) == 0) s.mbits[i / 32] = m;
    }
#pragma unroll 4
    for (int idx = tid; idx < L.kx * L.c1p; idx += THREADS) {
        const int k = idx / L.c1p;
        const int c = idx - k * L.c1p;
        put(s.w1 + (size_t)k * L.ldw1 + c, k < F && c < C1 ? at_form<BF16>(w1[(size_t)k * C1 + c]) : 0.f);
    }
#pragma unroll 4
    for (int idx = tid; idx < L.c1p * L.c2p; idx += THREADS) {
        const int k = idx / L.c2p;
        const int c = idx - k * L.c2p;
        put(s.w2 + (size_t)k * L.ldw2 + c, k < C1 && c < C2 ? at_form<BF16>(w2[(size_t)k * C2 + c]) : 0.f);
    }
}

// 1-3, after the staging and a barrier: fcx = x w1 -> T; h1 = relu(A fcx)
// -> H, times the mask where MASK_H1 (K9f's h1; K8's h1 is not masked);
// fcx2 = h1 w2 -> P, each step behind a barrier (the slab stores round in
// the bf16 form). h1_out(i, q, h) takes each row i < N's quad q of h1 before
// it is stored (unrounded). The forwards and K8b's recompute run this one
// path.
template <int TR, bool MASK_H1, typename E, class H1Out>
__device__ __forceinline__ void forward_fcx2(const Plan& L, const Slabs<E>& s, int N, int F, int C1, H1Out h1_out) {
    const auto to_t = [&](int m, int n, float v) { put(s.t + (size_t)m * L.ldt + n, v); };
    tile_gemm<TR, false>(s.p, L.ldp, s.w1, L.ldw1, L.rows, L.c1p, round4(F), to_t);
    __syncthreads();
    aggregate<QMAX>(s.bits, L.words, s.t, L.ldt, N, L.rows, L.c1p / 4, [&](int i, int q, float4 a) {
        const float m = !MASK_H1 || (i < N && bit_at(s.mbits, i)) ? 1.f : 0.f;
        const float4 v = make_float4(fmaxf(a.x, 0.f) * m, fmaxf(a.y, 0.f) * m, fmaxf(a.z, 0.f) * m, fmaxf(a.w, 0.f) * m);
        if (i < N) h1_out(i, q, v);
        E* h = s.h + (size_t)i * L.ldh + 4 * q;
        put(h, v.x);
        put(h + 1, v.y);
        put(h + 2, v.z);
        put(h + 3, v.w);
    });
    __syncthreads();
    const auto to_p = [&](int m, int n, float v) { put(s.p + (size_t)m * L.ldp + n, v); };
    tile_gemm<TR, false>(s.h, L.ldh, s.w2, L.ldw2, L.rows, L.c2p, round4(C1), to_p);
    __syncthreads();
}

// 4. part[warp][4q .. 4q+3] = the sum over the warp's rows i < n (i = 32
// warp + lane, then again THREADS further) of h = relu((A v)[i][4q .. 4q+3])
// * mask[i], q < quads: a lane walks its row once for each QMAX quads and
// hands each row's h to row_out(i, q, h), a butterfly of shuffles sums the
// warp's 32 rows (every lane ends with the same bits), and lane 0 adds that
// to the warp's sum, in row order. Only the row sums of one walk are held in
// registers. After a barrier, pool_total gives a channel's sum: the warps'
// sums added in order.
template <int QMAX_, typename E, class RowOut>
__device__ __forceinline__ void pool_rows(const uint32_t* bits, const uint32_t* mbits, int words, const E* v, int ldv, int n,
                                          int quads, float* part, RowOut row_out) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float* mine = part + (size_t)warp * 4 * quads;
    if (lane == 0) {
        for (int c = 0; c < 4 * quads; ++c) mine[c] = 0.f;
    }
    for (int q0 = 0; q0 < quads; q0 += QMAX_) {
        for (int i0 = 32 * warp; i0 < n; i0 += THREADS) {  // the same rounds for every lane of the warp
            const int i = i0 + lane;
            float4 acc[QMAX_];
            row_sum<QMAX_>(bits + (size_t)i * words, words, i < n, v, ldv, q0, quads, acc);
            const float m = i < n && bit_at(mbits, i) ? 1.f : 0.f;
#pragma unroll
            for (int q = 0; q < QMAX_; ++q) {
                acc[q] = make_float4(fmaxf(acc[q].x, 0.f) * m, fmaxf(acc[q].y, 0.f) * m, fmaxf(acc[q].z, 0.f) * m, fmaxf(acc[q].w, 0.f) * m);
                if (i < n && q0 + q < quads) row_out(i, q0 + q, acc[q]);
            }
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
                for (int q = 0; q < QMAX_; ++q) {
                    acc[q].x += __shfl_xor_sync(FULL, acc[q].x, d);
                    acc[q].y += __shfl_xor_sync(FULL, acc[q].y, d);
                    acc[q].z += __shfl_xor_sync(FULL, acc[q].z, d);
                    acc[q].w += __shfl_xor_sync(FULL, acc[q].w, d);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int q = 0; q < QMAX_; ++q) {
                    if (q0 + q < quads) {
                        float4* sum = reinterpret_cast<float4*>(mine + 4 * (q0 + q));
                        float4 t = *sum;
                        add4(t, acc[q]);
                        *sum = t;
                    }
                }
            }
        }
    }
}

// channel c's pooled sum from pool_rows' warp sums (rows of ld floats)
__device__ __forceinline__ float pool_total(const float* part, int ld, int c) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += part[w * ld + c];
    return t;
}

// ---------------------------------------------------------------------------
// launch

// Clears any earlier non-sticky error and opts the kernel into `smem` bytes
// of dynamic shared memory when that is above the default 48 KB; with
// `max_shared`, also all of an SM's shared memory to the carveout, so that
// several blocks of a compact plan fit. A plan above the card's limit fails
// here: the caller returns the error.
template <class Kernel>
inline cudaError_t prepare(Kernel* kernel, size_t smem, bool max_shared = false) {
    (void)cudaGetLastError();
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && max_shared) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) (void)cudaGetLastError();  // not sticky: clear it so later launches are not blamed
    return e;
}

}  // namespace tower
