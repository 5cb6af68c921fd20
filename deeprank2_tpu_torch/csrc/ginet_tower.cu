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
// Forward (K8f, tower_common.cuh:tower_fwd): one block of 512 threads per
// graph; the graph's adjacency (as bits), x and every intermediate stay in
// shared memory (150 KB at N=160, one block an SM), so the forward writes
// only [C2] per graph.
//
// Backward (K8b, backward::ginet_tower_bwd_graph): one block of 256 threads
// per graph, on a plan of its own (backward::plan) that fits two graphs an SM
// in the f32 form (110 KB at the bench shape) and three in the bf16 form (62
// KB: its slabs hold bf16, since every value that form stores is rounded to
// bf16), so one block's barriers and loads overlap another's products.
//   - The node products, this graph's dw2 = h1^T dfcx2 and dw1 = x^T dfcx1,
//     run on the tensor cores in the bf16 form: warp-level mma.sync
//     m16n8k16 (bf16 operands, exact products), fragments from the bf16
//     slabs by ldmatrix.trans, each 16-node window in a fresh fragment joined
//     to an f32 sum rounded to nearest (the tensor cores truncate their own
//     sums; csrc/diag_spmm.cu). In the f32 form the 8 lanes of an 8 x 8 dw
//     tile split the nodes, four 16-byte reads a node for 64 FMAs, and a
//     butterfly of shuffles sums the lanes.
//   - The weight products (x w1 and h1 w2 recomputed, dfcx2 w2^T) run on the
//     CUDA cores in both forms, in register tiles (8 x 8 a thread in f32,
//     4 x 8 in bf16; 16-byte reads of 4 k, 64 values for 256 FMAs an 8 x 8
//     tile), in ascending k: the bf16 form rounds their sums, and a sum in
//     another order (the tensor cores') lands on the neighbouring bf16 value
//     often enough to flip the sign of an h2 near zero or a dh1 against the
//     plain version, which moves whole columns of dw2 or dw1 off the gates.
//   - The aggregates walk the adjacency's set bits in ascending order, one
//     lane a row holding 8 or 16 channel quads. The cotangent of h2,
//     dpooled * [h2 > 0], is dpooled times a 0/1 sign, so dfcx2 = A (that) is
//     dpooled[c] times the count of row i's neighbours whose h2 is positive
//     at c: the signs are kept as bits, a word per 32 nodes and channel, and
//     the counts are popcounts of the adjacency's bit rows against them (in
//     the bf16 form the product of a bf16 and a count is exact, the value
//     the sum gives).
//   - Each graph writes its dw1/dw2 ([G, F*C1 + C1*C2], 6.7 MB at the bench
//     shape) and backward::sum_partials sums them over graphs in a fixed
//     order, with 8 loads in flight a thread: no atomics, deterministic.

#include "tower_common.cuh"

namespace {

using namespace tower;

namespace backward {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// a slab row of `cols` elements of `esize` bytes, padded to an odd number of
// 16-byte units: 8 consecutive rows then start in 8 different 16-byte bank
// groups (ldmatrix's 8 row reads, the f32 tiles' 8 lanes on 8 rows)
__host__ __device__ inline int row_elems(int cols, int esize) {
    int units = (cols * esize + 15) / 16;
    if (units % 2 == 0) ++units;
    return units * 16 / esize;
}

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
    const size_t here = at;
    at += (bytes + 15) / 16 * 16;
    return here;
}

// The backward's shared-memory plan (byte offsets; ops/ginet_tower.py:
// bwd_smem_bytes mirrors it). Every dimension a product runs over is padded
// to 16 (rows: nodes; kx: features; c1p, c2p: channels) and the pads hold
// exact zeros, so the tensor cores take whole tiles:
//   bits [N][words], the mask mbits [words] and sgn [c2p][words] (uint32),
//   dp [c2p] (f32);
//   w1 [kx][ldw1], w2 [c1p][ldw2];
//   P [rows][ldp]: x, then fcx2, then dfcx2, then x again;
//   H [rows][ldh]: h1, then dfcx1;  T [rows][ldh]: fcx, then dh1
// (slabs and weights of esize bytes: 4 in the f32 form, 2 in the bf16 form).
struct Plan {
    int rows, kx, c1p, c2p, words, ldp, ldh, ldw1, ldw2;
    size_t bits, mbits, sgn, dp, w1, w2, p, h, t, bytes;
};

__host__ __device__ inline Plan plan(int n, int f, int c1, int c2, int esize) {
    Plan L;
    L.rows = round16(n);
    L.kx = round16(f);
    L.c1p = round16(c1);
    L.c2p = round16(c2);
    L.words = (n + 31) / 32;
    L.ldp = row_elems(L.c2p > L.kx ? L.c2p : L.kx, esize);
    L.ldh = row_elems(L.c1p, esize);
    L.ldw1 = row_elems(L.c1p, esize);
    L.ldw2 = row_elems(L.c2p, esize);
    size_t at = 0;
    L.bits = take(at, (size_t)4 * n * L.words);
    L.mbits = take(at, (size_t)4 * L.words);
    L.sgn = take(at, (size_t)4 * L.c2p * L.words);
    L.dp = take(at, (size_t)4 * L.c2p);
    L.w1 = take(at, (size_t)esize * L.kx * L.ldw1);
    L.w2 = take(at, (size_t)esize * L.c1p * L.ldw2);
    L.p = take(at, (size_t)esize * L.rows * L.ldp);
    L.h = take(at, (size_t)esize * L.rows * L.ldh);
    L.t = take(at, (size_t)esize * L.rows * L.ldh);
    L.bytes = at;
    return L;
}

// slab elements: f32, or bf16 as its bits (a store rounds to nearest even)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) { *p = bf16::bf16_bits(v); }
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

// 4 bits, one per byte of u: bit b <=> byte b != 0
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t u) { return ((__vcmpne4(u, 0u) & 0x08040201u) * 0x01010101u) >> 24; }

__device__ __forceinline__ uint32_t nonzero_bits16(const int4& v) {
    return nonzero_nibble((uint32_t)v.x) | nonzero_nibble((uint32_t)v.y) << 4 | nonzero_nibble((uint32_t)v.z) << 8 |
           nonzero_nibble((uint32_t)v.w) << 12;
}

// tower::load_bits from 16-byte loads, when every adjacency row starts
// 16-byte aligned (N % 16 == 0): a thread builds each word from two pieces
__device__ __forceinline__ void load_bits16(const int8_t* __restrict__ adj_g, int n, int words, uint32_t* bits) {
    const int pieces = n / 16;
#pragma unroll 4
    for (int item = threadIdx.x; item < n * words; item += THREADS) {
        const int i = item / words;
        const int w = item - i * words;
        const int4* row = reinterpret_cast<const int4*>(adj_g + (size_t)i * n);
        const int4 lo = __ldg(row + 2 * w);
        const int4 hi = 2 * w + 1 < pieces ? __ldg(row + 2 * w + 1) : make_int4(0, 0, 0, 0);
        bits[item] = nonzero_bits16(lo) | nonzero_bits16(hi) << 16;
    }
}

// x [N][F] of one graph -> X [rows][ld], columns F .. kx and rows N .. rows
// zero; float4 loads of the graph's flat block when it is 16-byte aligned
// (thread t of nt)
template <bool BF16, typename E>
__device__ __forceinline__ void stage_x(E* X, int ld, const float* __restrict__ xg, int n, int f, int rows, int kx,
                                        bool vec, int t, int nt) {
    for (int idx = t; idx < rows * (kx - f); idx += nt) {
        const int i = idx / (kx - f);
        put(X + (size_t)i * ld + f + (idx - i * (kx - f)), 0.f);
    }
    for (int idx = t; idx < (rows - n) * f; idx += nt) {
        const int i = n + idx / f;
        put(X + (size_t)i * ld + idx % f, 0.f);
    }
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(xg);
        const int n4 = n * f / 4;
#pragma unroll 4
        for (int idx = t; idx < n4; idx += nt) {
            const float4 v = __ldg(x4 + idx);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int e = 4 * idx + c;
                const int i = e / f;
                put(X + (size_t)i * ld + (e - i * f), tower::at_form<BF16>(tower::lane4(v, c)));
            }
        }
    } else {
#pragma unroll 4
        for (int e = t; e < n * f; e += nt) {
            const int i = e / f;
            put(X + (size_t)i * ld + (e - i * f), tower::at_form<BF16>(__ldg(xg + e)));
        }
    }
}

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

__device__ __forceinline__ void add4(float4& acc, const float4& t) {
    acc.x += t.x;
    acc.y += t.y;
    acc.z += t.z;
    acc.w += t.w;
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
#pragma unroll
            for (int q = 0; q < QMAX; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
            BitWalk walk(bits + i * words, words, i < n);
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
#pragma unroll
            for (int q = 0; q < QMAX; ++q) {
                if (q0 + q < quads) epi(i, q0 + q, acc[q]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// f32 form: register tiles on the CUDA cores

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
                        const float a_k = tower::lane4(av[j], kk);
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

// epi(m, n, sum_{i < nodes} a[i*lda + m] * b[i*ldb + n]) for m < M, n < Nn,
// whose columns up to 8 ceil(M/8) and 8 ceil(Nn/8) are defined. 8 x 8 tiles
// (rows 8 mt .. 8 mt + 7, columns 8 nt .. 8 nt + 7: four 16-byte reads a
// node for 64 FMAs); the 8 lanes of a tile take nodes s, s + 8, ... (lane
// s), ascending, and a butterfly of shuffles sums their tiles (every lane
// ends with the same bits); lane s hands row s on. Warps w0 .. w0 + nw - 1
// take part, four tiles each.
template <class Epi>
__device__ __forceinline__ void node_gemm(const float* a, int lda, const float* b, int ldb, int M, int Nn, int nodes, Epi epi,
                                          int w0 = 0, int nw = WARPS) {
    const int lane = threadIdx.x & 31;
    const int s = lane & 7;
    const int MT = (M + 7) / 8;
    const int NT = (Nn + 7) / 8;
    const int warp = (threadIdx.x >> 5) - w0;
    if (warp < 0 || warp >= nw) return;
    for (int tile0 = warp * 4; tile0 < MT * NT; tile0 += nw * 4) {
        const int tile = tile0 + (lane >> 3);
        const bool live = tile < MT * NT;
        const int m0 = live ? 8 * (tile / NT) : 0;
        const int n0 = live ? 8 * (tile % NT) : 0;
        float acc[8][8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;
        for (int i = s; i < nodes; i += 8) {
            const float4 a0 = get4(a + i * lda + m0), a1 = get4(a + i * lda + m0 + 4);
            const float4 b0 = get4(b + i * ldb + n0), b1 = get4(b + i * ldb + n0 + 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(av[j], bv[c], acc[j][c]);
        }
#pragma unroll
        for (int d = 1; d < 8; d <<= 1)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[j][c] += __shfl_xor_sync(FULL, acc[j][c], d);
        if (live) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                if (j == s && m0 + j < M) {
#pragma unroll
                    for (int c = 0; c < 8; ++c) {
                        if (n0 + c < Nn) epi(m0 + j, n0 + c, acc[j][c]);
                    }
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 form: warp-level mma.sync on the tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d = a * b into a fresh fragment: bf16 operands, f32 sums
__device__ __forceinline__ void mma_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// epi(m, n, sum_{k < K} a[k*lda + m] * b[k*ldb + n]) for m < M, n < Nn (all
// multiples of 16): the node products, both operands node-major bf16 (k: the
// node). A warp takes 16 x 16 output tiles; its fragments come by
// ldmatrix.trans; each 16-node window's products (exact) sum in a fresh
// fragment, since the tensor cores do not round their sums to nearest, and
// join the f32 sum with f32 adds, in ascending windows. Fragments (PTX ISA,
// mma.m16n8k16): lane = 4 gid + tig holds rows gid, gid + 8 and columns
// 2 tig, 2 tig + 1 of the sums. Warps w0 .. w0 + nw - 1 take part.
template <class Epi>
__device__ __forceinline__ void node_mma(const uint16_t* a, int lda, const uint16_t* b, int ldb, int M, int Nn, int K, Epi epi,
                                         int w0 = 0, int nw = WARPS) {
    const int lane = threadIdx.x & 31;
    const int q = lane >> 3;
    const int r = lane & 7;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int nb = Nn / 16;
    const int warp = (threadIdx.x >> 5) - w0;
    if (warp < 0 || warp >= nw) return;
    for (int task = warp; task < (M / 16) * nb; task += nw) {
        const int m0 = (task / nb) * 16;
        const int n0 = (task % nb) * 16;
        // this lane's row of the 8 x 8 matrices the x4 loads take: A's in the
        // order of its fragment (m0, m0 + 8; then the window's second half),
        // B's as n-tile 0 (window halves), then n-tile 1
        const uint16_t* pa = a + (size_t)(r + 8 * (q >> 1)) * lda + m0 + 8 * (q & 1);
        const uint16_t* pb = b + (size_t)(r + 8 * (q & 1)) * ldb + n0 + 8 * (q >> 1);
        float acc[2][4] = {};
        for (int k0 = 0; k0 < K; k0 += 16) {
            uint32_t af[4], bf[4];
            ldsm_x4_trans(af, pa + (size_t)k0 * lda);
            ldsm_x4_trans(bf, pb + (size_t)k0 * ldb);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                float d[4];
                mma_fresh(d, af, bf[2 * nt], bf[2 * nt + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nt][e] += d[e];
            }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const int n = n0 + 8 * nt + 2 * tig;
            epi(m0 + gid, n, acc[nt][0]);
            epi(m0 + gid, n + 1, acc[nt][1]);
            epi(m0 + gid + 8, n, acc[nt][2]);
            epi(m0 + gid + 8, n + 1, acc[nt][3]);
        }
    }
}

// One graph's backward a block (see the header); part_g: the graph's
// [F*C1 + C1*C2] partial, dw1 then dw2.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, BF16 ? 3 : 2) ginet_tower_bwd_graph(
    const int8_t* __restrict__ adj, const float* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ w1, const float* __restrict__ w2, const float* __restrict__ dpooled,
    float* __restrict__ part, int N, int F, int C1, int C2) {
    using E = typename std::conditional<BF16, uint16_t, float>::type;
    // the weight products' tile rows (see the header): 4 in the bf16 form,
    // within the registers of three blocks an SM
    constexpr int TILE_ROWS = BF16 ? 4 : 8;
    extern __shared__ float4 smem4[];
    char* sm = reinterpret_cast<char*>(smem4);
    const Plan L = plan(N, F, C1, C2, (int)sizeof(E));
    uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L.bits);
    uint32_t* mbits = reinterpret_cast<uint32_t*>(sm + L.mbits);
    uint32_t* sgn = reinterpret_cast<uint32_t*>(sm + L.sgn);
    float* dp = reinterpret_cast<float*>(sm + L.dp);
    E* W1 = reinterpret_cast<E*>(sm + L.w1);
    E* W2 = reinterpret_cast<E*>(sm + L.w2);
    E* P = reinterpret_cast<E*>(sm + L.p);
    E* H = reinterpret_cast<E*>(sm + L.h);
    E* T = reinterpret_cast<E*>(sm + L.t);
    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int rows = L.rows;
    const int8_t* adj_g = adj + (size_t)g * N * N;
    const float* x_g = x + (size_t)g * N * F;
    const uint8_t* mask_g = mask + (size_t)g * N;
    float* part_g = part + (size_t)g * ((size_t)F * C1 + (size_t)C1 * C2);
    float* dw2_g = part_g + (size_t)F * C1;
    const bool x_vec = (N * F) % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    // the quads an aggregate's lane holds: C1's 8 at the bench widths, and
    // C2's 16 in the f32 form (the bf16 form, in the 80 registers three blocks
    // an SM leave a thread, walks a row twice for C2's 16)
    constexpr int QMAX = 8;
    constexpr int SIGN_QMAX = BF16 ? 8 : 16;

    // 0. the adjacency as bits, x, dpooled (rounded once: dh2 takes its
    // values or 0) and the weights, zero-padded
    if (N % 16 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15) == 0) {
        load_bits16(adj_g, N, L.words, bits);
    } else {
        tower::load_bits(adj_g, N, L.words, bits);
    }
    stage_x<BF16>(P, L.ldp, x_g, N, F, rows, L.kx, x_vec, tid, THREADS);
    for (int c = tid; c < L.c2p; c += THREADS) dp[c] = c < C2 ? tower::at_form<BF16>(dpooled[(size_t)g * C2 + c]) : 0.f;
    for (int u = tid; u < L.c2p * L.words; u += THREADS) sgn[u] = 0u;
    for (int i = tid; i < 32 * L.words; i += THREADS) {  // every lane of a warp reaches the ballot
        const uint32_t m = __ballot_sync(FULL, i < N && mask_g[i] != 0);
        if ((i & 31) == 0) mbits[i / 32] = m;
    }
#pragma unroll 4
    for (int idx = tid; idx < L.kx * L.c1p; idx += THREADS) {
        const int k = idx / L.c1p;
        const int c = idx - k * L.c1p;
        put(W1 + (size_t)k * L.ldw1 + c, k < F && c < C1 ? tower::at_form<BF16>(w1[(size_t)k * C1 + c]) : 0.f);
    }
#pragma unroll 4
    for (int idx = tid; idx < L.c1p * L.c2p; idx += THREADS) {
        const int k = idx / L.c2p;
        const int c = idx - k * L.c2p;
        put(W2 + (size_t)k * L.ldw2 + c, k < C1 && c < C2 ? tower::at_form<BF16>(w2[(size_t)k * C2 + c]) : 0.f);
    }
    __syncthreads();

    // 1. fcx = x w1 -> T
    const auto to_t = [&](int m, int n, float v) { put(T + (size_t)m * L.ldh + n, v); };
    tile_gemm<TILE_ROWS, false>(P, L.ldp, W1, L.ldw1, rows, L.c1p, tower::round4(F), to_t);
    __syncthreads();

    // 2. h1 = relu(A fcx) -> H
    aggregate<QMAX>(bits, L.words, T, L.ldh, N, rows, L.c1p / 4, [&](int i, int q, float4 a) {
        E* h = H + (size_t)i * L.ldh + 4 * q;
        put(h, fmaxf(a.x, 0.f));
        put(h + 1, fmaxf(a.y, 0.f));
        put(h + 2, fmaxf(a.z, 0.f));
        put(h + 3, fmaxf(a.w, 0.f));
    });
    __syncthreads();

    // 3. fcx2 = h1 w2 -> P
    const auto to_p = [&](int m, int n, float v) { put(P + (size_t)m * L.ldp + n, v); };
    tile_gemm<TILE_ROWS, false>(H, L.ldh, W2, L.ldw2, rows, L.c2p, tower::round4(C1), to_p);
    __syncthreads();

    // 4. the sign of h2 = relu(A fcx2) * mask, as bits: sgn[c][w] bit b <=>
    // h2[32 w + b][c] > 0 (sgn is zero from step 0)
    aggregate<SIGN_QMAX>(bits, L.words, P, L.ldp, N, N, L.c2p / 4, [&](int i, int q, float4 a) {
        const uint32_t bit = 1u << (i % 32);
        if ((mbits[i / 32] & bit) == 0) return;
        uint32_t* word = sgn + 4 * q * L.words + i / 32;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (tower::lane4(a, c) > 0.f) atomicOr(word + c * L.words, bit);
        }
    });
    __syncthreads();

    // 5. dfcx2 = A (dpooled * [h2 > 0]) = dpooled[c] * (the count of row i's
    // neighbours j with h2[j][c] > 0) -> P; a thread takes 8 channels of a row
    for (int item = tid; item < rows * (L.c2p / 8); item += THREADS) {
        const int i = item / (L.c2p / 8);
        const int c0 = 8 * (item - i * (L.c2p / 8));
        int count[8] = {};
        if (i < N) {
            for (int u = 0; u < L.words; ++u) {
                const uint32_t a = bits[i * L.words + u];
#pragma unroll
                for (int k = 0; k < 8; ++k) count[k] += __popc(a & sgn[(c0 + k) * L.words + u]);
            }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) put(P + (size_t)i * L.ldp + c0 + k, (float)count[k] * dp[c0 + k]);
    }
    __syncthreads();

    // 6. this graph's dw2 = h1^T dfcx2, and dh1 = (dfcx2 w2^T) * [h1 > 0] -> T
    // (its sum rounded in the bf16 form, so on the CUDA cores in the plain
    // version's order), side by side: dh1 on the first warps (as many as it
    // has tasks, one left over), dw2 on the rest
    const auto to_dw2 = [&](int m, int n, float v) {
        if (m < C1 && n < C2) dw2_g[(size_t)m * C2 + n] = v;
    };
    const auto to_dh1 = [&](int m, int n, float v) {
        put(T + (size_t)m * L.ldh + n, get(H + (size_t)m * L.ldh + n) > 0.f ? v : 0.f);
    };
    {
        const int split = min(tile_tasks(TILE_ROWS, rows, L.c1p), WARPS - 1);
        tile_gemm<TILE_ROWS, true>(P, L.ldp, W2, L.ldw2, rows, L.c1p, tower::round4(C2), to_dh1, 0, split);
        if constexpr (BF16) {
            node_mma(H, L.ldh, P, L.ldp, L.c1p, L.c2p, rows, to_dw2, split, WARPS - split);
        } else {
            node_gemm(H, L.ldh, P, L.ldp, C1, C2, N, to_dw2, split, WARPS - split);
        }
    }
    __syncthreads();

    // 7. dfcx1 = A dh1 -> H (h1 is dead); x again -> P (dfcx2 is dead), on
    // the warps the aggregate leaves idle (all, after it, when it takes all)
    {
        const int agg_warps = min(WARPS, (rows + 31) / 32);
        if (tid < 32 * agg_warps) {
            aggregate<QMAX>(bits, L.words, T, L.ldh, N, rows, L.c1p / 4, [&](int i, int q, float4 a) {
                E* h = H + (size_t)i * L.ldh + 4 * q;
                put(h, a.x);
                put(h + 1, a.y);
                put(h + 2, a.z);
                put(h + 3, a.w);
            });
        }
        if (agg_warps < WARPS) {
            const int t0 = 32 * agg_warps;
            if (tid >= t0) stage_x<BF16>(P, L.ldp, x_g, N, F, rows, L.kx, x_vec, tid - t0, THREADS - t0);
        } else {
            stage_x<BF16>(P, L.ldp, x_g, N, F, rows, L.kx, x_vec, tid, THREADS);
        }
    }
    __syncthreads();

    // 8. this graph's dw1 = x^T dfcx1
    const auto to_dw1 = [&](int m, int n, float v) {
        if (m < F && n < C1) part_g[(size_t)m * C1 + n] = v;
    };
    if constexpr (BF16) {
        node_mma(P, L.ldp, H, L.ldh, L.kx, L.c1p, rows, to_dw1);
    } else {
        node_gemm(P, L.ldp, H, L.ldh, F, C1, N, to_dw1);
    }
}

constexpr int SUM_COLS = 32;  // entries a block
constexpr int SUM_ROWS = 16;  // graph lanes a block
constexpr int SUM_LOADS = 8;  // loads in flight a thread

// out[e] = sum_g part[g][e]: lane r sums graphs r, r + 16, ... in order, then
// the 16 lane sums are added in order
__global__ void __launch_bounds__(SUM_COLS* SUM_ROWS) sum_partials(const float* __restrict__ part, float* __restrict__ out,
                                                                   int G, int E) {
    __shared__ float acc[SUM_ROWS][SUM_COLS + 1];
    const int col = threadIdx.x % SUM_COLS;
    const int row = threadIdx.x / SUM_COLS;
    const int e = blockIdx.x * SUM_COLS + col;
    float s = 0.f;
    if (e < E) {
        int g = row;
        for (; g + (SUM_LOADS - 1) * SUM_ROWS < G; g += SUM_LOADS * SUM_ROWS) {
            float t[SUM_LOADS];
#pragma unroll
            for (int k = 0; k < SUM_LOADS; ++k) t[k] = __ldg(part + (size_t)(g + k * SUM_ROWS) * E + e);
#pragma unroll
            for (int k = 0; k < SUM_LOADS; ++k) s += t[k];
        }
        for (; g < G; g += SUM_ROWS) s += __ldg(part + (size_t)g * E + e);
    }
    acc[row][col] = s;
    __syncthreads();
    if (row == 0 && e < E) {
        float t = 0.f;
        for (int r = 0; r < SUM_ROWS; ++r) t += acc[r][col];
        out[e] = t;
    }
}

}  // namespace backward

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
    const size_t smem = backward::plan(N, F, C1, C2, BF16 ? 2 : 4).bytes;
    cudaError_t e = prepare(backward::ginet_tower_bwd_graph<BF16>, smem);
    if (e != cudaSuccess) return e;
    // all of an SM's shared memory to the carveout, so that two (f32) or three
    // (bf16) blocks fit
    e = cudaFuncSetAttribute(backward::ginet_tower_bwd_graph<BF16>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) {
        (void)cudaGetLastError();
        return e;
    }
    backward::ginet_tower_bwd_graph<BF16><<<G, backward::THREADS, smem, stream>>>(
        (const int8_t*)adj, (const float*)x, (const uint8_t*)mask, (const float*)w1, (const float*)w2,
        (const float*)dpooled, (float*)part, N, F, C1, C2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int entries = F * C1 + C1 * C2;
    const int blocks = (entries + backward::SUM_COLS - 1) / backward::SUM_COLS;
    backward::sum_partials<<<blocks, backward::SUM_COLS * backward::SUM_ROWS, 0, stream>>>((const float*)part, (float*)out,
                                                                                         G, entries);
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
