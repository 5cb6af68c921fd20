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
// edge weights). Each entry enters the products at its exact value, so every
// type is exact up to summation order. Each kernel has two forms, by the type
// of the activations it reads (x, or g_pool for pool_bwd_kernel): f32, and
// the single-pass bf16 form of the JAX kernels (their split=False branch,
// compute_dtype=bfloat16), whose operand the wrapper rounds to bf16 once; the
// bf16 form takes int8 and bf16 adjacencies (exact in bf16), as the JAX
// kernel does, and sums in f32. The modes differ in u and the epilogue:
//   diag_kernel mode 0 (plain)           u = x   out = acc
//   diag_kernel mode 1 (relu_mask)       u = x   out = relu(acc) * mask
//   diag_kernel mode 2 (relu_mask_pool)  u = x   h = relu(acc) * mask;
//                                                sign = (h > 0) as uint8,
//                                                pooled[f, g] = sum_i h
//   pool_bwd_kernel                      u = sign ? g_pool[f, g] : 0,  out = acc
// The pooled layer's h is read back only for its sign (the backward), so
// mode 2 stores one byte per value instead of four.
//
// Two bodies. ops/diag_spmm.py:diag_body picks one by form and passes it in
// (never another at run time on failure): diag_mma for every form on an int8
// or bf16 adjacency, diag_aggregate for the f32 adjacency. diag_aggregate
// runs every form, diag_mma every form on an int8 or bf16 adjacency, so both
// stay checkable on each (and timed: chip_smoke.py's fma_body_calls,
// tools/diag_order.py).
//
// diag_mma: the per-graph product D [i, f] = A [i, j] x U [j, f] on the
// tensor cores, with warp-level mma.sync (bf16 operands, f32 sums). A is the
// adjacency, row-major in j (the `row` operand); U is the staged slab, read
// per feature along j (the `col` operand); neither is transposed in memory.
//   - The f32 form splits each f32 value of U exactly into three bf16
//     pieces: hi = x cut to its top 8 significant bits (bf16 toward zero),
//     mid = the same of x - hi, lo = x - hi - mid. 8 + 8 + 8 significant bits
//     cover f32's 24, so hi + mid + lo == x for every f32 (each remainder is
//     exact in f32). The cut is a mask and the remainders f32 subtractions,
//     so no conversion instruction runs (they issue at a quarter of the f32
//     rate or less). Each product of a piece with an int8 0/1 entry or a bf16
//     weight (8 bits by 8) is exact in f32. Two pieces (JAX's hi/lo split, up
//     to 2^-18 of each term left out) miss the f32 gate, rtol = atol = 1e-5,
//     once the sum of |terms| passes a few units.
//   - The tensor cores do not round their f32 sums to nearest: an mma adds
//     its products to the accumulator at the largest one's scale and drops
//     the bits below (3 x N/16 passes into one accumulator left sGAT's
//     weights off the f32 gate on an H100). So each 16-column window's hi
//     products sum in a fresh fragment, which limits the truncation to that
//     window: its sum is off the exact one by at most about 2^-23 of its
//     largest product, an f32 rounding's size. The window sums join the
//     running sum with f32 adds, rounded to nearest; the mid and lo pieces of
//     a 32-column step (2^-8 of the terms and less) sum into a fresh fragment
//     of their own, smallest first, joined the same way. So the f32 form is
//     its function up to f32 rounding, in another order than ascending j.
//   - The bf16 forms take one pass: their values are bf16 already.
//   - pool_bwd_kernel is a count product: u[f, j] = sign[f, j] * gp[f, g],
//     so out[f, i] = gp[f, g] * sum_j A[i, j] sign[f, j]. On an int8
//     adjacency the count is exact in one s8 pass (m16n8k32, s32 sums), and
//     the epilogue adds gp that many times in f32 (times the count where it
//     is negative), which on a 0/1 adjacency is the ascending f32 sum over
//     the row bit for bit (a product rounded once differs by an ulp, the
//     same way at every node of a graph, which moved a weight gradient that
//     cancels over the batch off the gate against the fused tower). On a
//     bf16 adjacency: one bf16 pass of w x sign (exact products, f32 sums),
//     scaled by gp.
// One block of 4 warps per (graph, 32 features), the feature chunk the
// fastest index of the grid, so a graph's chunks run side by side and the
// second read of its adjacency comes from L2. The block stages its graph's
// [N, 32] slab of u in shared memory as f32, feature-major (16-byte loads and
// stores; zeros past N up to a whole step), in no more bytes than
// the FMA body's node-major slab at the largest N, so both bodies run the
// same largest N. Its warps then take tasks of 32 output nodes x 16 features
// (two m16 x two n8 tiles) in turn, walking j in steps of 32: each thread
// loads its adjacency words straight from device memory into registers (the
// next step's while this one computes; the largest N leaves no shared memory
// for an adjacency ring) and its U values from the slab, one 16-byte load of
// 4 consecutive nodes a tile, split into pieces in registers. An int8 entry
// becomes a bf16 without a conversion instruction: a multiply where all the
// step's entries are 0/1, an exponent trick for any other int8. Rows past N
// are zeros; the ragged F tail is masked at the store, and a feature half
// with no feature < F is skipped. The pooled sums run over the fragment rows
// with shuffles, then over the warps through shared memory, in a fixed
// order: no atomics, every result deterministic.
//
// diag_aggregate: the dense product as f32 FMAs on CUDA cores, each output
// summed in ascending j, one rounding a term: the fused tower's order
// (csrc/diag_tower.cu). It runs the f32 adjacency, which no path launches
// (JAX never sends an f32 adjacency to its kernel). K1's f32 form on an int8
// adjacency ran here until its weight gradients were held to float64 at a
// per-entry bound (deeprank2_tpu_torch/tools/f64_gate.py) in place of a
// fixed atol between two summation orders: on the tensor cores that form
// runs about twice as fast, and is as near float64 as this body. One
// block per (graph, 32 features), its slab node-major; it walks the output
// nodes in tiles of 32 (lane = output node, warp = 8 features), streaming
// the adjacency through shared memory in 32 x 32 tiles, transposed so that a
// warp reads 32 consecutive entries; each adjacency value, widened in a
// register, feeds 8 FMAs.
//
// What bounds them on an H100 SXM, per call at the bench shape (G=512, N=160,
// F=32 or 64): the adjacency is read once (13.1 MB int8), one [F, G*N] f32
// slab is read and one written (10.5 or 21 MB each), 34-55 MB in all, about
// 10-16 us at 3.35 TB/s. The dense product is 2*F*N^2*G = 0.84 or 1.68
// GFLOP a pass: 12.5-25 us at the 67 TFLOP/s f32 CUDA-core peak (the FMA
// body is bound by operations), 0.85-1.7 us a pass at the 989 TFLOP/s bf16
// tensor-core peak. The tensor-core body is bound by neither: on an H100 its
// time goes to the integer and f32 work of building fragments (the split,
// the int8 entries, the fresh-fragment sums), which the products wait on
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int FC = 32;          // features per block
constexpr int THREADS = 128;    // four warps
constexpr int WARPS = THREADS / 32;
constexpr int XS = FC + 4;      // slab row stride in floats: float4-aligned, spreads the staging stores over banks

// the FMA body
constexpr int TI = 32;          // output nodes per row tile (one per lane)
constexpr int TJ = 32;          // adjacency columns per staged tile
constexpr int FPW = 8;          // features per warp

// the tensor-core body
constexpr int WM = 32;          // output nodes of a warp task: two m16 tiles
constexpr int WN = 16;          // features of a warp task: two n8 tiles
constexpr int KC = 32;          // adjacency columns a step: two k16 products, or one k32

enum Mode { PLAIN = 0, RELU_MASK = 1, RELU_MASK_POOL = 2, POOL_BWD = 3 };
// a bf16 adjacency is handled as its bit patterns (uint16_t): a bf16 is the
// top half of the f32 of the same value
enum AdjType { INT8 = 0, BF16 = 1, F32 = 2 };

// row stride of the FMA body's adjacency tile in entries: int8 rows unpadded
// (32 bytes), bf16 and f32 rows one 32-bit word longer, so that the
// transposing stores of consecutive threads land in different banks
template <typename T>
__host__ __device__ constexpr int tile_row() {
    return sizeof(T) == 1 ? TI : TI + 4 / (int)sizeof(T);
}

// the static shared memory a block of either body may hold beside its slab:
// the FMA body's adjacency tile. The tensor-core body holds less (its pooled
// partial sums) and is held to the same budget, so a form's largest N is
// the same whichever body runs it.
template <typename T>
__host__ __device__ constexpr size_t static_smem() {
    return sizeof(T) * TJ * tile_row<T>();
}
static_assert(sizeof(float) * WARPS * WN <= static_smem<int8_t>(), "the pooled partials exceed the int8 budget");

__device__ __forceinline__ float as_float(int8_t a) { return (float)a; }
__device__ __forceinline__ float as_float(uint16_t a) { return __uint_as_float((uint32_t)a << 16); }  // bf16 bits
__device__ __forceinline__ float as_float(float a) { return a; }

// stages graph g's [N, 32] slab of u (features f0..f0+31; 0 past F)
// node-major, for the FMA body
template <int MODE, typename X>
__device__ __forceinline__ void stage_slab(float* slab, const X* __restrict__ x, const uint8_t* __restrict__ sign_in,
                                           const X* __restrict__ g_pool, int g, int f0, int G, int N, int F) {
    const size_t gn = (size_t)G * N;
    const size_t base = (size_t)g * N;
    for (int idx = threadIdx.x; idx < FC * N; idx += THREADS) {
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
}

// ---------------------------------------------------------------------------
// The FMA body (every form)

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

    stage_slab<MODE>(slab, x, sign_in, g_pool, g, f0, G, N, F);

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

// ---------------------------------------------------------------------------
// The tensor-core body (int8 and bf16 adjacencies)
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16 and mma.m16n8k32 .s8), for lane =
// 4 * gid + tig: the accumulator holds rows gid and gid + 8, columns 2 tig
// and 2 tig + 1. A step covers 32 adjacency columns from j0; of them, a
// thread reads the 4 columns jb .. jb + 3 of its rows, jb = j0 + 16 h + 4 tig,
// for the k16 product h (0, 1): one word. Its k slots {2 tig, 2 tig + 1}
// take columns jb, jb + 1, its slots {2 tig + 8, 2 tig + 9} columns jb + 2,
// jb + 3; the k32 product of the count gives slot k to column j0 + k. A and U
// follow the same map, so the product is unchanged, and a thread's U values
// are 4 consecutive nodes of one feature: one 16-byte load from the slab.

// the mma body's slab: feature-major [FC][S] f32, S = the staged columns
// (N rounded up to the step, zeros past N) + 16, so that the 16-byte loads of
// 8 lanes (two features x four words) hit 32 banks. It takes no more shared
// memory than the FMA body's [N][XS] from N = 376 on, so the largest N is
// the same; the block asks for the larger of the two.
__host__ __device__ constexpr int slab_stride(int N) { return (N + KC - 1) / KC * KC + 16; }
__host__ __device__ constexpr size_t mma_slab_bytes(int N) {
    return sizeof(float) * ((size_t)N * XS > (size_t)FC * slab_stride(N) ? (size_t)N * XS : (size_t)FC * slab_stride(N));
}

// stages graph g's [N, 32] slab of u (features f0..f0+31; 0 past F and past
// N) feature-major: each warp load reads 128
// consecutive nodes of one feature (VEC: N % 4 == 0 and the operands
// aligned, 4 a lane) or 32 (one a lane), and a thread keeps 8 loads in flight
__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 v) {
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u), __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
}

template <int MODE, bool VEC, typename X>
__device__ __forceinline__ void stage_rows(float* slab, const X* __restrict__ x, const uint8_t* __restrict__ sign_in,
                                           const X* __restrict__ g_pool, int g, int f0, int G, int N, int F) {
    constexpr int FW = FC / WARPS;  // features a warp stages: warp, warp + WARPS, ...
    const int S = slab_stride(N);
    const int J = (N + KC - 1) / KC * KC;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const size_t gn = (size_t)G * N;
    const size_t base = (size_t)g * N;
    float gp[FW];
    size_t row[FW];
#pragma unroll
    for (int k = 0; k < FW; ++k) {
        const int f = f0 + warp + WARPS * k;
        row[k] = (size_t)(f < F ? f : 0) * gn + base;
        gp[k] = MODE == POOL_BWD && f < F ? as_float(g_pool[(size_t)f * G + g]) : 0.f;
    }
    if constexpr (VEC) {
        using V = std::conditional_t<sizeof(X) == 4, float4, uint2>;
        for (int j = 4 * lane; j < J; j += 128) {
            float4 v[FW];
#pragma unroll
            for (int k = 0; k < FW; ++k) {
                v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
                if (f0 + warp + WARPS * k < F && j < N) {
                    if constexpr (MODE == POOL_BWD) {
                        const uint32_t sg = __ldg(reinterpret_cast<const unsigned int*>(sign_in + row[k] + j));
                        v[k] = make_float4(sg & 0xffu ? gp[k] : 0.f, sg & 0xff00u ? gp[k] : 0.f,
                                           sg & 0xff0000u ? gp[k] : 0.f, sg & 0xff000000u ? gp[k] : 0.f);
                    } else {
                        v[k] = widen4(__ldg(reinterpret_cast<const V*>(x + row[k] + j)));
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < FW; ++k) *reinterpret_cast<float4*>(slab + (warp + WARPS * k) * S + j) = v[k];
        }
    } else {
        for (int j = lane; j < J; j += 32) {
            float v[FW];
#pragma unroll
            for (int k = 0; k < FW; ++k) {
                v[k] = 0.f;
                if (f0 + warp + WARPS * k < F && j < N) {
                    const size_t off = row[k] + j;
                    v[k] = MODE == POOL_BWD ? (sign_in[off] ? gp[k] : 0.f) : as_float(x[off]);
                }
            }
#pragma unroll
            for (int k = 0; k < FW; ++k) slab[(warp + WARPS * k) * S + j] = v[k];
        }
    }
}

// two bf16 values held as f32 (the top halves of their bits) in one bf16x2
// register, `lo` in the low half (the smaller k slot)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// d += a * b: bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b into a fresh fragment: bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a * b: s8 operands, s32 sums (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One word of entries per (row q, product h): 4 int8 entries, or 4 bf16
// entries in two words. Rows are r0 + gid + 8 q; the words start at column
// j0 + 16 h + 4 tig. Entries past N are 0. VEC: N % 4 == 0 and the
// operands aligned, so a group of 4 is all in or all out, and one load.
template <typename T>
struct AWords {
    uint32_t w[4][2][sizeof(T)];
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_a(AWords<T>& a, const T* __restrict__ adj_g, int r0, int j0, int N, int gid,
                                       int tig) {
    int ro[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int i = r0 + gid + 8 * q;
        ro[q] = i < N ? i * N : -1;  // i * N < 2^31: N <= 1607 (diag_max_nodes)
    }
    const int c0 = j0 + 4 * tig;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const T* row = adj_g + ro[q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = c0 + 16 * h;
            if constexpr (VEC) {
                const bool in = ro[q] >= 0 && c < N;
                if constexpr (sizeof(T) == 1) {
                    a.w[q][h][0] = in ? __ldg(reinterpret_cast<const unsigned int*>(row + c)) : 0u;
                } else {
                    const uint2 v = in ? __ldg(reinterpret_cast<const uint2*>(row + c)) : make_uint2(0u, 0u);
                    a.w[q][h][0] = v.x;
                    a.w[q][h][1] = v.y;
                }
            } else {
#pragma unroll
                for (int k = 0; k < (int)sizeof(T); ++k) a.w[q][h][k] = 0u;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (ro[q] >= 0 && c + e < N) {
                        if constexpr (sizeof(T) == 1) {
                            a.w[q][h][0] |= (uint32_t)(uint8_t)__ldg(reinterpret_cast<const signed char*>(row + c + e)) << (8 * e);
                        } else {
                            a.w[q][h][e >> 1] |=
                                (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(row + c + e)) << (16 * (e & 1));
                        }
                    }
                }
            }
        }
    }
}

// the bf16 A fragments [m16 tile] of the k16 product h of a step. An int8
// entry b becomes a bf16 without a conversion instruction: b * 0x3F80 where
// every entry of the warp's step is 0 or 1 (BINARY, the unweighted graphs);
// else the f32 bits 0x4B0000uu, u = b + 128, are 2^23 + u, less 2^23 + 128
// (exact), and the bf16 is their top half.
template <typename T, bool BINARY>
__device__ __forceinline__ void bf16_fragments(uint32_t (&a)[2][4], const AWords<T>& w, int h) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows gid, gid + 8: registers r and r + 2
            const uint32_t* wd = w.w[2 * mt + r][h];
            if constexpr (sizeof(T) == 2) {
                a[mt][r] = wd[0];
                a[mt][r + 2] = wd[1];
            } else if constexpr (BINARY) {
                a[mt][r] = __byte_perm(wd[0], 0u, 0x4140) * 0x3F80u;
                a[mt][r + 2] = __byte_perm(wd[0], 0u, 0x4342) * 0x3F80u;
            } else {
                const uint32_t u = wd[0] ^ 0x80808080u;
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | e)) - 8388736.f;
                a[mt][r] = pack_bf16x2(v[0], v[1]);
                a[mt][r + 2] = pack_bf16x2(v[2], v[3]);
            }
        }
    }
}

// x0, x1 (f32) as PASSES bf16x2 pieces whose sum is exact: hi, mid, lo.
// Each piece is its value's top 8 significant bits, cut off by a mask (the
// remainder x - piece is exact in f32): 8 + 8 + 8 bits hold f32's 24, and no
// conversion instruction runs (they issue at a quarter of the f32 rate or
// less). One piece of a bf16 value is the value itself.
template <int PASSES>
__device__ __forceinline__ void split_pair(uint32_t (&p)[PASSES], float x0, float x1) {
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
        p[k] = pack_bf16x2(x0, x1);
        if (k + 1 < PASSES) {
            x0 -= __uint_as_float(__float_as_uint(x0) & 0xffff0000u);
            x1 -= __uint_as_float(__float_as_uint(x1) & 0xffff0000u);
        }
    }
}

// 0/1 (u != 0) of four slab values, as s8 in one word
__device__ __forceinline__ uint32_t nonzero_bytes(float4 v) {
    return (uint32_t)(v.x != 0.f) | (uint32_t)(v.y != 0.f) << 8 | (uint32_t)(v.z != 0.f) << 16 |
           (uint32_t)(v.w != 0.f) << 24;
}

// 0/1 (u != 0) of two slab values, as bf16 in one register
__device__ __forceinline__ uint32_t nonzero_bf16x2(float lo, float hi) {
    return (lo != 0.f ? 0x3F80u : 0u) | (hi != 0.f ? 0x3F800000u : 0u);
}

// one step of 32 adjacency columns from j0 into the task's accumulators;
// `u`: the lane's slab row (feature fh + gid) at column 4 tig
template <int MODE, typename T, int PASSES, bool BINARY, typename Acc>
__device__ __forceinline__ void mma_step(Acc (&acc)[2][2][4], const AWords<T>& w, const float* u, int S, int j0) {
    const auto load_u = [&](int nt, int col) { return *reinterpret_cast<const float4*>(u + nt * 8 * S + col); };
    if constexpr (std::is_same<Acc, int>::value) {
        // the count product: sum_j A[i, j] [u[f, j] != 0], one k32 pass
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            a[mt][0] = w.w[2 * mt][0][0];
            a[mt][1] = w.w[2 * mt + 1][0][0];
            a[mt][2] = w.w[2 * mt][1][0];
            a[mt][3] = w.w[2 * mt + 1][1][0];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const uint32_t b0 = nonzero_bytes(load_u(nt, j0)), b1 = nonzero_bytes(load_u(nt, j0 + 16));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
        }
    } else {
        // The tensor cores do not round their f32 sums to nearest (see the
        // header): each k16 window's hi products go into a fresh fragment,
        // where their sum is exact, and join the running sum with an f32 add,
        // rounded to nearest; the smaller pieces (mid, lo), 2^-8 of the terms
        // and less, sum into a fresh fragment of the step, smallest first,
        // joined the same way.
        float d[2][2][4] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            uint32_t a[2][4];
            bf16_fragments<T, BINARY>(a, w, h);
            uint32_t b[2][PASSES][2];  // [n8 tile][piece][register]
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const float4 v = load_u(nt, j0 + 16 * h);
                uint32_t b0[PASSES], b1[PASSES];
                if (MODE == POOL_BWD) {
                    // w x sign on a bf16 adjacency: sign as bf16 0/1
                    b0[0] = nonzero_bf16x2(v.x, v.y);
                    b1[0] = nonzero_bf16x2(v.z, v.w);
                } else {
                    split_pair<PASSES>(b0, v.x, v.y);
                    split_pair<PASSES>(b1, v.z, v.w);
                }
#pragma unroll
                for (int p = 0; p < PASSES; ++p) {
                    b[nt][p][0] = b0[p];
                    b[nt][p][1] = b1[p];
                }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                    for (int p = PASSES - 1; p >= 1; --p) mma_bf16(d[mt][nt], a[mt], b[nt][p][0], b[nt][p][1]);
                    float e[4];
                    mma_bf16_fresh(e, a[mt], b[nt][0][0], b[nt][0][1]);
#pragma unroll
                    for (int k = 0; k < 4; ++k) acc[mt][nt][k] += e[k];
                }
            }
        }
        if constexpr (PASSES > 1) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[mt][nt][e];
        }
    }
}

// T: the adjacency's entry type (int8_t, or uint16_t bf16 bits); X: the
// activations' (float, or bf16 bits)
template <int MODE, typename T, typename X, bool VEC>
__global__ void __launch_bounds__(THREADS, 4) diag_mma(
    const T* __restrict__ adj, const X* __restrict__ x, const uint8_t* __restrict__ sign_in,
    const X* __restrict__ g_pool, const uint8_t* __restrict__ mask, float* __restrict__ out,
    uint8_t* __restrict__ sign_out, float* __restrict__ pooled, int G, int N, int F) {
    // K2 on an int8 adjacency: an exact s8 count product
    constexpr bool COUNT = MODE == POOL_BWD && sizeof(T) == 1;
    // three bf16 pieces of an f32 value, one of a bf16 value or a sign
    constexpr int PASSES = (MODE == POOL_BWD || sizeof(X) == 2) ? 1 : 3;
    using Acc = std::conditional_t<COUNT, int, float>;

    extern __shared__ float4 slab4[];
    float* slab = reinterpret_cast<float*>(slab4);  // [FC][S], u of this graph and feature chunk
    __shared__ float part[WARPS][WN];               // each warp's pooled sums (mode 2)

    const int chunks = (F + FC - 1) / FC;
    const int g = blockIdx.x / chunks;
    const int f0 = (blockIdx.x - g * chunks) * FC;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const size_t gn = (size_t)G * N;
    const size_t base = (size_t)g * N;
    const T* adj_g = adj + base * N;

    // the feature halves of the chunk that hold a feature < F (1 or 2); warp
    // w's tasks all lie in half w % halves
    const int halves = F - f0 > WN ? 2 : 1;
    const int tasks = (N + WM - 1) / WM * halves;
    float psum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    const int S = slab_stride(N);

    // the warp walks its tasks' steps in order, with the adjacency words of
    // its next step in flight, from one task into the next (a deeper ring
    // measured no faster: the step's own work is what it waits on). (lt, lj):
    // the task and first column of the next step to load.
    const int hs = halves - 1;  // t >> hs: the task's row tile; t & hs: its feature half
    int lt = warp, lj = 0;
    const auto load_next = [&](AWords<T>& a) {
        if (lt < tasks) load_a<T, VEC>(a, adj_g, (lt >> hs) * WM, lj, N, gid, tig);
        lj += KC;
        if (lj >= N) {
            lj = 0;
            lt += WARPS;
        }
    };
    AWords<T> w;
    load_next(w);  // in flight while the slab is staged
    stage_rows<MODE, VEC>(slab, x, sign_in, g_pool, g, f0, G, N, F);
    __syncthreads();
    for (int t = warp; t < tasks; t += WARPS) {
        const int r0 = (t >> hs) * WM;
        const int fh = (t & hs) * WN;
        const float* u = slab + (fh + gid) * S + 4 * tig;
        Acc acc[2][2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][e] = Acc(0);
        for (int j0 = 0; j0 < N; j0 += KC) {
            const AWords<T> cur = w;
            load_next(w);
            if constexpr (sizeof(T) == 1 && !COUNT) {
                uint32_t any = 0;  // a bit past 0/1 in any entry
#pragma unroll
                for (int q = 0; q < 4; ++q) any |= (cur.w[q][0][0] | cur.w[q][1][0]) & 0xFEFEFEFEu;
                if (__all_sync(0xffffffffu, any == 0)) {
                    mma_step<MODE, T, PASSES, true>(acc, cur, u, S, j0);
                } else {
                    mma_step<MODE, T, PASSES, false>(acc, cur, u, S, j0);
                }
            } else {
                mma_step<MODE, T, PASSES, false>(acc, cur, u, S, j0);
            }
        }

        // the epilogue, on the accumulator fragments
        float gp[2][2];
        if (MODE == POOL_BWD) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int f = f0 + fh + nt * 8 + 2 * tig + c;
                    gp[nt][c] = f < F ? as_float(g_pool[(size_t)f * G + g]) : 0.f;
                }
        }
        // K2 on an int8 adjacency: gp added count times in f32, as a sum over
        // the row does it (the plain version, the FMA body, the fused tower's
        // backward), for all 16 outputs of the lane in step: bit for bit on a
        // 0/1 adjacency, where a product rounded once would differ by an ulp
        // the same way at every node of a graph
        float seq[2][2][4];
        if constexpr (COUNT) {
            int most = 0;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        seq[mt][nt][e] = 0.f;
                        most = max(most, (int)acc[mt][nt][e]);
                    }
            for (int k = 0; k < most; ++k) {
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) seq[mt][nt][e] += k < (int)acc[mt][nt][e] ? gp[nt][e & 1] : 0.f;
            }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int i = r0 + 16 * mt + gid + 8 * r;
                if (i >= N) continue;
                const bool masked = MODE == RELU_MASK || MODE == RELU_MASK_POOL;
                const float m = masked ? (mask[base + i] ? 1.f : 0.f) : 1.f;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int f = f0 + fh + nt * 8 + 2 * tig + c;
                        if (f >= F) continue;
                        const size_t off = (size_t)f * gn + base + i;
                        const Acc v = acc[mt][nt][2 * r + c];
                        if (MODE == PLAIN) {
                            out[off] = v;
                        } else if (MODE == POOL_BWD) {
                            if constexpr (COUNT) {
                                out[off] = v >= 0 ? seq[mt][nt][2 * r + c] : gp[nt][c] * (float)v;
                            } else {
                                out[off] = gp[nt][c] * v;
                            }
                        } else {
                            const float h = fmaxf((float)v, 0.f) * m;
                            if (MODE == RELU_MASK) {
                                out[off] = h;
                            } else {
                                sign_out[off] = h > 0.f ? 1 : 0;
                                psum[nt][c] += h;
                            }
                        }
                    }
                }
            }
        }
    }

    if (MODE == RELU_MASK_POOL) {
        // over the 8 rows of each fragment (lane bits 2-4), then over the
        // warps of each feature half, in warp order
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float s = psum[nt][c];
                for (int d = 4; d < 32; d <<= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
                if (gid == 0) part[warp][nt * 8 + 2 * tig + c] = s;
            }
        __syncthreads();
        const int fl = threadIdx.x;
        if (fl < FC && fl / WN < halves && f0 + fl < F) {
            float s = 0.f;
            for (int w = fl / WN; w < WARPS; w += halves) s += part[w][fl % WN];
            pooled[(size_t)(f0 + fl) * G + g] = s;
        }
    }
}

// ---------------------------------------------------------------------------
// Launch

// opts `kernel` into `smem` bytes of dynamic shared memory where it needs
// it; an error where `smem` and the `reserved` static bytes pass the
// device's per-block limit (the wrapper raises)
template <typename K>
cudaError_t fit_smem(K* kernel, size_t smem, size_t reserved) {
    if (smem + reserved <= 48 * 1024) return cudaSuccess;
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess && smem + reserved > (size_t)optin) e = cudaErrorInvalidValue;
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) (void)cudaGetLastError();  // not sticky: clear it so later launches are not blamed
    return e;
}

template <typename T, typename X>
using Kernel = void (*)(const T*, const X*, const uint8_t*, const X*, const uint8_t*, float*, uint8_t*, float*, int, int,
                        int);

template <typename T, typename X>
int start(Kernel<T, X> kernel, dim3 grid, size_t smem, const void* adj, const void* x, const void* sign_in,
          const void* g_pool, const void* mask, void* out, void* sign_out, void* pooled, int G, int N, int F,
          void* stream) {
    const cudaError_t e = fit_smem(kernel, smem, static_smem<T>());
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>((const T*)adj, (const X*)x, (const uint8_t*)sign_in,
                                                           (const X*)g_pool, (const uint8_t*)mask, (float*)out,
                                                           (uint8_t*)sign_out, (float*)pooled, G, N, F);
    return (int)cudaGetLastError();
}

// the bodies, by their code in ops/diag_spmm.py (BODIES), which picks one
// by form (diag_body)
enum Body { MMA = 0, FMA = 1 };

template <int MODE, typename T, typename X>
int launch(int body, const void* adj, const void* x, const void* sign_in, const void* g_pool, const void* mask, void* out,
           void* sign_out, void* pooled, int G, int N, int F, void* stream) {
    if (G <= 0 || N <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    const int chunks = (F + FC - 1) / FC;
    if (body == FMA) {
        const size_t smem = (size_t)N * XS * sizeof(float);
        return start<T, X>(diag_aggregate<MODE, T, X>, dim3((unsigned)G, (unsigned)chunks), smem, adj, x, sign_in,
                           g_pool, mask, out, sign_out, pooled, G, N, F, stream);
    }
    if (body != MMA) return (int)cudaErrorInvalidValue;
    if constexpr (std::is_same<T, float>::value) {
        return (int)cudaErrorInvalidValue;  // no tensor-core body for an f32 adjacency
    } else {
        // the feature chunk is the fastest index of the grid
        if ((long long)G * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        const auto aligned = [](const void* p, size_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; };
        const bool vec = N % 4 == 0 && aligned(adj, 4 * sizeof(T)) &&
                         (MODE == POOL_BWD ? aligned(sign_in, 4) : aligned(x, 4 * sizeof(X)));
        return start<T, X>(vec ? diag_mma<MODE, T, X, true> : diag_mma<MODE, T, X, false>, dim3((unsigned)(G * chunks)),
                           mma_slab_bytes(N), adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
    }
}

// the activation types, by their code in ops/diag_spmm.py (ACT_DTYPES)
enum ActType { ACT_F32 = 0, ACT_BF16 = 1 };

template <int MODE>
int launch_typed(int dtype, int xtype, int body, const void* adj, const void* x, const void* sign_in, const void* g_pool,
                 const void* mask, void* out, void* sign_out, void* pooled, int G, int N, int F, void* stream) {
    if (xtype == ACT_BF16) {
        // the bf16 form: int8 and bf16 adjacencies only
        switch (dtype) {
            case INT8:
                return launch<MODE, int8_t, uint16_t>(body, adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
            case BF16:
                return launch<MODE, uint16_t, uint16_t>(body, adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F,
                                                        stream);
            default:
                return (int)cudaErrorInvalidValue;
        }
    }
    if (xtype != ACT_F32) return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case INT8:
            return launch<MODE, int8_t, float>(body, adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
        case BF16:
            return launch<MODE, uint16_t, float>(body, adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
        case F32:
            return launch<MODE, float, float>(body, adj, x, sign_in, g_pool, mask, out, sign_out, pooled, G, N, F, stream);
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
// (mask, out), 2 relu_mask_pool (mask, sign, pooled); out and pooled f32;
// `body` 0 tensor cores (int8 and bf16 adjacencies), 1 FMAs (every form)
int diag_kernel(const void* adj, int dtype, const void* x, int xtype, const void* mask, void* out, void* sign,
                void* pooled, int G, int N, int F, int mode, int body, void* stream) {
    switch (mode) {
        case PLAIN:
            return launch_typed<PLAIN>(dtype, xtype, body, adj, x, nullptr, nullptr, nullptr, out, nullptr, nullptr, G, N,
                                       F, stream);
        case RELU_MASK:
            return launch_typed<RELU_MASK>(dtype, xtype, body, adj, x, nullptr, nullptr, mask, out, nullptr, nullptr, G, N,
                                           F, stream);
        case RELU_MASK_POOL:
            return launch_typed<RELU_MASK_POOL>(dtype, xtype, body, adj, x, nullptr, nullptr, mask, nullptr, sign, pooled,
                                                G, N, F, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// g_pool [F, G] of type `gtype` (0 f32, 1 bf16: the bf16 form); out f32;
// `body` as for diag_kernel
int pool_bwd_kernel(const void* adj, int dtype, const void* sign, const void* g_pool, int gtype, void* out, int G,
                    int N, int F, int body, void* stream) {
    return launch_typed<POOL_BWD>(dtype, gtype, body, adj, nullptr, sign, g_pool, nullptr, out, nullptr, nullptr, G, N, F,
                                  stream);
}

// the largest N the current device runs in the form (adjacency `dtype`,
// activation `xtype`): its shared memory per block with the opt-in, less the
// static budget, over one node's staged features (f32 in both forms and
// both bodies); -1 on a CUDA error or a form that does not exist
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
