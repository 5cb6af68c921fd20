// Block-sparse (BCSR) SpMM for Hopper (sm_90a), bound with ctypes from
// deeprank2_tpu_torch/ops/block_sparse.py.
//
// It replaces the TPU kernel of deeprank2_tpu/ops/block_sparse.py:
//   bcsr_spmm_kernel  <- _kernel_stream  (launched by _bcsr_spmm_tpu)
//
// It computes, in the transposed layout, for every destination row tile r
//   out[f, r*128 + i] = sum_k sum_c x[f, block_col[k]*128 + c] * blocks_t[k][c, i]
// over the nonzero blocks k of row tile r (tile_blocks[tile_ptr[r] ..
// tile_ptr[r+1]]), with x [F, ldx] and out [F, ldo] f32 and the blocks
// 128 x 128, stored transposed ([c][i]), of one of three element types:
// int8 0/1 (the unweighted adjacency), bf16 or f32 (sGAT's weighted one).
// Every weight enters the products at its exact f32 value, so the result is
// exact up to summation order whatever the block type.
//
// Two forms, by the type of x: f32, and the single-pass bf16 form of the
// JAX kernel (its non-split branch, compute_dtype=bfloat16), whose x the
// wrapper rounds to bf16 once and whose blocks are cast to bf16: exact for
// int8 and bf16 blocks, rounded to nearest even (in registers, as JAX's
// astype) for f32 ones. The kernel widens every bf16 exactly and sums in
// f32, so the bf16 form is the f32 form on rounded operands.
//
// What bounds it on an H100 SXM, per call at the 100k-node atomic graph
// (15,222 nonzero blocks, 3.27M directed edges): the nonzero blocks are
// read once (249 MB int8, 499 MB bf16, 997 MB f32) and x and out once each
// (12.8 MB at F=32; x 6.4 MB in the bf16 form), about 80 / 155 / 300 us at
// 3.35 TB/s; the edges need
// 2*F*nnz = 0.2 GFLOP, 3 us at 67 TFLOP/s. So the function is bound by
// bytes. This kernel does the dense product of every stored block on CUDA
// cores (2*128^2*F per block: 16 GFLOP at F=32, about 100x the work the
// 1.3 % fill needs); tensor cores or skipping zero entries are later work.
//
// Design (none of the TPU kernel's VMEM chunking, bf16 hi/lo split, slab sum
// or double-buffered flushes carry over: x^T is at most 28 MB and sits in
// global memory and L2): one thread block per (row tile, slice of FS = 32 or
// 64 features), FS/16 warps. The block walks its row tile's nonzero blocks
// in order; for each it stages the block (16, 32 or 64 KB) and the [128, FS]
// x slab in shared memory, then every thread accumulates a 4 (nodes) x 16
// (features) tile in registers: per source node c one load of the four
// block entries of its nodes (a 4-, 8- or 16-byte word) and four broadcast
// float4 loads of x feed 64 FMAs. The x slab is stored node-major with its
// 4-float groups XOR-swizzled by (c & 7), so both the transposing stores and
// the float4 loads are free of bank conflicts. Entries become floats
// exactly: 0/1 bytes through the 2^23 trick (one byte permute and one
// subtract, no int-to-float conversion, which runs at 1/8 of the FMA rate),
// bf16 by a 16-bit shift. Each row tile's sum runs in a fixed order and its
// output is written once: no atomics, no slabs, deterministic; row tiles
// with no block (padding) come out as exact zeros, and zero pad blocks are
// never read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using bf16::round_bf16;
using bf16::widen;

constexpr int B = 128;   // block edge: nodes per tile
constexpr int IPT = 4;   // output nodes per thread (four consecutive entries of a block row)
constexpr int FPT = 16;  // features per thread (one warp covers 16 features)

enum BlockType { INT8 = 0, BF16 = 1, F32 = 2 };

// The four entries of a block row that one lane reads (nodes 4*lane ..
// 4*lane + 3), as one word, and their exact f32 values.
template <typename T>
struct Entries;

template <>
struct Entries<int8_t> {
    using Word = uint32_t;
    // 0/1 byte j of w as a float: 0x4B0000bj is 2^23 + b exactly
    static __device__ __forceinline__ void to_float(Word w, float (&a)[IPT]) {
#pragma unroll
        for (int j = 0; j < IPT; ++j) a[j] = __int_as_float((int)__byte_perm(w, 0x4B000000u, 0x7650u | j)) - 8388608.f;
    }
};

template <>
struct Entries<uint16_t> {  // bf16, as its bit patterns
    using Word = uint2;
    // a bf16 is the top half of the f32 of the same value
    static __device__ __forceinline__ void to_float(Word w, float (&a)[IPT]) {
        a[0] = __uint_as_float(w.x << 16);
        a[1] = __uint_as_float(w.x & 0xFFFF0000u);
        a[2] = __uint_as_float(w.y << 16);
        a[3] = __uint_as_float(w.y & 0xFFFF0000u);
    }
};

template <>
struct Entries<float> {
    using Word = float4;
    static __device__ __forceinline__ void to_float(Word w, float (&a)[IPT]) {
        a[0] = w.x;
        a[1] = w.y;
        a[2] = w.z;
        a[3] = w.w;
    }
};

template <int FS>
__host__ __device__ constexpr int threads() {
    return FS / FPT * 32;
}

// the staged block and the x slab, both dynamic (no static arrays)
template <typename T, int FS>
__host__ __device__ constexpr size_t smem_bytes() {
    return (size_t)B * B * sizeof(T) + (size_t)B * FS * sizeof(float);
}

// T: the block entry type; X: the type of x (float, or bf16 bits: the bf16
// form, which rounds f32 block entries to bf16)
template <typename T, typename X, int FS>
__global__ void __launch_bounds__(threads<FS>()) bcsr_rows(const T* __restrict__ blocks,
                                                           const int* __restrict__ block_col,
                                                           const int* __restrict__ tile_ptr,
                                                           const int* __restrict__ tile_blocks,
                                                           const X* __restrict__ x, float* __restrict__ out, int F,
                                                           int ldx, int ldo) {
    using Word = typename Entries<T>::Word;
    constexpr bool ROUND = sizeof(X) == 2 && sizeof(T) == 4;
    constexpr int THREADS = threads<FS>();
    constexpr int BLOCK_UINT4 = B * B * (int)sizeof(T) / 16;
    extern __shared__ uint4 smem4[];
    const Word* blk = reinterpret_cast<const Word*>(smem4);  // [c][i/4]: entries i..i+3 of block row c
    float* xs = reinterpret_cast<float*>(smem4 + BLOCK_UINT4);  // [c][FS], 4-float groups swizzled by c & 7

    const int r = blockIdx.x;
    const int f0 = blockIdx.y * FS;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int fw = (tid >> 5) * FPT;  // this warp's first feature in the slice

    float acc[IPT][FPT];
#pragma unroll
    for (int j = 0; j < IPT; ++j)
#pragma unroll
        for (int q = 0; q < FPT; ++q) acc[j][q] = 0.f;

    const int t1 = tile_ptr[r + 1];
    for (int t = tile_ptr[r]; t < t1; ++t) {
        const int k = tile_blocks[t];
        const size_t col0 = (size_t)block_col[k] * B;
        const uint4* src = reinterpret_cast<const uint4*>(blocks + (size_t)k * B * B);
        __syncthreads();  // the previous block is consumed
        for (int idx = tid; idx < BLOCK_UINT4; idx += THREADS) smem4[idx] = src[idx];
        // lanes: 8 consecutive nodes (one 32-byte sector) x 4 features
        for (int idx = tid; idx < B * FS; idx += THREADS) {
            const int lo = idx & 7;
            const int a = (idx >> 3) & 3;
            const int rest = idx >> 5;
            const int c = (rest & (B / 8 - 1)) * 8 + lo;
            const int f = (rest / (B / 8)) * 4 + a;
            const int fg = f0 + f;
            xs[c * FS + (f ^ (lo << 2))] = fg < F ? widen(x[(size_t)fg * ldx + col0 + c]) : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int c = 0; c < B; ++c) {
            float av[IPT];
            Entries<T>::to_float(blk[c * (B / IPT) + lane], av);
            if (ROUND) {
#pragma unroll
                for (int j = 0; j < IPT; ++j) av[j] = round_bf16(av[j]);
            }
            const float* xr = xs + c * FS;
            const int s = (c & 7) << 2;
#pragma unroll
            for (int q = 0; q < FPT / 4; ++q) {
                const float4 v = *reinterpret_cast<const float4*>(xr + ((fw + 4 * q) ^ s));
#pragma unroll
                for (int j = 0; j < IPT; ++j) {
                    acc[j][4 * q + 0] = fmaf(av[j], v.x, acc[j][4 * q + 0]);
                    acc[j][4 * q + 1] = fmaf(av[j], v.y, acc[j][4 * q + 1]);
                    acc[j][4 * q + 2] = fmaf(av[j], v.z, acc[j][4 * q + 2]);
                    acc[j][4 * q + 3] = fmaf(av[j], v.w, acc[j][4 * q + 3]);
                }
            }
        }
    }

    // every lane writes its 4 consecutive nodes of each feature row as a float4
#pragma unroll
    for (int q = 0; q < FPT; ++q) {
        const int fg = f0 + fw + q;
        if (fg < F) {
            float4* dst = reinterpret_cast<float4*>(out + (size_t)fg * ldo + (size_t)r * B + IPT * lane);
            *dst = make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
        }
    }
}

template <typename T, typename X, int FS>
int launch(const void* blocks, const void* block_col, const void* tile_ptr, const void* tile_blocks, const void* x,
           void* out, int R, int F, int ldx, int ldo, void* stream) {
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    // all of the block's shared memory is dynamic: 32-48 KB for int8 blocks,
    // 48-64 KB for bf16 and 80-96 KB for f32 (the x slab is f32 in both
    // forms); above 48 KB the block must opt in, for every byte it uses
    constexpr size_t smem = smem_bytes<T, FS>();
    if (smem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(bcsr_rows<T, X, FS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            (void)cudaGetLastError();
            return (int)e;
        }
    }
    const dim3 grid((unsigned)R, (unsigned)((F + FS - 1) / FS));
    bcsr_rows<T, X, FS><<<grid, threads<FS>(), smem, (cudaStream_t)stream>>>(
        (const T*)blocks, (const int*)block_col, (const int*)tile_ptr, (const int*)tile_blocks, (const X*)x,
        (float*)out, F, ldx, ldo);
    return (int)cudaGetLastError();
}

template <typename T, typename X>
int launch_sliced(const void* blocks, const void* block_col, const void* tile_ptr, const void* tile_blocks,
                  const void* x, void* out, int R, int F, int ldx, int ldo, void* stream) {
    // one slice of 64 features when F > 32 (the blocks are read once per slice)
    return F > 32 ? launch<T, X, 64>(blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream)
                  : launch<T, X, 32>(blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream);
}

// the activation types, by their code in ops/diag_spmm.py (ACT_DTYPES)
enum ActType { ACT_F32 = 0, ACT_BF16 = 1 };

template <typename T>
int launch_typed(int xtype, const void* blocks, const void* block_col, const void* tile_ptr, const void* tile_blocks,
                 const void* x, void* out, int R, int F, int ldx, int ldo, void* stream) {
    switch (xtype) {
        case ACT_F32:
            return launch_sliced<T, float>(blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream);
        case ACT_BF16:
            return launch_sliced<T, uint16_t>(blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// blocks [NB, 128, 128] of type `dtype` (0 int8, 1 bf16, 2 f32); x [F, ldx]
// of type `xtype` (0 f32, 1 bf16: the bf16 form) and out [F, ldo] f32,
// contiguous and 16-byte aligned; ldo = R * 128
int bcsr_spmm_kernel(const void* blocks, int dtype, const void* block_col, const void* tile_ptr,
                     const void* tile_blocks, const void* x, int xtype, void* out, int R, int F, int ldx, int ldo,
                     void* stream) {
    if (R <= 0 || F <= 0 || ldo != R * B || ldx % B) return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case INT8:
            return launch_typed<int8_t>(xtype, blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream);
        case BF16:
            return launch_typed<uint16_t>(xtype, blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo,
                                          stream);
        case F32:
            return launch_typed<float>(xtype, blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
