// Block-sparse (BCSR) SpMM for Hopper (sm_90a), bound with ctypes from
// deeprank2_tpu_torch/ops/block_sparse.py.
//
// It replaces the TPU kernel of deeprank2_tpu/ops/block_sparse.py:
//   bcsr_spmm_kernel  <- _kernel_stream  (launched by _bcsr_spmm_tpu)
//
// It computes, in the transposed layout, for every destination row tile r
//   out[f, r*128 + i] = sum_k sum_c x[f, block_col[k]*128 + c] * blocks_t[k][c, i]
// over the nonzero blocks k of row tile r (tile_blocks[tile_ptr[r] ..
// tile_ptr[r+1]]), with x [F, ldx] and out [F, ldo] f32 and the blocks int8
// 0/1, 128 x 128, stored transposed ([c][i]).
//
// What bounds it on an H100 SXM, per call at the 100k-node atomic graph
// (15,222 nonzero blocks, 3.27M directed edges): the nonzero blocks are
// read once (249 MB int8) and x and out once each (12.8 MB at F=32), about
// 80 us at 3.35 TB/s; the edges need 2*F*nnz = 0.2 GFLOP, 3 us at 67 TFLOP/s.
// So the function is bound by bytes. This kernel does the dense product of
// every stored block on CUDA cores (2*128^2*F per block: 16 GFLOP at F=32,
// about 100x the work the 1.3 % fill needs), exact up to summation order;
// tensor cores or skipping zero entries are later work.
//
// Design (none of the TPU kernel's VMEM chunking, bf16 hi/lo split, slab sum
// or double-buffered flushes carry over: x^T is at most 28 MB and sits in
// global memory and L2): one thread block per (row tile, slice of FS = 32 or
// 64 features), FS/16 warps. The block walks its row tile's nonzero blocks
// in order; for each it stages the int8 block (16 KB) and the [128, FS] x
// slab in shared memory, then every thread accumulates a 4 (nodes) x 16
// (features) tile in registers: per source node c one 32-bit load of four
// block bytes and four broadcast float4 loads of x feed 64 FMAs. The x slab
// is stored node-major with its 4-float groups XOR-swizzled by (c & 7), so
// both the transposing stores and the float4 loads are free of bank
// conflicts. The 0/1 bytes become floats through the 2^23 trick (one byte
// permute and one subtract, no int-to-float conversion, which runs at 1/8
// of the FMA rate). Each row tile's sum runs in a fixed order and its output
// is written once: no atomics, no slabs, deterministic; row tiles with no
// block (padding) come out as exact zeros, and zero pad blocks are never
// read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 128;   // block edge: nodes per tile
constexpr int IPT = 4;   // output nodes per thread (one 32-bit word of a block row)
constexpr int FPT = 16;  // features per thread (one warp covers 16 features)

template <int FS>
__host__ __device__ constexpr int threads() {
    return FS / FPT * 32;
}

template <int FS>
__host__ __device__ constexpr size_t smem_bytes() {
    return (size_t)B * B + (size_t)B * FS * sizeof(float);
}

// 0/1 byte j of w as a float: 0x4B0000bj is 2^23 + b exactly
__device__ __forceinline__ float byte_as_float(uint32_t w, uint32_t j) {
    return __int_as_float((int)__byte_perm(w, 0x4B000000u, 0x7650u | j)) - 8388608.f;
}

template <int FS>
__global__ void __launch_bounds__(threads<FS>()) bcsr_rows(const int8_t* __restrict__ blocks,
                                                           const int* __restrict__ block_col,
                                                           const int* __restrict__ tile_ptr,
                                                           const int* __restrict__ tile_blocks,
                                                           const float* __restrict__ x, float* __restrict__ out, int F,
                                                           int ldx, int ldo) {
    constexpr int THREADS = threads<FS>();
    extern __shared__ uint4 smem4[];
    const uint32_t* blk = reinterpret_cast<const uint32_t*>(smem4);  // [c][i/4]: bytes i..i+3 of block row c
    float* xs = reinterpret_cast<float*>(smem4 + B * B / 16);         // [c][FS], 4-float groups swizzled by c & 7

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
        for (int idx = tid; idx < B * B / 16; idx += THREADS) smem4[idx] = src[idx];
        // lanes: 8 consecutive nodes (one 32-byte sector) x 4 features
        for (int idx = tid; idx < B * FS; idx += THREADS) {
            const int lo = idx & 7;
            const int a = (idx >> 3) & 3;
            const int rest = idx >> 5;
            const int c = (rest & (B / 8 - 1)) * 8 + lo;
            const int f = (rest / (B / 8)) * 4 + a;
            const int fg = f0 + f;
            xs[c * FS + (f ^ (lo << 2))] = fg < F ? x[(size_t)fg * ldx + col0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int c = 0; c < B; ++c) {
            const uint32_t w = blk[c * (B / 4) + lane];
            float av[IPT];
#pragma unroll
            for (int j = 0; j < IPT; ++j) av[j] = byte_as_float(w, j);
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

template <int FS>
int launch(const void* blocks, const void* block_col, const void* tile_ptr, const void* tile_blocks, const void* x,
           void* out, int R, int F, int ldx, int ldo, void* stream) {
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    // all of the block's shared memory is dynamic (no static arrays): 48 KB at
    // FS=64, the most a block may use without opting in
    constexpr size_t smem = smem_bytes<FS>();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(bcsr_rows<FS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) {
            (void)cudaGetLastError();
            return (int)e;
        }
    }
    const dim3 grid((unsigned)R, (unsigned)((F + FS - 1) / FS));
    bcsr_rows<FS><<<grid, threads<FS>(), smem, (cudaStream_t)stream>>>(
        (const int8_t*)blocks, (const int*)block_col, (const int*)tile_ptr, (const int*)tile_blocks, (const float*)x,
        (float*)out, F, ldx, ldo);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [F, ldx] and out [F, ldo] f32, contiguous and 16-byte aligned; ldo = R * 128
int bcsr_spmm_kernel(const void* blocks, const void* block_col, const void* tile_ptr, const void* tile_blocks,
                     const void* x, void* out, int R, int F, int ldx, int ldo, void* stream) {
    if (R <= 0 || F <= 0 || ldo != R * B || ldx % B) return (int)cudaErrorInvalidValue;
    // one slice of 64 features when F > 32 (the blocks are read once per slice)
    return F > 32 ? launch<64>(blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream)
                  : launch<32>(blocks, block_col, tile_ptr, tile_blocks, x, out, R, F, ldx, ldo, stream);
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
