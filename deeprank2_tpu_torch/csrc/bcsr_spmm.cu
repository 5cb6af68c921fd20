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
// int8 (0/1 for the unweighted adjacency; any signed value is taken at that
// value), bf16 or f32 (sGAT's weighted one). Every weight enters the
// products at its exact f32 value.
//
// Two forms, by the type of x: f32, and the single-pass bf16 form of the
// JAX kernel (its non-split branch, compute_dtype=bfloat16), whose x the
// wrapper rounds to bf16 once and whose blocks are cast to bf16: exact for
// int8 and bf16 blocks, rounded to nearest even (in registers, as JAX's
// astype) for f32 ones. Sums run in f32 in both forms.
//
// What bounds it on an H100 SXM, per call at the 100k-node atomic graph
// (15,222 nonzero blocks, 3.27M directed edges, 1.3 % of each block's
// entries, about 20 % of its source rows): the nonzero blocks are read once
// (249 MB int8, 499 MB bf16, 997 MB f32), x and out once each (12.8 MB at
// F=32), about 80 / 155 / 300 us at 3.35 TB/s. The edges need 2*F*nnz =
// 0.2 GFLOP at F=32, 3 us of f32 FMAs. So the function is bound by the
// bytes of the blocks.
//
// Design: a walk of each block's nonzeros on CUDA cores behind an
// asynchronous ring of blocks. Two launches a call:
//   - node_major: x [F, ldx] to a node-major scratch xn [nodes, ldn] (32 x
//     32 tiles through shared memory). A block needs x only at its nonzero
//     source rows; node-major, each is one run of FS values, where
//     feature-major rows would fetch a 32-byte sector for each feature of
//     each group of 8 rows;
//   - bcsr_walk: one thread block (8 warps) per (row tile, feature slice of
//     FS = 16, 32 or 64, group of destination nodes). Where the row tiles
//     and slices give fewer than two thread blocks an SM (the pooled
//     structures: 18 row tiles), the 128 destination nodes are split in 2,
//     4 or 8 groups, each walking the same blocks (at 8, some warps of a
//     thread block have no node to walk). Per block of the tile:
//       - ring: thread 0 keeps the tile's next block in flight, one 1-D TMA
//         bulk copy (cp.async.bulk, 16 / 32 / 64 KB, completion on an
//         mbarrier) into a ring of two stages;
//       - row mask: the OR of each source row's 128 entries, warp ballots:
//         the rows c with an edge into the tile;
//       - x: the slice of xn at those rows only, 16-byte cp.async copies
//         (8 bytes in the bf16 form) into a node-major slab;
//       - column masks: for each destination node i, a 128-bit mask of the
//         source rows c with a nonzero entry, built from the nonzero rows;
//       - products: a lane holds two quads of features of one node (2, 4
//         or 8 lanes a node at FS = 16, 32, 64), so 16, 8 or 4 nodes walk
//         side by side in a warp: for each node, the set bits of its column
//         mask in ascending c, one entry load and two 16-byte (or 8-byte)
//         slab loads, then one fmaf a feature. Only the nonzero entries are
//         converted (int8 with a signed conversion, bf16 by a shift) and
//         multiplied.
// Each output (i, f) is one fmaf chain in a fixed order: the row tile's
// blocks in tile_blocks order, then c ascending. No atomics and no split of
// a tile's blocks: the result is deterministic, and for 0/1 blocks it is
// bit for bit the f32 loop that adds x in that order. Row tiles with no
// block come out as exact zeros, and zero pad blocks are never read. The
// output tile goes through shared memory for coalesced stores.
//
// A skipped zero entry contributes nothing, so an Inf or NaN in x under a
// zero weight does not turn the sum into NaN, where the dense product (the
// plain version) multiplies it by 0; cuSPARSE behaves the same. A finite
// sum is unchanged bit for bit by skipping: the accumulator starts at +0
// and can never become -0.
//
// Why not tensor cores: at 1.3 % fill an mma product, even one that skips
// all-zero 16-row slices, does 15-75x the products the edges need; an f32
// x needs three bf16 passes (an exact split), and the tensor cores' f32
// sums would change the summation order the gates hold today.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using bf16::round_bf16;
using bf16::widen;

constexpr int B = 128;  // block edge: nodes per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_ROW = B + 1;  // words per row of the output tile
constexpr int MAX_GROUPS = 8;    // groups of destination nodes a row tile

enum BlockType { INT8 = 0, BF16 = 1, F32 = 2 };

// One block entry type: its value, the four entries of a block row that one
// lane reads (nodes 4*lane .. 4*lane + 3) as one word, and which are nonzero
// (their bits, so a bf16 or f32 -0 counts as an entry: its product is an
// exact zero and changes no sum).
template <typename T>
struct Entry;

template <>
struct Entry<int8_t> {
    using Quad = uint32_t;
    static __device__ __forceinline__ float value(int8_t v) { return (float)v; }
    static __device__ __forceinline__ uint32_t nonzero(Quad q) {
        return (q & 0xFFu ? 1u : 0u) | (q & 0xFF00u ? 2u : 0u) | (q & 0xFF0000u ? 4u : 0u) | (q & 0xFF000000u ? 8u : 0u);
    }
};

template <>
struct Entry<uint16_t> {  // bf16, as its bit patterns
    using Quad = uint2;
    static __device__ __forceinline__ float value(uint16_t v) { return widen(v); }
    static __device__ __forceinline__ uint32_t nonzero(Quad q) {
        return (q.x & 0xFFFFu ? 1u : 0u) | (q.x >> 16 ? 2u : 0u) | (q.y & 0xFFFFu ? 4u : 0u) | (q.y >> 16 ? 8u : 0u);
    }
};

template <>
struct Entry<float> {
    using Quad = uint4;  // the bits
    static __device__ __forceinline__ float value(float v) { return v; }
    static __device__ __forceinline__ uint32_t nonzero(Quad q) {
        return (q.x ? 1u : 0u) | (q.y ? 2u : 0u) | (q.z ? 4u : 0u) | (q.w ? 8u : 0u);
    }
};

// T: the block entry type; X: the type of x (float, or bf16 bits: the bf16
// form, which rounds f32 block entries to bf16); FS: the feature slice
template <typename T, typename X, int FS>
struct Shape {
    // the ring of blocks: two stages, each refilled as soon as its block is
    // walked, so the next block is in flight while one is walked (more
    // stages cost thread blocks an SM and were no faster)
    static constexpr int STAGES = 2;
    static constexpr int BLOCK_BYTES = B * B * (int)sizeof(T);
    static constexpr int ROW_CHUNKS = B * (int)sizeof(T) / 16;  // 16-byte chunks of a block row
    static constexpr int QPL = 2;                               // quads of features a lane
    static constexpr int LPN = FS / (4 * QPL);                  // lanes that share a node
    static constexpr int NPAR = 32 / LPN;                       // nodes a warp walks side by side
    static constexpr int NMAX = B / (WARPS * NPAR);             // nodes a lane, with one group
    // x slab: the block's source rows of the slice, node-major (f32 rows of
    // FS; bf16 rows padded to FS + 4, so that two rows' quads fall on other
    // banks), so a lane reads its quad of row c in one load; the same words
    // then hold the output tile [FS][129] f32
    static constexpr int XROW = sizeof(X) == 4 ? FS : FS + 4;  // entries of X a slab row
    static constexpr int SLAB_WORDS = FS * TILE_ROW;
    static_assert(B * XROW * (int)sizeof(X) <= 4 * SLAB_WORDS, "slab");
    // the ring, the slab, the column masks [4][B], the row-mask halves [8],
    // the ring's barriers
    static constexpr size_t SMEM = (size_t)STAGES * BLOCK_BYTES + 4 * ((size_t)SLAB_WORDS + 4 * B + 8) + 8 * STAGES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void ring_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// one TMA bulk copy of `bytes` into shared memory, completing on `bar`
__device__ __forceinline__ void ring_fill(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// one quad of x (4 f32 or 4 bf16) into shared memory, asynchronously
__device__ __forceinline__ void copy_quad(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_quad(uint16_t* dst, const uint16_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// a quad of x from the slab, as f32
__device__ __forceinline__ void load_quad(const float* p, float (&v)[4]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
}
__device__ __forceinline__ void load_quad(const uint16_t* p, float (&v)[4]) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xFFFF0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xFFFF0000u);
}

// x [F, ldx] to node-major xn [nodes, ldn] (ldn = F rounded up to 4; the
// pad features are zeros): 32 x 32 tiles through shared memory, so both the
// reads and the writes are coalesced
template <typename X>
__global__ void __launch_bounds__(256) node_major(const X* __restrict__ x, X* __restrict__ xn, int F, int ldx, int ldn) {
    __shared__ X tile[32][33];
    const int n0 = blockIdx.x * 32;
    const int f0 = blockIdx.y * 32;
#pragma unroll
    for (int k = 0; k < 32; k += 8) {
        const int f = f0 + threadIdx.y + k;
        tile[threadIdx.y + k][threadIdx.x] = f < F ? x[(size_t)f * ldx + n0 + threadIdx.x] : X(0);
    }
    __syncthreads();
    const int f = f0 + threadIdx.x;
    if (f < ldn)
#pragma unroll
        for (int k = 0; k < 32; k += 8) xn[(size_t)(n0 + threadIdx.y + k) * ldn + f] = tile[threadIdx.x][threadIdx.y + k];
}

template <typename T, typename X, int FS>
__global__ void __launch_bounds__(THREADS, 3)
    bcsr_walk(const T* __restrict__ blocks, const int* __restrict__ block_col, const int* __restrict__ tile_ptr,
              const int* __restrict__ tile_blocks, const X* __restrict__ xn, float* __restrict__ out, int F, int ldn,
              int ldo, int groups) {
    using S = Shape<T, X, FS>;
    using Quad = typename Entry<T>::Quad;
    constexpr bool ROUND = sizeof(X) == 2 && sizeof(T) == 4;
    extern __shared__ __align__(128) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);
    X* slab = reinterpret_cast<X*>(smem + (size_t)S::STAGES * S::BLOCK_BYTES);
    uint32_t* colmask = reinterpret_cast<uint32_t*>(slab) + S::SLAB_WORDS;  // [4][B]: bit c & 31 of word c >> 5, for node i
    uint32_t* row_half = colmask + 4 * B;  // [8]: rows 32w .. 32w + 31, half h of the row, at w + 4h
    uint64_t* full = reinterpret_cast<uint64_t*>(row_half + 8);

    const int r = blockIdx.x;
    const int slice = blockIdx.y / groups;
    const int group = blockIdx.y % groups;
    const int f0 = slice * FS;
    const int quads = min(FS, ldn - f0) / 4;  // of the slice in a row of xn
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int t0 = tile_ptr[r];
    const int n = tile_ptr[r + 1] - t0;

    if (tid == 0) {
        for (int s = 0; s < S::STAGES; ++s) ring_init(&full[s]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
        for (int j = 0; j < n && j < S::STAGES; ++j)
            ring_fill(ring + (size_t)j * B * B, blocks + (size_t)tile_blocks[t0 + j] * B * B, S::BLOCK_BYTES, &full[j]);

    // the products' lanes: feature quads fl and fl + LPN of node subset p;
    // warp v walks nodes (q * WARPS + v) * NPAR + p of its group
    const int p = lane / S::LPN;
    const int fl = lane % S::LPN;
    const int nodes = B / groups;
    const int node0 = group * nodes;
    float acc[S::NMAX][4 * S::QPL];
#pragma unroll
    for (int q = 0; q < S::NMAX; ++q)
#pragma unroll
        for (int e = 0; e < 4 * S::QPL; ++e) acc[q][e] = 0.f;

    for (int j = 0; j < n; ++j) {
        const int s = j % S::STAGES;
        const T* blk = ring + (size_t)s * B * B;
        ring_wait(&full[s], (uint32_t)(j / S::STAGES) & 1u);

        // row mask: thread (row, half) ORs every other 16-byte chunk of its
        // row, in an order that keeps 8 consecutive rows on 8 bank groups
        {
            const int row = tid & (B - 1);
            const int h = tid >> 7;
            const uint4* rp = reinterpret_cast<const uint4*>(blk) + row * S::ROW_CHUNKS;
            uint32_t any = 0;
#pragma unroll
            for (int m = 0; m < S::ROW_CHUNKS / 2; ++m) {
                const uint4 v = rp[(2 * m + h + row) % S::ROW_CHUNKS];
                any |= v.x | v.y | v.z | v.w;
            }
            const uint32_t bits = __ballot_sync(0xFFFFFFFFu, any != 0);
            if (lane == 0) row_half[warp] = bits;
        }
        __syncthreads();
        const uint64_t rows_lo = (row_half[0] | row_half[4]) | (uint64_t)(row_half[1] | row_half[5]) << 32;
        const uint64_t rows_hi = (row_half[2] | row_half[6]) | (uint64_t)(row_half[3] | row_half[7]) << 32;

        // x: the slice of each nonzero row, quad by quad: thread t copies
        // quad t % (FS/4) of those of rows t / (FS/4) + k * STEP that hold an
        // edge; their bits gathered into one word (row c0 + a * STEP of the
        // lower 64 rows at bit a * STEP, of the upper at bit a * STEP + 1)
        {
            constexpr int STEP = THREADS / (FS / 4);
            uint64_t pattern = 0;
#pragma unroll
            for (int a = 0; a < 64 / STEP; ++a) pattern |= 1ull << (a * STEP);
            const int c0 = tid / (FS / 4);
            const int g = tid % (FS / 4);
            const X* xr = xn + (size_t)block_col[tile_blocks[t0 + j]] * B * ldn + f0 + 4 * g;
            uint64_t mine = g < quads ? ((rows_lo >> c0) & pattern) | (((rows_hi >> c0) & pattern) << 1) : 0;
            while (mine) {
                const int pos = __ffsll((long long)mine) - 1;
                mine &= mine - 1;
                const int c = c0 + (pos & ~1) + 64 * (pos & 1);
                copy_quad(slab + c * S::XROW + 4 * g, xr + (size_t)c * ldn);
            }
        }
        asm volatile("cp.async.commit_group;" ::: "memory");

        // column masks: warp w (of the first four) takes rows 32w .. 32w + 31,
        // lane q nodes 4q .. 4q + 3
        if (warp < 4) {
            uint32_t rest = row_half[warp] | row_half[warp + 4];
            uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
            const Quad* qrow = reinterpret_cast<const Quad*>(blk) + lane;
            while (rest) {
                const int b = __ffs(rest) - 1;
                rest &= rest - 1;
                const uint32_t nz = Entry<T>::nonzero(qrow[(32 * warp + b) * (B / 4)]);
                m0 |= (nz & 1u) << b;
                m1 |= ((nz >> 1) & 1u) << b;
                m2 |= ((nz >> 2) & 1u) << b;
                m3 |= ((nz >> 3) & 1u) << b;
            }
            reinterpret_cast<uint4*>(colmask)[warp * 32 + lane] = make_uint4(m0, m1, m2, m3);
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();

        // products: each node's nonzero entries in ascending c, one fmaf
        // chain a node and feature
#pragma unroll
        for (int q = 0; q < S::NMAX; ++q) {
            if ((q * WARPS + warp) * S::NPAR < nodes) {
                const int i = node0 + (q * WARPS + warp) * S::NPAR + p;
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    uint32_t bits = colmask[w * B + i];
                    while (bits) {
                        const int c = 32 * w + __ffs(bits) - 1;
                        bits &= bits - 1;
                        float a = Entry<T>::value(blk[c * B + i]);
                        if (ROUND) a = round_bf16(a);
#pragma unroll
                        for (int m = 0; m < S::QPL; ++m) {
                            float v[4];
                            load_quad(slab + c * S::XROW + 4 * (fl + m * S::LPN), v);
#pragma unroll
                            for (int e = 0; e < 4; ++e) acc[q][4 * m + e] = fmaf(a, v[e], acc[q][4 * m + e]);
                        }
                    }
                }
            }
        }
        __syncthreads();  // the stage, the slab and the masks are consumed
        if (tid == 0 && j + S::STAGES < n)
            ring_fill(ring + (size_t)s * B * B, blocks + (size_t)tile_blocks[t0 + j + S::STAGES] * B * B, S::BLOCK_BYTES,
                      &full[s]);
    }

    // the output tile [FS][129] through shared memory, then coalesced stores
    float* tile = reinterpret_cast<float*>(slab);
#pragma unroll
    for (int q = 0; q < S::NMAX; ++q) {
        if ((q * WARPS + warp) * S::NPAR < nodes) {
            const int i = node0 + (q * WARPS + warp) * S::NPAR + p;
#pragma unroll
            for (int e = 0; e < 4 * S::QPL; ++e) tile[(4 * (fl + (e >> 2) * S::LPN) + (e & 3)) * TILE_ROW + i] = acc[q][e];
        }
    }
    __syncthreads();
    for (int idx = tid; idx < FS * nodes; idx += THREADS) {
        const int f = idx / nodes;
        const int i = node0 + idx % nodes;
        if (f0 + f < F) out[(size_t)(f0 + f) * ldo + (size_t)r * B + i] = tile[f * TILE_ROW + i];
    }
}

// one call's operands
struct Call {
    const void* blocks;
    const int* block_col;
    const int* tile_ptr;
    const int* tile_blocks;
    const void* x;
    void* xn;
    float* out;
    int R, F, ldx, ldn, ldo;
    cudaStream_t stream;
};

// the SMs of each device, read once
int sm_count(int device) {
    static int sms[64] = {};
    if (device < 0 || device >= 64) return 0;
    if (!sms[device] && cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
        sms[device] = 0;
    return sms[device];
}

template <typename T, typename X, int FS>
int launch(const Call& a) {
    // the error returned after the launch must be this launch's: drop any
    // earlier non-sticky error still recorded for this thread
    (void)cudaGetLastError();
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    const int sms = e == cudaSuccess ? sm_count(device) : 0;
    if (e == cudaSuccess && !sms) e = cudaErrorInvalidDevice;
    // all of the walk's shared memory is dynamic (42-163 KB): it opts in for
    // every byte it uses, once a device
    constexpr size_t smem = Shape<T, X, FS>::SMEM;
    static bool opted[64] = {};
    if (e == cudaSuccess && !opted[device]) {
        e = cudaFuncSetAttribute(bcsr_walk<T, X, FS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        opted[device] = e == cudaSuccess;
    }
    if (e != cudaSuccess) {
        (void)cudaGetLastError();
        return (int)e;
    }
    node_major<X><<<dim3((unsigned)(a.ldx / 32), (unsigned)((a.ldn + 31) / 32)), dim3(32, 8), 0, a.stream>>>(
        (const X*)a.x, (X*)a.xn, a.F, a.ldx, a.ldn);
    // split the destination nodes until there are two thread blocks an SM
    const int slices = (a.F + FS - 1) / FS;
    int groups = 1;
    while (groups < MAX_GROUPS && (long long)a.R * slices * groups < 2LL * sms) groups *= 2;
    const dim3 grid((unsigned)a.R, (unsigned)(slices * groups));
    bcsr_walk<T, X, FS><<<grid, THREADS, smem, a.stream>>>((const T*)a.blocks, a.block_col, a.tile_ptr, a.tile_blocks,
                                                          (const X*)a.xn, a.out, a.F, a.ldn, a.ldo, groups);
    return (int)cudaGetLastError();
}

template <typename T, typename X>
int launch_sliced(const Call& a) {
    // the narrowest slice that holds F, else slices of 64 (the blocks are
    // walked once per slice)
    if (a.F <= 16) return launch<T, X, 16>(a);
    if (a.F <= 32) return launch<T, X, 32>(a);
    return launch<T, X, 64>(a);
}

// the activation types, by their code in ops/diag_spmm.py (ACT_DTYPES)
enum ActType { ACT_F32 = 0, ACT_BF16 = 1 };

template <typename T>
int launch_typed(int xtype, const Call& a) {
    switch (xtype) {
        case ACT_F32:
            return launch_sliced<T, float>(a);
        case ACT_BF16:
            return launch_sliced<T, uint16_t>(a);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// blocks [NB, 128, 128] of type `dtype` (0 int8, 1 bf16, 2 f32), 16-byte
// aligned (the TMA copies); x [F, ldx] of type `xtype` (0 f32, 1 bf16: the
// bf16 form); xn [ldx, ldn] of the same type, 16-byte aligned, the scratch
// of x made node-major, ldn = F rounded up to a multiple of 4; out [F, ldo]
// f32; all contiguous; ldo = R * 128
int bcsr_spmm_kernel(const void* blocks, int dtype, const void* block_col, const void* tile_ptr,
                     const void* tile_blocks, const void* x, int xtype, void* xn, int ldn, void* out, int R, int F,
                     int ldx, int ldo, void* stream) {
    if (R <= 0 || F <= 0 || ldo != R * B || ldx % B || ldn != (F + 3) / 4 * 4) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)blocks % 16 || (uintptr_t)xn % 16) return (int)cudaErrorMisalignedAddress;
    const Call a{blocks, (const int*)block_col, (const int*)tile_ptr, (const int*)tile_blocks, x, xn, (float*)out,
                 R, F, ldx, ldn, ldo, (cudaStream_t)stream};
    switch (dtype) {
        case INT8:
            return launch_typed<int8_t>(xtype, a);
        case BF16:
            return launch_typed<uint16_t>(xtype, a);
        case F32:
            return launch_typed<float>(xtype, a);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
