// Slot max-pool kernels for Hopper (sm_90a), bound with ctypes from
// deeprank2_tpu_torch/ops/slotpool.py.
//
// They replace the two TPU kernels of deeprank2_tpu/ops/pallas_slotpool.py:
//   slot_fwd_kernel  <- _fwd_kernel  (launched by _slot_fwd_tpu)
//   slot_bwd_kernel  <- _bwd_kernel  (launched by _slot_bwd_tpu)
//
// On flat transposed f32 activations h [F, V] cut into aligned groups of
// SLOT lanes (SLOT in {2, 4, 8}, V % SLOT == 0):
//   slot_fwd_kernel  pooled[f, j] = max(h[f, SLOT*j .. SLOT*j + SLOT-1])
//   slot_bwd_kernel  dh[f, v] = ([h[f, v] == pooled[f, j]] * mask[v]) * g[f, j],
//                    j = v / SLOT
// The forward reads no mask: h is post-relu and masked, so an empty group
// pools to 0. The backward is an exact f32 comparison, so every valid lane
// that ties for the max gets the full cotangent and padded lanes get 0, the
// JAX package's tie rule. Both are exact (a max and a comparison, no sums):
// they equal their plain PyTorch versions bit for bit, and the arithmetic of
// the backward is the plain version's, (eq * mask) * g, signed zeros included.
//
// What bounds them on an H100 SXM, at the bench shape (F=32, V=151,552,
// slot 8): the forward reads h (19.4 MB) and writes pooled (2.4 MB), about
// 6.5 us at 3.35 TB/s; the backward reads h, the mask row (0.6 MB), pooled and
// g (2 x 2.4 MB) and writes dh (19.4 MB), about 13 us. One comparison per
// byte or less: bytes bound both.
//
// Design: one thread per (feature row, group); neighbouring threads take
// neighbouring groups, so a warp reads and writes one contiguous span.
// A group is one or two 16-byte vector loads (slot 8: two float4, slot 4:
// one float4, slot 2: one float2); the wrapper checks that the pointers
// are 16-byte aligned. The TPU kernel's roll-tree max, bf16 three-term
// split, selection and expansion matmuls and NaN fencing of the ragged last
// block exist because Mosaic has no cheap stride-8 lane gather; here a
// thread simply loads its group, and the last group is bounds-checked by
// index. The max propagates NaN as torch.amax does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int SLOT>
struct Group {
    float v[SLOT];
};

template <int SLOT>
__device__ __forceinline__ Group<SLOT> load_group(const float* p) {
    Group<SLOT> out;
    if constexpr (SLOT == 2) {
        const float2 a = reinterpret_cast<const float2*>(p)[0];
        out.v[0] = a.x;
        out.v[1] = a.y;
    } else {
#pragma unroll
        for (int q = 0; q < SLOT / 4; ++q) {
            const float4 a = reinterpret_cast<const float4*>(p)[q];
            out.v[4 * q + 0] = a.x;
            out.v[4 * q + 1] = a.y;
            out.v[4 * q + 2] = a.z;
            out.v[4 * q + 3] = a.w;
        }
    }
    return out;
}

template <int SLOT>
__device__ __forceinline__ void store_group(float* p, const Group<SLOT>& in) {
    if constexpr (SLOT == 2) {
        reinterpret_cast<float2*>(p)[0] = make_float2(in.v[0], in.v[1]);
    } else {
#pragma unroll
        for (int q = 0; q < SLOT / 4; ++q)
            reinterpret_cast<float4*>(p)[q] = make_float4(in.v[4 * q], in.v[4 * q + 1], in.v[4 * q + 2], in.v[4 * q + 3]);
    }
}

// max that keeps a NaN from either side (torch.amax semantics)
__device__ __forceinline__ float max_nan(float a, float b) { return (b > a || b != b) ? b : a; }

template <int SLOT>
__global__ void __launch_bounds__(THREADS) slot_fwd(const float* __restrict__ h, float* __restrict__ pooled,
                                                    int64_t total, int64_t groups) {
    const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (t >= total) return;
    // t = f * groups + j, and h's row f starts at f * groups * SLOT
    const Group<SLOT> x = load_group<SLOT>(h + t * SLOT);
    float m = x.v[0];
#pragma unroll
    for (int k = 1; k < SLOT; ++k) m = max_nan(m, x.v[k]);
    pooled[t] = m;
}

template <int SLOT>
__global__ void __launch_bounds__(THREADS) slot_bwd(const float* __restrict__ h, const float* __restrict__ mask,
                                                    const float* __restrict__ pooled, const float* __restrict__ g,
                                                    float* __restrict__ dh, int64_t total, int64_t groups) {
    const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (t >= total) return;
    const int64_t j = t % groups;
    const float p = pooled[t];
    const float gv = g[t];
    const Group<SLOT> x = load_group<SLOT>(h + t * SLOT);
    const Group<SLOT> m = load_group<SLOT>(mask + j * SLOT);
    Group<SLOT> out;
#pragma unroll
    for (int k = 0; k < SLOT; ++k) out.v[k] = ((x.v[k] == p ? 1.f : 0.f) * m.v[k]) * gv;
    store_group<SLOT>(dh + t * SLOT, out);
}

int grid_for(int64_t total) { return (int)((total + THREADS - 1) / THREADS); }

bool valid_args(int F, int V, int slot) {
    return F > 0 && V > 0 && (slot == 2 || slot == 4 || slot == 8) && V % slot == 0;
}

}  // namespace

extern "C" {

// pooled [F, V/slot] = slot-lane group max of h [F, V]
int slot_fwd_kernel(const void* h, void* pooled, int F, int V, int slot, void* stream) {
    if (!valid_args(F, V, slot)) return (int)cudaErrorInvalidValue;
    // the error returned after the launch must be this launch's
    (void)cudaGetLastError();
    const int64_t groups = V / slot;
    const int64_t total = (int64_t)F * groups;
    const cudaStream_t s = (cudaStream_t)stream;
    const float* hp = (const float*)h;
    float* out = (float*)pooled;
    switch (slot) {
        case 8: slot_fwd<8><<<grid_for(total), THREADS, 0, s>>>(hp, out, total, groups); break;
        case 4: slot_fwd<4><<<grid_for(total), THREADS, 0, s>>>(hp, out, total, groups); break;
        default: slot_fwd<2><<<grid_for(total), THREADS, 0, s>>>(hp, out, total, groups); break;
    }
    return (int)cudaGetLastError();
}

// dh [F, V] from h [F, V], the f32 mask row [V], pooled and g [F, V/slot]
int slot_bwd_kernel(const void* h, const void* mask, const void* pooled, const void* g, void* dh, int F, int V,
                    int slot, void* stream) {
    if (!valid_args(F, V, slot)) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const int64_t groups = V / slot;
    const int64_t total = (int64_t)F * groups;
    const cudaStream_t s = (cudaStream_t)stream;
    const float *hp = (const float*)h, *mp = (const float*)mask, *pp = (const float*)pooled, *gp = (const float*)g;
    float* out = (float*)dh;
    switch (slot) {
        case 8: slot_bwd<8><<<grid_for(total), THREADS, 0, s>>>(hp, mp, pp, gp, out, total, groups); break;
        case 4: slot_bwd<4><<<grid_for(total), THREADS, 0, s>>>(hp, mp, pp, gp, out, total, groups); break;
        default: slot_bwd<2><<<grid_for(total), THREADS, 0, s>>>(hp, mp, pp, gp, out, total, groups); break;
    }
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
