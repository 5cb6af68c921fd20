// bf16 helpers shared by the single-pass bf16 forms of the kernels
// (csrc/bcsr_spmm.cu, csrc/blocked_edges.cu and csrc/tower_common.cuh). A
// bf16 is held as its 16 bits (uint16_t), the top half of the f32 of the
// same value, so widening one is exact and a sum over them runs in f32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16 {

// one activation as an f32: itself, or the exact value of its bf16 bits
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

// the bits of v rounded to the nearest bf16 (ties to even): the value JAX's
// astype(bfloat16) gives, in one hardware conversion (sm_80 and later). A NaN
// stays a NaN (the canonical one), an infinity stays itself, and subnormals
// are rounded, not flushed to zero.
__device__ __forceinline__ uint16_t bf16_bits(float v) {
    uint16_t h;
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(v));
    return h;
}

// v rounded to the nearest bf16, as an f32
__device__ __forceinline__ float round_bf16(float v) { return widen(bf16_bits(v)); }

// stores v as an activation: itself, or rounded to bf16, as its bits
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) { *p = bf16_bits(v); }

}  // namespace bf16
