// Loads and stores of the language-model kernels' element types, for
// Hopper (sm_90a).  Every kernel computes in float32; its tensors are
// float32 or bfloat16 (dtype code 0 or 1 from the Python wrapper), and a
// bfloat16 store rounds to nearest even, as torch's .to(torch.bfloat16).
#pragma once

#include <cuda_bf16.h>

namespace lm {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace lm
