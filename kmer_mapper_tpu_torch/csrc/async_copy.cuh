// The 16-byte asynchronous copy from device to shared memory that the
// kernels stage with, and the host's check of its source alignment.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmt_copy {

// A 16-byte cp.async copy (it bypasses L1); both addresses on 16 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace kmt_copy
