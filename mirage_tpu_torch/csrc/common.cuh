// Shared helpers for the mirage_tpu_torch kernels (sm_90a, plain C ABI).
//
// Every kernel reads and writes its activations in one working type T
// (float or __nv_bfloat16) and does its arithmetic in float. Small parameter
// vectors (LayerNorm scale/shift, biases) may come in either type; their
// type is passed at run time so a bf16 activation can use f32 parameters
// without a cast kernel in front of it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

enum MttDtype { MTT_F32 = 0, MTT_BF16 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// Rounds a float through T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// Element i of a parameter vector whose type is known only at run time.
__device__ __forceinline__ float load_param(const void* p, long i, int dtype) {
  return dtype == MTT_BF16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                           : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------ warp-level tensor-core MMA

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16×16, row) · b (16×8, col), bf16 in, float accumulate.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Launch state is kept per device: one process may drive several cards,
// from one host thread each, and cudaFuncSetAttribute and the attribute
// queries act on the calling thread's current device only. Each slot is
// indexed by cudaGetDevice; the Python launcher makes the tensors' device
// current around every launch.
constexpr int MAX_DEVICES = 64;

// The current device, or -1 when it cannot be read or has no slot.
static inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
  return dev;
}

// The dynamic shared memory a kernel has been raised to, per device
// (`start`: what it holds without the attribute).
struct SmemLimit {
  size_t bytes[MAX_DEVICES];
  explicit SmemLimit(size_t start = 0) {
    for (size_t& b : bytes) b = start;
  }
};

static inline std::mutex& launch_state_mutex() {
  static std::mutex mu;
  return mu;
}

// Raises a kernel's dynamic shared memory limit to `bytes` on the current
// device unless an earlier call (recorded in `limit`) already did there.
// The check and the raise hold one lock, so two threads never lower it.
template <typename Kernel>
static int set_smem(Kernel kernel, size_t bytes, SmemLimit& limit) {
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(launch_state_mutex());
  if (bytes <= limit.bytes[dev]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  limit.bytes[dev] = bytes;
  return 0;
}

// The current device's SM count (0 when it cannot be read), cached per
// device.
static inline int sm_count() {
  static std::atomic<int> counts[MAX_DEVICES];
  const int dev = current_device();
  if (dev < 0) return 0;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
