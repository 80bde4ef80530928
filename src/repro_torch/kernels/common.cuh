// Helpers shared by the port's CUDA kernels (each csrc/<name>.cu includes
// this file; _build.py hashes every *.cuh here with every source).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <atomic>

// Returned by an entry point when cuTensorMapEncodeTiled refuses a TMA
// tensor map or cannot be found (the CUDA error codes stay below it).
#define REPRO_ERR_TENSOR_MAP 10000

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte load, widened to f32: 4 floats or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Makes CUDA device `device` current for the life of an entry point and
// restores the caller's device after it, so a launch runs on the card its
// tensors live on whatever the calling thread's current device is. Where
// the device is current already it costs one cudaGetDevice.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    int cur = -1;
    err_ = cudaGetDevice(&cur);
    if (err_ == cudaSuccess && cur != device) {
      err_ = cudaSetDevice(device);
      if (err_ == cudaSuccess) prev_ = cur;
    }
  }
  ~DeviceScope() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

// One kernel's opt-in to more than 48 KB of dynamic shared memory, made on
// the current device the first time that device launches it: a function's
// attributes belong to a device's context, so an opt-in made on one card
// does not hold on another. Kept as a function-level static beside the
// launch of each kernel instantiation. Two threads that race on a device
// both set the attribute, which is harmless; a failed opt-in is tried again
// at the next launch.
class SmemOptIn {
 public:
  static constexpr int MAX_DEVICES = 64;
  template <typename Kernel>
  cudaError_t operator()(Kernel* kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done_[dev].load(std::memory_order_acquire))
      return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess && dev < MAX_DEVICES)
      done_[dev].store(true, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<bool> done_[MAX_DEVICES]{};
};

}  // namespace

// The message of a cudaError_t returned by an entry point of the library.
extern "C" const char* repro_cuda_error_string(int err) {
  if (err == REPRO_ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused the tensor map (or libcuda "
           "lacks it)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
