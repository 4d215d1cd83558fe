// Helpers shared by the conv towers' gradient kernels (conv3d_wgrad.cu,
// conv3d_dgrad.cu): 4-byte cp.async copies into shared memory, and the
// current device with its SM count, read once a device.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

// Copies one float from global to shared memory, or writes a zero there
// when `valid` is false (src is then not read, but must be a device address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits for all of this thread's copies, committed or not.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The current device and its number of SMs.
inline cudaError_t current_device_sms(int* device, int* count) {
  static std::atomic<int> sms[kMaxDevices];  // zero: not read yet
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  *count = *device < kMaxDevices ? sms[*device].load() : 0;
  if (*count == 0) {
    err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, *device);
    if (err != cudaSuccess) return err;
    if (*device < kMaxDevices) sms[*device].store(*count);
  }
  return cudaSuccess;
}

}  // namespace
