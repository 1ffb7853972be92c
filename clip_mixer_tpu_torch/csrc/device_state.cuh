// Per-device launch state shared by the port's kernels: a kernel's opt-in to
// more than 48 KB of dynamic shared memory, and the card's SM count.
//
// cudaFuncSetAttribute holds for the device that is current when it is
// called, so a value cached once per process would hold for the first
// device only, and a launch on another device would be refused. Both are
// cached here per device ordinal (cudaGetDevice, a host-side lookup), so a
// launch calls cudaFuncSetAttribute only the first time on each device.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace port {

constexpr int MAX_DEVICES = 64;

// One per kernel instance (a function-local static at its launch site): the
// dynamic shared memory that instance is opted into, per device.
struct SmemOptIn {
  std::atomic<int> bytes[MAX_DEVICES];  // zero-initialised as a static

  // Opt `kernel` into at least `need` bytes on the current device, once.
  cudaError_t ensure(const void* kernel, int need) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES)  // past the table: opt in on every call
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (bytes[dev].load(std::memory_order_acquire) >= need) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (e != cudaSuccess) return e;
    int had = bytes[dev].load(std::memory_order_relaxed);
    while (had < need && !bytes[dev].compare_exchange_weak(had, need, std::memory_order_release)) {
    }
    return cudaSuccess;
  }
};

// The current device's SM count, looked up once per device; 0 if the
// lookup failed.
inline int sm_count() {
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < MAX_DEVICES && (n = sms[dev].load(std::memory_order_relaxed)) != 0) return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < MAX_DEVICES) sms[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace port
