// Host-side helper shared by the kernel sources: a kernel's launch
// attributes (its shared memory above 48 KB, its carveout) set once a
// device, since a launch's host time counts beside its device time.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace vb {

// Runs `set` (a lambda returning a cudaError_t) on the current device's
// first call and again only until it succeeds there. Each lambda has a type
// of its own, so each call site (and each instantiation of a template that
// holds one) keeps its own flags.
template <typename Set>
cudaError_t once_a_device(Set set) {
  constexpr int kDevices = 64;
  static std::atomic<bool> ready[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && ready[dev].load(std::memory_order_acquire))) return err;
  err = set();
  if (err == cudaSuccess && dev < kDevices) ready[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace vb
