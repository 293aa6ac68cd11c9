// Attribute opt-ins once per device. cudaFuncSetAttribute acts on the
// current device, so a process that drives several cards needs each opt-in
// on each of them; a guard keeps one result per device. (In an unnamed
// namespace: each translation unit instantiates it with its own kernels.)
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kMaxDevices = 64;

// guard(set) runs set() the first time it is called on the current device
// and returns that device's result from then on.
struct PerDevice {
  std::once_flag once[kMaxDevices];
  cudaError_t err[kMaxDevices] = {};

  template <typename F>
  cudaError_t operator()(F&& set) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(once[dev], [&] { err[dev] = set(); });
    return err[dev];
  }
};

}  // namespace
