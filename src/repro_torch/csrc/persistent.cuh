// Launch helpers for persistent kernels: the blocks that fit a device at
// once, and the device's limits, each queried once and cached, so a launch
// after the first makes no runtime call besides cudaGetDevice, the launch
// and cudaGetLastError. Included by the kernel sources of csrc/.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace persistent {

struct Device {
  int sms = 0;     // streaming multiprocessors
  int optin = 0;   // shared memory a block may opt in to, bytes
};

inline cudaError_t device(int dev, Device* out) {
  static std::mutex mu;
  static std::map<int, Device> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(dev);
  if (it == cache.end()) {
    Device d;
    cudaError_t err =
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    it = cache.emplace(dev, d).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// occupancy x SMs blocks of `kernel` at `threads` threads and `smem` bytes
// of dynamic shared memory on device `dev`. With `max_smem` above 48 KB
// the kernel is first allowed that much dynamic shared memory.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int dev, int threads, size_t smem,
                            int max_smem, int* blocks) {
  using Key = std::tuple<const void*, int, int, size_t>;
  static std::mutex mu;
  static std::map<Key, int> cache;
  const Key key{reinterpret_cast<const void*>(kernel), dev, threads, smem};
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) {
      *blocks = it->second;
      return cudaSuccess;
    }
  }
  Device d;
  cudaError_t err = device(dev, &d);
  if (err == cudaSuccess && max_smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * d.sms;
  std::lock_guard<std::mutex> lock(mu);
  cache.emplace(key, *blocks);
  return cudaSuccess;
}

}  // namespace persistent
