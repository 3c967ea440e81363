// A host stand-in for the parts of the CUDA runtime and device language
// that the port's kernels use, so that their sources compile with a host
// C++20 compiler and run on the CPU (tests/test_torch_csrc_host.py for the
// line kernels, tests/test_torch_csrc_host_compressed.py for the compressed
// ones): a launch runs each block of the grid in turn, its threads as
// std::threads that meet at a std::barrier in __syncthreads(); shared
// memory is one host array. Warp shuffles, clusters and inline PTX are not
// modelled (the kernels that need them are compiled, not run): a shuffle
// returns the thread's own value. A warp vote (__any_sync) returns the
// thread's own predicate, which is exact where both branches of the vote
// give each element the same value (the compressed kernels' sincos). The
// math functions are the C library's (math.h: rintf, copysignf, fmaf,
// sincosf, ...); the card's __sincosf is the library's sincosf here.
#pragma once
#include <barrier>
#include <cmath>
#include <math.h>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __cluster_dims__(...)
#define __shared__ static

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* host_barrier = nullptr;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline int min(int a, int b) { return a < b ? a : b; }
template <class T>
inline T __shfl_down_sync(unsigned, T v, int) {
  return v;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int) {
  return v;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int) {
  return v;
}
inline bool __any_sync(unsigned, bool predicate) { return predicate; }
inline void __sincosf(float x, float* s, float* c) { sincosf(x, s, c); }
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// The dynamic shared memory of the block that runs (227 KB, the card's
// most).
extern "C" float2 host_shared[227 * 1024 / sizeof(float2)];

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// host_launch(grid, block, smem, stream)(kernel, args...).
struct HostLaunch {
  dim3 grid, block;
  template <class K, class... A>
  void operator()(K kernel, A... args) {
    gridDim = grid;
    blockDim = block;
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(block.x);
        host_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by);
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
  }
};
inline HostLaunch host_launch(dim3 grid, dim3 block, size_t, cudaStream_t) {
  return {grid, block};
}
