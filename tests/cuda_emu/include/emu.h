// A CPU emulation of the CUDA features csrc/mhsa.cu uses, so that its kernels
// run under g++ on a machine without a card (tests/test_torch_port_emulated.py).
// One std::thread per CUDA thread; the blocks of a launch run one after
// another; __syncthreads is a barrier of the block, and the warp collectives
// (shuffles, mma.sync, ldmatrix, movmatrix) exchange each lane's operands
// through a buffer of the warp between two barriers of its 32 threads, then
// compute each lane's result with the PTX fragment layouts.  cp.async is a
// copy (checked for its alignment); ex2.approx is exp2f with subnormals
// flushed; a TF32 operand is its f32 bits with the low 13 cleared.  The
// tensor cores' own rounding is not modelled: products sum in f32 in k
// order.  Shared memory starts filled with 0xff bytes (NaN as f32), so a
// read of a value no thread wrote shows.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __align__(n) alignas(n)
#define __launch_bounds__(...)

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx, blockIdx, blockDim, gridDim;

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

struct __nv_bfloat16 {
  unsigned short x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline uint32_t f2u(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // to nearest, ties to even
  uint32_t u = f2u(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float((uint32_t)b.x << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return __nv_bfloat162{__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __low2float(__nv_bfloat162 h) { return __bfloat162float(h.x); }
inline float __high2float(__nv_bfloat162 h) { return __bfloat162float(h.y); }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 132;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint32_t buf[32][16];
  const char* addr[32];
};
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  char* smem;
};
inline thread_local Block* tb;
inline thread_local Warp* tw;
inline thread_local int lane;
inline char* block_smem() { return tb->smem; }

// Every lane's N words of `mine`, for every lane of the warp.
template <int N>
inline void exchange(const uint32_t* mine, uint32_t (&all)[32][N]) {
  memcpy(tw->buf[lane], mine, N * 4);
  tw->bar.arrive_and_wait();
  for (int l = 0; l < 32; ++l) memcpy(all[l], tw->buf[l], N * 4);
  tw->bar.arrive_and_wait();
}

template <class... P>
struct Launch {
  void (*kernel)(P...);
  unsigned grid, block;
  size_t smem;
  template <class... A>
  void operator()(A... args) {
    std::vector<char> mem(smem + 256);
    char* base = (char*)(((uintptr_t)mem.data() + 127) & ~uintptr_t(127));
    for (unsigned b = 0; b < grid; ++b) {
      Block blk;
      blk.bar = std::make_unique<std::barrier<>>(block);
      for (unsigned w = 0; w < block / 32; ++w) blk.warps.push_back(std::make_unique<Warp>());
      memset(base, 0xff, smem);
      blk.smem = base;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block; ++t)
        threads.emplace_back([&, t, b] {
          threadIdx.x = t;
          blockIdx.x = b;
          blockDim.x = block;
          gridDim.x = grid;
          tb = &blk;
          tw = blk.warps[t / 32].get();
          lane = t % 32;
          kernel(args...);
        });
      for (auto& th : threads) th.join();
    }
  }
};

template <class... P>
Launch<P...> launch(void (*kernel)(P...), long grid, long block, size_t smem, void*) {
  if (block % 32 || block <= 0 || block > 1024) {
    fprintf(stderr, "emulated launch of %ld threads a block\n", block);
    abort();
  }
  return Launch<P...>{kernel, (unsigned)grid, (unsigned)block, smem};
}

inline float bf(uint32_t x, int high) {
  return __bfloat162float(__nv_bfloat16{(unsigned short)(high ? x >> 16 : x & 0xffffu)});
}
inline float tf(uint32_t x) { return __uint_as_float(x & 0xffffe000u); }
}  // namespace emu

inline void __syncthreads() { emu::tb->bar->arrive_and_wait(); }
inline void __syncwarp() { emu::tw->bar.arrive_and_wait(); }
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4, "4-byte shuffles only");
  uint32_t all[32][1], m;
  memcpy(&m, &v, 4);
  emu::exchange<1>(&m, all);
  T r;
  memcpy(&r, &all[src & 31][0], 4);
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int o) {
  return __shfl_sync(mask, v, emu::lane ^ o);
}

inline void emu_cp_async(void* dst, const void* src, int n) {
  if (((uintptr_t)dst | (uintptr_t)src) % n) {
    fprintf(stderr, "cp.async of %d bytes off its alignment\n", n);
    abort();
  }
  memcpy(dst, src, n);
}

inline float emu_ex2(float x) {
  const float y = exp2f(x);
  return fabsf(y) < 1.17549435e-38f ? 0.f : y;
}

// d += a b for one m16n8k16 (bf16) or m16n8k8 (tf32) product of the warp.
template <bool BF16>
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  uint32_t mine[10] = {a[0], a[1], a[2], a[3], b0, b1, f2u(d[0]), f2u(d[1]), f2u(d[2]), f2u(d[3])};
  uint32_t all[32][10];
  emu::exchange<10>(mine, all);
  constexpr int K = BF16 ? 16 : 8;
  float A[16][K], B[K][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, c = l & 3;
    if (BF16) {
      for (int e = 0; e < 2; ++e) {
        A[g][2 * c + e] = emu::bf(all[l][0], e);
        A[g + 8][2 * c + e] = emu::bf(all[l][1], e);
        A[g][2 * c + 8 + e] = emu::bf(all[l][2], e);
        A[g + 8][2 * c + 8 + e] = emu::bf(all[l][3], e);
        B[2 * c + e][g] = emu::bf(all[l][4], e);
        B[2 * c + 8 + e][g] = emu::bf(all[l][5], e);
      }
    } else {
      A[g][c] = emu::tf(all[l][0]);
      A[g + 8][c] = emu::tf(all[l][1]);
      A[g][c + 4] = emu::tf(all[l][2]);
      A[g + 8][c + 4] = emu::tf(all[l][3]);
      B[c][g] = emu::tf(all[l][4]);
      B[c + 4][g] = emu::tf(all[l][5]);
    }
  }
  const int g = emu::lane >> 2, c = emu::lane & 3;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * c, 2 * c + 1, 2 * c, 2 * c + 1};
  for (int i = 0; i < 4; ++i) {
    float s = d[i];
    for (int k = 0; k < K; ++k) s += A[rows[i]][k] * B[k][cols[i]];
    d[i] = s;
  }
}

// movmatrix.m8n8.trans.b16: each lane holds row lane / 4, columns 2 (lane %
// 4) and 2 (lane % 4) + 1 of an 8 x 8 matrix of 16-bit values; it gets the
// same places of the transpose.
inline uint32_t emu_transpose8(uint32_t x) {
  uint32_t all[32][1];
  emu::exchange<1>(&x, all);
  auto el = [&](int r, int col) {
    const uint32_t v = all[r * 4 + col / 2][0];
    return (col & 1) ? v >> 16 : v & 0xffffu;
  };
  const int r = emu::lane >> 2, c2 = 2 * (emu::lane & 3);
  return el(c2, r) | (el(c2 + 1, r) << 16);
}

// ldmatrix.m8n8.x4 (.trans): matrix i's rows at the addresses of lanes
// 8 i .. 8 i + 7, each 16 bytes, 16-byte aligned.
inline void emu_ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  emu::tw->addr[emu::lane] = (const char*)p;
  emu::tw->bar.arrive_and_wait();
  const char* ad[32];
  for (int l = 0; l < 32; ++l) ad[l] = emu::tw->addr[l];
  emu::tw->bar.arrive_and_wait();
  for (int l = 0; l < 32; ++l)
    if ((uintptr_t)ad[l] & 15) {
      fprintf(stderr, "ldmatrix row address off 16 bytes\n");
      abort();
    }
  auto el = [&](int m, int row, int col) {
    unsigned short v;
    memcpy(&v, ad[8 * m + row] + 2 * col, 2);
    return (uint32_t)v;
  };
  const int t = emu::lane, rr = t >> 2, c2 = 2 * (t & 3);
  for (int m = 0; m < 4; ++m)
    r[m] = trans ? (el(m, c2, rr) | (el(m, c2 + 1, rr) << 16))
                 : (el(m, rr, c2) | (el(m, rr, c2 + 1) << 16));
}
