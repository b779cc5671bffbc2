// A CPU emulation of the CUDA features csrc/mhsa.cu uses, so that its kernels
// run under g++ on a machine without a card (tests/test_torch_port_emulated.py).
// The threads of a block are cooperative fibers on the calling OS thread,
// each on its own stack; the blocks of a launch run one after another.
// __syncthreads is a barrier of the block and each warp collective
// (shuffles, mma.sync, ldmatrix, movmatrix, __syncwarp) a barrier of the
// warp's 32 lanes: a fiber that arrives where others are still due switches
// to the next runnable fiber, and the last to arrive releases the rest.  A
// collective's lanes exchange their operands through a buffer of the warp
// (two, alternating by the barrier's generation), then each lane computes
// its result with the PTX fragment layouts (an mma's, the first lane past
// the barrier for all 32).  Lanes of one warp that meet at
// different collectives, and a barrier that can never complete (a lane
// exited, or waits at another barrier), stop the launch at once: the
// message names the block, warp and lane, and cudaGetLastError() returns
// cudaErrorLaunchFailure.  cp.async is a copy (checked for its alignment);
// ex2.approx is exp2f with subnormals flushed; a TF32 operand is its f32
// bits with the low 13 cleared.  The tensor cores' own rounding is not
// modelled: products sum in f32 in k order.  Shared memory starts filled
// with 0xff bytes (NaN as f32), so a read of a value no thread wrote shows.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <functional>
#include <vector>

#include <sys/mman.h>

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

// Switch stacks: save the callee-saved registers and the stack pointer of
// the running fiber at *save, resume the one whose stack pointer is `to`.
// Weak: each translation unit of a build in parts defines it.
extern "C" void emu_switch(void** save, void* to);
asm(R"(
    .text
    .weak emu_switch
    .hidden emu_switch
    .type emu_switch, @function
emu_switch:
    pushq %rbp
    pushq %rbx
    pushq %r12
    pushq %r13
    pushq %r14
    pushq %r15
    movq %rsp, (%rdi)
    movq %rsi, %rsp
    popq %r15
    popq %r14
    popq %r13
    popq %r12
    popq %rbx
    popq %rbp
    ret
    .size emu_switch, .-emu_switch
)");

namespace emu {
enum { cudaErrorLaunchFailure = 719 };
inline thread_local int error = cudaSuccess;

// What a lane waits at: a warp collective of one kind, or the block's barrier.
enum Kind { kNone, kShfl, kMma, kLdmatrix, kMovmatrix, kSyncwarp, kSyncthreads };
inline const char* kind_name(int k) {
  static const char* names[] = {"nothing",   "__shfl_sync", "mma.sync",      "ldmatrix",
                                "movmatrix", "__syncwarp",  "__syncthreads"};
  return names[k];
}

struct Barrier {
  unsigned need = 0, count = 0, gen = 0;
  int kind = kNone;  // of the generation in progress
};
struct Warp {
  Barrier bar;
  uint32_t buf[2][32][16];
  const char* addr[2][32];
  float result[2][32][4];        // an mma's result for every lane
  unsigned result_gen[2] = {0, 0};  // 1 + the generation it was computed for
};
struct Fiber {
  void* sp = nullptr;
  char* stack = nullptr;
  bool done = false;
  Barrier* waits = nullptr;  // the barrier it waits at, or none
  int kind = kNone;
};
struct Block {
  Barrier bar;
  std::vector<Warp> warps;
  char* smem;
};

constexpr size_t kStack = 256 * 1024, kGuard = 4096;

// The fibers of one block and the loop that runs them.
struct Scheduler {
  std::vector<Fiber> fibers;
  void* main_sp = nullptr;
  unsigned cur = 0, block = 0;
  bool failed = false;
  std::function<void()> body;
};
inline thread_local Scheduler* sched;
inline thread_local Block* tb;
inline thread_local Warp* tw;
inline thread_local int lane;
inline char* block_smem() { return tb->smem; }

inline void yield() {
  Fiber& f = sched->fibers[sched->cur];
  emu_switch(&f.sp, sched->main_sp);
}

// Stop the launch: report, flag the error and never resume this fiber.
inline void fail() {
  sched->failed = true;
  error = cudaErrorLaunchFailure;
  for (;;) yield();
}

// Arrive at `b` for a wait of kind `kind`; return once every participant
// has arrived at the same generation.
inline void arrive(Barrier& b, int kind) {
  Fiber& me = sched->fibers[sched->cur];
  if (b.count == 0) {
    b.kind = kind;
  } else if (b.kind != kind) {
    fprintf(stderr,
            "emulated block %u: warp %u lane %d reaches %s where the other lanes of its warp "
            "wait at %s (a diverged collective)\n",
            sched->block, sched->cur / 32, (int)(sched->cur % 32), kind_name(kind),
            kind_name(b.kind));
    fail();
  }
  if (++b.count == b.need) {
    b.count = 0;
    ++b.gen;
    for (Fiber& f : sched->fibers)
      if (f.waits == &b) f.waits = nullptr;
    return;
  }
  me.waits = &b;
  me.kind = kind;
  while (me.waits) yield();
}

inline void entry() {
  sched->body();
  sched->fibers[sched->cur].done = true;
  for (;;) yield();
}

// A barrier that can never complete: name the first fiber that is not
// waiting at it (exited, or waiting at another barrier).
inline void report_deadlock() {
  auto& fs = sched->fibers;
  for (unsigned i = 0; i < fs.size(); ++i) {
    if (!fs[i].waits) continue;
    const Barrier* b = fs[i].waits;
    const bool warp_bar = fs[i].kind != kSyncthreads;
    for (unsigned j = 0; j < fs.size(); ++j) {
      if ((warp_bar && j / 32 != i / 32) || fs[j].waits == b) continue;
      char where[64] = "of the block";
      if (warp_bar) snprintf(where, sizeof where, "of warp %u", i / 32);
      char what[64] = "has exited";
      if (!fs[j].done) snprintf(what, sizeof what, "waits at %s", kind_name(fs[j].kind));
      fprintf(stderr,
              "emulated block %u: the %s %s can never complete: warp %u lane %u waits at it "
              "while warp %u lane %u %s\n",
              sched->block, kind_name(fs[i].kind), where, i / 32, i % 32, j / 32, j % 32, what);
      return;
    }
  }
}

// Every lane's N words of `mine`, for every lane of the warp.
template <int N>
inline void exchange(const uint32_t* mine, uint32_t (&all)[32][N], int kind) {
  Warp* w = tw;
  const unsigned par = w->bar.gen & 1;
  memcpy(w->buf[par][lane], mine, N * 4);
  arrive(w->bar, kind);
  for (int l = 0; l < 32; ++l) memcpy(all[l], w->buf[par][l], N * 4);
}

template <class... P>
struct Launch {
  void (*kernel)(P...);
  unsigned grid, block;
  size_t smem;
  template <class... A>
  void operator()(A... args) {
    if (error != cudaSuccess) return;  // an earlier launch failed
    std::vector<char> mem(smem + 256);
    char* base = (char*)(((uintptr_t)mem.data() + 127) & ~uintptr_t(127));
    Scheduler s;
    s.fibers.resize(block);
    for (auto& f : s.fibers) {
      void* m = mmap(nullptr, kStack + kGuard, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
      if (m == MAP_FAILED) {
        fprintf(stderr, "emulated launch: no memory for a fiber's stack\n");
        abort();
      }
      mprotect(m, kGuard, PROT_NONE);  // a stack overflow faults
      f.stack = (char*)m;
    }
    s.body = [&] { kernel(args...); };
    Scheduler* outer = sched;
    sched = &s;
    for (unsigned b = 0; b < grid && !s.failed; ++b) {
      Block blk;
      blk.bar.need = block;
      blk.warps.resize(block / 32);
      for (auto& w : blk.warps) w.bar.need = 32;
      memset(base, 0xff, smem);
      blk.smem = base;
      s.block = b;
      for (auto& f : s.fibers) {
        // the first switch pops six registers and returns into entry()
        void** sp = (void**)(f.stack + kGuard + kStack);
        *--sp = nullptr;  // entry()'s return address slot: the ABI's alignment
        *--sp = (void*)&entry;
        for (int r = 0; r < 6; ++r) *--sp = nullptr;
        f.sp = sp;
        f.done = false;
        f.waits = nullptr;
        f.kind = kNone;
      }
      tb = &blk;
      unsigned live = block;
      while (live && !s.failed) {
        bool ran = false;
        live = 0;
        for (unsigned t = 0; t < block && !s.failed; ++t) {
          Fiber& f = s.fibers[t];
          if (f.done) continue;
          ++live;
          if (f.waits) continue;
          threadIdx.x = t;
          blockIdx.x = b;
          blockDim.x = block;
          gridDim.x = grid;
          tw = &blk.warps[t / 32];
          lane = t % 32;
          s.cur = t;
          emu_switch(&s.main_sp, f.sp);
          ran = true;
        }
        if (live && !ran && !s.failed) {
          report_deadlock();
          s.failed = true;
          error = cudaErrorLaunchFailure;
        }
      }
    }
    sched = outer;
    for (auto& f : s.fibers) munmap(f.stack, kStack + kGuard);
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

inline cudaError_t cudaGetLastError() {
  const int e = emu::error;
  emu::error = cudaSuccess;
  return e;
}
inline void __syncthreads() { emu::arrive(emu::tb->bar, emu::kSyncthreads); }
inline void __syncwarp() { emu::arrive(emu::tw->bar, emu::kSyncwarp); }
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4, "4-byte shuffles only");
  uint32_t all[32][1], m;
  memcpy(&m, &v, 4);
  emu::exchange<1>(&m, all, emu::kShfl);
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

// d += a b for one m16n8k16 (bf16) or m16n8k8 (tf32) product of the warp:
// the first lane past the barrier computes every lane's result into the
// warp's buffer, and each lane takes its own.
template <bool BF16>
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  emu::Warp* w = emu::tw;
  const unsigned gen = w->bar.gen, par = gen & 1;
  uint32_t* mine = w->buf[par][emu::lane];
  const uint32_t in[10] = {a[0], a[1], a[2], a[3], b0, b1, f2u(d[0]), f2u(d[1]), f2u(d[2]), f2u(d[3])};
  memcpy(mine, in, sizeof in);
  emu::arrive(w->bar, emu::kMma);
  if (w->result_gen[par] != gen + 1) {
    constexpr int K = BF16 ? 16 : 8;
    float A[16][K], B[K][8];
    const uint32_t(&all)[32][16] = w->buf[par];
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
    for (int l = 0; l < 32; ++l) {
      const int g = l >> 2, c = l & 3;
      const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * c, 2 * c + 1, 2 * c, 2 * c + 1};
      for (int i = 0; i < 4; ++i) {
        float s = __uint_as_float(all[l][6 + i]);
        for (int k = 0; k < K; ++k) s += A[rows[i]][k] * B[k][cols[i]];
        w->result[par][l][i] = s;
      }
    }
    w->result_gen[par] = gen + 1;
  }
  for (int i = 0; i < 4; ++i) d[i] = w->result[par][emu::lane][i];
}

// movmatrix.m8n8.trans.b16: each lane holds row lane / 4, columns 2 (lane %
// 4) and 2 (lane % 4) + 1 of an 8 x 8 matrix of 16-bit values; it gets the
// same places of the transpose.
inline uint32_t emu_transpose8(uint32_t x) {
  uint32_t all[32][1];
  emu::exchange<1>(&x, all, emu::kMovmatrix);
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
  emu::Warp* w = emu::tw;
  const unsigned par = w->bar.gen & 1;
  w->addr[par][emu::lane] = (const char*)p;
  emu::arrive(w->bar, emu::kLdmatrix);
  const char* ad[32];
  for (int l = 0; l < 32; ++l) ad[l] = w->addr[par][l];
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
