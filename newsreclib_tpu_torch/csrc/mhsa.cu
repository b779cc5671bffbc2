// Masked multi-head self-attention over many short independent sequences,
// forward only: the attention of the NRMS title encoder (L = 16 / 30) and of
// its user encoder (L = 50), at D = 300, H = 15, hd = 20.
//
// Replaces the TPU kernel newsreclib_tpu/ops/mhsa.py::fused_small_mhsa (body
// _attention_kernel, pallas_call at ops/mhsa.py:198) and computes what
// ops/mhsa.py::mhsa_reference computes: for each sequence u and head h,
// softmax over the valid keys of q.k^T / sqrt(hd), applied to v.  Masked keys
// take the finite logit -1e30 (never -inf), so a fully masked sequence (the
// padding article, row 0) gets a uniform softmax over its L keys and a finite
// output.  Rows at masked query positions are computed like any other; the
// caller zeroes them.  None of the Mosaic workarounds of the TPU kernel are
// carried over (head indicator matmuls, bias feature column, transposed k/v,
// 128-lane padding).
//
// What bounds it on the H100: memory.  At U = 4096, L = 16 in bf16 it must
// read qkv (118 MB) and write the context (39 MB): 47 us at 3.35 TB/s,
// against 1.3 GFLOP of logits and weighted sums (1.3 us at the bf16 tensor
// rate).  The first version of this file (one block per sequence, k and v
// upcast to f32 in shared memory, one thread per (query row, head) running a
// serial FMA chain over the keys, hd-wide scattered q loads and output
// stores) ran 6-18x above that bound at the serving shapes, at nearly the
// same time in f32 and bf16: instruction- and latency-bound, not bytes-bound.
// This design aims at the bytes:
//
// * Several sequences per block, staged whole and coalesced.  The S
//   sequences of a block are one contiguous run of qkv (S * L * 3D values).
//   It is copied into shared memory as it lies, in the input type (bf16 is
//   not upcast), with 16-byte cp.async for the aligned body and byte copies
//   for the at most 15 bytes at either end; the shared copy starts at the
//   same address mod 16 as the source, so any L (odd L gives slabs that are
//   not 16-byte multiples) and any tensor offset take the same path.  S is
//   chosen on the host so that two blocks fit on an SM (L = 50 bf16: one
//   90 KB sequence a block; L = 16 bf16: three), and is cut for small U so
//   that the grid still gives every SM two blocks.  A block has 12 warps
//   (bf16, L <= 32), 8 warps (bf16, L > 32) or up to 1,024 threads (f32).
//   Inside a block the staging is not overlapped with compute; the other
//   block on the SM fills that time.  A persistent variant (one 16-warp
//   block per SM, a two-stage cp.async ring prefetching the next group while
//   the current one is computed) ran slower on the H100 (PERF.md, §6).
// * bf16: the two products on tensor cores with warp-level
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate).  One warp task is one
//   (sequence, head): the warp loads that head's k and v operand fragments
//   from the staged rows once, keeps them in registers, and runs every
//   16-row query tile against them.  wgmma is not used on purpose: its
//   64-row tiles would be mostly padding at L <= 64 per head, and its
//   operands would have to be re-laid out in shared memory; mma.sync reads
//   its fragments straight from the staged rows.  q.k^T runs at k = 16 or 32
//   (hd zero-padded), p.v at n = 8 * ceil(hd / 8) (hd = 20: three n8 tiles,
//   the last 4 columns dropped); keys are padded to a multiple of 16.
//   Rows past L are read clamped to the last row rather than guarded, and
//   the serving path's hd = 20 has instances with the head dimension fixed
//   and operand pairs read in one 4-byte load, to keep the instruction
//   count per task low.  L <= 64, so a whole logit row sits in the
//   accumulator fragments: the softmax is exact and two-pass in registers
//   (max and sum over the quad with shuffles, exp2 with log2(e) folded into
//   the scale).  Padded key positions (>= L) are excluded outright (p = 0),
//   so a fully masked row averages v over its L keys, not over the padded
//   width; masked keys inside L take -1e30 as in the reference.  p is
//   rounded to bf16 in registers and fed straight back as the A operand of
//   p.v.  That rounding costs about 2^-9 of each weight: at the serving
//   shapes the result stays within two bf16 steps of the plain version
//   (tolerance atol 2e-2 / rtol 1e-2).  Splitting p into bf16 hi + lo with
//   two p.v MMAs kept it within one step but cost 12% at L = 50 on the
//   H100, so it was left out.
// * f32: exact f32 FMAs on CUDA cores (TF32 would miss the 1e-5 tolerance),
//   one thread per (sequence, query row, head) with an online softmax over
//   the keys, reading q, k and v from the staged rows.
// * Output staged in shared memory, written with 16-byte stores.  Each task
//   writes its context over the q values it alone read (same rows, same head
//   columns), so no extra buffer is needed; after a barrier the block copies
//   its S * L context rows out.  A block's context is one contiguous run of
//   the output; where the staged q row and the output row agree mod 16 (any
//   D with 2 * D * sizeof(T) % 16 == 0 and allocator-aligned tensors, so
//   always on the serving path) the body moves in 16-byte loads and stores,
//   else element by element.
// * cudaFuncSetAttribute (dynamic shared memory above 48 KB) runs once per
//   kernel instance and device, not on every launch.
//
// Shared memory: a slab of S sequences takes 16 + S * L * 3D * sizeof(T)
// bytes, rounded up to 16.  An f32 block holds one slab plus its S * L mask
// bytes (rounded up to 16); a bf16 block holds one or two slabs and reads
// the mask bytes from global memory.  A shape whose single sequence, slab
// plus mask, does not fit one block's 232,448 bytes is refused, in either
// type (ops/mhsa.py::_check refuses it first).
//
// C entry point (bound with ctypes):
//   int nrl_mhsa_fwd(const void* qkv, const uint8_t* mask, void* out,
//                    int U, int L, int D, int H, int dtype, void* stream)
// qkv (U, L, 3D) and out (U, L, D) are contiguous, dtype 0 = float32,
// 1 = bfloat16; mask (U, L) is one byte per position, nonzero = valid key;
// L <= 64, D / H <= 32.  Launches on `stream`, does not synchronise,
// allocates nothing, and returns the cudaError_t of the launch (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskMin = -1e30f;
constexpr int kMaxLen = 64;
constexpr int kMaxHeadDim = 32;
constexpr int kSmemLimit = 232448;       // one block's dynamic shared memory
constexpr int kSmemTarget = 113 * 1024;  // per block, so that two fit on an SM
constexpr int kMaxDevices = 64;
// Warps of a bf16 block: 12 for up to two key tiles (L <= 32), 8 above,
// where a task holds more fragments (up to 128 registers a thread, with two
// blocks per SM).
__host__ __device__ constexpr int bf16_warps(int KT) { return KT <= 2 ? 12 : 8; }

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory of a block of S sequences: the slab (+ 16 bytes of
// alignment slack), then per sequence the L mask bytes (f32) or 64 key
// biases in f32 (bf16).
__host__ __device__ inline size_t slab_bytes(int S, int L, int D, int es) {
  return align16(16 + (size_t)S * L * 3 * D * es);
}
inline size_t smem_bytes(int S, int L, int D, int es) {
  return slab_bytes(S, L, D, es) + (es == 4 ? align16((size_t)S * L) : (size_t)S * kMaxLen * 4);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copy n bytes from global src to shared dst, where dst == src (mod 16):
// 16-byte cp.async for the aligned body, bytes for the ends; the copies are
// committed as one group.  The caller waits with cp_async_wait_all() and a
// barrier.
__device__ void stage(char* dst, const char* src, size_t n) {
  const size_t mis = (16 - ((uintptr_t)src & 15)) & 15;
  const size_t head_n = mis < n ? mis : n;
  const size_t nvec = (n - head_n) / 16;
  const size_t tail = head_n + nvec * 16;
  for (size_t i = threadIdx.x; i < nvec; i += blockDim.x)
    cp_async16(dst + head_n + 16 * i, src + head_n + 16 * i);
  asm volatile("cp.async.commit_group;\n" ::);
  for (size_t i = threadIdx.x; i < head_n; i += blockDim.x) dst[i] = src[i];
  for (size_t i = tail + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start staging the block's ns sequences (of S); returns where the slab
// will lie in shared memory (at the source's address mod 16).
template <typename T>
__device__ T* stage_slab(const T* qkv, int ns, int S, int L, int D, char* smem) {
  const char* src = reinterpret_cast<const char*>(qkv + (size_t)blockIdx.x * S * L * 3 * D);
  char* dst = smem + ((uintptr_t)src & 15);
  stage(dst, src, (size_t)ns * L * 3 * D * sizeof(T));
  return reinterpret_cast<T*>(dst);
}

// Copy `rows` rows of D values of T from shared memory (row stride 3D, the
// q columns of the staged slab) to the contiguous global `out`.  Each
// 16-byte slot of the output is one unit of work.
template <typename T>
__device__ void write_rows(T* out, const T* sq, int rows, int D) {
  const int row_bytes = D * (int)sizeof(T);
  const int slots = row_bytes / 16 + 2;  // 16-byte slots a row can touch
  for (int i = threadIdx.x; i < rows * slots; i += blockDim.x) {
    const int r = i / slots;
    const int j = i - r * slots;
    char* g = reinterpret_cast<char*>(out + (size_t)r * D);
    const char* s = reinterpret_cast<const char*>(sq + (size_t)r * 3 * D);
    const uintptr_t g0 = (uintptr_t)g;
    const uintptr_t lo_a = (g0 & ~uintptr_t(15)) + 16 * (uintptr_t)j;
    const uintptr_t lo = lo_a > g0 ? lo_a : g0;
    const uintptr_t hi_a = lo_a + 16;
    const uintptr_t hi = hi_a < g0 + row_bytes ? hi_a : g0 + row_bytes;
    if (lo >= hi) continue;
    const size_t off = lo - g0;
    if (hi - lo == 16 && (((uintptr_t)(s + off)) & 15) == 0) {
      *reinterpret_cast<uint4*>(g + off) = *reinterpret_cast<const uint4*>(s + off);
    } else {
      const T* se = reinterpret_cast<const T*>(s + off);
      T* ge = reinterpret_cast<T*>(g + off);
      for (size_t e = 0; e < (hi - lo) / sizeof(T); ++e) ge[e] = se[e];
    }
  }
}

// ---------------------------------------------------------------- bf16 ---

__device__ __forceinline__ uint32_t pack_bits(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values at s[off + d], s[off + d + 1] as one mma operand register
// (the lower index in the low half), zero where d >= hd.  PAIR: the pair is
// 4-byte aligned (even D and hd, aligned slab) and read in one load.
template <bool PAIR>
__device__ __forceinline__ uint32_t ld_pair(const unsigned short* s, int off, int d, int hd) {
  if (PAIR) return d < hd ? *reinterpret_cast<const uint32_t*>(s + off + d) : 0u;
  return pack_bits(d < hd ? s[off + d] : (unsigned short)0,
                   d + 1 < hd ? s[off + d + 1] : (unsigned short)0);
}

// One warp task: head h of the sequence whose staged rows start at `s` (bits
// of bf16, row stride 3D), all its query tiles of 16 rows.  The k and v
// fragments are loaded once and reused by every query tile.  `bias` holds
// the sequence's 64 key biases: 0 (valid), -1e30 (masked), -inf (past L).
// KT = key tiles of 16 (keys padded to 16 KT >= L); NT = n8 tiles of the
// head dimension (hd <= 8 NT); HDX = hd when fixed at compile time, else 0.
// Rows past L are read clamped to row L - 1 (real, finite data): padded
// keys then get p = 0 exactly, and padded query rows are never written.
// Fragment layouts of m16n8k16 (g = lane / 4, c = lane % 4): A a0 (g, 2c..),
// a1 (g+8, 2c..), a2 (g, 2c+8..), a3 (g+8, 2c+8..); B b0 (k = 2c.., n = g),
// b1 (k = 2c+8.., n = g); C c0..c1 (g, 2c..2c+1), c2..c3 (g+8, 2c..2c+1).
template <int KT, int NT, int HDX, bool PAIR>
__device__ __forceinline__ void bf16_head(unsigned short* s, const float* bias, int h, int L,
                                          int D, int hd_rt, float scale_log2) {
  constexpr int HK = (NT * 8 + 15) / 16;  // k16 steps of q.k^T over the head dim
  constexpr int NJ = 2 * KT;              // n8 tiles of keys
  const int hd = HDX > 0 ? HDX : hd_rt;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int D3 = 3 * D;
  const int qcol = h * hd, kcol = D + qcol, vcol = 2 * D + qcol;
  const bool last_on = (NJ - 1) * 8 < L;  // else the last key tile is all padding

  uint32_t kb[NJ][HK][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int off = min(j * 8 + g, L - 1) * D3 + kcol;
#pragma unroll
    for (int ks = 0; ks < HK; ++ks) {
      kb[j][ks][0] = ld_pair<PAIR>(s, off, ks * 16 + 2 * c, hd);
      kb[j][ks][1] = ld_pair<PAIR>(s, off, ks * 16 + 2 * c + 8, hd);
    }
  }
  uint32_t vb[KT][NT][2];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * 16 + 2 * c;
    const int o0 = min(k0, L - 1) * D3 + vcol, o1 = min(k0 + 1, L - 1) * D3 + vcol;
    const int o8 = min(k0 + 8, L - 1) * D3 + vcol, o9 = min(k0 + 9, L - 1) * D3 + vcol;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = nt * 8 + g;
      const bool ok = d < hd;
      vb[kt][nt][0] = ok ? pack_bits(s[o0 + d], s[o1 + d]) : 0u;
      vb[kt][nt][1] = ok ? pack_bits(s[o8 + d], s[o9 + d]) : 0u;
    }
  }

  const int mts = (L + 15) / 16;
  for (int mt = 0; mt < mts; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int q0 = min(r0, L - 1) * D3 + qcol, q1 = min(r1, L - 1) * D3 + qcol;
    uint32_t qa[HK][4];
#pragma unroll
    for (int ks = 0; ks < HK; ++ks) {
      const int d = ks * 16 + 2 * c;
      qa[ks][0] = ld_pair<PAIR>(s, q0, d, hd);
      qa[ks][1] = ld_pair<PAIR>(s, q1, d, hd);
      qa[ks][2] = ld_pair<PAIR>(s, q0, d + 8, hd);
      qa[ks][3] = ld_pair<PAIR>(s, q1, d + 8, hd);
    }
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if (j < NJ - 1 || last_on) {
#pragma unroll
        for (int ks = 0; ks < HK; ++ks) mma_bf16(sc[j], qa[ks], kb[j][ks][0], kb[j][ks][1]);
      }
    }

    // Exact softmax in registers, in log2 units (scale_log2 = log2(e) /
    // sqrt(hd)): x = s * scale + bias is the logit, -1e30 at a masked key
    // (|s * scale| is far below half an ulp of 1e30) and -inf past L, so
    // that 2^(x - max) is 0 there and a fully masked row is uniform over L.
    // Rows g + 8 of the tile are all padding when 16 mt + 8 >= L (L = 50:
    // rows 56..63): their softmax is skipped, as is the all-padding last
    // key tile; p is 0 there.
    const bool r1_on = r0 - g + 8 < L;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < NJ - 1 || last_on) {
        const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * c);
        sc[j][0] = fmaf(sc[j][0], scale_log2, b.x);
        sc[j][1] = fmaf(sc[j][1], scale_log2, b.y);
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        if (r1_on) {
          sc[j][2] = fmaf(sc[j][2], scale_log2, b.x);
          sc[j][3] = fmaf(sc[j][3], scale_log2, b.y);
          mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool on = j < NJ - 1 || last_on;
      sc[j][0] = on ? ex2(sc[j][0] - mx0) : 0.f;
      sc[j][1] = on ? ex2(sc[j][1] - mx0) : 0.f;
      sc[j][2] = on && r1_on ? ex2(sc[j][2] - mx1) : 0.f;
      sc[j][3] = on && r1_on ? ex2(sc[j][3] - mx1) : 0.f;
      sum0 += sc[j][0] + sc[j][1];
      sum1 += sc[j][2] + sc[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }

    // p.v with p rounded to bf16, straight from the accumulators as the A
    // operand.
    float oc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) oc[nt][0] = oc[nt][1] = oc[nt][2] = oc[nt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t pa[4] = {pack_f32(sc[2 * kt][0], sc[2 * kt][1]),           // a0: row g
                              pack_f32(sc[2 * kt][2], sc[2 * kt][3]),           // a1: row g+8
                              pack_f32(sc[2 * kt + 1][0], sc[2 * kt + 1][1]),   // a2: row g
                              pack_f32(sc[2 * kt + 1][2], sc[2 * kt + 1][3])};  // a3: row g+8
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(oc[nt], pa, vb[kt][nt][0], vb[kt][nt][1]);
    }

    // The context goes over this task's own q values (same rows, same
    // columns), after the q fragments of this tile were read.
    // Sums >= 1 (the max term is 2^0); sum1 is 0 only where rows g + 8 are
    // padding, which are not written.
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = nt * 8 + 2 * c;
      if (PAIR) {
        if (d < hd) {
          if (r0 < L)
            *reinterpret_cast<uint32_t*>(s + q0 + d) = pack_f32(oc[nt][0] * inv0, oc[nt][1] * inv0);
          if (r1 < L)
            *reinterpret_cast<uint32_t*>(s + q1 + d) = pack_f32(oc[nt][2] * inv1, oc[nt][3] * inv1);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (d + e < hd) {
            if (r0 < L) s[q0 + d + e] = __bfloat16_as_ushort(__float2bfloat16_rn(oc[nt][e] * inv0));
            if (r1 < L)
              s[q1 + d + e] = __bfloat16_as_ushort(__float2bfloat16_rn(oc[nt][2 + e] * inv1));
          }
        }
      }
    }
  }
}

template <int KT, int NT, int HDX, bool PAIR>
__global__ void __launch_bounds__(bf16_warps(KT) * 32, 2)
    mhsa_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, int U, int L, int D, int H, int S,
                     float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  const int ns = min(S, U - (int)blockIdx.x * S);
  __nv_bfloat16* slab = stage_slab(qkv, ns, S, L, D, smem);
  float* sbias = reinterpret_cast<float*>(smem + slab_bytes(S, L, D, 2));
  const uint8_t* msk = mask + (size_t)blockIdx.x * S * L;
  for (int i = threadIdx.x; i < ns * kMaxLen; i += blockDim.x) {
    const int sq = i / kMaxLen, key = i - sq * kMaxLen;
    sbias[i] = key < L ? (msk[sq * L + key] ? 0.f : kMaskMin) : -INFINITY;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  unsigned short* bits = reinterpret_cast<unsigned short*>(slab);
  for (int t = warp; t < ns * H; t += nwarps) {
    const int sq = t / H;
    bf16_head<KT, NT, HDX, PAIR>(bits + (size_t)sq * L * 3 * D, sbias + sq * kMaxLen, t - sq * H,
                                 L, D, D / H, scale_log2);
  }
  __syncthreads();
  write_rows(out + (size_t)blockIdx.x * S * L * D, slab, ns * L, D);
}

// ----------------------------------------------------------------- f32 ---

// HD is the register capacity for one head's q and accumulator; EXACT says
// that the head dimension equals it, so that the loops need no guard.
template <int HD, bool EXACT>
__global__ void __launch_bounds__(1024)
    mhsa_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int U, int L, int D, int H, int S, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int ns = min(S, U - (int)blockIdx.x * S);
  float* slab = stage_slab(qkv, ns, S, L, D, smem);
  uint8_t* smask = reinterpret_cast<uint8_t*>(smem + slab_bytes(S, L, D, 4));
  for (int i = threadIdx.x; i < ns * L; i += blockDim.x)
    smask[i] = mask[(size_t)blockIdx.x * S * L + i];
  cp_async_wait_all();
  __syncthreads();

  const int hd = EXACT ? HD : D / H;
  const int D3 = 3 * D;
  for (int t = threadIdx.x; t < ns * L * H; t += blockDim.x) {
    const int row = t / H;  // row of the block: sequence row / L, query row % L
    const int h = t - row * H;
    const int sq = row / L;
    const int off = h * hd;
    float* qrow = slab + (size_t)row * D3 + off;
    const float* kbase = slab + (size_t)sq * L * D3 + D + off;
    const float* vbase = kbase + D;
    const uint8_t* msk = smask + sq * L;

    float q[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) q[j] = j < hd ? qrow[j] : 0.f;
    float acc[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) acc[j] = 0.f;
    float m_run = kMaskMin;
    float l_run = 0.f;
    for (int m = 0; m < L; ++m) {
      const float* kr = kbase + (size_t)m * D3;
      float sdot = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j)
        if (j < hd) sdot = fmaf(q[j], kr[j], sdot);
      sdot = msk[m] ? sdot * scale : kMaskMin;
      const float m_new = fmaxf(m_run, sdot);
      const float alpha = expf(m_run - m_new);
      const float p = expf(sdot - m_new);
      l_run = l_run * alpha + p;
      const float* vr = vbase + (size_t)m * D3;
#pragma unroll
      for (int j = 0; j < HD; ++j)
        if (j < hd) acc[j] = fmaf(acc[j], alpha, p * vr[j]);
      m_run = m_new;
    }
    const float inv = 1.f / l_run;  // l_run >= 1: the running max term is exp(0)
#pragma unroll
    for (int j = 0; j < HD; ++j)
      if (j < hd) qrow[j] = acc[j] * inv;  // over this thread's own q values
  }
  __syncthreads();
  write_rows(out + (size_t)blockIdx.x * S * L * D, slab, ns * L, D);
}

// ---------------------------------------------------------------- host ---

int num_sms(int dev) {
  static int sms[kMaxDevices] = {0};
  if (dev < 0 || dev >= kMaxDevices) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    sms[dev] = n;
  }
  return sms[dev];
}

// Lets `kernel` use all of a block's shared memory, once per device: `done`
// is the calling kernel instance's own record.
template <typename K>
cudaError_t allow_smem(K kernel, int dev, bool (&done)[kMaxDevices]) {
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

struct Launch {
  int S;
  int blocks;
  size_t smem;
};

// Sequences per block: as many as fit kSmemTarget (two blocks per SM), at
// least one, and no more than leave two blocks per SM over the grid.
Launch plan(int U, int L, int D, int es, int dev) {
  int S = 1;
  while (S < U && smem_bytes(S + 1, L, D, es) <= (size_t)kSmemTarget) ++S;
  const int cap = U / (2 * num_sms(dev));
  if (S > cap) S = cap > 1 ? cap : 1;
  return Launch{S, (U + S - 1) / S, smem_bytes(S, L, D, es)};
}

template <int KT, int NT, int HDX, bool PAIR>
cudaError_t launch_bf16_inst(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                             int H, int dev, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_bf16_kernel<KT, NT, HDX, PAIR>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const Launch p = plan(U, L, D, 2, dev);
  const int tasks = p.S * H;
  const int warps = tasks < bf16_warps(KT) ? tasks : bf16_warps(KT);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)(D / H));
  kernel<<<p.blocks, warps * 32, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<__nv_bfloat16*>(out), U, L, D,
      H, p.S, scale_log2);
  return cudaGetLastError();
}

// The serving path's hd = 20 on a 4-byte aligned qkv has its own instances
// (head dimension known at compile time, operand pairs read in one load);
// any other head dimension <= 32 or alignment runs in a generic instance.
template <int KT>
cudaError_t launch_bf16_kt(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                           int H, int dev, cudaStream_t stream) {
  const int hd = D / H;
  if (hd == 20 && ((uintptr_t)qkv & 3) == 0)
    return launch_bf16_inst<KT, 3, 20, true>(qkv, mask, out, U, L, D, H, dev, stream);
  switch ((hd + 7) / 8) {
    case 1: return launch_bf16_inst<KT, 1, 0, false>(qkv, mask, out, U, L, D, H, dev, stream);
    case 2: return launch_bf16_inst<KT, 2, 0, false>(qkv, mask, out, U, L, D, H, dev, stream);
    case 3: return launch_bf16_inst<KT, 3, 0, false>(qkv, mask, out, U, L, D, H, dev, stream);
    default: return launch_bf16_inst<KT, 4, 0, false>(qkv, mask, out, U, L, D, H, dev, stream);
  }
}

cudaError_t launch_bf16(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                        int H, int dev, cudaStream_t stream) {
  switch ((L + 15) / 16) {
    case 1: return launch_bf16_kt<1>(qkv, mask, out, U, L, D, H, dev, stream);
    case 2: return launch_bf16_kt<2>(qkv, mask, out, U, L, D, H, dev, stream);
    case 3: return launch_bf16_kt<3>(qkv, mask, out, U, L, D, H, dev, stream);
    default: return launch_bf16_kt<4>(qkv, mask, out, U, L, D, H, dev, stream);
  }
}

template <int HD, bool EXACT>
cudaError_t launch_f32_hd(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                          int H, int dev, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_f32_kernel<HD, EXACT>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const Launch p = plan(U, L, D, 4, dev);
  int threads = ((p.S * L * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const float scale = 1.f / sqrtf((float)(D / H));
  kernel<<<p.blocks, threads, p.smem, stream>>>(static_cast<const float*>(qkv), mask,
                                                static_cast<float*>(out), U, L, D, H, p.S, scale);
  return cudaGetLastError();
}

// The head dimension sets the register arrays' size at compile time: the
// main path's hd = 20 has its own exact instance, any other hd <= 32 runs in
// the next capacity up with guarded loops.
cudaError_t launch_f32(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                       int H, int dev, cudaStream_t stream) {
  const int hd = D / H;
  if (hd == 20) return launch_f32_hd<20, true>(qkv, mask, out, U, L, D, H, dev, stream);
  if (hd <= 8) return launch_f32_hd<8, false>(qkv, mask, out, U, L, D, H, dev, stream);
  if (hd <= 16) return launch_f32_hd<16, false>(qkv, mask, out, U, L, D, H, dev, stream);
  return launch_f32_hd<32, false>(qkv, mask, out, U, L, D, H, dev, stream);
}

}  // namespace

extern "C" int nrl_mhsa_fwd(const void* qkv, const uint8_t* mask, void* out, int U, int L,
                            int D, int H, int dtype, void* stream) {
  if (U <= 0 || L <= 0 || L > kMaxLen || H <= 0 || D % H != 0 || D / H > kMaxHeadDim ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  if (smem_bytes(1, L, D, es) > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(qkv, mask, out, U, L, D, H, dev, s);
  return (int)launch_bf16(qkv, mask, out, U, L, D, H, dev, s);
}
