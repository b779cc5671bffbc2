// Masked multi-head self-attention over many short independent sequences,
// forward and backward: the attention of the NRMS title encoder (L = 16 /
// 30) and of its user encoder (L = 50), at D = 300, H = 15, hd = 20.  The
// forward is described first; the backward (nrl_mhsa_bwd) after it.
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
//
// Backward.  The TPU kernel has none: the JAX package trains through XLA
// autodiff of mhsa_reference, and this computes that gradient (what
// ops/mhsa.py::mhsa_backward computes in plain PyTorch).  Per (sequence,
// head), with s = 1 / sqrt(hd): P = softmax(s q.k^T) recomputed exactly
// (masked keys -1e30, keys past L excluded), dP = dO V^T,
// dS = P (dP - rowsum(dP P)) and 0 at masked keys, dQ = s dS K,
// dK = s dS^T Q, dV = P^T dO.  A fully masked sequence gets dQ = dK = 0 and
// dV = the mean of dO over its L rows.  L <= 64, so a whole logit row sits
// in registers and the row sums come from P and dP directly: the forward
// saves nothing (no output, no logsumexp) for it.
//
// What bounds it on the H100: memory again.  At U = 7168, L = 16 in bf16 it
// reads qkv (206 MB), dO (69 MB) and the mask and writes dqkv (206 MB):
// 0.144 ms at 3.35 TB/s, against 5.5 GFLOP of products (6 us on the
// tensor cores).  The plain version (mhsa_backward) runs about 30 kernels
// over f32 (U, H, L, L) tensors (4.8 ms there).  The design:
//
// * The forward's staging and plan: the same S sequences per block and the
//   same shared memory (slab + mask bytes or key biases), so that every
//   shape the forward takes, the backward takes.  dO is not staged: each
//   warp reads its head's columns of dO from global memory (through L1),
//   which leaves the slab the whole of a block's shared memory (f32 at
//   (64, 50) would need 240,016 bytes with dO staged).  Blocks of 8 warps.
// * One warp task per (sequence, head).  bf16: the five products on tensor
//   cores (mma.sync m16n8k16, bf16 in, f32 sums).  Per 16-row query tile:
//   q.k^T and dO.v^T, the exact softmax of the forward (then normalised),
//   the row sums of dP * P over the quad, dS in registers, dQ = dS K; then
//   dV += P^T dO and dK += dS^T Q into accumulators for all key rows, kept
//   in registers across the query tiles.  P^T and dS^T, which the last two
//   products need as A operands with keys as rows, come from the
//   accumulator fragments of P and dS rounded to bf16 and transposed in
//   registers (movmatrix.m8n8.trans, four per 16 x 16 tile), so neither P
//   nor dS is written to shared or global memory, and no product is spent
//   on recomputing the transposed logits.  P and dS are rounded to bf16
//   only as those operands; P goes into dV = P^T dO as a bf16 hi + lo pair
//   (two products), since one rounding moved dV by two bf16 steps of the
//   plain version, past the tolerance, where one key takes most of the
//   attention of many queries.  dO rows past L read as 0, so the clamped
//   query rows of a padded tile add nothing.  L = 50 (KT = 4) instances
//   keep 96 accumulator registers and run one 8-warp block per SM.
// * f32: exact f32 FMAs on CUDA cores (TF32 would miss 1e-5).  One warp a
//   task, lane j owns keys j and j + 32: per query row the logits, the
//   softmax by warp shuffles, dP, the row sum and dS; dK and dV accumulate
//   in the lane's registers; dQ is summed by lane d over the keys with dS
//   broadcast by shuffles.
// * Each task writes dQ over its own staged q values (after the tile's
//   last read of them) and dK, dV over its k and v values (after the last
//   tile); after a barrier the block copies its whole staged slab, now
//   dqkv, to the output in one coalesced run.  No atomics: each output
//   value is written by one lane, so the gradient is the same bits from
//   run to run.
//
//   int nrl_mhsa_bwd(const void* qkv, const uint8_t* mask, const void* dout,
//                    void* dqkv, int U, int L, int D, int H, int dtype,
//                    void* stream)
// qkv (U, L, 3D), dout (U, L, D) and dqkv (U, L, 3D) contiguous in the
// input type; the rest as nrl_mhsa_fwd.

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

// Exact softmax numerators of one 16-row tile in registers, in log2 units
// (scale_log2 = log2(e) / sqrt(hd)): x = s * scale + bias is the logit,
// -1e30 at a masked key (|s * scale| is far below half an ulp of 1e30) and
// -inf past L, so that 2^(x - max) is 0 there and a fully masked row is
// uniform over L.  sc holds the q.k^T accumulators of the tile (rows g and
// g + 8, NJ n8 tiles of keys) and gets the numerators; sum0 and sum1 get
// the row sums, over the quad.  Rows g + 8 of the tile are all padding when
// r1_on is false (16 mt + 8 >= L; L = 50: rows 56..63): their softmax is
// skipped, as is the all-padding last key tile (last_on false); p is 0
// there.
template <int NJ>
__device__ __forceinline__ void softmax_tile(float (&sc)[NJ][4], const float* bias,
                                             float scale_log2, bool last_on, bool r1_on,
                                             float& sum0, float& sum1) {
  const int c = threadIdx.x & 3;
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
  sum0 = 0.f;
  sum1 = 0.f;
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

    const bool r1_on = r0 - g + 8 < L;
    float sum0, sum1;
    softmax_tile(sc, bias, scale_log2, last_on, r1_on, sum0, sum1);

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

// ------------------------------------------------------------ backward ---

// Warps of a backward block: one (sequence, head) task each.
constexpr int kBwdWarps = 8;

// The 8x8 transpose of a matrix of 16-bit values held one 32-bit pair a
// lane (row lane / 4, columns 2 (lane % 4) and 2 (lane % 4) + 1, as in the
// mma fragments), in registers.
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// x, y as a bf16 pair hi (as pack_f32) and the pair lo of what hi leaves
// over, so that hi + lo carries about 16 bits of each.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_f32(x, y);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_f32(x - __low2float(h), y - __high2float(h));
}

// x, y as bf16 at s[off + d], s[off + d + 1], each only where its column is
// below hd.
template <bool PAIR>
__device__ __forceinline__ void st_pair(unsigned short* s, int off, int d, int hd, float x,
                                        float y) {
  if (PAIR) {
    if (d < hd) *reinterpret_cast<uint32_t*>(s + off + d) = pack_f32(x, y);
  } else {
    if (d < hd) s[off + d] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    if (d + 1 < hd) s[off + d + 1] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
  }
}

// One backward warp task, bf16: head h of the sequence whose staged rows
// start at `s`, with its output gradient `dout` (global, rows of D).  Per
// query tile of 16 rows it recomputes the logits and the exact softmax as
// the forward does, adds the tile's share of dV = P^T dO, then computes
// dP = dO V^T, the row sums of dP * P, dS and the tile's dQ = scale dS K,
// and adds the tile's share of dK = scale dS^T Q.  dV and dK accumulate
// over the query tiles for all key rows.  P^T and dS^T, the A operands with
// keys as rows, are the accumulator fragments of P (as bf16 hi + lo) and
// dS (bf16) transposed in registers (movmatrix, four per 16 x 16 tile).
// dO rows past L are read as 0, so the clamped query rows of the last tile
// add nothing to dK and dV.  dQ goes over the tile's own q values once they
// are read; dK and dV over the k and v values after the last tile.
template <int KT, int NT, int HDX, bool PAIR>
__device__ __forceinline__ void bf16_bwd_head(unsigned short* s, const float* bias,
                                              const unsigned short* dout, int h, int L, int D,
                                              int hd_rt, float scale_log2, float scale) {
  constexpr int HK = (NT * 8 + 15) / 16;
  constexpr int NJ = 2 * KT;
  const int hd = HDX > 0 ? HDX : hd_rt;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int D3 = 3 * D;
  const int qcol = h * hd, kcol = D + qcol, vcol = 2 * D + qcol;
  const bool last_on = (NJ - 1) * 8 < L;

  float dk[KT][NT][4], dv[KT][NT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[kt][nt][e] = dv[kt][nt][e] = 0.f;

  const int mts = (L + 15) / 16;
  for (int mt = 0; mt < mts; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int q0 = min(r0, L - 1) * D3 + qcol, q1 = min(r1, L - 1) * D3 + qcol;
    const bool in0 = r0 < L, in1 = r1 < L;

    // p = softmax(q.k^T scale), exactly as the forward computes it, then
    // normalised (queries as rows).
    float p[NJ][4];
    {
      uint32_t qa[HK][4];
#pragma unroll
      for (int ks = 0; ks < HK; ++ks) {
        const int d = ks * 16 + 2 * c;
        qa[ks][0] = ld_pair<PAIR>(s, q0, d, hd);
        qa[ks][1] = ld_pair<PAIR>(s, q1, d, hd);
        qa[ks][2] = ld_pair<PAIR>(s, q0, d + 8, hd);
        qa[ks][3] = ld_pair<PAIR>(s, q1, d + 8, hd);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
        if (j < NJ - 1 || last_on) {
          const int off = min(j * 8 + g, L - 1) * D3 + kcol;
#pragma unroll
          for (int ks = 0; ks < HK; ++ks)
            mma_bf16(p[j], qa[ks], ld_pair<PAIR>(s, off, ks * 16 + 2 * c, hd),
                     ld_pair<PAIR>(s, off, ks * 16 + 2 * c + 8, hd));
        }
      }
    }
    const bool r1_on = mt * 16 + 8 < L;
    float sum0, sum1;
    softmax_tile(p, bias, scale_log2, last_on, r1_on, sum0, sum1);
    const float inv0 = 1.f / sum0, inv1 = r1_on ? 1.f / sum1 : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      p[j][0] *= inv0;
      p[j][1] *= inv0;
      p[j][2] *= inv1;
      p[j][3] *= inv1;
    }

    // dV += P^T dO over this tile's queries (B: k = query, n = head column;
    // dO rows past L read as 0).  P goes in as bf16 hi + lo parts, two
    // products: one bf16 rounding of P (2^-9 of each weight) moved dV by
    // two bf16 steps of the plain version where a key takes most of the
    // attention of many queries.
    {
      const int k0 = mt * 16 + 2 * c;
      uint32_t ob[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + g;
        const bool ok = d < hd;
        const unsigned short* dc = dout + qcol + d;
        ob[nt][0] = pack_bits(ok && k0 < L ? dc[k0 * D] : (unsigned short)0,
                              ok && k0 + 1 < L ? dc[(k0 + 1) * D] : (unsigned short)0);
        ob[nt][1] = pack_bits(ok && k0 + 8 < L ? dc[(k0 + 8) * D] : (unsigned short)0,
                              ok && k0 + 9 < L ? dc[(k0 + 9) * D] : (unsigned short)0);
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t hi[4], lo[4];
        split_bf16(p[2 * kt][0], p[2 * kt][1], hi[0], lo[0]);
        split_bf16(p[2 * kt][2], p[2 * kt][3], hi[1], lo[1]);
        split_bf16(p[2 * kt + 1][0], p[2 * kt + 1][1], hi[2], lo[2]);
        split_bf16(p[2 * kt + 1][2], p[2 * kt + 1][3], hi[3], lo[3]);
        // A = P^T: rows keys kt*16 + (g, g + 8), k = queries (2c, 2c + 8)
        const uint32_t th[4] = {transpose8(hi[0]), transpose8(hi[2]), transpose8(hi[1]),
                                transpose8(hi[3])};
        const uint32_t tl[4] = {transpose8(lo[0]), transpose8(lo[2]), transpose8(lo[1]),
                                transpose8(lo[3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(dv[kt][nt], th, ob[nt][0], ob[nt][1]);
          mma_bf16(dv[kt][nt], tl, ob[nt][0], ob[nt][1]);
        }
      }
    }

    // dp = dO V^T (queries as rows; dO rows past L read as 0).
    float dp[NJ][4];
    {
      uint32_t oa[HK][4];
#pragma unroll
      for (int ks = 0; ks < HK; ++ks) {
        const int d = ks * 16 + 2 * c;
        oa[ks][0] = in0 ? ld_pair<PAIR>(dout, r0 * D + qcol, d, hd) : 0u;
        oa[ks][1] = in1 ? ld_pair<PAIR>(dout, r1 * D + qcol, d, hd) : 0u;
        oa[ks][2] = in0 ? ld_pair<PAIR>(dout, r0 * D + qcol, d + 8, hd) : 0u;
        oa[ks][3] = in1 ? ld_pair<PAIR>(dout, r1 * D + qcol, d + 8, hd) : 0u;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        if (j < NJ - 1 || last_on) {
          const int off = min(j * 8 + g, L - 1) * D3 + vcol;
#pragma unroll
          for (int ks = 0; ks < HK; ++ks)
            mma_bf16(dp[j], oa[ks], ld_pair<PAIR>(s, off, ks * 16 + 2 * c, hd),
                     ld_pair<PAIR>(s, off, ks * 16 + 2 * c + 8, hd));
        }
      }
    }

    // ds = p (dp - rowsum(dp p)) at valid keys, 0 at masked and padded ones,
    // rounded to bf16 as the A operand (queries as rows).
    float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dd0 += p[j][0] * dp[j][0] + p[j][1] * dp[j][1];
      dd1 += p[j][2] * dp[j][2] + p[j][3] * dp[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      dd0 += __shfl_xor_sync(0xffffffffu, dd0, o);
      dd1 += __shfl_xor_sync(0xffffffffu, dd1, o);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * c);
      dp[j][0] = b.x == 0.f ? p[j][0] * (dp[j][0] - dd0) : 0.f;
      dp[j][1] = b.y == 0.f ? p[j][1] * (dp[j][1] - dd0) : 0.f;
      dp[j][2] = b.x == 0.f ? p[j][2] * (dp[j][2] - dd1) : 0.f;
      dp[j][3] = b.y == 0.f ? p[j][3] * (dp[j][3] - dd1) : 0.f;
    }
    uint32_t sa[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      sa[kt][0] = pack_f32(dp[2 * kt][0], dp[2 * kt][1]);
      sa[kt][1] = pack_f32(dp[2 * kt][2], dp[2 * kt][3]);
      sa[kt][2] = pack_f32(dp[2 * kt + 1][0], dp[2 * kt + 1][1]);
      sa[kt][3] = pack_f32(dp[2 * kt + 1][2], dp[2 * kt + 1][3]);
    }

    // dQ = ds K (B: k = key, n = head column; padded keys have ds = 0).
    float dq[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int k0 = kt * 16 + 2 * c;
      const int o0 = min(k0, L - 1) * D3 + kcol, o1 = min(k0 + 1, L - 1) * D3 + kcol;
      const int o8 = min(k0 + 8, L - 1) * D3 + kcol, o9 = min(k0 + 9, L - 1) * D3 + kcol;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + g;
        const bool ok = d < hd;
        mma_bf16(dq[nt], sa[kt], ok ? pack_bits(s[o0 + d], s[o1 + d]) : 0u,
                 ok ? pack_bits(s[o8 + d], s[o9 + d]) : 0u);
      }
    }

    // dK += ds^T Q over this tile's queries (B: k = query, n = head column;
    // the clamped rows past L have ds = 0).
    {
      const int k0 = mt * 16 + 2 * c;
      const int o0 = min(k0, L - 1) * D3 + qcol, o1 = min(k0 + 1, L - 1) * D3 + qcol;
      const int o8 = min(k0 + 8, L - 1) * D3 + qcol, o9 = min(k0 + 9, L - 1) * D3 + qcol;
      uint32_t qb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + g;
        const bool ok = d < hd;
        qb[nt][0] = ok ? pack_bits(s[o0 + d], s[o1 + d]) : 0u;
        qb[nt][1] = ok ? pack_bits(s[o8 + d], s[o9 + d]) : 0u;
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t st[4] = {transpose8(sa[kt][0]), transpose8(sa[kt][2]),
                                transpose8(sa[kt][1]), transpose8(sa[kt][3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(dk[kt][nt], st, qb[nt][0], qb[nt][1]);
      }
    }

    // Every lane has read this tile's q values: dQ goes over them.
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = nt * 8 + 2 * c;
      if (in0) st_pair<PAIR>(s, q0, d, hd, dq[nt][0] * scale, dq[nt][1] * scale);
      if (in1) st_pair<PAIR>(s, q1, d, hd, dq[nt][2] * scale, dq[nt][3] * scale);
    }
  }

  // Every lane has read its last k and v values: dK and dV go over them.
  __syncwarp();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * 16 + g, k1 = k0 + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = nt * 8 + 2 * c;
      if (k0 < L) {
        st_pair<PAIR>(s, k0 * D3 + kcol, d, hd, dk[kt][nt][0] * scale, dk[kt][nt][1] * scale);
        st_pair<PAIR>(s, k0 * D3 + vcol, d, hd, dv[kt][nt][0], dv[kt][nt][1]);
      }
      if (k1 < L) {
        st_pair<PAIR>(s, k1 * D3 + kcol, d, hd, dk[kt][nt][2] * scale, dk[kt][nt][3] * scale);
        st_pair<PAIR>(s, k1 * D3 + vcol, d, hd, dv[kt][nt][2], dv[kt][nt][3]);
      }
    }
  }
}

template <int KT, int NT, int HDX, bool PAIR>
__global__ void __launch_bounds__(kBwdWarps * 32, KT <= 2 ? 2 : 1)
    mhsa_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
                         int U, int L, int D, int H, int S, float scale_log2, float scale) {
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
  const unsigned short* go = reinterpret_cast<const unsigned short*>(dout);
  for (int t = warp; t < ns * H; t += nwarps) {
    const int sq = t / H;
    bf16_bwd_head<KT, NT, HDX, PAIR>(bits + (size_t)sq * L * 3 * D, sbias + sq * kMaxLen,
                                     go + ((size_t)blockIdx.x * S + sq) * L * D, t - sq * H, L,
                                     D, D / H, scale_log2, scale);
  }
  __syncthreads();
  // The block's dqkv rows are one contiguous run laid out as its staged slab.
  write_rows(dqkv + (size_t)blockIdx.x * S * L * 3 * D, slab, 1, ns * L * 3 * D);
}

// One backward warp task, f32, on CUDA cores: lane j holds keys j and
// j + 32 (KPL = 2 where L > 32).  Per query row i: the logits of its keys,
// the exact softmax by warp shuffles, dP_ij = dO_i . V_j, the row sum of
// dP * P, ds_ij; dK_j and dV_j accumulate in the lane's registers, and
// dQ_i = scale sum_j ds_ij K_j is summed by lane d over the keys (ds
// broadcast by shuffles) and goes over q_i.  dO_i is read once from global
// memory, one column a lane, and broadcast by shuffles.
template <int HD, bool EXACT, int KPL>
__device__ __forceinline__ void f32_bwd_head(float* s, const uint8_t* msk, const float* dout,
                                             int h, int L, int D, int hd_rt, float scale) {
  const int hd = EXACT ? HD : hd_rt;
  const int lane = threadIdx.x & 31;
  const int D3 = 3 * D;
  const int qcol = h * hd, kcol = D + qcol, vcol = 2 * D + qcol;
  const int dl = min(lane, hd - 1);

  int jr[KPL];
  bool jin[KPL], jvalid[KPL];
  float dk[KPL][HD], dv[KPL][HD];
#pragma unroll
  for (int kk = 0; kk < KPL; ++kk) {
    const int j = lane + 32 * kk;
    jin[kk] = j < L;
    jr[kk] = min(j, L - 1);
    jvalid[kk] = jin[kk] && msk[jr[kk]];
#pragma unroll
    for (int d = 0; d < HD; ++d) dk[kk][d] = dv[kk][d] = 0.f;
  }

  for (int i = 0; i < L; ++i) {
    float* qi = s + (size_t)i * D3 + qcol;
    const float dov = lane < hd ? dout[(size_t)i * D + qcol + lane] : 0.f;
    float x[KPL], dp[KPL];
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const float* kr = s + (size_t)jr[kk] * D3 + kcol;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d)
        if (d < hd) dot = fmaf(qi[d], kr[d], dot);
      x[kk] = !jin[kk] ? -INFINITY : (msk[jr[kk]] ? dot * scale : kMaskMin);
      dp[kk] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      if (d < hd) {
        const float o = __shfl_sync(0xffffffffu, dov, d);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) dp[kk] = fmaf(o, s[(size_t)jr[kk] * D3 + vcol + d], dp[kk]);
      }
    }
    float mx = x[0];
#pragma unroll
    for (int kk = 1; kk < KPL; ++kk) mx = fmaxf(mx, x[kk]);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float p[KPL], sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      p[kk] = expf(x[kk] - mx);  // 0 past L
      sum += p[kk];
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;  // sum >= 1: the max term is exp(0)
    float rs = 0.f;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      p[kk] *= inv;
      rs += p[kk] * dp[kk];
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
    float ds[KPL];
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) ds[kk] = jvalid[kk] ? p[kk] * (dp[kk] - rs) : 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      if (d < hd) {
        const float qd = qi[d];
        const float o = __shfl_sync(0xffffffffu, dov, d);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          dk[kk][d] = fmaf(ds[kk], qd, dk[kk][d]);
          dv[kk][d] = fmaf(p[kk], o, dv[kk][d]);
        }
      }
    }
    float acc = 0.f;
    const int l0 = min(L, 32);
    for (int j = 0; j < l0; ++j)
      acc = fmaf(__shfl_sync(0xffffffffu, ds[0], j), s[(size_t)j * D3 + kcol + dl], acc);
    if (KPL > 1) {
      for (int j = 32; j < L; ++j)
        acc = fmaf(__shfl_sync(0xffffffffu, ds[KPL - 1], j - 32), s[(size_t)j * D3 + kcol + dl],
                   acc);
    }
    __syncwarp();  // every lane has read q_i
    if (lane < hd) qi[lane] = acc * scale;
  }
  __syncwarp();  // every lane has read its last k and v values
#pragma unroll
  for (int kk = 0; kk < KPL; ++kk) {
    if (!jin[kk]) continue;
    float* kr = s + (size_t)jr[kk] * D3 + kcol;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      if (d < hd) {
        kr[d] = dk[kk][d] * scale;
        kr[D + d] = dv[kk][d];
      }
    }
  }
}

template <int HD, bool EXACT, int KPL>
__global__ void __launch_bounds__(kBwdWarps * 32)
    mhsa_bwd_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        const float* __restrict__ dout, float* __restrict__ dqkv, int U, int L,
                        int D, int H, int S, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int ns = min(S, U - (int)blockIdx.x * S);
  float* slab = stage_slab(qkv, ns, S, L, D, smem);
  uint8_t* smask = reinterpret_cast<uint8_t*>(smem + slab_bytes(S, L, D, 4));
  for (int i = threadIdx.x; i < ns * L; i += blockDim.x)
    smask[i] = mask[(size_t)blockIdx.x * S * L + i];
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int t = warp; t < ns * H; t += nwarps) {
    const int sq = t / H;
    f32_bwd_head<HD, EXACT, KPL>(slab + (size_t)sq * L * 3 * D, smask + sq * L,
                                 dout + ((size_t)blockIdx.x * S + sq) * L * D, t - sq * H, L, D,
                                 D / H, scale);
  }
  __syncthreads();
  write_rows(dqkv + (size_t)blockIdx.x * S * L * 3 * D, slab, 1, ns * L * 3 * D);
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

// The backward's launches take the forward's plan (sequences per block,
// shared memory) with kBwdWarps warps, so that it takes every shape the
// forward takes: dO is read from global memory, not staged.
template <int KT, int NT, int HDX, bool PAIR>
cudaError_t launch_bwd_bf16_inst(const void* qkv, const uint8_t* mask, const void* dout,
                                 void* dqkv, int U, int L, int D, int H, int dev,
                                 cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_bwd_bf16_kernel<KT, NT, HDX, PAIR>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const Launch p = plan(U, L, D, 2, dev);
  const int warps = p.S * H < kBwdWarps ? p.S * H : kBwdWarps;
  const float scale = 1.f / sqrtf((float)(D / H));
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)(D / H));
  kernel<<<p.blocks, warps * 32, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), U, L, D, H, p.S, scale_log2, scale);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_bwd_bf16_kt(const void* qkv, const uint8_t* mask, const void* dout,
                               void* dqkv, int U, int L, int D, int H, int dev,
                               cudaStream_t stream) {
  const int hd = D / H;
  if (hd == 20 && ((uintptr_t)qkv & 3) == 0 && ((uintptr_t)dout & 3) == 0)
    return launch_bwd_bf16_inst<KT, 3, 20, true>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  switch ((hd + 7) / 8) {
    case 1:
      return launch_bwd_bf16_inst<KT, 1, 0, false>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 2:
      return launch_bwd_bf16_inst<KT, 2, 0, false>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 3:
      return launch_bwd_bf16_inst<KT, 3, 0, false>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    default:
      return launch_bwd_bf16_inst<KT, 4, 0, false>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  }
}

cudaError_t launch_bwd_bf16(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            int U, int L, int D, int H, int dev, cudaStream_t stream) {
  switch ((L + 15) / 16) {
    case 1: return launch_bwd_bf16_kt<1>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 2: return launch_bwd_bf16_kt<2>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 3: return launch_bwd_bf16_kt<3>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    default: return launch_bwd_bf16_kt<4>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  }
}

template <int HD, bool EXACT, int KPL>
cudaError_t launch_bwd_f32_inst(const void* qkv, const uint8_t* mask, const void* dout,
                                void* dqkv, int U, int L, int D, int H, int dev,
                                cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_bwd_f32_kernel<HD, EXACT, KPL>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const Launch p = plan(U, L, D, 4, dev);
  const int warps = p.S * H < kBwdWarps ? p.S * H : kBwdWarps;
  const float scale = 1.f / sqrtf((float)(D / H));
  kernel<<<p.blocks, warps * 32, p.smem, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<const float*>(dout),
      static_cast<float*>(dqkv), U, L, D, H, p.S, scale);
  return cudaGetLastError();
}

template <int HD, bool EXACT>
cudaError_t launch_bwd_f32_hd(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                              int U, int L, int D, int H, int dev, cudaStream_t stream) {
  if (L <= 32)
    return launch_bwd_f32_inst<HD, EXACT, 1>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  return launch_bwd_f32_inst<HD, EXACT, 2>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
}

cudaError_t launch_bwd_f32(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                           int U, int L, int D, int H, int dev, cudaStream_t stream) {
  const int hd = D / H;
  if (hd == 20) return launch_bwd_f32_hd<20, true>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  if (hd <= 8) return launch_bwd_f32_hd<8, false>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  if (hd <= 16)
    return launch_bwd_f32_hd<16, false>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  return launch_bwd_f32_hd<32, false>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
}

// The arguments both entry points take; 0 if the kernels take them.
int check_args(int U, int L, int D, int H, int dtype) {
  if (U <= 0 || L <= 0 || L > kMaxLen || H <= 0 || D % H != 0 || D / H > kMaxHeadDim ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(1, L, D, dtype == 0 ? 4 : 2) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int nrl_mhsa_fwd(const void* qkv, const uint8_t* mask, void* out, int U, int L,
                            int D, int H, int dtype, void* stream) {
  const int bad = check_args(U, L, D, H, dtype);
  if (bad) return bad;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(qkv, mask, out, U, L, D, H, dev, s);
  return (int)launch_bf16(qkv, mask, out, U, L, D, H, dev, s);
}

extern "C" int nrl_mhsa_bwd(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            int U, int L, int D, int H, int dtype, void* stream) {
  const int bad = check_args(U, L, D, H, dtype);
  if (bad) return bad;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bwd_f32(qkv, mask, dout, dqkv, U, L, D, H, dev, s);
  return (int)launch_bwd_bf16(qkv, mask, dout, dqkv, U, L, D, H, dev, s);
}
