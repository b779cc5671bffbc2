// Masked multi-head self-attention over many short independent sequences,
// forward and backward: the attention of the NRMS title encoder (L = 16 /
// 30) and of its user encoder (L = 50), at D = 300, H = 15, hd = 20, of
// the other GloVe models (MINS, CenNewsRec, CAUM: hd 15, 20 and 50, D up to
// 400), and of the PLM tower's MHSA (16 heads of 48, L up to 96).  The
// forward is described first; the backward (nrl_mhsa_bwd) after it; then
// the general per-head instances, for head dims above 32 and L above 64
// ("wide"); last the streaming instances for every shape outside their box,
// such as NRMS's user encoder at a history of 200 ("long").
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
// * bf16: several sequences per block, staged whole and coalesced.  The S
//   sequences of a block are one contiguous run of qkv (S * L * 3D values).
//   It is copied into shared memory as it lies, in the input type (bf16 is
//   not upcast), with 16-byte cp.async for the aligned body and byte copies
//   for the at most 15 bytes at either end; the shared copy starts at the
//   same address mod 16 as the source, so any L (odd L gives slabs that are
//   not 16-byte multiples) and any tensor offset take the same path.  S is
//   chosen on the host so that two blocks fit on an SM (L = 50 bf16: one
//   90 KB sequence a block; L = 16 bf16: three), and is cut for small U so
//   that the grid still gives every SM two blocks.  A block has 12 warps
//   (L <= 32) or 8 (L > 32).  Inside a block the staging is not overlapped with compute; the other
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
// * f32: the same warp task and exact two-pass softmax, with both products
//   on tensor cores in split TF32 ("3xTF32", mma.sync.m16n8k8 tf32 with f32
//   sums): each operand x goes in as hi = tf32(x) (cvt.rna) and
//   lo = tf32(x - hi), each product as a_lo b_hi + a_hi b_lo + a_hi b_hi.
//   One TF32 rounding (10 mantissa bits) misses the 1e-5 tolerance by two
//   orders of magnitude; the split keeps about 21 bits and stays well
//   inside it (tests/test_torch_port_f32split.py emulates both).  p goes
//   back as the A operand of p.v straight from the accumulators: the
//   m16n8k8 A fragment wants columns c and c + 4 where the accumulator holds
//   2c and 2c + 1, so k index c is taken as key 2c and c + 4 as key 2c + 1,
//   and the B operand reads v at those keys (a sum over k does not depend on
//   its order).  A block is one warp and one task, (sequence, head), and
//   stages only that head's q, k and v columns: 80-byte runs at D = 300, hd
//   = 20, still 16-byte cp.async (the row stride 3,600 bytes and the head
//   offset 80 h are multiples of 16; 4-byte cp.async otherwise).  Rows of 3
//   hd floats keep the fragment reads free of bank conflicts.  So the user
//   encoder's (64, 50) runs as 960 blocks rather than 64 blocks of whole
//   sequences on 132 SMs, and up to 16 blocks an SM overlap one block's
//   staging with another's compute: on the H100, blocks of 2 sequences of
//   one head ran the L = 16 backward 13-14% faster than blocks of 8, and
//   blocks of 1 within 3% of blocks of 2 (PERF.md, §6).  The neighbouring
//   heads of a sequence are neighbouring blocks, which run together and
//   share the 32-byte sectors of each other's runs in L2.
// * Output staged in shared memory, written with 16-byte stores.  Each task
//   writes its context over the q values it alone read (same rows, same head
//   columns), so no extra buffer is needed; after a barrier the block copies
//   its context rows (f32: its head's columns of them) out.  A bf16
//   block's context is one contiguous run of the output; where the staged q
//   row and the output row agree mod 16 (any D with 2 * D * sizeof(T) % 16
//   == 0 and allocator-aligned tensors, so always on the serving path) the
//   body moves in 16-byte loads and stores, else element by element.
// * cudaFuncSetAttribute (dynamic shared memory above 48 KB, bf16) runs
//   once per kernel instance and device, not on every launch.
//
// * Head dims above 32 (MINS's user encoder, hd 50; the PLM tower's MHSA,
//   hd 48; CAUM's default hd 100), L above 64 (PLM-mode titles), and bf16
//   shapes whose slab does not fit one block run in the wide instances, in
//   both types: one block per (sequence, head), a warp per 16-row tile, the
//   head's columns staged in the input type (see "wide" below).
//
// The shape rule: head dim up to 128 at L <= 64, up to 64 at L <= 128
// (kernel_box), and what the instance stages within one block's 232,448
// bytes of shared memory.  A bf16 block of S sequences (hd <= 32, L <= 64)
// takes 16 + S * L * 3D * 2 bytes, rounded up to 16, plus 64 key biases a
// sequence; a shape whose single sequence does not fit goes to the wide
// instances (L = 50: D above about 774).  An f32 block (hd <= 32, L <= 64)
// takes L * 3 hd * 4 bytes (+ L * hd * 4 for dO in the backward), each
// rounded up to 16, plus the key biases: at most 33 KB.  A wide block takes
// at most 141,312 bytes (below), so inside the box every shape fits.
// Every other shape, any L and head dims up to 1,024, runs in the long
// instances, which stream the keys through shared memory as the TPU kernel
// streams them (see "long" below; their blocks fit at every head dim up to
// 1,024).  ops/mhsa.py::kernel_supports applies the same rule first.
//
// C entry point (bound with ctypes):
//   int nrl_mhsa_fwd(const void* qkv, const uint8_t* mask, void* out,
//                    int U, int L, int D, int H, int dtype, void* stream)
// qkv (U, L, 3D) and out (U, L, D) are contiguous, dtype 0 = float32,
// 1 = bfloat16; mask (U, L) is one byte per position, nonzero = valid key;
// (L, D / H) within the rule above.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a shape outside the rule).
//
// Backward.  The TPU kernel has none: the JAX package trains through XLA
// autodiff of mhsa_reference, and this computes that gradient (what
// ops/mhsa.py::mhsa_backward computes in plain PyTorch).  Per (sequence,
// head), with s = 1 / sqrt(hd): P = softmax(s q.k^T) recomputed exactly
// (masked keys -1e30, keys past L excluded), dP = dO V^T,
// dS = P (dP - rowsum(dP P)) and 0 at masked keys, dQ = s dS K,
// dK = s dS^T Q, dV = P^T dO.  A fully masked sequence gets dQ = dK = 0 and
// dV = the mean of dO over its L rows.  L <= 128, so a whole logit row sits
// in registers and the row sums come from P and dP directly: the forward
// saves nothing (no output, no logsumexp) for it.
//
// What bounds it on the H100: memory again.  At U = 7168, L = 16 in bf16 it
// reads qkv (206 MB), dO (69 MB) and the mask and writes dqkv (206 MB):
// 0.144 ms at 3.35 TB/s, against 5.5 GFLOP of products (6 us on the
// tensor cores).  The plain version (mhsa_backward) runs about 30 kernels
// over f32 (U, H, L, L) tensors (4.8 ms there).  The design:
//
// * The forward's staging and plan.  bf16: the same S sequences per block
//   and the same shared memory (slab + key biases), so that every shape the
//   forward takes, the backward takes; dO is not staged: each warp reads its
//   head's columns of dO from global memory (through L1).  Blocks of 8
//   warps.  f32: one (sequence, head) a block, with that head's dO columns
//   staged beside its q, k and v columns.
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
// * f32: the five products in split TF32 (as the forward), with keys as the
//   rows: S^T = K Q^T and dP^T = V dO^T per 16-query tile, all keys in
//   registers, so the softmax, its sum and rowsum(dP * P) run down each
//   column (over the lane's key rows, then the 8 lanes of the column by
//   shuffles).  Then P^T and dS^T are already the A operands of dV += P^T dO
//   and dK += dS^T Q (k index c taken as query 2c, c + 4 as 2c + 1), and
//   only dQ = dS K needs a transpose: each 8 x 8 block of dS^T is turned
//   into dS's A fragment by two shuffles a lane (the lanes of even key rows
//   send their even column first, those of odd rows their odd column, which
//   is what the even and odd columns asking for them want; no shared memory
//   and no recomputed logits).  dK and dV accumulate for all keys across the
//   query tiles; the L = 50 instance holds them in 255 registers with no
//   spill and runs up to 8 warps per SM.  A per-warp shared tile in place
//   of the shuffles ran from 2% faster to 14% slower (PERF.md, §6).
// * Each task writes dQ over its own staged q values (after the tile's
//   last read of them) and dK, dV over its k and v values (after the last
//   tile); after a barrier the block copies its whole staged slab, now
//   dqkv, to the output in one coalesced run.  No atomics: each output
//   value is written by one lane, so the gradient is the same bits from
//   run to run.
//
//   int nrl_mhsa_bwd(const void* qkv, const uint8_t* mask, const void* dout,
//                    void* dqkv, void* workspace, int U, int L, int D, int H,
//                    int dtype, void* stream)
//   size_t nrl_mhsa_bwd_workspace(int U, int L, int D, int H, int dtype)
// qkv (U, L, 3D), dout (U, L, D) and dqkv (U, L, 3D) contiguous in the
// input type; workspace at least nrl_mhsa_bwd_workspace bytes, 4-byte
// aligned (the long instances' row statistics; 0 bytes, any pointer, for
// the others); the rest as nrl_mhsa_fwd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Built whole by default.  ops/build.py compiles it in four parts at once
// and links them (the wide instances are most of the build time): NRL_PART
// 1 holds the hd <= 32 instances, the shape rule and the C entry points,
// 2 the wide bf16 instances, 3 the wide f32 ones, 4 the long ones.
#ifndef NRL_PART
#define NRL_PART 0
#endif
#define NRL_BUILDS(part) (NRL_PART == 0 || NRL_PART == (part))

namespace {

constexpr float kMaskMin = -1e30f;
constexpr int kNarrowMaxLen = 64;    // L of the hd <= 32 instances (their key bias buffers)
constexpr int kBoxMaxLen = 128;      // L of the wide instances
constexpr int kBoxMaxHeadDim = 128;  // their head dim at L <= 64
constexpr int kBoxLongHeadDim = 64;  // their head dim at L above 64
constexpr int kMaxHeadDim = 1024;    // head dim of the long instances (any L)
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
// biases in f32 (bf16; these blocks take L <= 64).
__host__ __device__ inline size_t slab_bytes(int S, int L, int D, int es) {
  return align16(16 + (size_t)S * L * 3 * D * es);
}
inline size_t smem_bytes(int S, int L, int D, int es) {
  return slab_bytes(S, L, D, es) +
         (es == 4 ? align16((size_t)S * L) : (size_t)S * kNarrowMaxLen * 4);
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
  for (int i = threadIdx.x; i < ns * kNarrowMaxLen; i += blockDim.x) {
    const int sq = i / kNarrowMaxLen, key = i - sq * kNarrowMaxLen;
    sbias[i] = key < L ? (msk[sq * L + key] ? 0.f : kMaskMin) : -INFINITY;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  unsigned short* bits = reinterpret_cast<unsigned short*>(slab);
  for (int t = warp; t < ns * H; t += nwarps) {
    const int sq = t / H;
    bf16_head<KT, NT, HDX, PAIR>(bits + (size_t)sq * L * 3 * D, sbias + sq * kNarrowMaxLen,
                                 t - sq * H, L, D, D / H, scale_log2);
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
  for (int i = threadIdx.x; i < ns * kNarrowMaxLen; i += blockDim.x) {
    const int sq = i / kNarrowMaxLen, key = i - sq * kNarrowMaxLen;
    sbias[i] = key < L ? (msk[sq * L + key] ? 0.f : kMaskMin) : -INFINITY;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  unsigned short* bits = reinterpret_cast<unsigned short*>(slab);
  const unsigned short* go = reinterpret_cast<const unsigned short*>(dout);
  for (int t = warp; t < ns * H; t += nwarps) {
    const int sq = t / H;
    bf16_bwd_head<KT, NT, HDX, PAIR>(bits + (size_t)sq * L * 3 * D, sbias + sq * kNarrowMaxLen,
                                     go + ((size_t)blockIdx.x * S + sq) * L * D, t - sq * H, L,
                                     D, D / H, scale_log2, scale);
  }
  __syncthreads();
  // The block's dqkv rows are one contiguous run laid out as its staged slab.
  write_rows(dqkv + (size_t)blockIdx.x * S * L * 3 * D, slab, 1, ns * L * 3 * D);
}

// ----------------------------------------------------------------- f32 ---

// x rounded to tf32 (cvt.rna: to nearest, ties away from zero; the low 13
// bits of the f32 pattern cleared), as the bits of an mma operand.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment split into tf32 parts: hi = tf32(x), lo = tf32(x - hi),
// so that hi + lo keeps about 22 bits of x.  A zero (an excluded key's p, a
// padded column) splits into two zeros.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Fragment layouts of m16n8k8 (g = lane / 4, c = lane % 4): A a0 (g, c),
// a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4); B b0 (k = c, n = g), b1 (k = c+4,
// n = g); C as m16n8k16's, c0..c1 (g, 2c..2c+1), c2..c3 (g+8, 2c..2c+1).
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// d += a b in split TF32 ("3xTF32"): a_lo b_hi + a_hi b_lo + a_hi b_hi with
// f32 sums; the a_lo b_lo term (about 2^-22 of the product) is dropped.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// row[d], 0 past the head dimension.
__device__ __forceinline__ float ld(const float* row, int d, int hd) {
  return d < hd ? row[d] : 0.f;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Stage `rows` rows of `parts` runs of w floats: run (r, p) of the source,
// at src + r * src_row + p * src_part, goes to dst + (r * parts + p) * w.
// 16-byte cp.async where every run starts on 16 bytes and w is a multiple
// of 4 (D = 300, 15 heads of 20 on an aligned tensor), else 4-byte ones;
// committed as one group.  dst is 16-byte aligned.
__device__ void stage_runs(float* dst, const float* src, int rows, int parts, int w,
                           size_t src_row, size_t src_part) {
  const bool vec = ((uintptr_t)src & 15) == 0 && (src_row & 3) == 0 && (src_part & 3) == 0 &&
                   (w & 3) == 0;
  const int per = vec ? w / 4 : w;  // copies a run
  const int n = rows * parts * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int run = i / per, j = i - run * per;
    const int r = run / parts, p = run - r * parts;
    const float* s = src + r * src_row + p * src_part;
    float* d = dst + (size_t)run * w;
    if (vec)
      cp_async16(d + 4 * j, s + 4 * j);
    else
      cp_async4(d + j, s + j);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The first `parts` runs of each of `rows` staged rows of `src_parts` runs
// (as stage_runs lays them out) to dst + r * dst_row + p * dst_part, in
// 16-byte stores where aligned.
__device__ void write_runs(float* dst, const float* src, int rows, int parts, int src_parts,
                           int w, size_t dst_row, size_t dst_part) {
  const bool vec = ((uintptr_t)dst & 15) == 0 && (dst_row & 3) == 0 && (dst_part & 3) == 0 &&
                   (w & 3) == 0;
  const int per = vec ? w / 4 : w;
  const int n = rows * parts * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int run = i / per, j = i - run * per;
    const int r = run / parts, p = run - r * parts;
    const float* s = src + ((size_t)r * src_parts + p) * w;
    float* d = dst + r * dst_row + p * dst_part;
    if (vec)
      reinterpret_cast<float4*>(d)[j] = reinterpret_cast<const float4*>(s)[j];
    else
      d[j] = s[j];
  }
}

// The sequence's 64 key biases: 0 (valid), -1e30 (masked), -inf (past L).
__device__ void key_biases(float* sbias, const uint8_t* msk, int L) {
  for (int key = threadIdx.x; key < kNarrowMaxLen; key += blockDim.x)
    sbias[key] = key < L ? (msk[key] ? 0.f : kMaskMin) : -INFINITY;
}

// Shared memory of an f32 block (one head of one sequence): the staged q,
// k, v columns (rows of 3 hd floats), dO's (backward), the key biases; at
// most 33 KB, so no opt-in above 48 KB is needed.
__host__ __device__ inline size_t f32_qkv_bytes(int L, int hd) {
  return align16((size_t)L * 3 * hd * 4);
}
__host__ __device__ inline size_t f32_do_bytes(int L, int hd) {
  return align16((size_t)L * hd * 4);
}

// One f32 forward warp task: one head of one sequence, whose staged rows
// (q, k, v of the head, row stride 3 hd) start at `s`.  Per 16-row query
// tile: the logits q.k^T in split TF32 (hd zero-padded to 8 NT), the exact
// softmax of the bf16 path (softmax_tile), then p.v in split TF32 with p
// straight from the accumulators as the A operand (its k index c taken as
// key 2c and c + 4 as key 2c + 1, so the B operand reads v at those keys).
// The context goes over the tile's own q values.  Rows past L are read
// clamped to row L - 1.
template <int KT, int NT, int HDX>
__device__ __forceinline__ void f32_head(float* s, const float* bias, int L, int hd_rt,
                                         float scale_log2) {
  constexpr int NJ = 2 * KT;
  const int hd = HDX > 0 ? HDX : hd_rt;
  const int W = 3 * hd;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool last_on = (NJ - 1) * 8 < L;
  const int mts = (L + 15) / 16;
  for (int mt = 0; mt < mts; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    float* q0 = s + min(r0, L - 1) * W;
    float* q1 = s + min(r1, L - 1) * W;
    FragA qa[NT];
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const int d = ks * 8 + c;
      qa[ks] = frag_a(ld(q0, d, hd), ld(q1, d, hd), ld(q0, d + 4, hd), ld(q1, d + 4, hd));
    }
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if (j < NJ - 1 || last_on) {
        const float* kr = s + min(j * 8 + g, L - 1) * W + hd;
#pragma unroll
        for (int ks = 0; ks < NT; ++ks)
          mma3(sc[j], qa[ks], frag_b(ld(kr, ks * 8 + c, hd), ld(kr, ks * 8 + c + 4, hd)));
      }
    }
    const bool r1_on = mt * 16 + 8 < L;
    float sum0, sum1;
    softmax_tile(sc, bias, scale_log2, last_on, r1_on, sum0, sum1);

    float oc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) oc[nt][0] = oc[nt][1] = oc[nt][2] = oc[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < NJ - 1 || last_on) {
        const FragA pa = frag_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
        const float* v0 = s + min(j * 8 + 2 * c, L - 1) * W + 2 * hd;
        const float* v1 = s + min(j * 8 + 2 * c + 1, L - 1) * W + 2 * hd;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int d = nt * 8 + g;
          mma3(oc[nt], pa, frag_b(ld(v0, d, hd), ld(v1, d, hd)));
        }
      }
    }
    // Sums >= 1 (the max term is 2^0); rows g + 8 are all padding where
    // r1_on is false and are not written.
    const float inv0 = 1.f / sum0, inv1 = r1_on ? 1.f / sum1 : 0.f;
    __syncwarp();  // every lane has read the tile's q values
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = nt * 8 + 2 * c;
      if (r0 < L) {
        if (d < hd) q0[d] = oc[nt][0] * inv0;
        if (d + 1 < hd) q0[d + 1] = oc[nt][1] * inv0;
      }
      if (r1 < L) {
        if (d < hd) q1[d] = oc[nt][2] * inv1;
        if (d + 1 < hd) q1[d + 1] = oc[nt][3] * inv1;
      }
    }
  }
}

// One block, one warp: head blockIdx.x % H of sequence blockIdx.x / H.
// At most 128 registers a thread, as for 16 warps an SM.
template <int KT, int NT, int HDX>
__global__ void __launch_bounds__(32, 16)
    mhsa_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int L, int D, int H, float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  const int hd = HDX > 0 ? HDX : D / H;
  const int h = blockIdx.x % H;
  const size_t u = blockIdx.x / H;
  float* slab = reinterpret_cast<float*>(smem);
  float* sbias = reinterpret_cast<float*>(smem + f32_qkv_bytes(L, hd));
  stage_runs(slab, qkv + u * L * 3 * D + h * hd, L, 3, hd, 3 * D, D);
  key_biases(sbias, mask + u * L, L);
  cp_async_wait_all();
  __syncthreads();
  f32_head<KT, NT, HDX>(slab, sbias, L, hd, scale_log2);
  __syncthreads();
  write_runs(out + u * L * D + h * hd, slab, L, 1, 3, hd, D, 0);
}

// One f32 backward warp task: one head of one sequence, staged rows at `s`
// (q, k, v, row stride 3 hd), dO's at `dos` (row stride hd).  Keys are the
// rows of the products (16 KT, all in registers), queries the columns, 16
// a tile: per query tile, S^T = K Q^T and dP^T = V dO^T in split TF32, the
// exact softmax down each column (the column max, sum and rowsum(dP * P)
// over the key rows of the lane and then over the 8 lanes of its column by
// shuffles), dS^T; then dV += P^T dO and dK += dS^T Q with P^T and dS^T
// straight from the accumulators as A operands (k index c taken as query
// 2c, c + 4 as query 2c + 1), accumulated for all keys across the query
// tiles.  dQ = dS K needs dS with queries as rows: each 8 x 8 block of dS^T
// is transposed in registers by two shuffles a lane (a lane of row ρ sends
// the one of its two values that the lane asking for row ρ wants, since
// even rows are asked for by even columns first and odd rows by odd
// columns).  dO rows past L read as 0, so padded query columns add nothing.
template <int KT, int NT, int HDX>
__device__ __forceinline__ void f32_bwd_head(float* s, const float* dos, const float* bias,
                                             int L, int hd_rt, float scale_log2, float scale) {
  const int hd = HDX > 0 ? HDX : hd_rt;
  const int W = 3 * hd;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool godd = g & 1;

  float dk[KT][NT][4], dv[KT][NT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[kt][nt][e] = dv[kt][nt][e] = 0.f;

  const int mts = (L + 15) / 16;
  for (int mt = 0; mt < mts; ++mt) {
    const int qb = mt * 16;
    const bool n1_on = qb + 8 < L;  // else queries qb + 8.. are all padding

    // st = S^T = K Q^T, dpt = dP^T = V dO^T (rows keys, columns queries).
    float st[KT][2][4], dpt[KT][2][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[kt][nq][e] = dpt[kt][nq][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const int d = ks * 8 + c;
      FragB qf[2], of[2];
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {
        const int qr = qb + nq * 8 + g;
        const float* qrow = s + min(qr, L - 1) * W;
        const float* orow = dos + min(qr, L - 1) * hd;
        const bool in = qr < L;
        qf[nq] = frag_b(ld(qrow, d, hd), ld(qrow, d + 4, hd));
        of[nq] = frag_b(in ? ld(orow, d, hd) : 0.f, in ? ld(orow, d + 4, hd) : 0.f);
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const float* k0 = s + min(kt * 16 + g, L - 1) * W + hd;
        const float* k1 = s + min(kt * 16 + 8 + g, L - 1) * W + hd;
        const FragA ka = frag_a(ld(k0, d, hd), ld(k1, d, hd), ld(k0, d + 4, hd), ld(k1, d + 4, hd));
        mma3(st[kt][0], ka, qf[0]);
        if (n1_on) mma3(st[kt][1], ka, qf[1]);
        const float* v0 = k0 + hd;
        const float* v1 = k1 + hd;
        const FragA va = frag_a(ld(v0, d, hd), ld(v1, d, hd), ld(v0, d + 4, hd), ld(v1, d + 4, hd));
        mma3(dpt[kt][0], va, of[0]);
        if (n1_on) mma3(dpt[kt][1], va, of[1]);
      }
    }

    // The exact softmax down each column (log2 units, bias per key row),
    // then rowsum(dP * P) per query and dS^T, 0 at masked and padded keys.
    // Columns of this lane: queries qb + 8 nq + 2c + e.
    float mx[2][2], sm[2][2], dd[2][2];
#pragma unroll
    for (int nq = 0; nq < 2; ++nq) mx[nq][0] = mx[nq][1] = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const float b0 = bias[kt * 16 + g], b1 = bias[kt * 16 + 8 + g];
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          st[kt][nq][e] = fmaf(st[kt][nq][e], scale_log2, b0);
          st[kt][nq][2 + e] = fmaf(st[kt][nq][2 + e], scale_log2, b1);
          mx[nq][e] = fmaxf(mx[nq][e], fmaxf(st[kt][nq][e], st[kt][nq][2 + e]));
        }
      }
    }
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1)
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mx[nq][e] = fmaxf(mx[nq][e], __shfl_xor_sync(0xffffffffu, mx[nq][e], o));
#pragma unroll
    for (int nq = 0; nq < 2; ++nq) sm[nq][0] = sm[nq][1] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[kt][nq][e] = ex2(st[kt][nq][e] - mx[nq][e & 1]);  // 0 at keys past L
          sm[nq][e & 1] += st[kt][nq][e];
        }
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1)
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
#pragma unroll
        for (int e = 0; e < 2; ++e) sm[nq][e] += __shfl_xor_sync(0xffffffffu, sm[nq][e], o);
#pragma unroll
    for (int nq = 0; nq < 2; ++nq) {
      // sums >= 1: the max term is 2^0
      const float inv[2] = {1.f / sm[nq][0], 1.f / sm[nq][1]};
      dd[nq][0] = dd[nq][1] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[kt][nq][e] *= inv[e & 1];
          dd[nq][e & 1] += st[kt][nq][e] * dpt[kt][nq][e];
        }
    }
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1)
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
#pragma unroll
        for (int e = 0; e < 2; ++e) dd[nq][e] += __shfl_xor_sync(0xffffffffu, dd[nq][e], o);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const bool ok0 = bias[kt * 16 + g] == 0.f, ok1 = bias[kt * 16 + 8 + g] == 0.f;
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[kt][nq][e] = (e < 2 ? ok0 : ok1)
                               ? st[kt][nq][e] * (dpt[kt][nq][e] - dd[nq][e & 1])
                               : 0.f;
    }

    // dV += P^T dO, dK += dS^T Q over this tile's queries, one k8 step per
    // 8 queries (B: k = query 2c / 2c + 1, n = head column).
#pragma unroll
    for (int nq = 0; nq < 2; ++nq) {
      if (nq == 1 && !n1_on) break;
      const int qa = qb + nq * 8 + 2 * c;
      const float* o0 = dos + min(qa, L - 1) * hd;
      const float* o1 = dos + min(qa + 1, L - 1) * hd;
      const float* q0 = s + min(qa, L - 1) * W;
      const float* q1 = s + min(qa + 1, L - 1) * W;
      const bool in0 = qa < L, in1 = qa + 1 < L;
      FragB ob[NT], qbf[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + g;
        ob[nt] = frag_b(in0 ? ld(o0, d, hd) : 0.f, in1 ? ld(o1, d, hd) : 0.f);
        qbf[nt] = frag_b(ld(q0, d, hd), ld(q1, d, hd));
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const FragA pa = frag_a(st[kt][nq][0], st[kt][nq][2], st[kt][nq][1], st[kt][nq][3]);
        const FragA sa = frag_a(dpt[kt][nq][0], dpt[kt][nq][2], dpt[kt][nq][1], dpt[kt][nq][3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma3(dv[kt][nt], pa, ob[nt]);
          mma3(dk[kt][nt], sa, qbf[nt]);
        }
      }
    }

    // dQ = dS K (A: m = the tile's 16 queries, k = keys 2c / 2c + 1 of each
    // 8-key block; B: K rows at those keys).  Lane (g, c) gets dS at
    // (query g, keys 2c and 2c + 1) of each block from the lanes of rows 2c
    // and 2c + 1, column pair g / 2.
    const int src1 = (godd ? 2 * c + 1 : 2 * c) * 4 + (g >> 1);
    const int src2 = (godd ? 2 * c : 2 * c + 1) * 4 + (g >> 1);
    float dq[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 2 * KT; ++kb) {
      const int kt = kb >> 1, hf = kb & 1;
      float x[2][2];  // [query tile][key 2c, 2c + 1]
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {
        const float a = dpt[kt][nq][2 * hf], b = dpt[kt][nq][2 * hf + 1];
        const float r1 = __shfl_sync(0xffffffffu, godd ? b : a, src1);
        const float r2 = __shfl_sync(0xffffffffu, godd ? a : b, src2);
        x[nq][0] = godd ? r2 : r1;
        x[nq][1] = godd ? r1 : r2;
      }
      const FragA da = frag_a(x[0][0], x[1][0], x[0][1], x[1][1]);
      const float* k0 = s + min(kb * 8 + 2 * c, L - 1) * W + hd;
      const float* k1 = s + min(kb * 8 + 2 * c + 1, L - 1) * W + hd;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + g;
        mma3(dq[nt], da, frag_b(ld(k0, d, hd), ld(k1, d, hd)));
      }
    }

    // Every lane has read this tile's q values: dQ goes over them.
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = nt * 8 + 2 * c;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = qb + hf * 8 + g;
        if (r < L) {
          if (d < hd) s[r * W + d] = dq[nt][2 * hf] * scale;
          if (d + 1 < hd) s[r * W + d + 1] = dq[nt][2 * hf + 1] * scale;
        }
      }
    }
  }

  // Every lane has read its last k and v values: dK and dV go over them.
  __syncwarp();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = kt * 16 + hf * 8 + g;
      if (key >= L) continue;
      float* kr = s + key * W + hd;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + 2 * c;
        if (d < hd) {
          kr[d] = dk[kt][nt][2 * hf] * scale;
          kr[hd + d] = dv[kt][nt][2 * hf];
        }
        if (d + 1 < hd) {
          kr[d + 1] = dk[kt][nt][2 * hf + 1] * scale;
          kr[hd + d + 1] = dv[kt][nt][2 * hf + 1];
        }
      }
    }
  }
}

// As mhsa_f32_kernel; at most 128 registers a thread up to L = 32 (16
// warps an SM), 255 above.
template <int KT, int NT, int HDX>
__global__ void __launch_bounds__(32, KT <= 2 ? 16 : 8)
    mhsa_bwd_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        const float* __restrict__ dout, float* __restrict__ dqkv, int L, int D,
                        int H, float scale_log2, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int hd = HDX > 0 ? HDX : D / H;
  const int h = blockIdx.x % H;
  const size_t u = blockIdx.x / H;
  float* slab = reinterpret_cast<float*>(smem);
  float* sdo = reinterpret_cast<float*>(smem + f32_qkv_bytes(L, hd));
  float* sbias = reinterpret_cast<float*>(smem + f32_qkv_bytes(L, hd) + f32_do_bytes(L, hd));
  stage_runs(slab, qkv + u * L * 3 * D + h * hd, L, 3, hd, 3 * D, D);
  stage_runs(sdo, dout + u * L * D + h * hd, L, 1, hd, D, 0);
  key_biases(sbias, mask + u * L, L);
  cp_async_wait_all();
  __syncthreads();
  f32_bwd_head<KT, NT, HDX>(slab, sdo, sbias, L, hd, scale_log2, scale);
  __syncthreads();
  write_runs(dqkv + u * L * 3 * D + h * hd, slab, L, 3, 3, hd, 3 * D, D);
}

// ---------------------------------------------------------------- wide ---
//
// The general per-head instances ("wide"), in both types: every shape the
// instances above do not take.  That is any head dim above 32 (MINS's user
// encoder, 6 heads of 50; the PLM tower's MHSA, 16 heads of 48; CAUM's
// default of 4 heads over 400, head dim 100), any L above 64 (the PLM
// tower's titles reach 96 tokens), and a bf16 shape at head dim 32 or less
// whose (L, 3D) slab does not fit one block.  They take head dims 1..128 at
// L <= 64 and head dims 1..64 at L <= 128 (kernel_box below).
//
// What bounds them on the H100.  At the PLM head's (512, 96, 768, 16) the
// bytes: bf16 qkv and the context are 302 MB each way (0.090 ms at 3.35
// TB/s) against 14.5 GFLOP (0.015 ms at the bf16 tensor rate).  At MINS's
// (64, 50, 300, 6) the whole problem is 384 (sequence, head) pairs of a few
// KB each, one wave on 132 SMs: latency, so the design keeps the serial
// chain of each warp short and puts more warps on each pair: two warps a
// (sequence, head) that both formed every logit and ran the query tiles one
// after another, with dK and dV summed through shared memory and bf16
// multiplied as TF32, lost to SDPA there by 6.8x (bf16) and 2.2x (f32) in
// the backward (NVIDIA H100 80GB HBM3, 700.00 W).  The design:
//
// * One block per (sequence, head), one warp per 16-row tile of the
//   sequence (KT = ceil(L / 16) warps, up to 8).  The head's q, k, v (and
//   dO) columns are staged in shared memory in the input type, bf16 as bf16:
//   cp.async of 16, 8 or 4 bytes, the widest that the tensor's address, its
//   row stride, the head offset and the run of hd values allow (hd = 50 in
//   bf16: 4 bytes; hd = 48: 16), plain loads only for bf16 runs off a 4-byte
//   boundary.  Rows past L and columns past the head dim (up to the
//   product's padded depth) are zeroed, so no fragment read is clamped or
//   guarded: zero rows of k give logits that the -inf bias past L removes,
//   zero rows of v and dO add nothing.  Rows are padded to an odd number of
//   16-byte units (bf16: ceil(hd / 16) * 16 + 8 values; f32: an odd
//   multiple of 4 floats), so that the eight rows of an ldmatrix (bf16) or
//   the (g, c) fragment reads (f32) fall in distinct banks.
// * bf16: every product on bf16 tensor cores, mma.sync.m16n8k16 with f32
//   sums, with every operand read by ldmatrix (.trans where the operand
//   wants the other layout), half the shared memory and a quarter of the
//   products of TF32 split in two.  p (and dS) become A operands straight
//   from the accumulators (two n8 tiles of C are one k16 tile of A), rounded
//   to bf16 as the hd <= 32 path rounds them; P goes into dV = P^T dO as a
//   bf16 hi + lo pair, as there.  f32: split TF32 (mma.sync.m16n8k8, three
//   products each), as the hd <= 32 f32 instances: one TF32 rounding misses
//   the 1e-5 tolerance by two orders of magnitude.
// * Forward: warp mt runs query tile mt: S = q k^T over all keys into
//   registers (2 KT n8 tiles), the exact two-pass softmax of the other
//   instances, then o = p v one group of up to 8 n8 column tiles at a time
//   (two groups above head dim 64), written to the output from the
//   accumulators.
// * Backward, with no atomics and no work done twice across warps: phase
//   A gives warp mt query tile mt, phase B gives warp kt key tile kt.
//   Phase A: S and the softmax as the forward, then D = rowsum(dP * P)
//   (dP = dO V^T two 16-key chunks at a time, so that two accumulator
//   chains run at once: a pass that sums, then a pass that recomputes dP
//   into dS = P (dP - D) and dQ += dS K), and dQ written out; the row max,
//   1 / row sum and D of every query go to shared memory.  Barrier.  Phase
//   B: per 16-query chunk, S^T = K Q^T and dP^T = V dO^T for the warp's
//   keys in one loop, P^T from the stored row statistics, dS^T, then
//   dV += P^T dO and dK += dS^T Q in registers; dK and dV written out.  The
//   whole dK and dV of a key tile thus sum in one warp's registers in a
//   fixed order: each output value is written by one lane, once, and two
//   runs give the same bits.  Head dims above 64 run phase A's second pass
//   and phase B once per column group.  In f32 phase B forms S^T and dP^T
//   bit for bit as phase A formed S and dP (logits_t_f32), and each 8-row
//   product of dQ, dK and dV sums in a fresh accumulator before an f32 add
//   (both for precision: see there).
// * Outputs go from the accumulators to global memory (pairs of values a
//   store where aligned): each warp's rows are runs of hd values that it
//   alone writes, whole sectors within a few instructions.
//
// Shared memory: 3 (forward) or 4 (backward) arrays of Lp padded rows in the
// input type (Lp = 16 ceil(L / 16)) plus Lp key biases (and, backward, 3 Lp
// row statistics) in f32: at most 141,312 bytes (f32 backward at L = 128,
// head dim 64), so one block always fits.  (64, 50, 300, 6): 38,656 bytes
// in bf16, 62,464 in f32.
constexpr int kNarrowHeadDim = 32;  // the widest head of the hd <= 32 instances

// The shapes the kernels take: head dim up to 128 at L <= 64, up to 64 at
// L <= 128.
__host__ __device__ inline bool kernel_box(int L, int hd) {
  return L >= 1 && hd >= 1 && ((L <= kNarrowMaxLen && hd <= kBoxMaxHeadDim) ||
                               (L <= kBoxMaxLen && hd <= kBoxLongHeadDim));
}

// Row stride, in values, of a staged head array.
__host__ __device__ inline int wide_stride(int hd, int es) {
  return es == 2 ? (hd + 15) / 16 * 16 + 8 : (hd + 7) / 8 * 8 + 4;
}
__host__ __device__ inline size_t wide_smem(int L, int hd, int es, bool bwd) {
  const size_t Lp = (L + 15) / 16 * 16;
  return (bwd ? 4 : 3) * Lp * wide_stride(hd, es) * es + (bwd ? 4 : 1) * Lp * 4;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// Stage `parts` runs of hd values of each of L rows: run (r, p) of the
// source, at src + r * src_row + p * src_part, goes to row r of array p at
// dst (arrays of Lp rows of `stride` values).  cp.async of the widest of
// 16, 8 and 4 bytes that every run's address allows, committed as one
// group; 2-byte values off a 4-byte boundary by plain loads, kStageBatch in
// flight a thread.  The caller's cp_async_wait_all() and barrier cover both.
constexpr int kStageBatch = 16;

template <typename T>
__device__ void stage_head(T* dst, const T* src, int L, int parts, int hd, size_t src_row,
                           size_t src_part, int stride, int Lp) {
  constexpr int es = sizeof(T);
  const uintptr_t a = (uintptr_t)src | (src_row * es) | (src_part * es) | ((uintptr_t)hd * es);
  const int V = (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : es;
  const int per = hd * es / V;  // copies a run
  const int n = L * parts * per;
  if (V >= 4) {
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int run = i / per, j = i - run * per;
      const int r = run / parts, p = run - r * parts;
      const char* from = s + (r * src_row + p * src_part) * es + j * V;
      char* to = d + ((size_t)p * Lp * stride + (size_t)r * stride) * es + j * V;
      if (V == 16)
        cp_async16(to, from);
      else if (V == 8)
        cp_async8(to, from);
      else
        cp_async4(to, from);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i0 = threadIdx.x; i0 < n; i0 += kStageBatch * blockDim.x) {
      T v[kStageBatch];
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i < n) {
          const int run = i / hd, j = i - run * hd;
          const int r = run / parts, p = run - r * parts;
          v[k] = src[r * src_row + p * src_part + j];
        }
      }
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i < n) {
          const int run = i / hd, j = i - run * hd;
          const int r = run / parts, p = run - r * parts;
          dst[(size_t)p * Lp * stride + (size_t)r * stride + j] = v[k];
        }
      }
    }
  }
}

// Zero what the products read beyond the staged values: columns hd ..
// hdp - 1 of rows 0 .. L - 1 and columns 0 .. hdp - 1 of rows L .. Lp - 1
// of each of `parts` arrays (disjoint from what stage_head writes).
template <typename T>
__device__ void zero_pad(T* dst, int parts, int L, int Lp, int hd, int hdp, int stride) {
  const int pc = hdp - hd;
  const int n1 = parts * L * pc;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    const int row = i / pc, j = i - row * pc;  // row = p * L + r
    const int p = row / L, r = row - p * L;
    dst[((size_t)p * Lp + r) * stride + hd + j] = T(0);
  }
  const int pr = Lp - L;
  const int n2 = parts * pr * hdp;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    const int row = i / hdp, j = i - row * hdp;
    const int p = row / pr, r = row - p * pr;
    dst[((size_t)p * Lp + L + r) * stride + j] = T(0);
  }
}

// The key biases of one sequence for Lp keys: 0 (valid), -1e30 (masked),
// -inf (past L).
__device__ void wide_biases(float* sbias, const uint8_t* msk, int L, int Lp) {
  for (int key = threadIdx.x; key < Lp; key += blockDim.x)
    sbias[key] = key < L ? (msk[key] ? 0.f : kMaskMin) : -INFINITY;
}

// x, y at out[0], out[1] in the output type, each only where its column is
// below hd (col, col + 1 against hd); one 4- or 8-byte store where aligned.
__device__ __forceinline__ void put_pair(__nv_bfloat16* out, int col, int hd, float x, float y) {
  if (col + 1 < hd && ((uintptr_t)out & 3) == 0) {
    *reinterpret_cast<uint32_t*>(out) = pack_f32(x, y);
  } else {
    if (col < hd) out[0] = __float2bfloat16_rn(x);
    if (col + 1 < hd) out[1] = __float2bfloat16_rn(y);
  }
}
__device__ __forceinline__ void put_pair(float* out, int col, int hd, float x, float y) {
  if (col + 1 < hd && ((uintptr_t)out & 7) == 0) {
    *reinterpret_cast<float2*>(out) = make_float2(x, y);
  } else {
    if (col < hd) out[0] = x;
    if (col + 1 < hd) out[1] = y;
  }
}

// ldmatrix: four 8 x 8 matrices of 16-bit values, the rows of matrix i at
// the addresses of lanes 8 i .. 8 i + 7; register i of lane t holds row t / 4,
// columns 2 (t % 4) and 2 (t % 4) + 1 of matrix i (.trans: of its transpose).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Operand tiles of m16n8k16 from a staged bf16 array `a` (row stride st):
// tile_a: the A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 15
// (a0..a3 as in bf16_head).  tile_b: b0, b1 of two n8 tiles whose n index is
// the row (rows n0 .. n0 + 15, k = columns k0 .. k0 + 15): {b0, b1} of rows
// n0.., then of rows n0 + 8...  tile_bt: the same where the k index is the
// row (rows k0 .. k0 + 15, n = columns n0 .. n0 + 15).
__device__ __forceinline__ void tile_a(uint32_t (&r)[4], const unsigned short* a, int st, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(r, a + (r0 + (lane & 15)) * st + k0 + (lane >> 4) * 8);
}
__device__ __forceinline__ void tile_b(uint32_t (&r)[4], const unsigned short* a, int st, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(r, a + (n0 + (lane & 7) + (lane >> 4) * 8) * st + k0 + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void tile_bt(uint32_t (&r)[4], const unsigned short* a, int st, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4t(r, a + (k0 + (lane & 15)) * st + n0 + (lane >> 4) * 8);
}

// The exact softmax of one 16-row tile as softmax_tile, also returning each
// row's max (log2 units) and 1 / sum, with rows g + 8 (r1_on false: all
// past L) given max 0 and 1 / sum 0, so that P recomputed from them is 0.
template <int NJ>
__device__ __forceinline__ void wide_softmax(float (&sc)[NJ][4], const float* bias,
                                             float scale_log2, bool last_on, bool r1_on,
                                             float& mx0, float& mx1, float& inv0, float& inv1) {
  const int c = threadIdx.x & 3;
  mx0 = -INFINITY;
  mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < NJ - 1 || last_on) {
      const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * c);
      sc[j][0] = fmaf(sc[j][0], scale_log2, b.x);
      sc[j][1] = fmaf(sc[j][1], scale_log2, b.y);
      sc[j][2] = fmaf(sc[j][2], scale_log2, b.x);
      sc[j][3] = fmaf(sc[j][3], scale_log2, b.y);
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  if (!r1_on) mx1 = 0.f;
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
  inv0 = 1.f / sum0;  // >= 1: the max term is 2^0
  inv1 = r1_on ? 1.f / sum1 : 0.f;
}

// Everything a wide warp task needs of its block.
template <typename T>
struct WideHead {
  const T* q;  // staged arrays, Lp rows of `st` values each
  const T* k;
  const T* v;
  const T* dout;
  const float* bias;  // Lp key biases
  float* mx;          // backward: per query row, max (log2 units), 1 / sum, D
  float* inv;
  float* dd;
  int L, hd, st;
  float scale_log2, scale;
};

// ----------------------------------------------------------- wide, bf16 ---

// S = q k^T of query tile mt against every key (2 KT n8 tiles; the last
// skipped where it is all past L), k16 steps over the head dim.
template <int KT>
__device__ __forceinline__ void wide_logits_bf16(float (&sc)[2 * KT][4], const unsigned short* q,
                                                 const unsigned short* k, int st, int mt, int hk,
                                                 bool last_on) {
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  for (int ks = 0; ks < hk; ++ks) {
    uint32_t a[4];
    tile_a(a, q, st, mt * 16, ks * 16);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      tile_b(b, k, st, kk * 16, ks * 16);
      mma_bf16(sc[2 * kk], a, b[0], b[1]);
      if (kk < KT - 1 || last_on) mma_bf16(sc[2 * kk + 1], a, b[2], b[3]);
    }
  }
}

// dP = a b^T for one 16-row tile (rows r0 of `a`) and one 16-key chunk
// (rows n0 of `b`): two n8 tiles.
__device__ __forceinline__ void chunk_bf16(float (&dp)[2][4], const unsigned short* a,
                                           const unsigned short* b, int st, int r0, int n0,
                                           int hk) {
#pragma unroll
  for (int n = 0; n < 2; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
  for (int ks = 0; ks < hk; ++ks) {
    uint32_t fa[4], fb[4];
    tile_a(fa, a, st, r0, ks * 16);
    tile_b(fb, b, st, n0, ks * 16);
    mma_bf16(dp[0], fa, fb[0], fb[1]);
    mma_bf16(dp[1], fa, fb[2], fb[3]);
  }
}

// chunk_bf16 of (a, b) into x and of (c, d) into y in one loop over the
// head dim: four independent accumulator chains.
__device__ __forceinline__ void chunk2_bf16(float (&x)[2][4], const unsigned short* a,
                                            const unsigned short* b, float (&y)[2][4],
                                            const unsigned short* c, const unsigned short* d,
                                            int st, int r0, int n0, int hk) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = y[n][e] = 0.f;
  for (int ks = 0; ks < hk; ++ks) {
    uint32_t fa[4], fb[4], fc[4], fd[4];
    tile_a(fa, a, st, r0, ks * 16);
    tile_b(fb, b, st, n0, ks * 16);
    tile_a(fc, c, st, r0, ks * 16);
    tile_b(fd, d, st, n0, ks * 16);
    mma_bf16(x[0], fa, fb[0], fb[1]);
    mma_bf16(x[1], fa, fb[2], fb[3]);
    mma_bf16(y[0], fc, fd[0], fd[1]);
    mma_bf16(y[1], fc, fd[2], fd[3]);
  }
}

// C fragments of two n8 tiles (a 16 x 16 block) as the A fragment of a k16
// step, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x0)[4],
                                       const float (&x1)[4]) {
  a[0] = pack_f32(x0[0], x0[1]);
  a[1] = pack_f32(x0[2], x0[3]);
  a[2] = pack_f32(x1[0], x1[1]);
  a[3] = pack_f32(x1[2], x1[3]);
}

// dP = dO V^T of query tile mt for the 16-key chunks kk and kk + 1 (the
// second only where kk + 1 < KT), in one loop over the head dim.
template <int KT>
__device__ __forceinline__ void dp_chunks_bf16(float (&dp)[2][2][4],
                                               const WideHead<unsigned short>& w, int mt, int kk,
                                               int hk) {
  if (kk + 1 < KT)
    chunk2_bf16(dp[0], w.dout, w.v + kk * 16 * w.st, dp[1], w.dout, w.v + (kk + 1) * 16 * w.st,
                w.st, mt * 16, 0, hk);
  else
    chunk_bf16(dp[0], w.dout, w.v, w.st, mt * 16, kk * 16, hk);
}

// One wide bf16 forward warp task: query tile mt.  The context, normalised,
// goes to `out` (row stride D, this head's columns).
template <int KT>
__device__ __forceinline__ void wide_fwd_bf16(const WideHead<unsigned short>& w, int mt,
                                              __nv_bfloat16* out, int D) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int L = w.L, hd = w.hd, st = w.st;
  const int hk = (hd + 15) / 16, nts = (hd + 7) / 8;
  const bool last_on = (2 * KT - 1) * 8 < L;
  const bool r1_on = mt * 16 + 8 < L;
  float sc[2 * KT][4];
  wide_logits_bf16<KT>(sc, w.q, w.k, st, mt, hk, last_on);
  float mx0, mx1, inv0, inv1;
  wide_softmax<2 * KT>(sc, w.bias, w.scale_log2, last_on, r1_on, mx0, mx1, inv0, inv1);
  uint32_t pa[KT][4];  // p rounded to bf16, as A fragments of p.v
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) pack_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);

  const int r0 = mt * 16 + g, r1 = r0 + 8;
  for (int cg = 0; cg < nts; cg += 8) {  // groups of up to 8 n8 column tiles
    float oc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) oc[nt][0] = oc[nt][1] = oc[nt][2] = oc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (cg + 2 * np < nts) {
          uint32_t b[4];
          tile_bt(b, w.v, st, kk * 16, (cg + 2 * np) * 8);
          mma_bf16(oc[2 * np], pa[kk], b[0], b[1]);
          if (cg + 2 * np + 1 < nts) mma_bf16(oc[2 * np + 1], pa[kk], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (cg + nt) * 8 + 2 * c;
      if (cg + nt < nts) {
        if (r0 < L)
          put_pair(out + (size_t)r0 * D + col, col, hd, oc[nt][0] * inv0, oc[nt][1] * inv0);
        if (r1 < L)
          put_pair(out + (size_t)r1 * D + col, col, hd, oc[nt][2] * inv1, oc[nt][3] * inv1);
      }
    }
  }
}

// Phase A of the wide bf16 backward: query tile mt.  dQ (scaled) goes to
// `dq` (row stride 3D); the row statistics to w.mx, w.inv, w.dd.
template <int KT>
__device__ __forceinline__ void wide_bwd_a_bf16(const WideHead<unsigned short>& w, int mt,
                                                __nv_bfloat16* dq, int D3) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int L = w.L, hd = w.hd, st = w.st;
  const int hk = (hd + 15) / 16, nts = (hd + 7) / 8;
  const bool last_on = (2 * KT - 1) * 8 < L;
  const bool r1_on = mt * 16 + 8 < L;
  float p[2 * KT][4];
  wide_logits_bf16<KT>(p, w.q, w.k, st, mt, hk, last_on);
  float mx0, mx1, inv0, inv1;
  wide_softmax<2 * KT>(p, w.bias, w.scale_log2, last_on, r1_on, mx0, mx1, inv0, inv1);
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    p[j][0] *= inv0;
    p[j][1] *= inv0;
    p[j][2] *= inv1;
    p[j][3] *= inv1;
  }

  // D = rowsum(dP * P), dP = dO V^T two 16-key chunks at a time.
  float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; kk += 2) {
    float dp[2][2][4];
    dp_chunks_bf16<KT>(dp, w, mt, kk, hk);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kk + i < KT) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float(&pj)[4] = p[2 * (kk + i) + n];
          dd0 += pj[0] * dp[i][n][0] + pj[1] * dp[i][n][1];
          dd1 += pj[2] * dp[i][n][2] + pj[3] * dp[i][n][3];
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dd0 += __shfl_xor_sync(0xffffffffu, dd0, o);
    dd1 += __shfl_xor_sync(0xffffffffu, dd1, o);
  }
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  if (c == 0) {
    w.mx[r0] = mx0;
    w.inv[r0] = inv0;
    w.dd[r0] = dd0;
    w.mx[r1] = mx1;
    w.inv[r1] = inv1;
    w.dd[r1] = dd1;
  }

  // dS = P (dP - D) at valid keys, 0 elsewhere (dP again), dQ += dS K.
  for (int cg = 0; cg < nts; cg += 8) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 2) {
      float dp[2][2][4];
      dp_chunks_bf16<KT>(dp, w, mt, kk, hk);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kk + i < KT) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int j = 2 * (kk + i) + n;
            const float2 b = *reinterpret_cast<const float2*>(w.bias + j * 8 + 2 * c);
            const float(&pj)[4] = p[j];
            float(&x)[4] = dp[i][n];
            x[0] = b.x == 0.f ? pj[0] * (x[0] - dd0) : 0.f;
            x[1] = b.y == 0.f ? pj[1] * (x[1] - dd0) : 0.f;
            x[2] = b.x == 0.f ? pj[2] * (x[2] - dd1) : 0.f;
            x[3] = b.y == 0.f ? pj[3] * (x[3] - dd1) : 0.f;
          }
          uint32_t sa[4];
          pack_a(sa, dp[i][0], dp[i][1]);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (cg + 2 * np < nts) {
              uint32_t b[4];
              tile_bt(b, w.k, st, (kk + i) * 16, (cg + 2 * np) * 8);
              mma_bf16(acc[2 * np], sa, b[0], b[1]);
              if (cg + 2 * np + 1 < nts) mma_bf16(acc[2 * np + 1], sa, b[2], b[3]);
            }
          }
        }
      }
    }
    const float s = w.scale;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (cg + nt) * 8 + 2 * c;
      if (cg + nt < nts) {
        if (r0 < L) put_pair(dq + (size_t)r0 * D3 + col, col, hd, acc[nt][0] * s, acc[nt][1] * s);
        if (r1 < L) put_pair(dq + (size_t)r1 * D3 + col, col, hd, acc[nt][2] * s, acc[nt][3] * s);
      }
    }
  }
}

// Phase B of the wide bf16 backward: key tile kt.  dK (scaled) goes to `dk`,
// dV to `dv` (row stride 3D).
template <int KT>
__device__ __forceinline__ void wide_bwd_b_bf16(const WideHead<unsigned short>& w, int kt,
                                                __nv_bfloat16* dk, __nv_bfloat16* dv, int D3) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int L = w.L, hd = w.hd, st = w.st;
  const int hk = (hd + 15) / 16, nts = (hd + 7) / 8;
  const int k0 = kt * 16 + g, k1 = k0 + 8;  // this lane's key rows
  const float b0 = w.bias[k0], b1 = w.bias[k1];
  for (int cg = 0; cg < nts; cg += 8) {
    float av[8][4], ak[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
    for (int qc = 0; qc < KT; ++qc) {
      float pt[2][4], dst[2][4];  // P^T and dP^T, then dS^T: keys as rows
      chunk2_bf16(pt, w.k, w.q, dst, w.v, w.dout, st, kt * 16, qc * 16, hk);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qc * 16 + n * 8 + 2 * c + e;
          const float m = w.mx[qi], iv = w.inv[qi], d = w.dd[qi];
          pt[n][e] = ex2(fmaf(pt[n][e], w.scale_log2, b0) - m) * iv;
          pt[n][2 + e] = ex2(fmaf(pt[n][2 + e], w.scale_log2, b1) - m) * iv;
          dst[n][e] = b0 == 0.f ? pt[n][e] * (dst[n][e] - d) : 0.f;
          dst[n][2 + e] = b1 == 0.f ? pt[n][2 + e] * (dst[n][2 + e] - d) : 0.f;
        }
      }
      uint32_t hi[4], lo[4], sa[4];
      split_bf16(pt[0][0], pt[0][1], hi[0], lo[0]);
      split_bf16(pt[0][2], pt[0][3], hi[1], lo[1]);
      split_bf16(pt[1][0], pt[1][1], hi[2], lo[2]);
      split_bf16(pt[1][2], pt[1][3], hi[3], lo[3]);
      pack_a(sa, dst[0], dst[1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (cg + 2 * np < nts) {
          const bool two = cg + 2 * np + 1 < nts;
          uint32_t b[4];
          tile_bt(b, w.dout, st, qc * 16, (cg + 2 * np) * 8);
          mma_bf16(av[2 * np], hi, b[0], b[1]);
          mma_bf16(av[2 * np], lo, b[0], b[1]);
          if (two) {
            mma_bf16(av[2 * np + 1], hi, b[2], b[3]);
            mma_bf16(av[2 * np + 1], lo, b[2], b[3]);
          }
          tile_bt(b, w.q, st, qc * 16, (cg + 2 * np) * 8);
          mma_bf16(ak[2 * np], sa, b[0], b[1]);
          if (two) mma_bf16(ak[2 * np + 1], sa, b[2], b[3]);
        }
      }
    }
    const float s = w.scale;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (cg + nt) * 8 + 2 * c;
      if (cg + nt < nts) {
        if (k0 < L) {
          put_pair(dk + (size_t)k0 * D3 + col, col, hd, ak[nt][0] * s, ak[nt][1] * s);
          put_pair(dv + (size_t)k0 * D3 + col, col, hd, av[nt][0], av[nt][1]);
        }
        if (k1 < L) {
          put_pair(dk + (size_t)k1 * D3 + col, col, hd, ak[nt][2] * s, ak[nt][3] * s);
          put_pair(dv + (size_t)k1 * D3 + col, col, hd, av[nt][2], av[nt][3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ wide, f32 ---

// S = q k^T of query tile mt, split TF32 over k8 steps of the head dim.
template <int KT>
__device__ __forceinline__ void wide_logits_f32(float (&sc)[2 * KT][4], const float* q,
                                                const float* k, int st, int mt, int nks,
                                                bool last_on) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const float* q0 = q + (mt * 16 + g) * st + c;
  const float* q1 = q0 + 8 * st;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    const int d = ks * 8;
    const FragA a = frag_a(q0[d], q1[d], q0[d + 4], q1[d + 4]);
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      if (j < 2 * KT - 1 || last_on) {
        const float* kr = k + (j * 8 + g) * st + c + d;
        mma3(sc[j], a, frag_b(kr[0], kr[4]));
      }
    }
  }
}

// a b^T for one 16-row tile (rows r0 of `a`) and one 16-key chunk (rows n0
// of `b`), split TF32, for NC such (a, b) pairs at once (phase B: S^T and
// dP^T).  The main product a_hi b_hi and the two corrections sum in
// separate accumulators, added at the end: 6 NC independent chains of
// mma.sync over the head dim, not 2 NC chains of three dependent products
// (the f32 backward at (512, 96, 768, 16) is latency-bound on them).
template <int NC>
__device__ __forceinline__ void chunks_f32(float (&x)[NC][2][4], const float* const (&a)[NC],
                                           const float* const (&b)[NC], int st, int r0, int n0,
                                           int nks) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  float lo[NC][2][2][4];  // the two corrections of each tile
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][n][e] = lo[i][n][0][e] = lo[i][n][1][e] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    const int d = ks * 8 + c;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float* a0 = a[i] + (r0 + g) * st + d;
      const float* a1 = a0 + 8 * st;
      const FragA fa = frag_a(a0[0], a1[0], a0[4], a1[4]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* bn = b[i] + (n0 + 8 * n + g) * st + d;
        const FragB fb = frag_b(bn[0], bn[4]);
        mma_tf32(lo[i][n][0], fa.lo, fb.hi[0], fb.hi[1]);
        mma_tf32(lo[i][n][1], fa.hi, fb.lo[0], fb.lo[1]);
        mma_tf32(x[i][n], fa.hi, fb.hi[0], fb.hi[1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][n][e] += lo[i][n][0][e] + lo[i][n][1][e];
}

__device__ __forceinline__ void chunk_f32(float (&x)[2][4], const float* a, const float* b, int st,
                                          int r0, int n0, int nks) {
  float y[1][2][4];
  const float* const pa[1] = {a};
  const float* const pb[1] = {b};
  chunks_f32<1>(y, pa, pb, st, r0, n0, nks);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = y[0][n][e];
}

// dP = dO V^T of query tile mt for the 16-key chunks kk and kk + 1 (the
// second only where kk + 1 < KT), in one loop over the head dim.
template <int KT>
__device__ __forceinline__ void dp_chunks_f32(float (&dp)[2][2][4], const WideHead<float>& w,
                                              int mt, int kk, int nks) {
  if (kk + 1 < KT) {
    const float* const a[2] = {w.dout, w.dout};
    const float* const b[2] = {w.v + kk * 16 * w.st, w.v + (kk + 1) * 16 * w.st};
    chunks_f32<2>(dp, a, b, w.st, mt * 16, 0, nks);
  } else {
    chunk_f32(dp[0], w.dout, w.v, w.st, mt * 16, kk * 16, nks);
  }
}

template <int KT>
__device__ __forceinline__ void wide_fwd_f32(const WideHead<float>& w, int mt, float* out, int D) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int L = w.L, hd = w.hd, st = w.st;
  const int nts = (hd + 7) / 8;
  const bool last_on = (2 * KT - 1) * 8 < L;
  const bool r1_on = mt * 16 + 8 < L;
  float sc[2 * KT][4];
  wide_logits_f32<KT>(sc, w.q, w.k, st, mt, nts, last_on);
  float mx0, mx1, inv0, inv1;
  wide_softmax<2 * KT>(sc, w.bias, w.scale_log2, last_on, r1_on, mx0, mx1, inv0, inv1);

  const int r0 = mt * 16 + g, r1 = r0 + 8;
  for (int cg = 0; cg < nts; cg += 8) {
    float oc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) oc[nt][0] = oc[nt][1] = oc[nt][2] = oc[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      if (j < 2 * KT - 1 || last_on) {
        // p as the A operand straight from the accumulators: k index c is
        // key 2c, c + 4 is key 2c + 1
        const FragA pa = frag_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
        const float* v0 = w.v + (j * 8 + 2 * c) * st + cg * 8 + g;
        const float* v1 = v0 + st;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          if (cg + nt < nts) mma3(oc[nt], pa, frag_b(v0[nt * 8], v1[nt * 8]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (cg + nt) * 8 + 2 * c;
      if (cg + nt < nts) {
        if (r0 < L)
          put_pair(out + (size_t)r0 * D + col, col, hd, oc[nt][0] * inv0, oc[nt][1] * inv0);
        if (r1 < L)
          put_pair(out + (size_t)r1 * D + col, col, hd, oc[nt][2] * inv1, oc[nt][3] * inv1);
      }
    }
  }
}

// Phase A of the wide f32 backward (as wide_bwd_a_bf16, split TF32; dS
// goes into dQ = dS K as A operands straight from the accumulators, k index
// c as key 2c and c + 4 as key 2c + 1).
template <int KT>
__device__ __forceinline__ void wide_bwd_a_f32(const WideHead<float>& w, int mt, float* dq,
                                               int D3) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int L = w.L, hd = w.hd, st = w.st;
  const int nts = (hd + 7) / 8;
  const bool last_on = (2 * KT - 1) * 8 < L;
  const bool r1_on = mt * 16 + 8 < L;
  float p[2 * KT][4];
  wide_logits_f32<KT>(p, w.q, w.k, st, mt, nts, last_on);
  float mx0, mx1, inv0, inv1;
  wide_softmax<2 * KT>(p, w.bias, w.scale_log2, last_on, r1_on, mx0, mx1, inv0, inv1);
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    p[j][0] *= inv0;
    p[j][1] *= inv0;
    p[j][2] *= inv1;
    p[j][3] *= inv1;
  }
  float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; kk += 2) {
    float dp[2][2][4];
    dp_chunks_f32<KT>(dp, w, mt, kk, nts);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kk + i < KT) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float(&pj)[4] = p[2 * (kk + i) + n];
          dd0 += pj[0] * dp[i][n][0] + pj[1] * dp[i][n][1];
          dd1 += pj[2] * dp[i][n][2] + pj[3] * dp[i][n][3];
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dd0 += __shfl_xor_sync(0xffffffffu, dd0, o);
    dd1 += __shfl_xor_sync(0xffffffffu, dd1, o);
  }
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  if (c == 0) {
    w.mx[r0] = mx0;
    w.inv[r0] = inv0;
    w.dd[r0] = dd0;
    w.mx[r1] = mx1;
    w.inv[r1] = inv1;
    w.dd[r1] = dd1;
  }
  for (int cg = 0; cg < nts; cg += 8) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 2) {
      float dp[2][2][4];
      dp_chunks_f32<KT>(dp, w, mt, kk, nts);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kk + i < KT) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int j = 2 * (kk + i) + n;
            const float2 b = *reinterpret_cast<const float2*>(w.bias + j * 8 + 2 * c);
            const float x0 = b.x == 0.f ? p[j][0] * (dp[i][n][0] - dd0) : 0.f;
            const float x1 = b.y == 0.f ? p[j][1] * (dp[i][n][1] - dd0) : 0.f;
            const float x2 = b.x == 0.f ? p[j][2] * (dp[i][n][2] - dd1) : 0.f;
            const float x3 = b.y == 0.f ? p[j][3] * (dp[i][n][3] - dd1) : 0.f;
            const FragA da = frag_a(x0, x2, x1, x3);
            const float* kr0 = w.k + (j * 8 + 2 * c) * st + cg * 8 + g;
            const float* kr1 = kr0 + st;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              if (cg + nt < nts) {  // a fresh accumulator per 8 keys, as phase B's
                float t[4] = {0.f, 0.f, 0.f, 0.f};
                mma3(t, da, frag_b(kr0[nt * 8], kr1[nt * 8]));
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nt][e] += t[e];
              }
            }
          }
        }
      }
    }
    const float s = w.scale;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (cg + nt) * 8 + 2 * c;
      if (cg + nt < nts) {
        if (r0 < L) put_pair(dq + (size_t)r0 * D3 + col, col, hd, acc[nt][0] * s, acc[nt][1] * s);
        if (r1 < L) put_pair(dq + (size_t)r1 * D3 + col, col, hd, acc[nt][2] * s, acc[nt][3] * s);
      }
    }
  }
}

// S^T = K Q^T and dP^T = V dO^T of key tile kt and query chunk qc (16
// queries), each value bit for bit what phase A formed for S and dP: the
// same split-TF32 products (the same TF32 parts, multiplied exactly) summed
// in the same order, phase A's A operand now the B operand.  Phase A sums
// S as q_lo k_hi + q_hi k_lo + q_hi k_hi in one accumulator (mma3) and dP
// with its two corrections apart (chunks_f32).  So P^T and dS^T equal
// phase A's P and dS: a recomputed logit one ulp off phase A's row max moved
// a P near 1 by 1e-6, and dV (a sum of dO over every query where one key
// takes all the attention) by 1.2e-5 from a float64 reference at
// (512, 96, 768, 16) on the H100.
__device__ __forceinline__ void logits_t_f32(float (&pt)[2][4], float (&dpt)[2][4],
                                             const WideHead<float>& w, int kt, int qc, int nks) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int st = w.st;
  const float* k0 = w.k + (kt * 16 + g) * st + c;
  const float* v0 = w.v + (kt * 16 + g) * st + c;
  float lo[2][2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pt[n][e] = dpt[n][e] = lo[n][0][e] = lo[n][1][e] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    const int d = ks * 8;
    const FragA ka = frag_a(k0[d], k0[8 * st + d], k0[d + 4], k0[8 * st + d + 4]);
    const FragA va = frag_a(v0[d], v0[8 * st + d], v0[d + 4], v0[8 * st + d + 4]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float* qr = w.q + (qc * 16 + 8 * n + g) * st + c + d;
      const float* orow = w.dout + (qc * 16 + 8 * n + g) * st + c + d;
      const FragB qb = frag_b(qr[0], qr[4]);
      const FragB ob = frag_b(orow[0], orow[4]);
      mma_tf32(pt[n], ka.hi, qb.lo[0], qb.lo[1]);  // q_lo k_hi
      mma_tf32(pt[n], ka.lo, qb.hi[0], qb.hi[1]);  // q_hi k_lo
      mma_tf32(pt[n], ka.hi, qb.hi[0], qb.hi[1]);
      mma_tf32(lo[n][0], va.hi, ob.lo[0], ob.lo[1]);  // dO_lo v_hi
      mma_tf32(lo[n][1], va.lo, ob.hi[0], ob.hi[1]);  // dO_hi v_lo
      mma_tf32(dpt[n], va.hi, ob.hi[0], ob.hi[1]);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dpt[n][e] += lo[n][0][e] + lo[n][1][e];
}

// Phase B of the wide f32 backward: key tile kt, keys as rows; P^T and dS^T
// go into dV and dK as A operands straight from the accumulators (k index c
// as query 2c, c + 4 as query 2c + 1).
template <int KT>
__device__ __forceinline__ void wide_bwd_b_f32(const WideHead<float>& w, int kt, float* dk,
                                               float* dv, int D3) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int L = w.L, hd = w.hd, st = w.st;
  const int nts = (hd + 7) / 8;
  const int k0 = kt * 16 + g, k1 = k0 + 8;
  const float b0 = w.bias[k0], b1 = w.bias[k1];
  for (int cg = 0; cg < nts; cg += 8) {
    float av[8][4], ak[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
    for (int qc = 0; qc < KT; ++qc) {
      float pt[2][4], dst[2][4];  // P^T and dP^T, then dS^T: keys as rows
      logits_t_f32(pt, dst, w, kt, qc, nts);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qc * 16 + n * 8 + 2 * c + e;
          const float m = w.mx[qi], iv = w.inv[qi], d = w.dd[qi];
          pt[n][e] = ex2(fmaf(pt[n][e], w.scale_log2, b0) - m) * iv;
          pt[n][2 + e] = ex2(fmaf(pt[n][2 + e], w.scale_log2, b1) - m) * iv;
          dst[n][e] = b0 == 0.f ? pt[n][e] * (dst[n][e] - d) : 0.f;
          dst[n][2 + e] = b1 == 0.f ? pt[n][2 + e] * (dst[n][2 + e] - d) : 0.f;
        }
      }
      // Each 8-query product sums in a fresh accumulator and joins dV / dK
      // by an f32 add: chained through one accumulator over all L queries,
      // the tensor cores' sums drifted by 2e-5 from a float64 reference at
      // (512, 96, 768, 16) where one key takes all the attention of every
      // query (H100), past the 1e-5 tolerance.
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const FragA pa = frag_a(pt[n][0], pt[n][2], pt[n][1], pt[n][3]);
        const FragA sa = frag_a(dst[n][0], dst[n][2], dst[n][1], dst[n][3]);
        const int qa = qc * 16 + n * 8 + 2 * c;  // queries 2c, 2c + 1 of this n8 tile
        const float* o0 = w.dout + qa * st + cg * 8 + g;
        const float* q0 = w.q + qa * st + cg * 8 + g;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (cg + nt < nts) {
            float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(tv, pa, frag_b(o0[nt * 8], o0[st + nt * 8]));
            mma3(tk, sa, frag_b(q0[nt * 8], q0[st + nt * 8]));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              av[nt][e] += tv[e];
              ak[nt][e] += tk[e];
            }
          }
        }
      }
    }
    const float s = w.scale;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (cg + nt) * 8 + 2 * c;
      if (cg + nt < nts) {
        if (k0 < L) {
          put_pair(dk + (size_t)k0 * D3 + col, col, hd, ak[nt][0] * s, ak[nt][1] * s);
          put_pair(dv + (size_t)k0 * D3 + col, col, hd, av[nt][0], av[nt][1]);
        }
        if (k1 < L) {
          put_pair(dk + (size_t)k1 * D3 + col, col, hd, ak[nt][2] * s, ak[nt][3] * s);
          put_pair(dv + (size_t)k1 * D3 + col, col, hd, av[nt][2], av[nt][3]);
        }
      }
    }
  }
}

// ------------------------------------------------------- wide, kernels ---

// The staged arrays of one block (q, k, v, then dO) as the warp tasks see
// them: bits of bf16, or f32.
template <typename T>
struct Staged {
  using type = float;
};
template <>
struct Staged<__nv_bfloat16> {
  using type = unsigned short;
};

// Stage head blockIdx.x % H of sequence blockIdx.x / H: `parts` arrays of
// its columns of `src` (q, k, v of qkv; then dO), zero-padded, the key
// biases and, for the backward, room for the row statistics.
template <typename T>
__device__ WideHead<typename Staged<T>::type> wide_stage(const T* qkv, const uint8_t* mask,
                                                         const T* dout, int L, int D, int H,
                                                         float scale_log2, char* smem) {
  using S = typename Staged<T>::type;
  const int hd = D / H;
  const int h = blockIdx.x % H;
  const size_t u = blockIdx.x / H;
  const int Lp = (L + 15) / 16 * 16;
  const int st = wide_stride(hd, sizeof(T));
  const int hdp = sizeof(T) == 2 ? (hd + 15) / 16 * 16 : (hd + 7) / 8 * 8;
  const int parts = dout ? 4 : 3;
  S* arr = reinterpret_cast<S*>(smem);
  float* stats = reinterpret_cast<float*>(smem + (size_t)parts * Lp * st * sizeof(T));
  stage_head(arr, reinterpret_cast<const S*>(qkv) + u * L * 3 * D + h * hd, L, 3, hd,
             3 * (size_t)D, (size_t)D, st, Lp);
  if (dout)
    stage_head(arr + 3 * (size_t)Lp * st, reinterpret_cast<const S*>(dout) + u * L * D + h * hd, L,
               1, hd, (size_t)D, 0, st, Lp);
  zero_pad(arr, parts, L, Lp, hd, hdp, st);
  wide_biases(stats, mask + u * L, L, Lp);
  WideHead<S> w;
  const S* a = arr;
  w.q = a;
  w.k = a + (size_t)Lp * st;
  w.v = a + 2 * (size_t)Lp * st;
  w.dout = a + 3 * (size_t)Lp * st;
  w.bias = stats;
  w.mx = stats + Lp;
  w.inv = stats + 2 * Lp;
  w.dd = stats + 3 * Lp;
  w.L = L;
  w.hd = hd;
  w.st = st;
  w.scale_log2 = scale_log2;
  w.scale = 1.f / sqrtf((float)hd);
  return w;
}

// Blocks an SM that the register budget is set for: about 112 registers a
// thread for the bf16 forward, 128 for the bf16 backward, 168 for the f32
// instances (split TF32 holds each operand fragment twice).  On the H100
// (`nvcc -Xptxas -v`, kernel_bench): 112 left the bf16 backward at L = 96
// 192 bytes of spill and 128 the f32 instances up to 492, while 128 made
// the bf16 forward at L = 96 25% slower than 112 (two blocks an SM, not
// three).
template <typename T, bool BWD>
__host__ __device__ constexpr int wide_min_blocks(int KT) {
  return 65536 / (32 * KT * (sizeof(T) == 4 ? 168 : BWD ? 128 : 112));  // >= 1 for KT <= 8
}

// One block per (sequence, head), warp mt runs query tile mt.
template <typename T, int KT>
__global__ void __launch_bounds__(32 * KT, wide_min_blocks<T, false>(KT))
    mhsa_wide_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, int L, int D, int H, float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  const auto w = wide_stage<T>(qkv, mask, nullptr, L, D, H, scale_log2, smem);
  cp_async_wait_all();
  __syncthreads();
  const int mt = threadIdx.x >> 5;
  T* o = out + (size_t)(blockIdx.x / H) * L * D + (blockIdx.x % H) * w.hd;
  if constexpr (sizeof(T) == 2)
    wide_fwd_bf16<KT>(w, mt, o, D);
  else
    wide_fwd_f32<KT>(w, mt, o, D);
}

// One block per (sequence, head): phase A (warp mt: query tile mt), a
// barrier, phase B (warp kt: key tile kt).
template <typename T, int KT>
__global__ void __launch_bounds__(32 * KT, wide_min_blocks<T, true>(KT))
    mhsa_bwd_wide_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const T* __restrict__ dout, T* __restrict__ dqkv, int L, int D, int H,
                         float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  const auto w = wide_stage<T>(qkv, mask, dout, L, D, H, scale_log2, smem);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  T* g = dqkv + (size_t)(blockIdx.x / H) * L * 3 * D + (blockIdx.x % H) * w.hd;
  if constexpr (sizeof(T) == 2)
    wide_bwd_a_bf16<KT>(w, warp, g, 3 * D);
  else
    wide_bwd_a_f32<KT>(w, warp, g, 3 * D);
  __syncthreads();
  if constexpr (sizeof(T) == 2)
    wide_bwd_b_bf16<KT>(w, warp, g + D, g + 2 * D, 3 * D);
  else
    wide_bwd_b_f32<KT>(w, warp, g + D, g + 2 * D, 3 * D);
}

// ---------------------------------------------------------------- long ---
//
// The streaming instances ("long"), in both types: every shape outside the
// box of kernel_box, that is L above 128, head dims above 64 at L above 64,
// and head dims above 128, up to kMaxHeadDim (1,024, bert-large's width as
// one head) at any L.  NRMS's user encoder at data.max_history_len = 200
// (L = 200, 15 heads of 20), the PLM head at tokenizer_max_len = 256 (16
// heads of 48), CAUM's default head dim 100 at L = 100 and two heads over
// 300 (head dim 150) run here.  Shapes inside the box keep their instances.
//
// Like the TPU kernel (_attention_kernel, ops/mhsa.py:105), the forward
// streams the keys with an online softmax whose running max starts at the
// finite -1e30 (never -inf): a tile whose keys are all masked then leaves
// the running state as it was, and a fully masked sequence ends with the
// uniform mean of v over its L keys, however many tiles they span.
//
// What bounds it on the H100.  At the train user encoder's (64, 200, 300,
// 15) the products: 4 U L^2 D = 3.1 GFLOP against 23 MB of qkv and
// context, so 0.046 ms at the f32 CUDA-core rate against 0.007 ms of bytes
// (bf16: 0.0031 ms on the tensor cores, 0.0052 ms of bytes).  This first
// version is the simple one, without tensor cores: every product runs
// in f32 FMA on the CUDA cores, from tiles staged in shared memory as f32
// (bf16 is upcast when staged), so both types get the plain version's f32
// sums in another order (float32 within 1e-5; bf16 rounds once, at the
// output).  Making it fast (mma.sync / wgmma, TMA, a ring of tiles) is
// later work.  The design:
//
// * Tiles of T rows, T from the head dim (long_tile: 64 up to head dim 64,
//   32 up to 256, 16 up to 512, 8 up to 1,024), so that the largest block
//   (the dK/dV kernel's six T x hd tiles and two T x T ones) fits the
//   232,448 bytes of shared memory.  Rows are staged with an odd stride
//   (hd | 1 floats), so the column reads of the products fall in distinct
//   banks.  Rows past L are staged as zeros; keys past L take the bias
//   -inf (p = 0), masked keys -1e30.  All offsets into qkv, dO and the
//   outputs are 64-bit: U L 3D passes 2^31 values at PLM widths.
// * 128 threads a block.  The T x T logit tile is computed in registers,
//   a thread holding T / 16 rows (rows ty + 16 a) by T / 8 keys (tx + 8 b);
//   the 8 threads of a row are neighbouring lanes, so the row max and sum
//   of the online softmax are three shuffles each.  The p (or dS) tile then
//   goes to shared memory, and the T x hd product with v (or k, q, dO)
//   accumulates into an f32 tile in shared memory, each thread a 4 x 4
//   block of it (rows r + T / 4 a, columns 4 c .. 4 c + 3) per turn.
// * Forward: one block per (sequence, head, query tile); the key and value
//   tiles stream through shared memory.
// * Backward, FlashAttention-2's split, three launches, no atomics:
//   (1) one block per query tile streams the keys as the forward does and
//   writes per query row its max (in log2 units), 1 / sum and D =
//   rowsum(dP * P), summed online, into a workspace of U H L x 3 floats
//   (nrl_mhsa_bwd_workspace; the wrapper allocates it through torch's
//   allocator); (2) one block per query tile: P from those
//   statistics, dP = dO V^T, dS = P (dP - D) and 0 at masked keys, dQ +=
//   dS K over the key tiles; (3) one block per key tile: the same P^T and
//   dS^T with keys as the rows, dV += P^T dO and dK += dS^T Q over the
//   query tiles.  (2) and (3) form each logit as the same chain of FMAs in
//   the same order, so P is the same bits in both, and (1) forms dP as
//   they do, so dP - D cancels as in the plain version.  A fully masked
//   sequence gets dS = 0, so no gradient on q and k, and dV = the mean of
//   dO.
constexpr int kLongThreads = 128;

// Rows of a tile, from the head dim.
__host__ __device__ inline int long_tile(int hd) {
  return hd <= 64 ? 64 : hd <= 256 ? 32 : hd <= 512 ? 16 : 8;
}
// Shared memory of the long kernels: 0 the forward (the backward's
// statistics kernel needs less), 1 the dQ kernel, 2 the dK / dV kernel (the
// largest): T x hs tiles (hs = hd | 1 floats a row), T x (T + 1) tiles of p
// or dS, and four vectors of T floats.
__host__ __device__ inline size_t long_smem(int hd, int kind) {
  const size_t T = long_tile(hd), hs = hd | 1;
  return 4 * ((kind + 4) * T * hs + (kind == 2 ? 2 : 1) * T * (T + 1) + 4 * T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows r0 .. r0 + T - 1 of one head's hd columns of a sequence (`src`: its
// row 0 at the head's first column, rows `row` values apart) into `dst` as
// f32 (T rows of hs floats), rows at or past L as zeros; a warp a row.
template <typename E>
__device__ void long_stage(float* dst, const E* src, size_t row, int r0, int T, int L, int hd,
                           int hs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < T; r += kLongThreads / 32) {
    if (r0 + r < L) {
      const E* s = src + (size_t)(r0 + r) * row;
      for (int c = lane; c < hd; c += 32) dst[r * hs + c] = to_f32(s[c]);
    } else {
      for (int c = lane; c < hd; c += 32) dst[r * hs + c] = 0.f;
    }
  }
}

// Key biases of keys k0 .. k0 + T - 1: 0 (valid), -1e30 (masked), -inf (past L).
__device__ void long_biases(float* sbias, const uint8_t* msk, int k0, int T, int L) {
  for (int j = threadIdx.x; j < T; j += kLongThreads)
    sbias[j] = k0 + j < L ? (msk[k0 + j] ? 0.f : kMaskMin) : -INFINITY;
}

// Per query row q0 + i of the tile: max (log2 units), 1 / sum and D from
// the workspace, 0 past L (so that P recomputed from them is 0).
__device__ void long_load_stats(float* sm, float* sinv, float* sdd, const float* stats, int q0,
                                int T, int L) {
  for (int i = threadIdx.x; i < T; i += kLongThreads) {
    const bool on = q0 + i < L;
    sm[i] = on ? stats[3 * (size_t)(q0 + i)] : 0.f;
    sinv[i] = on ? stats[3 * (size_t)(q0 + i) + 1] : 0.f;
    sdd[i] = on ? stats[3 * (size_t)(q0 + i) + 2] : 0.f;
  }
}

template <int T>
struct LongTile {
  static constexpr int TM = T >= 16 ? T / 16 : 1;  // rows of a thread (ty + 16 a)
  static constexpr int TN = T / 8;                 // columns of a thread (tx + 8 b)
  static constexpr int RT = T >= 16 ? 16 : T;      // threads down the rows (ty < RT)
};

// NP tiles of dot products at once: acc[p][a][b] = sum over k < hd of
// ra[p][row a] * cb[p][row b], one FMA chain in k order (so the same logit
// comes out the same bits whichever side holds the queries).
template <int T, int NP>
__device__ __forceinline__ void long_dots(float (&acc)[NP][LongTile<T>::TM][LongTile<T>::TN],
                                          const float* const (&ra)[NP],
                                          const float* const (&cb)[NP], int ty, int tx, int hd,
                                          int hs) {
  using LT = LongTile<T>;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int a = 0; a < LT::TM; ++a)
#pragma unroll
      for (int b = 0; b < LT::TN; ++b) acc[p][a][b] = 0.f;
  for (int k = 0; k < hd; ++k) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float x[LT::TM], y[LT::TN];
#pragma unroll
      for (int a = 0; a < LT::TM; ++a) x[a] = ra[p][(ty + 16 * a) * hs + k];
#pragma unroll
      for (int b = 0; b < LT::TN; ++b) y[b] = cb[p][(tx + 8 * b) * hs + k];
#pragma unroll
      for (int a = 0; a < LT::TM; ++a)
#pragma unroll
        for (int b = 0; b < LT::TN; ++b) acc[p][a][b] = fmaf(x[a], y[b], acc[p][a][b]);
    }
  }
}

// acc (T x hd, rows of hs) = acc * rowscale[i] (where given) + A B, with A
// a T x T tile (rows of T + 1) and B T x hd (rows of hs); a thread a 4 x 4
// block per turn: rows r + T / 4 a, columns 4 c .. 4 c + 3 below hd.
template <int T>
__device__ void long_accum(float* acc, const float* A, const float* B, const float* rowscale,
                           int hd, int hs) {
  constexpr int RG = T / 4;
  const int blocks = RG * ((hd + 3) / 4);
  for (int t = threadIdx.x; t < blocks; t += kLongThreads) {
    const int r = t % RG, c0 = t / RG * 4;
    int col[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) col[b] = c0 + b < hd ? c0 + b : hd - 1;
    float o[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = r + RG * a;
      const float s = rowscale ? rowscale[i] : 1.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) o[a][b] = acc[i * hs + col[b]] * s;
    }
    for (int j = 0; j < T; ++j) {
      float x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = A[(r + RG * a) * (T + 1) + j];
#pragma unroll
      for (int b = 0; b < 4; ++b) y[b] = B[j * hs + col[b]];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) o[a][b] = fmaf(x[a], y[b], o[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c0 + b < hd) acc[(r + RG * a) * hs + c0 + b] = o[a][b];
  }
}

// Zero n floats of shared memory.
__device__ void long_zero(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kLongThreads) dst[i] = 0.f;
}

// Sum over the 8 neighbouring lanes of a row (max with MAX).
template <bool MAX>
__device__ __forceinline__ float row8(float x) {
#pragma unroll
  for (int o = 1; o <= 4; o <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  return x;
}

// The block's (sequence, head, tile) from blockIdx.x, tiles fastest.
struct LongBlock {
  size_t u;
  int h, t0;
};
__device__ __forceinline__ LongBlock long_block(int H, int ntiles, int T) {
  const size_t b = blockIdx.x;
  const size_t uh = b / ntiles;
  return LongBlock{uh / H, (int)(uh % H), (int)(b % ntiles) * T};
}

// Forward: one block per (sequence, head, query tile), the key tiles
// streamed with the online softmax.
template <typename E, int T>
__global__ void __launch_bounds__(kLongThreads)
    mhsa_long_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                     E* __restrict__ out, int L, int D, int H, float scale_log2) {
  using LT = LongTile<T>;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, hs = hd | 1;
  const LongBlock blk = long_block(H, (L + T - 1) / T, T);
  float* sq = reinterpret_cast<float*>(smem);
  float* so = sq + T * hs;
  float* sk = so + T * hs;
  float* sv = sk + T * hs;
  float* sp = sv + T * hs;
  float* sbias = sp + T * (T + 1);
  float* salpha = sbias + T;
  float* sinv = salpha + T;
  const E* base = qkv + blk.u * L * 3 * D + (size_t)blk.h * hd;
  const uint8_t* msk = mask + blk.u * L;
  long_stage(sq, base, 3 * (size_t)D, blk.t0, T, L, hd, hs);
  long_zero(so, T * hs);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const bool on = ty < LT::RT;
  float m_run[LT::TM], l_run[LT::TM];
#pragma unroll
  for (int a = 0; a < LT::TM; ++a) {
    m_run[a] = kMaskMin;
    l_run[a] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += T) {
    long_stage(sk, base + D, 3 * (size_t)D, k0, T, L, hd, hs);
    long_stage(sv, base + 2 * D, 3 * (size_t)D, k0, T, L, hd, hs);
    long_biases(sbias, msk, k0, T, L);
    __syncthreads();
    if (on) {
      float s[1][LT::TM][LT::TN];
      const float* const ra[1] = {sq};
      const float* const cb[1] = {sk};
      long_dots<T, 1>(s, ra, cb, ty, tx, hd, hs);
#pragma unroll
      for (int a = 0; a < LT::TM; ++a) {
        const int i = ty + 16 * a;
        float mx = -INFINITY;
#pragma unroll
        for (int b = 0; b < LT::TN; ++b) {
          s[0][a][b] = fmaf(s[0][a][b], scale_log2, sbias[tx + 8 * b]);
          mx = fmaxf(mx, s[0][a][b]);
        }
        const float m_new = fmaxf(m_run[a], row8<true>(mx));
        const float alpha = ex2(m_run[a] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < LT::TN; ++b) {
          const float p = ex2(s[0][a][b] - m_new);
          sp[i * (T + 1) + tx + 8 * b] = p;
          sum += p;
        }
        l_run[a] = l_run[a] * alpha + row8<false>(sum);
        m_run[a] = m_new;
        if (tx == 0) salpha[i] = alpha;
      }
    }
    __syncthreads();
    long_accum<T>(so, sp, sv, salpha, hd, hs);
    __syncthreads();
  }
  if (on && tx == 0) {
#pragma unroll
    for (int a = 0; a < LT::TM; ++a) sinv[ty + 16 * a] = 1.f / l_run[a];  // >= 1: 2^0 is a term
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = L - blk.t0 < T ? L - blk.t0 : T;
  E* o = out + (blk.u * L + blk.t0) * D + (size_t)blk.h * hd;
  for (int i = warp; i < rows; i += kLongThreads / 32)
    for (int c = lane; c < hd; c += 32) from_f32(o + (size_t)i * D + c, so[i * hs + c] * sinv[i]);
}

// Backward, the row statistics: one block per (sequence, head, query
// tile), the key tiles streamed; per query row its max (log2 units), 1 /
// sum and D = rowsum(dP * P) into stats ((U, H, L) x 3 floats).  D sums
// p dP online as the forward sums p v, with dP = dO V^T formed by the same
// FMA chains as the dQ and dK / dV kernels form it, so that dP - D cancels
// as it does in the plain version (a row with one valid key gets dS = 0).
template <typename E, int T>
__global__ void __launch_bounds__(kLongThreads)
    mhsa_long_stats_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                           const E* __restrict__ dout, float* __restrict__ stats, int L, int D,
                           int H, float scale_log2) {
  using LT = LongTile<T>;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, hs = hd | 1;
  const LongBlock blk = long_block(H, (L + T - 1) / T, T);
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + T * hs;
  float* sk = sdo + T * hs;
  float* sv = sk + T * hs;
  float* sbias = sv + T * hs;
  const E* base = qkv + blk.u * L * 3 * D + (size_t)blk.h * hd;
  const uint8_t* msk = mask + blk.u * L;
  long_stage(sq, base, 3 * (size_t)D, blk.t0, T, L, hd, hs);
  long_stage(sdo, dout + blk.u * L * D + (size_t)blk.h * hd, (size_t)D, blk.t0, T, L, hd, hs);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const bool on = ty < LT::RT;
  float m_run[LT::TM], l_run[LT::TM], d_run[LT::TM];
#pragma unroll
  for (int a = 0; a < LT::TM; ++a) {
    m_run[a] = kMaskMin;
    l_run[a] = d_run[a] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += T) {
    long_stage(sk, base + D, 3 * (size_t)D, k0, T, L, hd, hs);
    long_stage(sv, base + 2 * D, 3 * (size_t)D, k0, T, L, hd, hs);
    long_biases(sbias, msk, k0, T, L);
    __syncthreads();
    if (on) {
      float x[2][LT::TM][LT::TN];
      const float* const ra[2] = {sq, sdo};
      const float* const cb[2] = {sk, sv};
      long_dots<T, 2>(x, ra, cb, ty, tx, hd, hs);
#pragma unroll
      for (int a = 0; a < LT::TM; ++a) {
        float mx = -INFINITY;
#pragma unroll
        for (int b = 0; b < LT::TN; ++b) {
          x[0][a][b] = fmaf(x[0][a][b], scale_log2, sbias[tx + 8 * b]);
          mx = fmaxf(mx, x[0][a][b]);
        }
        const float m_new = fmaxf(m_run[a], row8<true>(mx));
        const float alpha = ex2(m_run[a] - m_new);
        float sum = 0.f, dsum = 0.f;
#pragma unroll
        for (int b = 0; b < LT::TN; ++b) {
          const float p = ex2(x[0][a][b] - m_new);
          sum += p;
          dsum = fmaf(p, x[1][a][b], dsum);
        }
        l_run[a] = l_run[a] * alpha + row8<false>(sum);
        d_run[a] = d_run[a] * alpha + row8<false>(dsum);
        m_run[a] = m_new;
      }
    }
    __syncthreads();
  }
  if (on && tx == 0) {
    float* st = stats + ((blk.u * H + blk.h) * L + blk.t0) * 3;
#pragma unroll
    for (int a = 0; a < LT::TM; ++a) {
      const int i = ty + 16 * a;
      if (blk.t0 + i < L) {
        st[3 * i] = m_run[a];
        st[3 * i + 1] = 1.f / l_run[a];
        st[3 * i + 2] = d_run[a] / l_run[a];
      }
    }
  }
}

// P and dS of one logit from its dot products, bias and query statistics.
__device__ __forceinline__ void long_p_ds(float s, float dp, float bias, float m, float inv,
                                          float dd, float scale_log2, float& p, float& ds) {
  p = ex2(fmaf(s, scale_log2, bias) - m) * inv;
  ds = bias == 0.f ? p * (dp - dd) : 0.f;
}

// Backward, dQ: one block per (sequence, head, query tile), the key tiles
// streamed: dQ = scale sum over keys of dS K.
template <typename E, int T>
__global__ void __launch_bounds__(kLongThreads)
    mhsa_long_dq_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        const E* __restrict__ dout, const float* __restrict__ stats,
                        E* __restrict__ dqkv, int L, int D, int H, float scale_log2,
                        float scale) {
  using LT = LongTile<T>;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, hs = hd | 1;
  const LongBlock blk = long_block(H, (L + T - 1) / T, T);
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + T * hs;
  float* sdq = sdo + T * hs;
  float* sk = sdq + T * hs;
  float* sv = sk + T * hs;
  float* sds = sv + T * hs;
  float* sbias = sds + T * (T + 1);
  float* sm = sbias + T;
  float* sinv = sm + T;
  float* sdd = sinv + T;
  const E* base = qkv + blk.u * L * 3 * D + (size_t)blk.h * hd;
  const uint8_t* msk = mask + blk.u * L;
  long_stage(sq, base, 3 * (size_t)D, blk.t0, T, L, hd, hs);
  long_stage(sdo, dout + blk.u * L * D + (size_t)blk.h * hd, (size_t)D, blk.t0, T, L, hd, hs);
  long_zero(sdq, T * hs);
  long_load_stats(sm, sinv, sdd, stats + (blk.u * H + blk.h) * L * 3, blk.t0, T, L);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  for (int k0 = 0; k0 < L; k0 += T) {
    long_stage(sk, base + D, 3 * (size_t)D, k0, T, L, hd, hs);
    long_stage(sv, base + 2 * D, 3 * (size_t)D, k0, T, L, hd, hs);
    long_biases(sbias, msk, k0, T, L);
    __syncthreads();
    if (ty < LT::RT) {
      float x[2][LT::TM][LT::TN];
      const float* const ra[2] = {sq, sdo};
      const float* const cb[2] = {sk, sv};
      long_dots<T, 2>(x, ra, cb, ty, tx, hd, hs);
#pragma unroll
      for (int a = 0; a < LT::TM; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int b = 0; b < LT::TN; ++b) {
          const int j = tx + 8 * b;
          float p, ds;
          long_p_ds(x[0][a][b], x[1][a][b], sbias[j], sm[i], sinv[i], sdd[i], scale_log2, p, ds);
          sds[i * (T + 1) + j] = ds;
        }
      }
    }
    __syncthreads();
    long_accum<T>(sdq, sds, sk, nullptr, hd, hs);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = L - blk.t0 < T ? L - blk.t0 : T;
  E* g = dqkv + (blk.u * L + blk.t0) * 3 * D + (size_t)blk.h * hd;
  for (int i = warp; i < rows; i += kLongThreads / 32)
    for (int c = lane; c < hd; c += 32) from_f32(g + (size_t)i * 3 * D + c, sdq[i * hs + c] * scale);
}

// Backward, dK and dV: one block per (sequence, head, key tile), the query
// tiles streamed, keys as the rows of the logit tile: dV = sum over queries
// of P^T dO, dK = scale sum of dS^T Q.
template <typename E, int T>
__global__ void __launch_bounds__(kLongThreads)
    mhsa_long_dkv_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const E* __restrict__ dout, const float* __restrict__ stats,
                         E* __restrict__ dqkv, int L, int D, int H, float scale_log2,
                         float scale) {
  using LT = LongTile<T>;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, hs = hd | 1;
  const LongBlock blk = long_block(H, (L + T - 1) / T, T);
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + T * hs;
  float* sdk = sv + T * hs;
  float* sdv = sdk + T * hs;
  float* sq = sdv + T * hs;
  float* sdo = sq + T * hs;
  float* sp = sdo + T * hs;
  float* sds = sp + T * (T + 1);
  float* sbias = sds + T * (T + 1);
  float* sm = sbias + T;
  float* sinv = sm + T;
  float* sdd = sinv + T;
  const E* base = qkv + blk.u * L * 3 * D + (size_t)blk.h * hd;
  const E* gbase = dout + blk.u * L * D + (size_t)blk.h * hd;
  const float* st = stats + (blk.u * H + blk.h) * L * 3;
  long_stage(sk, base + D, 3 * (size_t)D, blk.t0, T, L, hd, hs);
  long_stage(sv, base + 2 * D, 3 * (size_t)D, blk.t0, T, L, hd, hs);
  long_biases(sbias, mask + blk.u * L, blk.t0, T, L);
  long_zero(sdk, 2 * T * hs);  // dK and dV
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  for (int q0 = 0; q0 < L; q0 += T) {
    long_stage(sq, base, 3 * (size_t)D, q0, T, L, hd, hs);
    long_stage(sdo, gbase, (size_t)D, q0, T, L, hd, hs);
    long_load_stats(sm, sinv, sdd, st, q0, T, L);
    __syncthreads();
    if (ty < LT::RT) {
      float x[2][LT::TM][LT::TN];
      const float* const ra[2] = {sk, sv};
      const float* const cb[2] = {sq, sdo};
      long_dots<T, 2>(x, ra, cb, ty, tx, hd, hs);
#pragma unroll
      for (int a = 0; a < LT::TM; ++a) {
        const int j = ty + 16 * a;
#pragma unroll
        for (int b = 0; b < LT::TN; ++b) {
          const int i = tx + 8 * b;
          float p, ds;
          long_p_ds(x[0][a][b], x[1][a][b], sbias[j], sm[i], sinv[i], sdd[i], scale_log2, p, ds);
          sp[j * (T + 1) + i] = p;
          sds[j * (T + 1) + i] = ds;
        }
      }
    }
    __syncthreads();
    long_accum<T>(sdv, sp, sdo, nullptr, hd, hs);
    long_accum<T>(sdk, sds, sq, nullptr, hd, hs);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = L - blk.t0 < T ? L - blk.t0 : T;
  E* g = dqkv + (blk.u * L + blk.t0) * 3 * D + (size_t)blk.h * hd;
  for (int i = warp; i < rows; i += kLongThreads / 32)
    for (int c = lane; c < hd; c += 32) {
      from_f32(g + (size_t)i * 3 * D + D + c, sdk[i * hs + c] * scale);
      from_f32(g + (size_t)i * 3 * D + 2 * D + c, sdv[i * hs + c]);
    }
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

// Whether (L, D, H) runs in the long instances: outside the box of
// kernel_box (ops/mhsa.py::long_instance).
bool long_instance(int L, int D, int H) { return !kernel_box(L, D / H); }

// Whether (L, D, H) in the type of element size es runs in the wide
// instances: inside the box, head dim above 32, L above 64, or a bf16 shape
// whose single sequence's slab does not fit one block (kernel_supports in
// ops/mhsa.py routes by the same rule).
bool wide_instance(int L, int D, int H, int es) {
  return kernel_box(L, D / H) &&
         (D / H > kNarrowHeadDim || L > kNarrowMaxLen ||
          (es == 2 && smem_bytes(1, L, D, es) > (size_t)kSmemLimit));
}

// The wide instances, either type: one block per (sequence, head), U H of
// them, of ceil(L / 16) warps, with the shared memory of wide_smem (opted
// in above 48 KB once per instance and device).
template <typename T, int KT>
cudaError_t launch_wide_inst(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                             int H, int dev, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_wide_kernel<T, KT>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const int hd = D / H;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  kernel<<<U * H, 32 * KT, wide_smem(L, hd, sizeof(T), false), stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), L, D, H, scale_log2);
  return cudaGetLastError();
}

template <typename T, int KT>
cudaError_t launch_bwd_wide_inst(const void* qkv, const uint8_t* mask, const void* dout,
                                 void* dqkv, int U, int L, int D, int H, int dev,
                                 cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_bwd_wide_kernel<T, KT>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const int hd = D / H;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  kernel<<<U * H, 32 * KT, wide_smem(L, hd, sizeof(T), true), stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<const T*>(dout), static_cast<T*>(dqkv), L, D,
      H, scale_log2);
  return cudaGetLastError();
}

// The long instances, either type: U H ceil(L / T) blocks of kLongThreads,
// with the shared memory of long_smem (opted in once per kernel and
// device).  The backward's three launches share the workspace of per-row
// statistics.
template <typename E, int T>
cudaError_t launch_long_inst(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                             int H, int dev, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_long_kernel<E, T>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const int hd = D / H;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  const unsigned grid = (unsigned)((size_t)U * H * ((L + T - 1) / T));
  kernel<<<grid, kLongThreads, long_smem(hd, 0), stream>>>(
      static_cast<const E*>(qkv), mask, static_cast<E*>(out), L, D, H, scale_log2);
  return cudaGetLastError();
}

template <typename E, int T>
cudaError_t launch_bwd_long_inst(const void* qkv, const uint8_t* mask, const void* dout,
                                 void* dqkv, void* workspace, int U, int L, int D, int H, int dev,
                                 cudaStream_t stream) {
  static bool stats_set[kMaxDevices] = {false}, dq_set[kMaxDevices] = {false},
              dkv_set[kMaxDevices] = {false};
  auto stats_kernel = mhsa_long_stats_kernel<E, T>;
  auto dq_kernel = mhsa_long_dq_kernel<E, T>;
  auto dkv_kernel = mhsa_long_dkv_kernel<E, T>;
  cudaError_t err = allow_smem(stats_kernel, dev, stats_set);
  if (err == cudaSuccess) err = allow_smem(dq_kernel, dev, dq_set);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel, dev, dkv_set);
  if (err != cudaSuccess) return err;
  const int hd = D / H;
  const float scale = 1.f / sqrtf((float)hd);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  const unsigned grid = (unsigned)((size_t)U * H * ((L + T - 1) / T));
  const E* q = static_cast<const E*>(qkv);
  const E* g = static_cast<const E*>(dout);
  E* dq = static_cast<E*>(dqkv);
  float* st = static_cast<float*>(workspace);
  stats_kernel<<<grid, kLongThreads, long_smem(hd, 0), stream>>>(q, mask, g, st, L, D, H,
                                                                  scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<<<grid, kLongThreads, long_smem(hd, 1), stream>>>(q, mask, g, st, dq, L, D, H,
                                                               scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<<<grid, kLongThreads, long_smem(hd, 2), stream>>>(q, mask, g, st, dq, L, D, H,
                                                                scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// The wide instances' dispatch by KT, one instantiation per type: each in
// its own part of a split build (NRL_PART 2: bf16, 3: f32), called from
// part 1's entry points.
namespace nrl_mhsa {

template <typename T>
cudaError_t launch_wide(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                        int H, int dev, cudaStream_t stream);
template <typename T>
cudaError_t launch_bwd_wide(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            int U, int L, int D, int H, int dev, cudaStream_t stream);

#if NRL_PART != 1
template <typename T>
cudaError_t launch_wide(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                        int H, int dev, cudaStream_t stream) {
  switch ((L + 15) / 16) {
    case 1: return launch_wide_inst<T, 1>(qkv, mask, out, U, L, D, H, dev, stream);
    case 2: return launch_wide_inst<T, 2>(qkv, mask, out, U, L, D, H, dev, stream);
    case 3: return launch_wide_inst<T, 3>(qkv, mask, out, U, L, D, H, dev, stream);
    case 4: return launch_wide_inst<T, 4>(qkv, mask, out, U, L, D, H, dev, stream);
    case 5: return launch_wide_inst<T, 5>(qkv, mask, out, U, L, D, H, dev, stream);
    case 6: return launch_wide_inst<T, 6>(qkv, mask, out, U, L, D, H, dev, stream);
    case 7: return launch_wide_inst<T, 7>(qkv, mask, out, U, L, D, H, dev, stream);
    default: return launch_wide_inst<T, 8>(qkv, mask, out, U, L, D, H, dev, stream);
  }
}

template <typename T>
cudaError_t launch_bwd_wide(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            int U, int L, int D, int H, int dev, cudaStream_t stream) {
#define NRL_BWD_WIDE(KT) \
  launch_bwd_wide_inst<T, KT>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream)
  switch ((L + 15) / 16) {
    case 1: return NRL_BWD_WIDE(1);
    case 2: return NRL_BWD_WIDE(2);
    case 3: return NRL_BWD_WIDE(3);
    case 4: return NRL_BWD_WIDE(4);
    case 5: return NRL_BWD_WIDE(5);
    case 6: return NRL_BWD_WIDE(6);
    case 7: return NRL_BWD_WIDE(7);
    default: return NRL_BWD_WIDE(8);
  }
#undef NRL_BWD_WIDE
}
#endif

#if NRL_BUILDS(2)
template cudaError_t launch_wide<__nv_bfloat16>(const void*, const uint8_t*, void*, int, int, int,
                                                int, int, cudaStream_t);
template cudaError_t launch_bwd_wide<__nv_bfloat16>(const void*, const uint8_t*, const void*,
                                                    void*, int, int, int, int, int, cudaStream_t);
#endif
#if NRL_BUILDS(3)
template cudaError_t launch_wide<float>(const void*, const uint8_t*, void*, int, int, int, int, int,
                                        cudaStream_t);
template cudaError_t launch_bwd_wide<float>(const void*, const uint8_t*, const void*, void*, int,
                                            int, int, int, int, cudaStream_t);
#endif

// The long instances' dispatch by tile rows, both types in part 4.
template <typename T>
cudaError_t launch_long(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                        int H, int dev, cudaStream_t stream);
template <typename T>
cudaError_t launch_bwd_long(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            void* workspace, int U, int L, int D, int H, int dev,
                            cudaStream_t stream);

#if NRL_BUILDS(4)
template <typename T>
cudaError_t launch_long(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                        int H, int dev, cudaStream_t stream) {
  switch (long_tile(D / H)) {
    case 64: return launch_long_inst<T, 64>(qkv, mask, out, U, L, D, H, dev, stream);
    case 32: return launch_long_inst<T, 32>(qkv, mask, out, U, L, D, H, dev, stream);
    case 16: return launch_long_inst<T, 16>(qkv, mask, out, U, L, D, H, dev, stream);
    default: return launch_long_inst<T, 8>(qkv, mask, out, U, L, D, H, dev, stream);
  }
}

template <typename T>
cudaError_t launch_bwd_long(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            void* workspace, int U, int L, int D, int H, int dev,
                            cudaStream_t stream) {
#define NRL_BWD_LONG(R) \
  launch_bwd_long_inst<T, R>(qkv, mask, dout, dqkv, workspace, U, L, D, H, dev, stream)
  switch (long_tile(D / H)) {
    case 64: return NRL_BWD_LONG(64);
    case 32: return NRL_BWD_LONG(32);
    case 16: return NRL_BWD_LONG(16);
    default: return NRL_BWD_LONG(8);
  }
#undef NRL_BWD_LONG
}

template cudaError_t launch_long<__nv_bfloat16>(const void*, const uint8_t*, void*, int, int, int,
                                                int, int, cudaStream_t);
template cudaError_t launch_long<float>(const void*, const uint8_t*, void*, int, int, int, int, int,
                                        cudaStream_t);
template cudaError_t launch_bwd_long<__nv_bfloat16>(const void*, const uint8_t*, const void*,
                                                    void*, void*, int, int, int, int, int,
                                                    cudaStream_t);
template cudaError_t launch_bwd_long<float>(const void*, const uint8_t*, const void*, void*, void*,
                                            int, int, int, int, int, cudaStream_t);
#endif

}  // namespace nrl_mhsa

namespace {

#if NRL_BUILDS(1)
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
  if (wide_instance(L, D, H, 2))
    return nrl_mhsa::launch_wide<__nv_bfloat16>(qkv, mask, out, U, L, D, H, dev, stream);
  switch ((L + 15) / 16) {
    case 1: return launch_bf16_kt<1>(qkv, mask, out, U, L, D, H, dev, stream);
    case 2: return launch_bf16_kt<2>(qkv, mask, out, U, L, D, H, dev, stream);
    case 3: return launch_bf16_kt<3>(qkv, mask, out, U, L, D, H, dev, stream);
    default: return launch_bf16_kt<4>(qkv, mask, out, U, L, D, H, dev, stream);
  }
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
  if (wide_instance(L, D, H, 2))
    return nrl_mhsa::launch_bwd_wide<__nv_bfloat16>(qkv, mask, dout, dqkv, U, L, D, H, dev,
                                                     stream);
  switch ((L + 15) / 16) {
    case 1: return launch_bwd_bf16_kt<1>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 2: return launch_bwd_bf16_kt<2>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 3: return launch_bwd_bf16_kt<3>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    default: return launch_bwd_bf16_kt<4>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  }
}

// f32: one warp block per (sequence, head), U H of them: at (64, 50) 960
// blocks rather than 64 blocks of whole sequences on 132 SMs.
template <int KT, int NT, int HDX>
cudaError_t launch_f32_inst(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                            int H, cudaStream_t stream) {
  const int hd = D / H;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  mhsa_f32_kernel<KT, NT, HDX><<<U * H, 32, f32_qkv_bytes(L, hd) + kNarrowMaxLen * 4, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<float*>(out), L, D, H, scale_log2);
  return cudaGetLastError();
}

template <int KT, int NT, int HDX>
cudaError_t launch_bwd_f32_inst(const void* qkv, const uint8_t* mask, const void* dout,
                                void* dqkv, int U, int L, int D, int H, cudaStream_t stream) {
  const int hd = D / H;
  const float scale = 1.f / sqrtf((float)hd);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  const size_t smem = f32_qkv_bytes(L, hd) + f32_do_bytes(L, hd) + kNarrowMaxLen * 4;
  mhsa_bwd_f32_kernel<KT, NT, HDX><<<U * H, 32, smem, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<const float*>(dout),
      static_cast<float*>(dqkv), L, D, H, scale_log2, scale);
  return cudaGetLastError();
}

// The main path's hd = 20 has its own instances (three k8 / n8 steps over
// the head dimension, fixed at compile time); any other hd <= 32 runs in a
// generic instance of four steps with guarded loads.
template <int KT>
cudaError_t launch_f32_kt(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                          int H, cudaStream_t stream) {
  if (D / H == 20) return launch_f32_inst<KT, 3, 20>(qkv, mask, out, U, L, D, H, stream);
  return launch_f32_inst<KT, 4, 0>(qkv, mask, out, U, L, D, H, stream);
}

cudaError_t launch_f32(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                       int H, int dev, cudaStream_t stream) {
  if (wide_instance(L, D, H, 4))
    return nrl_mhsa::launch_wide<float>(qkv, mask, out, U, L, D, H, dev, stream);
  switch ((L + 15) / 16) {
    case 1: return launch_f32_kt<1>(qkv, mask, out, U, L, D, H, stream);
    case 2: return launch_f32_kt<2>(qkv, mask, out, U, L, D, H, stream);
    case 3: return launch_f32_kt<3>(qkv, mask, out, U, L, D, H, stream);
    default: return launch_f32_kt<4>(qkv, mask, out, U, L, D, H, stream);
  }
}

template <int KT>
cudaError_t launch_bwd_f32_kt(const void* qkv, const uint8_t* mask, const void* dout,
                              void* dqkv, int U, int L, int D, int H, cudaStream_t stream) {
  if (D / H == 20)
    return launch_bwd_f32_inst<KT, 3, 20>(qkv, mask, dout, dqkv, U, L, D, H, stream);
  return launch_bwd_f32_inst<KT, 4, 0>(qkv, mask, dout, dqkv, U, L, D, H, stream);
}

cudaError_t launch_bwd_f32(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                           int U, int L, int D, int H, int dev, cudaStream_t stream) {
  if (wide_instance(L, D, H, 4))
    return nrl_mhsa::launch_bwd_wide<float>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
  switch ((L + 15) / 16) {
    case 1: return launch_bwd_f32_kt<1>(qkv, mask, dout, dqkv, U, L, D, H, stream);
    case 2: return launch_bwd_f32_kt<2>(qkv, mask, dout, dqkv, U, L, D, H, stream);
    case 3: return launch_bwd_f32_kt<3>(qkv, mask, dout, dqkv, U, L, D, H, stream);
    default: return launch_bwd_f32_kt<4>(qkv, mask, dout, dqkv, U, L, D, H, stream);
  }
}
// The shared memory of the instance that runs (L, D, H) in the type of
// element size es, the larger of its forward and backward: what it stages.
// Long (long_instance): the dK / dV kernel's tiles (long_smem); wide
// (wide_instance): one head's q, k, v and dO columns in the input type
// and the row statistics (wide_smem); f32 up to hd = 32: one head's q, k, v
// and dO columns; bf16 up to hd = 32: the whole (L, 3D) slab of one
// sequence (smem_bytes).
size_t instance_smem(int L, int D, int H, int es) {
  const int hd = D / H;
  if (long_instance(L, D, H)) return long_smem(hd, 2);
  if (wide_instance(L, D, H, es)) return wide_smem(L, hd, es, true);
  if (es == 4) return f32_qkv_bytes(L, hd) + f32_do_bytes(L, hd) + kNarrowMaxLen * 4;
  return smem_bytes(1, L, D, es);
}

// The arguments both entry points take; 0 if the kernels take them
// (ops/mhsa.py::kernel_supports is the same rule): float32 or bfloat16,
// heads dividing D, any L >= 1, head dim up to kMaxHeadDim, what the
// instance stages within one block's shared memory (always), and a long
// instance's grid within 2^31 - 1 blocks.
int check_args(int U, int L, int D, int H, int dtype) {
  if (U <= 0 || H <= 0 || D <= 0 || D % H != 0 || L < 1 || D / H > kMaxHeadDim ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (instance_smem(L, D, H, dtype == 0 ? 4 : 2) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int T = long_tile(D / H);
  if (long_instance(L, D, H) && (size_t)U * H * ((L + T - 1) / T) > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Bytes of the backward's workspace: U H L x (max, 1 / sum, D) floats for a
// long instance, none for the others.
size_t bwd_workspace(int U, int L, int D, int H) {
  return long_instance(L, D, H) ? (size_t)U * H * L * 3 * sizeof(float) : 0;
}

#endif  // NRL_BUILDS(1)

}  // namespace

#if NRL_BUILDS(1)
extern "C" int nrl_mhsa_fwd(const void* qkv, const uint8_t* mask, void* out, int U, int L,
                            int D, int H, int dtype, void* stream) {
  const int bad = check_args(U, L, D, H, dtype);
  if (bad) return bad;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_instance(L, D, H))
    return (int)(dtype == 0
                     ? nrl_mhsa::launch_long<float>(qkv, mask, out, U, L, D, H, dev, s)
                     : nrl_mhsa::launch_long<__nv_bfloat16>(qkv, mask, out, U, L, D, H, dev, s));
  if (dtype == 0) return (int)launch_f32(qkv, mask, out, U, L, D, H, dev, s);
  return (int)launch_bf16(qkv, mask, out, U, L, D, H, dev, s);
}

// Bytes of workspace nrl_mhsa_bwd needs at (U, L, D, H) (0: none; pass any
// pointer), or 0 for arguments it refuses.
extern "C" size_t nrl_mhsa_bwd_workspace(int U, int L, int D, int H, int dtype) {
  return check_args(U, L, D, H, dtype) ? 0 : bwd_workspace(U, L, D, H);
}

extern "C" int nrl_mhsa_bwd(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            void* workspace, int U, int L, int D, int H, int dtype,
                            void* stream) {
  const int bad = check_args(U, L, D, H, dtype);
  if (bad) return bad;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_instance(L, D, H)) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? nrl_mhsa::launch_bwd_long<float>(qkv, mask, dout, dqkv, workspace,
                                                               U, L, D, H, dev, s)
                            : nrl_mhsa::launch_bwd_long<__nv_bfloat16>(
                                  qkv, mask, dout, dqkv, workspace, U, L, D, H, dev, s));
  }
  if (dtype == 0) return (int)launch_bwd_f32(qkv, mask, dout, dqkv, U, L, D, H, dev, s);
  return (int)launch_bwd_bf16(qkv, mask, dout, dqkv, U, L, D, H, dev, s);
}
#endif  // NRL_BUILDS(1)
