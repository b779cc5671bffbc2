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
// * bf16: persistent blocks walking groups of work through a two-stage
//   cp.async ring (bwd_plan, mhsa_bwd_bf16_kernel): the copies of the next
//   group land while the block computes the current one and the previous
//   one's dqkv stores drain.  A group is S whole sequences, their qkv and
//   dO slabs staged as they lie (16-byte cp.async), where the card's
//   blocks all get one; at small U, HG heads of one sequence, their q, k,
//   v and dO columns staged as padded rows, so that U x H warp tasks still
//   spread over the SMs.  The key mask goes through registers into key
//   biases.  Blocks of 8 warps (16 at L = 17 .. 32).  f32: one (sequence,
//   head) a block, with that head's dO columns staged beside its q, k and v
//   columns.
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
//   tile); after a barrier the block copies the group's staged rows, now
//   dqkv, to the output (a whole-sequence group's slab in one coalesced
//   run).  No atomics: each output value is written by one lane, so the
//   gradient is the same bits from run to run.
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

// Built whole by default.  ops/build.py compiles it in six parts at once
// and links them: NRL_PART 1 holds the hd <= 32 forward and f32 backward
// instances, the shape rule and the C entry points, 2 the wide bf16
// instances, 3 the wide f32 ones, 4 the long ones, 5 and 6 the hd <= 32
// bf16 backward ones (L <= 32, L above).
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

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

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

// Warps of a backward block of whole sequences (one (sequence, head) task
// each): 8 at L <= 16 (two blocks an SM) and above L = 32 (one block, up to
// 255 registers a thread), 16 at L = 17 .. 32 (one block, whose ring of
// two whole sequences of L = 30 takes 144 KB).  128 registers a thread up
// to L = 32.
__host__ __device__ constexpr int bwd_block_warps(int KT) { return KT == 2 ? 16 : 8; }
__host__ __device__ constexpr int bwd_min_blocks(int KT) { return KT == 1 ? 2 : 1; }

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

// One backward warp task, bf16: head hl of a sequence whose staged rows
// start at `s` (row stride rs; the head's q, k and v columns at hl hd, ko +
// hl hd and 2 ko + hl hd) with its output gradient staged at `dsm` (row
// stride drs, the head's columns at hl hd).  Per
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
__device__ __forceinline__ void bf16_bwd_head(unsigned short* s, int rs, int ko,
                                              const unsigned short* dsm, int drs,
                                              const float* bias, int hl, int L, int hd_rt,
                                              float scale_log2, float scale) {
  constexpr int HK = (NT * 8 + 15) / 16;
  constexpr int NJ = 2 * KT;
  const int hd = HDX > 0 ? HDX : hd_rt;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int qcol = hl * hd, kcol = ko + qcol, vcol = 2 * ko + qcol;
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
    const int q0 = min(r0, L - 1) * rs + qcol, q1 = min(r1, L - 1) * rs + qcol;
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
          const int off = min(j * 8 + g, L - 1) * rs + kcol;
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
        const unsigned short* dc = dsm + qcol + d;
        ob[nt][0] = pack_bits(ok && k0 < L ? dc[k0 * drs] : (unsigned short)0,
                              ok && k0 + 1 < L ? dc[(k0 + 1) * drs] : (unsigned short)0);
        ob[nt][1] = pack_bits(ok && k0 + 8 < L ? dc[(k0 + 8) * drs] : (unsigned short)0,
                              ok && k0 + 9 < L ? dc[(k0 + 9) * drs] : (unsigned short)0);
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
        oa[ks][0] = in0 ? ld_pair<PAIR>(dsm, r0 * drs + qcol, d, hd) : 0u;
        oa[ks][1] = in1 ? ld_pair<PAIR>(dsm, r1 * drs + qcol, d, hd) : 0u;
        oa[ks][2] = in0 ? ld_pair<PAIR>(dsm, r0 * drs + qcol, d + 8, hd) : 0u;
        oa[ks][3] = in1 ? ld_pair<PAIR>(dsm, r1 * drs + qcol, d + 8, hd) : 0u;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        if (j < NJ - 1 || last_on) {
          const int off = min(j * 8 + g, L - 1) * rs + vcol;
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
      const int o0 = min(k0, L - 1) * rs + kcol, o1 = min(k0 + 1, L - 1) * rs + kcol;
      const int o8 = min(k0 + 8, L - 1) * rs + kcol, o9 = min(k0 + 9, L - 1) * rs + kcol;
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
      const int o0 = min(k0, L - 1) * rs + qcol, o1 = min(k0 + 1, L - 1) * rs + qcol;
      const int o8 = min(k0 + 8, L - 1) * rs + qcol, o9 = min(k0 + 9, L - 1) * rs + qcol;
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
        st_pair<PAIR>(s, k0 * rs + kcol, d, hd, dk[kt][nt][0] * scale, dk[kt][nt][1] * scale);
        st_pair<PAIR>(s, k0 * rs + vcol, d, hd, dv[kt][nt][0], dv[kt][nt][1]);
      }
      if (k1 < L) {
        st_pair<PAIR>(s, k1 * rs + kcol, d, hd, dk[kt][nt][2] * scale, dk[kt][nt][3] * scale);
        st_pair<PAIR>(s, k1 * rs + vcol, d, hd, dv[kt][nt][2], dv[kt][nt][3]);
      }
    }
  }
}

// Shared memory of one stage of the backward's ring (bwd_plan): a group of
// S whole sequences (HG = H) stages its qkv and dO slabs as they lie (each
// with 16 bytes of slack: it starts at its source's address mod 16) and 64
// key biases a sequence; a group of HG heads of one sequence stages their
// q, k, v and dO columns as four arrays of L rows of wide_stride(HG hd, 2)
// values (tc_stage) and 64 key biases.
// Row stride, in values, of a staged head array (the wide and long
// instances', and a head group's here): an odd number of 16-byte units, so
// that the eight rows of an ldmatrix or a fragment read fall in distinct
// banks.
__host__ __device__ inline int wide_stride(int hd, int es) {
  return es == 2 ? (hd + 15) / 16 * 16 + 8 : (hd + 7) / 8 * 8 + 4;
}
__host__ __device__ inline size_t bwd_stage_bytes(int S, int HG, int L, int D, int H) {
  if (HG == H)
    return align16(16 + (size_t)S * L * 3 * D * 2) + align16(16 + (size_t)S * L * D * 2) +
           (size_t)S * kNarrowMaxLen * 4;
  return (size_t)4 * L * wide_stride(HG * (D / H), 2) * 2 + kNarrowMaxLen * 4;
}

// Rows r0 .. r0 + R - 1 of `parts` runs of hd values (run p of row r at
// src + r * src_row + p * src_part) into `parts` arrays of R rows of `st`
// values at dst (array p at dst + p R st): rows below L by cp.async of the
// widest of 16, 8 and 4 bytes that every run allows, not committed (the
// caller commits a tile's copies as one group); 2-byte values off a 4-byte
// boundary by plain copies; rows at or past L as zeros.  Columns hd and up
// are tc_zero_pad's.
template <typename S>
__device__ void tc_stage(S* dst, const S* src, int r0, int R, int L, int parts, int hd,
                         size_t src_row, size_t src_part, int st) {
  constexpr int es = sizeof(S);
  const uintptr_t a = (uintptr_t)src | (src_row * es) | (src_part * es) | ((uintptr_t)hd * es);
  const int V = (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : es;
  const int per = hd * es / V;  // copies a run
  const int n = R * parts * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int run = i / per, j = i - run * per;
    const int r = run / parts, p = run - r * parts;
    char* to = reinterpret_cast<char*>(dst + ((size_t)p * R + r) * st) + j * V;
    if (r0 + r < L) {
      const char* from =
          reinterpret_cast<const char*>(src + (size_t)(r0 + r) * src_row + p * src_part) + j * V;
      if (V == 16)
        cp_async16(to, from);
      else if (V == 8)
        cp_async8(to, from);
      else if (V == 4)
        cp_async4(to, from);
      else
        *reinterpret_cast<S*>(to) = *reinterpret_cast<const S*>(from);
    } else {
      for (int b = 0; b < V; b += es) *reinterpret_cast<S*>(to + b) = S(0);
    }
  }
}

// The first n values of the `rows` rows of `parts` staged arrays of 16-bit
// values (row r of array p at src + p src_part + r src_row) back to dst + r
// dst_row + p dst_part, in the widest stores, 16, 8, 4 or 2 bytes, that
// every address allows.
__device__ void write_runs16(unsigned short* dst, const unsigned short* src, int rows, int parts,
                             int n, size_t dst_row, size_t dst_part, int src_row, int src_part) {
  const uintptr_t a = (uintptr_t)src | (uintptr_t)dst | (dst_row * 2) | (dst_part * 2) |
                      ((uintptr_t)n * 2) | ((uintptr_t)src_row * 2) | ((uintptr_t)src_part * 2);
  const int V = (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 2;
  const int per = n * 2 / V;
  const int total = rows * parts * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int run = i / per, j = i - run * per;
    const int r = run / parts, p = run - r * parts;
    const char* from = reinterpret_cast<const char*>(src + p * src_part + r * src_row) + j * V;
    char* to = reinterpret_cast<char*>(dst + r * dst_row + p * dst_part) + j * V;
    if (V == 16)
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    else if (V == 8)
      *reinterpret_cast<uint64_t*>(to) = *reinterpret_cast<const uint64_t*>(from);
    else if (V == 4)
      *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(from);
    else
      *reinterpret_cast<unsigned short*>(to) = *reinterpret_cast<const unsigned short*>(from);
  }
}

// Where a group of the backward's plan lies: its sequences and heads, and
// its staged rows in stage `st` (qkv rows of rs values, k at ko and v at 2
// ko within a row; dO rows of drs values; 64 key biases a sequence).
struct BwdGroup {
  unsigned short *s, *d;
  float* bias;
  int u0, ns, h0, nh, rs, ko, drs;
};
__device__ __forceinline__ BwdGroup bwd_group(int grp, int st, char* smem, int stage_bytes,
                                              const __nv_bfloat16* qkv,
                                              const __nv_bfloat16* dout, int U, int L, int D,
                                              int H, int S, int HG) {
  BwdGroup g;
  char* base = smem + (size_t)st * stage_bytes;
  if (HG == H) {
    g.u0 = grp * S;
    g.ns = min(S, U - g.u0);
    g.h0 = 0;
    g.nh = H;
    g.rs = 3 * D;
    g.ko = D;
    g.drs = D;
    char* dbase = base + align16(16 + (size_t)S * L * 3 * D * 2);
    g.s = reinterpret_cast<unsigned short*>(
        base + ((uintptr_t)(qkv + (size_t)g.u0 * L * 3 * D) & 15));
    g.d = reinterpret_cast<unsigned short*>(dbase + ((uintptr_t)(dout + (size_t)g.u0 * L * D) & 15));
    g.bias = reinterpret_cast<float*>(dbase + align16(16 + (size_t)S * L * D * 2));
  } else {  // arrays of q, k, v and dO rows: k and v at one and two arrays from q
    const int nhg = (H + HG - 1) / HG;
    g.u0 = grp / nhg;
    g.ns = 1;
    g.h0 = (grp - g.u0 * nhg) * HG;
    g.nh = min(HG, H - g.h0);
    g.rs = g.drs = wide_stride(HG * (D / H), 2);
    g.ko = L * g.rs;
    g.s = reinterpret_cast<unsigned short*>(base);
    g.d = g.s + 3 * g.ko;
    g.bias = reinterpret_cast<float*>(g.d + g.ko);
  }
  return g;
}

// The narrow bf16 backward: persistent blocks walk the plan's groups (whole
// sequences, or head groups of one sequence; group blockIdx.x, then every
// gridDim.x-th) through a two-stage cp.async ring.  At the top of a turn
// the group whose copies were issued last turn has landed; the block then
// writes the previous group's dqkv (left over its staged q, k and v) out of
// the other stage, issues the next group's copies into it, and computes the
// current group, one (sequence, head) warp task at a time, while they land
// and the stores drain.  The next group's key mask is read into registers
// when its copies are issued and turned into key biases after the compute,
// so no warp waits on it.  A head group's rows are padded to wide_stride, so
// that the fragment reads of a warp's eight rows fall in distinct banks.
template <int KT, int NT, int HDX, bool PAIR>
__global__ void __launch_bounds__(bwd_block_warps(KT) * 32, bwd_min_blocks(KT))
    mhsa_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
                         int U, int L, int D, int H, int S, int HG, int stage_bytes,
                         float scale_log2, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H;
  const int groups = HG == H ? (U + S - 1) / S : U * ((H + HG - 1) / HG);
  auto where = [&](int grp, int st) {
    return bwd_group(grp, st, smem, stage_bytes, qkv, dout, U, L, D, H, S, HG);
  };
  auto load = [&](const BwdGroup& g) {
    const unsigned short* gq = reinterpret_cast<const unsigned short*>(qkv);
    const unsigned short* gd = reinterpret_cast<const unsigned short*>(dout);
    if (HG == H) {  // stage() commits its copies
      stage(reinterpret_cast<char*>(g.s),
            reinterpret_cast<const char*>(gq + (size_t)g.u0 * L * 3 * D),
            (size_t)g.ns * L * 3 * D * 2);
      stage(reinterpret_cast<char*>(g.d), reinterpret_cast<const char*>(gd + (size_t)g.u0 * L * D),
            (size_t)g.ns * L * D * 2);
    } else {
      tc_stage(g.s, gq + (size_t)g.u0 * L * 3 * D + (size_t)g.h0 * hd, 0, L, L, 3, g.nh * hd,
               3 * (size_t)D, D, g.rs);
      tc_stage(g.d, gd + (size_t)g.u0 * L * D + (size_t)g.h0 * hd, 0, L, L, 1, g.nh * hd, D, 0,
               g.rs);
      cp_async_commit();
    }
  };
  // Key-bias slots threadIdx.x and threadIdx.x + blockDim.x (sequence i / 64,
  // key i % 64) of the next group: the raw mask byte, and whether the key
  // lies below L.
  uint8_t raw[2];
  bool in[2];
  auto read_mask = [&](const BwdGroup& g) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = threadIdx.x + k * blockDim.x, sq = i / kNarrowMaxLen;
      const int key = i - sq * kNarrowMaxLen;
      in[k] = sq < g.ns && key < L;
      raw[k] = in[k] ? mask[(size_t)(g.u0 + sq) * L + key] : 0;
    }
  };
  auto put_biases = [&](const BwdGroup& g) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < g.ns * kNarrowMaxLen) g.bias[i] = in[k] ? (raw[k] ? 0.f : kMaskMin) : -INFINITY;
    }
  };
  auto write_back = [&](const BwdGroup& g) {
    if (HG == H)
      write_rows(dqkv + (size_t)g.u0 * L * 3 * D, reinterpret_cast<const __nv_bfloat16*>(g.s), 1,
                 g.ns * L * 3 * D);
    else
      write_runs16(reinterpret_cast<unsigned short*>(dqkv) + (size_t)g.u0 * L * 3 * D +
                       (size_t)g.h0 * hd,
                   g.s, L, 3, g.nh * hd, 3 * (size_t)D, D, g.rs, g.ko);
  };

  if ((int)blockIdx.x >= groups) return;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  {
    const BwdGroup g = where(blockIdx.x, 0);
    load(g);
    read_mask(g);
    put_biases(g);
  }
  int it = 0;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x, ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it > 0) {
      write_back(where(grp - gridDim.x, (it + 1) & 1));
      __syncthreads();  // its reads of the other stage are done
    }
    const int nx = grp + gridDim.x;
    if (nx < groups) {
      const BwdGroup g = where(nx, (it + 1) & 1);
      load(g);
      read_mask(g);
    }
    {
      const BwdGroup g = where(grp, it & 1);
      for (int t = warp; t < g.ns * g.nh; t += nwarps) {
        const int sq = t / g.nh;
        bf16_bwd_head<KT, NT, HDX, PAIR>(g.s + (size_t)sq * L * g.rs, g.rs, g.ko,
                                         g.d + (size_t)sq * L * g.drs, g.drs,
                                         g.bias + sq * kNarrowMaxLen, t - sq * g.nh, L, hd,
                                         scale_log2, scale);
      }
    }
    if (nx < groups) put_biases(where(nx, (it + 1) & 1));
  }
  __syncthreads();
  write_back(where(blockIdx.x + (it - 1) * gridDim.x, (it + 1) & 1));
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

__host__ __device__ inline size_t wide_smem(int L, int hd, int es, bool bwd) {
  const size_t Lp = (L + 15) / 16 * 16;
  return (bwd ? 4 : 3) * Lp * wide_stride(hd, es) * es + (bwd ? 4 : 1) * Lp * 4;
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
// the running state as it was once a valid key has been seen, and a fully
// masked sequence ends with the uniform mean of v over its L keys, however
// many tiles they span.  Masked keys take the bias -1e30, keys past L -inf
// (p = 0).
//
// What bounds it on the H100.  At the train user encoder's (64, 200, 300,
// 15) the forward's products are 4 U L^2 D = 3.1 GFLOP against 23 MB of
// qkv and context: 0.0031 ms on the bf16 tensor cores against 0.0052 ms of
// bytes (f32: 0.046 ms at the CUDA-core rate, 0.0063 ms in TF32 on the
// tensor cores).  Neither is near: at head dim 20 a warp's products are
// 16 x 64 x 32 tiles, so the kernel is bound by latency and instruction
// issue (fragment loads, the softmax's ex2 and shuffles, barriers), not by
// the tensor cores' rate or the bytes.  The design (the tensor-core
// instances, head dims up to kLongTcMaxHeadDim = 256):
//
// * Tiles of R = 64 rows (kTcRows), a warp per 16-row strip, R / 16 warps
//   a block.  Every array is staged in its storage type (bf16 stays bf16)
//   with the wide instances' padded rows (wide_stride: 16 ceil(hd / 16) + 8
//   bf16 values or 8 ceil(hd / 8) + 4 floats, so that ldmatrix and the f32
//   fragment reads fall in distinct banks); the head dim is zero-padded to
//   the mma k-step (hd = 20: 32 in bf16, 24 in f32), and rows past L are
//   staged as zeros.  All offsets into qkv, dO and the outputs are 64-bit
//   (U L 3D passes 2^31 values at PLM widths).
// * The streamed tiles (keys and values, or queries and dO) go through a
//   two-stage cp.async ring: after the barrier that makes tile j visible,
//   the copies of tile j + 1 are issued into the other stage and the warps
//   compute on tile j while they land (16-byte cp.async where every run
//   allows it, else 8 or 4 bytes; 2-byte bf16 values off a 4-byte boundary,
//   odd head dims, by plain copies).  One barrier a tile.
// * bf16: every product on mma.sync.m16n8k16 (bf16 in, f32 sums), operands
//   by ldmatrix from the staged tiles; P and dS rounded to bf16 as A
//   operands, P into dV = P^T dO and dS into dK = dS^T Q as bf16 hi + lo
//   pairs (sums over every query; tc_dkv).  f32: split TF32 ("3xTF32", mma.sync.m16n8k8), with P and
//   dS going back as A operands straight from the accumulators (k index c
//   as key 2c, c + 4 as key 2c + 1).  Every k8 step of a product sums its
//   main part and its corrections in fresh accumulators, added in f32
//   (mma3_add: the tensor cores truncate their sums).  One product leaves
//   the tensor cores in f32: dV = P^T dO, as one FMA chain a value over the
//   queries in order, which is how the plain version's exact-f32 product
//   rounds it; split-TF32 sums missed the f32 check against the plain
//   version at (512, 256, 768, 16) (tc_dkv).
// * Forward: one block per (sequence, head, query tile, column group).  A
//   warp's 16 x R logits sit in its accumulator fragments; the online
//   softmax keeps each row's max and sum in registers (the max over the
//   quad by two shuffles, the sum as per-lane partials added at the end),
//   rescales the output accumulators, and P goes into P V from the
//   accumulators without touching shared memory.
// * Column groups: a warp's output accumulators cover 4 n8 tiles (head
//   dim up to 32) or 8 (64 columns) of the head dim; wider heads run
//   ceil(hd / 64) column groups as separate blocks, each forming the
//   logits over the whole head dim.  So registers stay within one 16-row
//   strip's budget up to head dim 256 (the dK / dV kernel: 64 accumulators
//   of dK and dV, 16 of S^T and dP^T; at most 127 registers a thread in
//   bf16 and 167 in f32, no spill, nvcc 12.8 for sm_90a).  The bound
//   kLongTcMaxHeadDim is 256, the widest power of two whose blocks fit: the
//   dK / dV kernel's six staged bf16 tiles fit 232,448 bytes up to head dim
//   288, and beyond 256 the column groups would form the logits five times
//   and more.  Above it the XL instances below run (head dims up to 1,024,
//   outside every model of the repo), and in float32 above head dim 64
//   (kLongTcMaxHeadDimF32), where they were faster.
// * Backward, FlashAttention-2's split, three launches, no atomics:
//   (1) statistics: one block per (sequence, head, query tile) streams the
//   key tiles, forms S = Q K^T and dP = dO V^T per 16-key chunk and keeps
//   per row its max (log2 units), sum and D = rowsum(P * dP) online
//   (rescaled by the same factor as the sum), written as max, 1 / sum and
//   D / sum into a workspace of U H L x 3 floats; (2) dQ: one block per
//   (sequence, head, query tile, column group) streams the key tiles: S
//   and dP again, P from the statistics, dS = P (dP - D) (0 at masked
//   keys), dQ += dS K; (3) dK / dV: one block per (sequence, head, key
//   tile, column group) streams the query tiles with their statistics,
//   keys as the rows: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T as A
//   operands, dV += P^T dO, dK += dS^T Q.  D is formed from the same dP
//   values, the same products in the same order, that (2) and (3) subtract
//   it from, and P in (2) and (3) is the same bits (S and dP are summed in
//   the same k order whichever side holds the queries): so dP - D cancels
//   where one key takes all the attention as it does in the plain version.
//   D = rowsum(dO * O) from the forward's output, FlashAttention's choice,
//   did not cancel within the f32 tolerance at (512, 256, 768, 16).  Keeping
//   the statistics launch costs two products a pair; the forward's
//   log-sum-exp alone would not spare it, since D needs both.  A fully
//   masked sequence gets dS = 0 (no gradient on q and k) and dV = the mean
//   of dO.
constexpr int kLongTcMaxHeadDim = 256;
// float32 above this head dim runs in the XL instances: on an H100 (700 W)
// they took 0.1365 / 0.6162 ms (forward / backward) at (64, 100, 400, 4)
// and 0.4531 / 1.7193 at (64, 200, 300, 2) against these instances' 0.3335
// / 1.1253 and 1.8572 / 8.4719 (64-row tiles at head dim 100, 32-row ones
// at 150: one block of 2-4 warps an SM; PERF.md, §6).
constexpr int kLongTcMaxHeadDimF32 = 64;
constexpr int kTcRows = 64;  // rows of a tile of the tensor-core instances

// Whether head dim hd runs in the tensor-core long instances in the type of
// element size es (ops/mhsa.py::long_tc); else the XL instances.
__host__ __device__ inline bool long_tc(int hd, int es) {
  return hd <= (es == 4 ? kLongTcMaxHeadDimF32 : kLongTcMaxHeadDim);
}
// n8 column tiles of a column group, and the column groups of head dim hd.
__host__ __device__ inline int tc_ntc(int hd) { return hd <= 32 ? 4 : 8; }
__host__ __device__ inline int tc_groups(int hd) {
  return ((hd + 7) / 8 + tc_ntc(hd) - 1) / tc_ntc(hd);
}
// Shared memory of a tensor-core kernel: kind 0 the forward (the query
// tile, two stages of key and value tiles, two stages of key biases), 1 the
// statistics and dQ kernels (the query and dO tiles, the same ring), 2 the
// dK / dV kernel (the block's key and value tiles, two stages of query and
// dO tiles and of their rows' statistics).
__host__ __device__ inline size_t tc_smem(int hd, int es, int kind) {
  const size_t R = kTcRows, arr = R * wide_stride(hd, es) * es;
  return (kind == 0 ? 5 : 6) * arr + (kind == 2 ? 6 : 2) * R * 4;
}
// Blocks an SM that the register budget is set for: 128 registers a thread
// in bf16, 168 in f32.
template <typename E>
__host__ __device__ constexpr int tc_min_blocks() {
  return 65536 / (128 * (sizeof(E) == 4 ? 168 : 128));
}

// Zero columns hd .. hdp - 1 of `rows` staged rows of `st` values: the
// head dim's padding to the k-step, which no copy writes.
template <typename S>
__device__ void tc_zero_pad(S* dst, int rows, int hd, int hdp, int st) {
  const int pc = hdp - hd;
  for (int i = threadIdx.x; i < rows * pc; i += blockDim.x) {
    const int r = i / pc;
    dst[(size_t)r * st + hd + (i - r * pc)] = S(0);
  }
}

// Key biases of keys k0 .. k0 + T - 1: 0 (valid), -1e30 (masked), -inf (past L).
__device__ void long_biases(float* sbias, const uint8_t* msk, int k0, int T, int L) {
  for (int j = threadIdx.x; j < T; j += blockDim.x)
    sbias[j] = k0 + j < L ? (msk[k0 + j] ? 0.f : kMaskMin) : -INFINITY;
}

// The statistics of query rows q0 .. q0 + R - 1 (max, 1 / sum, D per row in
// `stats`) as three planes of R floats at dst, by 4-byte cp.async (not
// committed); 0 past L, so that P recomputed from them is 0.
__device__ void tc_stage_stats(float* dst, const float* stats, int q0, int R, int L) {
  for (int i = threadIdx.x; i < 3 * R; i += blockDim.x) {
    const int r = i / 3, k = i - 3 * r;
    if (q0 + r < L)
      cp_async4(dst + k * R + r, stats + 3 * (size_t)(q0 + r) + k);
    else
      dst[k * R + r] = 0.f;
  }
}

// The block's (sequence, head, tile, column group) from blockIdx.x, column
// groups fastest, then tiles.
struct TcBlock {
  size_t u;
  int h, t0, cg;
};
__device__ __forceinline__ TcBlock tc_block(int H, int ntiles, int R, int ncg) {
  const size_t b = blockIdx.x;
  const size_t bt = b / ncg;
  const size_t uh = bt / ntiles;
  return TcBlock{uh / H, (int)(uh % H), (int)(bt % ntiles) * R, (int)(b % ncg)};
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// acc += a b in split TF32 with each sum the tensor cores form kept to one
// k8 step: the main product a_hi b_hi and the two corrections (a_lo b_hi,
// then a_hi b_lo) in fresh accumulators, added to acc in f32.  The tensor
// cores align a sum's terms to the largest and truncate: chained through
// one accumulator over the head dim and the keys, the forward's output was
// 2.98e-6 off the plain version at (64, 200, 300, 15) on the H100, 1.37e-6
// with the sums kept short.  mma3_add_t is the same sum with the operands'
// roles swapped (a the key side, b the query side), each term the same
// product in the same order: S and dP come out the same bits with keys or
// queries as rows.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const FragA& a, const FragB& b) {
  float m[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(m, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += m[e] + c[e];
}
__device__ __forceinline__ void mma3_add_t(float (&acc)[4], const FragA& a, const FragB& b) {
  float m[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(m, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += m[e] + c[e];
}

// S = q k^T of the 16 rows r0 of q against the first nj n8 tiles of the R
// keys of k (the rest left 0), over the head dim: bf16 k16 steps.
template <int NJ>
__device__ __forceinline__ void tc_logits(float (&sc)[NJ][4], const unsigned short* q,
                                          const unsigned short* k, int st, int r0, int hd,
                                          int nj) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  const int hk = (hd + 15) / 16;
  for (int ks = 0; ks < hk; ++ks) {
    uint32_t a[4];
    tile_a(a, q, st, r0, ks * 16);
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      if (2 * kk < nj) {
        uint32_t b[4];
        tile_b(b, k, st, kk * 16, ks * 16);
        mma_bf16(sc[2 * kk], a, b[0], b[1]);
        if (2 * kk + 1 < nj) mma_bf16(sc[2 * kk + 1], a, b[2], b[3]);
      }
    }
  }
}
// The same in split TF32 (k8 steps, mma3_add).
template <int NJ>
__device__ __forceinline__ void tc_logits(float (&sc)[NJ][4], const float* q, const float* k,
                                          int st, int r0, int hd, int nj) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const float* q0 = q + (r0 + g) * st + c;
  const float* q1 = q0 + 8 * st;
#pragma unroll
  for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  const int nks = (hd + 7) / 8;
  for (int ks = 0; ks < nks; ++ks) {
    const int d = ks * 8;
    const FragA a = frag_a(q0[d], q1[d], q0[d + 4], q1[d + 4]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) {
        const float* kr = k + (j * 8 + g) * st + c + d;
        mma3_add(sc[j], a, frag_b(kr[0], kr[4]));
      }
  }
}

// o += p v for the first nj n8 key tiles of p (16 rows x R keys, in the
// accumulator layout) and the ntg n8 column tiles of v from column col0.
template <int NJ, int NTC>
__device__ __forceinline__ void tc_pv(float (&o)[NTC][4], const float (&p)[NJ][4],
                                      const unsigned short* v, int st, int col0, int ntg,
                                      int nj) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    if (2 * kk < nj) {
      uint32_t a[4];
      pack_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NTC / 2; ++np) {
        if (2 * np < ntg) {
          uint32_t b[4];
          tile_bt(b, v, st, kk * 16, col0 + np * 16);
          mma_bf16(o[2 * np], a, b[0], b[1]);
          if (2 * np + 1 < ntg) mma_bf16(o[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
}
template <int NJ, int NTC>
__device__ __forceinline__ void tc_pv(float (&o)[NTC][4], const float (&p)[NJ][4], const float* v,
                                      int st, int col0, int ntg, int nj) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
      const FragA pa = frag_a(p[j][0], p[j][2], p[j][1], p[j][3]);
      const float* v0 = v + (j * 8 + 2 * c) * st + col0 + g;
      const float* v1 = v0 + st;
#pragma unroll
      for (int nt = 0; nt < NTC; ++nt)
        if (nt < ntg) mma3_add(o[nt], pa, frag_b(v0[nt * 8], v1[nt * 8]));
    }
  }
}

// S = q k^T and dP = dO v^T of the 16 rows r0 (q, dO) and the 16 keys n0
// (k, v): two n8 tiles each.  bf16: chunk2_bf16; f32: mma3_add.
__device__ __forceinline__ void tc_chunk2(float (&s)[2][4], float (&dp)[2][4],
                                          const unsigned short* q, const unsigned short* k,
                                          const unsigned short* dout, const unsigned short* v,
                                          int st, int r0, int n0, int hd) {
  chunk2_bf16(s, q, k, dp, dout, v, st, r0, n0, (hd + 15) / 16);
}
template <int NH>
__device__ __forceinline__ void tc_chunk2(float (&s)[NH][4], float (&dp)[NH][4], const float* q,
                                          const float* k, const float* dout, const float* v,
                                          int st, int r0, int n0, int hd) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  const int nks = (hd + 7) / 8;
  for (int ks = 0; ks < nks; ++ks) {
    const int d = ks * 8 + c;
    const float* q0 = q + (r0 + g) * st + d;
    const float* o0 = dout + (r0 + g) * st + d;
    const FragA qa = frag_a(q0[0], q0[8 * st], q0[4], q0[8 * st + 4]);
    const FragA oa = frag_a(o0[0], o0[8 * st], o0[4], o0[8 * st + 4]);
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const float* kr = k + (n0 + 8 * n + g) * st + d;
      const float* vr = v + (n0 + 8 * n + g) * st + d;
      mma3_add(s[n], qa, frag_b(kr[0], kr[4]));
      mma3_add(dp[n], oa, frag_b(vr[0], vr[4]));
    }
  }
}

// S^T = k q^T and dP^T = v dO^T of the 16 keys r0 (k, v) and the 16 queries
// n0 (q, dO), each value the bits tc_chunk2 forms for S and dP: bf16
// chunk2_bf16 with the operands swapped; f32 mma3_add_t.
__device__ __forceinline__ void tc_chunk2_t(float (&pt)[2][4], float (&dpt)[2][4],
                                            const unsigned short* k, const unsigned short* v,
                                            const unsigned short* q, const unsigned short* dout,
                                            int st, int r0, int n0, int hd) {
  chunk2_bf16(pt, k, q, dpt, v, dout, st, r0, n0, (hd + 15) / 16);
}
template <int NH>
__device__ __forceinline__ void tc_chunk2_t(float (&pt)[NH][4], float (&dpt)[NH][4],
                                            const float* k, const float* v, const float* q,
                                            const float* dout, int st, int r0, int n0, int hd) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const float* k0 = k + (r0 + g) * st + c;
  const float* v0 = v + (r0 + g) * st + c;
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pt[n][e] = dpt[n][e] = 0.f;
  const int nks = (hd + 7) / 8;
  for (int ks = 0; ks < nks; ++ks) {
    const int d = ks * 8;
    const FragA ka = frag_a(k0[d], k0[8 * st + d], k0[d + 4], k0[8 * st + d + 4]);
    const FragA va = frag_a(v0[d], v0[8 * st + d], v0[d + 4], v0[8 * st + d + 4]);
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const float* qr = q + (n0 + 8 * n + g) * st + c + d;
      const float* orow = dout + (n0 + 8 * n + g) * st + c + d;
      mma3_add_t(pt[n], ka, frag_b(qr[0], qr[4]));
      mma3_add_t(dpt[n], va, frag_b(orow[0], orow[4]));
    }
  }
}

// acc += ds b for one 16-row x 16-key chunk of dS (accumulator layout, two
// n8 tiles) and the 16 rows n0 of b (keys: dQ = dS K), its ntg n8 column
// tiles from col0.
template <int NTC>
__device__ __forceinline__ void tc_ds_b(float (&acc)[NTC][4], const float (&ds)[2][4],
                                        const unsigned short* b, int st, int n0, int col0,
                                        int ntg) {
  uint32_t a[4];
  pack_a(a, ds[0], ds[1]);
#pragma unroll
  for (int np = 0; np < NTC / 2; ++np) {
    if (2 * np < ntg) {
      uint32_t f[4];
      tile_bt(f, b, st, n0, col0 + np * 16);
      mma_bf16(acc[2 * np], a, f[0], f[1]);
      if (2 * np + 1 < ntg) mma_bf16(acc[2 * np + 1], a, f[2], f[3]);
    }
  }
}
template <int NTC, int NH>
__device__ __forceinline__ void tc_ds_b(float (&acc)[NTC][4], const float (&ds)[NH][4],
                                        const float* b, int st, int n0, int col0, int ntg) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const FragA da = frag_a(ds[n][0], ds[n][2], ds[n][1], ds[n][3]);
    const float* r0 = b + (n0 + n * 8 + 2 * c) * st + col0 + g;
    const float* r1 = r0 + st;
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt) {
      if (nt < ntg) mma3_add(acc[nt], da, frag_b(r0[nt * 8], r1[nt * 8]));
    }
  }
}

// dV += P^T dO and dK += dS^T Q for one 16-key x 16-query chunk (P^T and
// dS^T in the accumulator layout, keys as rows) and the 16 query rows n0 of
// dO and Q, their ntg n8 column tiles from col0.  bf16: P^T and dS^T each
// as a hi + lo pair of bf16 operands.  dS^T rounded once failed the bf16
// check of dK against the plain version at (512, 256, 768, 16), a sum over
// 256 queries (0.0625 off it, H100); as a pair dK is 0.52 of the tolerance
// off it there, and dQ = dS K, with dS rounded once, 0.51
// (kernel_bench --components).
template <int NTC>
__device__ __forceinline__ void tc_dkv(float (&av)[NTC][4], float (&ak)[NTC][4],
                                       const float (&pt)[2][4], const float (&dst)[2][4],
                                       const unsigned short* dout, const unsigned short* q,
                                       int st, int n0, int col0, int ntg) {
  uint32_t hi[4], lo[4], sa[4], sl[4];
  split_bf16(pt[0][0], pt[0][1], hi[0], lo[0]);
  split_bf16(pt[0][2], pt[0][3], hi[1], lo[1]);
  split_bf16(pt[1][0], pt[1][1], hi[2], lo[2]);
  split_bf16(pt[1][2], pt[1][3], hi[3], lo[3]);
  split_bf16(dst[0][0], dst[0][1], sa[0], sl[0]);
  split_bf16(dst[0][2], dst[0][3], sa[1], sl[1]);
  split_bf16(dst[1][0], dst[1][1], sa[2], sl[2]);
  split_bf16(dst[1][2], dst[1][3], sa[3], sl[3]);
#pragma unroll
  for (int np = 0; np < NTC / 2; ++np) {
    if (2 * np < ntg) {
      const bool two = 2 * np + 1 < ntg;
      uint32_t b[4];
      tile_bt(b, dout, st, n0, col0 + np * 16);
      mma_bf16(av[2 * np], hi, b[0], b[1]);
      mma_bf16(av[2 * np], lo, b[0], b[1]);
      if (two) {
        mma_bf16(av[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(av[2 * np + 1], lo, b[2], b[3]);
      }
      tile_bt(b, q, st, n0, col0 + np * 16);
      mma_bf16(ak[2 * np], sa, b[0], b[1]);
      mma_bf16(ak[2 * np], sl, b[0], b[1]);
      if (two) {
        mma_bf16(ak[2 * np + 1], sa, b[2], b[3]);
        mma_bf16(ak[2 * np + 1], sl, b[2], b[3]);
      }
    }
  }
}
// f32: dK on the tensor cores (mma3_add); dV = P^T dO as one FMA chain per
// value over the queries in order (each lane gathers its key rows' P of
// the chunk's 16 queries from its quad by shuffles), as cuBLAS's exact-f32
// product, the plain version's, sums it.  The plain version's own dV is
// that chain's rounding: at (512, 256, 768, 16) it is 1.31 of the 1e-5 +
// 1e-5 |x| tolerance off a float64 reference where one key takes most of
// many queries' attention (kernel_bench --components, H100), and
// split-TF32 sums were 2.67e-5 off it there, past the check; the chain is
// 0.31 of the tolerance off it.
template <int NTC, int NH>
__device__ __forceinline__ void tc_dkv(float (&av)[NTC][4], float (&ak)[NTC][4],
                                       const float (&pt)[NH][4], const float (&dst)[NH][4],
                                       const float* dout, const float* q, int st, int n0,
                                       int col0, int ntg) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const FragA sa = frag_a(dst[n][0], dst[n][2], dst[n][1], dst[n][3]);
    const float* q0 = q + (n0 + n * 8 + 2 * c) * st + col0 + g;  // queries 2c, 2c + 1
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt)
      if (nt < ntg) mma3_add(ak[nt], sa, frag_b(q0[nt * 8], q0[st + nt * 8]));
  }
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int cs = 0; cs < 4; ++cs)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // query n0 + 8 n + 2 cs + e, in order
        const int src = (lane & ~3) | cs;
        const float p0 = __shfl_sync(0xffffffffu, pt[n][e], src);
        const float p1 = __shfl_sync(0xffffffffu, pt[n][2 + e], src);
        const float* o = dout + (n0 + 8 * n + 2 * cs + e) * st + col0 + 2 * c;
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt) {
          if (nt < ntg) {
            const float2 y = *reinterpret_cast<const float2*>(o + nt * 8);
            av[nt][0] = fmaf(p0, y.x, av[nt][0]);
            av[nt][1] = fmaf(p0, y.y, av[nt][1]);
            av[nt][2] = fmaf(p1, y.x, av[nt][2]);
            av[nt][3] = fmaf(p1, y.y, av[nt][3]);
          }
        }
      }
}

// Rows r0, r0 + 8 (this lane's) of a 16-row strip's accumulators, times
// s0 / s1, to rows of stride `row` of out (columns col0 + 8 nt + 2c of its
// ntg tiles, below hd), rows at or past L skipped.
template <int NTC, typename E>
__device__ __forceinline__ void tc_store(E* out, size_t row, const float (&acc)[NTC][4], int r0,
                                         int L, int col0, int ntg, int hd, float s0, float s1) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt) {
    const int col = col0 + nt * 8 + 2 * c;
    if (nt < ntg) {
      if (r0 < L) put_pair(out + (size_t)r0 * row + col, col, hd, acc[nt][0] * s0, acc[nt][1] * s0);
      if (r0 + 8 < L)
        put_pair(out + (size_t)(r0 + 8) * row + col, col, hd, acc[nt][2] * s1, acc[nt][3] * s1);
    }
  }
}

// Forward: one block per (sequence, head, query tile of R rows, column
// group), warp w the rows 16 w ..; the key and value tiles stream through
// the ring, the online softmax and the output accumulators in registers.
template <typename E, int NTC, int R>
__global__ void __launch_bounds__(2 * R, tc_min_blocks<E>())
    mhsa_long_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                     E* __restrict__ out, int L, int D, int H, float scale_log2) {
  using S = typename Staged<E>::type;
  constexpr int NJ = R / 8, es = sizeof(E);
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, es);
  const int hdp = es == 2 ? (hd + 15) / 16 * 16 : (hd + 7) / 8 * 8;
  const int ntiles = (L + R - 1) / R;
  const TcBlock blk = tc_block(H, ntiles, R, tc_groups(hd));
  S* sq = reinterpret_cast<S*>(smem);
  S* ring = sq + R * st;  // stage s: keys at ring + 2 s R st, values R st further
  float* sbias = reinterpret_cast<float*>(ring + 4 * R * st);
  const S* base = reinterpret_cast<const S*>(qkv) + blk.u * L * 3 * D + (size_t)blk.h * hd;
  const uint8_t* msk = mask + blk.u * L;
  tc_zero_pad(sq, 5 * R, hd, hdp, st);
  tc_stage(sq, base, blk.t0, R, L, 1, hd, 3 * (size_t)D, 0, st);
  tc_stage(ring, base + D, 0, R, L, 2, hd, 3 * (size_t)D, (size_t)D, st);
  long_biases(sbias, msk, 0, R, L);
  cp_async_commit();
  const int warp = threadIdx.x >> 5, c = threadIdx.x & 3;
  const int r0 = blk.t0 + warp * 16 + ((threadIdx.x & 31) >> 2);
  const bool active = blk.t0 + warp * 16 < L;
  const int col0 = blk.cg * 8 * NTC;
  const int ntg = min(NTC, (hd + 7) / 8 - blk.cg * NTC);
  float o[NTC][4];
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kMaskMin, m1 = kMaskMin, l0 = 0.f, l1 = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < ntiles) {
      const int nx = (kt + 1) & 1;
      tc_stage(ring + 2 * nx * R * st, base + D, (kt + 1) * R, R, L, 2, hd, 3 * (size_t)D,
               (size_t)D, st);
      long_biases(sbias + nx * R, msk, (kt + 1) * R, R, L);
    }
    cp_async_commit();
    if (!active) continue;
    const S* sk = ring + 2 * (kt & 1) * R * st;
    const float* bias = sbias + (kt & 1) * R;
    const int nj = min(NJ, (L - kt * R + 7) / 8);
    float sc[NJ][4];
    tc_logits<NJ>(sc, sq, sk, st, warp * 16, hd, nj);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * c);
        sc[j][0] = fmaf(sc[j][0], scale_log2, b.x);
        sc[j][1] = fmaf(sc[j][1], scale_log2, b.y);
        sc[j][2] = fmaf(sc[j][2], scale_log2, b.x);
        sc[j][3] = fmaf(sc[j][3], scale_log2, b.y);
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
    }
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool on = j < nj;
      sc[j][0] = on ? ex2(sc[j][0] - n0) : 0.f;
      sc[j][1] = on ? ex2(sc[j][1] - n0) : 0.f;
      sc[j][2] = on ? ex2(sc[j][2] - n1) : 0.f;
      sc[j][3] = on ? ex2(sc[j][3] - n1) : 0.f;
      s0 += sc[j][0] + sc[j][1];
      s1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * a0 + s0;  // this lane's part of the row sums
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }
    tc_pv<NJ, NTC>(o, sc, sk + R * st, st, col0, ntg, nj);
  }
  l0 = quad_sum(l0);  // >= 1: the max term is 2^0
  l1 = quad_sum(l1);
  if (active)
    tc_store<NTC>(out + blk.u * L * D + (size_t)blk.h * hd, (size_t)D, o, r0, L, col0, ntg, hd,
                  1.f / l0, 1.f / l1);
}

// The query tile and its dO rows, and the first key and value tile, of the
// statistics and dQ kernels, into their shared memory (kind 1).
template <typename S, int R>
struct TcQuery {
  S *sq, *sdo, *ring;
  float* sbias;
  const S* base;
  const uint8_t* msk;
  __device__ TcQuery(char* smem, const S* qkv, const uint8_t* mask, const S* dout, const TcBlock& b,
                     int L, int D, int hd, int st) {
    const int hdp = sizeof(S) == 2 ? (hd + 15) / 16 * 16 : (hd + 7) / 8 * 8;
    sq = reinterpret_cast<S*>(smem);
    sdo = sq + R * st;
    ring = sdo + R * st;
    sbias = reinterpret_cast<float*>(ring + 4 * R * st);
    base = qkv + b.u * L * 3 * D + (size_t)b.h * hd;
    msk = mask + b.u * L;
    tc_zero_pad(sq, 6 * R, hd, hdp, st);
    tc_stage(sq, base, b.t0, R, L, 1, hd, 3 * (size_t)D, 0, st);
    tc_stage(sdo, dout + b.u * L * D + (size_t)b.h * hd, b.t0, R, L, 1, hd, (size_t)D, 0, st);
    next(0, L, D, hd, st);
  }
  // Stage key tile kt (and its biases) into stage kt % 2, then commit.
  __device__ void next(int kt, int L, int D, int hd, int st) {
    if (kt * R < L) {
      tc_stage(ring + 2 * (kt & 1) * R * st, base + D, kt * R, R, L, 2, hd, 3 * (size_t)D,
               (size_t)D, st);
      long_biases(sbias + (kt & 1) * R, msk, kt * R, R, L);
    }
    cp_async_commit();
  }
};

// Backward, (1) the row statistics: one block per (sequence, head, query
// tile); per row its max (log2 units), 1 / sum and D = rowsum(P * dP) into
// stats ((U, H, L) x 3 floats), each 16-key chunk's S and dP folded into
// the online max, sum and D.
template <typename E, int R>
__global__ void __launch_bounds__(2 * R, tc_min_blocks<E>())
    mhsa_long_stats_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                           const E* __restrict__ dout, float* __restrict__ stats, int L, int D,
                           int H, float scale_log2) {
  using S = typename Staged<E>::type;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, sizeof(E));
  const int ntiles = (L + R - 1) / R;
  const TcBlock blk = tc_block(H, ntiles, R, 1);
  TcQuery<S, R> t(smem, reinterpret_cast<const S*>(qkv), mask, reinterpret_cast<const S*>(dout),
                  blk, L, D, hd, st);
  const int warp = threadIdx.x >> 5, c = threadIdx.x & 3;
  const int r0 = blk.t0 + warp * 16 + ((threadIdx.x & 31) >> 2);
  const bool active = blk.t0 + warp * 16 < L;
  float m0 = kMaskMin, m1 = kMaskMin, l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    t.next(kt + 1, L, D, hd, st);
    if (!active) continue;
    const S* sk = t.ring + 2 * (kt & 1) * R * st;
    const float* bias = t.sbias + (kt & 1) * R;
    for (int kk = 0; kk < R / 16 && kt * R + kk * 16 < L; ++kk) {
      float s[2][4], dp[2][4];
      tc_chunk2(s, dp, t.sq, sk, t.sdo, sk + R * st, st, warp * 16, kk * 16, hd);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(bias + kk * 16 + n * 8 + 2 * c);
        s[n][0] = fmaf(s[n][0], scale_log2, b.x);
        s[n][1] = fmaf(s[n][1], scale_log2, b.y);
        s[n][2] = fmaf(s[n][2], scale_log2, b.x);
        s[n][3] = fmaf(s[n][3], scale_log2, b.y);
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
      const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.f, s1 = 0.f, e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float p0 = ex2(s[n][0] - n0), p1 = ex2(s[n][1] - n0);
        const float p2 = ex2(s[n][2] - n1), p3 = ex2(s[n][3] - n1);
        s0 += p0 + p1;
        s1 += p2 + p3;
        e0 += p0 * dp[n][0] + p1 * dp[n][1];
        e1 += p2 * dp[n][2] + p3 * dp[n][3];
      }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
      d0 = d0 * a0 + e0;
      d1 = d1 * a1 + e1;
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (active && c == 0) {
    float* row = stats + (blk.u * H + blk.h) * L * 3;
    if (r0 < L) {
      row[3 * (size_t)r0] = m0;
      row[3 * (size_t)r0 + 1] = 1.f / l0;
      row[3 * (size_t)r0 + 2] = d0 / l0;
    }
    if (r0 + 8 < L) {
      row[3 * (size_t)(r0 + 8)] = m1;
      row[3 * (size_t)(r0 + 8) + 1] = 1.f / l1;
      row[3 * (size_t)(r0 + 8) + 2] = d1 / l1;
    }
  }
}

// P and dS of one logit s (dot product) from its key's bias and its query's
// statistics: the same expression in the dQ and the dK / dV kernels.
__device__ __forceinline__ void tc_p_ds(float& s, float& dp, float bias, float m, float inv,
                                        float dd, float scale_log2) {
  s = ex2(fmaf(s, scale_log2, bias) - m) * inv;
  dp = bias == 0.f ? s * (dp - dd) : 0.f;
}

// Backward, (2) dQ: one block per (sequence, head, query tile, column
// group), the key tiles streamed: dQ = scale sum over keys of dS K.
template <typename E, int NTC, int R>
__global__ void __launch_bounds__(2 * R, tc_min_blocks<E>())
    mhsa_long_dq_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        const E* __restrict__ dout, const float* __restrict__ stats,
                        E* __restrict__ dqkv, int L, int D, int H, float scale_log2,
                        float scale) {
  using S = typename Staged<E>::type;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, sizeof(E));
  const int ntiles = (L + R - 1) / R;
  const TcBlock blk = tc_block(H, ntiles, R, tc_groups(hd));
  TcQuery<S, R> t(smem, reinterpret_cast<const S*>(qkv), mask, reinterpret_cast<const S*>(dout),
                  blk, L, D, hd, st);
  const int warp = threadIdx.x >> 5, c = threadIdx.x & 3;
  const int r0 = blk.t0 + warp * 16 + ((threadIdx.x & 31) >> 2);
  const bool active = blk.t0 + warp * 16 < L;
  const int col0 = blk.cg * 8 * NTC;
  const int ntg = min(NTC, (hd + 7) / 8 - blk.cg * NTC);
  const float* row = stats + (blk.u * H + blk.h) * L * 3;
  float st0[3] = {0.f, 0.f, 0.f}, st1[3] = {0.f, 0.f, 0.f};  // max, 1 / sum, D
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (r0 < L) st0[k] = row[3 * (size_t)r0 + k];
    if (r0 + 8 < L) st1[k] = row[3 * (size_t)(r0 + 8) + k];
  }
  float acc[NTC][4];
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    t.next(kt + 1, L, D, hd, st);
    if (!active) continue;
    const S* sk = t.ring + 2 * (kt & 1) * R * st;
    const float* bias = t.sbias + (kt & 1) * R;
    for (int kk = 0; kk < R / 16 && kt * R + kk * 16 < L; ++kk) {
      float s[2][4], dp[2][4];
      tc_chunk2(s, dp, t.sq, sk, t.sdo, sk + R * st, st, warp * 16, kk * 16, hd);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(bias + kk * 16 + n * 8 + 2 * c);
        tc_p_ds(s[n][0], dp[n][0], b.x, st0[0], st0[1], st0[2], scale_log2);
        tc_p_ds(s[n][1], dp[n][1], b.y, st0[0], st0[1], st0[2], scale_log2);
        tc_p_ds(s[n][2], dp[n][2], b.x, st1[0], st1[1], st1[2], scale_log2);
        tc_p_ds(s[n][3], dp[n][3], b.y, st1[0], st1[1], st1[2], scale_log2);
      }
      tc_ds_b<NTC>(acc, dp, sk, st, kk * 16, col0, ntg);
    }
  }
  if (active)
    tc_store<NTC>(dqkv + blk.u * L * 3 * D + (size_t)blk.h * hd, 3 * (size_t)D, acc, r0, L, col0,
                  ntg, hd, scale, scale);
}

// Backward, (3) dK and dV: one block per (sequence, head, key tile, column
// group), warp w the keys 16 w ..; the query tiles, their dO rows and their
// statistics streamed through the ring: dV = sum over queries of P^T dO,
// dK = scale sum of dS^T Q.
template <typename E, int NTC, int R>
__global__ void __launch_bounds__(2 * R, tc_min_blocks<E>())
    mhsa_long_dkv_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const E* __restrict__ dout, const float* __restrict__ stats,
                         E* __restrict__ dqkv, int L, int D, int H, float scale_log2,
                         float scale) {
  using S = typename Staged<E>::type;
  constexpr int es = sizeof(E);
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, es);
  const int hdp = es == 2 ? (hd + 15) / 16 * 16 : (hd + 7) / 8 * 8;
  const int ntiles = (L + R - 1) / R;
  const TcBlock blk = tc_block(H, ntiles, R, tc_groups(hd));
  S* sk = reinterpret_cast<S*>(smem);
  S* sv = sk + R * st;
  S* ring = sv + R * st;  // stage s: queries at ring + 2 s R st, dO R st further
  float* sstat = reinterpret_cast<float*>(ring + 4 * R * st);  // stage s: 3 R floats at 3 s R
  const S* base = reinterpret_cast<const S*>(qkv) + blk.u * L * 3 * D + (size_t)blk.h * hd;
  const S* gbase = reinterpret_cast<const S*>(dout) + blk.u * L * D + (size_t)blk.h * hd;
  const float* srow = stats + (blk.u * H + blk.h) * L * 3;
  tc_zero_pad(sk, 6 * R, hd, hdp, st);
  tc_stage(sk, base + D, blk.t0, R, L, 2, hd, 3 * (size_t)D, (size_t)D, st);
  auto next = [&](int qt) {
    if (qt * R < L) {
      S* q = ring + 2 * (qt & 1) * R * st;
      tc_stage(q, base, qt * R, R, L, 1, hd, 3 * (size_t)D, 0, st);
      tc_stage(q + R * st, gbase, qt * R, R, L, 1, hd, (size_t)D, 0, st);
      tc_stage_stats(sstat + 3 * (qt & 1) * R, srow, qt * R, R, L);
    }
    cp_async_commit();
  };
  next(0);
  const int warp = threadIdx.x >> 5, c = threadIdx.x & 3;
  const int k0 = blk.t0 + warp * 16 + ((threadIdx.x & 31) >> 2);  // this lane's key rows
  const bool active = blk.t0 + warp * 16 < L;
  const uint8_t* msk = mask + blk.u * L;
  const float b0 = k0 < L ? (msk[k0] ? 0.f : kMaskMin) : -INFINITY;
  const float b1 = k0 + 8 < L ? (msk[k0 + 8] ? 0.f : kMaskMin) : -INFINITY;
  const int col0 = blk.cg * 8 * NTC;
  const int ntg = min(NTC, (hd + 7) / 8 - blk.cg * NTC);
  float av[NTC][4], ak[NTC][4];
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
  for (int qt = 0; qt < ntiles; ++qt) {
    cp_async_wait_all();
    __syncthreads();
    next(qt + 1);
    if (!active) continue;
    const S* sq = ring + 2 * (qt & 1) * R * st;
    const S* sdo = sq + R * st;
    const float* sm = sstat + 3 * (qt & 1) * R;
    for (int qc = 0; qc < R / 16 && qt * R + qc * 16 < L; ++qc) {
      float pt[2][4], dst[2][4];  // P^T and dP^T, then dS^T: keys as rows
      tc_chunk2_t(pt, dst, sk, sv, sq, sdo, st, warp * 16, qc * 16, hd);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qc * 16 + n * 8 + 2 * c + e;
          const float m = sm[qi], iv = sm[R + qi], dd = sm[2 * R + qi];
          tc_p_ds(pt[n][e], dst[n][e], b0, m, iv, dd, scale_log2);
          tc_p_ds(pt[n][2 + e], dst[n][2 + e], b1, m, iv, dd, scale_log2);
        }
      }
      tc_dkv<NTC>(av, ak, pt, dst, sdo, sq, st, qc * 16, col0, ntg);
    }
  }
  if (active) {
    E* g = dqkv + blk.u * L * 3 * D + (size_t)blk.h * hd;
    tc_store<NTC>(g + D, 3 * (size_t)D, ak, k0, L, col0, ntg, hd, scale, scale);
    tc_store<NTC>(g + 2 * D, 3 * (size_t)D, av, k0, L, col0, ntg, hd, 1.f, 1.f);
  }
}

// ------------------------------------------------------------- long, XL ---
//
// Head dims above the tensor-core instances' bound (257 .. 1,024 in bf16,
// above kLongTcMaxHeadDimF32 in float32: long_tc) run in the XL instances,
// on the tensor cores too.  There a 16-row strip's output accumulators for
// the whole head would need 128 registers and more a thread, and column
// groups as separate blocks would form the logits once per group (16 times
// at head dim 1,024).  So one block splits the head dim over its warps and
// forms the logits of each pair of tiles once:
//
// * One block per (sequence, head, 16-row tile): xl_warps(hd) = ceil(hd /
//   64) warps, warp w the 64 columns 64 w .. of every product (the last
//   group zero-padded to the k step).  The block's own rows (queries, or
//   keys in the dK / dV kernel) stay staged; the streamed tiles (keys and
//   values, or queries and dO with their statistics) go through the
//   tensor-core instances' two-stage cp.async ring, one stage where two do
//   not fit 232,448 bytes (xl_stages: float32's backward kernels from head
//   dim 841 up).  Streamed tiles are T = 16 rows in bf16 and 8 in float32
//   (XlTile): the k step of P V, dS K and the dK / dV products.  Staged in
//   the input type with the wide instances' padded rows (wide_stride).
// * The logits of a (16-row tile, T-row tile) pair are formed once: each
//   warp forms the partial dot products over its 64 columns (bf16
//   mma.sync m16n8k16 by ldmatrix, float32 split TF32, as the tensor-core
//   instances), writes them to shared memory, and after a barrier the
//   block's threads sum them over the warps in order, one element each
//   (xl_reduce).  dP = dO V^T in the backward the same way.  After a second
//   barrier every warp reads the sums in its accumulator layout: the
//   forward's online softmax (each warp keeps the same running max and sum)
//   and P V into its columns; the backward's P and dS from the row
//   statistics, then dQ += dS K, or dV += P^T dO and dK += dS^T Q, into its
//   columns, as the tensor-core instances (bf16 P and dS into dV and dK as
//   hi + lo pairs, float32 dV by in-order FMA chains: tc_dkv).
// * The same logits in all three backward kernels: each warp's partial is
//   the tensor-core instances' bits with queries or keys as rows
//   (chunk2_bf16 with the operands swapped, mma3_add / mma3_add_t), and the
//   sum over the warps runs in the same order in each kernel, so P is the
//   same bits in the statistics, dQ and dK / dV kernels and dP - D cancels
//   where one key takes all the attention.
// * Shared memory at head dim 1,024 (xl_smem): bf16 181,632 bytes (the
//   forward), 231,040 (statistics, dQ) and 231,296 (dK / dV), all two
//   stages; float32 205,632 (the forward, two stages), 213,792 and 213,856
//   (one stage).  At most 128 registers a thread (16 warps a block).
constexpr int kXlCols = 64;                          // columns of a warp
constexpr int kXlMaxWarps = kMaxHeadDim / kXlCols;  // warps a block at head dim 1,024

// Rows of a streamed tile of the XL instances, and its n8 tiles.
template <typename E>
struct XlTile {
  static constexpr int T = sizeof(E) == 2 ? 16 : 8;
  static constexpr int NH = T / 8;
};
__host__ __device__ inline int xl_warps(int hd) { return (hd + kXlCols - 1) / kXlCols; }
// Shared memory of an XL kernel with `stages` stages of the ring: kind 0
// the forward (the query tile, key and value tiles, key biases, one plane
// of partial logits), 1 the statistics and dQ kernels (the query and dO
// tiles, the same ring, two planes: S and dP), 2 the dK / dV kernel (the
// block's key and value tiles, query and dO tiles, their statistics, two
// planes).  A plane holds each warp's 16 x T partial sums.
__host__ __device__ inline size_t xl_smem(int hd, int es, int kind, int stages) {
  const size_t T = es == 2 ? 16 : 8, row = (size_t)wide_stride(hd, es) * es;
  const size_t own = (kind == 0 ? 1 : 2) * 16 * row, ring = (size_t)stages * 2 * T * row;
  const size_t side = (size_t)stages * (kind == 2 ? 3 : 1) * T * 4;
  return own + ring + side + (kind == 0 ? 1 : 2) * (size_t)xl_warps(hd) * 16 * T * 4;
}
__host__ __device__ inline int xl_stages(int hd, int es, int kind) {
  return xl_smem(hd, es, kind, 2) <= (size_t)kSmemLimit ? 2 : 1;
}
// The largest of the three kernels' shared memory.
__host__ __device__ inline size_t xl_instance_smem(int hd, int es) {
  size_t m = 0;
  for (int kind = 0; kind < 3; ++kind) {
    const size_t b = xl_smem(hd, es, kind, xl_stages(hd, es, kind));
    m = b > m ? b : m;
  }
  return m;
}

// A warp's NH n8 tiles of 16 x T sums (accumulator layout) to rows of T
// floats at `part`, and back.
template <int NH>
__device__ __forceinline__ void xl_put(float* part, const float (&x)[NH][4]) {
  constexpr int T = 8 * NH;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    *reinterpret_cast<float2*>(part + g * T + 8 * n + 2 * c) = make_float2(x[n][0], x[n][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * T + 8 * n + 2 * c) = make_float2(x[n][2], x[n][3]);
  }
}
template <int NH>
__device__ __forceinline__ void xl_get(float (&x)[NH][4], const float* part) {
  constexpr int T = 8 * NH;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const float2 a = *reinterpret_cast<const float2*>(part + g * T + 8 * n + 2 * c);
    const float2 b = *reinterpret_cast<const float2*>(part + (g + 8) * T + 8 * n + 2 * c);
    x[n][0] = a.x;
    x[n][1] = a.y;
    x[n][2] = b.x;
    x[n][3] = b.y;
  }
}

// Sum `planes` planes of `warps` slots of n floats each (slot w of plane p
// at part + (p warps + w) n) over the slots, in slot order, into slot 0;
// one element a thread.
__device__ void xl_reduce(float* part, int n, int warps, int planes) {
  for (int i = threadIdx.x; i < planes * n; i += blockDim.x) {
    const int p = i / n;
    float* x = part + (size_t)p * warps * n + (i - p * n);
    float s = x[0];
    for (int w = 1; w < warps; ++w) s += x[(size_t)w * n];
    x[0] = s;
  }
}

// The block's (sequence, head, 16-row tile), its warp's first column and
// columns, and their n8 tiles.
struct XlWarp {
  TcBlock blk;
  int col0, cols, ntg;
};
__device__ __forceinline__ XlWarp xl_warp(int L, int H, int hd) {
  XlWarp x;
  x.blk = tc_block(H, (L + 15) / 16, 16, 1);
  x.col0 = (threadIdx.x >> 5) * kXlCols;
  x.cols = min(kXlCols, hd - x.col0);
  x.ntg = (x.cols + 7) / 8;
  return x;
}

// Forward: the key and value tiles streamed, the online softmax of the
// tensor-core forward over the summed logits, P V into the warp's columns.
template <typename E>
__global__ void __launch_bounds__(kXlMaxWarps * 32)
    mhsa_long_xl_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        E* __restrict__ out, int L, int D, int H, int stages, float scale_log2) {
  using S = typename Staged<E>::type;
  constexpr int T = XlTile<E>::T, NH = XlTile<E>::NH, es = sizeof(E);
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, es), nw = xl_warps(hd);
  const int hdp = es == 2 ? (hd + 15) / 16 * 16 : (hd + 7) / 8 * 8;
  const XlWarp x = xl_warp(L, H, hd);
  S* sq = reinterpret_cast<S*>(smem);
  S* ring = sq + 16 * st;  // stage s: keys at ring + 2 s T st, values T st further
  float* sbias = reinterpret_cast<float*>(ring + 2 * stages * T * st);
  float* part = sbias + stages * T;
  const S* base = reinterpret_cast<const S*>(qkv) + x.blk.u * L * 3 * D + (size_t)x.blk.h * hd;
  const uint8_t* msk = mask + x.blk.u * L;
  tc_zero_pad(sq, 16 + 2 * stages * T, hd, hdp, st);
  tc_stage(sq, base, x.blk.t0, 16, L, 1, hd, 3 * (size_t)D, 0, st);
  auto next = [&](int kt) {
    if (kt * T < L) {
      const int s = kt % stages;
      tc_stage(ring + 2 * s * T * st, base + D, kt * T, T, L, 2, hd, 3 * (size_t)D, (size_t)D, st);
      long_biases(sbias + s * T, msk, kt * T, T, L);
    }
    cp_async_commit();
  };
  next(0);
  const int warp = threadIdx.x >> 5, c = threadIdx.x & 3;
  const int r0 = x.blk.t0 + ((threadIdx.x & 31) >> 2);
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kMaskMin, m1 = kMaskMin, l0 = 0.f, l1 = 0.f;
  const int nk = (L + T - 1) / T;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (stages == 2) next(kt + 1);
    const S* sk = ring + 2 * (kt % stages) * T * st;
    const float* bias = sbias + (kt % stages) * T;
    float sc[NH][4];
    tc_logits<NH>(sc, sq + x.col0, sk + x.col0, st, 0, x.cols, NH);
    xl_put<NH>(part + warp * 16 * T, sc);
    __syncthreads();
    xl_reduce(part, 16 * T, nw, 1);
    __syncthreads();
    xl_get<NH>(sc, part);
    const int nj = min(NH, (L - kt * T + 7) / 8);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (j < nj) {
        const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * c);
        sc[j][0] = fmaf(sc[j][0], scale_log2, b.x);
        sc[j][1] = fmaf(sc[j][1], scale_log2, b.y);
        sc[j][2] = fmaf(sc[j][2], scale_log2, b.x);
        sc[j][3] = fmaf(sc[j][3], scale_log2, b.y);
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
    }
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const bool on = j < nj;
      sc[j][0] = on ? ex2(sc[j][0] - n0) : 0.f;
      sc[j][1] = on ? ex2(sc[j][1] - n0) : 0.f;
      sc[j][2] = on ? ex2(sc[j][2] - n1) : 0.f;
      sc[j][3] = on ? ex2(sc[j][3] - n1) : 0.f;
      s0 += sc[j][0] + sc[j][1];
      s1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }
    tc_pv<NH, 8>(o, sc, sk + T * st, st, x.col0, x.ntg, nj);
    if (stages == 1) {
      __syncthreads();
      next(kt + 1);
    }
  }
  l0 = quad_sum(l0);  // >= 1: the max term is 2^0
  l1 = quad_sum(l1);
  tc_store<8>(out + x.blk.u * L * D + (size_t)x.blk.h * hd, (size_t)D, o, r0, L, x.col0, x.ntg, hd,
              1.f / l0, 1.f / l1);
}

// The statistics and dQ kernels' shared memory (kind 1): the query and dO
// tiles of the block's 16 rows, then the key and value tiles streamed.
template <typename E>
struct XlQuery {
  using S = typename Staged<E>::type;
  static constexpr int T = XlTile<E>::T;
  S *sq, *sdo, *ring;
  float *sbias, *part;
  const S* base;
  const uint8_t* msk;
  int stages;
  __device__ XlQuery(char* smem, const E* qkv, const uint8_t* mask, const E* dout,
                     const TcBlock& b, int L, int D, int hd, int st, int stages_)
      : stages(stages_) {
    const int hdp = sizeof(E) == 2 ? (hd + 15) / 16 * 16 : (hd + 7) / 8 * 8;
    sq = reinterpret_cast<S*>(smem);
    sdo = sq + 16 * st;
    ring = sdo + 16 * st;
    sbias = reinterpret_cast<float*>(ring + 2 * stages * T * st);
    part = sbias + stages * T;
    base = reinterpret_cast<const S*>(qkv) + b.u * L * 3 * D + (size_t)b.h * hd;
    msk = mask + b.u * L;
    tc_zero_pad(sq, 32 + 2 * stages * T, hd, hdp, st);
    tc_stage(sq, base, b.t0, 16, L, 1, hd, 3 * (size_t)D, 0, st);
    tc_stage(sdo, reinterpret_cast<const S*>(dout) + b.u * L * D + (size_t)b.h * hd, b.t0, 16, L,
             1, hd, (size_t)D, 0, st);
    next(0, L, D, hd, st);
  }
  // Stage key tile kt (and its biases) into stage kt % stages, then commit.
  __device__ void next(int kt, int L, int D, int hd, int st) {
    if (kt * T < L) {
      const int s = kt % stages;
      tc_stage(ring + 2 * s * T * st, base + D, kt * T, T, L, 2, hd, 3 * (size_t)D, (size_t)D,
               st);
      long_biases(sbias + s * T, msk, kt * T, T, L);
    }
    cp_async_commit();
  }
  // After the tile's barrier: S and dP of the 16 rows and key tile kt, the
  // partial sums of every warp summed, in each warp's accumulator layout
  // (`all` false: warp 0 alone reads them).
  template <int NH>
  __device__ void logits(float (&s)[NH][4], float (&dp)[NH][4], int kt, int st, int nw,
                         const XlWarp& x, bool all) {
    const S* sk = ring + 2 * (kt % stages) * T * st;
    tc_chunk2(s, dp, sq + x.col0, sk + x.col0, sdo + x.col0, sk + T * st + x.col0, st, 0, 0,
              x.cols);
    const int warp = threadIdx.x >> 5;
    xl_put<NH>(part + warp * 16 * T, s);
    xl_put<NH>(part + (nw + warp) * 16 * T, dp);
    __syncthreads();
    xl_reduce(part, 16 * T, nw, 2);
    __syncthreads();
    if (all || warp == 0) {
      xl_get<NH>(s, part);
      xl_get<NH>(dp, part + nw * 16 * T);
    }
  }
};

// Backward, (1) the row statistics: one block per (sequence, head, query
// tile of 16), the key tiles streamed; warp 0 folds each tile's summed S
// and dP into the online max, sum and D and writes them as the tensor-core
// statistics kernel does.
template <typename E>
__global__ void __launch_bounds__(kXlMaxWarps * 32)
    mhsa_long_xl_stats_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                              const E* __restrict__ dout, float* __restrict__ stats, int L, int D,
                              int H, int stages, float scale_log2) {
  constexpr int T = XlTile<E>::T, NH = XlTile<E>::NH;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, sizeof(E)), nw = xl_warps(hd);
  const XlWarp x = xl_warp(L, H, hd);
  XlQuery<E> t(smem, qkv, mask, dout, x.blk, L, D, hd, st, stages);
  const int c = threadIdx.x & 3;
  const int r0 = x.blk.t0 + ((threadIdx.x & 31) >> 2);
  float m0 = kMaskMin, m1 = kMaskMin, l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  const int nk = (L + T - 1) / T;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (stages == 2) t.next(kt + 1, L, D, hd, st);
    float s[NH][4], dp[NH][4];
    t.template logits<NH>(s, dp, kt, st, nw, x, false);
    if (threadIdx.x < 32) {
      const float* bias = t.sbias + (kt % stages) * T;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(bias + n * 8 + 2 * c);
        s[n][0] = fmaf(s[n][0], scale_log2, b.x);
        s[n][1] = fmaf(s[n][1], scale_log2, b.y);
        s[n][2] = fmaf(s[n][2], scale_log2, b.x);
        s[n][3] = fmaf(s[n][3], scale_log2, b.y);
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
      const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.f, s1 = 0.f, e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float p0 = ex2(s[n][0] - n0), p1 = ex2(s[n][1] - n0);
        const float p2 = ex2(s[n][2] - n1), p3 = ex2(s[n][3] - n1);
        s0 += p0 + p1;
        s1 += p2 + p3;
        e0 += p0 * dp[n][0] + p1 * dp[n][1];
        e1 += p2 * dp[n][2] + p3 * dp[n][3];
      }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
      d0 = d0 * a0 + e0;
      d1 = d1 * a1 + e1;
    }
    if (stages == 1) {
      __syncthreads();
      t.next(kt + 1, L, D, hd, st);
    }
  }
  if (threadIdx.x >= 32) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (c == 0) {
    float* row = stats + (x.blk.u * H + x.blk.h) * L * 3;
    if (r0 < L) {
      row[3 * (size_t)r0] = m0;
      row[3 * (size_t)r0 + 1] = 1.f / l0;
      row[3 * (size_t)r0 + 2] = d0 / l0;
    }
    if (r0 + 8 < L) {
      row[3 * (size_t)(r0 + 8)] = m1;
      row[3 * (size_t)(r0 + 8) + 1] = 1.f / l1;
      row[3 * (size_t)(r0 + 8) + 2] = d1 / l1;
    }
  }
}

// Backward, (2) dQ: one block per (sequence, head, query tile of 16), the
// key tiles streamed: dQ = scale sum over keys of dS K, the warp's columns.
template <typename E>
__global__ void __launch_bounds__(kXlMaxWarps * 32)
    mhsa_long_xl_dq_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                           const E* __restrict__ dout, const float* __restrict__ stats,
                           E* __restrict__ dqkv, int L, int D, int H, int stages,
                           float scale_log2, float scale) {
  constexpr int T = XlTile<E>::T, NH = XlTile<E>::NH;
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, sizeof(E)), nw = xl_warps(hd);
  const XlWarp x = xl_warp(L, H, hd);
  XlQuery<E> t(smem, qkv, mask, dout, x.blk, L, D, hd, st, stages);
  const int c = threadIdx.x & 3;
  const int r0 = x.blk.t0 + ((threadIdx.x & 31) >> 2);
  const float* row = stats + (x.blk.u * H + x.blk.h) * L * 3;
  float st0[3] = {0.f, 0.f, 0.f}, st1[3] = {0.f, 0.f, 0.f};  // max, 1 / sum, D
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (r0 < L) st0[k] = row[3 * (size_t)r0 + k];
    if (r0 + 8 < L) st1[k] = row[3 * (size_t)(r0 + 8) + k];
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int nk = (L + T - 1) / T;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (stages == 2) t.next(kt + 1, L, D, hd, st);
    float s[NH][4], dp[NH][4];
    t.template logits<NH>(s, dp, kt, st, nw, x, true);
    const float* bias = t.sbias + (kt % stages) * T;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(bias + n * 8 + 2 * c);
      tc_p_ds(s[n][0], dp[n][0], b.x, st0[0], st0[1], st0[2], scale_log2);
      tc_p_ds(s[n][1], dp[n][1], b.y, st0[0], st0[1], st0[2], scale_log2);
      tc_p_ds(s[n][2], dp[n][2], b.x, st1[0], st1[1], st1[2], scale_log2);
      tc_p_ds(s[n][3], dp[n][3], b.y, st1[0], st1[1], st1[2], scale_log2);
    }
    tc_ds_b<8>(acc, dp, t.ring + 2 * (kt % stages) * T * st, st, 0, x.col0, x.ntg);
    if (stages == 1) {
      __syncthreads();
      t.next(kt + 1, L, D, hd, st);
    }
  }
  tc_store<8>(dqkv + x.blk.u * L * 3 * D + (size_t)x.blk.h * hd, 3 * (size_t)D, acc, r0, L, x.col0,
              x.ntg, hd, scale, scale);
}

// Backward, (3) dK and dV: one block per (sequence, head, key tile of 16),
// the query tiles, their dO rows and statistics streamed, keys as the rows:
// dV = sum over queries of P^T dO, dK = scale sum of dS^T Q, the warp's
// columns.
template <typename E>
__global__ void __launch_bounds__(kXlMaxWarps * 32)
    mhsa_long_xl_dkv_kernel(const E* __restrict__ qkv, const uint8_t* __restrict__ mask,
                            const E* __restrict__ dout, const float* __restrict__ stats,
                            E* __restrict__ dqkv, int L, int D, int H, int stages,
                            float scale_log2, float scale) {
  using S = typename Staged<E>::type;
  constexpr int T = XlTile<E>::T, NH = XlTile<E>::NH, es = sizeof(E);
  extern __shared__ __align__(16) char smem[];
  const int hd = D / H, st = wide_stride(hd, es), nw = xl_warps(hd);
  const int hdp = es == 2 ? (hd + 15) / 16 * 16 : (hd + 7) / 8 * 8;
  const XlWarp x = xl_warp(L, H, hd);
  S* sk = reinterpret_cast<S*>(smem);
  S* sv = sk + 16 * st;
  S* ring = sv + 16 * st;  // stage s: queries at ring + 2 s T st, dO T st further
  float* sstat = reinterpret_cast<float*>(ring + 2 * stages * T * st);  // stage s: 3 T at 3 s T
  float* part = sstat + 3 * stages * T;
  const S* base = reinterpret_cast<const S*>(qkv) + x.blk.u * L * 3 * D + (size_t)x.blk.h * hd;
  const S* gbase = reinterpret_cast<const S*>(dout) + x.blk.u * L * D + (size_t)x.blk.h * hd;
  const float* srow = stats + (x.blk.u * H + x.blk.h) * L * 3;
  tc_zero_pad(sk, 32 + 2 * stages * T, hd, hdp, st);
  tc_stage(sk, base + D, x.blk.t0, 16, L, 2, hd, 3 * (size_t)D, (size_t)D, st);
  auto next = [&](int qt) {
    if (qt * T < L) {
      const int s = qt % stages;
      S* q = ring + 2 * s * T * st;
      tc_stage(q, base, qt * T, T, L, 1, hd, 3 * (size_t)D, 0, st);
      tc_stage(q + T * st, gbase, qt * T, T, L, 1, hd, (size_t)D, 0, st);
      tc_stage_stats(sstat + 3 * s * T, srow, qt * T, T, L);
    }
    cp_async_commit();
  };
  next(0);
  const int warp = threadIdx.x >> 5, c = threadIdx.x & 3;
  const int k0 = x.blk.t0 + ((threadIdx.x & 31) >> 2);  // this lane's key rows
  const uint8_t* msk = mask + x.blk.u * L;
  const float b0 = k0 < L ? (msk[k0] ? 0.f : kMaskMin) : -INFINITY;
  const float b1 = k0 + 8 < L ? (msk[k0 + 8] ? 0.f : kMaskMin) : -INFINITY;
  float av[8][4], ak[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
  const int nq = (L + T - 1) / T;
  for (int qt = 0; qt < nq; ++qt) {
    cp_async_wait_all();
    __syncthreads();
    if (stages == 2) next(qt + 1);
    const S* sq = ring + 2 * (qt % stages) * T * st;
    const S* sdo = sq + T * st;
    const float* sm = sstat + 3 * (qt % stages) * T;
    float pt[NH][4], dst[NH][4];  // P^T and dP^T, then dS^T: keys as rows
    tc_chunk2_t(pt, dst, sk + x.col0, sv + x.col0, sq + x.col0, sdo + x.col0, st, 0, 0, x.cols);
    xl_put<NH>(part + warp * 16 * T, pt);
    xl_put<NH>(part + (nw + warp) * 16 * T, dst);
    __syncthreads();
    xl_reduce(part, 16 * T, nw, 2);
    __syncthreads();
    xl_get<NH>(pt, part);
    xl_get<NH>(dst, part + nw * 16 * T);
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = n * 8 + 2 * c + e;
        const float m = sm[qi], iv = sm[T + qi], dd = sm[2 * T + qi];
        tc_p_ds(pt[n][e], dst[n][e], b0, m, iv, dd, scale_log2);
        tc_p_ds(pt[n][2 + e], dst[n][2 + e], b1, m, iv, dd, scale_log2);
      }
    }
    tc_dkv<8>(av, ak, pt, dst, sdo, sq, st, 0, x.col0, x.ntg);
    if (stages == 1) {
      __syncthreads();
      next(qt + 1);
    }
  }
  E* g = dqkv + x.blk.u * L * 3 * D + (size_t)x.blk.h * hd;
  tc_store<8>(g + D, 3 * (size_t)D, ak, k0, L, x.col0, x.ntg, hd, scale, scale);
  tc_store<8>(g + 2 * D, 3 * (size_t)D, av, k0, L, x.col0, x.ntg, hd, 1.f, 1.f);
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

// The narrow bf16 backward's launch (mhsa_bwd_bf16_kernel): groups of S
// whole sequences (HG = H) or of HG heads of one sequence (S = 1), W warps a
// block, a persistent grid of `grid` blocks, `stage` bytes a stage of its
// two-stage ring (bwd_stage_bytes).
struct BwdPlan {
  int S, HG, W, grid;
  size_t stage;
};
constexpr int kBwdMaxSeqs = 4;        // sequences of a whole-sequence group
constexpr int kBwdMaxHeads = 8;       // heads of a head group
constexpr size_t kSmemPerSm = 233472;  // shared memory an SM, 1 KB of it reserved a block

// Blocks of W warps an SM holds at `smem` bytes of shared memory each: the
// registers allow 16 warps up to L = 32 (128 a thread) and 8 above, and
// the shared memory kSmemPerSm.
int bwd_blocks_per_sm(int KT, int W, size_t smem) {
  const int by_regs = (KT <= 2 ? 16 : 8) / W;
  const int by_smem = (int)(kSmemPerSm / (smem + 1024));
  return by_regs < by_smem ? by_regs : by_smem;
}

// The rule (ops/mhsa.py::narrow_bwd_plan states it too).  Whole sequences,
// as many to a group as fit twice in a block's share of the SM (two blocks
// an SM up to L = 16, one above) up to kBwdMaxSeqs, bwd_block_warps(KT)
// warps a block, when the groups give every block of a full grid
// (occupancy x SMs) one at least.  Otherwise groups of HG = ceil(H / n)
// heads of one sequence, a warp each, for n from ceil(H / 8) up: the
// largest HG whose use of the grid's slots (groups over waves x blocks of a
// full grid) is within 10% of the best split's.  On the H100 (132 SMs) at
// D = 300, 15 heads: whole sequences at L = 16 from U = 264 (the train
// step's (1792, 16) and up) and at L = 30 from U = 132, heads 8 + 7 at
// (64, 50) and (256, 50), 5 at (32, 50).
BwdPlan bwd_plan(int U, int L, int D, int H, int sms) {
  const int KT = (L + 15) / 16, W = bwd_block_warps(KT);
  const size_t budget = KT == 1 ? (size_t)kSmemTarget : (size_t)kSmemLimit;
  for (int S = kBwdMaxSeqs; S >= 1; --S) {
    const size_t stage = bwd_stage_bytes(S, H, L, D, H);
    if (2 * stage > budget) continue;
    const int grid = sms * bwd_blocks_per_sm(KT, W, 2 * stage);
    if ((U + S - 1) / S >= grid) return BwdPlan{S, H, W, grid, stage};
  }
  BwdPlan cand[kBwdMaxHeads];
  double use[kBwdMaxHeads], best = 0.;
  int nc = 0;
  for (int n = (H + kBwdMaxHeads - 1) / kBwdMaxHeads, last = 0; n <= H; ++n) {
    const int HG = (H + n - 1) / n;
    if (HG == last) continue;
    last = HG;
    const size_t stage = bwd_stage_bytes(1, HG, L, D, H);
    const long slots = (long)sms * bwd_blocks_per_sm(KT, HG, 2 * stage);
    if (slots == 0) continue;  // its two stages do not fit an SM
    const long groups = (long)U * ((H + HG - 1) / HG);
    const long waves = (groups + slots - 1) / slots;
    cand[nc] = BwdPlan{1, HG, HG, (int)(groups < slots ? groups : slots), stage};
    use[nc] = (double)groups / (double)(waves * slots);
    best = use[nc] > best ? use[nc] : best;
    ++nc;
  }
  int i = 0;
  while (use[i] < 0.9 * best) ++i;
  return cand[i];
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

// Launch `kernel` with all of a block's shared memory opted in (once per
// device, `done` the kernel's own record); the launch's error.
template <typename K, typename... A>
cudaError_t launch_opted(K kernel, bool (&done)[kMaxDevices], int dev, size_t grid, int threads,
                         size_t smem, cudaStream_t stream, A... args) {
  cudaError_t err = allow_smem(kernel, dev, done);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The long instances, either type.  Tensor-core: U H ceil(L / R) blocks of
// 2 R threads, times the column groups (not for the statistics kernel), the
// shared memory of tc_smem; XL: U H ceil(L / 16) blocks of xl_warps(hd)
// warps, the shared memory of xl_smem with xl_stages stages.  The
// backward's three launches share the workspace of per-row statistics.
template <typename E, int NTC, int R>
cudaError_t launch_long_tc(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                           int H, int dev, cudaStream_t stream) {
  static bool set[kMaxDevices] = {false};
  const int hd = D / H;
  const size_t grid = (size_t)U * H * ((L + R - 1) / R) * tc_groups(hd);
  return launch_opted(mhsa_long_kernel<E, NTC, R>, set, dev, grid, 2 * R,
                      tc_smem(hd, sizeof(E), 0), stream, static_cast<const E*>(qkv), mask,
                      static_cast<E*>(out), L, D, H, 1.4426950408889634f / sqrtf((float)hd));
}

template <typename E, int NTC, int R>
cudaError_t launch_bwd_long_tc(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                               void* workspace, int U, int L, int D, int H, int dev,
                               cudaStream_t stream) {
  static bool set[3][kMaxDevices] = {};
  const int hd = D / H, es = sizeof(E);
  const size_t tiles = (size_t)U * H * ((L + R - 1) / R), grid = tiles * tc_groups(hd);
  const float scale = 1.f / sqrtf((float)hd), scale_log2 = 1.4426950408889634f * scale;
  const E* q = static_cast<const E*>(qkv);
  const E* g = static_cast<const E*>(dout);
  E* dq = static_cast<E*>(dqkv);
  float* st = static_cast<float*>(workspace);
  cudaError_t err = launch_opted(mhsa_long_stats_kernel<E, R>, set[0], dev, tiles, 2 * R,
                                 tc_smem(hd, es, 1), stream, q, mask, g, st, L, D, H,
                                 scale_log2);
  if (err == cudaSuccess)
    err = launch_opted(mhsa_long_dq_kernel<E, NTC, R>, set[1], dev, grid, 2 * R,
                       tc_smem(hd, es, 1), stream, q, mask, g, st, dq, L, D, H, scale_log2,
                       scale);
  if (err == cudaSuccess)
    err = launch_opted(mhsa_long_dkv_kernel<E, NTC, R>, set[2], dev, grid, 2 * R,
                       tc_smem(hd, es, 2), stream, q, mask, g, st, dq, L, D, H, scale_log2,
                       scale);
  return err;
}

template <typename E>
cudaError_t launch_long_xl(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                           int H, int dev, cudaStream_t stream) {
  static bool set[kMaxDevices] = {false};
  const int hd = D / H, es = sizeof(E), stages = xl_stages(hd, es, 0);
  const size_t grid = (size_t)U * H * ((L + 15) / 16);
  return launch_opted(mhsa_long_xl_kernel<E>, set, dev, grid, 32 * xl_warps(hd),
                      xl_smem(hd, es, 0, stages), stream, static_cast<const E*>(qkv), mask,
                      static_cast<E*>(out), L, D, H, stages,
                      1.4426950408889634f / sqrtf((float)hd));
}

template <typename E>
cudaError_t launch_bwd_long_xl(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                               void* workspace, int U, int L, int D, int H, int dev,
                               cudaStream_t stream) {
  static bool set[3][kMaxDevices] = {};
  const int hd = D / H, es = sizeof(E), threads = 32 * xl_warps(hd);
  const int s1 = xl_stages(hd, es, 1), s2 = xl_stages(hd, es, 2);
  const size_t grid = (size_t)U * H * ((L + 15) / 16);
  const float scale = 1.f / sqrtf((float)hd), scale_log2 = 1.4426950408889634f * scale;
  const E* q = static_cast<const E*>(qkv);
  const E* g = static_cast<const E*>(dout);
  E* dq = static_cast<E*>(dqkv);
  float* st = static_cast<float*>(workspace);
  cudaError_t err = launch_opted(mhsa_long_xl_stats_kernel<E>, set[0], dev, grid, threads,
                                 xl_smem(hd, es, 1, s1), stream, q, mask, g, st, L, D, H, s1,
                                 scale_log2);
  if (err == cudaSuccess)
    err = launch_opted(mhsa_long_xl_dq_kernel<E>, set[1], dev, grid, threads,
                       xl_smem(hd, es, 1, s1), stream, q, mask, g, st, dq, L, D, H, s1,
                       scale_log2, scale);
  if (err == cudaSuccess)
    err = launch_opted(mhsa_long_xl_dkv_kernel<E>, set[2], dev, grid, threads,
                       xl_smem(hd, es, 2, s2), stream, q, mask, g, st, dq, L, D, H, s2,
                       scale_log2, scale);
  return err;
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

// The narrow bf16 backward's launch at KT = ceil(L / 16), by head dim; part
// 1 dispatches by KT (launch_bwd_bf16).  Its instances, the longest to
// build, compile in part 5 (KT 1, 2) and part 6 (KT 3, 4).
template <int KT>
cudaError_t launch_bwd_bf16_kt(const void* qkv, const uint8_t* mask, const void* dout,
                               void* dqkv, int U, int L, int D, int H, int dev,
                               cudaStream_t stream);

#if NRL_PART == 0 || NRL_PART >= 5
// The backward's launches follow bwd_plan: a persistent grid walking whole
// sequences or head groups, both staged with their dO.
template <int KT, int NT, int HDX, bool PAIR>
cudaError_t launch_bwd_bf16_inst(const void* qkv, const uint8_t* mask, const void* dout,
                                 void* dqkv, int U, int L, int D, int H, int dev,
                                 cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {false};
  auto kernel = mhsa_bwd_bf16_kernel<KT, NT, HDX, PAIR>;
  cudaError_t err = allow_smem(kernel, dev, smem_set);
  if (err != cudaSuccess) return err;
  const BwdPlan p = bwd_plan(U, L, D, H, num_sms(dev));
  const float scale = 1.f / sqrtf((float)(D / H));
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)(D / H));
  kernel<<<p.grid, p.W * 32, 2 * p.stage, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), U, L, D, H, p.S, p.HG, (int)p.stage, scale_log2, scale);
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
#endif
#if NRL_BUILDS(5)
template cudaError_t launch_bwd_bf16_kt<1>(const void*, const uint8_t*, const void*, void*, int,
                                           int, int, int, int, cudaStream_t);
template cudaError_t launch_bwd_bf16_kt<2>(const void*, const uint8_t*, const void*, void*, int,
                                           int, int, int, int, cudaStream_t);
#endif
#if NRL_BUILDS(6)
template cudaError_t launch_bwd_bf16_kt<3>(const void*, const uint8_t*, const void*, void*, int,
                                           int, int, int, int, cudaStream_t);
template cudaError_t launch_bwd_bf16_kt<4>(const void*, const uint8_t*, const void*, void*, int,
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
// Tensor-core instances by head dim: NTC = 4 n8 tiles a column group up
// to head dim 32, 8 above (tc_ntc); the XL instances above long_tc's bound.
#define NRL_LONG(TC, XL)                                               \
  const int hd = D / H;                                                \
  if (!long_tc(hd, sizeof(T))) return XL;                              \
  return hd <= 32 ? TC(4, kTcRows) : TC(8, kTcRows);

template <typename T>
cudaError_t launch_long(const void* qkv, const uint8_t* mask, void* out, int U, int L, int D,
                        int H, int dev, cudaStream_t stream) {
#define NRL_TC(NTC, R) launch_long_tc<T, NTC, R>(qkv, mask, out, U, L, D, H, dev, stream)
  NRL_LONG(NRL_TC, (launch_long_xl<T>(qkv, mask, out, U, L, D, H, dev, stream)))
#undef NRL_TC
}

template <typename T>
cudaError_t launch_bwd_long(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            void* workspace, int U, int L, int D, int H, int dev,
                            cudaStream_t stream) {
#define NRL_TC(NTC, R) \
  launch_bwd_long_tc<T, NTC, R>(qkv, mask, dout, dqkv, workspace, U, L, D, H, dev, stream)
  NRL_LONG(NRL_TC,
           (launch_bwd_long_xl<T>(qkv, mask, dout, dqkv, workspace, U, L, D, H, dev, stream)))
#undef NRL_TC
}
#undef NRL_LONG

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

cudaError_t launch_bwd_bf16(const void* qkv, const uint8_t* mask, const void* dout, void* dqkv,
                            int U, int L, int D, int H, int dev, cudaStream_t stream) {
  if (wide_instance(L, D, H, 2))
    return nrl_mhsa::launch_bwd_wide<__nv_bfloat16>(qkv, mask, dout, dqkv, U, L, D, H, dev,
                                                     stream);
  switch ((L + 15) / 16) {
    case 1: return nrl_mhsa::launch_bwd_bf16_kt<1>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 2: return nrl_mhsa::launch_bwd_bf16_kt<2>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    case 3: return nrl_mhsa::launch_bwd_bf16_kt<3>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
    default: return nrl_mhsa::launch_bwd_bf16_kt<4>(qkv, mask, dout, dqkv, U, L, D, H, dev, stream);
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
// Long (long_instance): the dK / dV kernel's tiles (tc_smem) or the largest
// XL kernel's (xl_instance_smem); wide
// (wide_instance): one head's q, k, v and dO columns in the input type
// and the row statistics (wide_smem); f32 up to hd = 32: one head's q, k, v
// and dO columns; bf16 up to hd = 32: the forward's whole (L, 3D) slab of
// one sequence (smem_bytes; the backward's plan picks groups that fit, down
// to one head of one sequence).
size_t instance_smem(int L, int D, int H, int es) {
  const int hd = D / H;
  if (long_instance(L, D, H)) return long_tc(hd, es) ? tc_smem(hd, es, 2) : xl_instance_smem(hd, es);
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
  const int hd = D / H, es = dtype == 0 ? 4 : 2, tc = long_tc(hd, es);
  const int R = tc ? kTcRows : 16;
  const size_t blocks = (size_t)U * H * ((L + R - 1) / R) * (tc ? tc_groups(hd) : 1);
  if (long_instance(L, D, H) && blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
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
