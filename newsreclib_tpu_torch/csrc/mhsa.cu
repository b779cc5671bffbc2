// Masked multi-head self-attention over many short independent sequences,
// forward only: the attention of the NRMS title encoder (L = 16 / 30) and of
// its user encoder (L = 50), at D = 300, H = 15, hd = 20.
//
// Replaces the TPU kernel newsreclib_tpu/ops/mhsa.py::fused_small_mhsa (body
// _attention_kernel, pallas_call at ops/mhsa.py:198) and computes what
// ops/mhsa.py::mhsa_reference computes: for each sequence u and head h,
// softmax over the valid keys of q.k^T / sqrt(hd), applied to v.  Masked keys
// take the finite logit -1e30 (never -inf), so a fully masked sequence (the
// padding article, row 0) gets a uniform softmax and a finite output.  Rows at
// masked query positions are computed like any other; the caller zeroes them.
// None of the Mosaic workarounds of the TPU kernel are carried over (head
// indicator matmuls, bias feature column, transposed k/v, 128-lane padding).
//
// Design: one block per sequence.  The block stages that sequence's k and v
// (L x D each, converted to f32) in shared memory with coalesced loads; each
// thread then owns one (query row, head) pair, keeps its q (hd values) and
// its output accumulator in registers, and runs an online softmax over the L
// keys.  Sums are in f32 whatever the input type; the output is written in
// the input type.
//
// What bounds it on the H100: memory.  At U = 4096, L = 16 in bf16 it must
// read qkv (U*L*3D*2 = 118 MB) and write the context (U*L*D*2 = 39 MB), about
// 157 MB or 47 us at 3.35 TB/s, against about 1.3 GFLOP of logits and
// weighted sums (1.3 us at the bf16 tensor rate).  The design reads every
// input byte once and writes every output byte once; q and the output are
// read and written as hd-wide runs per thread, which wastes some of each
// sector.  Left for later: staging the output through shared memory for
// fully coalesced stores, several sequences per block for short L,
// wgmma / mma.sync for the two small products, and TMA loads.
//
// C entry point (bound with ctypes):
//   int nrl_mhsa_fwd(const void* qkv, const uint8_t* mask, void* out,
//                    int U, int L, int D, int H, int dtype, void* stream)
// qkv (U, L, 3D) and out (U, L, D) are contiguous, dtype 0 = float32,
// 1 = bfloat16; mask (U, L) is one byte per position, nonzero = valid key.
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskMin = -1e30f;
constexpr int kMaxHeadDim = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// HD is the register capacity for one head's q and accumulator; EXACT says
// that the head dimension equals it, so that the loops need no guard.
template <typename T, int HD, bool EXACT>
__global__ void mhsa_fwd_kernel(const T* __restrict__ qkv,
                                const uint8_t* __restrict__ mask,
                                T* __restrict__ out, int L, int D, int H,
                                float scale) {
  const int hd = EXACT ? HD : D / H;
  extern __shared__ float smem[];
  float* sk = smem;               // (L, D)
  float* sv = sk + L * D;         // (L, D)
  float* svalid = sv + L * D;     // (L,) 1 = valid key

  const int u = blockIdx.x;
  const T* src = qkv + (size_t)u * L * 3 * D;
  const uint8_t* msk = mask + (size_t)u * L;

  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int row = i / D;
    const int col = i - row * D;
    const T* r = src + (size_t)row * 3 * D;
    sk[i] = to_f32(r[D + col]);
    sv[i] = to_f32(r[2 * D + col]);
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) svalid[i] = msk[i] ? 1.f : 0.f;
  __syncthreads();

  T* dst = out + (size_t)u * L * D;
  for (int t = threadIdx.x; t < L * H; t += blockDim.x) {
    const int l = t / H;
    const int h = t - l * H;
    const int off = h * hd;

    float q[HD];
    const T* qrow = src + (size_t)l * 3 * D + off;
#pragma unroll
    for (int j = 0; j < HD; ++j) q[j] = j < hd ? to_f32(qrow[j]) : 0.f;

    float acc[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) acc[j] = 0.f;
    float m_run = kMaskMin;
    float l_run = 0.f;

    for (int m = 0; m < L; ++m) {
      const float* kr = sk + m * D + off;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j)
        if (j < hd) s = fmaf(q[j], kr[j], s);
      s = svalid[m] != 0.f ? s * scale : kMaskMin;
      const float m_new = fmaxf(m_run, s);
      const float alpha = expf(m_run - m_new);
      const float p = expf(s - m_new);
      l_run = l_run * alpha + p;
      const float* vr = sv + m * D + off;
#pragma unroll
      for (int j = 0; j < HD; ++j)
        if (j < hd) acc[j] = fmaf(acc[j], alpha, p * vr[j]);
      m_run = m_new;
    }

    const float inv = 1.f / l_run;  // l_run >= 1: the running max term is exp(0)
    T* orow = dst + (size_t)l * D + off;
#pragma unroll
    for (int j = 0; j < HD; ++j)
      if (j < hd) orow[j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int HD, bool EXACT>
cudaError_t launch_hd(const void* qkv, const uint8_t* mask, void* out, int U,
                      int L, int D, int H, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * L * D + L) * sizeof(float);
  auto kernel = mhsa_fwd_kernel<T, HD, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((L * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const float scale = 1.f / sqrtf((float)(D / H));
  kernel<<<U, threads, smem, stream>>>(static_cast<const T*>(qkv), mask,
                                       static_cast<T*>(out), L, D, H, scale);
  return cudaGetLastError();
}

// The head dimension sets the register arrays' size at compile time: the
// main path's hd = 20 has its own exact instance, any other hd <= 32 runs in
// the next capacity up with guarded loops.
template <typename T>
cudaError_t launch(const void* qkv, const uint8_t* mask, void* out, int U,
                   int L, int D, int H, cudaStream_t stream) {
  const int hd = D / H;
  if (hd == 20) return launch_hd<T, 20, true>(qkv, mask, out, U, L, D, H, stream);
  if (hd <= 8) return launch_hd<T, 8, false>(qkv, mask, out, U, L, D, H, stream);
  if (hd <= 16) return launch_hd<T, 16, false>(qkv, mask, out, U, L, D, H, stream);
  return launch_hd<T, 32, false>(qkv, mask, out, U, L, D, H, stream);
}

}  // namespace

extern "C" int nrl_mhsa_fwd(const void* qkv, const uint8_t* mask, void* out,
                            int U, int L, int D, int H, int dtype,
                            void* stream) {
  if (U <= 0 || L <= 0 || H <= 0 || D % H != 0 || D / H > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(qkv, mask, out, U, L, D, H, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(qkv, mask, out, U, L, D, H, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
