// Fused LayerNorm + channel MLP of a mixer block, for sm_90a.
//
//   out = x + QuickGELU(LN(x) . W_in^T + b_in) . W_out^T + b_out
//
// Replaces clip_mixer_tpu/ops/pallas/mlp_kernel.py::fused_ln_mlp (body
// _kernel at :35-58). Weights arrive in nn.Linear's (out, in) layout:
// w_in [H, W], w_out [W, H]; x and out are [R, W] row-major.
//
// What bounds it on an H100: at the serving shapes (R = B*T = 6400, W = 768,
// H = 3072) the two products are 4*R*W*H = 60 GFLOP against ~30 MB of
// unique bytes, so it is bound by tensor-core operations (~61 us at the
// 989 TFLOP/s bf16 peak). The unfused chain would also write and re-read the
// [R, H] hidden activation (R*H*2*2 = 79 MB): this kernel never stores it.
//
// Design (bf16): one CTA of 8 warps owns BM rows and the whole output width:
// BM = 64 when 32-row blocks would not fit in one wave on the card and
// W <= 768 (64 rows of f32 accumulators fit in registers), else BM = 32.
// The device code is channel_mix.cuh's, shared with mixer_block.cu.
// LN runs once in f32 (rows read 16 bytes a lane) and lands in shared
// memory as bf16. The hidden dim is
// walked in chunks of HC1 = 64 *inside* the CTA (the TPU grid's sequential
// "arbitrary" axis has no counterpart: CTAs run in no order). Per chunk:
// h = y . W_in[chunk]^T on wmma bf16 m16n16k16 tensor-core tiles with f32
// accumulation, + b_in, QuickGELU, rounded once to bf16 in shared memory;
// then acc += h . W_out[:, chunk]^T into f32
// accumulators held in registers (each warp owns W / 8 output columns of all
// BM rows: 192 registers a thread at W = 768). Epilogue: x + acc + b_out in
// f32, cast once. Rows past R are masked at the store, so R is arbitrary.
// Rounding points follow the TPU kernel: y and h in bf16, f32 accumulation,
// f32 epilogue, LN affine from bf16-cast parameters (the caller casts).
// The weights stream from L2 through a ring of shared tiles filled by
// cp.async, S - 1 tiles ahead of the MMAs. Each CTA reads every weight once,
// so L2 traffic is all weights per BM rows (64 operations per byte at
// BM = 64): at 32 rows the weight stream alone took as long as the MMAs.
// Now the MMAs (wmma from shared memory, 8 warps an SM) are the larger
// cost; wgmma, TMA multicast across a cluster, and splitting the hidden dim
// across CTAs at small R are the next steps for speed.
//
// Design (f32): 32 rows a block and 128-wide hidden chunks on CUDA cores
// (there is no full-precision f32 tensor-core path), for the f32
// configurations; no serving path runs it at speed.

#include "channel_mix.cuh"

namespace {

// 32 or 64 rows a block (bf16), 32 (f32); the channel mix itself is
// channel_mix.cuh's, shared with mixer_block.cu.
template <int NF, int BM_>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                   const bf16* __restrict__ w_in, const bf16* __restrict__ b_in,
                   const bf16* __restrict__ w_out, const bf16* __restrict__ b_out,
                   bf16* __restrict__ out, int R, int H) {
  constexpr int W = Bf16Shape<NF, BM_ / 16>::W;
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * BM_;
  channel_mix_bf16<NF, BM_ / 16>(x + (size_t)row0 * W, W, out + (size_t)row0 * W, W, min(BM_, R - row0),
                                 ln_w, ln_b, w_in, b_in, w_out, b_out, H, smem);
}

template <int MC>
__global__ void __launch_bounds__(THREADS)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const float* __restrict__ w_in, const float* __restrict__ b_in,
                  const float* __restrict__ w_out, const float* __restrict__ b_out,
                  float* __restrict__ out, int R, int W, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * F32_BM;
  channel_mix_f32<MC>(x + (size_t)row0 * W, W, out + (size_t)row0 * W, W, min(F32_BM, R - row0),
                      ln_w, ln_b, w_in, b_in, w_out, b_out, W, H, smem);
}

template <int NF, int BM_>
cudaError_t launch_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w_in, const void* b_in,
                        const void* w_out, const void* b_out, void* out, int R, int H, cudaStream_t stream) {
  using S_ = Bf16Shape<NF, BM_ / 16>;
  // Opt into the shared memory once per instance (the port drives one device).
  static const cudaError_t opted = cudaFuncSetAttribute(
      ln_mlp_bf16_kernel<NF, BM_>, cudaFuncAttributeMaxDynamicSharedMemorySize, S_::SMEM);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((R + BM_ - 1) / BM_);
  ln_mlp_bf16_kernel<NF, BM_><<<grid, THREADS, S_::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)ln_w, (const bf16*)ln_b, (const bf16*)w_in, (const bf16*)b_in,
      (const bf16*)w_out, (const bf16*)b_out, (bf16*)out, R, H);
  return cudaGetLastError();
}

// The card's SM count, looked up on the first launch (the port drives one
// device); the lookup's error is kept and returned by every launch.
struct SmCount {
  int sms = 0;
  cudaError_t error;
  SmCount() {
    int device = 0;
    error = cudaGetDevice(&device);
    if (error == cudaSuccess) error = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
};

// 64-row blocks where 32-row blocks would not fit in one wave on the card.
template <int NF>
cudaError_t launch_bf16_rows(const void* x, const void* ln_w, const void* ln_b, const void* w_in,
                             const void* b_in, const void* w_out, const void* b_out, void* out, int R, int H,
                             cudaStream_t stream) {
  static const SmCount card;
  if (card.error != cudaSuccess) return card.error;
  if (NF <= 6 && (R + 31) / 32 > card.sms)
    return launch_bf16<NF, NF <= 6 ? 64 : 32>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, stream);
  return launch_bf16<NF, 32>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, stream);
}

template <int MC>
cudaError_t launch_f32(const void* x, const void* ln_w, const void* ln_b, const void* w_in, const void* b_in,
                       const void* w_out, const void* b_out, void* out, int R, int W, int H, cudaStream_t stream) {
  const int smem = f32_smem(W);
  cudaError_t e = cudaFuncSetAttribute(ln_mlp_f32_kernel<MC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((R + F32_BM - 1) / F32_BM);
  ln_mlp_f32_kernel<MC><<<grid, THREADS, smem, stream>>>(
      (const float*)x, (const float*)ln_w, (const float*)ln_b, (const float*)w_in, (const float*)b_in,
      (const float*)w_out, (const float*)b_out, (float*)out, R, W, H);
  return cudaGetLastError();
}

}  // namespace

// C interface. Shapes: x/out [R, W]; w_in [H, W]; w_out [W, H]; vectors
// ln_w, ln_b, b_out [W], b_in [H]. The caller checks W % 128 == 0 (bf16),
// W <= 1024, H % 128 == 0, R > 0 and 32-byte-aligned pointers (16-byte
// cp.async copies need the weights' rows 16-byte aligned: W % 8 == 0).
extern "C" int ln_mlp_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w_in, const void* b_in,
                           const void* w_out, const void* b_out, void* out, int R, int W, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (W / (16 * WARPS)) {
    case 1: return launch_bf16_rows<1>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    case 2: return launch_bf16_rows<2>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    case 3: return launch_bf16_rows<3>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    case 4: return launch_bf16_rows<4>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    case 5: return launch_bf16_rows<5>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    case 6: return launch_bf16_rows<6>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    case 7: return launch_bf16_rows<7>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    case 8: return launch_bf16_rows<8>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ln_mlp_f32(const void* x, const void* ln_w, const void* ln_b, const void* w_in, const void* b_in,
                          const void* w_out, const void* b_out, void* out, int R, int W, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch ((W + THREADS - 1) / THREADS) {
    case 1: return launch_f32<1>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, W, H, s);
    case 2: return launch_f32<2>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, W, H, s);
    case 3: return launch_f32<3>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, W, H, s);
    case 4: return launch_f32<4>(x, ln_w, ln_b, w_in, b_in, w_out, b_out, out, R, W, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
