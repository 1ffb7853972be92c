// LayerNorm + channel MLP of a mixer block, for sm_90a.
//
//   out = x + QuickGELU(LN(x) . W_in^T + b_in) . W_out^T + b_out
//
// Replaces clip_mixer_tpu/ops/pallas/mlp_kernel.py::fused_ln_mlp (body
// _kernel at :35-58). Weights arrive in nn.Linear's (out, in) layout:
// w_in [H, W], w_out [W, H]; x and out are [R, W] row-major.
//
// What bounds it on an H100: at the serving shapes (R = B*T = 6400, W = 768,
// H = 3072) the two products are 4*R*W*H = 60 GFLOP against ~30 MB of
// unique bytes, so tensor-core operations bound it (~61 us at the 989
// TFLOP/s bf16 peak).
//
// Design (bf16): three launches on the caller's stream.
// (a) ln_rows_kernel: LN in f32, one warp a row (channel_mix.cuh's
//     ln_rows_bf16, 16 bytes a lane a load), y [R, W] rounded to bf16 into
//     a scratch the caller allocates.
// (b) GEMM 1, gemm_sm90.cuh: h = bf16(QuickGELU(y . W_in^T + b_in)) into a
//     second scratch h [R, H], the epilogue in f32 on the accumulators.
// (c) GEMM 2: out = bf16(x + h . W_out^T + b_out), added in f32.
// The epilogues are channel_mix.cuh's GeluEpilogue and ResidualEpilogue,
// which mixer_block.cu's channel half runs too.
// The TPU kernel kept h on chip, walking the hidden dim as a sequential grid
// axis into an f32 accumulator of the whole width. On this card that design
// (a whole-width wmma channel mix) held [64, W] f32 accumulators a block
// in registers (192 a thread at W = 768): its row tile could not grow, no
// warpgroup MMA fit beside them, and every block re-streamed all of W_in
// and W_out from L2 (0.94 GB a call at R = 6400). Its
// MMAs alone ran at ~110 TFLOP/s. Unfused, each product is an ordinary GEMM
// with 128-row tiles on wgmma and TMA. The price is h's round trip through
// device memory: R*H*2 bytes written and read back, 39 MB at R = 6400
// (~24 us at 3.35 TB/s if none of it stayed in the 50 MB L2). The rounding
// points are the TPU kernel's: y and h in bf16, f32 sums, f32 epilogues, the
// LN affine from bf16-cast parameters (the caller casts).
//
// Design (f32): 32 rows a block and 128-wide hidden chunks on CUDA cores
// (there is no full-precision f32 tensor-core path), channel_mix.cuh's
// channel_mix_f32, for the f32 configurations; no serving path runs it at
// speed.

#include "channel_mix.cuh"
#include "gemm_sm90.cuh"

namespace {

// One warp a row, WARPS rows a block.
template <int W>
__global__ void __launch_bounds__(THREADS)
ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
               bf16* __restrict__ y, int R) {
  const int row0 = blockIdx.x * WARPS;
  const int rows = min(WARPS, R - row0);
  ln_rows_bf16<W>(x + (size_t)row0 * W, W, rows, rows, ln_w, ln_b, y + (size_t)row0 * W, W);
}

template <int W>
cudaError_t launch_ln_rows(const void* x, const void* ln_w, const void* ln_b, void* y, int R, cudaStream_t stream) {
  ln_rows_kernel<W><<<(R + WARPS - 1) / WARPS, THREADS, 0, stream>>>((const bf16*)x, (const bf16*)ln_w,
                                                                      (const bf16*)ln_b, (bf16*)y, R);
  return cudaGetLastError();
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

template <int MC>
cudaError_t launch_f32(const void* x, const void* ln_w, const void* ln_b, const void* w_in, const void* b_in,
                       const void* w_out, const void* b_out, void* out, int R, int W, int H, cudaStream_t stream) {
  const int smem = f32_smem(W);
  static port::SmemOptIn opt_in;
  const cudaError_t e = opt_in.ensure((const void*)ln_mlp_f32_kernel<MC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((R + F32_BM - 1) / F32_BM);
  ln_mlp_f32_kernel<MC><<<grid, THREADS, smem, stream>>>(
      (const float*)x, (const float*)ln_w, (const float*)ln_b, (const float*)w_in, (const float*)b_in,
      (const float*)w_out, (const float*)b_out, (float*)out, R, W, H);
  return cudaGetLastError();
}

}  // namespace

// C interface, bf16 stages. Shapes: x, y, out [R, W]; h [R, H]; w_in [H, W];
// w_out [W, H]; ln_w, ln_b, b_out [W]; b_in [H]. The caller checks
// W % 128 == 0, W <= 1024, H % 128 == 0, R > 0 and 32-byte-aligned pointers.
// Each entry returns cudaGetLastError() after its last launch.
extern "C" int ln_mlp_ln_rows(const void* x, const void* ln_w, const void* ln_b, void* y, int R, int W,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (W / 128) {
    case 1: return launch_ln_rows<128>(x, ln_w, ln_b, y, R, s);
    case 2: return launch_ln_rows<256>(x, ln_w, ln_b, y, R, s);
    case 3: return launch_ln_rows<384>(x, ln_w, ln_b, y, R, s);
    case 4: return launch_ln_rows<512>(x, ln_w, ln_b, y, R, s);
    case 5: return launch_ln_rows<640>(x, ln_w, ln_b, y, R, s);
    case 6: return launch_ln_rows<768>(x, ln_w, ln_b, y, R, s);
    case 7: return launch_ln_rows<896>(x, ln_w, ln_b, y, R, s);
    case 8: return launch_ln_rows<1024>(x, ln_w, ln_b, y, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ln_mlp_linear_gelu(const void* y, const void* w_in, const void* b_in, void* h, int R, int H, int W,
                                  void* stream) {
  const GeluEpilogue epi{(const bf16*)b_in, (bf16*)h, H};
  return sm90::gemm((const bf16*)y, (const bf16*)w_in, R, H, W, epi, (cudaStream_t)stream);
}

extern "C" int ln_mlp_linear_residual(const void* h, const void* w_out, const void* b_out, const void* x, void* out,
                                      int R, int W, int H, void* stream) {
  const ResidualEpilogue epi{(const bf16*)b_out, (const bf16*)x, (bf16*)out, W};
  return sm90::gemm((const bf16*)h, (const bf16*)w_out, R, W, H, epi, (cudaStream_t)stream);
}

// The three stages in turn; y and h are the caller's scratch.
extern "C" int ln_mlp_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w_in, const void* b_in,
                           const void* w_out, const void* b_out, void* out, void* y, void* h, int R, int W, int H,
                           void* stream) {
  int e = ln_mlp_ln_rows(x, ln_w, ln_b, y, R, W, stream);
  if (e == 0) e = ln_mlp_linear_gelu(y, w_in, b_in, h, R, H, W, stream);
  if (e == 0) e = ln_mlp_linear_residual(h, w_out, b_out, x, out, R, W, H, stream);
  return e;
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
