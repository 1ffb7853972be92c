// A whole mixer block in one launch, for sm_90a:
//
//   z   = x + W2 . QuickGELU(W1 . LN_tok(x) + b1) + b2     (over the token axis)
//   out = z + QuickGELU(LN_ch(z) . W3^T + b3) . W4^T + b4  (over the width)
//
// Replaces clip_mixer_tpu/ops/pallas/block_kernel.py::fused_mixer_block_tbd
// (body _kernel at :71-124). x and out are [T, B, D] with D contiguous, at
// any token stride ts and sample stride ss (elements): the tower passes its
// [B, T, D] activations and nothing is transposed. Weights arrive in
// nn.Linear's (out, in) layout: W1 [U, T], W2 [T, U], W3 [H, D], W4 [D, H].
//
// What bounds it on an H100: at a bucket of 128 samples the products are
// 2*B*D*2*T*U + 2*B*T*2*D*H operations (64.3 GFLOP on the vision tower,
// T=50 U=200 D=768 H=3072; 47.6 GFLOP on the text tower, T=77 U=308 D=512
// H=2048) against about 29 MB of unique bytes (vision): bound by
// tensor-core operations, 65 us and 48 us at the 989 TFLOP/s bf16 peak.
// The channel mix is 94% (vision) of the operations.
//
// Design (bf16): one CTA of 8 warps per sample. It owns the sample's T rows
// and the whole width, so both halves need no step across CTAs (the TPU
// kernel's sequential grid axis becomes loops inside the CTA). The token
// MLP is independent for each column d; only LN_tok couples the columns,
// through per-row statistics. So the CTA takes the T rows' statistics
// first, then walks D in chunks of DC = 64 columns: y = LN_tok(x)[:, chunk]
// in bf16 (x read 16 bytes a thread), h = W1 . y on wmma bf16 tiles with
// f32 accumulation, + b1,
// QuickGELU, rounded to bf16; then W2 . h + b2 + x in f32, rounded once,
// is z[:, chunk]. T and U (50/200, 77/308) are not multiples of 16: the
// token weights sit in shared memory zero-padded to T_pad = 16 ceil(T/16)
// and U_pad, so padded hidden rows are gelu(0) = 0 against zero columns of
// W2 and add nothing; padded token rows are masked at the store.
// Shared memory is the wall: at the text shapes the padded token weights
// (2 x 51 KB), a [T_pad, D] z (82 KB) and the channel mix's weight ring
// cannot all stay. So z goes to this sample's own rows of `out` in device
// memory (it stays in L2; no other CTA touches them), and the channel mix
// then runs on those rows in place with channel_mix.cuh's code, the same
// as ln_mlp.cu's: LN_ch(z) into shared memory, the hidden dim in chunks of
// 64 through a cp.async ring of weight tiles, the [16 RT, D] f32
// accumulators in registers (RT = 4 row tiles at D = 768, 5 at D = 512, a
// compile-time count: runtime guards cost registers and spilled), z read
// back in the epilogue. The token half
// and the channel half use the same shared memory one after the other.
// At a bucket of 8 samples the grid is 8 CTAs on 132 SMs; at 128, one wave.
//
// Design (f32): the same walk on CUDA cores (no full-precision f32
// tensor-core path), the token weights read from L2, then the channel mix
// 32 rows at a time: for the f32 tests, not for speed.

#include "channel_mix.cuh"

namespace {

constexpr int DC = 64;          // token-mix column chunk
constexpr int LDC = DC + 8;     // row of y_c and h_c (bf16)
constexpr int MAX_TOKENS = 80;  // T_pad / 16 <= 5 row tiles
constexpr int MAX_TOKEN_HIDDEN = 320;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Byte offsets of the bf16 token half's shared memory.
struct TokenSmem {
  int TP, UP, LDT, LDU;
  size_t wi, wo, yc, hc, scratch, total;
  __host__ __device__ TokenSmem(int T, int U) {
    TP = round16(T);
    UP = round16(U);
    LDT = TP + 8;
    LDU = UP + 8;
    wi = align128(2 * TP * sizeof(float));  // after the per-row mean and 1/std
    wo = align128(wi + (size_t)UP * LDT * 2);
    yc = align128(wo + (size_t)TP * LDU * 2);
    hc = align128(yc + (size_t)TP * LDC * 2);
    scratch = align128(hc + (size_t)UP * LDC * 2);
    total = scratch + WARPS * 256 * sizeof(float);
  }
};

// The most row tiles the bf16 kernel takes at a width of NF * 128: the
// [T_pad, D] f32 accumulators of the channel mix stay in registers.
template <int NF>
constexpr int row_tiles_max() { return 24 / NF < 5 ? 24 / NF : 5; }

template <int NF, int RTM>
__global__ void __launch_bounds__(THREADS, 1)
mixer_block_bf16_kernel(const bf16* __restrict__ x, bf16* out, long long ts, long long ss, int T, int U, int H,
                        const bf16* __restrict__ lt_w, const bf16* __restrict__ lt_b,
                        const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                        const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                        const bf16* __restrict__ lc_w, const bf16* __restrict__ lc_b,
                        const bf16* __restrict__ w3, const bf16* __restrict__ b3,
                        const bf16* __restrict__ w4, const bf16* __restrict__ b4) {
  constexpr int D = NF * 16 * WARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  const TokenSmem L(T, U);
  float* mean_s = reinterpret_cast<float*>(smem);             // [T_pad]
  float* rstd_s = mean_s + L.TP;                              // [T_pad]
  bf16* wi_s = reinterpret_cast<bf16*>(smem + L.wi);          // [U_pad, LDT]: W1, zero-padded
  bf16* wo_s = reinterpret_cast<bf16*>(smem + L.wo);          // [T_pad, LDU]: W2, zero-padded
  bf16* yc_s = reinterpret_cast<bf16*>(smem + L.yc);          // [T_pad, LDC]: LN_tok(x) of the chunk
  bf16* hc_s = reinterpret_cast<bf16*>(smem + L.hc);          // [U_pad, LDC]: token hidden of the chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + warp * 256;  // 16 x 16 f32 a warp

  const bf16* xb = x + (size_t)blockIdx.x * ss;
  bf16* zb = out + (size_t)blockIdx.x * ss;
  const int rt = L.TP / 16, ut = L.UP / 16;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int i = threadIdx.x; i < L.UP * L.TP; i += THREADS) {
    const int u = i / L.TP, t = i % L.TP;
    wi_s[u * L.LDT + t] = (u < U && t < T) ? w1[u * T + t] : zero;
  }
  for (int i = threadIdx.x; i < L.TP * L.UP; i += THREADS) {
    const int t = i / L.UP, u = i % L.UP;
    wo_s[t * L.LDU + u] = (t < T && u < U) ? w2[t * U + u] : zero;
  }
  for (int t = warp; t < T; t += WARPS) {
    RowBf16<D> row;
    const float2 st = row.load_stats(xb + (size_t)t * ts, lane);
    if (lane == 0) {
      mean_s[t] = st.x;
      rstd_s[t] = st.y;
    }
  }
  __syncthreads();

  const int r = lane / 2, cc = (lane % 2) * 8;  // a lane's row and 8 columns of a 16 x 16 tile
  for (int d0 = 0; d0 < D; d0 += DC) {
    for (int i = threadIdx.x; i < L.TP * (DC / 8); i += THREADS) {  // 8 columns a thread
      const int t = i / (DC / 8), c = 8 * (i % (DC / 8)), d = d0 + c;
      float y[8] = {};
      if (t < T) {
        float xv[8], w[8], b[8];
        load8(xb + (size_t)t * ts + d, xv);
        load8(lt_w + d, w);
        load8(lt_b + d, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = (xv[e] - mean_s[t]) * rstd_s[t] * w[e] + b[e];
      }
      store8(yc_s + t * LDC + c, y);
    }
    __syncthreads();  // y_c is in; the last chunk's GEMMs are done with h_c

    // h_c = QuickGELU(W1 . y_c + b1), one 16 x 16 tile a warp at a time
    for (int tile = warp; tile < ut * (DC / 16); tile += WARPS) {
      const int mu = tile / (DC / 16), nd = tile % (DC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < rt; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, wi_s + 16 * mu * L.LDT + 16 * k, L.LDT);
        wmma::load_matrix_sync(b, yc_s + 16 * k * LDC + 16 * nd, LDC);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int u = 16 * mu + r;
      const float bias = u < U ? __bfloat162float(b1[u]) : 0.0f;
      float h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = u < U ? quick_gelu(scratch[r * 16 + cc + e] + bias) : 0.0f;
      store8(hc_s + u * LDC + 16 * nd + cc, h);
      __syncwarp();
    }
    __syncthreads();

    // z[:, chunk] = x + (W2 . h_c + b2), rounded once; padded token rows are not stored
    for (int tile = warp; tile < rt * (DC / 16); tile += WARPS) {
      const int mt = tile / (DC / 16), nd = tile % (DC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < ut; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, wo_s + 16 * mt * L.LDU + 16 * k, L.LDU);
        wmma::load_matrix_sync(b, hc_s + 16 * k * LDC + 16 * nd, LDC);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int t = 16 * mt + r;
      if (t < T) {
        const float bias = __bfloat162float(b2[t]);
        const size_t off = (size_t)t * ts + d0 + 16 * nd + cc;
        float xv[8], z[8];
        load8(xb + off, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) z[e] = xv[e] + (scratch[r * 16 + cc + e] + bias);
        store8(zb + off, z);
      }
      __syncwarp();
    }
  }
  __syncthreads();  // z is in `out` for every token; the token half's shared memory is free

  // T <= 16 RTM rows; the padded rows are zeros in LN_ch's output and are not stored
  channel_mix_bf16<NF, RTM>(zb, ts, zb, ts, T, lc_w, lc_b, w3, b3, w4, b4, H, smem);
}

// f32: MC output columns a thread in the channel mix (D <= MC * THREADS).
constexpr int F32_DC = 32;  // token-mix column chunk, one a lane

__host__ __device__ constexpr int f32_token_smem(int T, int U) { return (2 * T + F32_DC * T + F32_DC * U) * 4; }

template <int MC>
__global__ void __launch_bounds__(THREADS)
mixer_block_f32_kernel(const float* __restrict__ x, float* out, long long ts, long long ss, int T, int U, int D,
                       int H, const float* __restrict__ lt_w, const float* __restrict__ lt_b,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ lc_w, const float* __restrict__ lc_b,
                       const float* __restrict__ w3, const float* __restrict__ b3,
                       const float* __restrict__ w4, const float* __restrict__ b4) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* mean_s = reinterpret_cast<float*>(smem);  // [T]
  float* rstd_s = mean_s + T;                       // [T]
  float* yc_s = rstd_s + T;                         // [T, F32_DC]
  float* hc_s = yc_s + T * F32_DC;                  // [U, F32_DC]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xb = x + (size_t)blockIdx.x * ss;
  float* zb = out + (size_t)blockIdx.x * ss;

  for (int t = warp; t < T; t += WARPS) {
    const float2 st = row_stats_f32(xb + (size_t)t * ts, D, lane);
    if (lane == 0) {
      mean_s[t] = st.x;
      rstd_s[t] = st.y;
    }
  }
  __syncthreads();

  for (int d0 = 0; d0 < D; d0 += F32_DC) {
    const int nc = min(F32_DC, D - d0);
    for (int i = threadIdx.x; i < T * F32_DC; i += THREADS) {
      const int t = i / F32_DC, c = i % F32_DC, d = d0 + c;
      yc_s[i] = c < nc ? (xb[(size_t)t * ts + d] - mean_s[t]) * rstd_s[t] * lt_w[d] + lt_b[d] : 0.0f;
    }
    __syncthreads();  // y_c is in; the last chunk is done with h_c
    for (int u = warp; u < U; u += WARPS) {  // lane = column of the chunk
      const float* wr = w1 + (size_t)u * T;
      float s = 0.0f;
      for (int t = 0; t < T; ++t) s += wr[t] * yc_s[t * F32_DC + lane];
      hc_s[u * F32_DC + lane] = quick_gelu(s + b1[u]);
    }
    __syncthreads();
    for (int t = warp; t < T; t += WARPS) {
      const float* wr = w2 + (size_t)t * U;
      float s = 0.0f;
      for (int u = 0; u < U; ++u) s += wr[u] * hc_s[u * F32_DC + lane];
      if (lane < nc) {
        const size_t off = (size_t)t * ts + d0 + lane;
        zb[off] = xb[off] + (s + b2[t]);
      }
    }
  }
  __syncthreads();  // z is in `out` for every token

  // Each group's LN reads its own rows, which no earlier group writes; the
  // last barrier of a group's hidden loop comes after its last shared read.
  for (int g0 = 0; g0 < T; g0 += F32_BM)
    channel_mix_f32<MC>(zb + (size_t)g0 * ts, ts, zb + (size_t)g0 * ts, ts, min(F32_BM, T - g0), lc_w, lc_b, w3, b3,
                        w4, b4, D, H, smem);
}

template <int NF>
cudaError_t launch_bf16(const void* x, void* out, long long ts, long long ss, int B, int T, int U, int H,
                        const void* const* p, cudaStream_t stream) {
  constexpr int RTM = row_tiles_max<NF>();
  auto kernel = mixer_block_bf16_kernel<NF, RTM>;
  // Opt into the shared memory once per instance (the port drives one device).
  static const cudaError_t opted = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return opted;
  if (round16(T) > 16 * RTM || U > MAX_TOKEN_HIDDEN) return cudaErrorInvalidValue;
  const size_t token = TokenSmem(T, U).total, channel = Bf16Shape<NF, RTM>::SMEM;
  const size_t smem = token > channel ? token : channel;
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  kernel<<<B, THREADS, smem, stream>>>(
      (const bf16*)x, (bf16*)out, ts, ss, T, U, H, (const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2],
      (const bf16*)p[3], (const bf16*)p[4], (const bf16*)p[5], (const bf16*)p[6], (const bf16*)p[7],
      (const bf16*)p[8], (const bf16*)p[9], (const bf16*)p[10], (const bf16*)p[11]);
  return cudaGetLastError();
}

template <int MC>
cudaError_t launch_f32(const void* x, void* out, long long ts, long long ss, int B, int T, int U, int D, int H,
                       const void* const* p, cudaStream_t stream) {
  auto kernel = mixer_block_f32_kernel<MC>;
  const int token = f32_token_smem(T, U), channel = f32_smem(D);
  const int smem = token > channel ? token : channel;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, THREADS, smem, stream>>>(
      (const float*)x, (float*)out, ts, ss, T, U, D, H, (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (const float*)p[9], (const float*)p[10], (const float*)p[11]);
  return cudaGetLastError();
}

}  // namespace

// C interface. x and out [T, B, D] at token stride ts and sample stride ss
// (elements; D contiguous, out laid out as x); the twelve parameters in
// order: LN_tok scale, bias [D]; W1 [U, T], b1 [U]; W2 [T, U], b2 [T];
// LN_ch scale, bias [D]; W3 [H, D], b3 [H]; W4 [D, H], b4 [D]. The caller
// checks T <= 80, U <= 320, H % 128 == 0, B > 0, contiguous parameters,
// 32-byte-aligned pointers, and for bf16 D % 128 == 0, D <= 1024 and
// T_pad / 16 <= min(5, 24 / (D / 128)); for f32 D <= 1024.
extern "C" int mixer_block_bf16(const void* x, void* out, long long ts, long long ss, int B, int T, int U, int D,
                                int H, const void* lt_w, const void* lt_b, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* lc_w, const void* lc_b, const void* w3,
                                const void* b3, const void* w4, const void* b4, void* stream) {
  const void* p[12] = {lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b, w3, b3, w4, b4};
  cudaStream_t s = (cudaStream_t)stream;
  if (D % (16 * WARPS) || T > MAX_TOKENS) return (int)cudaErrorInvalidValue;
  switch (D / (16 * WARPS)) {
    case 1: return launch_bf16<1>(x, out, ts, ss, B, T, U, H, p, s);
    case 2: return launch_bf16<2>(x, out, ts, ss, B, T, U, H, p, s);
    case 3: return launch_bf16<3>(x, out, ts, ss, B, T, U, H, p, s);
    case 4: return launch_bf16<4>(x, out, ts, ss, B, T, U, H, p, s);
    case 5: return launch_bf16<5>(x, out, ts, ss, B, T, U, H, p, s);
    case 6: return launch_bf16<6>(x, out, ts, ss, B, T, U, H, p, s);
    case 7: return launch_bf16<7>(x, out, ts, ss, B, T, U, H, p, s);
    case 8: return launch_bf16<8>(x, out, ts, ss, B, T, U, H, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mixer_block_f32(const void* x, void* out, long long ts, long long ss, int B, int T, int U, int D,
                               int H, const void* lt_w, const void* lt_b, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* lc_w, const void* lc_b, const void* w3,
                               const void* b3, const void* w4, const void* b4, void* stream) {
  const void* p[12] = {lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b, w3, b3, w4, b4};
  cudaStream_t s = (cudaStream_t)stream;
  if (T > MAX_TOKENS || U > MAX_TOKEN_HIDDEN) return (int)cudaErrorInvalidValue;
  switch ((D + THREADS - 1) / THREADS) {
    case 1: return launch_f32<1>(x, out, ts, ss, B, T, U, D, H, p, s);
    case 2: return launch_f32<2>(x, out, ts, ss, B, T, U, D, H, p, s);
    case 3: return launch_f32<3>(x, out, ts, ss, B, T, U, D, H, p, s);
    case 4: return launch_f32<4>(x, out, ts, ss, B, T, U, D, H, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
