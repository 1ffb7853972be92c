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
// LN runs once in f32 and lands in shared memory as bf16. The hidden dim is
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;              // rows per CTA (f32)
constexpr int HC = 128;             // hidden chunk width (f32)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quick_gelu(float h) { return h / (1.0f + expf(-1.702f * h)); }

// LN of rows [row0, row0 + ROWS) into y_s [ROWS, ldy], f32 internals, biased
// variance, eps 1e-5, stored in T. Rows past R are written as zeros.
template <typename T, int ROWS>
__device__ void ln_rows(const T* __restrict__ x, const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                        T* y_s, int ldy, int row0, int R, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += WARPS) {
    T* yrow = y_s + r * ldy;
    const int gr = row0 + r;
    if (gr >= R) {
      for (int c = lane; c < W; c += 32) yrow[c] = from_f32<T>(0.0f);
      continue;
    }
    const T* xr = x + (size_t)gr * W;
    float s = 0.0f;
    for (int c = lane; c < W; c += 32) s += to_f32(xr[c]);
    const float mean = warp_sum(s) / W;
    float v = 0.0f;
    for (int c = lane; c < W; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / W + 1e-5f);
    for (int c = lane; c < W; c += 32) {
      const float yn = (to_f32(xr[c]) - mean) * rstd;
      yrow[c] = from_f32<T>(yn * to_f32(ln_w[c]) + to_f32(ln_b[c]));
    }
  }
}

// ---- bf16: wmma tensor cores fed from a cp.async ring ----------------------
// The weights stream through shared memory as a sequence of tiles, per hidden
// chunk of HC1: W / KT1 tiles of W_in[chunk, k-slice] (GEMM1), then HC1 / 16
// tiles of W_out[:, 16 hidden] (GEMM2). Every thread copies its share of
// tile t + S - 1 while the warps multiply tile t. Shared rows are padded
// (LD1, LDY, LDH, LDS) so the fragment loads hit distinct banks.
constexpr int HC1 = 64;        // hidden chunk
constexpr int KT1 = 128;       // GEMM1 k-slice
constexpr int LD1 = KT1 + 8;   // GEMM1 tile row: W_in[n, k-slice]
constexpr int LD2 = 16;        // GEMM2 tile row: W_out[n, 16 hidden]
constexpr int LDH = HC1 + 8;   // h_s row
constexpr int LDS = HC1 + 4;   // f32 stage row
constexpr int SMEM_MAX = 232448;  // 227 KB, the most one block may opt into

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// NF = output column fragments (16 wide) per warp: W = NF * 16 * WARPS. A
// block owns BM_ rows, 32 or 64 (64 only where the [64, W] f32
// accumulators fit in registers: 4 * NF fragments of 8 a thread, <= 192).
// More rows per block means fewer weight bytes from L2 per row, but fewer
// and longer blocks: the launcher takes 64 only when 32-row blocks would
// not fit in one wave on the card.
template <int NF, int BM_>
struct Bf16Shape {
  static constexpr int W = NF * 16 * WARPS;
  static constexpr int BM = BM_;
  static constexpr int RT = BM / 16;           // row tiles
  static constexpr int K1 = W / KT1;           // GEMM1 tiles per chunk
  static constexpr int TPC = K1 + HC1 / 16;    // tiles per chunk
  static constexpr int LDY = W + 8;            // y_s row
  static constexpr int SLOT = (HC1 * LD1 > W * LD2) ? HC1 * LD1 : W * LD2;  // elements
  static constexpr int FIXED = BM * LDY * 2 + BM * LDH * 2 + BM * LDS * 4;
  static constexpr int S_FIT = (SMEM_MAX - FIXED) / (SLOT * 2);
  static constexpr int S = S_FIT > 4 ? 4 : S_FIT;  // ring depth
  static constexpr int SMEM = S * SLOT * 2 + FIXED;
  static_assert(S >= 2, "the cp.async ring needs two slots");
};

template <int NF, int BM_>
__device__ __forceinline__ void fetch_tile(bf16* slot, int t, const bf16* __restrict__ w_in,
                                           const bf16* __restrict__ w_out, int H) {
  using S_ = Bf16Shape<NF, BM_>;
  const int chunk = t / S_::TPC, r = t % S_::TPC;
  if (r < S_::K1) {  // W_in[chunk * HC1 + n, r * KT1 + 8q], 16 bytes each
    const bf16* src = w_in + (size_t)chunk * HC1 * S_::W + r * KT1;
    for (int i = threadIdx.x; i < HC1 * (KT1 / 8); i += THREADS) {
      const int n = i / (KT1 / 8), q = i % (KT1 / 8);
      cp_async16(slot + n * LD1 + q * 8, src + (size_t)n * S_::W + q * 8);
    }
  } else {  // W_out[n, chunk * HC1 + 16 k2 + 8q]
    const bf16* src = w_out + chunk * HC1 + (r - S_::K1) * 16;
    for (int i = threadIdx.x; i < S_::W * 2; i += THREADS) {
      const int n = i >> 1, q = i & 1;
      cp_async16(slot + n * LD2 + q * 8, src + (size_t)n * H + q * 8);
    }
  }
}

template <int NF, int BM_>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                   const bf16* __restrict__ w_in, const bf16* __restrict__ b_in,
                   const bf16* __restrict__ w_out, const bf16* __restrict__ b_out,
                   bf16* __restrict__ out, int R, int H) {
  using S_ = Bf16Shape<NF, BM_>;
  constexpr int W = S_::W, S = S_::S, LDY = S_::LDY, BM = S_::BM, RT = S_::RT;
  constexpr int RT1 = RT / 2;  // GEMM1 row tiles per warp (4 column tiles x 2 warp rows)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);                                   // [S][SLOT]
  bf16* y_s = ring + S * S_::SLOT;                                              // [BM, LDY]
  bf16* h_s = y_s + BM * LDY;                                                   // [BM, LDH]
  float* stage = reinterpret_cast<float*>(h_s + BM * LDH);                      // [BM, LDS]

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = (H / HC1) * S_::TPC;
  const int cw = warp % 4, rw = (warp / 4) * RT1;  // this warp's GEMM1 column tile and first row tile

  // The first tiles fly while LN runs.
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < T) fetch_tile<NF, BM_>(ring + s * S_::SLOT, s, w_in, w_out, H);
    cp_async_commit();
  }
  ln_rows<bf16, BM>(x, ln_w, ln_b, y_s, LDY, row0, R, W);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][NF];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  int t = 0;
  for (int c0 = 0; c0 < H; c0 += HC1) {
    // h[rows of rw.., 16 cw : 16 cw + 16] = y . W_in[c0 + 16 cw ...]^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[RT1];
#pragma unroll
    for (int i = 0; i < RT1; ++i) wmma::fill_fragment(hacc[i], 0.0f);
    for (int kt = 0; kt < S_::K1; ++kt, ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();  // tile t landed for every thread; slot (t - 1) % S is free
      if (t + S - 1 < T) fetch_tile<NF, BM_>(ring + ((t + S - 1) % S) * S_::SLOT, t + S - 1, w_in, w_out, H);
      cp_async_commit();
      // B(k, n) = W_in[c0 + n, kt * KT1 + k]: column-major in the tile
      const bf16* bt = ring + (t % S) * S_::SLOT + 16 * cw * LD1;
#pragma unroll
      for (int kk = 0; kk < KT1; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, bt + kk, LD1);
#pragma unroll
        for (int i = 0; i < RT1; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, y_s + 16 * (rw + i) * LDY + kt * KT1 + kk, LDY);
          wmma::mma_sync(hacc[i], a, b, hacc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT1; ++i)
      wmma::store_matrix_sync(stage + 16 * (rw + i) * LDS + 16 * cw, hacc[i], LDS, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * HC1; i += THREADS) {
      const int r = i / HC1, c = i % HC1;
      const float h = stage[r * LDS + c] + __bfloat162float(b_in[c0 + c]);
      h_s[r * LDH + c] = __float2bfloat16(quick_gelu(h));
    }
    // acc[:, warp's columns] += h . W_out[cols, c0 : c0 + HC1]^T, 16 hidden at a time
    for (int k2 = 0; k2 < HC1 / 16; ++k2, ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();  // also publishes h_s
      if (t + S - 1 < T) fetch_tile<NF, BM_>(ring + ((t + S - 1) % S) * S_::SLOT, t + S - 1, w_in, w_out, H);
      cp_async_commit();
      const bf16* bt = ring + (t % S) * S_::SLOT;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) wmma::load_matrix_sync(a[i], h_s + 16 * i * LDH + 16 * k2, LDH);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        // B(k, n) = W_out[n, c0 + 16 k2 + k]: column-major in the tile
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, bt + (warp * NF * 16 + 16 * j) * LD2, LD2);
#pragma unroll
        for (int i = 0; i < RT; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue through a 16x16 f32 scratch per warp: out = x + acc + b_out.
  float* scratch = stage + warp * 256;
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + 16 * i + r;
      const int gc = warp * NF * 16 + 16 * j + cc;
      if (gr < R) {
        const bf16* xr = x + (size_t)gr * W + gc;
        bf16* orow = out + (size_t)gr * W + gc;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = __bfloat162float(xr[e]) + scratch[r * 16 + cc + e] + __bfloat162float(b_out[gc + e]);
          orow[e] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

// ---- f32: CUDA cores -----------------------------------------------------
// MC = output columns per thread: W <= MC * THREADS.
template <int MC>
__global__ void __launch_bounds__(THREADS)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const float* __restrict__ w_in, const float* __restrict__ b_in,
                  const float* __restrict__ w_out, const float* __restrict__ b_out,
                  float* __restrict__ out, int R, int W, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem);  // [BM, W]
  float* h_s = y_s + BM * W;                     // [BM, HC]

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ln_rows<float, BM>(x, ln_w, ln_b, y_s, W, row0, R, W);
  __syncthreads();

  float acc[MC][BM];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[m][r] = 0.0f;

  for (int c0 = 0; c0 < H; c0 += HC) {
    // h[:, n] for the warp's chunk columns: lanes split k, then a warp sum per row.
    for (int n = warp; n < HC; n += WARPS) {
      const float* wrow = w_in + (size_t)(c0 + n) * W;
      float part[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) part[r] = 0.0f;
      for (int k = lane; k < W; k += 32) {
        const float wv = wrow[k];
#pragma unroll
        for (int r = 0; r < BM; ++r) part[r] += y_s[r * W + k] * wv;
      }
      float mine = 0.0f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float s = warp_sum(part[r]);
        if (lane == r) mine = s;
      }
      h_s[lane * HC + n] = quick_gelu(mine + b_in[c0 + n]);  // BM == 32 lanes
    }
    __syncthreads();
    for (int k = 0; k < HC; ++k) {
      float wv[MC];
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        const int j = threadIdx.x + m * THREADS;
        wv[m] = j < W ? w_out[(size_t)j * H + c0 + k] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float hv = h_s[r * HC + k];
#pragma unroll
        for (int m = 0; m < MC; ++m) acc[m][r] += hv * wv[m];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MC; ++m) {
    const int j = threadIdx.x + m * THREADS;
    if (j >= W) continue;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int gr = row0 + r;
      if (gr < R) out[(size_t)gr * W + j] = x[(size_t)gr * W + j] + acc[m][r] + b_out[j];
    }
  }
}

template <int NF, int BM_>
cudaError_t launch_bf16(const void* x, const void* ln_w, const void* ln_b, const void* w_in, const void* b_in,
                        const void* w_out, const void* b_out, void* out, int R, int H, cudaStream_t stream) {
  using S_ = Bf16Shape<NF, BM_>;
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
  const int smem = (BM * W + BM * HC) * 4;
  cudaError_t e = cudaFuncSetAttribute(ln_mlp_f32_kernel<MC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((R + BM - 1) / BM);
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
