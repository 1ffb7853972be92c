// Device code of a mixer block's channel mix, shared by ln_mlp.cu and
// mixer_block.cu:
//
//   out = x + QuickGELU(LN(x) . W_in^T + b_in) . W_out^T + b_out
//
// - bf16: the LN rows (ln_rows_bf16, one warp a row, 16 bytes a lane a load)
//   and the two epilogue functors that gemm_sm90.cuh's GEMM runs on its
//   accumulators (GeluEpilogue after LN(x) . W_in^T, ResidualEpilogue after
//   h . W_out^T). The products themselves are gemm_sm90.cuh's.
// - f32: channel_mix_f32, one block of 8 warps on up to 32 rows and the
//   whole width W, on CUDA cores, for the f32 configurations. Row r of x is
//   at x + r * ldx and of out at out + r * ldo; x and out may be the same
//   rows (mixer_block.cu updates z in place): every element is read and then
//   written by one thread, and the LN has read all rows before any is
//   written.
// Weights are in nn.Linear's (out, in) layout: w_in [H, W], w_out [W, H].
// Rounding points follow the TPU kernel: LN in f32 with the affine from
// parameters already in the activation type, y and the hidden activation
// rounded to it, f32 accumulation, f32 epilogue.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_MAX = 232448;  // 227 KB, the most one block may opt into

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quick_gelu(float h) { return h / (1.0f + expf(-1.702f * h)); }

// (mean, 1 / sqrt(var + 1e-5)) of one f32 row of W values, biased
// variance; every lane of the calling warp gets them.
__device__ __forceinline__ float2 row_stats_f32(const float* xr, int W, int lane) {
  float s = 0.0f;
  for (int c = lane; c < W; c += 32) s += xr[c];
  const float mean = warp_sum(s) / W;
  float v = 0.0f;
  for (int c = lane; c < W; c += 32) {
    const float d = xr[c] - mean;
    v += d * d;
  }
  return make_float2(mean, rsqrtf(warp_sum(v) / W + 1e-5f));
}

// LN of `rows` f32 rows into y_s [rows_pad, ldy]; rows in [rows, rows_pad)
// are written as zeros.
__device__ void ln_rows_f32(const float* x, size_t ldx, int rows, int rows_pad, const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, float* y_s, int ldy, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows_pad; r += WARPS) {
    float* yrow = y_s + r * ldy;
    if (r >= rows) {
      for (int c = lane; c < W; c += 32) yrow[c] = 0.0f;
      continue;
    }
    const float* xr = x + (size_t)r * ldx;
    const float2 st = row_stats_f32(xr, W, lane);
    for (int c = lane; c < W; c += 32) yrow[c] = (xr[c] - st.x) * st.y * ln_w[c] + ln_b[c];
  }
}

// 8 bf16 values through one 16-byte access (p 16-byte aligned).
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One bf16 row of W values (W % 8 == 0, 16-byte aligned) held by a warp,
// 8 columns a lane a vector: v[k] holds columns 8 (lane + 32 k) onwards.
template <int W>
struct RowBf16 {
  static constexpr int NV = (W / 8 + 31) / 32;
  float v[NV][8];

  // Loads the row; returns (mean, 1 / sqrt(var + 1e-5)), biased variance, f32.
  __device__ __forceinline__ float2 load_stats(const bf16* xr, int lane) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 8 * (lane + 32 * k);
      if (c < W) {
        load8(xr + c, v[k]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[k][e];
      }
    }
    const float mean = warp_sum(s) / W;
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (8 * (lane + 32 * k) < W) {
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (v[k][e] - mean) * (v[k][e] - mean);
      }
    }
    return make_float2(mean, rsqrtf(warp_sum(q) / W + 1e-5f));
  }
};

// LN of `rows` bf16 rows of a compile-time width into y_s [rows_pad, ldy],
// 16 bytes a lane a load; rows in [rows, rows_pad) are written as zeros.
template <int W>
__device__ void ln_rows_bf16(const bf16* x, size_t ldx, int rows, int rows_pad, const bf16* __restrict__ ln_w,
                             const bf16* __restrict__ ln_b, bf16* y_s, int ldy) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows_pad; r += WARPS) {
    bf16* yrow = y_s + r * ldy;
    if (r >= rows) {
      const float zeros[8] = {};
      for (int c = 8 * lane; c < W; c += 256) store8(yrow + c, zeros);
      continue;
    }
    RowBf16<W> row;
    const float2 st = row.load_stats(x + (size_t)r * ldx, lane);
#pragma unroll
    for (int k = 0; k < RowBf16<W>::NV; ++k) {
      const int c = 8 * (lane + 32 * k);
      if (c < W) {
        float w[8], b[8], y[8];
        load8(ln_w + c, w);
        load8(ln_b + c, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = (row.v[k][e] - st.x) * st.y * w[e] + b[e];
        store8(yrow + c, y);
      }
    }
  }
}

// The GEMM epilogues of the bf16 channel mix (gemm_sm90.cuh's functors),
// shared by ln_mlp.cu and mixer_block.cu.
// GEMM 1: h[r, c..c+1] = bf16(QuickGELU(acc + b_in)).
struct GeluEpilogue {
  const bf16* bias;
  bf16* h;
  int ldh;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) const {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c));
    *reinterpret_cast<__nv_bfloat162*>(h + (size_t)r * ldh + c) =
        __floats2bfloat162_rn(quick_gelu(v0 + b.x), quick_gelu(v1 + b.y));
  }
};

// GEMM 2: out[r, c..c+1] = bf16(x + acc + b_out), in f32. x and out may be
// the same rows: each element is read and then written by one thread.
struct ResidualEpilogue {
  const bf16* bias;
  const bf16* x;
  bf16* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) const {
    const size_t i = (size_t)r * ld + c;
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c));
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + i));
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(xv.x + v0 + b.x, xv.y + v1 + b.y);
  }
};

// ---- f32: CUDA cores -----------------------------------------------------
// 32 rows a block (one a lane) and 128-wide hidden chunks: there is no
// full-precision f32 tensor-core path. MC = output columns per thread,
// W <= MC * THREADS. Shared memory: F32_SMEM(W) bytes.
constexpr int F32_BM = 32;
constexpr int F32_HC = 128;

__host__ __device__ constexpr int f32_smem(int W) { return (F32_BM * W + F32_BM * F32_HC) * 4; }

template <int MC>
__device__ __forceinline__ void channel_mix_f32(const float* x, size_t ldx, float* out, size_t ldo, int rows,
                                                const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                                                const float* __restrict__ w_in, const float* __restrict__ b_in,
                                                const float* __restrict__ w_out, const float* __restrict__ b_out,
                                                int W, int H, unsigned char* smem) {
  float* y_s = reinterpret_cast<float*>(smem);  // [F32_BM, W]
  float* h_s = y_s + F32_BM * W;                 // [F32_BM, F32_HC]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ln_rows_f32(x, ldx, rows, F32_BM, ln_w, ln_b, y_s, W, W);
  __syncthreads();

  float acc[MC][F32_BM];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int r = 0; r < F32_BM; ++r) acc[m][r] = 0.0f;

  for (int c0 = 0; c0 < H; c0 += F32_HC) {
    // h[:, n] for the warp's chunk columns: lanes split k, then a warp sum per row.
    for (int n = warp; n < F32_HC; n += WARPS) {
      const float* wrow = w_in + (size_t)(c0 + n) * W;
      float part[F32_BM];
#pragma unroll
      for (int r = 0; r < F32_BM; ++r) part[r] = 0.0f;
      for (int k = lane; k < W; k += 32) {
        const float wv = wrow[k];
#pragma unroll
        for (int r = 0; r < F32_BM; ++r) part[r] += y_s[r * W + k] * wv;
      }
      float mine = 0.0f;
#pragma unroll
      for (int r = 0; r < F32_BM; ++r) {
        const float s = warp_sum(part[r]);
        if (lane == r) mine = s;
      }
      h_s[lane * F32_HC + n] = quick_gelu(mine + b_in[c0 + n]);  // F32_BM == 32 lanes
    }
    __syncthreads();
    for (int k = 0; k < F32_HC; ++k) {
      float wv[MC];
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        const int j = threadIdx.x + m * THREADS;
        wv[m] = j < W ? w_out[(size_t)j * H + c0 + k] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < F32_BM; ++r) {
        const float hv = h_s[r * F32_HC + k];
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
    for (int r = 0; r < F32_BM; ++r)
      if (r < rows) out[(size_t)r * ldo + j] = x[(size_t)r * ldx + j] + acc[m][r] + b_out[j];
  }
}

}  // namespace
