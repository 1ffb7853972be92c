// The channel mix of a mixer block, as device code for one thread block of
// 8 warps that owns a few rows and the whole width W:
//
//   out = x + QuickGELU(LN(x) . W_in^T + b_in) . W_out^T + b_out
//
// Shared by ln_mlp.cu (a block owns up to 64 rows of x [R, W]) and
// mixer_block.cu (a block owns the T tokens of one sample, after its token
// mix). Row r of x is at x + r * ldx and of out at out + r * ldo; x and out
// may be the same rows (mixer_block.cu updates z in place): every element is
// read and then written by one thread, and the LN has read all rows before
// any is written. Weights are in nn.Linear's (out, in) layout: w_in [H, W],
// w_out [W, H]. Rounding points follow the TPU kernel: LN in f32 with the
// affine from parameters already in the activation type, y and the hidden
// activation rounded to it, f32 accumulation, f32 epilogue.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

// NF = output column fragments (16 wide) per warp: W = NF * 16 * WARPS.
// RT = the row tiles (16 rows) a block owns; the [16 RT, W] f32
// accumulators live in registers, RT * NF fragments of 8 floats a thread
// (192 registers at RT * NF = 24).
template <int NF, int RT>
struct Bf16Shape {
  static constexpr int W = NF * 16 * WARPS;
  static constexpr int BM = 16 * RT;
  static constexpr int K1 = W / KT1;           // GEMM1 tiles per chunk
  static constexpr int TPC = K1 + HC1 / 16;    // tiles per chunk
  static constexpr int LDY = W + 8;            // y_s row
  static constexpr int SLOT = (HC1 * LD1 > W * LD2) ? HC1 * LD1 : W * LD2;  // elements
  static constexpr int FIXED = BM * LDY * 2 + BM * LDH * 2 + BM * LDS * 4;
  static constexpr int S_FIT = (SMEM_MAX - FIXED) / (SLOT * 2);
  static constexpr int S = S_FIT > 4 ? 4 : S_FIT;  // ring depth
  static constexpr int SMEM = S * SLOT * 2 + FIXED;
  static_assert(S >= 2, "the cp.async ring needs two slots");
  static_assert(BM * LDS >= WARPS * 256, "the epilogue's per-warp scratch lives in the stage");
};

template <int NF, int RT>
__device__ __forceinline__ void fetch_tile(bf16* slot, int t, const bf16* __restrict__ w_in,
                                           const bf16* __restrict__ w_out, int H) {
  using S_ = Bf16Shape<NF, RT>;
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

// The channel mix of `rows` rows (rows <= 16 * RT) with the shared memory
// `smem` (Bf16Shape<NF, RT>::SMEM bytes); x and out rows 16-byte aligned.
// GEMM1 splits the RT row tiles between two halves of the warps, each warp
// taking one of the chunk's four 16-column tiles; GEMM2 gives each warp NF
// output column tiles of every row tile. Rows past `rows` are zeros in y
// and are not stored.
template <int NF, int RT>
__device__ __forceinline__ void channel_mix_bf16(const bf16* x, size_t ldx, bf16* out, size_t ldo, int rows,
                                                 const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                                                 const bf16* __restrict__ w_in, const bf16* __restrict__ b_in,
                                                 const bf16* __restrict__ w_out, const bf16* __restrict__ b_out,
                                                 int H, unsigned char* smem) {
  using S_ = Bf16Shape<NF, RT>;
  constexpr int S = S_::S, LDY = S_::LDY, BM = S_::BM;
  constexpr int RT1 = (RT + 1) / 2;  // the most GEMM1 row tiles a warp takes
  bf16* ring = reinterpret_cast<bf16*>(smem);                                   // [S][SLOT]
  bf16* y_s = ring + S * S_::SLOT;                                              // [BM, LDY]
  bf16* h_s = y_s + BM * LDY;                                                   // [BM, LDH]
  float* stage = reinterpret_cast<float*>(h_s + BM * LDH);                      // [BM, LDS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int NT = (H / HC1) * S_::TPC;
  const int cw = warp % 4, rw = (warp / 4) * RT1;  // this warp's GEMM1 column tile and first row tile
  const int nrw = min(RT1, RT - rw);                // and its number of row tiles (RT odd: one fewer)

  // The first tiles fly while LN runs.
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < NT) fetch_tile<NF, RT>(ring + s * S_::SLOT, s, w_in, w_out, H);
    cp_async_commit();
  }
  ln_rows_bf16<S_::W>(x, ldx, rows, BM, ln_w, ln_b, y_s, LDY);

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
      if (t + S - 1 < NT) fetch_tile<NF, RT>(ring + ((t + S - 1) % S) * S_::SLOT, t + S - 1, w_in, w_out, H);
      cp_async_commit();
      // B(k, n) = W_in[c0 + n, kt * KT1 + k]: column-major in the tile
      const bf16* bt = ring + (t % S) * S_::SLOT + 16 * cw * LD1;
#pragma unroll
      for (int kk = 0; kk < KT1; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, bt + kk, LD1);
#pragma unroll
        for (int i = 0; i < RT1; ++i) {
          if (RT % 2 == 0 || i < nrw) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, y_s + 16 * (rw + i) * LDY + kt * KT1 + kk, LDY);
            wmma::mma_sync(hacc[i], a, b, hacc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT1; ++i)
      if (RT % 2 == 0 || i < nrw)
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
      if (t + S - 1 < NT) fetch_tile<NF, RT>(ring + ((t + S - 1) % S) * S_::SLOT, t + S - 1, w_in, w_out, H);
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

  // Epilogue through a 16x16 f32 scratch per warp: out = x + acc + b_out,
  // 8 columns a lane.
  float* scratch = stage + warp * 256;
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = 16 * i + r;
      const int gc = warp * NF * 16 + 16 * j + cc;
      if (gr < rows) {
        float xv[8], bv[8], o[8];
        load8(x + (size_t)gr * ldx + gc, xv);
        load8(b_out + gc, bv);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = xv[e] + scratch[r * 16 + cc + e] + bv[e];
        store8(out + (size_t)gr * ldo + gc, o);
      }
      __syncwarp();
    }
  }
}

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
