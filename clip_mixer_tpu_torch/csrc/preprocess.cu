// Image front end for sm_90a: uint8 [B, H, W, 3] -> antialiased bicubic
// resize with the centre crop folded in -> (v - 255*mean) / (255*std) ->
// [B, N, N, 3] in bf16 or f32.
//
// Replaces clip_mixer_tpu/ops/pallas/preprocess_kernel.py::make_pallas_preprocess
// (body _kernel at :63-69). The TPU kernel ran two dense matmuls per image,
// R_h . img and then . R_w' with R_w block-expanded to keep the three
// channels interleaved on the 128-lane layout. Here the resize is separable
// and banded: the PIL bicubic matrices have ~5-9 non-zero taps per output
// row, so each output sums only its row's band (packed host-side from the
// same dense matrices: the same sums minus exact zeros, in the same order,
// R_h taps in k order and then R_w taps in k order, one FMA chain per
// output, so the f32 results are those of the first, one-CTA-per-row kernel).
//
// What bounds it on an H100: bytes. At B = 128, 256 -> 224 it must read
// 25.2 MB of uint8 and write 38.5 MB of bf16: 19 us at 3.35 TB/s. The banded
// arithmetic is ~0.25 G FMAs of f32 (under 10 us at the f32 peak), but each
// vertical tap also costs a shared-memory load and a byte conversion, and
// each horizontal tap a shared-memory load, so instruction issue and
// shared-memory wavefronts, not the FMA pipe, are the next limits.
//
// Design (what the first kernel lacked: it ran one 256-thread CTA per
// output row, 28,672 short CTAs each ending in a barrier with nothing to
// overlap, read the input a byte a thread per tap, re-read every tap and
// start from global memory and converted a byte for every tap):
// - A unit is a band of R output rows of one image (R, the pass height G
//   and the grid chosen by the host plan,
//   ops/kernels/preprocess.py::plan_preprocess). The input rows the band's
//   taps reach are one contiguous byte range of the image, staged into
//   shared memory whole by a cp.async.bulk (TMA 1-d bulk copy) that
//   completes on an mbarrier; the few bytes before the first and after the
//   last 16-byte boundary are copied by the threads.
// - Persistent CTAs (up to three an SM) walk the units; the next unit's
//   copy is issued into the other of two stages before the current unit is
//   computed, so device-memory reads overlap the arithmetic and the stores.
// - The R_h and R_w taps and starts are loaded into shared memory once per
//   CTA, R_w transposed to [k][p] so that neighbouring threads (pixels) read
//   neighbouring words. Where both passes have five taps (256 -> 224, the
//   resize the front end serves) the count is a compile-time constant: the
//   tap loops unroll and every load of a sum is issued at once. Any other
//   count takes the same sums in the same order with the count read at run
//   time.
// - Per pass of G <= 4 rows: the vertical sums t[g, c, w] = sum_k rh[o, k]
//   * img[start_h[o] + k, w, c], four pixels (12 bytes, three 32-bit shared
//   loads a tap, conflict-free) a thread, each byte made f32 on the integer
//   and FMA pipes (0x4B000000 | byte is 2^23 + byte exactly; minus 2^23),
//   into an f32 row buffer of three channel planes; then the horizontal
//   sums, a pixel a thread with its R_w taps in registers, for every row of
//   the pass, normalised and stored straight to the output. Planes put a
//   pixel's taps ~1.14 words from its neighbour's (an interleaved row put
//   them ~3.4 apart, 3-4-way bank conflicts), and a warp takes only as many
//   consecutive pixels (PW, 28 at 256 -> 224) as start within 32 words, so
//   each of its loads hits 32 distinct banks. The vertical sums of pass q + 1
//   and the horizontal ones of pass q run in one phase between barriers, on
//   two row buffers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_state.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PASS = 4;  // output rows a pass, at most (the horizontal pass unrolls over them)
constexpr int SMEM_MAX = 232448;  // 227 KB, the most one block may opt into on an H100

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__host__ __device__ constexpr size_t a16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared memory, in bytes from the (128-aligned) base, every region 16-byte
// aligned: two input stages of stage_bytes; two f32 row buffers [G, 3, Wp]
// (a plane a channel, Wp = W rounded up to 4); R_h taps [N, KH] and starts
// [N]; R_w taps transposed [KW, N] and starts [N]; norm [6] (32 bytes); two
// mbarriers. ops/kernels/preprocess.py::smem_bytes mirrors it.
struct Layout {
  size_t tbuf, rh, rhs, rw, rws, norm, bar, total;
  __host__ __device__ Layout(int W, int N, int KH, int KW, int G, int stage_bytes) {
    const size_t rowf = 3 * ((size_t)(W + 3) / 4 * 4);
    size_t o = 2 * (size_t)stage_bytes;
    tbuf = o;
    o += a16(2 * (size_t)G * rowf * 4);
    rh = o;
    o += a16((size_t)N * KH * 4);
    rhs = o;
    o += a16((size_t)N * 4);
    rw = o;
    o += a16((size_t)N * KW * 4);
    rws = o;
    o += a16((size_t)N * 4);
    norm = o;
    o += 32;
    bar = o;
    total = o + 16;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// Byte i of w as an exact f32: 0x4B0000xx is 2^23 + xx.
template <int I>
__device__ __forceinline__ float byte_f32(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | I)) - 8388608.0f;
}

struct Args {
  const uint8_t* img;
  const float* rh_taps;  // [N, KH]
  const int* rh_start;   // [N]
  const float* rw_taps;  // [N, KW]
  const int* rw_start;   // [N]
  const float* norm;     // {255*mean[0..2], 1/(255*std[0..2])}
  const int* bands;      // [2, n_bands]: first input row a band stages, and how many
  void* out;
  int B, H, W, N, KH, KW, R, G, n_bands, stage_bytes;
  int PW;  // consecutive output pixels a warp takes in the horizontal pass
};

// The unit's bytes start at `start`; byte x lands at stage + (start & 15) + (x - start).
__device__ __forceinline__ const uint8_t* unit_src(const Args& a, int u, int& lo) {
  const int b = u / a.n_bands, j = u - b * a.n_bands;
  lo = a.bands[j];
  return a.img + ((size_t)b * a.H + lo) * (size_t)(a.W * 3);
}

// Stage unit u's input rows into `stage`, completing on `bar`. All threads call it.
__device__ __forceinline__ void issue(const Args& a, int u, unsigned char* stage, uint64_t* bar) {
  int lo;
  const uint8_t* src = unit_src(a, u, lo);
  const int j = u % a.n_bands;
  const size_t n = (size_t)a.bands[a.n_bands + j] * (a.W * 3);
  const uintptr_t start = (uintptr_t)src, end = start + n;
  const uintptr_t first = (start + 15) & ~(uintptr_t)15, last = end & ~(uintptr_t)15;
  unsigned char* buf = stage + (start & 15);
  if (first < last) {
    if (threadIdx.x == 0) {
      // the stage was last read by the generic proxy, before a barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, (uint32_t)(last - first));
      bulk_load(buf + (first - start), (const void*)first, (uint32_t)(last - first), bar);
    }
    const int head = (int)(first - start), tail = (int)(end - last);
    for (int i = threadIdx.x; i < head + tail; i += THREADS) {
      const size_t x = i < head ? (size_t)i : (last - start) + (i - head);
      buf[x] = src[x];
    }
  } else {
    if (threadIdx.x == 0) mbar_arrive(bar);
    for (size_t i = threadIdx.x; i < n; i += THREADS) buf[i] = src[i];
  }
}

// KT: the taps of both passes as a compile-time constant (loops unrolled,
// every load of a sum issued at once), or 0 for any KH and KW.
template <typename T, bool WORDS, int KT>
__global__ void __launch_bounds__(THREADS, 3) preprocess_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = a.W, rowb = W * 3, N = a.N, KH = KT ? KT : a.KH, KW = KT ? KT : a.KW, G = a.G;
  const int Wp = (W + 3) / 4 * 4, rowf = 3 * Wp;
  const Layout L(W, N, KH, KW, G, a.stage_bytes);
  float* rh = reinterpret_cast<float*>(smem + L.rh);
  int* rhs = reinterpret_cast<int*>(smem + L.rhs);
  float* rw = reinterpret_cast<float*>(smem + L.rw);
  int* rws = reinterpret_cast<int*>(smem + L.rws);
  float* nrm = reinterpret_cast<float*>(smem + L.norm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int units = a.B * a.n_bands;

  for (int i = tid; i < N * KH; i += THREADS) rh[i] = a.rh_taps[i];
  for (int i = tid; i < N * KW; i += THREADS) {
    const int p = i / KW, k = i - p * KW;
    rw[k * N + p] = a.rw_taps[i];
  }
  for (int i = tid; i < N; i += THREADS) {
    rhs[i] = a.rh_start[i];
    rws[i] = a.rw_start[i];
  }
  if (tid < 6) nrm[tid] = a.norm[tid];
  if (tid == 0) {
    mbar_init(&bar[0], 1);  // one arrival (with the copy's bytes) a phase
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if ((int)blockIdx.x < units) issue(a, blockIdx.x, smem, &bar[0]);
  __syncthreads();

  const int Q4 = (W + 3) / 4;  // 4-pixel (12-byte) column groups a row
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    const int s = it & 1;
    if (u + (int)gridDim.x < units) issue(a, u + gridDim.x, smem + (size_t)(s ^ 1) * a.stage_bytes, &bar[s ^ 1]);
    int lo;
    const uint8_t* src = unit_src(a, u, lo);
    const unsigned char* st = smem + (size_t)s * a.stage_bytes + ((uintptr_t)src & 15);
    const int b = u / a.n_bands, j = u - b * a.n_bands;
    const int o0 = j * a.R, rows = min(a.R, N - o0);
    const int nq = (rows + G - 1) / G;
    T* dst = reinterpret_cast<T*>(a.out) + ((size_t)b * N + o0) * N * 3;
    mbar_wait(&bar[s], (it >> 1) & 1);

    for (int ph = 0; ph <= nq; ++ph) {
      // horizontal pass of q = ph - 1: a pixel a thread, its three channels
      // in every row of the pass, stored straight to the output. A warp
      // takes PW consecutive pixels, whose starts lie within 32 words of a
      // plane, so that its loads hit 32 distinct banks.
      if (ph >= 1 && lane < a.PW) {
        const int q = ph - 1, gr = min(G, rows - q * G);
        const float* tb = reinterpret_cast<const float*>(smem + L.tbuf) + (size_t)(q & 1) * G * rowf;
        for (int p = warp * a.PW + lane; p < N; p += (THREADS / 32) * a.PW) {
          const float* t0 = tb + rws[p];
          float wr[KT ? KT : 1];
          if constexpr (KT > 0) {
#pragma unroll
            for (int k = 0; k < KT; ++k) wr[k] = rw[k * N + p];
          }
#pragma unroll
          for (int g = 0; g < MAX_PASS; ++g) {
            if (g < gr) {
              const float* t = t0 + (size_t)g * rowf;
              float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
              for (int k = 0; k < KW; ++k) {
                float w;
                if constexpr (KT > 0) w = wr[k]; else w = rw[k * N + p];
                s0 = fmaf(w, t[k], s0);
                s1 = fmaf(w, t[Wp + k], s1);
                s2 = fmaf(w, t[2 * Wp + k], s2);
              }
              T* d = dst + ((size_t)(q * G + g) * N + p) * 3;
              d[0] = from_f32<T>((s0 - nrm[0]) * nrm[3]);
              d[1] = from_f32<T>((s1 - nrm[1]) * nrm[4]);
              d[2] = from_f32<T>((s2 - nrm[2]) * nrm[5]);
            }
          }
        }
      }
      // vertical pass of q = ph: four pixels (12 bytes) of a row a thread
      if (ph < nq) {
        const int q = ph, gr = min(G, rows - q * G);
        float* tb = reinterpret_cast<float*>(smem + L.tbuf) + (size_t)(q & 1) * G * rowf;
        for (int i = tid; i < gr * Q4; i += THREADS) {
          const int g = i / Q4, x0 = (i - g * Q4) * 4;
          const int o = o0 + q * G + g;
          const unsigned char* p = st + (size_t)(rhs[o] - lo) * rowb + 3 * x0;
          const float* w = rh + o * KH;
          float* d = tb + (size_t)g * rowf + x0;
          // s[c][j]: channel c of pixel x0 + j
          float s[3][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
          if (WORDS) {
#pragma unroll
            for (int k = 0; k < KH; ++k) {
              const uint32_t* pk = reinterpret_cast<const uint32_t*>(p + (size_t)k * rowb);
              const uint32_t v0 = pk[0], v1 = pk[1], v2 = pk[2];
              const float wk = w[k];
              s[0][0] = fmaf(wk, byte_f32<0>(v0), s[0][0]);
              s[1][0] = fmaf(wk, byte_f32<1>(v0), s[1][0]);
              s[2][0] = fmaf(wk, byte_f32<2>(v0), s[2][0]);
              s[0][1] = fmaf(wk, byte_f32<3>(v0), s[0][1]);
              s[1][1] = fmaf(wk, byte_f32<0>(v1), s[1][1]);
              s[2][1] = fmaf(wk, byte_f32<1>(v1), s[2][1]);
              s[0][2] = fmaf(wk, byte_f32<2>(v1), s[0][2]);
              s[1][2] = fmaf(wk, byte_f32<3>(v1), s[1][2]);
              s[2][2] = fmaf(wk, byte_f32<0>(v2), s[2][2]);
              s[0][3] = fmaf(wk, byte_f32<1>(v2), s[0][3]);
              s[1][3] = fmaf(wk, byte_f32<2>(v2), s[1][3]);
              s[2][3] = fmaf(wk, byte_f32<3>(v2), s[2][3]);
            }
#pragma unroll
            for (int c = 0; c < 3; ++c)
              *reinterpret_cast<float4*>(d + c * Wp) = make_float4(s[c][0], s[c][1], s[c][2], s[c][3]);
          } else {
            const int nx = min(4, W - x0);
            for (int k = 0; k < KH; ++k) {
              const unsigned char* pk = p + (size_t)k * rowb;
              const float wk = w[k];
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 3; ++c)
                  if (j < nx) s[c][j] = fmaf(wk, (float)pk[3 * j + c], s[c][j]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 3; ++c)
                if (j < nx) d[c * Wp + j] = s[c][j];
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, bool WORDS, int KT>
cudaError_t launch_as(const Args& a, int smem, int grid, cudaStream_t stream) {
  static port::SmemOptIn opt_in;  // per instance, per device
  const cudaError_t e = opt_in.ensure((const void*)preprocess_kernel<T, WORDS, KT>, smem);
  if (e != cudaSuccess) return e;
  preprocess_kernel<T, WORDS, KT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* img, const void* rh_taps, const void* rh_start, int KH, const void* rw_taps,
           const void* rw_start, int KW, const void* norm, const void* bands, void* out, int B, int H, int W, int N,
           int R, int G, int n_bands, int stage_bytes, int PW, int smem, int grid, void* stream) {
  // the host plan's shared memory must be this layout's
  const Layout L(W, N, KH, KW, G, stage_bytes);
  if (stage_bytes % 16 || (size_t)smem != L.total || smem > SMEM_MAX || grid <= 0 || R <= 0 || G <= 0 ||
      G > MAX_PASS || PW <= 0 || PW > 32)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)img, (const float*)rh_taps, (const int*)rh_start, (const float*)rw_taps,
               (const int*)rw_start, (const float*)norm, (const int*)bands, out,
               B, H, W, N, KH, KW, R, G, n_bands, stage_bytes, PW};
  const bool words = W % 4 == 0 && ((uintptr_t)img & 3) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!words) return (int)launch_as<T, false, 0>(a, smem, grid, s);
  // the served resize, 256 -> 224, has five taps in both passes
  if (KH == 5 && KW == 5) return (int)launch_as<T, true, 5>(a, smem, grid, s);
  return (int)launch_as<T, true, 0>(a, smem, grid, s);
}

}  // namespace

// C interface. img uint8 [B, H, W, 3]; the packed bands of R_h and R_w; norm
// [6] f32; bands int32 [2, n_bands] (the host plan's staged input rows per
// band of R output rows); out [B, N, N, 3]; G output rows a pass; the plan's
// stage and total shared-memory bytes; grid CTAs.
extern "C" int preprocess_u8_bf16(const void* img, const void* rh_taps, const void* rh_start, int KH,
                                  const void* rw_taps, const void* rw_start, int KW, const void* norm,
                                  const void* bands, void* out, int B, int H, int W, int N, int R, int G,
                                  int n_bands, int stage_bytes, int PW, int smem, int grid, void* stream) {
  return launch<__nv_bfloat16>(img, rh_taps, rh_start, KH, rw_taps, rw_start, KW, norm, bands, out, B, H, W, N, R, G,
                               n_bands, stage_bytes, PW, smem, grid, stream);
}

extern "C" int preprocess_u8_f32(const void* img, const void* rh_taps, const void* rh_start, int KH,
                                 const void* rw_taps, const void* rw_start, int KW, const void* norm,
                                 const void* bands, void* out, int B, int H, int W, int N, int R, int G,
                                 int n_bands, int stage_bytes, int PW, int smem, int grid, void* stream) {
  return launch<float>(img, rh_taps, rh_start, KH, rw_taps, rw_start, KW, norm, bands, out, B, H, W, N, R, G,
                       n_bands, stage_bytes, PW, smem, grid, stream);
}
