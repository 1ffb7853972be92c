// A whole mixer block, for sm_90a:
//
//   z   = x + W2 . QuickGELU(W1 . LN_tok(x) + b1) + b2     (over the token axis)
//   out = z + QuickGELU(LN_ch(z) . W3^T + b3) . W4^T + b4  (over the width)
//
// Replaces clip_mixer_tpu/ops/pallas/block_kernel.py::fused_mixer_block_tbd
// (body _kernel at :71-124). x and out are [T, B, D] with D contiguous, at
// token stride ts and sample stride ss (elements), either a contiguous
// [T, B, D] or a [T, B, D] view of a contiguous [B, T, D]: the tower passes
// its [B, T, D] activations and nothing is transposed. Both are one dense
// block of B*T rows. Weights arrive in nn.Linear's (out, in) layout:
// W1 [U, T], W2 [T, U], W3 [H, D], W4 [D, H].
//
// What bounds it on an H100: at a bucket of 128 samples the products are
// 2*B*D*2*T*U + 2*B*T*2*D*H operations (64.3 GFLOP on the vision tower,
// T=50 U=200 D=768 H=3072; 47.6 GFLOP on the text tower, T=77 U=308 D=512
// H=2048) against about 29 MB of unique bytes (vision): bound by
// tensor-core operations, 65 us and 48 us at the 989 TFLOP/s bf16 peak.
// The channel mix is 94% (vision) of the operations.
//
// Design (bf16): three launches on the caller's stream.
// (a) token_mix_kernel: z = x + the token MLP, into `out`, and y2 = LN_ch(z)
//     into a [B*T, D] scratch in out's row order. Alone it is bound by bytes:
//     3.9 GFLOP (vision, bucket 128; 6.2 text) against 29.5 MB (x read, z
//     and y2 written; 30.3 text), 8.8 us at 3.35 TB/s. One block of four
//     warpgroups a sample, as the TPU kernel's batch tile:
//     - the sample's x [T, D] lands whole in shared memory (one
//       cp.async.bulk a token row, on one mbarrier) while the threads stage
//       W1 and W2 zero-padded to T_pad = 16 ceil(T/16) and U_pad =
//       64 ceil(U/64), in the no-swizzle core-matrix layout that a wgmma
//       descriptor names (8 rows x 16 bytes contiguous; row groups 128 bytes
//       apart, 8-column groups (R_pad + 1) x 16 bytes apart). Then LN_tok's
//       row statistics.
//     - Each warpgroup walks D in 64-column slices in the transposed
//       orientation, so the token hidden never leaves registers: it writes
//       Y^T [64 d, T_pad] = LN_tok(x)[:, slice]^T in bf16 (K-major), then, 64
//       hidden units at a time, H^T [64, 64] = Y^T . W1^T on wgmma (B is W1
//       as stored, K-major), adds b1, applies QuickGELU in f32 and rounds to
//       bf16 in registers, and feeds that as the register A operand of
//       Z^T [64, T_pad] += H^T . W2^T (B is W2 as stored): the accumulator
//       layout of the first product is the A-fragment layout of the second
//       (FlashAttention-3's P . V). A thread holds 32 hidden and T_pad / 2
//       output accumulators.
//     - The slice's epilogue adds b2 and x in f32, rounds once, and writes z
//       over x's slice in shared memory. After the last slice, LN_ch over
//       the sample's z rows writes z to `out` and y2 to the scratch, 16 bytes
//       a lane.
//     Padded hidden units are gelu(0) = 0 against zero columns of W2;
//     padded token rows are zeros in Y^T and are not stored; 8-unit groups
//     of the hidden past U skip the QuickGELU.
//     What bounds it in practice is latency, not bytes or tensor time: the
//     same ~45 us a block whether 8 or 128 blocks run. ptxas waits for each
//     register-A product before the warpgroup goes on (it must keep the A
//     registers), so a warpgroup's products, QuickGELU (two MUFU operations
//     an element, ex2 and rcp, 16 a clock an SM) and epilogues run one after
//     another; four warpgroups (the most whose registers and Y^T slices fit)
//     overlap one another's. The launch, the staging and the statistics take
//     about 12 us before the first product.
//     At a bucket of 8 the grid is 8 blocks, but the token half is 6% of the
//     block's operations: the bulk, the channel half, spreads its row tiles
//     over the card.
// (b), (c) the channel half on gemm_sm90.cuh, as ln_mlp.cu runs it:
//     h = bf16(QuickGELU(y2 . W3^T + b3)) into a second scratch [B*T, H],
//     then out = bf16(z + h . W4^T + b4) in place on the rows of `out`
//     (each element is read and then written by one thread).
// The rounding points are the TPU kernel's: y, the token hidden, z, y2 and
// the channel hidden in bf16; f32 sums and epilogues.
//
// Design (f32): one block of 8 warps a sample on CUDA cores (there is no
// full-precision f32 tensor-core path): the token mix in 32-column chunks,
// the token weights read from L2, z into `out`, then the channel mix 32 rows
// at a time (channel_mix.cuh's channel_mix_f32): for the f32 tests, not for
// speed.

#include "channel_mix.cuh"
#include "gemm_sm90.cuh"

namespace {

// f32: the token half's shared memory. (bf16 takes T <= 80 too, T_pad / 2
// <= 40 output accumulators a thread, and U as its shared memory allows.)
constexpr int MAX_TOKENS = 80;
constexpr int MAX_TOKEN_HIDDEN = 320;

// ---- bf16 token half ---------------------------------------------------------

constexpr int TM_WG = 4;                 // warpgroups a block
constexpr int TM_THREADS = 128 * TM_WG;
constexpr int SLICE = 64;                // columns of D a warpgroup takes at a time: wgmma's M
constexpr int UC = 64;                   // hidden units a chunk: the first product's N
constexpr int ROW_NV = 4;                // 16-byte vectors of a row a lane holds: D <= 1024

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Bytes of an [R_pad, K_pad] bf16 operand in the core-matrix layout below.
__host__ __device__ constexpr size_t cm_bytes(int rows_pad, int k_pad) { return (size_t)(k_pad / 8) * (rows_pad + 1) * 16; }

// Byte offsets of the token kernel's shared memory, from a 128-byte-aligned
// base: x [T, XS] bf16 (then z); W1 [U_pad, T_pad] and W2 [T_pad, U_pad] in
// the core-matrix layout; a Y^T [64, T_pad] a warpgroup; b1 [U_pad] and b2,
// mean, rstd [T_pad] in f32; the mbarrier. `total` adds 128 bytes of slack
// for the alignment. ops/kernels/mixer_block.py mirrors it.
struct TokenSmem {
  int TP, UP, XS;
  size_t w1, w2, y, b1, b2, mean, rstd, bar, total;
  __host__ __device__ TokenSmem(int T, int U, int D) {
    TP = round_up(T, 16);
    UP = round_up(U, UC);
    XS = D + 8;  // 16 bytes of padding a row: rows t and t + 2 fall on other banks in the epilogue
    w1 = align128((size_t)T * XS * 2);
    w2 = align128(w1 + cm_bytes(UP, TP));
    y = align128(w2 + cm_bytes(TP, UP));
    b1 = align128(y + TM_WG * cm_bytes(SLICE, TP));
    b2 = b1 + (size_t)UP * 4;
    mean = b2 + (size_t)TP * 4;
    rstd = mean + (size_t)TP * 4;
    bar = rstd + (size_t)TP * 4;
    total = bar + 8 + 128;
  }
};

// The no-swizzle K-major layout of an [R_pad, K_pad] bf16 operand: 8-column
// groups of R_pad rows x 16 bytes, one after another with 16 bytes between
// them, so that the group stride, (R_pad + 1) x 16 bytes, is not a multiple
// of 128: a warp that stores the same column of 32 groups then hits 8 bank
// groups, not one.
__device__ __forceinline__ int cm_lbo(int rows_pad) { return rows_pad + 1; }  // group stride, 16-byte units

// Element offset of (r, k) in that layout.
__device__ __forceinline__ int cm_index(int r, int k, int rows_pad) { return (k / 8) * cm_lbo(rows_pad) * 8 + r * 8 + k % 8; }

// wgmma descriptor of that layout (layout type 0, no swizzle): core matrices
// (8 rows x 16 bytes) 128 bytes apart along the rows (SBO) and one group
// stride apart along K (LBO). A k16 step adds two group strides.
__device__ __forceinline__ uint64_t cm_desc(const void* p, int rows_pad) {
  return (uint64_t)((sm90::smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)cm_lbo(rows_pad) << 16 |
         (uint64_t)(128 >> 4) << 32;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// QuickGELU on the card's fast exp2 and reciprocal (two MUFU operations):
// relative error about 1e-6, far below the bf16 rounding that follows.
__device__ __forceinline__ float quick_gelu_fast(float h) { return __fdividef(h, 1.0f + __expf(-1.702f * h)); }

__device__ __forceinline__ void warpgroup_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// Generic-proxy writes to shared memory become visible to wgmma.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// `bytes` contiguous bytes (16-byte multiples, 16-byte aligned) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(sm90::smem_addr(bar))
               : "memory");
}

// Zeros over `bytes` (a multiple of 16) of shared memory, 16 bytes a thread.
__device__ void zero_shared(void* dst, size_t bytes) {
  for (size_t i = 16 * threadIdx.x; i < bytes; i += 16 * TM_THREADS)
    *reinterpret_cast<uint4*>(static_cast<unsigned char*>(dst) + i) = make_uint4(0, 0, 0, 0);
}

// src [R, K] row-major (nn.Linear's layout, 16-byte aligned) into dst, an
// [R_pad, K_pad] operand in the core-matrix layout whose padding is zero
// already. The source is read as one flat array, 16 bytes a thread a step
// (coalesced: its rows of T or U values are not 16-byte aligned), and each
// value stored on its own.
__device__ void stage_operand(bf16* dst, const bf16* __restrict__ src, int R, int K, int RP) {
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const int n = R * K;
  for (int i = 8 * threadIdx.x; i < n; i += 8 * TM_THREADS) {
    uint32_t w[4];
    if (i + 8 <= n) {
      const uint4 u = *reinterpret_cast<const uint4*>(s + i);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (i + 2 * e < n ? s[i + 2 * e] : 0u) | (i + 2 * e + 1 < n ? (uint32_t)s[i + 2 * e + 1] << 16 : 0u);
    }
    int r = i / K, k = i % K;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (r < R) d[cm_index(r, k, RP)] = (unsigned short)(e % 2 ? w[e / 2] >> 16 : w[e / 2] & 0xFFFF);
      if (++k == K) k = 0, ++r;
    }
  }
}

// A bf16 row of D values (D % 8 == 0, D <= 1024, 16-byte aligned) into v,
// 8 columns a lane a vector (v[k] holds columns 8 (lane + 32 k) onwards);
// returns (mean, 1 / sqrt(var + 1e-5)), biased variance, f32: RowBf16's
// statistics at a width known at run time.
__device__ __forceinline__ float2 row_stats_bf16(const bf16* xr, int D, int lane, float (&v)[ROW_NV][8]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < ROW_NV; ++k) {
    const int c = 8 * (lane + 32 * k);
    if (c < D) {
      load8(xr + c, v[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[k][e];
    }
  }
  const float mean = warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < ROW_NV; ++k) {
    if (8 * (lane + 32 * k) < D) {
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (v[k][e] - mean) * (v[k][e] - mean);
    }
  }
  return make_float2(mean, rsqrtf(warp_sum(q) / D + 1e-5f));
}

// Keeps the compiler from moving accumulator registers while wgmma owns them.
#define TM_F8(i)                                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// d[64 x N] = A[64 x 16] . B[N x 16]^T + (accumulate ? d : 0): A and B from
// shared-memory descriptors (wgmma_ss), or A from registers (wgmma_rs, four
// registers of two bf16 each in mma.m16n8k16's A-fragment layout, a warp
// owning 16 rows). B K-major.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TM_F8(0), TM_F8(8), TM_F8(16), TM_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : TM_F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : TM_F8(0), TM_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : TM_F8(0), TM_F8(8), TM_F8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TM_F8(0), TM_F8(8), TM_F8(16), TM_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : TM_F8(0), TM_F8(8), TM_F8(16), TM_F8(24), TM_F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
#undef TM_F8

// One block a sample: z = x + the token MLP into `z` (x's layout) and
// y2 = LN_ch(z) into `y2` (x's layout), T <= TP.
template <int TP>
__global__ void __launch_bounds__(TM_THREADS, 1)
token_mix_kernel(const bf16* __restrict__ x, bf16* __restrict__ z, bf16* __restrict__ y2, long long ts, long long ss,
                 int T, int U, int D, const bf16* __restrict__ lt_w, const bf16* __restrict__ lt_b,
                 const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, const bf16* __restrict__ lc_w, const bf16* __restrict__ lc_b) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (sm90::smem_addr(smem_raw) & 127)) & 127);
  const TokenSmem L(T, U, D);
  const int XS = L.XS, UP = L.UP;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  float* mean_s = reinterpret_cast<float*>(smem + L.mean);
  float* rstd_s = reinterpret_cast<float*>(smem + L.rstd);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t sample = (size_t)blockIdx.x * ss;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);  // the expect_tx arrival; the bytes complete it
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) sm90::mbar_expect_tx(bar, (uint32_t)(T * D * 2));
    __syncwarp();
    for (int t = lane; t < T; t += 32) bulk_load(xs + (size_t)t * XS, x + sample + (size_t)t * ts, D * 2, bar);
  }
  zero_shared(w1s, L.y - L.w1);  // W1 and W2
  for (int i = threadIdx.x; i < UP; i += TM_THREADS) b1s[i] = i < U ? __bfloat162float(b1[i]) : 0.0f;
  for (int i = threadIdx.x; i < TP; i += TM_THREADS) b2s[i] = i < T ? __bfloat162float(b2[i]) : 0.0f;
  __syncthreads();
  stage_operand(w1s, w1, U, T, UP);  // B of the first product: rows u, K = t
  stage_operand(w2s, w2, T, U, TP);  // B of the second: rows t, K = u
  fence_async_shared();
  sm90::mbar_wait(bar, 0);
  for (int t = warp; t < T; t += TM_THREADS / 32) {
    float v[ROW_NV][8];
    const float2 st = row_stats_bf16(xs + (size_t)t * XS, D, lane, v);
    if (lane == 0) {
      mean_s[t] = st.x;
      rstd_s[t] = st.y;
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  bf16* ys = reinterpret_cast<bf16*>(smem + L.y + wg * cm_bytes(SLICE, TP));
  const uint64_t y_desc = cm_desc(ys, SLICE), w2_desc = cm_desc(w2s, TP);
  // wgmma's accumulator layout: register 4j + {0, 1} holds row 16 w + g, columns
  // 8j + 2 c4 + {0, 1}; 4j + {2, 3} the same columns 8 rows down.
  const int w = wt / 32, g = lane / 4, c4 = lane % 4;
  const int d = wt % SLICE;  // the column of a slice this thread writes Y^T for
  float lw = __bfloat162float(lt_w[wg * SLICE + d]), lb = __bfloat162float(lt_b[wg * SLICE + d]);
  for (int s = wg; s < D / SLICE; s += TM_WG) {
    const int d0 = s * SLICE;
    {  // Y^T of the slice: thread wt owns column d0 + d and the 8-token groups wt / 64 + 2i
      for (int tg = wt / SLICE; tg < TP / 8; tg += 128 / SLICE) {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float y[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int t = 8 * tg + 2 * e + q;
            y[q] = t < T ? (__bfloat162float(xs[(size_t)t * XS + d0 + d]) - mean_s[t]) * rstd_s[t] * lw + lb : 0.0f;
          }
          v[e] = pack_bf16(y[0], y[1]);
        }
        *reinterpret_cast<uint4*>(ys + cm_index(d, 8 * tg, SLICE)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    fence_async_shared();
    warpgroup_sync(1 + wg);  // Y^T is in for the warpgroup's products
    // the next slice's LN_tok parameters, loaded under this slice's products
    const int dn = min(d0 + TM_WG * SLICE, D - SLICE) + d;
    const float lw_next = __bfloat162float(lt_w[dn]), lb_next = __bfloat162float(lt_b[dn]);

    float zacc[TP / 2];  // Z^T [64, T_pad]; the first product of a slice overwrites it
    uint32_t a[UC / 16][4];  // the chunk's H^T in bf16, A fragments of the second product's k16 steps
    for (int n0 = 0; n0 < UP; n0 += UC) {
      float hacc[UC / 2];
      const uint64_t w1_desc = cm_desc(w1s + cm_index(n0, 0, UP), UP);
      sm90::fence_acc(hacc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TP / 16; ++kk)
        wgmma_ss<UC>(hacc, y_desc + 2 * cm_lbo(SLICE) * kk, w1_desc + 2 * cm_lbo(UP) * kk, kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      sm90::fence_acc(hacc);
      // also the last chunk's second product: its A registers are free again
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      sm90::fence_acc(hacc);
      fence_regs(a);

      // + b1, QuickGELU, bf16: 8-column group j is half of k16 step j / 2,
      // A registers {0, 1} (rows g, g + 8) for j even, {2, 3} for j odd
#pragma unroll
      for (int j = 0; j < UC / 8; ++j) {
        float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (n0 + 8 * j < U) {  // the same for the whole warpgroup
          const float2 b = *reinterpret_cast<const float2*>(b1s + n0 + 8 * j + 2 * c4);
          h[0] = quick_gelu_fast(hacc[4 * j] + b.x);
          h[1] = quick_gelu_fast(hacc[4 * j + 1] + b.y);
          h[2] = quick_gelu_fast(hacc[4 * j + 2] + b.x);
          h[3] = quick_gelu_fast(hacc[4 * j + 3] + b.y);
        }
        a[j / 2][2 * (j % 2)] = pack_bf16(h[0], h[1]);
        a[j / 2][2 * (j % 2) + 1] = pack_bf16(h[2], h[3]);
      }

      sm90::fence_acc(zacc);
      fence_regs(a);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < UC / 16; ++k)
        wgmma_rs<TP>(zacc, a[k], w2_desc + 2 * cm_lbo(TP) * (n0 / 16 + k), n0 > 0 || k > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      sm90::fence_acc(zacc);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    sm90::fence_acc(zacc);
    fence_regs(a);

    // z = x + (Z^T + b2) in f32, rounded once, over x's slice; padded tokens are not stored
#pragma unroll
    for (int j = 0; j < TP / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 8 * j + 2 * c4 + q;
        if (t < T) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bf16* p = xs + (size_t)t * XS + d0 + 16 * w + g + 8 * r;
            *p = __float2bfloat16(__bfloat162float(*p) + (zacc[4 * j + 2 * r + q] + b2s[t]));
          }
        }
      }
    }
    lw = lw_next;
    lb = lb_next;
  }
  // LN_ch: one warp a row; z and y2 out, 16 bytes a lane. A lane's LN_ch
  // parameters are the same in every row: loaded once, before the barrier.
  uint4 lcw[ROW_NV], lcb[ROW_NV];
#pragma unroll
  for (int k = 0; k < ROW_NV; ++k) {
    const int c = 8 * (lane + 32 * k);
    if (c < D) {
      lcw[k] = *reinterpret_cast<const uint4*>(lc_w + c);
      lcb[k] = *reinterpret_cast<const uint4*>(lc_b + c);
    }
  }
  __syncthreads();  // z is in shared memory for every token
  for (int t = warp; t < T; t += TM_THREADS / 32) {
    const bf16* zr = xs + (size_t)t * XS;
    float v[ROW_NV][8];
    const float2 st = row_stats_bf16(zr, D, lane, v);
    const size_t row = sample + (size_t)t * ts;
#pragma unroll
    for (int k = 0; k < ROW_NV; ++k) {
      const int c = 8 * (lane + 32 * k);
      if (c < D) {
        *reinterpret_cast<uint4*>(z + row + c) = *reinterpret_cast<const uint4*>(zr + c);
        float cw[8], cb[8], y[8];
        load8(reinterpret_cast<const bf16*>(&lcw[k]), cw);
        load8(reinterpret_cast<const bf16*>(&lcb[k]), cb);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = (v[k][e] - st.x) * st.y * cw[e] + cb[e];
        store8(y2 + row + c, y);
      }
    }
  }
}

template <int TP>
cudaError_t launch_token_mix(const void* x, void* z, void* y2, long long ts, long long ss, int B, int T, int U, int D,
                             const void* const* p, cudaStream_t stream) {
  auto kernel = token_mix_kernel<TP>;
  // Opt into the shared memory once per instance (the port drives one device).
  static const cudaError_t opted = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return opted;
  const size_t smem = TokenSmem(T, U, D).total;
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  kernel<<<B, TM_THREADS, smem, stream>>>((const bf16*)x, (bf16*)z, (bf16*)y2, ts, ss, T, U, D, (const bf16*)p[0],
                                          (const bf16*)p[1], (const bf16*)p[2], (const bf16*)p[3], (const bf16*)p[4],
                                          (const bf16*)p[5], (const bf16*)p[6], (const bf16*)p[7]);
  return cudaGetLastError();
}

// ---- f32 ------------------------------------------------------------------------

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
// (elements; D contiguous; out laid out as x; a contiguous [T, B, D] or a
// [T, B, D] view of a contiguous [B, T, D]); the twelve parameters in
// order: LN_tok scale, bias [D]; W1 [U, T], b1 [U]; W2 [T, U], b2 [T];
// LN_ch scale, bias [D]; W3 [H, D], b3 [H]; W4 [D, H], b4 [D]. Every
// entry returns cudaGetLastError() after its last launch.
//
// bf16: y2 [B*T, D] and h [B*T, H] are scratch, in out's row order. The
// caller checks T <= 80, D % 128 == 0, D <= 1024, H % 128 == 0, B > 0,
// contiguous 32-byte-aligned parameters and scratch, and TokenSmem's total
// (T, U, D) <= 227 KB. The three stages are entries of their own, for the
// checks and the timing of each.
extern "C" int mixer_block_token_mix(const void* x, void* z, void* y2, long long ts, long long ss, int B, int T, int U,
                                     int D, const void* lt_w, const void* lt_b, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* lc_w, const void* lc_b,
                                     void* stream) {
  const void* p[8] = {lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b};
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 128 || D > 1024 || T < 1) return (int)cudaErrorInvalidValue;
  switch ((T + 15) / 16) {
    case 1: return launch_token_mix<16>(x, z, y2, ts, ss, B, T, U, D, p, s);
    case 2: return launch_token_mix<32>(x, z, y2, ts, ss, B, T, U, D, p, s);
    case 3: return launch_token_mix<48>(x, z, y2, ts, ss, B, T, U, D, p, s);
    case 4: return launch_token_mix<64>(x, z, y2, ts, ss, B, T, U, D, p, s);
    case 5: return launch_token_mix<80>(x, z, y2, ts, ss, B, T, U, D, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// h = bf16(QuickGELU(y2 . W3^T + b3)), R = B*T rows.
extern "C" int mixer_block_linear_gelu(const void* y2, const void* w3, const void* b3, void* h, int R, int H, int D,
                                       void* stream) {
  const GeluEpilogue epi{(const bf16*)b3, (bf16*)h, H};
  return sm90::gemm((const bf16*)y2, (const bf16*)w3, R, H, D, epi, (cudaStream_t)stream);
}

// out = bf16(out + h . W4^T + b4), in place on the R = B*T rows of out.
extern "C" int mixer_block_linear_residual(const void* h, const void* w4, const void* b4, void* out, int R, int D,
                                           int H, void* stream) {
  const ResidualEpilogue epi{(const bf16*)b4, (const bf16*)out, (bf16*)out, D};
  return sm90::gemm((const bf16*)h, (const bf16*)w4, R, D, H, epi, (cudaStream_t)stream);
}

extern "C" int mixer_block_bf16(const void* x, void* out, long long ts, long long ss, int B, int T, int U, int D,
                                int H, const void* lt_w, const void* lt_b, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* lc_w, const void* lc_b, const void* w3,
                                const void* b3, const void* w4, const void* b4, void* y2, void* h, void* stream) {
  int e = mixer_block_token_mix(x, out, y2, ts, ss, B, T, U, D, lt_w, lt_b, w1, b1, w2, b2, lc_w, lc_b, stream);
  if (e == 0) e = mixer_block_linear_gelu(y2, w3, b3, h, B * T, H, D, stream);
  if (e == 0) e = mixer_block_linear_residual(h, w4, b4, out, B * T, D, H, stream);
  return e;
}

// f32: the caller checks T <= 80, U <= 320, H % 128 == 0, B > 0, D <= 1024
// and contiguous 32-byte-aligned parameters.
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
