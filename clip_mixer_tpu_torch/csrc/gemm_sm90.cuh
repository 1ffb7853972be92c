// A bf16 GEMM for sm_90a: C[M, N] = A[M, K] . B[N, K]^T with f32 sums and an
// epilogue functor, built the Hopper way: TMA loads into a ring of
// shared-memory stages, warpgroup MMAs (wgmma) on them, warp specialisation.
//
// It serves the two products of a channel mix, y . W_in^T with a QuickGELU
// epilogue, then h . W_out^T with a residual epilogue: for
// clip_mixer_tpu/ops/pallas/mlp_kernel.py::fused_ln_mlp through ln_mlp.cu,
// and for the channel half of block_kernel.py::fused_mixer_block_tbd through
// mixer_block.cu. Both operands are K-major, the layout
// of row-major activations (A) and of nn.Linear's (out, in) weights (B), so
// nothing is transposed.
//
// What bounds it on an H100: at the serving shapes (M = 6400, N and K = 768
// and 3072) each product is 30 GFLOP against 15-65 MB of operands and
// results, so tensor-core operations bound it (31 us at 989 TFLOP/s bf16).
// A fused whole-width channel mix keeps a block's whole [64, W] f32 output
// in registers, so its row tile cannot grow, no warpgroup MMA fits beside
// the accumulators, and every block re-streams all the weights from L2.
// Here a block owns one 128 x BN tile of C only.
//
// Design: one block per 128 x BN output tile (BN = 256 when N % 256 == 0
// and those tiles make two waves on the card, else 128); K walked in BK = 64
// steps, one 128-byte swizzle row of bf16.
// Three warpgroups:
// - warpgroup 0 produces, after setmaxnreg.dec to 40 registers: one thread
//   waits for a free stage on its `empty` mbarrier and issues
//   cp.async.bulk.tensor loads of the A and B tiles into it (128B swizzle;
//   rows past M arrive as zeros), completing on the stage's `full` mbarrier;
// - warpgroups 1 and 2 consume, after setmaxnreg.inc to 232: each owns 64
//   rows of the tile and runs BK / 16 wgmma.mma_async m64nBNk16 per stage
//   from shared-memory descriptors into f32 accumulators in registers (128 a
//   thread at BN = 256). One wgmma group stays in flight; when the next is
//   issued, the stage of the one before it is released.
// The epilogue goes from the registers straight to global memory: the
// functor gets (row, column pair, two f32 values) for rows < M.
// Preconditions (the callers check them): K % 64 == 0, N % 128 == 0, A and
// B 16-byte aligned. The TMA maps are built on the host at each launch;
// cuTensorMapEncodeTiled comes through the runtime's driver entry point, so
// nothing links against libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int THREADS = 384;  // one producer and two consumer warpgroups

template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = BM * BK * 2;  // 16 KB
  static constexpr int B_BYTES = BN * BK * 2;  // 32 or 16 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 1024 bytes of slack to align the ring to the 128B swizzle's 1024-byte atom
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static constexpr int ACC = BN / 2;  // f32 accumulators a consumer thread: 64 x BN over 128 threads
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

// One box of a 2-d tensor map into shared memory; c0 is the inner (K) coordinate.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128B swizzle:
// 128-byte rows, 8-row groups 1024 bytes apart (SBO), layout type 1 (128B
// swizzle); the leading offset is unused by this layout.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

// Keeps the compiler from moving accumulator registers while wgmma owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_F8(i)                                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define SM90_F64(i) \
  SM90_F8(i), SM90_F8(i + 8), SM90_F8(i + 16), SM90_F8(i + 24), SM90_F8(i + 32), SM90_F8(i + 40), SM90_F8(i + 48), \
      SM90_F8(i + 56)

// d[64 x BN] = A[64 x 16] . B[BN x 16]^T + (accumulate ? d : 0), both
// operands from shared memory, K-major.
template <int BN>
__device__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : SM90_F64(0), SM90_F64(64)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_F64(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef SM90_F64
#undef SM90_F8

template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b, int M, int K,
                Epi epi) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_s = smem;                             // STAGES x [128 rows][64] bf16, swizzled
  uint8_t* b_s = smem + T::STAGES * T::A_BYTES;    // STAGES x [BN rows][64] bf16, swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + T::STAGES * T::B_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_tiles = K / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; the bytes complete it
      mbar_init(&empty[s], 8);  // lane 0 of each of the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % T::STAGES;
        // a fresh barrier passes the wait for parity 1: the first round finds every stage free
        mbar_wait(&empty[s], ((kt / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        tma_load(a_s + s * T::A_BYTES, &map_a, &full[s], kt * BK, m0);
        tma_load(b_s + s * T::B_BYTES, &map_b, &full[s], kt * BK, n0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this warpgroup's 64 rows of the tile
    // No instruction but wgmma writes d before the epilogue (the first MMA
    // overwrites it), or ptxas serialises the MMAs.
    float d[T::ACC];
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % T::STAGES;
      mbar_wait(&full[s], (kt / T::STAGES) & 1);
      const uint64_t da = sw128_desc(a_s + s * T::A_BYTES + c * 64 * BK * 2);
      const uint64_t db = sw128_desc(b_s + s * T::B_BYTES);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma<BN>(d, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);  // +32 B a step
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(d);
      // the group before this one has finished reading its stage: release it
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(kt - 1) % T::STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // wgmma's accumulator layout: register 4j + {0, 1} holds row 16 warp + lane / 4,
    // columns 8j + 2 (lane % 4) + {0, 1}; 4j + {2, 3} the same columns 8 rows down.
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = m0 + 64 * c + 16 * warp + lane / 4;
    const int col = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (row < M) epi(row, col + 8 * j, d[4 * j], d[4 * j + 1]);
      if (row + 8 < M) epi(row + 8, col + 8 * j, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (null if absent).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                           &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, K] matrix as a TMA map of [box_rows, 64] boxes,
// 128B swizzle, zeros for rows past the end.
inline bool kmajor_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, class Epi>
cudaError_t launch(const bf16* A, const bf16* B, int M, int N, int K, const Epi& epi, cudaStream_t stream) {
  using T = Tile<BN>;
  // Opt into the shared memory once per instance (the port drives one device).
  static const cudaError_t opted =
      cudaFuncSetAttribute(gemm_kernel<BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (opted != cudaSuccess) return opted;
  CUtensorMap map_a, map_b;
  if (!kmajor_map(&map_a, A, M, K, BM) || !kmajor_map(&map_b, B, N, K, BN)) return cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<BN, Epi><<<grid, THREADS, T::SMEM, stream>>>(map_a, map_b, M, K, epi);
  return cudaGetLastError();
}

// The card's SM count, looked up once (the port drives one device); 0 if
// the lookup failed.
inline int sm_count() {
  static const int sms = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// C = A . B^T through `epi`, on `stream`; A [M, K] and B [N, K] row-major bf16.
// 256-wide tiles where N allows them and they make at least two waves of
// blocks (one block an SM); else 128-wide ones, twice as many blocks, so a
// short grid (the second product at N = W, small R) fills more of the card.
template <class Epi>
cudaError_t gemm(const bf16* A, const bf16* B, int M, int N, int K, const Epi& epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || N % 128 || K <= 0 || K % BK) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const bool wide = N % 256 == 0 && (long long)((M + BM - 1) / BM) * (N / 256) >= 2LL * sms;
  return wide ? launch<256>(A, B, M, N, K, epi, stream) : launch<128>(A, B, M, N, K, epi, stream);
}

}  // namespace sm90
