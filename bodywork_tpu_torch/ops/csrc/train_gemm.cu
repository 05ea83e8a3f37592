// The MLP trainer's f32 weight gradients on Hopper's tensor cores (sm_90a):
// C[M, N] = h^T . dY for h (K, M) and dY (K, N), both row-major, K the
// minibatch; f32-accurate as three TF32 wgmma products.
//
// Replaces no Pallas kernel: the JAX package leaves the trainer's products
// to XLA's `dot` (bodywork_tpu/models/mlp.py, the `lax.scan` Adam loop).
// It was added because the port's training step at config 6's widths
// (32 -> 1024 -> 1024 -> 1024 -> 1, batch 32768) spent about 81% of its
// device time in cuBLAS's FFMA SGEMMs (TF32 off), at about 32% of the
// products' roofline; FFMA's own peak (67 TFLOP/s) caps any such GEMM
// under 41% of it. ops/train_gemm.py routes to it the trainer's weight
// gradients whose M, N and K are all at least 1024 (its module note says
// why the forward and input gradient stay on cuBLAS).
//
// Products. One TF32 product keeps 11 significant bits of each operand,
// a different function from the IEEE f32 product the trainer is held to.
// Each f32 operand is split as hi = x rounded to TF32 (cvt.rna, its low 13
// bits cleared) and lo = x - hi (exact in f32) with its low 13 bits
// cleared, and a product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, small terms
// first; the dropped lo.lo term and lo's truncation are about 2^-21 of the
// product (the split of mlp_kernel.cu). Neither operand reaches the tensor
// cores with bits below TF32's, so the result does not depend on how they
// would read them. The tensor cores' own accumulation truncates
// (mlp_kernel.cu's header: 1.7e-5 of scale over a 1024-long sum), and the
// weight gradient sums over K = the batch, 32768 at config 6: each pair of
// k-tiles (64 k, 192 terms) goes into a zeroed wgmma accumulator that is
// then added into a separate f32 register sum with a plain FADD.
//
// Operands. TF32 wgmma reads B from shared memory K-major only.
//   - B = dY^T comes pre-split: ops/train_gemm.py runs
//     `train_gemm_split_kernel` over dY (K, N) first, which transposes it
//     and writes B_hi and B_lo cut into tiles of TG_BN n-rows x TG_BK k
//     (16 KB), each K-major in wgmma's 128-byte swizzle already, ordered
//     (n tile, k tile), N padded to TG_BN with zeros. One bulk asynchronous
//     copy (cp.async.bulk, the TMA engine) brings a tile into shared memory.
//   - A = h^T is the raw f32 activation h (K, M), read in place through a
//     TMA tensor map in the 128-byte swizzle: four boxes of 32 k-lines x 32
//     rows a k-tile (two lanes of a fragment load share a bank). The
//     consumer threads load their A fragments into registers, split them
//     there, and issue wgmma with A from registers: the one pass over a
//     batch-sized operand is dY's transposing split.
//
// Design.
//   - Grid: (N tiles, M tiles, K splits) of TG_BM x TG_BN = 128 x 128
//     outputs; the N tile varies fastest, so the CTAs that share an A row
//     tile run together and B stays in L2.
//   - Block: two consumer warpgroups (64 output rows each, one m64n128k8
//     accumulator of 64 f32 a thread, the 64-float promoted sum and two
//     k-tiles' split A fragments, 232 registers by setmaxnreg) and a
//     producer warpgroup (40 registers) whose first warp keeps a ring of
//     TG_STAGES k-tiles in flight through full/empty mbarriers. A
//     consumer takes its k-tiles in pairs: per k-tile, per k8 step, three
//     wgmma (lo.hi, hi.lo, hi.hi), committed as one group; the pair's two
//     groups run back to back, then wgmma.wait_group 0, both stages
//     released and the accumulator promoted into the sum. The two
//     warpgroups keep the tensor cores busy through each other's waits.
//   - Split K: where the output has fewer tiles than the card has SMs
//     (config 6: 64 tiles of 128 x 128 for 132 SMs), the grid's
//     z splits the k-tiles; each split writes its partial sum to a
//     workspace, and `train_gemm_splitk_reduce_kernel` adds them in a
//     fixed order. No atomics: a seeded fit gives the same bits twice.
//   - Ragged edges: M and N need not be tile multiples (TMA fills A's
//     columns past M with zeros, the split pads B's rows past N with
//     zeros, and rows and columns past M and N are not stored); K must be
//     a multiple of TG_BK, and M and N of 4 (h's rows 16-byte aligned for
//     TMA, 8-byte stores).
//
// Bound on an H100 SXM: operations. 3xTF32 issues three TF32 products a
// multiply-add, 495 / 3 = 165 TFLOP/s of f32-accurate products; a weight
// gradient at config 6's hidden widths (M, N, K = 1024, 1024, 32768, 68.7
// GFLOP) takes 0.416 ms there, and its bytes (about 0.3 GB with the split
// pass) 0.09 ms at 3.35 TB/s. On an H100 its product takes about 0.5 ms,
// and 0.49 ms with its loads left out: the consumers' own work (fragment
// loads, splits, waits) holds it.
//
// Shared memory: TG_STAGES x 48 KB (2 B tiles and an A tile of 16 KB) +
// 1024 bytes of alignment slack + the mbarriers = 197,696 bytes of the
// 232,448 a block may opt into.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (ops/_build.py). cuTensorMapEncodeTiled is looked up
// through the CUDA runtime, so nothing more is linked. The C
// entry points launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() after each launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define TG_BM 128                                  // output rows a CTA
#define TG_BN 128                                  // output columns a CTA
#define TG_BK 32                                   // k a stage: one 128-byte swizzle row
#define TG_STAGES 4
#define TG_THREADS 384                             // two consumer warpgroups + a producer's
#define TG_B_TILE (TG_BN * TG_BK)                  // floats of one B tile
#define TG_B_BYTES (TG_B_TILE * 4)                 // 16384
#define TG_A_BYTES (TG_BM * TG_BK * 4)             // 16384
#define TG_A_BOX 32                                // M-major: A's m a TMA box (128 bytes)
#define TG_STAGE_BYTES (2 * TG_B_BYTES + TG_A_BYTES)  // 49152
#define TG_SMEM_BYTES (1024 + TG_STAGES * TG_STAGE_BYTES + 2 * TG_STAGES * 8)

static_assert(TG_B_BYTES % 1024 == 0 && TG_A_BYTES % 1024 == 0,
              "every tile stays 1024-byte aligned for the 128-byte swizzle");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- B's tiled layout (the split pass writes it, the product reads it):
// -- element (n, k) of B, KT = K / TG_BK k tiles, in floats
__device__ __forceinline__ size_t b_index(int n, int k, int KT) {
  const int nt = n / TG_BN, r = n % TG_BN, kt = k / TG_BK, c = k % TG_BK;
  return ((size_t)nt * KT + kt) * TG_B_TILE + (size_t)r * TG_BK +
         ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// -- the split: x = hi + lo, both TF32 with their low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// -- mbarriers and bulk copies
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one bulk asynchronous copy global -> shared, counted against `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- wgmma
// shared-memory descriptor, K-major, 128-byte swizzle: rows 128 B apart,
// 8-row groups 1024 B apart (SBO); LBO is unused for this layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep a register's value where it is across the asynchronous products
__device__ __forceinline__ void hold(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// d[64 x 128] (= or +=) A[64 x 8] . B[128 x 8]^T: A from registers (the
// m16n8k8 TF32 fragment of each warp's 16 rows), B from shared memory
template <int ACCUMULATE>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(ACCUMULATE)
      : "memory");
}

// one TMA copy of a 2-D box of `map` at (c0, c1) (innermost first) into
// shared memory, counted against `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the A fragment's element (row r, k) of a stage's A tile, as TMA lays
// it out in the 128-byte swizzle (a 16-byte chunk's index XOR the line's
// index mod 8): four boxes of 32 k-lines x 32 rows, box r / 32 holding
// rows 32 (r / 32) on
__device__ __forceinline__ int a_slot(int r, int k) {
  const int j = r / TG_A_BOX, m = r % TG_A_BOX;
  return j * TG_A_BOX * TG_BK + k * TG_A_BOX + ((((m >> 2) ^ (k & 7)) << 2) | (m & 3));
}

__device__ __forceinline__ void hold_fragments(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hold(hi[kk][i]);
      hold(lo[kk][i]);
    }
  }
}

// one k-tile of a consumer warpgroup: wait for its stage, load and split
// the thread's A fragments (rows r0 and r0 + 8), then issue its 12
// products as one group: per k8 step lo.hi, hi.lo, hi.hi. ACCUMULATE 0
// starts the accumulator afresh.
template <int ACCUMULATE>
__device__ __forceinline__ void issue_tile(float (&acc)[64], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4], const uint8_t* st,
                                           uint64_t* full, uint32_t phase, int r0, int t) {
  mbar_wait(full, phase);
  const float* As = reinterpret_cast<const float*>(st + 2 * TG_B_BYTES);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // fragment a_i: row r0 + 8 (i & 1), k 8 kk + t + 4 (i >> 1)
      split_tf32(As[a_slot(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1))], hi[kk][i], lo[kk][i]);
    }
  }
  const uint64_t dh = smem_desc(smem_u32(st)), dl = smem_desc(smem_u32(st + TG_B_BYTES));
#pragma unroll
  for (int i = 0; i < 64; ++i) hold(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // the next k8 step is 32 bytes further along each 128-byte row
    if (kk == 0) {
      wgmma_tf32<ACCUMULATE>(acc, lo[kk], dh);
    } else {
      wgmma_tf32<1>(acc, lo[kk], dh + 2 * kk);
    }
    wgmma_tf32<1>(acc, hi[kk], dl + 2 * kk);
    wgmma_tf32<1>(acc, hi[kk], dh + 2 * kk);
  }
  wgmma_commit();
}

// C (+ z M N for split z) = A . B^T over split z's k-tiles; `map_a` is
// A's tensor map
__global__ void __launch_bounds__(TG_THREADS, 1)
    train_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const float* __restrict__ b_hi,
                      const float* __restrict__ b_lo, float* __restrict__ c, int M, int N, int K,
                      int kt_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + TG_STAGES * TG_STAGE_BYTES);
  uint64_t* empty = full + TG_STAGES;
  const int KT = K / TG_BK;
  const int nt = blockIdx.x, m0 = blockIdx.y * TG_BM, n0 = nt * TG_BN;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(KT, kt0 + kt_per_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer warpgroup gives its registers to the consumers; its
    // first warp brings B_hi, B_lo and A of each k-tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      // A's boxes are always whole: TMA fills rows past M with zeros
      const uint32_t bytes = 2 * TG_B_BYTES + TG_A_BYTES;
      int s = 0;
      uint32_t phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        if (lane == 0) mbar_expect_tx(&full[s], bytes);
        __syncwarp();
        uint8_t* st = base + s * TG_STAGE_BYTES;
        const size_t b_off = ((size_t)nt * KT + kt) * TG_B_TILE;
        float* As = reinterpret_cast<float*>(st + 2 * TG_B_BYTES);
        if (lane == 0) bulk_copy(st, b_hi + b_off, TG_B_BYTES, &full[s]);
        if (lane == 1) bulk_copy(st + TG_B_BYTES, b_lo + b_off, TG_B_BYTES, &full[s]);
        if (lane >= 2 && lane < 2 + TG_BM / TG_A_BOX) {
          const int j = lane - 2;
          tma_load_2d(As + j * TG_A_BOX * TG_BK, &map_a, m0 + j * TG_A_BOX, kt * TG_BK, &full[s]);
        }
        if (++s == TG_STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 output rows x TG_BN columns
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int r0 = 64 * wg + 16 * (warp & 3) + g;  // the thread's rows r0 and r0 + 8
    float sum[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = acc[i] = 0.f;
    // the A fragments of two k-tiles, split: a tile's products read them
    // from registers while the next tile's are loaded
    uint32_t hi0[4][4] = {}, lo0[4][4] = {}, hi1[4][4] = {}, lo1[4][4] = {};
    int s = 0;
    uint32_t phase = 0;
    // k-tiles in pairs: both tiles' products go into the accumulator in two
    // groups back to back, then one wait, the two stages released and the
    // accumulator (64 k) promoted into the sum
    for (int kt = kt0; kt < kt1; kt += 2) {
      const bool pair = kt + 1 < kt1;
      const int s0 = s;
      issue_tile<0>(acc, hi0, lo0, base + s * TG_STAGE_BYTES, &full[s], phase, r0, t);
      if (++s == TG_STAGES) {
        s = 0;
        phase ^= 1;
      }
      if (pair) {
        issue_tile<1>(acc, hi1, lo1, base + s * TG_STAGE_BYTES, &full[s], phase, r0, t);
      }
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) hold(acc[i]);
      hold_fragments(hi0, lo0);
      hold_fragments(hi1, lo1);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s0]);
        if (pair) mbar_arrive(&empty[s]);
      }
      if (pair && ++s == TG_STAGES) {
        s = 0;
        phase ^= 1;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    // sum[4 j + q] is row r0 + 8 (q >> 1), column 8 j + 2 t + (q & 1)
    float* out = c + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
      }
    }
  }
}

// B = src^T (N, K) in the tiled layout, hi and lo, from src (K, N)
// row-major; rows n in [N, N padded to TG_BN) are written as zeros.
// Block (32, 8): a 32 x 32 patch, read along src's rows and written along
// B's k.
__global__ void __launch_bounds__(256)
    train_gemm_split_kernel(const float* __restrict__ src, int K, int N,
                            float* __restrict__ hi, float* __restrict__ lo) {
  __shared__ float patch[32][33];
  const int KT = K / TG_BK;
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 8 * i, n = n0 + tx;
    patch[ty + 8 * i][tx] = n < N ? src[(size_t)k * N + n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 8 * i, k = k0 + tx;
    uint32_t h, l;
    split_tf32(patch[tx][ty + 8 * i], h, l);
    const size_t at = b_index(n, k, KT);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// C = the sum of the `splits` partial products in ws, in split order
__global__ void __launch_bounds__(256)
    train_gemm_splitk_reduce_kernel(const float4* __restrict__ ws, float4* __restrict__ c,
                                    size_t n4, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 acc = ws[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = ws[(size_t)z * n4 + i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    c[i] = acc;
  }
}

// cuTensorMapEncodeTiled, a CUDA function outside the runtime, looked up
// through the runtime's entry point query: the library links nothing more
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// returned where cuTensorMapEncodeTiled refuses A's tensor map (no
// cudaError_t has it)
#define TG_ERROR_TENSOR_MAP 100000

// A's tensor map: A^T = h (K, M) row-major in boxes of TG_A_BOX rows x
// TG_BK k-lines; 128-byte rows in the 128-byte swizzle, zero-filled past M
static cudaError_t encode_a(CUtensorMap* map, const float* a, int M, int K) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<cudaError_t>(TG_ERROR_TENSOR_MAP);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)M * sizeof(float)};
  const cuuint32_t box[2] = {TG_A_BOX, TG_BK};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : static_cast<cudaError_t>(TG_ERROR_TENSOR_MAP + r);
}

static cudaError_t launch_product(const float* a, const float* b_hi, const float* b_lo,
                                  float* out, int M, int N, int K, int splits,
                                  cudaStream_t stream) {
  static bool configured = false;  // the opt-in to the shared memory, once a process
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        train_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap map_a;
  const cudaError_t e = encode_a(&map_a, a, M, K);
  if (e != cudaSuccess) return e;
  const int KT = K / TG_BK, per = (KT + splits - 1) / splits;
  const dim3 grid((N + TG_BN - 1) / TG_BN, (M + TG_BM - 1) / TG_BM, splits);
  train_gemm_kernel<<<grid, TG_THREADS, TG_SMEM_BYTES, stream>>>(map_a, b_hi, b_lo, out, M, N, K,
                                                                 per);
  return cudaGetLastError();
}

extern "C" {

// B_hi, B_lo (each padded N x K floats, N padded to TG_BN) of B = src^T
// from src (K, N) row-major (dY); K must be a multiple of TG_BK
int train_gemm_split(const float* src, int K, int N, float* hi, float* lo, void* stream) {
  if (K <= 0 || N <= 0 || K % TG_BK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(K / 32, (N + TG_BN - 1) / TG_BN * (TG_BN / 32));
  train_gemm_split_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      src, K, N, hi, lo);
  return (int)cudaGetLastError();
}

// c (M, N) = A . B^T: A^T = h (K, M) row-major; B from train_gemm_split.
// With splits > 1 the partial products go to `workspace` (splits x M x N
// floats) and are reduced into c.
int train_gemm(const float* a, const float* b_hi, const float* b_lo, float* c, float* workspace,
               int M, int N, int K, int splits, void* stream) {
  const int KT = K / TG_BK;
  if (M <= 0 || N <= 0 || K <= 0 || K % TG_BK != 0 || M % 4 != 0 || N % 4 != 0 ||
      splits < 1 || splits > KT || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? workspace : c;
  const cudaError_t e = launch_product(a, b_hi, b_lo, out, M, N, K, splits, s);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n4 = (size_t)M * N / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  train_gemm_splitk_reduce_kernel<<<blocks, 256, 0, s>>>(
      reinterpret_cast<const float4*>(workspace), reinterpret_cast<float4*>(c), n4, splits);
  return (int)cudaGetLastError();
}

const char* train_gemm_error_string(int code) {
  if (code >= TG_ERROR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused A's tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
