// Fused MLP scoring forward with bf16 weights for Hopper (sm_90a): the
// whole folded dense stack in ONE launch, on the tensor cores (wgmma).
//
// Replaces the bf16 variant of the Pallas TPU kernel `make_pallas_mlp_apply`
// in bodywork_tpu/ops/mlp_kernel.py (`_mlp_kernel` with operand_dtype
// bf16, engine `pallas-bf16` -> `kernel-bf16`).
//
// What it computes: h = X; for each layer h = bf16(h) . W_i + b_i with
// bf16 x bf16 products accumulated in f32, ReLU between layers (f32), the
// last layer linear; the output is column 0 of the last layer. A bf16
// product is exact in f32, so the tensor cores' f32 accumulation keeps the
// Pallas arithmetic up to summation order.
//
// Design.
//   - Grid: (row tiles of BF_M = 64 rows) x (a thread-block cluster of C
//     CTAs). All C CTAs of a cluster own the same 64 rows; CTA c computes
//     its share of every layer's columns, in units of 64 columns
//     (ceil(units / C) consecutive units per CTA, at most BF_MAX_UNITS).
//   - Activations: each CTA keeps its row tile's full layer input in
//     shared memory as bf16, in the 128-byte-swizzled K-major layout that
//     the wgmma descriptors read (one 8 KB atom of 64 rows x 64 k per 64
//     input features). Storing the input rounded to bf16 loses nothing:
//     the Pallas arithmetic rounds it there anyway. After a layer's K loop
//     its outputs are still in registers; a cluster barrier waits until
//     every peer has finished reading the old input, each CTA writes
//     bf16(relu(acc + b)) of its columns into its own input buffer (its
//     64-column units are whole 8 KB atoms of the next layer's input),
//     and one thread sends that run of bytes to every peer's buffer with
//     one bulk copy through distributed shared memory per peer, which
//     completes on the peer's exchange mbarrier. No activation goes to
//     device memory, and one buffer suffices.
//   - Weights: the wrapper prepares, once per model, a K-major copy of
//     each layer, W^T (N_pad, K_pad), zero-padded to multiples of 64 (the
//     last layer's N = 1 and the first layer's K = 1 included; zero
//     padding is exact), cut into 8 KB tiles of 64 columns x 64 k stored
//     in the 128-byte swizzle already, ordered (k chunk, column unit). A
//     CTA's slice of one k chunk is then one contiguous run of bytes, which
//     one thread copies from L2 into a ring of 2-6 shared-memory stages
//     (as many as fit) with one bulk asynchronous copy (cp.async.bulk, the
//     TMA engine) completing on the stage's mbarrier. The ring runs ahead
//     of the products, across layer boundaries too, and a stage is
//     recycled as soon as the group of products that read it retires.
//   - Products: two consumer warpgroups (256 threads). A ring stage holds
//     up to 4 of the CTA's units: a CTA with 5-8 units splits them over
//     two steps per k-chunk, as evenly as it can (3 + 2 up to 4 + 4). Of
//     a step's units warpgroup g owns units g and g + 2, each an m64n64k16
//     wgmma with A (the activations) and B (the weight slice) both read
//     from shared memory. The f32 accumulators (at most 128 a thread) stay
//     in registers, and one stage's group of products stays in flight
//     while the warpgroups wait for the next stage: a stage is recycled
//     after `wgmma.wait_group 1`, which retires the group that read it
//     only if the warpgroup committed a group in every step since. The
//     even split guarantees that: within a layer a warpgroup has units in
//     every step or in none (a step of 2-4 units gives both warpgroups
//     one), so no warpgroup skips a step with a group still in flight.
//
// Bound on an H100 SXM at the slice's 4096-row bucket (1 -> 1024 -> 1024
// -> 1024 -> 1: 2,099,200 MACs a row, 17.2 GFLOP): 17 us at the tensor
// cores' 989 TFLOP/s; the 4.2 MB of bf16 weights take 1.3 us at 3.35 TB/s,
// so operations bound it. A 256-row request is bound by bytes (1.3 us).
// The design keeps the tensor cores fed from shared memory; what it does
// not do yet (a producer warp, multicast of weight tiles to the clusters
// of other row tiles, larger wgmma tiles) is later work.
//
// Shared memory: 64 * K_max * 2 bytes of activations + S stages x
// min(units per CTA, 4) x 8 KB of weights + 1088 bytes of alignment slack
// and mbarriers; the wrapper picks the most stages S (2 to 6) that fit.
// With the H100's 232,448 bytes a block may opt into, the widest layer
// this kernel serves is 1536 features (24 units, 2 per CTA in clusters of
// 16: 1088 + 196,608 + 2 x 2 x 8192 = 230,464 bytes); ops/mlp_kernel.py
// `plan_smem_bytes` mirrors this sum, and the wrapper refuses a wider
// stack with ValueError.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (ops/_build.py). The C entry points launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cluster_common.cuh"

namespace cg = cooperative_groups;

#define BF_M 64           // rows per tile: the wgmma M
#define BF_KC 64          // k per ring stage: one 128-byte swizzle row
#define BF_UNIT 64        // columns per wgmma (m64n64k16)
#define BF_THREADS 256    // two warpgroups
#define BF_MAX_UNITS 8    // units per CTA per layer (4 per warpgroup)
#define BF_STAGE_UNITS 4  // units one ring stage holds: a k-chunk of a wider
                          // slice is two steps, its units split evenly
#define BF_MIN_STAGES 2   // weight ring stages: the wrapper picks as many as
#define BF_MAX_STAGES 6   // fit beside the activations
#define BF_ATOM 8192      // one 64-row x 128-byte swizzle atom block
#define BF_SLACK 1088     // 1024-byte alignment + the mbarriers (<= 8)

struct Bf16Stack {
  // (kp / 64, np / 64) tiles of BF_ATOM bytes: W^T's 64 columns x 64 k,
  // zero padded, rows pre-swizzled
  const uint8_t* wt[MLP_MAX_LAYERS];
  const float* b[MLP_MAX_LAYERS];           // (np,), zero padded
  int kp[MLP_MAX_LAYERS];                   // K padded to BF_KC
  int np[MLP_MAX_LAYERS];                   // N padded to BF_UNIT
  int n_layers;
  int d_in;  // true feature count of X
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset -> its place under the 128-byte swizzle (16-byte chunk
// index XOR row index within the 8-row, 1024-byte atom)
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ ((off >> 3) & 0x70u);
}

// where activation (row r, feature k) lives in the A buffer
__device__ __forceinline__ uint32_t act_off(int r, int k) {
  return (uint32_t)(k / BF_KC) * BF_ATOM +
         swz((uint32_t)r * 128u + (uint32_t)(k % BF_KC) * 2u);
}

// wgmma shared-memory descriptor, K-major, 128-byte swizzle: rows 128 B
// apart, 8-row groups 1024 B apart (SBO); LBO is unused for this layout
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
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
// all but the most recent group of products have retired
__device__ __forceinline__ void wgmma_wait_prev() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// order this thread's generic-proxy writes to its CTA's shared memory
// before async-proxy reads of them (wgmma, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
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
// one bulk asynchronous copy global -> this CTA's shared memory, counted
// against `bar`'s expected transaction bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the address of `p` in the shared memory of cluster CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
// one bulk copy from this CTA's shared memory to a peer's (both at
// shared::cluster addresses), counted against the peer's mbarrier
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, const void* src,
                                                  uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the steps of one k-chunk of a CTA's slice of nu units: one per
// BF_STAGE_UNITS of them (at least one, so that every CTA walks every
// k-chunk)
__device__ __forceinline__ int groups_of(int nu) {
  return max(1, (nu + BF_STAGE_UNITS - 1) / BF_STAGE_UNITS);
}
// the most units of one step: the slice split evenly over its steps (step
// g holds units g * per .. min(nu, (g + 1) * per) - 1), so that with two
// steps each holds at least 2 units
__device__ __forceinline__ int per_step(int nu) {
  const int groups = groups_of(nu);
  return (nu + groups - 1) / groups;
}

// (one thread) start the copy of `bytes` of weight tiles from `src` into
// ring stage `dst`, completing on `bar` (which expects them, even 0)
__device__ __forceinline__ void issue_copy(const uint8_t* src, uint32_t bytes, uint8_t* dst,
                                           uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  if (bytes > 0) bulk_copy(dst, src, bytes, bar);
}

// issue (and commit as one group) the m64n64k16 products of one ring
// stage for a warpgroup that owns N_UNITS of its units (units wg and
// wg + 2 of the stage, into accumulators a0 and a1)
template <int N_UNITS>
__device__ __forceinline__ void issue_products(float (&a0)[32], float (&a1)[32],
                                               const uint8_t* a_blk, const uint8_t* b_stage,
                                               int wg) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BF_KC / 16; ++kk) {
    const uint64_t da = smem_desc(a_blk + kk * 32);
    wgmma_m64n64k16(a0, da, smem_desc(b_stage + (size_t)wg * BF_ATOM + kk * 32));
    if (N_UNITS == 2) {
      wgmma_m64n64k16(a1, da, smem_desc(b_stage + (size_t)(wg + 2) * BF_ATOM + kk * 32));
    }
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(BF_THREADS, 1)
mlp_bf16_kernel(const float* __restrict__ x, float* __restrict__ out,
                int n_rows, Bf16Stack S, int stage_units, int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / C) * BF_M;
  const int tid = threadIdx.x;
  const int wg = tid / 128;        // warpgroup
  const int warp = (tid / 32) & 3;  // warp within the warpgroup
  const int lane = tid & 31;

  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must sit on 1024-byte boundaries of the shared window
  uint8_t* act = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  int kmax = 0;
  for (int l = 0; l < S.n_layers; ++l) kmax = max(kmax, S.kp[l]);
  uint8_t* ring = act + (size_t)kmax * BF_M * 2;
  const size_t stage_bytes = (size_t)stage_units * BF_ATOM;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* exchanged = full + stages;  // the peers' slices of the next input

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    mbar_init(exchanged, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // stage this tile's rows of X, rounded to bf16; rows past the batch and
  // features past d_in are zero
  {
    const int kp0 = S.kp[0];
    for (int i = tid; i < BF_M * kp0; i += BF_THREADS) {
      const int r = i / kp0;
      const int k = i - r * kp0;
      const int row = row0 + r;
      const float v = (row < n_rows && k < S.d_in) ? x[(size_t)row * S.d_in + k] : 0.0f;
      *reinterpret_cast<__nv_bfloat16*>(act + act_off(r, k)) = __float2bfloat16_rn(v);
    }
  }
  fence_proxy_async();
  __syncthreads();

  // thread 0 keeps the ring's copies ahead of the products, across layer
  // boundaries: ring step t goes to stage t % stages. Its cursor is the
  // next copy's layer, k-chunk and step, with that layer's slice and split
  int ll = 0, lk = 0, lg = 0;
  Slice ls = slice_of<BF_UNIT>(S.np[0], rank, C);
  int lsteps = groups_of(ls.nu), lper = per_step(ls.nu);
  auto issue_next = [&](int st) {
    if (ll < S.n_layers) {
      const int first = lg * lper;
      const int count = max(0, min(lper, ls.nu - first));
      const size_t tile = (size_t)lk * (S.np[ll] / BF_UNIT) + ls.u0 + first;
      issue_copy(S.wt[ll] + tile * BF_ATOM, (uint32_t)count * BF_ATOM, ring + st * stage_bytes,
                 &full[st]);
      if (++lg == lsteps) {
        lg = 0;
        if (++lk == S.kp[ll] / BF_KC) {
          lk = 0;
          if (++ll < S.n_layers) {
            ls = slice_of<BF_UNIT>(S.np[ll], rank, C);
            lsteps = groups_of(ls.nu);
            lper = per_step(ls.nu);
          }
        }
      }
    }
  };
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) issue_next(st);
  }

  // accumulator slot a holds unit wg + 2 (a % 2) of step a / 2, the
  // slice's unit (a / 2) * per + wg + 2 (a % 2)
  float acc[4][32];
  int t = 0;  // steps consumed
  for (int l = 0; l < S.n_layers; ++l) {
    const Slice s = slice_of<BF_UNIT>(S.np[l], rank, C);
    const int groups = groups_of(s.nu);
    const int per = per_step(s.nu);
    const int in0 = min(per, s.nu), in1 = s.nu - per;  // units of steps 0 and 1
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[a][j] = 0.0f;
    }
    // one group of products stays in flight while the next stage's wait,
    // barrier and copy run; a stage is recycled once its group retired
    int pending = -1;  // the stage of the group that may be in flight
    const int n_chunks = S.kp[l] / BF_KC;
    for (int step = 0; step < n_chunks * groups; ++step, ++t) {
      const int kc = step / groups;
      const int g = step - kc * groups;
      const int st = t % stages;
      mbar_wait(&full[st], (uint32_t)(t / stages) & 1u);
      const uint8_t* a_blk = act + (size_t)kc * BF_ATOM;
      const uint8_t* b_stage = ring + st * stage_bytes;
      const int in_stage = g == 0 ? in0 : in1;
      if (g == 0) {
        if (wg + 2 < in_stage) {
          issue_products<2>(acc[0], acc[1], a_blk, b_stage, wg);
        } else if (wg < in_stage) {
          issue_products<1>(acc[0], acc[1], a_blk, b_stage, wg);
        }
      } else {
        if (wg + 2 < in_stage) {
          issue_products<2>(acc[2], acc[3], a_blk, b_stage, wg);
        } else if (wg < in_stage) {
          issue_products<1>(acc[2], acc[3], a_blk, b_stage, wg);
        }
      }
      // a warpgroup with units in this step had units in the previous one
      // (the even split), so this retires every group that read stage
      // `pending`, and its copy may overwrite it
      wgmma_wait_prev();
      __syncthreads();
      if (tid == 0 && pending >= 0) issue_next(pending);
      pending = st;
    }
    wgmma_wait_all();
    // every product of this layer has retired: its last stage is free and
    // its input is no longer read
    __syncthreads();
    if (tid == 0) issue_next(pending);

    const float* __restrict__ bias = S.b[l];
    if (l + 1 == S.n_layers) {
      // column 0 of the last layer is the prediction: unit 0 of rank 0,
      // accumulator d[0] / d[2] of the lanes with lane % 4 == 0
      if (rank == 0 && wg == 0 && (lane & 3) == 0) {
        const float b0 = bias[0];
        const int r = warp * 16 + (lane >> 2);
        if (row0 + r < n_rows) out[row0 + r] = acc[0][0] + b0;
        if (row0 + r + 8 < n_rows) out[row0 + r + 8] = acc[0][2] + b0;
      }
      break;
    }

    // expect the peers' slices of the next input, then wait until every
    // peer has finished reading its current input (and expects ours)
    if (tid == 0) {
      mbar_expect_tx(exchanged, (uint32_t)(S.np[l] / BF_UNIT - s.nu) * BF_ATOM);
    }
    cluster.sync();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (wg + 2 * (a % 2) >= (a < 2 ? in0 : in1)) continue;
      const int unit = (a / 2) * per + wg + 2 * (a % 2);
      const int col_base = (s.u0 + unit) * BF_UNIT + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int col = col_base + (i >> 2) * 8;
        const float v0 = fmaxf(acc[a][i] + bias[col], 0.0f);
        const float v1 = fmaxf(acc[a][i + 1] + bias[col + 1], 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(act + act_off(r, col)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_proxy_async();
    __syncthreads();
    // this CTA's units are atoms u0 .. u0 + nu - 1 of the next input
    if (tid == 0 && s.nu > 0) {
      const uint8_t* slice = act + (size_t)s.u0 * BF_ATOM;
      for (int p = 0; p < C; ++p) {
        if (p == rank) continue;
        bulk_copy_to_peer(peer_addr(slice, p), slice, (uint32_t)s.nu * BF_ATOM,
                          peer_addr(exchanged, p));
      }
    }
    mbar_wait(exchanged, (uint32_t)l & 1u);
  }
  // no CTA leaves while a peer may still read its shared memory
  cluster.sync();
}

// dynamic shared memory of one CTA, and the units one ring stage holds
static size_t smem_bytes_for(const Bf16Stack& S, int C, int stages, int* stage_units) {
  int kmax = 0, units = 0;
  for (int l = 0; l < S.n_layers; ++l) {
    kmax = kmax > S.kp[l] ? kmax : S.kp[l];
    const int u = (S.np[l] / BF_UNIT + C - 1) / C;
    units = units > u ? units : u;
  }
  *stage_units = units < BF_STAGE_UNITS ? units : BF_STAGE_UNITS;
  return BF_SLACK + (size_t)kmax * BF_M * 2 + (size_t)stages * *stage_units * BF_ATOM;
}

extern "C" {

// one forward of the padded stack over n_rows rows of x (n_rows, d_in) f32
// into out (n_rows,) f32, in clusters of `cluster` CTAs. smem_bytes is the
// wrapper's reckoning of the dynamic shared memory; it must cover the
// kernel's own.
int mlp_bf16_forward(const float* x, float* out, int n_rows, int n_layers,
                     int d_in, const int* kp, const int* np, void* const* wt,
                     void* const* b, int cluster, int stages, int smem_bytes,
                     void* stream) {
  if (!stack_ok(n_rows, n_layers, d_in, kp, np, cluster, BF_KC, BF_UNIT, BF_MAX_UNITS) ||
      stages < BF_MIN_STAGES || stages > BF_MAX_STAGES) {
    return (int)cudaErrorInvalidValue;
  }
  Bf16Stack S;
  S.n_layers = n_layers;
  S.d_in = d_in;
  for (int l = 0; l < n_layers; ++l) {
    S.kp[l] = kp[l];
    S.np[l] = np[l];
    S.wt[l] = static_cast<const uint8_t*>(wt[l]);
    S.b[l] = static_cast<const float*>(b[l]);
  }
  int stage_units = 0;
  const size_t smem = smem_bytes_for(S, cluster, stages, &stage_units);
  if ((size_t)smem_bytes < smem) return (int)cudaErrorInvalidValue;
  return (int)launch_clusters(mlp_bf16_kernel, BF_THREADS, n_rows, BF_M, cluster, smem, stream,
                              x, out, n_rows, S, stage_units, stages);
}

// how many clusters of `cluster` CTAs with smem_bytes of dynamic shared
// memory each can be resident at once on the current device (0: the
// configuration cannot run); a negative value is -cudaError
int mlp_bf16_max_active_clusters(int cluster, int smem_bytes) {
  return max_active_clusters(mlp_bf16_kernel, BF_THREADS, cluster, smem_bytes);
}

const char* mlp_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
