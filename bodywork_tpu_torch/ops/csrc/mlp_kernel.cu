// Fused MLP scoring forward with f32 weights for Hopper (sm_90a): the whole
// folded dense stack in ONE launch, f32-accurate products on the tensor
// cores as three TF32 mma.sync each ("3xTF32").
//
// Replaces the Pallas TPU kernel `_mlp_kernel` with f32 operands of
// `make_pallas_mlp_apply` in bodywork_tpu/ops/mlp_kernel.py (engine
// `pallas` -> `kernel`, the engine `auto` serves).
//
// What it computes: h = X; for each layer h = h . W_i + b_i with f32
// accumulation, ReLU between layers, the last layer linear; the output is
// column 0 of the last layer. The scaler is already folded into the first
// and last layers by the wrapper (ops/mlp_kernel.py fold_scaler_into_net).
//
// Products. One TF32 product keeps 11 significant bits of each operand
// (about 7e-4 of scale on the served stack: a different function). Each
// f32 operand is split in registers as hi = cvt.rna.tf32.f32(x) (its low 13
// bits masked) and lo = x - hi with its low 13 bits masked, and a product
// is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, small terms first; the dropped
// lo.lo term and lo's truncation are about 2^-21 of the product. Every term
// is one mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. The tensor
// cores' own accumulation truncates: over a 1024-long sum in one
// accumulator that read 1.7e-5 of scale on an H100, so each warp's
// products of at most 16 k go into a zeroed partial sum that meets the
// layer's accumulator in an f32 add (1.1e-6).
//
// Design (the skeleton of mlp_int8.cu).
//   - Grid: (row tiles of F_M = 32 rows) x (a thread-block cluster of C
//     CTAs). All C CTAs of a cluster own the same 32 rows; CTA c computes
//     its share of every layer's columns, in units of 64 columns
//     (ceil(units / C) consecutive units per CTA, at most F_MAX_UNITS).
//   - Activations: each CTA keeps its row tile's full layer input in
//     shared memory as f32, [k][r] (`act_slot`). After a layer's K loop a
//     cluster barrier waits until every peer has finished reading its
//     input; each CTA writes relu(acc + b) of its columns into its own
//     buffer, then copies those k-rows, one contiguous block, into every
//     peer's buffer through distributed shared memory (16-byte stores); a
//     second cluster barrier publishes the new input. No activation goes
//     to device memory.
//   - Weights: the wrapper pads each layer once per model to (K_pad,
//     N_pad) f32 (N to 64, the first K to F_KC) with zeros, which is exact.
//     Each CTA streams only its column slice from L2 into a ring of 2 or 3
//     stages (the wrapper picks the deepest that fits) with 16-byte
//     cp.async copies (`stage_slot`); the loads run stages - 1 chunks
//     ahead, across layer boundaries too. The ring stage is the B operand
//     itself: there is no second weight tile. A stage always holds F_KC x
//     F_STAGE_UNITS x 64 floats (32 KB): a slice of 8 units takes chunks
//     of 16 k-rows, a narrower one proportionally longer chunks (1 unit:
//     128 k-rows), so every chunk gives a busy warp the same work.
//   - Ring order: the products read the ring stage directly, so a stage
//     may be refilled only after every warp is done with it. Per chunk t:
//     wait until chunk t has landed, __syncthreads() (chunk t is visible,
//     and every warp has finished chunk t - 1), then issue the load of chunk
//     t + stages - 1 into the stage chunk t - 1 used, commit (an empty group
//     past the last chunk keeps the count), and compute. One barrier a chunk.
//   - Warps: warp w computes unit w % nu of the CTA's slice of nu units, a
//     32 x 64 block (2 m16 x 8 n8 tiles: 64 f32 accumulators a lane in the
//     m16n8 fragment layout, `frag_c_*`). A slice of fewer units than warps
//     splits each chunk's k8 steps over the warps of a unit (k part w /
//     nu), whose partial sums meet in shared memory after the layer, as in
//     mlp_int8.cu. Per k8 step a warp loads 2 A and 8 B fragments, splits
//     them and issues 48 mma.sync.
//   - Banks: an unswizzled fragment load puts the 4 lanes of a row group
//     (same g, k = t or t + 4) on one bank. `act_slot` XORs bits 3-4 of the
//     row, `stage_slot` bits 3-4 of the column (the 16-byte chunk index)
//     with k & 3, so every fragment load reads 32 different banks; every
//     writer (X staging, the epilogue, cp.async) goes through the same two
//     helpers.
//
// Bound on an H100 SXM at the slice's 4096-row bucket (1 -> 1024 -> 1024
// -> 1024 -> 1: 2,099,200 MACs a row, 17.2 GFLOP): operations. As FFMA on
// the CUDA cores, 0.2567 ms at the data sheet's 67 TFLOP/s f32; as 3xTF32,
// 3 x 17.2 GFLOP at 495 TFLOP/s dense TF32, 0.104 ms. The 8.4 MB of
// weights take 2.5 us at 3.35 TB/s. What holds this kernel above it
// (ablations on an H100): a 32-row tile reads its slice of every weight
// from L2, 1.07 GB at 4096 rows, which alone takes about as long as the
// products; and mma.sync with TF32 operands runs at little more than half
// the dense TF32 rate, less again inside the kernel's loop.
//
// Shared memory (the H100's 232,448 bytes a block may opt into): 32 * K_max
// * 4 bytes of activations (131,072 at width 1024) + stages x 32,768 bytes
// of ring. At width 1024 every cluster size takes 3 stages (229,376 bytes).
// The widest layer this kernel serves is 1280 features (2 stages: 163,840
// + 65,536 = 229,376 bytes, 5 units a CTA in clusters of 4 or more);
// ops/mlp_kernel.py `plan_smem_bytes` mirrors this sum, and the wrapper
// refuses a wider stack with ValueError.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (ops/_build.py). The C entry points launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cluster_common.cuh"

namespace cg = cooperative_groups;

#define F_M 32           // rows per tile
#define F_KC 16          // k-rows a stage holds of 8 units: two k8 steps
#define F_UNIT 64        // columns per unit
#define F_THREADS 256    // eight warps
#define F_WARPS 8
#define F_MAX_UNITS 8    // units per CTA per layer
#define F_STAGE_UNITS 8  // a ring stage holds F_KC k-rows of this many units
#define F_MIN_STAGES 2
#define F_MAX_STAGES 3

struct F32Stack {
  const float* w[MLP_MAX_LAYERS];  // (kp, np) row-major, zero padded
  const float* b[MLP_MAX_LAYERS];  // (np,), zero padded
  int kp[MLP_MAX_LAYERS];
  int np[MLP_MAX_LAYERS];
  int n_layers;
  int d_in;  // true feature count of X
};

// -- shared-memory layouts (tests/test_torch_mlp_f32.py reads these two
// -- one-line bodies). Each XORs bits 3-4 of the row (activations) or the
// -- column (a ring stage) with k & 3, so 4 aligned floats stay one 16-byte
// -- chunk, and adding a multiple of 4 to k moves the slot by whole k-rows.
// the layer input: row r of input feature k, F_M floats a k-row
__device__ __forceinline__ int act_slot(int k, int r) {
  return k * F_M + (r ^ ((k & 3) << 3));
}
// a ring stage: column c of k-row kk, `pitch` floats a k-row
__device__ __forceinline__ int stage_slot(int kk, int c, int pitch) {
  return kk * pitch + (c ^ ((kk & 3) << 3));
}

// -- fragments of mma.m16n8k8 with .tf32 operands (PTX ISA, "Matrix
// -- Fragments for mma.m16n8k8", the .tf32 figures); lane = 4 g + t
// A (16 x 8, row): a_i at row g + 8 (i & 1), k t + 4 (i >> 1)
__device__ __forceinline__ int frag_a_row(int lane, int i) { return (lane >> 2) + 8 * (i & 1); }
__device__ __forceinline__ int frag_a_k(int lane, int i) { return (lane & 3) + 4 * (i >> 1); }
// B (8 x 8, col): b_i at k t + 4 i, column g
__device__ __forceinline__ int frag_b_k(int lane, int i) { return (lane & 3) + 4 * i; }
__device__ __forceinline__ int frag_b_col(int lane) { return lane >> 2; }
// C and D (16 x 8, f32): c_i at row g + 8 (i >> 1), column 2 t + (i & 1)
__device__ __forceinline__ int frag_c_row(int lane, int i) { return (lane >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int frag_c_col(int lane, int i) { return 2 * (lane & 3) + (i & 1); }

// x rounded to TF32, nearest with ties away; cvt leaves the low 13 bits of
// its result unspecified, so they are cleared
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
// x = hi + lo, both TF32, to 2^-21 of x: hi is x rounded, x - hi is exact
// in f32, and lo is x - hi with its low 13 bits cleared (truncated: one
// instruction where cvt takes four, for half an ulp of lo more error)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
// d += a . b on the tensor cores
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// How a CTA runs layer l: its column slice `s`; chunks of `rows` k-rows (a
// ring stage holds F_KC x F_STAGE_UNITS x 64 floats, so a slice of nu units
// takes the largest power-of-two multiple of F_KC with rows x nu <= F_KC x
// F_STAGE_UNITS that divides K into whole chunks); and `ksplit` warps per
// unit, each taking every ksplit-th k8 step of a chunk, as far as their
// partial sums fit in the activation buffer
struct LayerPlan {
  Slice s;
  int rows;
  int ksplit;
};
__device__ __forceinline__ LayerPlan layer_plan(const F32Stack& S, int l, int rank, int C,
                                                int kmax) {
  LayerPlan p;
  p.s = slice_of<F_UNIT>(S.np[l], rank, C);
  const int nu = max(p.s.nu, 1);
  p.rows = F_KC;
  while (p.rows * 2 * nu <= F_KC * F_STAGE_UNITS && S.kp[l] % (p.rows * 2) == 0) p.rows *= 2;
  p.ksplit = 1;
  while (p.ksplit * 2 * nu <= F_WARPS && p.ksplit * 2 <= p.rows / 8 &&
         (p.ksplit * 2 - 1) * nu * F_UNIT * F_M <= kmax * F_M) {
    p.ksplit *= 2;
  }
  return p;
}

// The next ring chunk to load: k-chunk kc of layer l's column slice of this
// CTA, `rows` k-rows of per_row 16-byte copies. A thread's copies are
// copies tid, tid + F_THREADS, ... of the chunk; the loader walks them from
// (k-row kk0, copy c0) in steps of dk k-rows and dc copies, without a
// division per copy.
struct Loader {
  int l, kc, n_chunks, rows;
  const float* w;  // k-row 0 of layer l's slice
  int np, per_row, kk0, c0, dk, dc;
};

__device__ __forceinline__ void loader_layer(Loader& L, const F32Stack& S, int rank, int C,
                                             int kmax) {
  const LayerPlan p = layer_plan(S, L.l, rank, C, kmax);
  L.kc = 0;
  L.rows = p.rows;
  L.n_chunks = S.kp[L.l] / p.rows;
  L.np = S.np[L.l];
  L.w = S.w[L.l] + (size_t)p.s.u0 * F_UNIT;
  L.per_row = p.s.nu * (F_UNIT / 4);
  L.kk0 = L.rows;  // no copies for an empty slice
  if (L.per_row > 0) {
    L.kk0 = threadIdx.x / L.per_row;
    L.c0 = threadIdx.x - L.kk0 * L.per_row;
    L.dk = F_THREADS / L.per_row;
    L.dc = F_THREADS - L.dk * L.per_row;
  }
}

// issue this thread's copies of the next chunk into ring stage `dst` (nu x
// 64 floats a k-row; past the last layer: no copies), then step to the
// chunk after it
__device__ __forceinline__ void load_next(Loader& L, const F32Stack& S, int rank, int C,
                                          int kmax, float* dst) {
  if (L.l >= S.n_layers) return;
  const float* w = L.w + (size_t)L.kc * L.rows * L.np;
  const int pitch = 4 * L.per_row;
  for (int kk = L.kk0, c = L.c0; kk < L.rows;) {
    cp_async16(dst + stage_slot(kk, 4 * c, pitch), w + (size_t)kk * L.np + 4 * c);
    kk += L.dk;
    c += L.dc;
    if (c >= L.per_row) {
      c -= L.per_row;
      ++kk;
    }
  }
  if (++L.kc == L.n_chunks && ++L.l < S.n_layers) loader_layer(L, S, rank, C, kmax);
}

// One k8 step of a unit (32 rows x 64 columns: 2 m16 x 8 n8 tiles) into
// `part`: `ak` is the step's first k-row of the activations, `bk` of the
// ring stage (`pitch` floats a k-row); a_off and b_off are the lane's
// fragment offsets from those rows (act_slot(k0 + k, r) = k0 * F_M +
// act_slot(k, r) for k0 % 4 == 0, and stage_slot likewise). Each operand is
// split in registers; the small terms go first, each term over every tile
// before the next.
__device__ __forceinline__ void k8_products(float (&part)[2][8][4], const float* ak,
                                            const float* bk, const int (&a_off)[2][2],
                                            const int (&b_off)[8], int pitch) {
  uint32_t ahi[2][4], alo[2][4], bhi[8][2], blo[8][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_tf32(ak[4 * (i >> 1) * F_M + a_off[mt][i & 1]], ahi[mt][i], alo[mt][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tf32(bk[4 * i * pitch + b_off[j]], bhi[j][i], blo[j][i]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j], alo[mt], bhi[j][0], bhi[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j], ahi[mt], blo[j][0], blo[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j], ahi[mt], bhi[j][0], bhi[j][1]);
  }
}

__device__ __forceinline__ void zero_tile(float (&t)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) t[mt][j][i] = 0.0f;
    }
  }
}
__device__ __forceinline__ void add_tile(float (&acc)[2][8][4], const float (&part)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[mt][j][i];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS, 1)
mlp_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int n_rows, F32Stack S,
               int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / C) * F_M;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* act = reinterpret_cast<float*>(smem_raw);
  int kmax = 0;
  for (int l = 0; l < S.n_layers; ++l) kmax = max(kmax, S.kp[l]);
  float* ring = act + (size_t)kmax * F_M;
  const int stage_floats = F_KC * F_STAGE_UNITS * F_UNIT;

  // stage this tile's rows of X; rows past the batch and features past
  // d_in are zero
  for (int i = tid; i < F_M * S.kp[0]; i += F_THREADS) {
    const int k = i / F_M;
    const int r = i - k * F_M;
    const int row = row0 + r;
    act[act_slot(k, r)] = (row < n_rows && k < S.d_in) ? x[(size_t)row * S.d_in + k] : 0.0f;
  }

  // chunk t of the stack (every layer's chunks in turn) sits in ring stage
  // t % stages; the loader runs stages - 1 chunks ahead
  Loader L;
  L.l = 0;
  loader_layer(L, S, rank, C, kmax);
  for (int i = 0; i < stages - 1; ++i) {
    load_next(L, S, rank, C, kmax, ring + i * stage_floats);
    cp_async_commit();
  }
  int use = 0, fill = stages - 1;  // stages of the chunk in use and of the next load

  for (int l = 0; l < S.n_layers; ++l) {
    const LayerPlan p = layer_plan(S, l, rank, C, kmax);
    const int nu = p.s.nu;
    // warp w computes unit w % nu over k part w / nu, if that is < ksplit
    const int unit = nu > 0 ? warp % nu : 0;
    const int kpart = nu > 0 ? warp / nu : p.ksplit;
    const bool busy = kpart < p.ksplit;
    const int pitch = nu * F_UNIT;  // floats a stage k-row for this layer
    const int steps = p.rows / 8;   // k8 steps a chunk
    int a_off[2][2], b_off[8];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a_off[mt][h] = act_slot(frag_a_k(lane, h), 16 * mt + frag_a_row(lane, h));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b_off[j] = stage_slot(frag_b_k(lane, 0), unit * F_UNIT + 8 * j + frag_b_col(lane), pitch);
    }
    float acc[2][8][4];
    zero_tile(acc);

    // Per chunk: wait until this thread's copies of it have landed; one
    // barrier (every thread's copies are visible, and every warp is done
    // with the previous chunk, whose stage the next load refills); issue
    // the next load (an empty group past the last chunk keeps the count);
    // the products. The tensor cores' own accumulation truncates, so each
    // warp's products of up to 16 k (two k8 steps) go into `part` and meet
    // `acc` in an f32 add.
    for (int kc = 0; kc < S.kp[l] / p.rows; ++kc) {
      cp_async_wait(stages - 2);
      __syncthreads();
      load_next(L, S, rank, C, kmax, ring + fill * stage_floats);
      cp_async_commit();
      if (busy) {
        const float* ak = act + (size_t)kc * p.rows * F_M;
        const float* st = ring + use * stage_floats;
        // the warp's k8 steps of the chunk are kpart, kpart + ksplit, ...,
        // two at a time into one partial sum (one pair for most layers)
        for (int s8 = kpart; s8 < steps; s8 += 2 * p.ksplit) {
          float part[2][8][4];
          zero_tile(part);
          k8_products(part, ak + 8 * s8 * F_M, st + 8 * s8 * pitch, a_off, b_off, pitch);
          const int s8b = s8 + p.ksplit;
          if (s8b < steps) {
            k8_products(part, ak + 8 * s8b * F_M, st + 8 * s8b * pitch, a_off, b_off, pitch);
          }
          add_tile(acc, part);
        }
      }
      use = use + 1 == stages ? 0 : use + 1;
      fill = fill + 1 == stages ? 0 : fill + 1;
    }
    if (p.ksplit > 1) {
      // every warp is done reading this layer's input: it holds the k
      // parts' sums, [k part - 1][unit][value][lane], for the unit's owner
      // (warp `unit`) to add up
      __syncthreads();
      if (busy && kpart > 0) {
        float* part = act + ((size_t)(kpart - 1) * nu + unit) * F_UNIT * F_M + lane;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) part[((mt * 8 + j) * 4 + i) * 32] = acc[mt][j][i];
          }
        }
      }
      __syncthreads();
      if (warp < nu) {
        for (int q = 1; q < p.ksplit; ++q) {
          const float* part = act + ((size_t)(q - 1) * nu + unit) * F_UNIT * F_M + lane;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[((mt * 8 + j) * 4 + i) * 32];
            }
          }
        }
      }
    }

    const float* __restrict__ bias = S.b[l];
    if (l + 1 == S.n_layers) {
      // column 0 of the last layer is the prediction: n8 tile 0 of unit 0,
      // owned by warp 0 of rank 0, in the lanes with t = 0 (c_0 and c_2 of
      // each m16 tile)
      if (rank == 0 && warp == 0 && (lane & 3) == 0) {
        const float b0 = bias[0];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; i += 2) {
            const int row = row0 + 16 * mt + frag_c_row(lane, i);
            if (row < n_rows) out[row] = acc[mt][0][i] + b0;
          }
        }
      }
      break;
    }

    // every peer has finished reading its current input
    cluster.sync();
    if (warp < nu) {
      const int col = (p.s.u0 + unit) * F_UNIT;  // the unit's first k of the next layer
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = col + 8 * j + frag_c_col(lane, i);
          const float bk = bias[k];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            act[act_slot(k, 16 * mt + frag_c_row(lane, i))] = fmaxf(acc[mt][j][i] + bk, 0.0f);
          }
        }
      }
    }
    __syncthreads();
    // this CTA's columns are k-rows [u0 * 64, (u0 + nu) * 64) of the next
    // input, one contiguous block: copy it into every peer
    if (nu > 0) {
      const size_t off = (size_t)p.s.u0 * F_UNIT * F_M;
      const float4* src = reinterpret_cast<const float4*>(act + off);
      const int n4 = nu * F_UNIT * F_M / 4;
      for (int q = 1; q < C; ++q) {
        float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(act, (rank + q) % C) + off);
        for (int i = tid; i < n4; i += F_THREADS) dst[i] = src[i];
      }
    }
    // the new input is complete in every CTA of the cluster
    cluster.sync();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

static size_t smem_bytes_for(const F32Stack& S, int stages) {
  int kmax = 0;
  for (int l = 0; l < S.n_layers; ++l) kmax = kmax > S.kp[l] ? kmax : S.kp[l];
  return ((size_t)kmax * F_M + (size_t)stages * F_KC * F_STAGE_UNITS * F_UNIT) * sizeof(float);
}

extern "C" {

// one forward of the padded stack over n_rows rows of x (n_rows, d_in) f32
// into out (n_rows,) f32, in clusters of `cluster` CTAs with a weight ring
// of `stages` stages. smem_bytes is the wrapper's reckoning of the dynamic
// shared memory; it must cover the kernel's own.
int mlp_f32_forward(const float* x, float* out, int n_rows, int n_layers, int d_in,
                    const int* kp, const int* np, void* const* w, void* const* b, int cluster,
                    int stages, int smem_bytes, void* stream) {
  if (!stack_ok(n_rows, n_layers, d_in, kp, np, cluster, F_KC, F_UNIT, F_MAX_UNITS) ||
      stages < F_MIN_STAGES || stages > F_MAX_STAGES) {
    return (int)cudaErrorInvalidValue;
  }
  F32Stack S;
  S.n_layers = n_layers;
  S.d_in = d_in;
  for (int l = 0; l < n_layers; ++l) {
    S.kp[l] = kp[l];
    S.np[l] = np[l];
    S.w[l] = static_cast<const float*>(w[l]);
    S.b[l] = static_cast<const float*>(b[l]);
  }
  const size_t smem = smem_bytes_for(S, stages);
  if ((size_t)smem_bytes < smem) return (int)cudaErrorInvalidValue;
  return (int)launch_clusters(mlp_f32_kernel, F_THREADS, n_rows, F_M, cluster, smem, stream,
                              x, out, n_rows, S, stages);
}

// how many clusters of `cluster` CTAs with smem_bytes of dynamic shared
// memory each can be resident at once on the current device (0: the
// configuration cannot run); a negative value is -cudaError
int mlp_f32_max_active_clusters(int cluster, int smem_bytes) {
  return max_active_clusters(mlp_f32_kernel, F_THREADS, cluster, smem_bytes);
}

const char* mlp_f32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
