// Fused MLP scoring forward with int8 weights for Hopper (sm_90a): the
// whole folded dense stack in ONE launch, f32 FMA over int8 weight tiles
// staged in shared memory.
//
// Replaces the Pallas TPU kernel `_mlp_kernel_int8` of
// `make_pallas_mlp_apply` in bodywork_tpu/ops/mlp_kernel.py (engine
// `pallas-int8` -> `kernel-int8`).
//
// What it computes: h = X; for each layer w = f32(q) * scale[col] (one f32
// multiply, as the Pallas kernel dequantizes before its dot), h = h . w +
// b in f32, ReLU between layers, the last layer linear; the output is
// column 0 of the last layer. The activations stay f32: int8 tensor cores
// would need int8 activations and TF32 would round them to 10 bits, both a
// different function, so the products run on the CUDA cores.
//
// Design.
//   - Grid: (row tiles of I8_M = 32 rows) x (a thread-block cluster of C
//     CTAs). All C CTAs of a cluster own the same 32 rows; CTA c computes
//     its share of every layer's columns, in units of 64 columns
//     (ceil(units / C) consecutive units per CTA, at most I8_MAX_UNITS).
//   - Activations: each CTA keeps its row tile's full layer input in
//     shared memory as f32, transposed ([k][r]), so 8 rows of input
//     feature k are two float4 reads. After a layer's K loop its outputs
//     are still in registers; a cluster barrier waits until every peer has finished
//     reading the old input, each CTA writes relu(acc + b) of its columns
//     into the input buffer of EVERY CTA of the cluster through
//     distributed shared memory (16-byte stores), and a second cluster
//     barrier publishes the new input. No activation goes to device
//     memory, and one buffer suffices.
//   - Weights: the wrapper prepares, once per model, each layer's int8
//     (K_pad, N_pad) matrix, zero-padded (N to 64, K to the previous
//     layer's N_pad or, for the first layer, to I8_KC) with scale 1 and
//     bias 0 on padded columns, so padded outputs are exactly 0. Each CTA
//     streams only its column slice, 32 k-rows at a time, from L2 into a
//     two-stage shared-memory ring with 16-byte cp.async copies; the next
//     stage (across layer boundaries too) loads while the current one
//     computes.
//   - Dequantization: once a ring stage has landed, the CTA dequantizes
//     it into an f32 weight tile in shared memory, each weight once
//     (__fmul_rn(float(q), scale), the Pallas value; float(q) by byte
//     permute and one add, exact, instead of the quarter-rate I2F): once
//     per CTA, i.e. once per 32 rows, for only the CTA's N/C columns.
//   - Register tile: warp w owns unit w of the CTA's slice (a slice of
//     fewer units than warps splits each k-chunk over the warps of a unit,
//     whose partial sums meet in shared memory after the layer); lane
//     (row group g = lane / 8, column group c = lane % 8) owns rows
//     8g..8g+7 and columns 4c..4c+3 and 32+4c..35+4c of it (64 f32
//     accumulators). Per k it
//     reads two float4 of activations and two float4 of weights and does
//     64 FMAs: 68 instructions for 64 FMAs, and few shared-memory
//     wavefronts, since the lanes of a row group share their activations
//     and those of a column group share their weights.
//
// Bound on an H100 SXM at the slice's 4096-row bucket (1 -> 1024 -> 1024
// -> 1024 -> 1: 2,099,200 MACs a row, 17.2 GFLOP): the work is f32 FMA on
// the CUDA cores, so operations bound it, 0.26 ms at the data sheet's 67
// TFLOP/s; the 2.1 MB of int8 weights take 0.6 us at 3.35 TB/s.
//
// Shared memory: 32 * K_max * 4 bytes of activations + per unit of the
// CTA's widest slice 2 int8 stages (2 x 32 x 64 bytes) and one f32 tile
// (32 x 64 x 4 bytes). With the H100's 232,448 bytes a block may opt
// into, the widest layer this kernel serves is 1600 features (25 units, 2
// per CTA in clusters of 16: 204,800 + 2 x (2 x 2048 + 8192) = 229,376
// bytes); ops/mlp_kernel.py `plan_smem_bytes` mirrors this sum, and the
// wrapper refuses a wider stack with ValueError.
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

#define I8_M 32          // rows per tile
#define I8_KC 32         // k-rows per ring stage
#define I8_UNIT 64       // columns per warp
#define I8_THREADS 256   // eight warps
#define I8_MAX_UNITS 8   // units per CTA per layer (one per warp)
#define I8_STAGES 2

struct Int8Stack {
  const int8_t* w[MLP_MAX_LAYERS];       // (kp, np) row-major, zero padded
  const float* b[MLP_MAX_LAYERS];        // (np,), zero padded
  const float* scale[MLP_MAX_LAYERS];    // (np,), 1 on padded columns
  int kp[MLP_MAX_LAYERS];
  int np[MLP_MAX_LAYERS];
  int n_layers;
  int d_in;  // true feature count of X
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// float(q) for one signed byte of `word` (byte_perm selector 0x744b picks
// byte b), exactly, without the quarter-rate I2F: the byte biased by 128
// becomes the low bits of 2^23 + 128 + q, from which 2^23 + 128 is taken
__device__ __forceinline__ float int8_to_float(uint32_t word, uint32_t selector) {
  const uint32_t bits = __byte_perm(word ^ 0x80808080u, 0x4B000000u, selector);
  return __int_as_float((int)bits) - 8388736.0f;
}

// issue the cp.async copies of layer l's k-chunk kc of this CTA's column
// slice into ring stage `dst` ([kk][slice column], row stride `pitch`)
__device__ __forceinline__ void load_chunk(const Int8Stack& S, int l, int kc,
                                           int rank, int C, uint8_t* dst,
                                           int pitch) {
  const Slice s = slice_of<I8_UNIT>(S.np[l], rank, C);
  const int np = S.np[l];
  const int8_t* w = S.w[l] + (size_t)kc * I8_KC * np + (size_t)s.u0 * I8_UNIT;
  const int per_row = s.nu * (I8_UNIT / 16);  // 16-byte chunks a k-row
  const int n_copies = I8_KC * per_row;
  for (int i = threadIdx.x; i < n_copies; i += I8_THREADS) {
    const int kk = i / per_row;
    const int ch = i - kk * per_row;
    cp_async16(dst + (size_t)kk * pitch + ch * 16, w + (size_t)kk * np + ch * 16);
  }
}

__global__ void __launch_bounds__(I8_THREADS, 1)
mlp_int8_kernel(const float* __restrict__ x, float* __restrict__ out,
                int n_rows, Int8Stack S, int ring_units) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / C) * I8_M;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int rg = lane >> 3;  // rows 8 rg .. 8 rg + 7
  const int cg8 = lane & 7;  // columns 4 cg8 + {0..3, 32..35} of the warp's unit

  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* act = reinterpret_cast<float*>(smem_raw);  // [k][r]
  int kmax = 0;
  for (int l = 0; l < S.n_layers; ++l) kmax = max(kmax, S.kp[l]);
  const int pitch = ring_units * I8_UNIT;  // columns of a stage / tile row
  float* wf = act + (size_t)kmax * I8_M;   // [kk][column] dequantized tile
  uint8_t* ring = reinterpret_cast<uint8_t*>(wf + (size_t)I8_KC * pitch);
  const size_t stage_bytes = (size_t)I8_KC * pitch;

  // stage this tile's rows of X, transposed; rows past the batch and
  // features past d_in are zero
  {
    const int kp0 = S.kp[0];
    for (int i = tid; i < I8_M * kp0; i += I8_THREADS) {
      const int k = i / I8_M;
      const int r = i - k * I8_M;
      const int row = row0 + r;
      act[i] = (row < n_rows && k < S.d_in) ? x[(size_t)row * S.d_in + k] : 0.0f;
    }
  }

  int ll = 0, lk = 0;  // next chunk to load, one ahead of the products
  load_chunk(S, ll, lk, rank, C, ring, pitch);
  cp_async_commit();
  if (++lk == S.kp[ll] / I8_KC) { lk = 0; ++ll; }

  int t = 0;  // chunks consumed
  for (int l = 0; l < S.n_layers; ++l) {
    const Slice s = slice_of<I8_UNIT>(S.np[l], rank, C);
    const int slice_cols = s.nu * I8_UNIT;
    // a slice of fewer units than warps splits each chunk's k range over
    // the warps of a unit (unit warp % nu, k part warp / nu), as far as the
    // partial sums fit in the activation buffer, free once the layer's
    // products are done
    int ksplit = 1;
    while (s.nu > 0 && ksplit * 2 * s.nu <= I8_THREADS / 32 &&
           (ksplit * 2 - 1) * s.nu * 2048 <= kmax * I8_M) {
      ksplit *= 2;
    }
    const int unit = s.nu > 0 ? warp % s.nu : 0;
    const int kpart = s.nu > 0 ? warp / s.nu : ksplit;
    const bool busy = kpart < ksplit;  // computes part of a unit
    const bool mine = warp < s.nu;     // holds the unit's sum for the epilogue
    const int kk0 = kpart * (I8_KC / ksplit);
    const int kk1 = kk0 + I8_KC / ksplit;
    // this lane's columns: col + c for c < 4, col + 28 + c for c >= 4, so a
    // quarter-warp's weight reads are 128 contiguous bytes
    const int col = (s.u0 + unit) * I8_UNIT + cg8 * 4;
    // the dequantization pass: the slice's columns in quads of 4, padded
    // to a power of two `span` of quads; thread (k-row phase tid / span,
    // quad tid % span) converts its quad in every (I8_THREADS / span)-th
    // k-row of a stage, with its 4 scales held in registers for the layer
    int span = 16;
    while (span * 4 < slice_cols) span *= 2;
    const int quad = tid & (span - 1);
    const bool converts = quad * 4 < slice_cols;
    const float4 sc4 = converts
        ? *reinterpret_cast<const float4*>(S.scale[l] + s.u0 * I8_UNIT + quad * 4)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    }
    const int n_chunks = S.kp[l] / I8_KC;
    for (int kc = 0; kc < n_chunks; ++kc, ++t) {
      if (ll < S.n_layers) {
        load_chunk(S, ll, lk, rank, C, ring + ((t + 1) % I8_STAGES) * stage_bytes, pitch);
        if (++lk == S.kp[ll] / I8_KC) { lk = 0; ++ll; }
      }
      cp_async_commit();  // an empty group past the last chunk keeps the count
      cp_async_wait_one();
      // this stage has landed, and every warp is done with the previous
      // f32 tile
      __syncthreads();
      if (converts) {
        const uint8_t* q8 = ring + (t % I8_STAGES) * stage_bytes + quad * 4;
        float* w4 = wf + quad * 4;
#pragma unroll 4
        for (int kk = tid / span; kk < I8_KC; kk += I8_THREADS / span) {
          const uint32_t q = *reinterpret_cast<const uint32_t*>(q8 + (size_t)kk * pitch);
          *reinterpret_cast<float4*>(w4 + (size_t)kk * pitch) = make_float4(
              __fmul_rn(int8_to_float(q, 0x7440), sc4.x),
              __fmul_rn(int8_to_float(q, 0x7441), sc4.y),
              __fmul_rn(int8_to_float(q, 0x7442), sc4.z),
              __fmul_rn(int8_to_float(q, 0x7443), sc4.w));
        }
      }
      __syncthreads();

      if (busy) {
        const float* wrow = wf + unit * I8_UNIT + cg8 * 4;
        const float* arow = act + (size_t)kc * I8_KC * I8_M + rg * 8;
#pragma unroll 4
        for (int kk = kk0; kk < kk1; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(arow + kk * I8_M);
          const float4 a1 = *reinterpret_cast<const float4*>(arow + kk * I8_M + 4);
          const float4 w0 = *reinterpret_cast<const float4*>(wrow + (size_t)kk * pitch);
          const float4 w1 = *reinterpret_cast<const float4*>(wrow + (size_t)kk * pitch + 32);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
          }
        }
      }
    }
    if (ksplit > 1) {
      // every warp is done reading this layer's input: it holds the
      // partial sums, [k part - 1][unit][accumulator][lane]
      __syncthreads();
      if (busy && kpart > 0) {
        float* part = act + ((size_t)(kpart - 1) * s.nu + unit) * 2048 + lane;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) part[(r * 8 + c) * 32] = acc[r][c];
        }
      }
      __syncthreads();
      if (mine) {
        for (int kp = 1; kp < ksplit; ++kp) {
          const float* part = act + ((size_t)(kp - 1) * s.nu + unit) * 2048 + lane;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] += part[(r * 8 + c) * 32];
          }
        }
      }
    }
    const float* __restrict__ bias = S.b[l];
    if (l + 1 == S.n_layers) {
      // column 0 of the last layer is the prediction: the lanes of column
      // group 0 of warp 0 of rank 0 hold it, 8 rows each
      if (rank == 0 && warp == 0 && cg8 == 0) {
        const float b0 = bias[0];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int row = row0 + rg * 8 + r;
          if (row < n_rows) out[row] = acc[r][0] + b0;
        }
      }
      break;
    }

    // every peer has finished reading the current input
    cluster.sync();
    if (mine) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int cc = col + (c < 4 ? c : 28 + c);
        const float bc = bias[cc];
        const float4 o0 = make_float4(
            fmaxf(acc[0][c] + bc, 0.0f), fmaxf(acc[1][c] + bc, 0.0f),
            fmaxf(acc[2][c] + bc, 0.0f), fmaxf(acc[3][c] + bc, 0.0f));
        const float4 o1 = make_float4(
            fmaxf(acc[4][c] + bc, 0.0f), fmaxf(acc[5][c] + bc, 0.0f),
            fmaxf(acc[6][c] + bc, 0.0f), fmaxf(acc[7][c] + bc, 0.0f));
        const size_t off = (size_t)cc * I8_M + rg * 8;
        for (int p = 0; p < C; ++p) {
          float* peer = cluster.map_shared_rank(act, p);
          *reinterpret_cast<float4*>(peer + off) = o0;
          *reinterpret_cast<float4*>(peer + off + 4) = o1;
        }
      }
    }
    // the new input is complete in every CTA of the cluster
    cluster.sync();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

static size_t smem_bytes_for(const Int8Stack& S, int C, int* ring_units) {
  int kmax = 0, units = 0;
  for (int l = 0; l < S.n_layers; ++l) {
    kmax = kmax > S.kp[l] ? kmax : S.kp[l];
    const int u = (S.np[l] / I8_UNIT + C - 1) / C;
    units = units > u ? units : u;
  }
  *ring_units = units;
  return (size_t)kmax * I8_M * sizeof(float) +
         (size_t)units * I8_UNIT * I8_KC * (I8_STAGES + sizeof(float));
}

extern "C" {

// one forward of the padded stack over n_rows rows of x (n_rows, d_in) f32
// into out (n_rows,) f32, in clusters of `cluster` CTAs. smem_bytes is the
// wrapper's reckoning of the dynamic shared memory; it must cover the
// kernel's own.
int mlp_int8_forward(const float* x, float* out, int n_rows, int n_layers,
                     int d_in, const int* kp, const int* np, void* const* w,
                     void* const* b, void* const* scale, int cluster,
                     int smem_bytes, void* stream) {
  if (!stack_ok(n_rows, n_layers, d_in, kp, np, cluster, I8_KC, I8_UNIT, I8_MAX_UNITS) ||
      scale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Int8Stack S;
  S.n_layers = n_layers;
  S.d_in = d_in;
  for (int l = 0; l < n_layers; ++l) {
    S.kp[l] = kp[l];
    S.np[l] = np[l];
    S.w[l] = static_cast<const int8_t*>(w[l]);
    S.b[l] = static_cast<const float*>(b[l]);
    S.scale[l] = static_cast<const float*>(scale[l]);
  }
  int ring_units = 0;
  const size_t smem = smem_bytes_for(S, cluster, &ring_units);
  if ((size_t)smem_bytes < smem) return (int)cudaErrorInvalidValue;
  return (int)launch_clusters(mlp_int8_kernel, I8_THREADS, n_rows, I8_M, cluster, smem, stream,
                              x, out, n_rows, S, ring_units);
}

// how many clusters of `cluster` CTAs with smem_bytes of dynamic shared
// memory each can be resident at once on the current device (0: the
// configuration cannot run); a negative value is -cudaError
int mlp_int8_max_active_clusters(int cluster, int smem_bytes) {
  return max_active_clusters(mlp_int8_kernel, I8_THREADS, cluster, smem_bytes);
}

const char* mlp_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
