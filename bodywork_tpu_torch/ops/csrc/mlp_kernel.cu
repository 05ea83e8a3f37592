// Fused MLP scoring forward for Hopper (sm_90a): the whole folded dense
// stack in ONE launch, with f32 weights.
//
// Replaces the Pallas TPU kernel `make_pallas_mlp_apply` in
// bodywork_tpu/ops/mlp_kernel.py: `_mlp_kernel` with f32 operands (engine
// `pallas` -> `kernel`). The bf16 and int8 variants have kernels of their
// own, designed for Hopper: mlp_bf16_tc.cu (tensor cores) and mlp_int8.cu.
//
// What it computes: h = X; for each layer h = h.W_i + b_i with f32
// accumulation, ReLU between layers, the last layer linear; the output is
// column 0 of the last layer (the regression head). The scaler is already
// folded into the first and last layers by the wrapper
// (ops/mlp_kernel.py fold_scaler_into_net). IEEE f32 FMA on the CUDA
// cores; no TF32, no tensor cores. The template keeps its weight-type
// parameter WT (`load_weight`, `operand`) for f32 alone.
//
// Design. The TPU kernel keeps every weight VMEM-resident and never writes
// an intermediate activation to HBM. On Hopper the wide model's weights
// (8.4 MB f32 at hidden (1024, 1024, 1024)) cannot sit in a block's 227 KB
// of shared memory, so instead:
//   - each block owns R rows of the batch (R = 8, 16 or 32, a launch
//     parameter the wrapper picks per batch size, separate from the serving
//     bucket's row tile) and walks ALL layers in one launch;
//   - the block's activations live in dynamic shared memory, stored
//     transposed ([k][r]) so one float4 broadcast read gives four rows'
//     activation for input feature k; no activation ever goes to device
//     memory. When every layer's outputs come from one column pass
//     (N <= MLP_COLS * MLP_THREADS = 1024) a single buffer of
//     R * max_width * 4 bytes is updated in place (128 KB at R = 32 and
//     width 1024); wider stacks ping-pong between two;
//   - weights are read from global memory and stay in the 50 MB L2 across
//     blocks; each thread accumulates MLP_COLS output columns for the
//     block's R rows in f32 registers, with neighbouring threads on
//     neighbouring columns (coalesced weight reads along N). Each block
//     re-reads every weight from L2 once, so more rows per block means
//     less L2 traffic, and fewer blocks to spread over the 132 SMs;
//   - the weight loads of step k + 1 are issued before step k's FMAs, and
//     are predicated rather than branched around, so the L2 latency hides
//     behind arithmetic;
//   - bias and ReLU run in the epilogue between layers; ragged widths are
//     masked here, so no 128-lane padding is needed.
//
// Bound on an H100 SXM at the slice's 4096-row bucket (1 -> 1024 -> 1024
// -> 1024 -> 1: 2,099,200 MACs a row, 17.2 GFLOP):
//   the work is f32 FMA on the CUDA cores, so operations bound it: about
//   0.26 ms at the data sheet's 67 TFLOP/s f32. The 8.4 MB of weights take
//   2.5 us at 3.35 TB/s. (An H100 PCIe's data sheet gives 51 TFLOP/s f32
//   and 2.0 TB/s; the card's own name says which figures apply.) The L2
//   re-reads of the weights, once per R rows, and the latency of those
//   reads keep this kernel well above its bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (ops/_build.py). The C entry points launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define MLP_MAX_LAYERS 16
#define MLP_THREADS 256
#define MLP_COLS 4  // output columns per thread per pass over N

struct MlpLayers {
  const void* w[MLP_MAX_LAYERS];       // (K, N) row-major, element type WT
  const float* b[MLP_MAX_LAYERS];      // (N,)
  const float* scale[MLP_MAX_LAYERS];  // unused by f32: null
  int width[MLP_MAX_LAYERS + 1];       // width[0] = features, width[l+1] = N_l
  int n_layers;
  int max_width;
};

// -- per weight type: how a weight is read, and how an activation is
// -- rounded before it meets that weight
__device__ __forceinline__ float load_weight(const float* w, size_t i, float) {
  return __ldg(w + i);
}

template <typename WT>
__device__ __forceinline__ float operand(float a) {
  return a;
}

template <typename WT, int R, bool IN_PLACE>
__global__ void __launch_bounds__(MLP_THREADS)
mlp_forward_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int n_rows, MlpLayers L) {
  extern __shared__ __align__(16) float smem[];
  float* h_in = smem;
  float* h_out = IN_PLACE ? smem : smem + (size_t)R * L.max_width;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;

  // stage this block's rows of X, transposed to [k][r]; rows past the
  // batch are zero (they are computed and never written out)
  const int d_in = L.width[0];
  for (int i = tid; i < d_in * R; i += MLP_THREADS) {
    const int k = i / R;
    const int r = i - k * R;
    const int row = row0 + r;
    const float v = row < n_rows ? x[(size_t)row * d_in + k] : 0.0f;
    h_in[i] = operand<WT>(v);
  }
  __syncthreads();

  for (int l = 0; l < L.n_layers; ++l) {
    const int K = L.width[l];
    const int N = L.width[l + 1];
    const WT* __restrict__ W = static_cast<const WT*>(L.w[l]);
    const float* __restrict__ bias = L.b[l];
    const float* __restrict__ scale = L.scale[l];
    const bool hidden = l + 1 < L.n_layers;

    for (int n0 = 0; n0 < N; n0 += MLP_COLS * MLP_THREADS) {
      int col[MLP_COLS];
      bool live[MLP_COLS];
      float sc[MLP_COLS];
      float acc[MLP_COLS][R];
#pragma unroll
      for (int c = 0; c < MLP_COLS; ++c) {
        col[c] = n0 + c * MLP_THREADS + tid;
        live[c] = col[c] < N;
        sc[c] = (scale != nullptr && live[c]) ? scale[col[c]] : 1.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
      }

      // the weights of step k + 1 load while step k's FMAs run: the L2
      // latency of the weight reads is what the block would wait on.
      // Loads are predicated (a dead column reads 0), never branched
      // around, so the compiler keeps them ahead of the FMAs.
      float w_next[MLP_COLS];
#pragma unroll
      for (int c = 0; c < MLP_COLS; ++c) {
        w_next[c] = live[c] ? load_weight(W, (size_t)col[c], sc[c]) : 0.0f;
      }
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        float w[MLP_COLS];
        const size_t next = (size_t)(k + 1) * N;
#pragma unroll
        for (int c = 0; c < MLP_COLS; ++c) {
          w[c] = w_next[c];
          w_next[c] = (live[c] && k + 1 < K) ? load_weight(W, next + col[c], sc[c]) : 0.0f;
        }
        float a[R];
        const float4* hv = reinterpret_cast<const float4*>(h_in + (size_t)k * R);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 t = hv[q];
          a[4 * q + 0] = t.x;
          a[4 * q + 1] = t.y;
          a[4 * q + 2] = t.z;
          a[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int c = 0; c < MLP_COLS; ++c) {
#pragma unroll
          for (int r = 0; r < R; ++r) acc[c][r] = fmaf(a[r], w[c], acc[c][r]);
        }
      }

      // in place, every thread must be done reading this layer's input
      // before any output overwrites it (one column pass covers all of N)
      if (IN_PLACE) __syncthreads();
      // epilogue: bias, ReLU between layers, the next layer's rounding
#pragma unroll
      for (int c = 0; c < MLP_COLS; ++c) {
        if (live[c]) {
          const float bb = bias[col[c]];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float v = acc[c][r] + bb;
            if (hidden) v = operand<WT>(fmaxf(v, 0.0f));
            h_out[(size_t)col[c] * R + r] = v;
          }
        }
      }
    }
    __syncthreads();
    if (!IN_PLACE) {
      float* t = h_in;
      h_in = h_out;
      h_out = t;
    }
  }

  // column 0 of the last layer is the prediction
  for (int r = tid; r < R; r += MLP_THREADS) {
    const int row = row0 + r;
    if (row < n_rows) out[row] = h_in[r];
  }
}

template <typename WT, int R, bool IN_PLACE>
static cudaError_t launch(const float* x, float* out, int n_rows,
                          const MlpLayers& L, cudaStream_t stream) {
  const size_t smem =
      (IN_PLACE ? 1 : 2) * (size_t)R * (size_t)L.max_width * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_forward_kernel<WT, R, IN_PLACE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_rows + R - 1) / R;
  if (blocks > 0) {
    mlp_forward_kernel<WT, R, IN_PLACE><<<blocks, MLP_THREADS, smem, stream>>>(
        x, out, n_rows, L);
  }
  return cudaGetLastError();
}

template <typename WT, int R>
static cudaError_t launch_rows(const float* x, float* out, int n_rows,
                               const MlpLayers& L, cudaStream_t stream) {
  // one activation buffer suffices when every layer's outputs come from
  // a single column pass; wider layers ping-pong between two
  int widest_out = 0;
  for (int i = 1; i <= L.n_layers; ++i) {
    if (L.width[i] > widest_out) widest_out = L.width[i];
  }
  if (widest_out <= MLP_COLS * MLP_THREADS) {
    return launch<WT, R, true>(x, out, n_rows, L, stream);
  }
  return launch<WT, R, false>(x, out, n_rows, L, stream);
}

template <typename WT>
static int forward(const float* x, float* out, int n_rows, int n_layers,
                   const int* widths, void* const* w, void* const* b,
                   void* const* scale, int block_rows, void* stream) {
  if (n_layers < 1 || n_layers > MLP_MAX_LAYERS || n_rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  MlpLayers L;
  L.n_layers = n_layers;
  L.max_width = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return (int)cudaErrorInvalidValue;
    L.width[i] = widths[i];
    if (widths[i] > L.max_width) L.max_width = widths[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    L.w[i] = w[i];
    L.b[i] = static_cast<const float*>(b[i]);
    L.scale[i] = scale != nullptr ? static_cast<const float*>(scale[i]) : nullptr;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 8:
      return (int)launch_rows<WT, 8>(x, out, n_rows, L, s);
    case 16:
      return (int)launch_rows<WT, 16>(x, out, n_rows, L, s);
    case 32:
      return (int)launch_rows<WT, 32>(x, out, n_rows, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int mlp_forward_f32(const float* x, float* out, int n_rows, int n_layers,
                    const int* widths, void* const* w, void* const* b,
                    void* const* scale, int block_rows, void* stream) {
  return forward<float>(x, out, n_rows, n_layers, widths, w, b, nullptr,
                        block_rows, stream);
}

// the most dynamic shared memory one block may opt into on `device`
int mlp_max_dynamic_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

const char* mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
