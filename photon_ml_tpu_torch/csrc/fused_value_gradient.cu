// Fused GLM value + gradient sums over a dense design matrix, for Hopper.
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_kernels.py:144
// (fused_value_gradient_sums; Pallas body _kernel :87-129, pl.pallas_call
// at :183). For z_i = x_i . w + offset_i + shift it returns
//     value     = sum_i wt_i * l(z_i, y_i)
//     vector    = sum_i wt_i * l'(z_i, y_i) * x_i        ([D])
//     prefactor = sum_i wt_i * l'(z_i, y_i)
// for the logistic, squared, Poisson and smoothed-hinge losses, with the
// formulas of ops/losses.py (log1p_exp(x) = max(x,0) + log1p(exp(-|x|)),
// the branch-wise sigmoid, the smoothed hinge on y_pm = 2y - 1).
//
// What bounds it: bytes. A call must read X once plus labels, offsets and
// weights: n*d*itemsize + 12*n bytes (+ 4*d for w). It does 4*n*d flops,
// i.e. 1 flop per byte of f32 X, far below the ~20 flop/byte at which the
// H100's f32 CUDA cores (67 TFLOP/s) would overtake HBM (3.35 TB/s). So the
// design is about reading X from HBM exactly once.
//
// Design (simple first):
//  * Pass 1: a persistent grid (as many CTAs as are resident at once) walks
//    row tiles, grid-stride. Each tile (rows_per_tile full rows, <= 28 KB)
//    is copied from HBM into shared memory with coalesced 16-byte loads
//    (bf16 is widened to f32 on load), with its labels, offsets and
//    weights. One warp per row forms x_i . w from the staged tile and w
//    (kept in shared memory, f32) and reduces it with shuffles; then one
//    thread per row forms wt*l and wt*l'. Rows >= n are never loaded: the
//    ragged last tile is cut by its row count (selection), so padding can
//    never leak into a sum. Then every thread adds wd_i * X[i, j] for the
//    columns it owns from shared memory into registers that persist across
//    the CTA's tiles (for d < 256, 256/d thread groups split the rows and
//    are summed in group order at the end). So X is read from HBM once for
//    both X.w and X^T r; the TPU kernel's 4 MB VMEM tile and its serial
//    grid accumulation (pallas_kernels.py:45-60, :92-96) do not carry over.
//  * Pass 2: one small kernel sums the per-CTA partials in a fixed order
//    (CTA 0, 1, 2, ...; a fixed shuffle tree for the scalars). No atomics:
//    two calls on the same inputs are bit-identical.
//
// Left for later: the copy into shared memory is synchronous (no cp.async
// or TMA pipelining, so a CTA's loads do not overlap its own arithmetic;
// only the other resident CTAs hide the latency), and the partials take a
// second pass (a cluster or last-CTA reduction could fold it into pass 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocksPerSm = 4;      // caps registers at 64 per thread
constexpr int kTileFloats = 7168;       // staged X per tile: 28 KB of f32
constexpr int kMaxRows = kThreads;      // one thread per row for the loss
constexpr int kMaxDim = 4096;
constexpr int kMaxColsPerThread = kMaxDim / kThreads;  // 16 registers

template <int LOSS>
__device__ __forceinline__ void loss_and_d1(float z, float y, float* l,
                                            float* d1) {
  if (LOSS == 0) {  // logistic
    const float e = expf(-fabsf(z));
    *l = fmaxf(z, 0.f) + log1pf(e) - y * z;
    const float s = z >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    *d1 = s - y;
  } else if (LOSS == 1) {  // squared
    const float r = z - y;
    *l = 0.5f * r * r;
    *d1 = r;
  } else if (LOSS == 2) {  // poisson
    const float e = expf(z);
    *l = e - y * z;
    *d1 = e - y;
  } else {  // smoothed hinge
    const float y_pm = 2.f * y - 1.f;
    const float t = y_pm * z;
    if (t >= 1.f) {
      *l = 0.f;
      *d1 = 0.f;
    } else if (t <= 0.f) {
      *l = 0.5f - t;
      *d1 = -y_pm;
    } else {
      const float u = 1.f - t;
      *l = 0.5f * u * u;
      *d1 = y_pm * (t - 1.f);
    }
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One 16-byte load from global memory into f32 shared memory.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]);
  const float2 e = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, e.x, e.y);
}

// Fixed-order tree sum of one value per thread; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Shared memory (floats): tile [rows*d] | w [d] | z [rows] | y [rows] |
// offsets [rows] | weights [rows] | reduction scratch [kThreads].
inline size_t smem_floats(int rows, int d) {
  return (size_t)rows * d + d + 4 * (size_t)rows + kThreads;
}

template <typename T, int LOSS, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
fused_vg_partials(const T* __restrict__ X, const float* __restrict__ labels,
                  const float* __restrict__ offsets,
                  const float* __restrict__ weights,
                  const float* __restrict__ w,
                  const float* __restrict__ shift_ptr, int64_t n, int d,
                  int rows_per_tile, int groups, float* __restrict__ part_vec,
                  float* __restrict__ part_val, float* __restrict__ part_pre) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* w_s = tile + (int64_t)rows_per_tile * d;
  float* z_s = w_s + d;  // margins, then wt * l'
  float* y_s = z_s + rows_per_tile;
  float* off_s = y_s + rows_per_tile;
  float* wt_s = off_s + rows_per_tile;
  float* red = wt_s + rows_per_tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < d; j += kThreads) w_s[j] = w[j];
  const float shift = *shift_ptr;
  // column ownership: groups > 1 (d < 256) splits rows over `groups`
  // thread groups of d threads; groups == 1 gives thread tid the columns
  // tid, tid + 256, ...
  const int grp = groups > 1 ? tid / d : 0;
  const bool col_thread = groups > 1 ? grp < groups : true;

  float acc[kMaxColsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxColsPerThread; ++k) acc[k] = 0.f;
  float val = 0.f;  // this thread's rows' running sums
  float pre = 0.f;

  const int64_t num_tiles = (n + rows_per_tile - 1) / rows_per_tile;
  for (int64_t t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int64_t row0 = t * rows_per_tile;
    const int64_t left = n - row0;
    const int rows = left < rows_per_tile ? (int)left : rows_per_tile;
    const int64_t count = (int64_t)rows * d;
    const T* src = X + row0 * d;
    __syncthreads();  // the previous tile is consumed; w_s is written
    if (VEC) {
      constexpr int V = 16 / sizeof(T);
      for (int64_t c = tid; c < count / V; c += kThreads)
        load16(src + c * V, tile + c * V);
    } else {
      for (int64_t c = tid; c < count; c += kThreads)
        tile[c] = to_float(src[c]);
    }
    if (tid < rows) {
      y_s[tid] = labels[row0 + tid];
      off_s[tid] = offsets[row0 + tid];
      wt_s[tid] = weights[row0 + tid];
    }
    __syncthreads();

    // x_i . w, one warp per row
#pragma unroll 2
    for (int i = warp; i < rows; i += kWarps) {
      const float* xr = tile + (int64_t)i * d;
      float s = 0.f;
      for (int j = lane; j < d; j += 32) s = fmaf(xr[j], w_s[j], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) z_s[i] = s;
    }
    __syncthreads();

    // pointwise loss, one thread per row
    if (tid < rows) {
      const float z = z_s[tid] + off_s[tid] + shift;
      float l, g;
      loss_and_d1<LOSS>(z, y_s[tid], &l, &g);
      const float wt = wt_s[tid];
      const float wd = wt * g;
      val += wt * l;
      pre += wd;
      z_s[tid] = wd;
    }
    __syncthreads();

    // X^T (wt * l') for this tile, from shared memory
    if (groups > 1) {
      if (col_thread) {
        const int j = tid - grp * d;
        for (int i = grp; i < rows; i += groups)
          acc[0] = fmaf(z_s[i], tile[(int64_t)i * d + j], acc[0]);
      }
    } else {
      for (int i = 0; i < rows; ++i) {
        const float wd = z_s[i];
        const float* xr = tile + (int64_t)i * d;
#pragma unroll
        for (int k = 0; k < kMaxColsPerThread; ++k) {
          const int j = tid + k * kThreads;
          if (j < d) acc[k] = fmaf(wd, xr[j], acc[k]);
        }
      }
    }
  }

  float* pv = part_vec + (int64_t)blockIdx.x * d;
  if (groups > 1) {
    __syncthreads();
    red[tid] = col_thread ? acc[0] : 0.f;
    __syncthreads();
    if (tid < d) {
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s += red[g * d + tid];
      pv[tid] = s;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int k = 0; k < kMaxColsPerThread; ++k) {
      const int j = tid + k * kThreads;
      if (j < d) pv[j] = acc[k];
    }
  }
  const float v = block_sum(val, red);
  const float p = block_sum(pre, red);
  if (tid == 0) {
    part_val[blockIdx.x] = v;
    part_pre[blockIdx.x] = p;
  }
}

// Pass 2: fixed-order sum of the per-CTA partials.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part_vec,
                const float* __restrict__ part_val,
                const float* __restrict__ part_pre, int num_parts, int d,
                float* __restrict__ out_vec, float* __restrict__ out_val,
                float* __restrict__ out_pre) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < d) {
    float s = 0.f;
    for (int g = 0; g < num_parts; ++g) s += part_vec[(int64_t)g * d + j];
    out_vec[j] = s;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v = 0.f, p = 0.f;
    for (int g = lane; g < num_parts; g += 32) {
      v += part_val[g];
      p += part_pre[g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, o);
      p += __shfl_xor_sync(0xffffffffu, p, o);
    }
    if (lane == 0) {
      *out_val = v;
      *out_pre = p;
    }
  }
}

struct Args {
  const void* X;
  const float* labels;
  const float* offsets;
  const float* weights;
  const float* w;
  const float* shift;
  int64_t n;
  int d;
  int rows;
  int groups;
  size_t smem;
  int max_ctas;
  float* part_vec;
  float* part_val;
  float* part_pre;
  cudaStream_t stream;
};

// Launch pass 1 with as many CTAs as fit on the card at once (never more
// than the tiles or the scratch); returns the grid size via *grid.
template <typename T, int LOSS, bool VEC>
cudaError_t launch_pass1(const Args& a, int* grid) {
  auto kernel = fused_vg_partials<T, LOSS, VEC>;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    a.smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t num_tiles = (a.n + a.rows - 1) / a.rows;
  int64_t g = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  if (g > num_tiles) g = num_tiles;
  if (g > a.max_ctas) g = a.max_ctas;
  *grid = (int)g;
  kernel<<<*grid, kThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.X), a.labels, a.offsets, a.weights, a.w,
      a.shift, a.n, a.d, a.rows, a.groups, a.part_vec, a.part_val,
      a.part_pre);
  return cudaGetLastError();
}

template <typename T, int LOSS>
cudaError_t launch_vec(const Args& a, int* grid) {
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      (a.d % V == 0) && (reinterpret_cast<uintptr_t>(a.X) % 16 == 0);
  return vec ? launch_pass1<T, LOSS, true>(a, grid)
             : launch_pass1<T, LOSS, false>(a, grid);
}

template <typename T>
cudaError_t launch_loss(int loss, const Args& a, int* grid) {
  switch (loss) {
    case 0: return launch_vec<T, 0>(a, grid);
    case 1: return launch_vec<T, 1>(a, grid);
    case 2: return launch_vec<T, 2>(a, grid);
    case 3: return launch_vec<T, 3>(a, grid);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Rows staged per tile for width d.
int photon_fused_vg_rows_per_tile(int d) {
  if (d < 1) return 1;
  const int rows = kTileFloats / d;
  return rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
}

// Both passes on `stream`. x_dtype: 0 = f32, 1 = bf16. loss: 0 logistic,
// 1 squared, 2 poisson, 3 smoothed hinge. max_ctas bounds pass 1's grid;
// the scratch part_vec holds max_ctas * d floats, part_val/part_pre
// max_ctas. Returns cudaGetLastError() after the launches (0 = success).
int photon_fused_value_gradient(const void* X, int x_dtype,
                                const void* labels, const void* offsets,
                                const void* weights, const void* w,
                                const void* shift, long long n, int d,
                                int loss, int max_ctas, void* part_vec,
                                void* part_val, void* part_pre, void* out_vec,
                                void* out_val, void* out_pre, void* stream) {
  if (n < 1 || d < 1 || d > kMaxDim || max_ctas < 1 || loss < 0 || loss > 3)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.X = X;
  a.labels = static_cast<const float*>(labels);
  a.offsets = static_cast<const float*>(offsets);
  a.weights = static_cast<const float*>(weights);
  a.w = static_cast<const float*>(w);
  a.shift = static_cast<const float*>(shift);
  a.n = n;
  a.d = d;
  a.rows = photon_fused_vg_rows_per_tile(d);
  a.groups = d < kThreads ? kThreads / d : 1;
  a.smem = smem_floats(a.rows, d) * sizeof(float);
  a.max_ctas = max_ctas;
  a.part_vec = static_cast<float*>(part_vec);
  a.part_val = static_cast<float*>(part_val);
  a.part_pre = static_cast<float*>(part_pre);
  a.stream = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t err;
  if (x_dtype == 0) {
    err = launch_loss<float>(loss, a, &grid);
  } else if (x_dtype == 1) {
    err = launch_loss<__nv_bfloat16>(loss, a, &grid);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<(d + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.part_vec, a.part_val, a.part_pre, grid, d,
      static_cast<float*>(out_vec), static_cast<float*>(out_val),
      static_cast<float*>(out_pre));
  return (int)cudaGetLastError();
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
