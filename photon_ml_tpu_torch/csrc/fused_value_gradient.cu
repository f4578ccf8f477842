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
// weights: n*d*itemsize + 12*n + 4*d bytes. It does 4*n*d flops, i.e. 1
// flop per byte of f32 X, far below the ~20 flop/byte at which the H100's
// f32 CUDA cores (67 TFLOP/s) would overtake HBM (3.35 TB/s); tensor cores
// have nothing to do here. Both paths below are bound by those bytes, so
// each is about reading X from HBM exactly once while keeping enough loads
// in flight: by Little's law about 3.35 TB/s x ~1 us / 132 SMs ~ 25 KB per
// SM at all times.
//
// Pass 1 has two paths; the caller picks one (see ops/pallas_kernels.py
// kernel_path) and this file refuses a stream request it cannot take.
//  * Stream path, rows of at most 1 KB that are whole 16-byte vectors with
//    X 16-byte aligned (d <= 256 in f32, d <= 512 in bf16; the GLMix
//    fixed effect is 64 wide). No shared-memory staging and no block-wide
//    barrier in the row loop. A row is held in registers by a segment of P
//    lanes (P = row vectors rounded up to a power of two, at most 32); lane
//    p of a segment loads the row's 16-byte vectors p and p + P (the second
//    only for rows over 512 B) with read-only, L1-bypassing loads. A warp
//    walks batches of G = U * 32/P consecutive rows, grid-stride over all
//    warps of the grid, and issues all U loads of a batch (kStreamVecs x 16
//    B per lane, half that for 16-byte rows; 4 KB a warp at d = 64 f32,
//    and with two 256-thread CTAs per SM up to 64 KB an SM, well above the
//    ~25 KB asked) plus the batch's labels, offsets and weights before it
//    consumes any. Each lane keeps its slice of w in registers; x . w is
//    reduced with xor shuffles inside the segment. The margins then move by
//    shuffle to one row per lane, so the loss runs once per row with up to
//    32 rows in a warp's 32 lanes (16 at d = 64 f32, whose batch is 16
//    rows), not once per segment, and wt * l' goes back to the row's
//    segment by shuffle. Each lane adds wt * l' * x into f32 accumulators for its
//    own columns that persist across all of the CTA's rows. Rows >= n are
//    never loaded and add exactly zero. At the end the segments of a warp
//    fold in a fixed xor order and the warps fold through shared memory in
//    warp order.
//  * Staged path, every other shape (rows over 1 KB, widths that are not
//    whole vectors, a misaligned X). A persistent grid walks row tiles,
//    grid-stride. Each tile (rows_per_tile full rows, <= 28 KB) is copied
//    from HBM into shared memory with coalesced 16-byte loads (bf16 is
//    widened to f32 on load), with its labels, offsets and weights. One
//    warp per row forms x_i . w from the staged tile and w (kept in shared
//    memory, f32) and reduces it with shuffles; then one thread per row
//    forms wt*l and wt*l'. Rows >= n are never loaded: the ragged last tile
//    is cut by its row count (selection). Then every thread adds
//    wd_i * X[i, j] for the columns it owns from shared memory into
//    registers that persist across the CTA's tiles (for d < 256, 256/d
//    thread groups split the rows and are summed in group order at the
//    end). At d = 2,048 a tile is 3 rows and a warp's row loop has work for
//    every lane; at d = 64 the tile's four phases leave a CTA with nothing
//    in flight for three of them, which is why narrow rows stream instead.
//  The TPU kernel's 4 MB VMEM tile and its serial grid accumulation
//  (pallas_kernels.py:45-60, :92-96) carry over to neither path.
//  * Pass 2 (both paths): one small kernel sums the per-CTA partials in a
//    fixed order (CTA 0, 1, 2, ...; a fixed shuffle tree for the scalars).
//    The grid is sized from the occupancy, so it is the same for the same
//    call. No atomics: two calls on the same inputs are bit-identical.
//
// Left for later: the staged path's copy into shared memory is synchronous
// (a cp.async or TMA multi-stage ring would let a CTA's loads overlap its
// own arithmetic; only the other resident CTAs hide the latency now), and
// both paths take a second launch for the partials (a cluster or last-CTA
// reduction could fold it into pass 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocksPerSm = 4;      // caps registers at 64 per thread
constexpr int kTileFloats = 7168;       // staged X per tile: 28 KB of f32
constexpr int kMaxRows = kThreads;      // one thread per row for the loss
constexpr int kMaxDim = 4096;
constexpr int kMaxColsPerThread = kMaxDim / kThreads;  // 16 registers

// Stream path.
constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
// Registers set this kernel's occupancy: ptxas gives it 64-128 a thread
// by width, dtype and loss (85 at d = 64 f32, 111 in bf16). Two CTAs per
// SM caps it at 128, so no variant spills, and two CTAs keep up to 64 KB
// of loads in flight an SM at d = 64, more than the bound needs; the
// occupancy query sizes the grid from what ptxas allots.
constexpr int kStreamMinBlocksPerSm = 2;
constexpr int kStreamVecs = 8;  // 16-byte loads a lane has in flight
constexpr int kStreamMaxLossRows = 4;  // loss rows a lane holds per batch
constexpr int kStreamMaxRowBytes = 1024;
constexpr int kStreamMaxCols = kStreamMaxRowBytes / 2;  // bf16 at 1 KB

// The stream path's batch for P lanes a row and VPL vectors a lane: U
// loads a lane (kStreamVecs vectors, fewer for 16-byte rows, whose 32
// rows a load would otherwise give a lane more loss rows than registers
// hold), G rows a batch, C loss rows a lane.
template <int P, int VPL>
struct StreamBatch {
  static constexpr int S = 32 / P;  // rows per warp load (segments)
  static constexpr int U = kStreamVecs / VPL < kStreamMaxLossRows * P
                               ? kStreamVecs / VPL
                               : kStreamMaxLossRows * P;
  static constexpr int G = U * S;
  static constexpr int C = (G + 31) / 32;
};

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

// One read-only 16-byte load that does not allocate in L1: X is read once.
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The 16 bytes of v as f32 values: 4 of f32, or 8 of bf16 widened.
__device__ __forceinline__ void widen16(const uint4& v, float (&out)[4]) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ float2 widen_bf16x2(uint32_t bits) {
  __nv_bfloat162 h;
  memcpy(&h, &bits, sizeof(h));
  return __bfloat1622float2(h);
}
__device__ __forceinline__ void widen16(const uint4& v, float (&out)[8]) {
  const float2 a = widen_bf16x2(v.x);
  const float2 b = widen_bf16x2(v.y);
  const float2 c = widen_bf16x2(v.z);
  const float2 e = widen_bf16x2(v.w);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  out[4] = c.x; out[5] = c.y; out[6] = e.x; out[7] = e.y;
}

// Stream path pass 1 (see the note at the top). P lanes per row, VPL
// 16-byte vectors per lane; lane p of a segment owns vectors p + v * P.
template <typename T, int LOSS, int P, int VPL>
__global__ void __launch_bounds__(kStreamThreads, kStreamMinBlocksPerSm)
fused_vg_stream(const T* __restrict__ X, const float* __restrict__ labels,
                const float* __restrict__ offsets,
                const float* __restrict__ weights,
                const float* __restrict__ w,
                const float* __restrict__ shift_ptr, int64_t n, int d,
                float* __restrict__ part_vec, float* __restrict__ part_val,
                float* __restrict__ part_pre) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte vector
  constexpr int S = StreamBatch<P, VPL>::S;
  constexpr int U = StreamBatch<P, VPL>::U;
  constexpr int G = StreamBatch<P, VPL>::G;
  constexpr int C = StreamBatch<P, VPL>::C;
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ float red_vec[kStreamWarps * kStreamMaxCols];
  __shared__ float red_val[kStreamWarps];
  __shared__ float red_pre[kStreamWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = lane / P;
  const int p = lane % P;
  const int nv = d / E;  // vectors per row
  bool has[VPL];
  float wv[VPL][E];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int k = p + v * P;
    has[v] = k < nv;
#pragma unroll
    for (int e = 0; e < E; ++e) wv[v][e] = has[v] ? w[k * E + e] : 0.f;
  }
  const float shift = *shift_ptr;
  float acc[VPL][E];
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[v][e] = 0.f;
  float val = 0.f;  // this lane's loss rows' running sums
  float pre = 0.f;

  const uint4* Xv = reinterpret_cast<const uint4*>(X);
  const int64_t num_batches = (n + G - 1) / G;
  const int64_t step = (int64_t)gridDim.x * kStreamWarps;
  for (int64_t b = (int64_t)blockIdx.x * kStreamWarps + warp; b < num_batches;
       b += step) {
    const int64_t row0 = b * G;
    // every load of the batch is issued before any is consumed
    uint4 x[U][VPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = row0 + u * S + seg;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        x[u][v] = (row < n && has[v])
                      ? load_stream(Xv + row * nv + p + v * P)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    // loss row of this lane: batch row c * 32 + lane
    bool ok[C];
    float yl[C], ol[C], wl[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t row = row0 + c * 32 + lane;
      ok[c] = c * 32 + lane < G && row < n;
      yl[c] = ok[c] ? labels[row] : 0.f;
      ol[c] = ok[c] ? offsets[row] : 0.f;
      wl[c] = ok[c] ? weights[row] : 0.f;
    }

    // x . w: every lane of a segment ends up with its row's sum
    float z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float xf[E];
        widen16(x[u][v], xf);
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(xf[e], wv[v][e], s);
      }
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      z[u] = s;
    }
    // batch row g = u * S + s sits in load u of segment s; lane g % 32
    // takes it for loss row g / 32
    float zl[C];
#pragma unroll
    for (int c = 0; c < C; ++c) zl[c] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float t = __shfl_sync(kFull, z[u], (lane % S) * P);
      if (lane / S == u % (32 / S)) zl[u * S / 32] = t;
    }
    float wdl[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float l, g;
      loss_and_d1<LOSS>(zl[c] + ol[c] + shift, yl[c], &l, &g);
      wdl[c] = 0.f;
      if (ok[c]) {
        wdl[c] = wl[c] * g;
        val += wl[c] * l;
        pre += wdl[c];
      }
    }
    // wt * l' back to the row's segment, then X^T r for this lane's columns
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float wd = __shfl_sync(kFull, wdl[u * S / 32], (u * S) % 32 + seg);
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float xf[E];
        widen16(x[u][v], xf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[v][e] = fmaf(wd, xf[e], acc[v][e]);
      }
    }
  }

  // segments of a warp hold the same columns: fold them in xor order
#pragma unroll
  for (int o = P; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[v][e] += __shfl_xor_sync(kFull, acc[v][e], o);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    val += __shfl_xor_sync(kFull, val, o);
    pre += __shfl_xor_sync(kFull, pre, o);
  }
  if (seg == 0) {
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (has[v])
#pragma unroll
        for (int e = 0; e < E; ++e)
          red_vec[warp * d + (p + v * P) * E + e] = acc[v][e];
  }
  if (lane == 0) {
    red_val[warp] = val;
    red_pre[warp] = pre;
  }
  __syncthreads();
  // warps fold in warp order
  float* pv = part_vec + (int64_t)blockIdx.x * d;
  for (int j = threadIdx.x; j < d; j += kStreamThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kStreamWarps; ++k) s += red_vec[k * d + j];
    pv[j] = s;
  }
  if (threadIdx.x == 0) {
    float v = 0.f, q = 0.f;
#pragma unroll
    for (int k = 0; k < kStreamWarps; ++k) {
      v += red_val[k];
      q += red_pre[k];
    }
    part_val[blockIdx.x] = v;
    part_pre[blockIdx.x] = q;
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
  bool stream_path;
  int lanes;          // stream path: lanes per row
  int vecs_per_lane;  // stream path: 16-byte vectors per lane
  float* part_vec;
  float* part_val;
  float* part_pre;
  cudaStream_t stream;
};

// Pass 1's grid: as many CTAs of `kernel` as fit on the card at once,
// never more than `work` (CTAs with rows to do) or the scratch.
template <typename K>
cudaError_t resident_grid(K kernel, int threads, size_t smem, int64_t work,
                          int max_ctas, int* grid) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int64_t g = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  if (g > work) g = work;
  if (g > max_ctas) g = max_ctas;
  *grid = (int)g;
  return cudaSuccess;
}

// Launch the staged pass 1; returns the grid size via *grid.
template <typename T, int LOSS, bool VEC>
cudaError_t launch_pass1(const Args& a, int* grid) {
  auto kernel = fused_vg_partials<T, LOSS, VEC>;
  const int64_t num_tiles = (a.n + a.rows - 1) / a.rows;
  cudaError_t err =
      resident_grid(kernel, kThreads, a.smem, num_tiles, a.max_ctas, grid);
  if (err != cudaSuccess) return err;
  kernel<<<*grid, kThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.X), a.labels, a.offsets, a.weights, a.w,
      a.shift, a.n, a.d, a.rows, a.groups, a.part_vec, a.part_val,
      a.part_pre);
  return cudaGetLastError();
}

// Launch the stream pass 1; returns the grid size via *grid.
template <typename T, int LOSS, int P, int VPL>
cudaError_t launch_stream(const Args& a, int* grid) {
  auto kernel = fused_vg_stream<T, LOSS, P, VPL>;
  constexpr int G = StreamBatch<P, VPL>::G;
  const int64_t batches = (a.n + G - 1) / G;
  cudaError_t err = resident_grid(
      kernel, kStreamThreads, 0, (batches + kStreamWarps - 1) / kStreamWarps,
      a.max_ctas, grid);
  if (err != cudaSuccess) return err;
  kernel<<<*grid, kStreamThreads, 0, a.stream>>>(
      static_cast<const T*>(a.X), a.labels, a.offsets, a.weights, a.w,
      a.shift, a.n, a.d, a.part_vec, a.part_val, a.part_pre);
  return cudaGetLastError();
}

// The stream path's geometry for rows of d values of `itemsize` bytes at
// X: false when it cannot take them (over 1 KB, not whole 16-byte vectors,
// X misaligned).
bool stream_geometry(const void* X, int d, int itemsize, int* lanes,
                     int* vecs_per_lane) {
  const int row_bytes = d * itemsize;
  if (row_bytes > kStreamMaxRowBytes || row_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0)
    return false;
  const int vecs = row_bytes / 16;
  int p = 1;
  while (p < vecs && p < 32) p <<= 1;
  *lanes = p;
  *vecs_per_lane = (vecs + p - 1) / p;
  return true;
}

template <typename T, int LOSS>
cudaError_t launch_stream_geometry(const Args& a, int* grid) {
  if (a.vecs_per_lane == 2)
    return a.lanes == 32 ? launch_stream<T, LOSS, 32, 2>(a, grid)
                         : cudaErrorInvalidValue;
  if (a.vecs_per_lane != 1) return cudaErrorInvalidValue;
  switch (a.lanes) {
    case 1: return launch_stream<T, LOSS, 1, 1>(a, grid);
    case 2: return launch_stream<T, LOSS, 2, 1>(a, grid);
    case 4: return launch_stream<T, LOSS, 4, 1>(a, grid);
    case 8: return launch_stream<T, LOSS, 8, 1>(a, grid);
    case 16: return launch_stream<T, LOSS, 16, 1>(a, grid);
    case 32: return launch_stream<T, LOSS, 32, 1>(a, grid);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int LOSS>
cudaError_t launch_vec(const Args& a, int* grid) {
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      (a.d % V == 0) && (reinterpret_cast<uintptr_t>(a.X) % 16 == 0);
  return vec ? launch_pass1<T, LOSS, true>(a, grid)
             : launch_pass1<T, LOSS, false>(a, grid);
}

template <typename T, int LOSS>
cudaError_t launch_path(const Args& a, int* grid) {
  return a.stream_path ? launch_stream_geometry<T, LOSS>(a, grid)
                       : launch_vec<T, LOSS>(a, grid);
}

template <typename T>
cudaError_t launch_loss(int loss, const Args& a, int* grid) {
  switch (loss) {
    case 0: return launch_path<T, 0>(a, grid);
    case 1: return launch_path<T, 1>(a, grid);
    case 2: return launch_path<T, 2>(a, grid);
    case 3: return launch_path<T, 3>(a, grid);
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
// 1 squared, 2 poisson, 3 smoothed hinge. path: 0 = staged, 1 = stream,
// with its geometry (lanes_per_row, vecs_per_lane), which must be the one
// this file derives for d; a stream request for a shape the stream path
// cannot take is refused, never run on the other path. max_ctas bounds
// pass 1's grid; the scratch part_vec holds max_ctas * d floats,
// part_val/part_pre max_ctas. Returns cudaGetLastError() after the
// launches (0 = success).
int photon_fused_value_gradient(const void* X, int x_dtype,
                                const void* labels, const void* offsets,
                                const void* weights, const void* w,
                                const void* shift, long long n, int d,
                                int loss, int path, int lanes_per_row,
                                int vecs_per_lane, int max_ctas,
                                void* part_vec, void* part_val,
                                void* part_pre, void* out_vec, void* out_val,
                                void* out_pre, void* stream) {
  if (n < 1 || d < 1 || d > kMaxDim || max_ctas < 1 || loss < 0 ||
      loss > 3 || path < 0 || path > 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.stream_path = path == 1;
  if (a.stream_path) {
    const int itemsize = x_dtype == 0 ? 4 : 2;
    if (!stream_geometry(X, d, itemsize, &a.lanes, &a.vecs_per_lane) ||
        a.lanes != lanes_per_row || a.vecs_per_lane != vecs_per_lane)
      return (int)cudaErrorInvalidValue;
  }
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
