// Multi-scale deformable attention sampling, hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/ms_deform_attn.py `ms_deform_attn_sample`, as the
// deformable encoder and decoder layers of erd_tpu/models/heads/
// deformable_detr_head.py (`MSDeformAttnLayer`) and dino_head.py
// (`BoxMSDeformAttn`) call it. On the TPU, XLA lowered the four bilinear
// corner reads of every (query, head, level, point) to dynamic gathers of
// whole head rows, one level at a time.
//
// Thread layout: one warp per (batch, query, head), one lane per channel
// (head_dim 32). Lane s < L * K first computes sample s's corner indices,
// bilinear fractions and attention weight once (its 2 location floats and
// 1 weight are neighbouring addresses across lanes, so the warp reads them
// coalesced); the warp then walks the samples, each broadcast from its
// lane by a shuffle, and the 32 lanes read each in-range corner as one
// 128-byte row of the flat (B, N_tok, heads, 32) value tokens.
//
// Arithmetic: the plain version's order, every op rounded on its own (the
// library is built with -fmad=false): xs = x * W - 0.5, floor, the four
// corner terms v*(1-wy)*(1-wx), v*(1-wy)*wx, v*wy*(1-wx), v*wy*wx summed
// left to right, times the weight, the points summed in order from 0, the
// levels likewise. A corner outside its map reads 0 (grid_sample's
// padding_mode='zeros', erd_tpu's masked read). Kernel and plain version
// agree to the bit.
//
// Bound on this card: bytes. At the encoder's Q = 22323 tokens (800x1344)
// the call must read the 22.9 MB value tokens, 22.9 MB of locations and
// 11.4 MB of weights and write 22.9 MB: ~80 MB, 0.024 ms at 3.35 TB/s. The
// corner reads (16 samples x 4 corners x 128 B per warp, 1.46 GB in all)
// hit mostly in the 50 MB L2, which holds the whole value tensor.
//
// The backward (`erd_ms_deform_attn_backward`) replaces erd_tpu's autodiff
// of the same sampler (XLA's transpose of the gathers: scatter-adds into
// the value maps, and elementwise products for the location and weight
// gradients). It takes the forward's thread layout and recomputes every
// sample from the locations (nothing is stored by the forward). Per
// sample, with the four corner coefficients c_k and corner values v_k (0
// off the map) and the lane's output gradient g:
//   d weight = sum over channels of g * (sum_k c_k v_k), a shuffle-reduce;
//   d loc_x  = weight * W * sum_c g * ((v01 - v00)(1 - wy) + (v11 - v10) wy)
//   d loc_y  = weight * H * sum_c g * ((v10 - v00)(1 - wx) + (v11 - v01) wx)
//   (floor's derivative is 0, as in JAX);
//   d values += weight * c_k * g at each in-range corner, a float32
//   atomicAdd (red.global.add.f32) of the 32 lanes into one 128-byte row
//   of the zeroed (B, N_tok, heads, 32) buffer. A corner off its map reads
//   0 and receives nothing.
// NOT DETERMINISTIC: the atomics add a value row's contributions in the
// order the warps reach it, which changes from run to run; the location
// and weight gradients are deterministic (one warp each).
// Bound: bytes. At the encoder's call at batch 16 (Q = N_tok = 22323) the
// function reads values, output gradient and locations (366 MB each) and
// weights (183 MB), and writes d values and d locations (366 MB each) and
// d weights (183 MB): ~2.2 GB, 0.65 ms at 3.35 TB/s. The 64 atomic row
// adds per warp (45.7 M per call) to a 366 MB buffer that no longer sits
// in the 50 MB L2 are what the design leaves to a later kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[4];
  int w[4];
  int start[4];
};

__device__ __forceinline__ float corner(const float* v, int y, int x, int h,
                                        int w, int row_stride) {
  if (y < 0 || y >= h || x < 0 || x >= w) return 0.f;
  return v[(static_cast<size_t>(y) * w + x) * row_stride];
}

__global__ void ms_deform_attn_kernel(const float* __restrict__ value,
                                      const float* __restrict__ loc,
                                      const float* __restrict__ attn,
                                      Levels lv, int n_tok, int q, int heads,
                                      int levels, int points,
                                      long long warps,
                                      float* __restrict__ out) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= warps) return;  // whole warps: blockDim is a multiple of 32
  const int head = static_cast<int>(warp % heads);
  const long long b = warp / heads / q;
  const int samples = levels * points;

  // sample `lane`: corner indices, fractions and weight
  int sx = 0, sy = 0;
  float fx = 0.f, fy = 0.f, aw = 0.f;
  if (lane < samples) {
    const int lvl = lane / points;
    const float* l = loc + (warp * samples + lane) * 2;
    const float xs = __fsub_rn(__fmul_rn(l[0], static_cast<float>(lv.w[lvl])),
                               0.5f);
    const float ys = __fsub_rn(__fmul_rn(l[1], static_cast<float>(lv.h[lvl])),
                               0.5f);
    const float x0 = floorf(xs);
    const float y0 = floorf(ys);
    fx = __fsub_rn(xs, x0);
    fy = __fsub_rn(ys, y0);
    sx = static_cast<int>(x0);
    sy = static_cast<int>(y0);
    aw = attn[warp * samples + lane];
  }

  const int row_stride = heads * 32;
  const float* vb = value + (static_cast<size_t>(b) * n_tok * heads + head) *
                                32 + lane;
  float total = 0.f;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int h = lv.h[lvl], w = lv.w[lvl];
    const float* v = vb + static_cast<size_t>(lv.start[lvl]) * row_stride;
    float acc = 0.f;
    for (int p = 0; p < points; ++p) {
      const int s = lvl * points + p;
      const int x0 = __shfl_sync(kFull, sx, s);
      const int y0 = __shfl_sync(kFull, sy, s);
      const float wx = __shfl_sync(kFull, fx, s);
      const float wy = __shfl_sync(kFull, fy, s);
      const float a = __shfl_sync(kFull, aw, s);
      const float hx = __fsub_rn(1.f, wx);
      const float hy = __fsub_rn(1.f, wy);
      float samp = __fmul_rn(__fmul_rn(corner(v, y0, x0, h, w, row_stride),
                                       hy), hx);
      samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(
          corner(v, y0, x0 + 1, h, w, row_stride), hy), wx));
      samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(
          corner(v, y0 + 1, x0, h, w, row_stride), wy), hx));
      samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(
          corner(v, y0 + 1, x0 + 1, h, w, row_stride), wy), wx));
      acc = __fadd_rn(acc, __fmul_rn(samp, a));
    }
    total = __fadd_rn(total, acc);
  }
  out[warp * 32 + lane] = total;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void corner_add(float* gv, int y, int x, int h,
                                           int w, int row_stride, float v) {
  if (y < 0 || y >= h || x < 0 || x >= w) return;
  atomicAdd(gv + (static_cast<size_t>(y) * w + x) * row_stride, v);
}

__global__ void ms_deform_attn_backward_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ grad_out,
    Levels lv, int n_tok, int q, int heads, int levels, int points,
    long long warps, float* __restrict__ grad_value,
    float* __restrict__ grad_loc, float* __restrict__ grad_attn) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= warps) return;  // whole warps: blockDim is a multiple of 32
  const int head = static_cast<int>(warp % heads);
  const long long b = warp / heads / q;
  const int samples = levels * points;

  int sx = 0, sy = 0;
  float fx = 0.f, fy = 0.f, aw = 0.f;
  if (lane < samples) {
    const int lvl = lane / points;
    const float* l = loc + (warp * samples + lane) * 2;
    const float xs = __fsub_rn(__fmul_rn(l[0], static_cast<float>(lv.w[lvl])),
                               0.5f);
    const float ys = __fsub_rn(__fmul_rn(l[1], static_cast<float>(lv.h[lvl])),
                               0.5f);
    const float x0 = floorf(xs);
    const float y0 = floorf(ys);
    fx = __fsub_rn(xs, x0);
    fy = __fsub_rn(ys, y0);
    sx = static_cast<int>(x0);
    sy = static_cast<int>(y0);
    aw = attn[warp * samples + lane];
  }

  const int row_stride = heads * 32;
  const size_t base = (static_cast<size_t>(b) * n_tok * heads + head) * 32 +
                      lane;
  const float* vb = value + base;
  float* gb = grad_value + base;
  const float g = grad_out[warp * 32 + lane];
  float my_dw = 0.f, my_dx = 0.f, my_dy = 0.f;  // sample `lane`'s results
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int h = lv.h[lvl], w = lv.w[lvl];
    const size_t off = static_cast<size_t>(lv.start[lvl]) * row_stride;
    const float* v = vb + off;
    float* gv = gb + off;
    for (int p = 0; p < points; ++p) {
      const int s = lvl * points + p;
      const int x0 = __shfl_sync(kFull, sx, s);
      const int y0 = __shfl_sync(kFull, sy, s);
      const float wx = __shfl_sync(kFull, fx, s);
      const float wy = __shfl_sync(kFull, fy, s);
      const float a = __shfl_sync(kFull, aw, s);
      const float hx = __fsub_rn(1.f, wx);
      const float hy = __fsub_rn(1.f, wy);
      const float v00 = corner(v, y0, x0, h, w, row_stride);
      const float v01 = corner(v, y0, x0 + 1, h, w, row_stride);
      const float v10 = corner(v, y0 + 1, x0, h, w, row_stride);
      const float v11 = corner(v, y0 + 1, x0 + 1, h, w, row_stride);
      float samp = __fmul_rn(__fmul_rn(v00, hy), hx);
      samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(v01, hy), wx));
      samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(v10, wy), hx));
      samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(v11, wy), wx));
      const float gx = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), hy),
                                 __fmul_rn(__fsub_rn(v11, v10), wy));
      const float gy = __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), hx),
                                 __fmul_rn(__fsub_rn(v11, v01), wx));
      const float dw = warp_sum(__fmul_rn(g, samp));
      const float dx = warp_sum(__fmul_rn(g, gx));
      const float dy = warp_sum(__fmul_rn(g, gy));
      if (lane == s) {
        my_dw = dw;
        my_dx = __fmul_rn(__fmul_rn(dx, a), static_cast<float>(w));
        my_dy = __fmul_rn(__fmul_rn(dy, a), static_cast<float>(h));
      }
      const float ag = __fmul_rn(a, g);
      corner_add(gv, y0, x0, h, w, row_stride, __fmul_rn(ag,
                                                         __fmul_rn(hy, hx)));
      corner_add(gv, y0, x0 + 1, h, w, row_stride,
                 __fmul_rn(ag, __fmul_rn(hy, wx)));
      corner_add(gv, y0 + 1, x0, h, w, row_stride,
                 __fmul_rn(ag, __fmul_rn(wy, hx)));
      corner_add(gv, y0 + 1, x0 + 1, h, w, row_stride,
                 __fmul_rn(ag, __fmul_rn(wy, wx)));
    }
  }
  if (lane < samples) {
    grad_attn[warp * samples + lane] = my_dw;
    grad_loc[(warp * samples + lane) * 2] = my_dx;
    grad_loc[(warp * samples + lane) * 2 + 1] = my_dy;
  }
}

}  // namespace

// value (B, n_tok, heads, 32), loc (B, q, heads, levels, points, 2),
// attn (B, q, heads, levels, points), out (B, q, heads, 32): float32.
// Level l is the (h_l, w_l) map at rows start_l of the tokens; unused
// levels have h = w = 0. levels * points <= 32.
// Returns cudaGetLastError() after the launch.
extern "C" int erd_ms_deform_attn(const void* value, const void* loc,
                                  const void* attn, void* out, int h0, int w0,
                                  int h1, int w1, int h2, int w2, int h3,
                                  int w3, int s0, int s1, int s2, int s3,
                                  int batch, int n_tok, int q, int heads,
                                  int levels, int points, void* stream) {
  const long long warps = static_cast<long long>(batch) * q * heads;
  if (warps <= 0) return 0;
  if (levels < 1 || levels > 4 || levels * points > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {{h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  const int threads = 256;
  const long long warps_per_block = threads / 32;
  const unsigned blocks =
      static_cast<unsigned>((warps + warps_per_block - 1) / warps_per_block);
  ms_deform_attn_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), lv, n_tok, q, heads, levels, points,
      warps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The gradients of erd_ms_deform_attn: grad_out (B, q, heads, 32) float32
// in; grad_value (B, n_tok, heads, 32) float32, ZEROED by the caller and
// accumulated with atomics; grad_loc (B, q, heads, levels, points, 2) and
// grad_attn (B, q, heads, levels, points) float32, written. Other arguments
// as erd_ms_deform_attn's. Returns cudaGetLastError() after the launch.
extern "C" int erd_ms_deform_attn_backward(
    const void* value, const void* loc, const void* attn,
    const void* grad_out, void* grad_value, void* grad_loc, void* grad_attn,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3, int s0,
    int s1, int s2, int s3, int batch, int n_tok, int q, int heads,
    int levels, int points, void* stream) {
  const long long warps = static_cast<long long>(batch) * q * heads;
  if (warps <= 0) return 0;
  if (levels < 1 || levels > 4 || levels * points > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {{h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  const int threads = 256;
  const long long warps_per_block = threads / 32;
  const unsigned blocks =
      static_cast<unsigned>((warps + warps_per_block - 1) / warps_per_block);
  ms_deform_attn_backward_kernel<<<blocks, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(grad_out),
      lv, n_tok, q, heads, levels, points, warps,
      static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
      static_cast<float*>(grad_attn));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
