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
// Arithmetic: the plain version's order, every op rounded on its own (the
// library is built with -fmad=false): xs = x * W - 0.5, floor, the four
// corner terms v*(1-wy)*(1-wx), v*(1-wy)*wx, v*wy*(1-wx), v*wy*wx summed
// left to right, times the weight, the points summed in order from 0, the
// levels likewise. A corner outside its map reads 0 (grid_sample's
// padding_mode='zeros', erd_tpu's masked read). Kernel and plain version
// agree to the bit.
//
// Design. The first design ran a warp per (batch, query, head) and a lane
// per channel: lane s computed sample s's corners and weight, 5 shuffles
// broadcast each sample to the warp (80 a warp), lanes 16-31 idled
// through that, and every corner was a scalar 4-byte load a lane, a warp
// instruction fetching one 128-byte value row. That layout is bound by
// issue, not by memory (erd_tpu_torch/tools/atomic_backward_probe.py
// found the same layout issue-bound in the backward). Now a lane holds 4
// channels (a float4) and 8 lanes a head's 128-byte row, so a warp serves
// 4 (batch, query, head) triples, one a lane group. Each group loads its
// own triple's locations and weights (the 8 lanes read one address) and
// walks its samples in the plain version's order; groups never combine,
// so no shuffles, and a ragged last warp's idle groups just leave. A
// corner is one float4 load a lane: 4 value rows a warp instruction.
//
// Bound on this card: bytes. At the encoder's Q = 22323 tokens (800x1344)
// the call must read the 22.9 MB value tokens, 22.9 MB of locations and
// 11.4 MB of weights and write 22.9 MB: ~80 MB, 0.024 ms at 3.35 TB/s
// (16 times that at the training step's batch of 16). The corner reads
// (16 samples x 4 corners x 128 B per triple, 1.46 GB an image) hit
// mostly in the 50 MB L2; the float32 arithmetic, 13 operations a
// channel and sample rounded one by one, is ~0.6 ms of the card's
// non-FMA issue rate at batch 16.
//
// The backward (`erd_ms_deform_attn_backward`) replaces erd_tpu's autodiff
// of the same sampler (XLA's transpose of the gathers: scatter-adds into
// the value maps, and elementwise products for the location and weight
// gradients). It recomputes every sample from the locations (nothing is
// stored by the forward). Per sample, with the four corner coefficients
// c_k and corner values v_k (0 off the map) and the output gradient g:
//   d weight = sum over channels of g * (sum_k c_k v_k);
//   d loc_x  = weight * W * sum_c g * ((v01 - v00)(1 - wy) + (v11 - v10) wy)
//   d loc_y  = weight * H * sum_c g * ((v10 - v00)(1 - wx) + (v11 - v01) wx)
//   (floor's derivative is 0, as in JAX);
//   d values += weight * c_k * g at each in-range corner, into the zeroed
//   float32 (B, N_tok, heads, 32) buffer. A corner off its map reads 0 and
//   receives nothing.
// NOT DETERMINISTIC: atomics add a value row's contributions in the order
// they reach it, which changes from run to run; the location and weight
// gradients are deterministic.
//
// Design. The first design ran a warp per (batch, query, head), a lane
// per channel, one sample at a time: 5 shuffles to broadcast the sample,
// three 5-step warp sums, 4 row-wide atomics. Its 13.0 ms at the
// encoder's call were issue, not contention: with 3/4 of the samples moved
// off their maps (no loads, no atomics) it still took 9.8 ms, and no level
// cost more than another (erd_tpu_torch/tools/atomic_backward_probe.py on
// an H100). Now:
//   - A lane holds 4 channels (a float4), 8 lanes a 128-byte row, so a
//     warp works on 4 samples at once (lane group j on point j of a level
//     of one query, a query's 16 samples in 4 rounds); each group loads
//     its own sample's location and weight (the 8 lanes read one address)
//     instead of taking it by shuffles; corner reads and value-gradient
//     adds are float4 (sm_90's vectorized global atomicAdd, one a lane).
//   - The three channel sums of a round are one reduce-scatter over the 8
//     lanes of a group: 15 shuffles for 4 samples where the first design
//     spent 80 (with the broadcasts), pairing the channels in its order (c
//     with c^16, c^8, c^4 across lanes, then c^2, c^1 within a lane): the
//     location and weight gradients are the first design's sums, in the
//     same order, and deterministic.
//   - A block owns one (image, head) and a run of its queries, 8 warps of
//     consecutive queries, so that the blocks in flight share a few heads'
//     values and value gradient in L2 (ops/ms_deform_attn.py
//     `ms_deform_attn_backward_run` sizes the run to the call).
//   - The value gradient's adds stay global float4 atomics on every level.
//     A float32 copy of the coarse levels in shared memory, flushed once a
//     block, was built and measured: shared-memory float atomics are
//     compare-and-swap loops on this card (ATOMS.CAST.SPIN), dearer than
//     the global float4 adds unless the samples crowd a handful of rows,
//     which the DETR configs' calls do not.
// Bound: bytes. At the encoder's call at batch 16 (Q = N_tok = 22323) the
// function reads values, output gradient and locations (366 MB each) and
// weights (183 MB), and writes d values and d locations (366 MB each) and
// d weights (183 MB): ~2.2 GB, 0.65 ms at 3.35 TB/s. What the kernel moves
// through L2 is larger: 128 bytes of values and a 128-byte atomic a
// corner, 47 GB in all, and ~100 instructions a sample.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[4];
  int w[4];
  int start[4];
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}


__device__ __forceinline__ float4 corner4(const float4* v, int y, int x,
                                          int h, int w, size_t tok_stride) {
  if (y < 0 || y >= h || x < 0 || x >= w) return zero4();
  return v[(static_cast<size_t>(y) * w + x) * tok_stride];
}

// one channel's bilinear sample, the plain version's order
__device__ __forceinline__ float bilinear(float v00, float v01, float v10,
                                          float v11, float hy, float hx,
                                          float wy, float wx) {
  float samp = __fmul_rn(__fmul_rn(v00, hy), hx);
  samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(v01, hy), wx));
  samp = __fadd_rn(samp, __fmul_rn(__fmul_rn(v10, wy), hx));
  return __fadd_rn(samp, __fmul_rn(__fmul_rn(v11, wy), wx));
}

// Lane group j = lane >> 3 of a warp on (batch, query, head) triple 4 *
// warp + j; lane m = lane & 7 holds channels 4m..4m+3.
__global__ void __launch_bounds__(256)
ms_deform_attn_kernel(const float* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, Levels lv, int n_tok,
                      int q, int heads, int levels, int points,
                      long long triples, float* __restrict__ out) {
  const long long tri =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 3;
  if (tri >= triples) return;  // no shuffles: idle groups may leave
  const int m = threadIdx.x & 7;
  const int head = static_cast<int>(tri % heads);
  const long long b = tri / heads / q;
  const int samples = levels * points;
  const size_t tok_stride = static_cast<size_t>(heads) * 8;  // float4s
  const float4* vb = reinterpret_cast<const float4*>(value) +
                     (static_cast<size_t>(b) * n_tok * heads + head) * 8 + m;
  const float2* l2 = reinterpret_cast<const float2*>(loc) + tri * samples;
  const float* aw = attn + tri * samples;
  float4 total = zero4();
#pragma unroll
  for (int lvl = 0; lvl < 4; ++lvl) {
    if (lvl >= levels) break;
    const int h = lv.h[lvl], w = lv.w[lvl];
    const float fw = static_cast<float>(w), fh = static_cast<float>(h);
    const float4* v = vb + static_cast<size_t>(lv.start[lvl]) * tok_stride;
    float4 acc = zero4();
    for (int p = 0; p < points; ++p) {
      const int s = lvl * points + p;
      const float2 l = l2[s];
      const float a = aw[s];
      const float xs = __fsub_rn(__fmul_rn(l.x, fw), 0.5f);
      const float ys = __fsub_rn(__fmul_rn(l.y, fh), 0.5f);
      const float x0f = floorf(xs), y0f = floorf(ys);
      const float wx = __fsub_rn(xs, x0f), wy = __fsub_rn(ys, y0f);
      const float hx = __fsub_rn(1.f, wx), hy = __fsub_rn(1.f, wy);
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
      const float4 c00 = corner4(v, y0, x0, h, w, tok_stride);
      const float4 c01 = corner4(v, y0, x0 + 1, h, w, tok_stride);
      const float4 c10 = corner4(v, y0 + 1, x0, h, w, tok_stride);
      const float4 c11 = corner4(v, y0 + 1, x0 + 1, h, w, tok_stride);
      acc.x = __fadd_rn(acc.x, __fmul_rn(bilinear(c00.x, c01.x, c10.x, c11.x,
                                                  hy, hx, wy, wx), a));
      acc.y = __fadd_rn(acc.y, __fmul_rn(bilinear(c00.y, c01.y, c10.y, c11.y,
                                                  hy, hx, wy, wx), a));
      acc.z = __fadd_rn(acc.z, __fmul_rn(bilinear(c00.z, c01.z, c10.z, c11.z,
                                                  hy, hx, wy, wx), a));
      acc.w = __fadd_rn(acc.w, __fmul_rn(bilinear(c00.w, c01.w, c10.w, c11.w,
                                                  hy, hx, wy, wx), a));
    }
    total = make_float4(__fadd_rn(total.x, acc.x), __fadd_rn(total.y, acc.y),
                        __fadd_rn(total.z, acc.z), __fadd_rn(total.w, acc.w));
  }
  reinterpret_cast<float4*>(out)[tri * 8 + m] = total;
}

// One round's three channel sums (weight, x, y) of the 4 samples of a warp
// (lane group j = lane >> 3 on one sample; lane m = lane & 7 holds channels
// 4m..4m+3 in components 0..3). The pairs are the first design's warp sum
// over lanes = channels c: c with c^16, c^8, c^4 (lane bits 2, 1, 0), then
// c^2 and c^1 (components): ((v0 + v2) + (v1 + v3)) of the lane sums.
// A reduce-scatter: 6 + 3 + 3 shuffles leave lanes (b2, b1) with 3 of the
// 12 lane sums, {W0 W2 X0}, {W1 W3 X1}, {X2 Y0 Y2}, {X3 Y1 Y3}; 3 more
// finish. Float addition commutes exactly, so which lane of a pair adds
// does not change a bit. Lanes with m < 4 return d weight (first) and d x
// (second), lanes with m >= 4 d y (first).
__device__ __forceinline__ float2 round_sums(const float (&wv)[4],
                                             const float (&xv)[4],
                                             const float (&yv)[4], int m) {
  const bool b2 = (m & 4) != 0, b1 = (m & 2) != 0;
  // set P (kept by b2 = 0) and Q (kept by b2 = 1)
  const float p[6] = {wv[0], wv[2], xv[0], wv[1], wv[3], xv[1]};
  const float q[6] = {xv[2], yv[0], yv[2], xv[3], yv[1], yv[3]};
  float k6[6];
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const float got = __shfl_xor_sync(kFull, b2 ? p[t] : q[t], 4);
    k6[t] = __fadd_rn(b2 ? q[t] : p[t], got);
  }
  float k3[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float got = __shfl_xor_sync(kFull, b1 ? k6[t] : k6[t + 3], 2);
    k3[t] = __fadd_rn(b1 ? k6[t + 3] : k6[t], got);
  }
#pragma unroll
  for (int t = 0; t < 3; ++t)
    k3[t] = __fadd_rn(k3[t], __shfl_xor_sync(kFull, k3[t], 1));
  // b2 = 0: a = W0 + W2 (or W1 + W3), x part X0 (X1); b2 = 1: c = Y0 + Y2
  // (Y1 + Y3), x part X2 (X3)
  const float pair = b2 ? __fadd_rn(k3[1], k3[2]) : __fadd_rn(k3[0], k3[1]);
  const float xpart = b2 ? k3[0] : k3[2];
  const float xo = __shfl_xor_sync(kFull, xpart, 4);
  const float e = __fadd_rn(xpart, xo);  // X0 + X2 or X1 + X3
  const float po = __shfl_xor_sync(kFull, pair, 2);
  const float eo = __shfl_xor_sync(kFull, e, 2);
  return make_float2(__fadd_rn(pair, po), __fadd_rn(e, eo));
}

__device__ __forceinline__ float4 scaled(float4 g, float c) {
  return make_float4(__fmul_rn(g.x, c), __fmul_rn(g.y, c), __fmul_rn(g.z, c),
                     __fmul_rn(g.w, c));
}

// Block: one (image, head) and the queries [r * run, (r + 1) * run) of
// it, r = blockIdx.x % runs; each warp a contiguous part of them, one
// query at a time. A round of a warp is 4 samples, one a lane group: the 4
// points of one level (a query's 16 samples in 4 rounds).
__global__ void __launch_bounds__(256)
ms_deform_attn_backward_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ grad_out,
    Levels table, int n_tok, int q, int heads, int levels, int points,
    int run, int runs, float* __restrict__ grad_value,
    float* __restrict__ grad_loc, float* __restrict__ grad_attn) {
  __shared__ Levels lt;  // indexed by level: shared, not parameters
  if (threadIdx.x == 0) lt = table;
  __syncthreads();

  const int r = blockIdx.x % runs;
  const int pair = blockIdx.x / runs;
  const int head = pair % heads;
  const long long b = pair / heads;
  const int lane = threadIdx.x & 31, grp = lane >> 3, m = lane & 7;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int samples = levels * points;
  const int per_warp = (run + nwarps - 1) / nwarps;
  const int q_lo = r * run + warp * per_warp;
  const int q_hi = min(min(q, (r + 1) * run), q_lo + per_warp);
  // float4 index of channel 4m of token 0's row of (b, head); a token is
  // `heads` rows further
  const size_t row0 = (static_cast<size_t>(b) * n_tok * heads + head) * 8 + m;
  const size_t tok_stride = static_cast<size_t>(heads) * 8;
  const float4* v4 = reinterpret_cast<const float4*>(value);
  float4* gv4 = reinterpret_cast<float4*>(grad_value);
  const int rounds = (samples + 3) / 4;

  for (int qi = q_lo; qi < q_hi; ++qi) {
    const long long wq = (b * q + qi) * heads + head;
    const float4 g = reinterpret_cast<const float4*>(grad_out)[wq * 8 + m];
    const float gv[4] = {g.x, g.y, g.z, g.w};
    for (int rd = 0; rd < rounds; ++rd) {
      const int s = rd * 4 + grp;
      const bool valid = s < samples;
      const int sc = s < samples ? s : samples - 1;
      const int lvl = sc / points;
      const int h = lt.h[lvl], w = lt.w[lvl], start = lt.start[lvl];
      const float2 l = reinterpret_cast<const float2*>(loc)[wq * samples + sc];
      const float a = attn[wq * samples + sc];
      const float xs = __fsub_rn(__fmul_rn(l.x, static_cast<float>(w)), 0.5f);
      const float ys = __fsub_rn(__fmul_rn(l.y, static_cast<float>(h)), 0.5f);
      const float x0f = floorf(xs);
      const float y0f = floorf(ys);
      const float wx = __fsub_rn(xs, x0f), wy = __fsub_rn(ys, y0f);
      const float hx = __fsub_rn(1.f, wx), hy = __fsub_rn(1.f, wy);
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
      const bool iny0 = y0 >= 0 && y0 < h, iny1 = y0 + 1 >= 0 && y0 + 1 < h;
      const bool inx0 = x0 >= 0 && x0 < w, inx1 = x0 + 1 >= 0 && x0 + 1 < w;
      const bool ok00 = valid && iny0 && inx0, ok01 = valid && iny0 && inx1;
      const bool ok10 = valid && iny1 && inx0, ok11 = valid && iny1 && inx1;
      const long long t00 = start + static_cast<long long>(y0) * w + x0;
      const size_t i00 = row0 + static_cast<size_t>(t00) * tok_stride;
      const float4 c00 = ok00 ? v4[i00] : zero4();
      const float4 c01 = ok01 ? v4[i00 + tok_stride] : zero4();
      const float4 c10 = ok10 ? v4[i00 + w * tok_stride] : zero4();
      const float4 c11 = ok11 ? v4[i00 + (w + 1) * tok_stride] : zero4();
      float wv[4], xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v00 = comp(c00, i), v01 = comp(c01, i);
        const float v10 = comp(c10, i), v11 = comp(c11, i);
        const float samp = bilinear(v00, v01, v10, v11, hy, hx, wy, wx);
        const float gx = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), hy),
                                   __fmul_rn(__fsub_rn(v11, v10), wy));
        const float gy = __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), hx),
                                   __fmul_rn(__fsub_rn(v11, v01), wx));
        wv[i] = __fmul_rn(gv[i], samp);
        xv[i] = __fmul_rn(gv[i], gx);
        yv[i] = __fmul_rn(gv[i], gy);
      }
      const float2 sums = round_sums(wv, xv, yv, m);
      if (valid) {
        const long long at = wq * samples + s;
        if (m == 0) {
          grad_attn[at] = sums.x;
          grad_loc[at * 2] = __fmul_rn(__fmul_rn(sums.y, a),
                                       static_cast<float>(w));
        } else if (m == 4) {
          grad_loc[at * 2 + 1] = __fmul_rn(__fmul_rn(sums.x, a),
                                           static_cast<float>(h));
        }
      }
      const float4 ag = scaled(g, a);
      const float4 d00 = scaled(ag, __fmul_rn(hy, hx));
      const float4 d01 = scaled(ag, __fmul_rn(hy, wx));
      const float4 d10 = scaled(ag, __fmul_rn(wy, hx));
      const float4 d11 = scaled(ag, __fmul_rn(wy, wx));
      if (ok00) atomicAdd(gv4 + i00, d00);
      if (ok01) atomicAdd(gv4 + i00 + tok_stride, d01);
      if (ok10) atomicAdd(gv4 + i00 + w * tok_stride, d10);
      if (ok11) atomicAdd(gv4 + i00 + (w + 1) * tok_stride, d11);
    }
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
  const long long triples = static_cast<long long>(batch) * q * heads;
  if (triples <= 0) return 0;
  if (levels < 1 || levels > 4 || levels * points > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {{h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  const int threads = 256;
  const long long per_block = threads / 8;  // lane groups of 8
  const unsigned blocks =
      static_cast<unsigned>((triples + per_block - 1) / per_block);
  ms_deform_attn_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), lv, n_tok, q, heads, levels, points,
      triples, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The gradients of erd_ms_deform_attn: grad_out (B, q, heads, 32) float32
// in; grad_value (B, n_tok, heads, 32) float32, ZEROED by the caller and
// accumulated with atomics; grad_loc (B, q, heads, levels, points, 2) and
// grad_attn (B, q, heads, levels, points) float32, written. A block of
// 256 threads takes `run` queries of one (image, head) (ops/
// ms_deform_attn.py `ms_deform_attn_backward_run`). Other arguments as
// erd_ms_deform_attn's. One launch. Returns cudaGetLastError() after it.
extern "C" int erd_ms_deform_attn_backward(
    const void* value, const void* loc, const void* attn,
    const void* grad_out, void* grad_value, void* grad_loc, void* grad_attn,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3, int s0,
    int s1, int s2, int s3, int batch, int n_tok, int q, int heads,
    int levels, int points, int run, void* stream) {
  if (static_cast<long long>(batch) * q * heads <= 0) return 0;
  if (levels < 1 || levels > 4 || levels * points > 32 || points < 1 ||
      run < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {{h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  const int runs = (q + run - 1) / run;
  const long long blocks = static_cast<long long>(batch) * heads * runs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ms_deform_attn_backward_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const float*>(grad_out),
      lv, n_tok, q, heads, levels, points, run, runs,
      static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
      static_cast<float*>(grad_attn));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
