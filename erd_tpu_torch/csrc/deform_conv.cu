// Deformable im2col (DCNv1 / DCNv2 bilinear gather) and its backward,
// hand-written for Hopper (sm_90a).
//
// Replaces: the gather half of erd_tpu/ops/deform_conv.py `deform_conv2d`
// (`_bilinear_zero` and the per-deform-group patch loop), as
// `ModulatedDeformConv` (the ResNet DCN plugin) and the VFNet head's star
// deformable convolutions call it, and its autodiff in training (the
// transpose of those gathers). On the TPU, XLA lowered the four corner
// reads of every (output pixel, kernel point) to dynamic gathers of whole
// channel rows and handed the (Ho*Wo, K*K*Cin) patches to one MXU GEMM;
// jax.grad turned the gathers into scatter-adds. Here the columns go to
// device memory and the GEMM (forward and backward) stays torch.matmul.
//
// Forward thread layout: one thread per (image, deform group, channel
// chunk, kernel point, output pixel), the output pixel fastest. A thread
// computes its sample location, the four corner indices with their in-map
// flags and the bilinear fractions once (and reads its mask value), then
// loops over the chunk's channels (16 of the group's): four reads of the
// NCHW map (bf16 maps widened in registers) and one float32 write of the
// columns (B, Cin*K*K, Ho*Wo), row c*K*K + k. Neighbouring threads take
// neighbouring output pixels, so the column writes are coalesced and the
// corner reads of a warp fall on one or two rows of the plane. Splitting
// the channels into chunks keeps enough threads in flight on the small
// maps of layer4 (1050 pixels x 9 points at 800x1344).
//
// Arithmetic: the plain version's order, every op rounded on its own (the
// library is built with -fmad=false): ys = base + dy, floor, wy = ys - y0,
// the corner terms v*(1-wy)*(1-wx), v*(1-wy)*wx, v*wy*(1-wx), v*wy*wx
// summed left to right, times the mask for DCNv2. A corner whose own index
// lies outside the map reads 0 (erd_tpu's per-corner rule). Kernel and
// plain version agree to the bit.
//
// Forward bound on this card: bytes. The call must read the map
// (B*Cin*H*W elements) and the offsets and masks, and write the columns,
// K*K = 9 times the output map's size in float32: at the VFNet head's P3
// call (bf16 256 x 100 x 168 at 800x1344) 8.6 MB read and 155 MB written,
// 0.049 ms at 3.35 TB/s. The corner reads (4 per column element) are
// served mostly from L2.
//
// Backward (erd_deform_im2col_backward): the transpose of the gathers.
// Per sample (output pixel, kernel point) and channel, with the column
// gradient G and the mask m (1 for DCNv1):
//   - d x: ((G*m)*(1-wx))*(1-wy), ((G*m)*wx)*(1-wy), ((G*m)*(1-wx))*wy
//     and ((G*m)*wx)*wy added to the four corners of the float32 map
//     gradient, on-map corners only; the wrapper zeroes the (B, Cin, H, W)
//     float32 buffer and rounds it once to the map's dtype. The adds come
//     in no fixed order: the map gradient is NOT deterministic (a few
//     float32 ulps from run to run);
//   - d dy, d dx: m * sum_c G*((v10-v00)*(1-wx) + (v11-v01)*wx) and
//     m * sum_c G*((v01-v00)*(1-wy) + (v11-v10)*wy), the corner values 0
//     off the map (erd_tpu's per-corner rule under autodiff; floor's
//     derivative is 0);
//   - d mask: sum_c G * sample.
// erd_tpu rounds a bf16 map's per-corner contributions to bf16 before its
// bf16 scatter-add; this kernel sums in float32 and rounds once, so on
// bf16 maps the two differ by bf16 rounding.
//
// Thread layout: a thread per sample (image, deform group, kernel point,
// output pixel), the output pixel fastest, so that a warp's lanes are
// neighbouring pixels of one kernel point and its column-gradient reads
// are coalesced; the offset and mask gradients of a sample are summed by
// one thread over the group's channels in order (deterministic; the first
// design's sums, bit for bit) and written once.
//
// Design. The first design added each column element's four corner
// products with four float32 atomicAdds (2.5e9 at the VFNet P3 head
// call): 12.5 of its 13.15 ms there (erd_tpu_torch/tools/
// atomic_backward_probe.py on an H100). Now:
//   - A warp combines its adds before they leave it. Its lanes' samples
//     are neighbours with similar offsets: lanes whose top-left corners
//     coincide form a run (when they are neighbours), and the run's first
//     lane (the head) adds the run's four sums; a head whose top-left
//     corner is the previous run's top-right one takes that run's right
//     sums into its own left adds. The runs depend on the offsets alone:
//     worked out once (a ballot and a few shuffles), they serve every
//     channel, and a warp with nothing to combine (stride 2) skips the
//     shuffles. With offsets that move neighbours alike, a sample takes
//     two atomics a channel instead of four, on distinct addresses.
//   - The map-gradient threads take a chunk of the group's channels, the
//     chunk slowest over the blocks, so that the blocks in flight add into
//     the same planes; the offset and mask gradients then take blocks of
//     their own in the same launch. The wrapper's plan
//     (ops/deform_conv.py `deform_backward_chunk`) picks the chunk from
//     the call's shape: calls that fill the card many times over keep one
//     chunk (a thread walks all channels once for both gradients, reading
//     the column gradient once); the others split, for the parallelism
//     that the small maps lack.
// Tiled designs that stage a window of the map in shared memory lost on
// the card: shared-memory float atomics are compare-and-swap loops there
// (ATOMS.CAST.SPIN). The probe times one of them beside this kernel
// (csrc/deform_backward_window.cu).
//
// Backward bound on this card: bytes. The call must read the column
// gradient (B*Cin*K*K*Ho*Wo float32), the map, the offsets and masks, and
// write the map gradient in the map's dtype and the offset and mask
// gradients: at the VFNet head's P3 call at bs 16 (bf16 256 x 100 x 168)
// 2.48 GB of column gradient and 0.16 GB more read, 0.16 GB written,
// 0.83 ms at 3.35 TB/s; at an R101 layer3 call (bf16 256 x 50 x 84,
// bs 16) 0.21 ms. The map gradient's atomics, ~1.3e9 after combining at
// the P3 call, set the pace; the star offsets of the VFNet head, 7-9 px
// out with per-pixel jitter, split a warp's adds over more rows and runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float widen(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void deform_im2col_kernel(const T* __restrict__ x,
                                     const float* __restrict__ offset,
                                     const float* __restrict__ mask, int cin,
                                     int h, int w, int ho, int wo, int k,
                                     int stride, int pad, int dil, int dg,
                                     int chunk, int n_chunks, long long total,
                                     float* __restrict__ cols) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= total) return;
  const int hw = ho * wo;
  const int kk = k * k;
  const int pix = static_cast<int>(t % hw);
  long long r = t / hw;
  const int kidx = static_cast<int>(r % kk);
  r /= kk;
  const int part = static_cast<int>(r % n_chunks);
  r /= n_chunks;
  const int g = static_cast<int>(r % dg);
  const long long n = r / dg;

  const int oy = pix / wo, ox = pix % wo;
  const int ky = kidx / k, kx = kidx % k;
  const long long point = (n * dg + g) * kk + kidx;  // (image, group, k)
  const float dy = offset[(point * 2) * hw + pix];
  const float dx = offset[(point * 2 + 1) * hw + pix];
  const float ys = __fadd_rn(static_cast<float>(oy * stride - pad + ky * dil),
                             dy);
  const float xs = __fadd_rn(static_cast<float>(ox * stride - pad + kx * dil),
                             dx);
  const float y0f = floorf(ys);
  const float x0f = floorf(xs);
  const float wy = __fsub_rn(ys, y0f);
  const float wx = __fsub_rn(xs, x0f);
  const float hy = __fsub_rn(1.f, wy);
  const float hx = __fsub_rn(1.f, wx);
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const bool iny0 = y0 >= 0 && y0 < h, iny1 = y0 + 1 >= 0 && y0 + 1 < h;
  const bool inx0 = x0 >= 0 && x0 < w, inx1 = x0 + 1 >= 0 && x0 + 1 < w;
  const long long i00 = static_cast<long long>(y0) * w + x0;  // may be < 0
  const float m = mask != nullptr ? mask[point * hw + pix] : 1.f;

  const int cpg = cin / dg;
  const int c_begin = part * chunk;
  const int c_end = min(cpg, c_begin + chunk);
  for (int c = c_begin; c < c_end; ++c) {
    const int ch = g * cpg + c;
    const T* plane = x + (static_cast<size_t>(n) * cin + ch) * h * w;
    const float v00 = iny0 && inx0 ? widen(plane, i00) : 0.f;
    const float v01 = iny0 && inx1 ? widen(plane, i00 + 1) : 0.f;
    const float v10 = iny1 && inx0 ? widen(plane, i00 + w) : 0.f;
    const float v11 = iny1 && inx1 ? widen(plane, i00 + w + 1) : 0.f;
    float v = __fmul_rn(__fmul_rn(v00, hy), hx);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, hy), wx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), hx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
    if (mask != nullptr) v = __fmul_rn(v, m);
    cols[((static_cast<size_t>(n) * cin + ch) * kk + kidx) * hw + pix] = v;
  }
}

constexpr unsigned kFull = 0xffffffffu;

// The backward's map-gradient adds of one warp, combined before they go
// to the map. A warp's lanes are neighbouring output pixels of one kernel
// point; a lane's sample adds to the left and right corners of two map
// rows. Lanes whose samples share their top-left corner (the same key)
// form a run, when they are neighbours: the run's first lane (its head)
// takes the run's sums; a head whose left corners are the previous run's
// right corners takes that run's right sums too. The runs depend on the
// offsets only, so they are worked out once and serve every channel.
struct WarpRuns {
  int steps;       // doubling steps that sum the longest run
  unsigned same;   // bit j: lane + 2^j lies in this lane's run
  int prev;        // the previous head (the lane's own index: none)
  bool head, merge, consumed;  // merge: take prev's right sums;
                               // consumed: the next head takes ours
};

__device__ __forceinline__ WarpRuns warp_runs(int key, int lane) {
  WarpRuns wr{};
  const int kprev = __shfl_up_sync(kFull, key, 1);
  wr.head = lane == 0 || kprev != key;
  const unsigned heads = __ballot_sync(kFull, wr.head);
  const unsigned below = heads & ((1u << lane) - 1u);
  const int run = __popc(heads & (2u * (1u << lane) - 1u));  // 1-based id
  wr.same = 0u;
  int longest = 1;
  for (int j = 0; j < 5; ++j) {
    const int other = __shfl_down_sync(kFull, run, 1 << j);
    if (lane + (1 << j) < 32 && other == run) wr.same |= 1u << j;
  }
  // the run length at the head: the next head's lane less the head's
  const unsigned above = heads & ~(2u * (1u << lane) - 1u);
  const int next = above ? __ffs(above) - 1 : 32;
  if (wr.head) longest = next - lane;
  for (int off = 16; off > 0; off >>= 1)
    longest = max(longest, __shfl_xor_sync(kFull, longest, off));
  wr.steps = 0;
  while ((1 << wr.steps) < longest) ++wr.steps;
  wr.prev = below ? 31 - __clz(below) : lane;
  const int kp = __shfl_sync(kFull, key, wr.prev);
  const int kn = __shfl_sync(kFull, key, next < 32 ? next : lane);
  wr.merge = wr.head && wr.prev != lane && key >= 0 && kp == key - 1;
  wr.consumed = wr.head && next < 32 && key >= 0 && kn == key + 1;
  return wr;
}

// The run's sum at its head (suffix sums over `steps` doubling steps).
__device__ __forceinline__ float run_sum(float v, const WarpRuns& wr) {
  for (int j = 0; j < wr.steps; ++j) {
    const float u = __shfl_down_sync(kFull, v, 1 << j);
    if (wr.same >> j & 1u) v = __fadd_rn(v, u);
  }
  return v;
}

// One launch, a thread a sample (image, deform group, kernel point, output
// pixel; the pixel fastest) in one of two roles. The first `offset_blocks`
// blocks take the offset and mask gradients, each thread walking all the
// group's channels in order (deterministic). The other blocks take the map
// gradient of `chunk` channels of their samples, the chunk slowest over
// the blocks, their adds combined in the warp (WarpRuns); when a chunk is
// all the group's channels and there are no offset blocks, these threads
// also take the offset and mask gradients (one walk over the channels).
template <typename T>
__global__ void deform_im2col_backward_kernel(
    const T* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const float* __restrict__ grad, int cin,
    int h, int w, int ho, int wo, int k, int stride, int pad, int dil,
    int dg, long long total, long long offset_blocks, int chunk,
    float* __restrict__ grad_x, float* __restrict__ grad_offset,
    float* __restrict__ grad_mask) {
  const bool offset_role = blockIdx.x < offset_blocks;
  const long long bi = offset_role ? blockIdx.x : blockIdx.x - offset_blocks;
  const long long sample_blocks = (total + blockDim.x - 1) / blockDim.x;
  const int cpg = cin / dg;
  const int c_begin =
      offset_role ? 0 : static_cast<int>(bi / sample_blocks) * chunk;
  const int c_end = offset_role ? cpg : min(cpg, c_begin + chunk);
  const bool adds = !offset_role && grad_x != nullptr;
  const bool sums =
      grad_offset != nullptr && (offset_role || offset_blocks == 0);
  const long long t0 = (offset_role ? bi : bi % sample_blocks) *
                           static_cast<long long>(blockDim.x) +
                       threadIdx.x;
  // whole warps stay where they add: the combining shuffles need every lane
  const bool live = t0 < total;
  if (!adds && !live) return;
  const long long t = live ? t0 : total - 1;
  const int lane = threadIdx.x & 31;
  const int hw = ho * wo;
  const int kk = k * k;
  const int pix = static_cast<int>(t % hw);
  long long r = t / hw;
  const int kidx = static_cast<int>(r % kk);
  r /= kk;
  const int g = static_cast<int>(r % dg);
  const long long n = r / dg;

  const int oy = pix / wo, ox = pix % wo;
  const int ky = kidx / k, kx = kidx % k;
  const long long point = (n * dg + g) * kk + kidx;  // (image, group, k)
  const float dy = offset[(point * 2) * hw + pix];
  const float dx = offset[(point * 2 + 1) * hw + pix];
  const float ys = __fadd_rn(static_cast<float>(oy * stride - pad + ky * dil),
                             dy);
  const float xs = __fadd_rn(static_cast<float>(ox * stride - pad + kx * dil),
                             dx);
  const float y0f = floorf(ys);
  const float x0f = floorf(xs);
  const float wy = __fsub_rn(ys, y0f);
  const float wx = __fsub_rn(xs, x0f);
  const float hy = __fsub_rn(1.f, wy);
  const float hx = __fsub_rn(1.f, wx);
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const bool iny0 = y0 >= 0 && y0 < h, iny1 = y0 + 1 >= 0 && y0 + 1 < h;
  const bool inx0 = x0 >= 0 && x0 < w, inx1 = x0 + 1 >= 0 && x0 + 1 < w;
  const bool ok00 = iny0 && inx0, ok01 = iny0 && inx1;
  const bool ok10 = iny1 && inx0, ok11 = iny1 && inx1;
  const long long i00 = static_cast<long long>(y0) * w + x0;  // may be < 0
  const float m = mask != nullptr ? mask[point * hw + pix] : 1.f;

  // the runs: a key per top-left corner of a sample that can touch the
  // map, counting (image, group) plane sets from the warp's first lane's
  // (a warp can span several; keys of two never differ by 1, nor do those
  // of two rows), a distinct negative key otherwise. `hands` (the same in
  // every lane): some head takes the previous run's right sums
  WarpRuns wr{};
  wr.head = true;
  bool hands = false;
  if (adds) {
    const bool touch = live && y0 >= -1 && y0 < h && x0 >= -1 && x0 < w;
    const long long set = n * dg + g;
    const int rel = static_cast<int>(set - __shfl_sync(kFull, set, 0));
    wr = warp_runs(touch ? (rel * (h + 1) + y0 + 1) * (w + 2) + x0 + 1
                         : -2 - lane,
                   lane);
    hands = __any_sync(kFull, wr.merge);
  }

  float sy = 0.f, sx = 0.f, sm = 0.f;
  for (int c = c_begin; c < c_end; ++c) {
    const size_t plane = (static_cast<size_t>(n) * cin + g * cpg + c) *
                         static_cast<size_t>(h) * w;
    const float gc =
        grad[((static_cast<size_t>(n) * cin + g * cpg + c) * kk + kidx) *
                 hw + pix];
    if (adds) {
      const float a = mask != nullptr ? __fmul_rn(gc, m) : gc;
      const float ahx = __fmul_rn(a, hx), awx = __fmul_rn(a, wx);
      float tl = __fmul_rn(ahx, hy), tr = __fmul_rn(awx, hy);
      float bl = __fmul_rn(ahx, wy), br = __fmul_rn(awx, wy);
      if (wr.steps > 0) {
        tl = run_sum(tl, wr);
        tr = run_sum(tr, wr);
        bl = run_sum(bl, wr);
        br = run_sum(br, wr);
      }
      if (hands) {
        const float trp = __shfl_sync(kFull, tr, wr.prev);
        const float brp = __shfl_sync(kFull, br, wr.prev);
        if (wr.merge) {
          tl = __fadd_rn(tl, trp);
          bl = __fadd_rn(bl, brp);
        }
      }
      if (live && wr.head) {
        float* p = grad_x + plane;
        if (ok00) atomicAdd(p + i00, tl);
        if (ok01 && !wr.consumed) atomicAdd(p + i00 + 1, tr);
        if (ok10) atomicAdd(p + i00 + w, bl);
        if (ok11 && !wr.consumed) atomicAdd(p + i00 + w + 1, br);
      }
    }
    if (sums) {
      const T* xp = x + plane;
      const float v00 = ok00 ? widen(xp, i00) : 0.f;
      const float v01 = ok01 ? widen(xp, i00 + 1) : 0.f;
      const float v10 = ok10 ? widen(xp, i00 + w) : 0.f;
      const float v11 = ok11 ? widen(xp, i00 + w + 1) : 0.f;
      const float ty = __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), hx),
                                 __fmul_rn(__fsub_rn(v11, v01), wx));
      const float tx = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), hy),
                                 __fmul_rn(__fsub_rn(v11, v10), wy));
      sy = __fadd_rn(sy, __fmul_rn(gc, ty));
      sx = __fadd_rn(sx, __fmul_rn(gc, tx));
      if (mask != nullptr) {
        float v = __fmul_rn(__fmul_rn(v00, hy), hx);
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, hy), wx));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), hx));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
        sm = __fadd_rn(sm, __fmul_rn(gc, v));
      }
    }
  }
  if (live && sums) {
    grad_offset[(point * 2) * hw + pix] =
        mask != nullptr ? __fmul_rn(sy, m) : sy;
    grad_offset[(point * 2 + 1) * hw + pix] =
        mask != nullptr ? __fmul_rn(sx, m) : sx;
    if (grad_mask != nullptr) grad_mask[point * hw + pix] = sm;
  }
}

}  // namespace

// x (B, cin, h, w) float32 or bf16 (is_bf16); offset (B, dg*k*k*2, ho, wo)
// float32 with channels (group, point, (dy, dx)); mask null or
// (B, dg*k*k, ho, wo) float32; cols (B, cin*k*k, ho*wo) float32.
// `chunk` channels of a group per thread. Returns cudaGetLastError() after
// the launch.
extern "C" int erd_deform_im2col(const void* x, const void* offset,
                                 const void* mask, void* cols, int batch,
                                 int cin, int h, int w, int ho, int wo, int k,
                                 int stride, int pad, int dil, int dg,
                                 int chunk, int is_bf16, void* stream) {
  if (dg < 1 || cin % dg != 0 || chunk < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (cin / dg + chunk - 1) / chunk;
  const long long total = static_cast<long long>(batch) * dg * n_chunks *
                          k * k * ho * wo;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offset);
  const float* msk = static_cast<const float*>(mask);
  float* out = static_cast<float*>(cols);
  if (is_bf16) {
    deform_im2col_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), off, msk, cin, h, w, ho, wo, k,
        stride, pad, dil, dg, chunk, n_chunks, total, out);
  } else {
    deform_im2col_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), off, msk, cin, h, w, ho, wo, k, stride,
        pad, dil, dg, chunk, n_chunks, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradients of erd_deform_im2col for the column gradient `grad`
// (B, cin*k*k, ho*wo) float32, arguments otherwise as there. grad_x null,
// or a ZEROED float32 (B, cin, h, w) buffer the map gradient is added to;
// grad_offset null, or float32 (B, dg*k*k*2, ho, wo); grad_mask null (no
// mask, or offsets not asked for), or float32 (B, dg*k*k, ho, wo).
// chunk: the channels of a group that a map-gradient thread takes (the
// plan, ops/deform_conv.py `deform_backward_chunk`); with fewer than the
// group's, the offset and mask gradients take blocks of their own. One
// launch. Returns cudaGetLastError() after it.
extern "C" int erd_deform_im2col_backward(
    const void* x, const void* offset, const void* mask, const void* grad,
    void* grad_x, void* grad_offset, void* grad_mask, int batch, int cin,
    int h, int w, int ho, int wo, int k, int stride, int pad, int dil,
    int dg, int is_bf16, int chunk, void* stream) {
  if (dg < 1 || cin % dg != 0 || k < 1 || chunk < 1 ||
      (grad_mask != nullptr && (mask == nullptr || grad_offset == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) * dg * k * k * ho *
                          wo;
  if (total <= 0 || (grad_x == nullptr && grad_offset == nullptr)) return 0;
  const int threads = 256;
  const int cpg = cin / dg;
  if (chunk > cpg) chunk = cpg;
  const long long sample_blocks = (total + threads - 1) / threads;
  const long long chunks = (cpg + chunk - 1) / chunk;
  const long long offset_blocks =
      grad_offset != nullptr && (chunks > 1 || grad_x == nullptr)
          ? sample_blocks : 0;
  const long long all = offset_blocks +
                        (grad_x != nullptr ? sample_blocks * chunks : 0);
  if (all > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(all);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offset);
  const float* msk = static_cast<const float*>(mask);
  const float* g = static_cast<const float*>(grad);
  float* gx = static_cast<float*>(grad_x);
  float* goff = static_cast<float*>(grad_offset);
  float* gm = static_cast<float*>(grad_mask);
  if (is_bf16) {
    deform_im2col_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), off, msk, g, cin, h, w, ho, wo,
        k, stride, pad, dil, dg, total, offset_blocks, chunk, gx, goff, gm);
  } else {
    deform_im2col_backward_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), off, msk, g, cin, h, w, ho, wo, k,
        stride, pad, dil, dg, total, offset_blocks, chunk, gx, goff, gm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
