// Deformable im2col (DCNv1 / DCNv2 bilinear gather), hand-written for
// Hopper (sm_90a).
//
// Replaces: the gather half of erd_tpu/ops/deform_conv.py `deform_conv2d`
// (`_bilinear_zero` and the per-deform-group patch loop), as
// `ModulatedDeformConv` (the ResNet DCN plugin) and the VFNet head's star
// deformable convolutions call it. On the TPU, XLA lowered the four corner
// reads of every (output pixel, kernel point) to dynamic gathers of whole
// channel rows and handed the (Ho*Wo, K*K*Cin) patches to one MXU GEMM.
// Here the columns go to device memory and the GEMM stays torch.matmul.
//
// Thread layout: one thread per (image, deform group, channel chunk, kernel
// point, output pixel), the output pixel fastest. A thread computes its
// sample location, the four corner indices with their in-map flags and the
// bilinear fractions once (and reads its mask value), then loops over the
// chunk's channels (16 of the group's): four reads of the NCHW map (bf16
// maps widened in registers) and one float32 write of the columns
// (B, Cin*K*K, Ho*Wo), row c*K*K + k. Neighbouring threads take
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
// Bound on this card: bytes. The call must read the map (B*Cin*H*W
// elements) and the offsets and masks, and write the columns, K*K = 9
// times the output map's size in float32: at the VFNet head's P3 call
// (bf16 256 x 100 x 168 at 800x1344) 8.6 MB read and 155 MB written,
// 0.049 ms at 3.35 TB/s. The corner reads (4 per column element) are
// served mostly from L2.
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

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
