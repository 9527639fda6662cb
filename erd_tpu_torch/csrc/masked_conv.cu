// Masked convolution (mmcv's MaskedConv2d), hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/sampling.py `masked_conv2d` (:57). On the TPU it
// was a dense float32 convolution (K x K, symmetric padding (K - 1) / 2,
// any stride) plus bias, times a 0/1 mask at output resolution: XLA fused
// the mask into the conv's epilogue, and the dense conv cost the same
// whatever the mask. Here, as mmcv designs it, only the masked output
// positions are computed: the caller compacts them (a nonzero over the
// mask) and zeroes the output; the kernel computes each (position, output
// channel) as a float32 FMA chain over Cin * K * K in a fixed order (input
// channel, then kernel row, then kernel column), adds the bias, multiplies
// by the mask's value, and writes it. No library GEMM is involved.
//
// Layout: x (B, Cin, H, W) NCHW float32; the weight rearranged by the
// caller to (Cin, K, K, Co), so that the threads of a warp, one output
// channel each, read neighbouring weights; out (B, Co, Ho, Wo). A block
// takes kPos masked positions and blockDim output channels (grid.y covers
// Co); it stages the kPos input patches of kCin input channels at a time in
// shared memory (zeros where the window leaves the map), and each thread
// keeps kPos sums in registers, so that each weight it reads serves kPos
// FMAs and each patch value in shared memory serves the block's channels.
//
// Bound on this card: operations, 2 * P * Co * Cin * K^2 float32 FLOP for
// P masked positions (19.8 GFLOP for a 3x3, 256 -> 256 conv on a full
// 100 x 168 map, 0.296 ms at 67 TFLOP/s), or bytes where the mask is
// sparse (the map read, the weights, the output written: 34 MB there,
// 0.0103 ms at 3.35 TB/s). This first version reads the weights through L1
// / L2 once per kPos positions and does no register tiling over channels:
// it is simple and exact in its order, not fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPos = 8;  // masked positions per block
constexpr int kCin = 8;  // input channels per shared-memory stage

__global__ void masked_conv_kernel(const float* __restrict__ x,
                                   const float* __restrict__ wt,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ maskv,
                                   const int64_t* __restrict__ pos, int p,
                                   int cin, int h, int w, int co, int k,
                                   int stride, int pad, int ho, int wo,
                                   float* __restrict__ out) {
  extern __shared__ float patch[];  // [kPos][kCin][k * k]
  const int kk = k * k;
  const int p0 = blockIdx.x * kPos;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = c < co;
  float acc[kPos];
#pragma unroll
  for (int q = 0; q < kPos; ++q) acc[q] = 0.f;
  for (int ci0 = 0; ci0 < cin; ci0 += kCin) {
    const int nci = min(kCin, cin - ci0);
    __syncthreads();  // the previous stage's patch has been read
    for (int e = threadIdx.x; e < kPos * kCin * kk; e += blockDim.x) {
      const int q = e / (kCin * kk);
      const int r = e - q * (kCin * kk);
      const int ci = r / kk;
      const int t = r - ci * kk;
      float v = 0.f;
      if (p0 + q < p && ci < nci) {
        const int64_t at = pos[p0 + q];
        const int64_t bb = at / (static_cast<int64_t>(ho) * wo);
        const int rem = static_cast<int>(at - bb * ho * wo);
        const int iy = (rem / wo) * stride - pad + t / k;
        const int ix = (rem % wo) * stride - pad + t % k;
        if (iy >= 0 && iy < h && ix >= 0 && ix < w)
          v = x[((bb * cin + ci0 + ci) * h + iy) * static_cast<int64_t>(w) +
                ix];
      }
      patch[e] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int ci = 0; ci < nci; ++ci) {
      for (int t = 0; t < kk; ++t) {
        const float wv =
            wt[(static_cast<int64_t>(ci0 + ci) * kk + t) * co + c];
#pragma unroll
        for (int q = 0; q < kPos; ++q)
          acc[q] = __fmaf_rn(patch[(q * kCin + ci) * kk + t], wv, acc[q]);
      }
    }
  }
  if (!live) return;
  const float bc = bias == nullptr ? 0.f : bias[c];
#pragma unroll
  for (int q = 0; q < kPos; ++q) {
    if (p0 + q >= p) break;
    const int64_t at = pos[p0 + q];
    const int64_t bb = at / (static_cast<int64_t>(ho) * wo);
    const int64_t rem = at - bb * ho * wo;
    float v = acc[q];
    if (bias != nullptr) v = __fadd_rn(v, bc);
    out[(bb * co + c) * static_cast<int64_t>(ho) * wo + rem] =
        __fmul_rn(v, maskv[p0 + q]);
  }
}

}  // namespace

// x (B, Cin, H, W) float32; wt (Cin, K, K, Co) float32; bias null or (Co,);
// maskv (P,) float32, the mask's value at each masked position; pos (P,)
// int64 flat indices into (B, Ho, Wo); out (B, Co, Ho, Wo) float32, zeroed
// by the caller. One launch; returns cudaGetLastError().
extern "C" int erd_masked_conv2d(const void* x, const void* wt,
                                 const void* bias, const void* maskv,
                                 const void* pos, void* out, int p, int cin,
                                 int h, int w, int co, int k, int stride,
                                 int pad, int ho, int wo, void* stream) {
  if (p <= 0 || co <= 0) return 0;
  const int threads = min(256, ((co + 31) / 32) * 32);
  const dim3 grid((p + kPos - 1) / kPos, (co + threads - 1) / threads);
  const size_t smem = sizeof(float) * kPos * kCin * k * k;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_conv_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(maskv),
      static_cast<const int64_t*>(pos), p, cin, h, w, co, k, stride, pad, ho,
      wo, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
