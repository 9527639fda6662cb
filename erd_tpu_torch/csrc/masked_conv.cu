// Masked convolution (mmcv's MaskedConv2d), hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/sampling.py `masked_conv2d` (:57). On the TPU it
// was a dense float32 convolution (K x K, symmetric padding (K - 1) / 2,
// any stride) plus bias, times a 0/1 mask at output resolution: XLA fused
// the mask into the conv's epilogue, and the dense conv cost the same
// whatever the mask. Here, as mmcv designs it, only the masked output
// positions are computed: the caller compacts them (a nonzero over the
// mask) and zeroes the other outputs, and the kernel is an implicit GEMM
// over the compacted positions,
//   out[p, n] = (sum_r A[p, r] * B[r, n] + bias[n]) * mask[p],
// M = P positions, N = Co, K = Cin * K^2: A[p, r] is the input under tap
// (ky, kx) of channel ci at position p (0 off the map), B[r, n] the
// weight. IEEE float32 FMAs on the SIMT units, no TF32 and no library GEMM.
// The reduction runs tap-major within blocks of BK channels, r = (ci / BK,
// ky, kx, ci % BK): a step is one tap of BK channels, so a step's tap, its
// bounds and its offset are worked out once, and each gathered entry only
// adds a channel plane (an (ci, ky, kx) order divides by K^2 and K and
// tests four bounds an entry, the largest cost beside the FMAs). The
// weight comes as (Co, K, K, Cin), which the wrapper makes from OIHW each
// call, so that a step's BK channels of a tap are contiguous (read OIHW,
// K^2 floats apart, they cost more than the copy).
//
// Bound on this card: operations, 2 * P * Co * Cin * K^2 float32 FLOP
// (19.8 GFLOP for a 3x3, 256 -> 256 conv on a full 100 x 168 map, 0.296
// ms at 67 TFLOP/s), or bytes where the mask is sparse (the map read, the
// weights, the output written). The design feeds the FMAs from registers:
// a block of 256 threads owns a BM x BN tile of (positions x channels),
// each thread a TM x TN register tile of sums. Three tiles, the wrapper
// picking the one whose launch a cost model fitted on the card puts
// shortest (ops/sampling.py masked_conv_tile: a + b x the blocks on the
// busiest SM; a launch's time steps up with each block more an SM):
//   3: 128 x 256, 8 x 16 sums a thread, 1 block an SM (P = 16800, Co =
//      256: 132 blocks, one wave); 1: 128 x 128, 8 x 8, 2 blocks an SM;
//   2: 64 x 64, 4 x 4, 4 blocks an SM, for few positions.
// Per step of BK = 16 reduction entries (one tap of 16 channels):
//   A tile (BK x BM, k-major in shared memory): gathered from the NCHW map
//     by cp.async, 4 bytes an entry, the taps off the map, the channels
//     past Cin and the positions past P zero-filled by a source size of 0;
//   B tile (BK x BN): read from the weight by 16-byte loads into
//     registers, BK / 4 neighbouring threads an output channel's run of BK
//     input channels, and stored transposed in shared memory (rows padded
//     by 4 floats);
//   both double-buffered: the next step's copies are in flight while this
//     step's FMAs run, one __syncthreads a step;
//   each thread reads TM + TN values from shared memory as float4s for
//     TM x TN FMAs (8 + 16 for 128 at 128 x 256).
// Each sum runs over r in order, one FMA a step, so the result repeats bit
// for bit from run to run; bias is added and the mask's value multiplied as
// before.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from src to shared dst, or zeros where bytes == 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a block: BM positions x BN channels, kThreads threads as 16 x 16, a
// thread TM x TN sums, BK reduction entries a step (copies of step s + 1
// in flight while step s's FMAs run), at least kMinBlocks blocks an SM.
// Step s covers one tap t and BK channels from cb * BK: s = cb * K^2 + t.
template <int BM, int BN, int TM, int TN, int BK, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    masked_conv_kernel(const float* __restrict__ x,
                       const float* __restrict__ weight,
                       const float* __restrict__ bias,
                       const float* __restrict__ maskv,
                       const int64_t* __restrict__ pos, int p, int cin, int h,
                       int w, int co, int k, int stride, int pad, int ho,
                       int wo, int vec_b, float* __restrict__ out) {
  static_assert(BM == 16 * TM && BN == 16 * TN, "16 x 16 threads");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  constexpr int kA = BM * BK / kThreads;  // A entries a thread copies
  static_assert(kA * kThreads == BM * BK, "");
  constexpr int kBPad = BN + 4;
  extern __shared__ __align__(16) float smem[];
  auto as = reinterpret_cast<float(*)[BK][BM]>(smem);
  auto bs = reinterpret_cast<float(*)[BK][kBPad]>(smem + 2 * BK * BM);

  const int kk = k * k;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long plane = static_cast<long long>(h) * w;
  const long long hw_out = static_cast<long long>(ho) * wo;

  // this thread's A entries: position a_m, channels a_k .. + kA of a step
  const int a_m = tid % BM, a_k = (tid / BM) * kA;
  const bool a_live = p0 + a_m < p;
  int iy0 = 0, ix0 = 0;
  const float* xb = x;
  if (a_live) {
    const int64_t at = pos[p0 + a_m];
    const int64_t bb = at / hw_out;
    const int rem = static_cast<int>(at - bb * hw_out);
    iy0 = (rem / wo) * stride - pad;
    ix0 = (rem % wo) * stride - pad;
    xb = x + (bb * cin + a_k) * plane;
  }
  // this thread's B entries: channels b_k .. + 4 of a step in output
  // channels b_n + i * kRowsPerPass (i < kPasses), read as 16 bytes where
  // they keep the alignment; BK / 4 neighbouring threads cover one output
  // channel's run of BK input channels
  constexpr int kPieces = BK / 4;
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kPasses = BN / kRowsPerPass;
  static_assert(BK % 4 == 0 && kPasses * kRowsPerPass == BN, "");
  const int b_n = tid / kPieces, b_k = (tid % kPieces) * 4;

  const bool whole = cin % BK == 0;  // no step runs past Cin
  // the next step to load: channels from ci0, tap (ky, kx)
  int ci0 = 0, ky = 0, kx = 0;
  // that step: the A gather by cp.async into buffer buf, the B entries
  // into registers; then the step after it
  auto load = [&](int buf, float4 (&v)[kPasses]) {
    const int iy = iy0 + ky, ix = ix0 + kx, t = ky * k + kx;
    const bool tap = a_live && iy >= 0 && iy < h && ix >= 0 && ix < w;
    const long long off = ci0 * plane + static_cast<long long>(iy) * w + ix;
#pragma unroll
    for (int j = 0; j < kA; ++j) {
      const bool ok = tap && (whole || ci0 + a_k + j < cin);
      cp_async4(&as[buf][a_k + j][a_m], ok ? xb + off + j * plane : x,
                ok ? 4 : 0);
    }
    cp_async_commit();
    const int c = ci0 + b_k;  // this thread's first input channel
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int n = n0 + b_n + i * kRowsPerPass;
      const float* src = weight + (static_cast<long long>(n) * kk + t) * cin;
      if (vec_b && n < co && c + 4 <= cin) {
        v[i] = *reinterpret_cast<const float4*>(src + c);
      } else {
        const bool live = n < co;
        v[i].x = live && c < cin ? src[c] : 0.f;
        v[i].y = live && c + 1 < cin ? src[c + 1] : 0.f;
        v[i].z = live && c + 2 < cin ? src[c + 2] : 0.f;
        v[i].w = live && c + 3 < cin ? src[c + 3] : 0.f;
      }
    }
    if (++kx == k) {
      kx = 0;
      if (++ky == k) {
        ky = 0;
        ci0 += BK;
      }
    }
  };
  auto store_b = [&](const float4 (&v)[kPasses], int buf) {
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      float* dst = &bs[buf][b_k][b_n + i * kRowsPerPass];
      dst[0] = v[i].x;
      dst[kBPad] = v[i].y;
      dst[2 * kBPad] = v[i].z;
      dst[3 * kBPad] = v[i].w;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  const int tx = tid % 16, ty = tid / 16;  // positions tx, channels ty
  const int steps = (cin + BK - 1) / BK * kk;

  float4 breg[kPasses];
  load(0, breg);
  store_b(breg, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) load((s + 1) & 1, breg);
    const int cur = s & 1;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 q =
            *reinterpret_cast<const float4*>(&as[cur][r][g * 64 + tx * 4]);
        a[g * 4] = q.x, a[g * 4 + 1] = q.y, a[g * 4 + 2] = q.z,
                 a[g * 4 + 3] = q.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 q =
            *reinterpret_cast<const float4*>(&bs[cur][r][g * 64 + ty * 4]);
        b[g * 4] = q.x, b[g * 4 + 1] = q.y, b[g * 4 + 2] = q.z,
                 b[g * 4 + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
    }
    if (more) {
      store_b(breg, cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // epilogue: position tx's rows, channel ty's columns
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = p0 + (i / 4) * 64 + tx * 4 + i % 4;
    if (m >= p) continue;
    const int64_t at = pos[m];
    const int64_t bb = at / hw_out;
    const int64_t rem = at - bb * hw_out;
    const float mv = maskv[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + ty * 4 + j % 4;
      if (n >= co) continue;
      float v = acc[i][j];
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      out[(bb * co + n) * hw_out + rem] = __fmul_rn(v, mv);
    }
  }
}

template <int BM, int BN, int TM, int TN, int BK, int kMinBlocks>
int launch(const float* x, const float* weight, const float* bias,
           const float* maskv, const int64_t* pos, float* out, int p,
           int cin, int h, int w, int co, int k, int stride, int pad, int ho,
           int wo, cudaStream_t st) {
  // 16-byte weight loads where every run of channels keeps the alignment
  const int vec_b = reinterpret_cast<uintptr_t>(weight) % 16 == 0 &&
                    cin % 4 == 0;
  const dim3 grid((p + BM - 1) / BM, (co + BN - 1) / BN);
  auto kernel = masked_conv_kernel<BM, BN, TM, TN, BK, kMinBlocks>;
  constexpr int kSmem =
      2 * BK * (BM + BN + 4) * static_cast<int>(sizeof(float));
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, kSmem, st>>>(x, weight, bias, maskv, pos, p, cin,
                                        h, w, co, k, stride, pad, ho, wo,
                                        vec_b, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, Cin, H, W) float32; weight (Co, K, K, Cin) float32 (OHWI); bias
// null or (Co,); maskv (P,) float32, the mask's value at each masked
// position; pos (P,) int64 flat indices into (B, Ho, Wo); out (B, Co, Ho,
// Wo) float32, its other positions zeroed by the caller. tile 1: 128 x 128
// tiles (8 x 8 sums a thread, 2 blocks an SM), 2: 64 x 64 (4 x 4, 4 blocks
// an SM), 3: 128 x 256 (8 x 16, 1 block an SM). One launch; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another tile.
extern "C" int erd_masked_conv2d(const void* x, const void* weight,
                                 const void* bias, const void* maskv,
                                 const void* pos, void* out, int p, int cin,
                                 int h, int w, int co, int k, int stride,
                                 int pad, int ho, int wo, int tile,
                                 void* stream) {
  if (p <= 0 || co <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weight);
  const float* bf = static_cast<const float*>(bias);
  const float* mf = static_cast<const float*>(maskv);
  const int64_t* pf = static_cast<const int64_t*>(pos);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 1)
    return launch<128, 128, 8, 8, 16, 2>(xf, wf, bf, mf, pf, of, p, cin, h,
                                         w, co, k, stride, pad, ho, wo, st);
  if (tile == 2)
    return launch<64, 64, 4, 4, 16, 4>(xf, wf, bf, mf, pf, of, p, cin, h, w,
                                       co, k, stride, pad, ho, wo, st);
  if (tile == 3)
    return launch<128, 256, 8, 16, 16, 1>(xf, wf, bf, mf, pf, of, p, cin, h,
                                          w, co, k, stride, pad, ho, wo, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
