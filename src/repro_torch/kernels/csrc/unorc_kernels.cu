// Hand-written Hopper (sm_90a) kernels for UnoRC, the protected cross-pod
// gradient exchange (repro_torch/core/uno_collectives.py).
//
// They replace the three Pallas TPU kernels on that path:
//
//   K3 uno_gf_matmul    <- repro/kernels/rs_pallas.py gf_matmul (behind
//                          rs_encode / rs_decode): RS(k, r) parity and
//                          erasure decode over GF(2^8), poly 0x11D;
//   K4 uno_quant_int8   <- repro/kernels/quant_pallas.py quant_int8:
//                          blockwise absmax int8, block 256;
//   K5 uno_dequant_int8 <- repro/kernels/quant_pallas.py dequant_int8.
//
// All three are bound by bytes: they touch each byte once and do a few
// integer or float operations on it.  The designs keep every warp's
// loads and stores on contiguous runs of memory, and compute in registers.
//
// K3: a static (M, K) coefficient matrix (the encode rows, or a decode
// matrix solved on the host) times a batch of (K, B) byte matrices.  One
// thread owns one 16-byte column of one batch entry: it loads the column
// of each of the K input rows as four 32-bit words and multiplies them by
// the constants with a SWAR xtime ladder (multiply-by-2 on four packed
// bytes at once: ((v & 0x7f7f7f7f) << 1) ^ (((v >> 7) & 0x01010101) *
// 0x1d)), XOR-accumulating into the M output columns.  Only shifts, masks
// and XORs: no table gathers, no shared-memory bank conflicts.  XOR is
// exact, so the result is bitwise the table-based product.  The TPU
// kernel used the same ladder because its vector unit has no gather; here
// it is simply the cheapest exact form.  The coefficients travel by value
// in the kernel's parameters (no recompilation per erasure pattern) and
// are staged in shared memory, so a runtime K indexes them without local
// memory.  Rows whose width is not a multiple of 16 take a byte path.
//
// K4: one warp per 256-value block; each lane holds 8 floats (two float4
// loads, 128 floats apart, so a warp's loads are two contiguous 512-byte
// runs).  A shuffle butterfly gives the block's absmax; the scale is
// amax * f32(1/127) (0x3C010204: the reference runs under jit, where XLA
// rewrites its `amax / 127.0` into this product), or 1 for an all-zero
// block.  q = clamp(rint(x / scale), -127, 127) with an IEEE division
// (__fdiv_rn) and round-half-even.  Rows of the input may be strided.
//
// K5: out = float(q) * scale[i / 256], one rounded product each.  With
// an addend it is the receiver's dequantize-and-add, fused: out =
// fma(float(q), scale, acc) with one rounding, which is what XLA makes of
// the reference's `c + dequant(...)` (it contracts the multiply and the
// add), and it saves writing and re-reading the product.  The output is
// four bytes for every byte of q, so the stores set the time: each warp
// owns a span of kDqRuns runs of 32 float4 (1,024 values, four quant
// blocks), and store i of lane l writes float4 base + 32 i + l, so one
// store instruction fills one contiguous 512-byte run.  q is loaded in
// the same layout, 4 bytes a lane (one 128-byte run an instruction), all
// kDqRuns loads (and the addend's float4s) issued before the first store:
// 32 values in flight per lane.  A run lies inside one quant block and
// one row, so its scale is one broadcast load and its addend row one
// pointer.  Spans past the end are cut at a run.

// Build without --use_fast_math: IEEE division and rintf are part of the
// contract.  Plain C interface, loaded with ctypes: every entry point
// launches on the caller's stream and returns cudaGetLastError() right
// after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 4;
constexpr int kMaxK = 16;
constexpr int kQuantBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

struct GfCoeffs {
  unsigned char c[kMaxM * kMaxK];   // row-major (M, K)
};

__device__ __forceinline__ uint32_t xtime4(uint32_t v) {
  return ((v & 0x7f7f7f7fu) << 1) ^ (((v >> 7) & 0x01010101u) * 0x1du);
}

__device__ __forceinline__ void load16(const uint8_t* p, int64_t left,
                                       bool vec, uint32_t v[4]) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    return;
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * w + i;
      if (j < left) word |= (uint32_t)__ldg(p + j) << (8 * i);
    }
    v[w] = word;
  }
}

__device__ __forceinline__ void store16(uint8_t* p, int64_t left, bool vec,
                                        const uint32_t v[4]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < left) p[j] = (uint8_t)(v[j >> 2] >> (8 * (j & 3)));
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 GfCoeffs coeffs, int64_t n_groups, int k_rows, int64_t width,
                 int64_t cols, bool vec) {
  __shared__ unsigned char sc[kMaxM * kMaxK];
  if (threadIdx.x < M * k_rows) sc[threadIdx.x] = coeffs.c[threadIdx.x];
  __syncthreads();
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n_groups * cols) return;
  const int64_t g = t / cols;
  const int64_t col = (t - g * cols) * 16;
  const int64_t left = width - col;
  const uint8_t* xg = x + g * k_rows * width + col;
  uint32_t acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[m][w] = 0u;
  }
#pragma unroll 4
  for (int k = 0; k < k_rows; ++k) {
    uint32_t v[4];
    load16(xg + k * width, left, vec, v);
    unsigned live = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) live |= sc[m * k_rows + k];
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      if ((live >> bit) == 0u) break;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if ((sc[m * k_rows + k] >> bit) & 1u) {
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[m][w] ^= v[w];
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) v[w] = xtime4(v[w]);
    }
  }
  uint8_t* og = out + g * M * width + col;
#pragma unroll
  for (int m = 0; m < M; ++m) store16(og + m * width, left, vec, acc[m]);
}

__device__ __forceinline__ int8_t quant1(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
}

__global__ void __launch_bounds__(kThreads)
quant_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, int64_t n_blocks,
                  int64_t blocks_per_row, int64_t ld) {
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_blocks) return;            // whole warps exit together
  const int64_t row = warp / blocks_per_row;
  const float* xb = x + row * ld + (warp - row * blocks_per_row) * kQuantBlock;
  const float4 a = __ldg(reinterpret_cast<const float4*>(xb) + lane);
  const float4 b = __ldg(reinterpret_cast<const float4*>(xb + 128) + lane);
  float amax = fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                     fmaxf(fabsf(a.z), fabsf(a.w)));
  amax = fmaxf(amax, fmaxf(fmaxf(fabsf(b.x), fabsf(b.y)),
                           fmaxf(fabsf(b.z), fabsf(b.w))));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  }
  const float scale =
      amax > 0.0f ? __fmul_rn(amax, __int_as_float(0x3C010204)) : 1.0f;
  int8_t* qb = q + warp * kQuantBlock;
  reinterpret_cast<char4*>(qb)[lane] =
      make_char4(quant1(a.x, scale), quant1(a.y, scale),
                 quant1(a.z, scale), quant1(a.w, scale));
  reinterpret_cast<char4*>(qb + 128)[lane] =
      make_char4(quant1(b.x, scale), quant1(b.y, scale),
                 quant1(b.z, scale), quant1(b.w, scale));
  if (lane == 0) scales[warp] = scale;
}

constexpr int kDqRuns = 8;                  // runs of 32 float4 per warp
constexpr int kDqSpan = 32 * kDqRuns;       // float4 per warp
constexpr int kBlockFloat4 = kQuantBlock / 4;

template <bool kAcc>
__global__ void __launch_bounds__(kThreads)
dequant_int8_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    const float* __restrict__ acc, float* __restrict__ out,
                    int64_t n4, int64_t row4, int64_t ld_acc) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      ((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5) * kDqSpan;
  if (base >= n4) return;                  // whole warps exit together
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
  uint32_t w[kDqRuns];
  float s[kDqRuns];
  float4 c[kDqRuns];
#pragma unroll
  for (int i = 0; i < kDqRuns; ++i) {
    const int64_t run = base + 32 * i;     // n4 is a multiple of 64
    if (run < n4) {
      w[i] = __ldg(qw + run + lane);
      s[i] = __ldg(scales + run / kBlockFloat4);
      if (kAcc) {
        const int64_t row = run / row4;
        c[i] = __ldg(reinterpret_cast<const float4*>(acc + row * ld_acc) +
                     (run - row * row4) + lane);
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < kDqRuns; ++i) {
    const int64_t run = base + 32 * i;
    if (run >= n4) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (float)(int8_t)(w[i] >> (8 * j));
    if (kAcc) {
      o[run + lane] = make_float4(
          __fmaf_rn(v[0], s[i], c[i].x), __fmaf_rn(v[1], s[i], c[i].y),
          __fmaf_rn(v[2], s[i], c[i].z), __fmaf_rn(v[3], s[i], c[i].w));
    } else {
      o[run + lane] = make_float4(__fmul_rn(v[0], s[i]), __fmul_rn(v[1], s[i]),
                                  __fmul_rn(v[2], s[i]), __fmul_rn(v[3], s[i]));
    }
  }
}

int blocks_for(int64_t threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// x: (n_groups, k, width) uint8; out: (n_groups, m, width) uint8;
// coeffs: host (m, k) bytes, 1 <= m <= 4, 1 <= k <= 16.  vec != 0 only
// when width % 16 == 0 and both pointers are 16-byte aligned.
int uno_gf_matmul(const uint8_t* x, uint8_t* out, const unsigned char* coeffs,
                  long long n_groups, int m, int k, long long width, int vec,
                  cudaStream_t stream) {
  if (m < 1 || m > kMaxM || k < 1 || k > kMaxK || n_groups < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  GfCoeffs c = {};
  for (int i = 0; i < m * k; ++i) c.c[i] = coeffs[i];
  const int64_t cols = (width + 15) / 16;
  const int blocks = blocks_for(n_groups * cols);
  switch (m) {
    case 1: gf_matmul_kernel<1><<<blocks, kThreads, 0, stream>>>(
                x, out, c, n_groups, k, width, cols, vec != 0); break;
    case 2: gf_matmul_kernel<2><<<blocks, kThreads, 0, stream>>>(
                x, out, c, n_groups, k, width, cols, vec != 0); break;
    case 3: gf_matmul_kernel<3><<<blocks, kThreads, 0, stream>>>(
                x, out, c, n_groups, k, width, cols, vec != 0); break;
    default: gf_matmul_kernel<4><<<blocks, kThreads, 0, stream>>>(
                x, out, c, n_groups, k, width, cols, vec != 0); break;
  }
  return (int)cudaGetLastError();
}

// x: (n_rows, row_len) f32 with row stride ld (elements), 16-byte aligned
// rows, row_len % 256 == 0; q: (n_rows, row_len) int8 contiguous;
// scales: (n_rows, row_len / 256) f32.
int uno_quant_int8(const float* x, int8_t* q, float* scales, long long n_rows,
                   long long row_len, long long ld, cudaStream_t stream) {
  if (n_rows < 1 || row_len < kQuantBlock || row_len % kQuantBlock)
    return (int)cudaErrorInvalidValue;
  const int64_t per_row = row_len / kQuantBlock;
  const int64_t n_blocks = n_rows * per_row;
  quant_int8_kernel<<<blocks_for(n_blocks * 32), kThreads, 0, stream>>>(
      x, q, scales, n_blocks, per_row, ld);
  return (int)cudaGetLastError();
}

// q: (n_rows, row_len) int8 contiguous, 4-byte aligned, row_len % 256
// == 0; scales: (n_rows, row_len / 256) f32; out: (n_rows, row_len) f32.
// acc: null, or (n_rows, row_len) f32 with row stride ld_acc (elements,
// 16-byte aligned rows): out = fma(q, scale, acc), one rounding.
int uno_dequant_int8(const int8_t* q, const float* scales, const float* acc,
                     float* out, long long n_rows, long long row_len,
                     long long ld_acc, cudaStream_t stream) {
  if (n_rows < 1 || row_len < kQuantBlock || row_len % kQuantBlock)
    return (int)cudaErrorInvalidValue;
  const int64_t row4 = row_len / 4;
  const int64_t n4 = n_rows * row4;        // a multiple of 64
  const int blocks = blocks_for((n4 + kDqSpan - 1) / kDqSpan * 32);
  if (acc == nullptr) {
    dequant_int8_kernel<false><<<blocks, kThreads, 0, stream>>>(
        q, scales, acc, out, n4, row4, ld_acc);
  } else {
    dequant_int8_kernel<true><<<blocks, kThreads, 0, stream>>>(
        q, scales, acc, out, n4, row4, ld_acc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
