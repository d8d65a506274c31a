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
// K4 and K5 are bound by bytes: they touch each byte once and do a few
// float operations on it.  K3 does some 230 integer operations for every
// 4 bytes of a decode column, so on Hopper it is bound by bytes only if
// those stay under the byte time.  The designs keep every warp's loads
// and stores on contiguous runs of memory, and compute in registers.
//
// K3: a static (M, K) coefficient matrix (the encode rows, or a decode
// matrix solved on the host) times a batch of (K, B) byte matrices.  A
// thread owns a 16-byte column of one batch entry at a time and computes
// its M output columns as four 32-bit words each.  Write out_m = sum_b
// 2^b S_{m,b}, where S_{m,b} is the XOR of the x_k whose coefficient c_mk
// has bit b set; Horner over the bits, acc = S_{m,7}; acc = xtime(acc) ^
// S_{m,6}; ...; ^ S_{m,0}, costs M x 7 SWAR xtimes a word (multiply-by-2
// on four packed bytes) and one select-and-XOR per (m, b, k).  The TPU
// kernel ran the ladder on the inputs instead (K x 7 xtimes, then a
// conditional XOR per set bit) because its vector unit has no gather;
// ported as it was, that form made K3 wait on instruction issue (~600
// instructions a word at M = 2, K = 8).  Here the coefficients travel by
// value as one word per (m, b, k) in the kernel's parameters (`GfPlanes`,
// built by unorc_cuda.gf_planes), so they are constant-bank operands:
// no shared-memory loads, no per-bit branches, no rebuild per erasure
// pattern.  Half the words are AND masks (acc ^= x & mask, one LOP3) and
// half multipliers (acc ^= x * 1 ^ x' * 1, two IMADs and a LOP3), and
// xtime's shift and reduction are products too: on Hopper the logic ops
// and the multiplies issue to two pipes of 64 lanes a clock each, and
// the logic pipe alone was the limit.  A plane (m, b) with no set bit is
// skipped, and so are the doublings of a still-zero acc, by branches
// uniform across the grid (the encode rows have 9 live planes of 16).
// K is a template parameter, so the K x 4 input words stay in registers;
// the grid is one wave of resident blocks that stride over the columns,
// and for K <= 8 each thread loads its next column while it computes this
// one, so that loads and arithmetic overlap.  On the p = 2 chunk of the
// sync, encode then runs at its byte bound and decode, with all 16
// planes live, at about three quarters of it: there the arithmetic is
// still about two thirds of the byte time and the overlap is partial.
// XOR is exact, so the result is bitwise the table-based product.  Rows
// whose width is not a multiple of 16, or unaligned pointers, take a
// byte path.
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
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 4;
constexpr int kMaxK = 16;
constexpr int kQuantBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kBits = 8;            // GF(2^8): bit planes of a coefficient

// K3's coefficient block (unorc_cuda.gf_planes builds it): word[m][b][k]
// selects x_k into plane (m, b) if bit b of coeffs[m][k] is set: as an
// AND mask (~0, else 0) where k & 2 == 0, as a multiplier (1, else 0)
// where k & 2 != 0, so that half the terms run on the multiply pipe; bit
// 8 m + b of `live` says plane (m, b) has a set bit, of `dbl` that a
// plane above b of row m has one (so acc may be nonzero and the Horner
// step doubles it).
struct GfPlanes {
  uint32_t word[kMaxM][kBits][kMaxK];
  uint32_t live;
  uint32_t dbl;
};
constexpr int kGfPlaneWords = kMaxM * kBits * kMaxK + 2;
static_assert(sizeof(GfPlanes) == 4 * kGfPlaneWords, "GfPlanes layout");

// Multiply by 2 in GF(2^8) on four packed bytes: ((v & 0x7f7f7f7f) << 1)
// ^ (((v >> 7) & 0x01010101) * 0x1d), written so that the shift and the
// reduction, (hi * 0x1d) >> 7 (carry-free: 0x80 * 0x1d spans bits 7-11 of
// each byte), run on the multiply pipe.
__device__ __forceinline__ uint32_t xtime4(uint32_t v) {
  const uint32_t hi = v & 0x80808080u;
  return (v * 2u) ^ (hi * 2u) ^ __umulhi(hi, 0x1du << 25);
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

template <int K>
__device__ __forceinline__ void gf_load(const uint8_t* __restrict__ x,
                                        int64_t item, uint32_t cols,
                                        int64_t width, bool vec,
                                        uint32_t (&v)[K][4]) {
  const uint32_t g = (uint32_t)item / cols;
  const int64_t col = ((uint32_t)item - g * cols) * (int64_t)16;
  const uint8_t* xg = x + g * (int64_t)K * width + col;
#pragma unroll
  for (int k = 0; k < K; ++k) load16(xg + k * width, width - col, vec, v[k]);
}

// A persistent grid: thread t owns columns t, t + stride, ... of the
// flattened (group, column) space, and for K <= 8 loads the next column's
// K words while it computes this one (no spills there at 128 registers).
template <int M, int K>
__global__ void __launch_bounds__(kThreads, 2)
gf_matmul_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 const GfPlanes planes, int64_t n_items, uint32_t cols,
                 int64_t width, bool vec) {
  constexpr bool kPrefetch = K <= 8;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= n_items) return;
  uint32_t v[K][4];
  gf_load<K>(x, i, cols, width, vec, v);
  for (;;) {
    const int64_t next = i + stride;
    uint32_t vn[kPrefetch ? K : 1][4];
    if constexpr (kPrefetch) {
      if (next < n_items) gf_load<K>(x, next, cols, width, vec, vn);
    }
    uint32_t acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[m][w] = 0u;
#pragma unroll
      for (int b = kBits - 1; b >= 0; --b) {
        const uint32_t plane = 1u << (kBits * m + b);
        if (planes.dbl & plane) {
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[m][w] = xtime4(acc[m][w]);
        }
        if (planes.live & plane) {
#define GF_WORD(j) planes.word[m][b][j]
#pragma unroll
          for (int k = 0; k < K; k += 4) {
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              uint32_t a = acc[m][w] ^ (v[k][w] & GF_WORD(k));
              if (k + 1 < K) a ^= v[k + 1][w] & GF_WORD(k + 1);
              if (k + 2 < K) {
                const uint32_t p = v[k + 2][w] * GF_WORD(k + 2);
                a ^= k + 3 < K ? p ^ v[k + 3][w] * GF_WORD(k + 3) : p;
              }
              acc[m][w] = a;
            }
          }
#undef GF_WORD
        }
      }
    }
    const uint32_t g = (uint32_t)i / cols;
    const int64_t col = ((uint32_t)i - g * cols) * (int64_t)16;
    uint8_t* og = out + g * (int64_t)M * width + col;
#pragma unroll
    for (int m = 0; m < M; ++m)
      store16(og + m * width, width - col, vec, acc[m]);
    if (next >= n_items) break;
    if constexpr (kPrefetch) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int w = 0; w < 4; ++w) v[k][w] = vn[k][w];
      }
    } else {
      gf_load<K>(x, next, cols, width, vec, v);
    }
    i = next;
  }
}

using GfKernel = void (*)(const uint8_t*, uint8_t*, const GfPlanes, int64_t,
                          uint32_t, int64_t, bool);

template <int M, int K = 1>
GfKernel gf_kernel_for(int k) {
  if constexpr (K > kMaxK) {
    return nullptr;
  } else {
    return k == K ? gf_matmul_kernel<M, K> : gf_kernel_for<M, K + 1>(k);
  }
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
// planes: host GfPlanes as kGfPlaneWords words, 1 <= m <= 4,
// 1 <= k <= 16.  vec != 0 only when width % 16 == 0 and both pointers are
// 16-byte aligned.
int uno_gf_matmul(const uint8_t* x, uint8_t* out, const uint32_t* planes,
                  long long n_groups, int m, int k, long long width, int vec,
                  cudaStream_t stream) {
  if (m < 1 || m > kMaxM || k < 1 || k > kMaxK || n_groups < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  GfPlanes p;
  memcpy(&p, planes, sizeof(p));
  GfKernel kernel;
  switch (m) {
    case 1: kernel = gf_kernel_for<1>(k); break;
    case 2: kernel = gf_kernel_for<2>(k); break;
    case 3: kernel = gf_kernel_for<3>(k); break;
    default: kernel = gf_kernel_for<4>(k); break;
  }
  const int64_t cols = (width + 15) / 16;
  const int64_t n_items = n_groups * cols;
  if (n_items >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  // one full wave of resident blocks (cached per device and kernel)
  static int sms[64], per_sm[64][kMaxM + 1][kMaxK + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  int& resident = per_sm[dev][m][k];
  if (resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t wave = (int64_t)sms[dev] * (resident > 0 ? resident : 1);
  const int64_t need = (n_items + kThreads - 1) / kThreads;
  kernel<<<(unsigned)(need < wave ? need : wave), kThreads, 0, stream>>>(
      x, out, p, n_items, (uint32_t)cols, width, vec != 0);
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
