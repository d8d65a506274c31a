// Hand-written Hopper (sm_90a) kernels for the fleetsim flow<->link exchange.
//
// They replace the two Pallas TPU kernels of repro/kernels/fleet_pallas.py:
//
//   K1 uno_link_scatter  <- link_scatter (_scatter_kernel), and through it
//                           path_rates / path_table_scatter;
//   K2 uno_link_gathers  <- link_gathers (_gathers_kernel), and through it
//                           path_table_gathers.
//
// The TPU kernels turn the sparse access into one-hot matmuls because the
// TPU vector unit has no per-lane gather.  Hopper has real gathers, so both
// kernels index directly:
//
// K1 is a deterministic segmented sum over a by-segment-sorted CSR entry
// list: out[k] = sum_{e in [ptr[k], ptr[k+1])} vals[gather[e]].  One warp
// owns one output segment; its lanes stride over the segment's entries,
// each lane accumulating in a fixed order, then a fixed butterfly of warp
// shuffles combines the 32 partial sums.  No float atomics, so the result
// is bitwise reproducible from run to run.  The trailing segment (the
// scratch slot of -1 hops, or the block-padding sentinel) is outside the
// contract and is written 0.0 without reading its entries.  Bound: bytes
// (each entry reads a 4-byte id and gathers a 4-byte value, L2-resident at
// the fleet sizes here); the warp-per-segment split is load-imbalanced
// when segment lengths differ widely.
//
// K2 runs one thread per row of an (R, h) index table: it loops over the
// row's h hops, reads the packed per-link float4 (scale, clean, delay, 0)
// — the identity row (1, 1, 0, 0) sits at the scratch slot L — and writes
// min over hops of scale, 1 - prod over hops of clean and sum over hops of
// delay, hop 0 first.  Bound: bytes (the index table dominates).
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// caller's stream and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
link_scatter_kernel(const float* __restrict__ vals,
                    const int* __restrict__ gather,
                    const int* __restrict__ ptr,
                    float* __restrict__ out, int n_seg) {
  const int warp = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp > n_seg) return;
  if (warp == n_seg) {                 // scratch / sentinel slot
    if (lane == 0) out[n_seg] = 0.0f;
    return;
  }
  const int a = __ldg(ptr + warp);
  const int b = __ldg(ptr + warp + 1);
  float acc = 0.0f;
#pragma unroll 4
  for (int e = a + lane; e < b; e += 32) {
    acc += __ldg(vals + __ldg(gather + e));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[warp] = acc;
}

__global__ void __launch_bounds__(kThreads)
link_gathers_kernel(const int* __restrict__ idx,
                    const float4* __restrict__ packed,
                    float* __restrict__ scale_out,
                    float* __restrict__ frac_out,
                    float* __restrict__ delay_out, int n_rows, int h) {
  const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int* row = idx + r * h;
  float4 v = __ldg(packed + __ldg(row));
  float mn = v.x;
  float prod = 1.0f * v.y;
  float tot = 0.0f + v.z;
  for (int j = 1; j < h; ++j) {
    v = __ldg(packed + __ldg(row + j));
    mn = fminf(mn, v.x);
    prod = prod * v.y;
    tot = tot + v.z;
  }
  scale_out[r] = mn;
  frac_out[r] = 1.0f - prod;
  delay_out[r] = tot;
}

}  // namespace

extern "C" {

// vals: (V,) f32; gather: (E,) int32 ids into vals, sorted by segment;
// ptr: (n_seg + 2,) int32 CSR offsets; out: (n_seg + 1,) f32.
int uno_link_scatter(const float* vals, const int* gather, const int* ptr,
                     float* out, int n_seg, cudaStream_t stream) {
  const int64_t threads = (int64_t)(n_seg + 1) * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  link_scatter_kernel<<<blocks, kThreads, 0, stream>>>(vals, gather, ptr,
                                                       out, n_seg);
  return (int)cudaGetLastError();
}

// idx: (n_rows, h) int32 in [0, L]; packed: (L + 1, 4) f32, 16-byte
// aligned; outputs: (n_rows,) f32 each.  n_rows must be positive.
int uno_link_gathers(const int* idx, const float* packed, float* scale_out,
                     float* frac_out, float* delay_out, int n_rows, int h,
                     cudaStream_t stream) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  link_gathers_kernel<<<blocks, kThreads, 0, stream>>>(
      idx, reinterpret_cast<const float4*>(packed), scale_out, frac_out,
      delay_out, n_rows, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
