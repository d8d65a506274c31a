// Hand-written Hopper (sm_90a) kernels for the fleetsim flow<->link exchange.
//
// They replace the Pallas TPU kernels of repro/kernels/fleet_pallas.py:
//
//   K1 uno_link_scatter       <- link_scatter (_scatter_kernel), and through
//                                it path_rates / path_table_scatter;
//   K2 uno_link_gathers       <- link_gathers (_gathers_kernel);
//      uno_pt_gathers         <- path_table_gathers, the whole function:
//                                the per-segment gathers and the
//                                per-subflow prefix/suffix composition;
//   K6 uno_link_scatter_tiles <- link_scatter_tiles (_scatter_tiles_kernel),
//                                and through it the tiled (n_boundary=)
//                                branch of path_table_scatter.
//
// and two that replace no TPU kernel, uno_rel_epoch and uno_lb_update: the
// epoch step's reliability phase and UnoLB's split update, each in one pass
// over the flows (notes below).
//
// The TPU kernels turn the sparse access into one-hot matmuls because the
// TPU vector unit has no per-lane gather.  Hopper has real gathers, so the
// kernels index directly.
//
// K1 and K6 are one deterministic segmented sum over a by-segment-sorted
// CSR entry list, out[k] = sum_{e in [ptr[k], ptr[k+1])} vals[gather[e]],
// balanced by entries rather than by segments.  Segment lengths in the
// fleet layouts run from 1 to 50,000 entries, so a worker per segment
// leaves lanes idle on short segments, the card idle when there are few
// segments, and one worker walking the longest.  Here each block owns a
// fixed tile of kTile = 2,048 consecutive entries (256 threads x 8),
// whatever the segments, in one kernel:
//
//   1. Each thread streams its 8 contiguous gather ids with two 16-byte
//      loads.  Meanwhile the block finds the first segment starting in
//      the tile: 256-ary steps over ptr (L2-resident) narrow the range to
//      256 offsets, and the block loads a window of 512 offsets from
//      there into shared memory.  From the window it marks each non-empty
//      segment's first entry in a shared bitmask of the tile, with the
//      segment's id beside it, and writes each empty segment +0.0.  Only
//      then does each thread gather its 8 values from L2: issued earlier,
//      the tile's gathers would hold the search's few loads up.
//   2. A fixed-order segmented scan (in-thread, warp shuffles, then the 8
//      warp totals) over (sum, position of the last start) gives each
//      entry its segment's running sum in the tile.
//   3. A segment lying wholly in the tile is written by the thread that
//      holds its last entry.
//   4. A segment over tiles first..last leaves one piece per tile in
//      scratch the wrapper allocates: `carry` for a piece that runs past
//      its tile's end, `head_sum` for the piece in its last tile.  Each
//      piece's thread then takes a ticket at ticket[last] with an
//      acquire-release add; the one that draws last - first (the last
//      piece in) adds the pieces in tile order, carries first to last - 1
//      then the head, writes the sum and resets the ticket to 0.  The ticket buffer is kept zeroed by the
//      wrapper between calls, so no second kernel and no memset is needed.
//
// Every real segment is written once, by one owner: a segment inside one
// tile by that tile, an empty one (+0.0) by the tile holding its offset,
// a spanning one by the tile whose piece lands last.  No float atomics and
// a fixed order of every add, so two runs are bitwise equal whichever
// tile finishes a segment.  The trailing segment (the scratch slot of -1
// hops, or the block-padding sentinel) is outside the contract: out[K] is
// written 0.0 and entries at or past ptr[K] are never read.  ptr[K] is
// read on the device, so the wrappers make no host sync; ptr[0] must be 0
// and ptr[K] at most the entry count E.  The grid covers [0, E], so the
// tile holding ptr[K] exists; tiles past it exit at once.
//
// Bound: bytes.  Each live entry streams its 4-byte id once from device
// memory and gathers a 4-byte value (L2-resident at the fleet sizes
// here); ptr is read a few times per tile.  A random 4-byte gather moves
// a 32-byte L2 sector, so the large CSRs run at the L2's sector rate, not
// at the byte bound; the small ones are latency: one tile is a chain of
// dependent loads (ptr[K], ids, values), barriers and the scan, fetched
// into a cold SM's instruction cache.  PERF.md has the measurements.
//
// K6 is K1 with its output cut in two, as the TPU kernel's two revisited
// output blocks (private links, then the boundary links plus the scratch
// slot) are: every store goes below the cut n_seg - n_boundary into the
// private tile, at or above it into the boundary tile, whose pointer may
// be any row of the sharded run's stacked exchange buffer.  Both run the
// same kernel, so K6 equals K1 bitwise.
//
// K2 reduces each row of a hop table over three per-link vectors: min
// of scale, product of clean, sum of delay, hop 0 first; hop id L (the
// scratch slot of -1 hops) reads the identity (1, 1, 0).  The operands are
// the three (L,) vectors themselves, so no packed table is built per call.
// One thread per row; the hop count is a template parameter for h <= 16,
// so a thread issues all its row's id loads before the first gather (a
// runtime loop serves larger h).  Bound: bytes, the hop ids streamed once
// and the outputs written once.  The per-link gathers stay on chip: the
// vectors of the fat tree (1,616 links, 19 KB) sit in each SM's L1 after
// first touch, and the dumbbell's (51,563 links, 619 KB) in L2.  Staging
// them in shared memory per block was tried and lost at every use (it
// adds a serial load-and-barrier step and saves no memory traffic);
// PERF.md has the times.
//
// uno_link_gathers (TPU row 2) is that reduction over the flat (n*p, h)
// pad_idx table.  uno_pt_gathers (TPU row 5) computes path_table_gathers
// in full from pre_id, suf_id (n, p) and seg_idx (U, hseg):
//   sub_scale = min(seg_scale[pre], seg_scale[suf]),
//   sub_frac  = 1 - seg_clean[pre] * seg_clean[suf],
//   sub_delay = seg_delay[pre] + seg_delay[suf],
// where seg_clean is the segment's product of clean.  The reference
// rounds it through 1 - (1 - prod) before the multiply; the kernel
// multiplies the products directly (as the reference's plain oracle
// does), which is within its 1e-6 bar and one rounding closer.  Every
// multiply and add is __fmul_rn / __fadd_rn / __fsub_rn, so nothing is
// contracted into an FMA and the plain versions (ref.link_gathers_ref,
// ref.pt_gathers_ref) replay the kernels' arithmetic exactly; the min is
// fminf (it differs from torch.minimum only on NaN).  It runs as two
// launches on the caller's stream: one thread per segment writes a (U,)
// float4 {min, prod, sum, 0} table to scratch the wrapper allocates, then
// one thread per subflow gathers its two segments' float4 and composes
// them.  The second pass sets the time: 2 S random 16-byte gathers from
// the 0.93 MB segment table run at the L2's sector rate.  One launch in
// which each subflow reduces its own two segments' hops was tried and was
// twice as slow on the main path (2 x hseg id loads and gathers per
// subflow in place of two float4 gathers).

// uno_rel_epoch (rel_epoch_kernel) replaces no TPU kernel: the reference's
// reliability.py is jnp, which XLA fuses on the TPU.  It is the epoch
// step's reliability phase (reliability.rel_step) in one pass over the
// flows: the loss fraction (split-weighted over the paths), the recovery
// split at the flow's rung, the NACK machine, the EC ladder's step, the
// EWMAs and counters, and the goodput split at the old rung.  Eager torch
// ran it as ~100-135 elementwise kernels that wrote every intermediate,
// among them (flows, 17) binomial tables, to device memory.  Here each
// flow's operands are read once and its outputs written once to fresh
// buffers (the state given is never written: callers keep old states, and
// a fresh RelState shares one zero tensor among a dozen fields).  Only the
// r pmf terms i = 1..r are evaluated (the i = 0 term is 0, coef is 0
// past r), none at q = 0.
//
// It is bitwise the plain version on the card, so that a run on the
// kernel backends and one on the plain ones take the same NACK and rung
// decisions: float32 with every operation rounded on its own (__f*_rn,
// IEEE division, powf) in the plain version's order, and its two sums,
// the r-term window and the sum over the paths, in the order torch.sum
// takes over a short contiguous row on the card (ATen's Reduce.cuh: lane
// x of last_pow2(w) lanes holds a[x] + a[x + lanes], then lane x adds
// lane x + lanes / 2, x + lanes / 4, ... x + 1; `pair_sum`; measured on
// torch 2.11 at widths 2-9, 16 and 17).
//
// The ladder comes in three layouts, a template parameter read from the
// tables' shapes: none (static EC), one shared (L,) ladder, or a grid's
// per-cell (cells, L) tables, flow f reading cell f / cell_flows's row.
// One flow a thread, coalesced 4-byte loads through the read-only path: 4
// and 2 flows a thread with 16- and 8-byte accesses were tried and lost
// (1.07 and 0.86 ms against 0.74 ms at 12.8M flows on an H100 SXM at 700
// W: 154 and 89 registers leave one or two blocks an SM, too few warps to
// hide the powf chains).
// Bound: bytes, ~163 a flow with the ladder, 150 + 4 r without;
// PERF.md has the times.

// uno_lb_update (lb_update_kernel) replaces no TPU kernel either: the
// reference's cc.update_split and the path-mark filter before it are jnp.
// It is UnoLB's split update for one epoch (cc.lb_update_plain): the
// per-path mark filter path_frac' = path_frac + fb (sub_frac - path_frac),
// the bad-epoch count and the repath it triggers, the multiplicative
// weights split * exp(-eta path_frac'), and links.normalize_split (clamp,
// mask, the w_floor / n_valid probe trickle, the row sum, the uniform
// split where the sum is <= 1e-9).  Eager torch ran it as ~33 kernels over
// (flows, p) tables, each writing its intermediate to device memory, among
// them three row sums at about a fifth of the card's byte rate.
//
// Bound: bytes; nothing is reused.  Per flow it reads split, path_frac,
// sub_frac and bad_count (4 x 4p B), the mask (p B), fb and the four
// LbParams it uses (20 B), and writes path_frac', split' and bad_count'
// (3 x 4p B): 252 B at p = 8.  So one thread streams one flow,
// neighbouring threads on neighbouring flows, a block for every 256 flows
// (a grid-stride loop, which runs once a thread below 2^31 blocks): each
// row in 16-byte vector loads and stores where p is a multiple of 4 (8-
// or 4-byte ones otherwise), the mask row in one load of p bytes where p
// is 1, 2, 4 or 8.  p is a template parameter (1 to 8, the path counts
// the scenarios sample), so the rows live in registers.  Tried and lost
// at 8M flows x 8 on an H100 at 700 W: a grid of only the blocks the
// card holds at once, each looping (0.741 against 0.684 ms), and
// streaming __ldcs / __stcs accesses (0.817, and 0.756 on the full grid).
//
// It is bitwise the plain version on the card: every operation rounded on
// its own (__f*_rn; nvcc would otherwise contract the filter's multiply
// and add into an FMA, and an ulp there can flip the repath threshold),
// IEEE division, expf as torch.exp calls it, torch.maximum's NaN rule,
// and the row sum in torch.sum's order over a short row (`row_sum`, the
// order of the reliability kernel's path sum above).

// Plain C interface, loaded with ctypes: every entry point launches on the
// caller's stream and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // entries per thread
constexpr int kTile = kThreads * kItems;     // entries per block
constexpr int kWin = 2 * kThreads;           // ptr offsets a block loads at once

// The output cut: segment k goes to priv[k] below n_priv, else to
// bnd[k - n_priv].  K1 passes n_priv = n_seg + 1, so all goes to priv.
struct Out {
  float* priv;
  float* bnd;
  int n_priv;
  __device__ __forceinline__ void store(int k, float v) const {
    *(k < n_priv ? priv + k : bnd + (k - n_priv)) = v;
  }
};

// A segmented-sum scan element: the sum since the last segment start in
// the tile, and that start's tile position (-1 before the first start).
struct Part {
  float v;
  int pos;
};

// a then b
__device__ __forceinline__ Part combine(const Part& a, const Part& b) {
  return b.pos >= 0 ? b : Part{a.v + b.v, a.pos};
}

// Segment k starts at tile position pos.
__device__ __forceinline__ void mark_start(unsigned* starts, int* seg_at,
                                           int pos, int k) {
  seg_at[pos] = k;
  atomicOr(starts + (pos >> 5), 1u << (pos & 31));
}

// Step 4: tile b's piece `acc` of segment `seg`, which runs over tiles
// first..last.  The tile whose piece arrives last adds all of them in
// tile order and resets the ticket.  The ticket's add is acquire-release:
// it publishes this piece and, to the last arrival, all earlier ones.
// Out of line: it runs at most twice per thread, and inlined it bloats
// the kernel.
__device__ __noinline__ void segsum_piece(Out out, float* carry,
                                          float* head_sum, unsigned* ticket,
                                          int b, int seg, float acc,
                                          int first, int last) {
  if (last > b) {
    carry[b] = acc;                          // runs on past this tile
  } else {
    head_sum[b] = acc;                       // ends in this tile
  }
  unsigned drawn;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(drawn) : "l"(ticket + last) : "memory");
  if (drawn != (unsigned)(last - first)) return;
  ticket[last] = 0u;                         // ready for the next call
  float sum = __ldcg(carry + first);
#pragma unroll 4
  for (int c = first + 1; c < last; ++c) sum += __ldcg(carry + c);
  out.store(seg, sum + __ldcg(head_sum + last));
}

// The whole segmented sum (see the note above): one block per tile.
__global__ void __launch_bounds__(kThreads)
segsum_tile_kernel(const float* __restrict__ vals,
                   const int* __restrict__ gather,
                   const int* __restrict__ ptr, Out out, int n_seg,
                   float* __restrict__ carry, float* __restrict__ head_sum,
                   unsigned* __restrict__ ticket) {
  __shared__ unsigned starts[kTile / 32 + 1];  // bit i: a segment starts at i
  __shared__ int seg_at[kTile];      // that segment, where the bit is set
  __shared__ int win[kWin + 1];      // a window of ptr at the tile start
  __shared__ Part warp_total[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int t0 = b * kTile;
  const int live = __ldg(ptr + n_seg);
  if (b == 0 && tid == 0) out.store(n_seg, 0.0f);   // scratch / sentinel
  if (t0 > live) return;
  const int t1 = min(t0 + kTile, live);

  // this thread's entries [e0, e0 + kItems): the ids streamed now, the
  // values gathered after step 1, so that step 1's few loads of ptr do not
  // queue behind the tile's gathers
  const int i0 = tid * kItems;
  const int e0 = t0 + i0;
  int id[kItems];
  if (e0 + kItems <= t1 && (reinterpret_cast<uintptr_t>(gather) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(gather + e0) + q);
      id[4 * q] = x.x;
      id[4 * q + 1] = x.y;
      id[4 * q + 2] = x.z;
      id[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      id[j] = e0 + j < t1 ? __ldg(gather + e0 + j) : -1;
    }
  }
  if (tid <= kTile / 32) starts[tid] = 0u;

  // step 1: k_lo, the first segment starting at or after t0.  Block-wide
  // kThreads-ary steps narrow [lo, hi) to at most kThreads offsets; the
  // block then loads a window of kWin offsets from lo, counts those below
  // t0 for k_lo, and marks from the window what starts in the tile.
  int lo = 0, hi = b == 0 ? 0 : n_seg;       // tile 0: k_lo = 0 (ptr[0] = 0)
  while (hi - lo > kThreads) {
    const int64_t span = hi - lo;
    const int a = __ldg(ptr + lo + (int)(span * tid / kThreads));
    const int nb = __syncthreads_count(a < t0);
    if (nb == 0) {
      hi = lo;
    } else {
      if (nb < kThreads) hi = lo + (int)(span * nb / kThreads);
      lo += (int)(span * (nb - 1) / kThreads) + 1;
    }
  }
  // the window: ptr[lo .. lo + kWin], two offsets a thread, one round trip
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int w = lo + tid + r * kThreads;
    win[tid + r * kThreads] = w <= n_seg ? __ldg(ptr + w) : INT_MAX;
  }
  if (tid == kThreads - 1) {
    win[kWin] = lo + kWin <= n_seg ? __ldg(ptr + lo + kWin) : INT_MAX;
  }
  const int k_lo =
      lo + __syncthreads_count(lo + tid < hi && win[tid] < t0);
  // mark the first entry of each non-empty segment starting in the tile;
  // an empty one is written +0.0 here, by the tile holding its offset
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = tid + r * kThreads;
    const int k = lo + i;
    if (k >= k_lo && k < n_seg && win[i] < t0 + kTile) {
      if (win[i + 1] > win[i]) {
        mark_start(starts, seg_at, win[i] - t0, k);
      } else {
        out.store(k, 0.0f);
      }
    }
  }
  if (lo + kWin < n_seg && win[kWin] < t0 + kTile) {
    // more segments start in the tile than the window holds
    for (int k0 = lo + kWin;; k0 += kThreads) {
      const int k = k0 + tid;
      bool more = false;
      if (k < n_seg) {
        const int a = __ldg(ptr + k);
        if (a < t0 + kTile) {
          more = true;
          if (__ldg(ptr + k + 1) > a) {
            mark_start(starts, seg_at, a - t0, k);
          } else {
            out.store(k, 0.0f);
          }
        }
      }
      if (!__syncthreads_or(more && tid == kThreads - 1)) break;
    }
  }
  __syncthreads();
  const int k_first = k_lo - 1;    // holds t0 when position 0 is no start

  float v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    v[j] = e0 + j < t1 ? __ldg(vals + id[j]) : 0.0f;
  }

  // step 2: the segmented scan, in-thread then across the block.  The
  // thread's 8 start bits, and the next thread's first, in one word pair.
  const unsigned bits = static_cast<unsigned>(
      (static_cast<unsigned long long>(starts[(tid >> 2) + 1]) << 32 |
       starts[tid >> 2]) >> (8 * (tid & 3))) & 0x1ffu;
  Part inc{0.0f, -1};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (bits >> j & 1u) inc = Part{0.0f, i0 + j};
    inc.v += v[j];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Part o{__shfl_up_sync(0xffffffffu, inc.v, off),
                 __shfl_up_sync(0xffffffffu, inc.pos, off)};
    if (lane >= off) inc = combine(o, inc);
  }
  Part exc{__shfl_up_sync(0xffffffffu, inc.v, 1),
           __shfl_up_sync(0xffffffffu, inc.pos, 1)};
  if (lane == 0) exc = Part{0.0f, -1};
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  Part pre{0.0f, -1};
#pragma unroll 1
  for (int u = 0; u < warp; ++u) pre = combine(pre, warp_total[u]);
  exc = combine(pre, exc);

  // step 3: each segment's sum within the tile, at its last entry here.
  // A segment that began in an earlier tile ends at most once per tile
  // (its head piece), and only the tile's last entry can leave a piece
  // that may run on; both go to step 4 after the loop.
  float acc = exc.v;
  bool started = exc.pos >= 0;               // cur starts in this tile
  int cur = started ? seg_at[exc.pos] : k_first;
  int head_seg = -1, edge_seg = -1;
  float head_acc = 0.0f, edge_acc = 0.0f;
  bool edge_started = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = e0 + j;
    if (e >= t1) break;
    if (bits >> j & 1u) {
      cur = seg_at[i0 + j];
      acc = 0.0f;
      started = true;
    }
    acc += v[j];
    if (e + 1 < t1 && !(bits >> (j + 1) & 1u)) continue;  // cur goes on
    if (e + 1 == t0 + kTile) {
      edge_seg = cur;
      edge_acc = acc;
      edge_started = started;
    } else if (started) {
      out.store(cur, acc);                   // wholly in the tile
    } else {
      head_seg = cur;
      head_acc = acc;
    }
  }
  // ptr[k], from the window where it holds k
  auto ptr_at = [&](int k) {
    return k >= lo && k - lo <= kWin ? win[k - lo] : __ldg(ptr + k);
  };
  if (head_seg >= 0) {
    segsum_piece(out, carry, head_sum, ticket, b, head_seg, head_acc,
                 ptr_at(head_seg) / kTile, b);
  }
  if (edge_seg >= 0) {
    const int end = ptr_at(edge_seg + 1);
    if (edge_started && end == t0 + kTile) {
      out.store(edge_seg, edge_acc);         // wholly in the tile
    } else {
      segsum_piece(out, carry, head_sum, ticket, b, edge_seg, edge_acc,
                   edge_started ? b : ptr_at(edge_seg) / kTile,
                   (end - 1) / kTile);
    }
  }
}

// K1 and K6: one block per tile.  scratch: 2 * n_tiles floats (carry,
// head_sum); ticket: n_tiles zeroed counters, left zeroed.
int launch_segsum(const float* vals, const int* gather, const int* ptr,
                  Out out, float* scratch, unsigned* ticket, int n_seg,
                  int n_entries, cudaStream_t stream) {
  const int n_tiles = n_entries / kTile + 1;
  segsum_tile_kernel<<<n_tiles, kThreads, 0, stream>>>(
      vals, gather, ptr, out, n_seg, scratch, scratch + n_tiles, ticket);
  return (int)cudaGetLastError();
}

constexpr int kGatherThreads = 256;

// The three per-link vectors; hop id n_links is the scratch slot.
struct LinkVals {
  const float* scale;
  const float* clean;
  const float* delay;
  int n_links;
};

// A row's reduction: min of scale, product of clean, sum of delay.
struct Reduced {
  float mn, prod, tot;
};

// Hop l's (scale, clean, delay), the identity (1, 1, 0) at l = n_links.
__device__ __forceinline__ Reduced link_value(const LinkVals& lv, int l) {
  if (l >= lv.n_links) return Reduced{1.0f, 1.0f, 0.0f};
  return Reduced{__ldg(lv.scale + l), __ldg(lv.clean + l),
                 __ldg(lv.delay + l)};
}

__device__ __forceinline__ void fold(Reduced& r, const Reduced& v) {
  r.mn = fminf(r.mn, v.mn);
  r.prod = __fmul_rn(r.prod, v.prod);
  r.tot = __fadd_rn(r.tot, v.tot);
}

// One row of hop ids, hop 0 first.  H > 0: the row has H hops, all ids
// loaded before the first gather; H == 0: h hops, one at a time.
template <int H>
__device__ __forceinline__ Reduced reduce_row(const int* __restrict__ row,
                                              int h, const LinkVals& lv) {
  if constexpr (H > 0) {
    int id[H];
#pragma unroll
    for (int j = 0; j < H; ++j) id[j] = __ldg(row + j);
    Reduced r = link_value(lv, id[0]);
#pragma unroll
    for (int j = 1; j < H; ++j) fold(r, link_value(lv, id[j]));
    return r;
  } else {
    Reduced r = link_value(lv, __ldg(row));
    for (int j = 1; j < h; ++j) fold(r, link_value(lv, __ldg(row + j)));
    return r;
  }
}

__device__ __forceinline__ int64_t this_row() {
  return blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
}

// K2 flat: out = [min (n_rows,) | 1 - prod (n_rows,) | sum (n_rows,)].
template <int H>
__global__ void __launch_bounds__(kGatherThreads)
link_gathers_kernel(const int* __restrict__ idx, LinkVals lv,
                    float* __restrict__ out, int64_t n_rows, int h) {
  const int64_t r = this_row();
  if (r >= n_rows) return;
  const Reduced g = reduce_row<H>(idx + r * (H > 0 ? H : h), h, lv);
  out[r] = g.mn;
  out[n_rows + r] = __fsub_rn(1.0f, g.prod);
  out[2 * n_rows + r] = g.tot;
}

// uno_pt_gathers, pass 1: seg[u] = {min, prod, sum, 0} of segment u.
template <int H>
__global__ void __launch_bounds__(kGatherThreads)
pt_segments_kernel(const int* __restrict__ seg_idx, LinkVals lv,
                   float4* __restrict__ seg, int64_t n_seg, int hseg) {
  const int64_t u = this_row();
  if (u >= n_seg) return;
  const Reduced g = reduce_row<H>(seg_idx + u * (H > 0 ? H : hseg), hseg, lv);
  seg[u] = make_float4(g.mn, g.prod, g.tot, 0.0f);
}

// uno_pt_gathers, pass 2: each subflow's two segments composed.
__global__ void __launch_bounds__(kGatherThreads)
pt_compose_kernel(const int* __restrict__ pre_id,
                  const int* __restrict__ suf_id,
                  const float4* __restrict__ seg, float* __restrict__ out,
                  int64_t n_sub) {
  const int64_t i = this_row();
  if (i >= n_sub) return;
  const float4 a = __ldg(seg + __ldg(pre_id + i));
  const float4 b = __ldg(seg + __ldg(suf_id + i));
  out[i] = fminf(a.x, b.x);
  out[n_sub + i] = __fsub_rn(1.0f, __fmul_rn(a.y, b.y));
  out[2 * n_sub + i] = __fadd_rn(a.z, b.z);
}

int blocks_for_rows(int64_t n_rows) {
  return (int)((n_rows + kGatherThreads - 1) / kGatherThreads);
}

template <int H>
struct FlatGathers {
  static void launch(const int* idx, LinkVals lv, float* out, int64_t n_rows,
                     int h, cudaStream_t stream) {
    link_gathers_kernel<H><<<blocks_for_rows(n_rows), kGatherThreads, 0,
                             stream>>>(idx, lv, out, n_rows, h);
  }
};

template <int H>
struct PtSegments {
  static void launch(const int* seg_idx, LinkVals lv, float4* seg,
                     int64_t n_seg, int hseg, cudaStream_t stream) {
    pt_segments_kernel<H><<<blocks_for_rows(n_seg), kGatherThreads, 0,
                            stream>>>(seg_idx, lv, seg, n_seg, hseg);
  }
};

// Launch<H>::launch(args...) for the hop count h: H = h up to 16, else
// the runtime loop (H = 0).
template <template <int> class Launch, class... Args>
void launch_by_hops(int h, Args... args) {
  switch (h) {
#define UNO_HOPS_CASE(N)        \
  case N:                       \
    Launch<N>::launch(args...); \
    return;
    UNO_HOPS_CASE(1) UNO_HOPS_CASE(2) UNO_HOPS_CASE(3) UNO_HOPS_CASE(4)
    UNO_HOPS_CASE(5) UNO_HOPS_CASE(6) UNO_HOPS_CASE(7) UNO_HOPS_CASE(8)
    UNO_HOPS_CASE(9) UNO_HOPS_CASE(10) UNO_HOPS_CASE(11) UNO_HOPS_CASE(12)
    UNO_HOPS_CASE(13) UNO_HOPS_CASE(14) UNO_HOPS_CASE(15) UNO_HOPS_CASE(16)
#undef UNO_HOPS_CASE
    default:
      Launch<0>::launch(args...);
  }
}

// ------------------------------------------------------------ rel_epoch

constexpr int kRelThreads = 256;
constexpr int kCoefCols = 17;                // reliability.MAX_R + 1

// The EC ladder's layout, read from the tables' shapes by the wrapper.
enum RelForm { kRelStatic = 0, kRelShared = 1, kRelPerCell = 2 };

// The operands, in the order fleet_cuda.rel_epoch packs them (_REL_FLOW,
// _REL_KNOBS, _REL_STATE; out the new RelState, cut, goodput): all (n,)
// but split and sub_loss (n, p), coef (n, kCoefCols), the ladder tables
// ((L,) and (L, kCoefCols), or (cells, L) and (cells, L, kCoefCols)) and
// dt (a 0-d tensor).  The RelState
// fields follow in RelState's order; the static form leaves the last
// three (rung, loss_ewma, adapt_cd) unread and unwritten.
struct RelIn {
  const float *rate, *rtx, *sc, *rtt, *split, *sub_loss, *dt;
  const uint8_t *enabled, *adapt_on;
  const float *ec_k, *ec_r, *ec_eff;
  const int *nack_period, *nack_hold;
  const float *nack_quantum, *coef;
  const float *lad_k, *lad_r, *lad_eff, *lad_coef, *lad_up, *lad_down;
  const float *pending, *backlog;
  const int *ack_cd, *hold;
  const float *md_cd, *rtx_ewma, *lat_ewma, *nacks, *rec_bytes, *rtx_bytes,
      *wire_bytes, *lost_bytes;
  const int* rung;
  const float *loss_ewma, *adapt_cd;
};

struct RelOut {
  float *pending, *backlog;
  int *ack_cd, *hold;
  float *md_cd, *rtx_ewma, *lat_ewma, *nacks, *rec_bytes, *rtx_bytes,
      *wire_bytes, *lost_bytes;
  int* rung;
  float *loss_ewma, *adapt_cd;
  uint8_t* cut;
  float* goodput;
};

// torch.clamp's one-sided bounds: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : (x > hi ? hi : x);
}

// torch.sum's order over L lanes (the note at the top of the file): lane
// j adds lane j + L / 2, then j + L / 4, and so on down to j + 1.
template <int L>
__device__ __forceinline__ float pair_sum(float (&v)[L]) {
#pragma unroll
  for (int s = L / 2; s >= 1; s >>= 1)
#pragma unroll
    for (int j = 0; j < s; ++j) v[j] = __fadd_rn(v[j], v[j + s]);
  return v[0];
}

// The flow's loss fraction over its 2 <= p < 2 L paths, L = last_pow2(p):
// lane x holds split * loss of path x, plus that of path x + L.
template <int L>
__device__ __forceinline__ float path_loss(const float* __restrict__ split,
                                           const float* __restrict__ loss,
                                           int p) {
  float v[L];
#pragma unroll
  for (int x = 0; x < L; ++x) {
    v[x] = __fmul_rn(__ldg(split + x), __ldg(loss + x));
    if (x + L < p)
      v[x] = __fadd_rn(v[x], __fmul_rn(__ldg(split + x + L),
                                       __ldg(loss + x + L)));
  }
  return pair_sum(v);
}

// E[X 1(X <= r)] for X ~ Binomial(n, q), from the flow's pmf coefficients
// C(n, i), i = 1..r: the i = 0 term is 0, coef is 0 past r, and at q = 0
// every term is 0.  torch.sum puts the kCoefCols terms on 16 lanes, term i
// on lane i mod 16 (the i = 16 term beside the i = 0 one, 0), and first
// adds lane j + 8 to lane j: acc[j] takes terms j and j + 8 as they come
// (an add of a term, which is >= 0, to 0 is exact), a rolled loop with
// no array indexed at run time; `pair_sum` does the rest.
__device__ __forceinline__ float rec_window(const float* __restrict__ crow,
                                            float n, float r, float q) {
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  if (q == 0.0f) return 0.0f;
  const float keep = __fsub_rn(1.0f, q);
  const int top = min((int)r, kCoefCols - 1);
  for (int i = 1; i <= top; ++i) {
    const float fi = (float)i;
    const float p_i =
        __fmul_rn(__fmul_rn(__ldg(crow + i), powf(q, fi)),
                  powf(keep, clamp_min(__fsub_rn(n, fi), 0.0f)));
    const float t = __fmul_rn(fi, p_i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] = (i & 7) == j ? __fadd_rn(acc[j], t) : acc[j];
  }
  return pair_sum(acc);
}

// One epoch of the reliability phase, one flow a thread (the note at the
// top of the file).  FORM: the ladder's layout.
template <int FORM>
__global__ void __launch_bounds__(kRelThreads)
rel_epoch_kernel(RelIn in, RelOut out, int64_t n, int n_paths,
                 int64_t cell_flows, int n_rungs) {
  const int64_t f = (int64_t)blockIdx.x * kRelThreads + threadIdx.x;
  if (f >= n) return;
  constexpr bool kLadder = FORM != kRelStatic;
  const float dt = __ldg(in.dt);
  const float rate = __ldg(in.rate + f), rtx = __ldg(in.rtx + f),
              sc = __ldg(in.sc + f), rtt = __ldg(in.rtt + f);
  const float* split = in.split + f * n_paths;
  const float* loss = in.sub_loss + f * n_paths;
  float lf;
  if (n_paths == 1)
    lf = __fmul_rn(__ldg(split), __ldg(loss));
  else if (n_paths < 4)
    lf = path_loss<2>(split, loss, n_paths);
  else if (n_paths < 8)
    lf = path_loss<4>(split, loss, n_paths);
  else if (n_paths < 16)
    lf = path_loss<8>(split, loss, n_paths);
  else if (n_paths < 32)
    lf = path_loss<16>(split, loss, n_paths);
  else
    lf = path_loss<32>(split, loss, n_paths);
  const bool en = __ldg(in.enabled + f) != 0;
  const int period = __ldg(in.nack_period + f),
            holdoff = __ldg(in.nack_hold + f);
  const float quantum = __ldg(in.nack_quantum + f);
  const int ack_cd = __ldg(in.ack_cd + f), hold = __ldg(in.hold + f);
  const float pending = __ldg(in.pending + f),
              backlog = __ldg(in.backlog + f), md_cd = __ldg(in.md_cd + f);

  // the geometry at the flow's rung: its own (k, r, eff, coef row), or its
  // cell's ladder row when it adapts
  float k, r, eff;
  const float* crow;
  bool on = false;
  int rung = 0;
  int64_t t = 0;
  if constexpr (kLadder) {
    on = __ldg(in.adapt_on + f) != 0;
    rung = __ldg(in.rung + f);
    t = (FORM == kRelPerCell ? f / cell_flows * n_rungs : 0) + rung;
  }
  if (on) {
    k = __ldg(in.lad_k + t);
    r = __ldg(in.lad_r + t);
    eff = __ldg(in.lad_eff + t);
    crow = in.lad_coef + t * kCoefCols;
  } else {
    k = __ldg(in.ec_k + f);
    r = __ldg(in.ec_r + f);
    eff = __ldg(in.ec_eff + f);
    crow = in.coef + f * kCoefCols;
  }

  const float g = clamp_max(__fdiv_rn(dt, rtt), 1.0f);
  const float q = clamp_max(clamp_min(lf, 0.0f), 1.0f);
  // the recovery split at the current rung
  const float nn = __fadd_rn(k, r);
  const float win = rec_window(crow, nn, r, q);
  const float nack_win = clamp_min(__fsub_rn(__fmul_rn(nn, q), win), 0.0f);
  const float scale =
      en ? __fdiv_rn(k, clamp_min(__fmul_rn(nn, nn), 1.0f)) : 0.0f;
  const float recovered = __fmul_rn(rate, __fmul_rn(win, scale));
  const float nack_frac = __fmul_rn(nack_win, scale);
  // the NACK machine
  const float lost_new = __fadd_rn(__fmul_rn(__fmul_rn(rate, nack_frac), dt),
                                   __fmul_rn(__fmul_rn(rtx, q), dt));
  const float pend = __fadd_rn(pending, lost_new);
  const bool tick = ack_cd <= 1;
  const bool fire = tick && hold <= 0 && pend >= quantum && en;
  out.backlog[f] =
      __fadd_rn(clamp_min(__fsub_rn(backlog, __fmul_rn(rtx, dt)), 0.0f),
                fire ? pend : 0.0f);
  out.pending[f] = fire ? 0.0f : pend;
  out.hold[f] = fire ? holdoff : max(hold - 1, 0);
  out.ack_cd[f] = tick ? period : ack_cd - 1;
  const bool cut = fire && md_cd <= 0.0f;
  out.cut[f] = cut;
  out.md_cd[f] = cut ? rtt : clamp_min(__fsub_rn(md_cd, dt), 0.0f);
  // the EC ladder
  if constexpr (kLadder) {
    const float ewma0 = __ldg(in.loss_ewma + f);
    const float ewma = __fadd_rn(ewma0, __fmul_rn(g, __fsub_rn(q, ewma0)));
    const float cd =
        clamp_min(__fsub_rn(__ldg(in.adapt_cd + f), dt), 0.0f);
    const bool can = on && en && cd <= 0.0f;
    const bool step_up =
        can && ewma > __ldg(in.lad_up + t) && rung < n_rungs - 1;
    const bool step_dn = can && ewma < __ldg(in.lad_down + t) && rung > 0;
    out.rung[f] = rung + (int)step_up - (int)step_dn;
    out.adapt_cd[f] = step_up || step_dn ? rtt : cd;
    out.loss_ewma[f] = ewma;
  }
  // latency and retransmit EWMAs, the cumulative counters
  const float lat_nack = __fadd_rn(
      __fmul_rn(1.5f, rtt),
      __fmul_rn(__fmul_rn(0.5f, (float)(period + holdoff)), dt));
  const float vol = __fadd_rn(recovered, rtx);
  const float inst = __fdiv_rn(
      __fadd_rn(__fmul_rn(recovered, rtt), __fmul_rn(rtx, lat_nack)),
      clamp_min(vol, 1e-9f));
  const float lat = __ldg(in.lat_ewma + f);
  out.lat_ewma[f] =
      vol > 0.0f ? __fadd_rn(lat, __fmul_rn(g, __fsub_rn(inst, lat))) : lat;
  const float rtx_ewma = __ldg(in.rtx_ewma + f);
  out.rtx_ewma[f] =
      __fadd_rn(rtx_ewma, __fmul_rn(g, __fsub_rn(rtx, rtx_ewma)));
  out.nacks[f] = __fadd_rn(__ldg(in.nacks + f), fire ? 1.0f : 0.0f);
  out.rec_bytes[f] =
      __fadd_rn(__ldg(in.rec_bytes + f), __fmul_rn(recovered, dt));
  out.rtx_bytes[f] = __fadd_rn(__ldg(in.rtx_bytes + f), __fmul_rn(rtx, dt));
  const float wire = __fadd_rn(rate, rtx);
  out.wire_bytes[f] =
      __fadd_rn(__ldg(in.wire_bytes + f), __fmul_rn(wire, dt));
  out.lost_bytes[f] = __fadd_rn(__ldg(in.lost_bytes + f),
                                __fmul_rn(__fmul_rn(wire, q), dt));
  // the goodput split at the old rung's efficiency
  out.goodput[f] = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(wire, sc), eff),
                __fmul_rn(__fmul_rn(rtx, sc), __fsub_rn(1.0f, eff))),
      recovered);
}

template <int FORM>
void launch_rel_epoch(const RelIn& in, const RelOut& out, int64_t n,
                      int n_paths, int64_t cell_flows, int n_rungs,
                      cudaStream_t stream) {
  const int blocks = (int)((n + kRelThreads - 1) / kRelThreads);
  rel_epoch_kernel<FORM><<<blocks, kRelThreads, 0, stream>>>(
      in, out, n, n_paths, cell_flows, n_rungs);
}

// ------------------------------------------------------------ lb_update

constexpr int kLbThreads = 256;
constexpr int kLbMaxPaths = 8;               // fleet_cuda.LB_MAX_PATHS
constexpr float kSplitEps = 1e-9f;           // links._EPS in float32

// The operands, in the order fleet_cuda.LbUpdate packs them (_LB_IN,
// _LB_OUT): split, path_frac, sub_frac, bad_count and mask (n, p); fb and
// the LbParams (n,).
struct LbIn {
  const float *split, *path_frac, *sub_frac;
  const int* bad_count;
  const uint8_t* mask;
  const float *fb, *eta, *thresh;
  const int* patience;
  const float* w_floor;
};

struct LbOut {
  float *path_frac, *split;
  int* bad_count;
};

__host__ __device__ constexpr int last_pow2(int p) {
  return p >= 2 ? 2 * last_pow2(p / 2) : 1;
}

// The widest access (in elements: 4, 2 or 1) that divides a row of p.
__host__ __device__ constexpr int row_vec(int p) {
  return p % 4 == 0 ? 4 : p % 2 == 0 ? 2 : 1;
}

template <int P>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[P]) {
  if constexpr (row_vec(P) == 4) {
#pragma unroll
    for (int i = 0; i < P / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else if constexpr (row_vec(P) == 2) {
#pragma unroll
    for (int i = 0; i < P / 2; ++i) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = __ldg(p + i);
  }
}

template <int P>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[P]) {
  if constexpr (row_vec(P) == 4) {
#pragma unroll
    for (int i = 0; i < P / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (row_vec(P) == 2) {
#pragma unroll
    for (int i = 0; i < P / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) p[i] = v[i];
  }
}

// int32 rows move as their bits.
template <int P>
__device__ __forceinline__ void load_row(const int* __restrict__ p,
                                         int (&v)[P]) {
  float f[P];
  load_row<P>(reinterpret_cast<const float*>(p), f);
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = __float_as_int(f[i]);
}

template <int P>
__device__ __forceinline__ void store_row(int* __restrict__ p,
                                          const int (&v)[P]) {
  float f[P];
#pragma unroll
  for (int i = 0; i < P; ++i) f[i] = __int_as_float(v[i]);
  store_row<P>(reinterpret_cast<float*>(p), f);
}

// The mask row of p bools as 0 / 1: one load where p is 1, 2, 4 or 8.
template <int P>
__device__ __forceinline__ void load_mask(const uint8_t* __restrict__ p,
                                          bool (&m)[P]) {
  unsigned long long bits = 0;
  if constexpr (P == 8) {
    bits = __ldg(reinterpret_cast<const unsigned long long*>(p));
  } else if constexpr (P == 4) {
    bits = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (P == 2) {
    bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      bits |= (unsigned long long)__ldg(p + i) << (8 * i);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) m[i] = ((bits >> (8 * i)) & 0xffu) != 0;
}

// torch.sum over a row of P: lane x of last_pow2(P) lanes holds a[x] +
// a[x + lanes], then `pair_sum`.
template <int P>
__device__ __forceinline__ float row_sum(const float (&a)[P]) {
  constexpr int L = last_pow2(P);
  float v[L];
#pragma unroll
  for (int x = 0; x < L; ++x)
    v[x] = x + L < P ? __fadd_rn(a[x], a[x + L]) : a[x];
  return pair_sum(v);
}

// torch.maximum: NaN wins, else the larger.
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

// One epoch of UnoLB's split update (the note at the top of the file).
template <int P>
__global__ void __launch_bounds__(kLbThreads)
lb_update_kernel(LbIn in, LbOut out, int64_t n) {
  for (int64_t f = (int64_t)blockIdx.x * kLbThreads + threadIdx.x; f < n;
       f += (int64_t)gridDim.x * kLbThreads) {
    const int64_t o = f * P;
    float split[P], pf[P], sf[P], w[P];
    int bc[P];
    bool m[P];
    load_row<P>(in.split + o, split);
    load_row<P>(in.path_frac + o, pf);
    load_row<P>(in.sub_frac + o, sf);
    load_row<P>(in.bad_count + o, bc);
    load_mask<P>(in.mask + o, m);
    const float fb = __ldg(in.fb + f), neg_eta = -__ldg(in.eta + f),
                thresh = __ldg(in.thresh + f),
                w_floor = __ldg(in.w_floor + f);
    const int patience = __ldg(in.patience + f);
    float count = 0.0f;                      // valid paths, exact
#pragma unroll
    for (int j = 0; j < P; ++j) {
      // the lagged per-path mark fraction
      pf[j] = __fadd_rn(pf[j], __fmul_rn(fb, __fsub_rn(sf[j], pf[j])));
      // the bad-epoch count and the repath it triggers
      const int c = m[j] && pf[j] > thresh ? bc[j] + 1 : 0;
      const bool repath = c >= patience;
      bc[j] = repath ? 0 : c;
      // the multiplicative weights, clamped at 0 and masked
      const float x = repath ? 0.0f
                             : __fmul_rn(split[j],
                                         expf(__fmul_rn(neg_eta, pf[j])));
      const float mj = m[j] ? 1.0f : 0.0f;
      w[j] = __fmul_rn(clamp_min(x, 0.0f), mj);
      count = __fadd_rn(count, mj);
    }
    const float n_valid = clamp_min(count, 1.0f);
    const float trickle = __fdiv_rn(w_floor, n_valid);
#pragma unroll
    for (int j = 0; j < P; ++j)
      w[j] = maximum(w[j], __fmul_rn(trickle, m[j] ? 1.0f : 0.0f));
    const float s = row_sum<P>(w);
#pragma unroll
    for (int j = 0; j < P; ++j)
      w[j] = s > kSplitEps ? __fdiv_rn(w[j], s)
                           : __fdiv_rn(m[j] ? 1.0f : 0.0f, n_valid);
    store_row<P>(out.path_frac + o, pf);
    store_row<P>(out.split + o, w);
    store_row<P>(out.bad_count + o, bc);
  }
}

// A block for every 256 flows; the kernel's loop takes over only past
// INT_MAX blocks.
template <int P>
void launch_lb_update(const LbIn& in, const LbOut& out, int64_t n,
                      cudaStream_t stream) {
  const int64_t want = (n + kLbThreads - 1) / kLbThreads;
  const int blocks = (int)(want < INT_MAX ? want : INT_MAX);
  lb_update_kernel<P><<<blocks, kLbThreads, 0, stream>>>(in, out, n);
}

}  // namespace

extern "C" {

// Entries per tile of K1/K6; the wrappers size the scratch with it.
int uno_segsum_tile(void) { return kTile; }

// vals: (V,) f32; gather: (E,) int32 ids into vals, sorted by segment;
// ptr: (n_seg + 2,) int32 CSR offsets, ptr[0] = 0, ptr[n_seg] <= E;
// out: (n_seg + 1,) f32; scratch: (2 * n_tiles,) f32 and ticket:
// (n_tiles,) zeroed int32 for n_tiles = E / tile + 1; ticket is left
// zeroed, so one buffer serves every call on a stream.
int uno_link_scatter(const float* vals, const int* gather, const int* ptr,
                     float* out, float* scratch, unsigned* ticket,
                     int n_seg, int n_entries, cudaStream_t stream) {
  return launch_segsum(vals, gather, ptr, Out{out, out, n_seg + 1}, scratch,
                       ticket, n_seg, n_entries, stream);
}

// K1's operands; priv: (n_seg - n_boundary,) f32; bnd: (n_boundary + 1,)
// f32.  0 < n_boundary < n_seg (the wrapper checks).
int uno_link_scatter_tiles(const float* vals, const int* gather,
                           const int* ptr, float* priv, float* bnd,
                           float* scratch, unsigned* ticket, int n_seg,
                           int n_boundary, int n_entries,
                           cudaStream_t stream) {
  return launch_segsum(vals, gather, ptr,
                       Out{priv, bnd, n_seg - n_boundary}, scratch, ticket,
                       n_seg, n_entries, stream);
}

// K2 flat.  idx: (n_rows, h) int32 in [0, n_links]; scale, clean, delay:
// (n_links,) f32; out: (3, n_rows) f32 [min scale | 1 - prod clean | sum
// delay].  n_rows > 0, h > 0 (the wrapper checks).
int uno_link_gathers(const int* idx, const float* scale, const float* clean,
                     const float* delay, int n_links, float* out,
                     long long n_rows, int h, cudaStream_t stream) {
  launch_by_hops<FlatGathers>(h, idx, LinkVals{scale, clean, delay, n_links},
                              out, (int64_t)n_rows, h, stream);
  return (int)cudaGetLastError();
}

// K2 over the PathTable, path_table_gathers in full.  pre_id, suf_id:
// (n_sub,) int32 in [0, n_seg); seg_idx: (n_seg, hseg) int32 in [0,
// n_links]; scale, clean, delay as above; seg: (n_seg, 4) f32 scratch,
// 16-byte aligned; out: (3, n_sub) f32 [sub_scale | sub_frac | sub_delay].
// n_sub > 0, n_seg > 0, hseg > 0.  Two launches: segments, then subflows.
int uno_pt_gathers(const int* pre_id, const int* suf_id, const int* seg_idx,
                   const float* scale, const float* clean, const float* delay,
                   int n_links, float* seg, float* out, long long n_sub,
                   long long n_seg, int hseg, cudaStream_t stream) {
  float4* seg4 = reinterpret_cast<float4*>(seg);
  launch_by_hops<PtSegments>(hseg, seg_idx,
                             LinkVals{scale, clean, delay, n_links}, seg4,
                             (int64_t)n_seg, hseg, stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pt_compose_kernel<<<blocks_for_rows(n_sub), kGatherThreads, 0, stream>>>(
      pre_id, suf_id, seg4, out, (int64_t)n_sub);
  return (int)cudaGetLastError();
}

// The reliability phase of the epoch step (reliability.rel_step), one
// launch.  in_ptrs: the RelIn operands, out_ptrs: the RelOut ones, in
// those structs' order, null where absent; n > 0 flows of 1 <= n_paths <
// 64 paths; form: RelForm; cell_flows: flows per cell (kRelPerCell);
// n_rungs: the ladder's length.
int uno_rel_epoch(const void* const* in_ptrs, void* const* out_ptrs,
                  long long n, int n_paths, long long cell_flows, int n_rungs,
                  int form, cudaStream_t stream) {
  RelIn in;
  RelOut out;
  memcpy(&in, in_ptrs, sizeof(in));
  memcpy(&out, out_ptrs, sizeof(out));
  switch (form) {
    case kRelStatic:
      launch_rel_epoch<kRelStatic>(in, out, n, n_paths, cell_flows, n_rungs,
                                   stream);
      break;
    case kRelShared:
      launch_rel_epoch<kRelShared>(in, out, n, n_paths, cell_flows, n_rungs,
                                   stream);
      break;
    case kRelPerCell:
      launch_rel_epoch<kRelPerCell>(in, out, n, n_paths, cell_flows,
                                    n_rungs, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// UnoLB's split update (cc.lb_update_plain), one launch.  in_ptrs: the
// LbIn operands, out_ptrs: the LbOut ones, in those structs' order; n > 0
// flows of 1 <= n_paths <= kLbMaxPaths paths; every (n, p) row aligned to
// its vector access (the wrapper checks).
int uno_lb_update(const void* const* in_ptrs, void* const* out_ptrs,
                  long long n, int n_paths, cudaStream_t stream) {
  LbIn in;
  LbOut out;
  memcpy(&in, in_ptrs, sizeof(in));
  memcpy(&out, out_ptrs, sizeof(out));
  switch (n_paths) {
#define UNO_LB_CASE(N)                              \
  case N:                                           \
    launch_lb_update<N>(in, out, (int64_t)n, stream); \
    break;
    UNO_LB_CASE(1) UNO_LB_CASE(2) UNO_LB_CASE(3) UNO_LB_CASE(4)
    UNO_LB_CASE(5) UNO_LB_CASE(6) UNO_LB_CASE(7) UNO_LB_CASE(8)
#undef UNO_LB_CASE
    static_assert(kLbMaxPaths == 8, "one case for each path count");
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
