// Fused row-wise top-2 similarity search for Hopper (sm_90a): 3xTF32 on the
// tensor cores (wgmma), fed by TMA.
//
// Replaces the TPU kernel hfnet_slam_tpu/ops/pallas_match.py:row_top2 (body
// _match_kernel). For every row a of A it computes s = A[a] . B[j] over all
// columns j, with masked columns set to -1e9, and returns
//   best[a]   = max_j s,
//   idx[a]    = the argmax, LOWEST index on exact ties,
//   second[a] = the row max with only the argmax column knocked out to -1e9
//               (so an exact tie gives second == best, and NB == 1 or an
//               all-masked B gives second == -1e9).
// The (NA, NB) similarity matrix never reaches device memory.
//
// What bounds it on an H100. One call at NA = NB = 1024, D = 256 is
// 2 * 1024 * 1024 * 256 = 0.537 GFLOP of dot products, 2.1 MB of inputs.
// A single TF32 pass misses the float32 similarity by ~1e-4 and flips
// near-tie argmaxes, and float32 on the CUDA cores (67 TFLOP/s) leaves the
// tensor cores idle. 3xTF32 keeps float32 accuracy on them: three TF32
// products per multiply-add at 495 TFLOP/s, 3.25 us at that shape, 13 us at
// (1024, 4096, 256) and (4096, 1024, 256), 26 us at (1024, 8192, 256). The
// bytes (0.6-2.5 us at 3.35 TB/s) never bound it.
//
// Precision: 3xTF32. Each operand x splits into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (ties away from zero) with the
// low 13 bits cleared, so nothing depends on what the tensor core does with
// them. Per k-step of 8 the accumulator takes lo_A.hi_B, then hi_A.lo_B,
// then hi_A.hi_B (the small terms first); lo_A.lo_B is dropped. Every column
// goes through the same instruction sequence, so identical B rows give
// bit-identical similarities, which the exact-tie rule needs.
//
// Design.
//   * A block owns BM = 128 rows of A (two consumer warpgroups of 64 rows)
//     and a split of B's columns, walked in BN = 128-column tiles. For each
//     tile the D axis streams in BK = 32-float chunks (one 128-byte swizzle
//     row) through a ring of STAGES shared-memory stages. A and B are
//     row-major, which is K-major for A.B^T, so no transpose is needed.
//   * A third warpgroup feeds the ring: one thread issues the TMA loads of
//     the A and B chunks (128-byte swizzle, out-of-bounds rows and the D
//     tail zero-filled) onto the stage's `full` mbarrier; three warps then
//     split the B chunk in place into hi and a second lo plane, write the
//     tile's column fills (masking, see below) with its last chunk, and
//     arrive on the stage's `split` mbarrier. Splitting in shared memory
//     costs no device-memory traffic (a pre-pass writing split planes would
//     double the input bytes every block re-reads) and runs beside the
//     consumers' tensor-core work.
//   * The consumers read their A fragment of each k-step from the swizzled
//     stage with plain loads (bank-conflict free), split it in registers,
//     and issue wgmma.m64n128k8.f32.tf32 with A from registers and B_hi /
//     B_lo from shared memory through 128B-swizzle descriptors. A warp
//     releases the stage on its `empty` mbarrier once its wgmmas are done.
//     Each warpgroup drains its wgmmas at the end of every chunk: they read
//     the A fragments from registers asynchronously, so the next chunk's
//     fragments cannot be loaded while they run; the other warpgroup's
//     wgmmas keep the tensor cores busy meanwhile.
//   * What holds it back: shared-memory traffic. Per chunk a block moves
//     192 KB through shared memory (TMA 32 KB, the split 48 KB, wgmma's B
//     reads 96 KB, A fragments 16 KB) for 3 x 2 x 128 x 128 x 32 flops.
//     Dropping the split or two of the three wgmmas (a quarter or a third
//     of that traffic) each saves about a fifth of the time; halving the
//     L2 bytes or shortening the ring saves little
//     (tools/row_top2_breakdown.py, PERF.md).
//   * After the last chunk of a tile each thread folds its 64 accumulators
//     (2 rows x 32 columns) into a running (best, idx, second) per row;
//     each column enters as fma(s, mul, add) with the column's fill, so
//     masking costs one instruction and no device-memory load. The 4
//     threads of a row merge with shuffles at the end.
//   * Filling 132 SMs: at NA = 1024 there are only 8 row blocks, so B's
//     columns are split across blocks, sized so that one wave of at most
//     one block per SM covers every tile. Each block writes its per-split
//     states; the last block of a row block to finish (an atomic ticket)
//     merges them. With a single split the block writes the outputs.
// Merge rule: the winner is decided by (best, -idx); second becomes the max
// of the loser's best and both seconds. It is exact and order-free, so
// splits and lanes can merge in any order.
//
// Host side: the TMA descriptors are encoded per call by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
// -lcuda), and passed as __grid_constant__ kernel parameters, so the launch
// can be captured in a CUDA graph. TMA needs a 16-byte-aligned base and a
// row stride that is a multiple of 16 bytes; the wrapper copies inputs that
// break either rule into an aligned, zero-padded buffer first.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // A rows per block: two consumer warpgroups
constexpr int BN = 128;      // B columns per tile (wgmma N)
constexpr int BK = 32;       // D per stage: 128 bytes of float32
constexpr int STAGES = 4;
constexpr int NT = 384;      // consumers: warpgroups 0, 1; producer: warpgroup 2
constexpr int N_SPLIT_THREADS = 96;  // warps 9-11 split B; warp 8 issues TMA
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;
constexpr int FILL_BYTES = BN * 8;   // (mul, add) of each column of a tile
// a stage: A, B (split to hi in place), B lo, the tile's column fills; each
// part and each stage stays 1024-byte aligned
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES + FILL_BYTES;
constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BAR_OFFSET + 128 + 1024;  // barriers, a flag, alignment slack
constexpr float kNeg = -1e9f;
constexpr int kNoIdx = 0x7fffffff;
// a barrier wait that has not completed after this many cycles (~1 s) is a
// pipeline fault: trap, so the launch fails instead of hanging the card
constexpr long long kWaitLimit = 2000000000LL;

// Columns reach a thread's state in increasing order, so an exact tie keeps
// the earlier (lower) index and lands in `second`, making second == best.
__device__ __forceinline__ void push(float v, int j, float& best, float& second, int& idx) {
  const bool better = v > best;
  second = better ? best : fmaxf(second, v);  // the old best is the max of the old state
  best = better ? v : best;
  idx = better ? j : idx;
}

__device__ __forceinline__ void merge(float& best, float& second, int& idx,
                                      float ob, float os, int oi) {
  const bool other_wins = (ob > best) || (ob == best && oi < idx);
  const float loser_best = other_wins ? best : ob;
  second = fmaxf(fmaxf(second, os), loser_best);
  if (other_wins) {
    best = ob;
    idx = oi;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitLimit) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// float32 -> TF32 with round to nearest, ties away from zero, as
// cvt.rna.tf32.f32 gives for finite inputs: half a TF32 ulp added to the
// sign-magnitude bits, the low 13 bits cleared. Two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with
// 128-byte swizzle: rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart
// (stride byte offset 1024; the leading byte offset is unused for swizzled
// K-major layouts). The tile base is 1024-byte aligned; a k-step of 8 floats
// advances the start address by 32 bytes inside the swizzle row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most N of this warpgroup's committed groups are pending
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator reads across the wgmma wait
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

#define ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 per warpgroup, f32) = (scale_d ? d : 0) + a (64 x 8, tf32,
// registers) . b (128 x 8, tf32, shared memory)^T
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
#undef ACC8

__global__ void __launch_bounds__(NT, 1)
row_top2_wgmma(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
               const uint8_t* __restrict__ maskB, int NA, int NB, int nk, int cols_per_split,
               int* __restrict__ scratch, float* __restrict__ out_best,
               float* __restrict__ out_second, int* __restrict__ out_idx) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle pattern repeats every 1024 bytes: align the ring
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bar0 = sbase + BAR_OFFSET;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto split = [&](int s) { return bar0 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bar0 + 8 * (2 * STAGES + s); };
  int* last_flag = reinterpret_cast<int*>(smem + BAR_OFFSET + 8 * 3 * STAGES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nsplit = gridDim.y;
  const int row0 = blockIdx.x * BM;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(NB, c_begin + cols_per_split);
  const int n_tiles = (c_end - c_begin + BN - 1) / BN;
  const int n_iters = n_tiles * nk;  // stage fills: tiles x D chunks

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(split(s), N_SPLIT_THREADS);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    if (tid == 256) {
      // producer: one thread keeps the ring's TMA loads in flight
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), A_BYTES + B_BYTES);
        const int t = it / nk, kc = it - t * nk;
        const uint32_t st = sbase + s * STAGE_BYTES;
        tma_load_2d(st, &tmA, full(s), kc * BK, row0);
        tma_load_2d(st + A_BYTES, &tmB, full(s), kc * BK, c_begin + t * BN);
      }
    } else if (tid >= 288) {
      // splitters: B chunk -> hi (in place) and lo (second plane). The
      // split is elementwise, so both planes keep TMA's swizzled layout.
      const int t = tid - 288;
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        float4* b = reinterpret_cast<float4*>(st + A_BYTES);
        float4* lo = b + B_BYTES / 16;
        for (int e = t; e < B_BYTES / 16; e += N_SPLIT_THREADS) {
          const float4 v = b[e];
          const float4 h = make_float4(
              __uint_as_float(tf32_rna(v.x)), __uint_as_float(tf32_rna(v.y)),
              __uint_as_float(tf32_rna(v.z)), __uint_as_float(tf32_rna(v.w)));
          b[e] = h;
          lo[e] = make_float4(
              __uint_as_float(tf32_rna(v.x - h.x)), __uint_as_float(tf32_rna(v.y - h.y)),
              __uint_as_float(tf32_rna(v.z - h.z)), __uint_as_float(tf32_rna(v.w - h.w)));
        }
        if ((it + 1) % nk == 0) {
          // the tile's last chunk carries its column fills: the epilogue
          // takes fma(s, mul, add), which is s for a valid column, exactly
          // -1e9 for a masked one, and -inf past the split's end (-inf
          // never changes a state, and every split has a column in range)
          const int col0 = c_begin + (it / nk) * BN;
          float2* fill = reinterpret_cast<float2*>(st + A_BYTES + 2 * B_BYTES);
          for (int e = t; e < BN; e += N_SPLIT_THREADS) {
            const int j = col0 + e;
            fill[e] = j >= c_end ? make_float2(0.f, -INFINITY)
                      : maskB[j] ? make_float2(1.f, 0.f)
                                 : make_float2(0.f, kNeg);
          }
        }
        // make the generic-proxy writes visible to wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(split(s));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the block. In
  // the m64nNk8 layouts, lane l of warp w holds rows 16 w + l / 4 and
  // 16 w + l / 4 + 8; its A fragment is columns l % 4 and l % 4 + 4 of the
  // k-step, its accumulators columns 8 n + 2 (l % 4) + {0, 1}, n < 16.
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int rq = lane >> 2, cq = lane & 3;
  const int rloc = 64 * wg + 16 * warp + rq;  // and rloc + 8
  // byte offset of (row, col) in a 128B-swizzled chunk: row * 128 +
  // ((col / 4) ^ (row % 8)) * 16 + (col % 4) * 4; row % 8 == rq here
  const uint32_t a_row = rloc * 128 + cq * 4;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  float best[2] = {-INFINITY, -INFINITY}, second[2] = {-INFINITY, -INFINITY};
  int idx[2] = {kNoIdx, kNoIdx};

  int it = 0;  // stage fills consumed
  for (int t = 0; t < n_tiles; ++t) {
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      mbar_wait(full(s), ph);
      mbar_wait(split(s), ph);
      __syncwarp();  // wgmma's .sync.aligned forms need the warp converged
      const uint8_t* a = smem + s * STAGE_BYTES;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t o0 = a_row + (((2 * kk) ^ rq) << 4);
        const uint32_t o1 = a_row + (((2 * kk + 1) ^ rq) << 4);
        const float v[4] = {*reinterpret_cast<const float*>(a + o0),
                            *reinterpret_cast<const float*>(a + o0 + 1024),
                            *reinterpret_cast<const float*>(a + o1),
                            *reinterpret_cast<const float*>(a + o1 + 1024)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ahi[kk][q] = tf32_rna(v[q]);
          alo[kk][q] = tf32_rna(v[q] - __uint_as_float(ahi[kk][q]));
        }
      }
      const uint32_t bhi = sbase + s * STAGE_BYTES + A_BYTES, blo = bhi + B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k8_tf32(d, alo[kk], desc_sw128(bhi + 32 * kk), (kc | kk) != 0);
        wgmma_m64n128k8_tf32(d, ahi[kk], desc_sw128(blo + 32 * kk), 1);
        wgmma_m64n128k8_tf32(d, ahi[kk], desc_sw128(bhi + 32 * kk), 1);
      }
      wgmma_commit();
      // wait for all of them: the A fragments live in registers, which an
      // in-flight wgmma still reads (ptxas does not keep them alive)
      wgmma_wait_all();
      if (kc == nk - 1) break;  // the epilogue reads the last chunk's stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // the tile is complete: fold it into the row states, reading the column
    // fills from the stage of its last chunk before releasing that stage
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(d[i]);
    const int s = it % STAGES;
    ++it;
    const float2* fill = reinterpret_cast<const float2*>(smem + s * STAGE_BYTES + A_BYTES +
                                                         2 * B_BYTES);
    const int col0 = c_begin + t * BN + 2 * cq;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 f = fill[8 * n + 2 * cq + e];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          push(fmaf(d[4 * n + 2 * h + e], f.x, f.y), col0 + 8 * n + e, best[h], second[h],
               idx[h]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // the 4 lanes of a row merge; then either the final outputs (one split)
  // or this split's partial state, which the last block of the row merges
  float* pbest = reinterpret_cast<float*>(scratch);
  float* psecond = pbest + static_cast<size_t>(nsplit) * NA;
  int* pidx = reinterpret_cast<int*>(psecond + static_cast<size_t>(nsplit) * NA);
  int* tickets = pidx + static_cast<size_t>(nsplit) * NA;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[h], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[h], off);
      merge(best[h], second[h], idx[h], ob, os, oi);
    }
    // the reference knocks the argmax out to -1e9, so second is never below
    // it; max() commutes with the merge, so partial states clamp too
    second[h] = fmaxf(second[h], kNeg);
    const int row = row0 + rloc + 8 * h;
    if (cq == 0 && row < NA) {
      if (nsplit == 1) {
        out_best[row] = best[h];
        out_second[row] = second[h];
        out_idx[row] = idx[h];
      } else {
        const size_t o = static_cast<size_t>(blockIdx.y) * NA + row;
        pbest[o] = best[h];
        psecond[o] = second[h];
        pidx[o] = idx[h];
      }
    }
  }
  if (nsplit == 1) return;

  // the last of the row block's nsplit blocks to finish merges all splits
  // (fence, take a ticket, fence, read: CUDA's threadFenceReduction)
  __threadfence();
  asm volatile("bar.sync 1, 256;" ::: "memory");  // the 8 consumer warps
  if (tid == 0) *last_flag = atomicAdd(&tickets[blockIdx.x], 1) == nsplit - 1;
  asm volatile("bar.sync 1, 256;" ::: "memory");
  if (!*last_flag) return;
  __threadfence();
  if (tid < BM && row0 + tid < NA) {
    const int row = row0 + tid;
    float b = __ldcg(pbest + row), sc = __ldcg(psecond + row);
    int i = __ldcg(pidx + row);
    for (int sp = 1; sp < nsplit; ++sp) {
      const size_t o = static_cast<size_t>(sp) * NA + row;
      merge(b, sc, i, __ldcg(pbest + o), __ldcg(psecond + o), __ldcg(pidx + o));
    }
    out_best[row] = b;
    out_second[row] = sc;
    out_idx[row] = i;
  }
  if (tid == 0) tickets[blockIdx.x] = 0;  // ready for the next launch
}

int cols_per_split(int NB, int nsplit) {
  const int tiles = (NB + BN - 1) / BN;
  return ((tiles + nsplit - 1) / nsplit) * BN;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// rows x ld float32, row-major; boxes of BK floats x 128 rows, 128B swizzle,
// out-of-bounds elements read as zero
CUresult encode(EncodeTiledFn fn, CUtensorMap* map, const float* base, int rows, int ld) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kMaxDevices = 64;
bool smem_attr_set[kMaxDevices];

}  // namespace

extern "C" {

// Return codes of row_top2_launch besides 0 and a cudaError_t (> 0).
const int ROW_TOP2_NO_ENCODER = -1000000;  // cuTensorMapEncodeTiled not found
// -r for a CUresult r of cuTensorMapEncodeTiled

// Number of column splits for an (NA, NB) problem on a card with n_sm SMs:
// the fewest tiles per block that let one wave of at most n_sm blocks cover
// every (row block, column tile), never more splits than column tiles.
int row_top2_nsplit(int NA, int NB, int n_sm) {
  const int row_blocks = (NA + BM - 1) / BM;
  const int tiles = (NB + BN - 1) / BN;
  const long long total = static_cast<long long>(row_blocks) * tiles;
  const int per_block = static_cast<int>((total + n_sm - 1) / n_sm);
  int want = (tiles + per_block - 1) / per_block;
  if (want < 1) want = 1;
  const int cps = cols_per_split(NB, want);
  return (NB + cps - 1) / cps;  // splits that actually hold columns
}

// int32 words of scratch a launch with nsplit splits needs: the partial
// (best, second, idx) of every (split, row) and one ticket per row block.
// The caller zeroes it once; every launch leaves the tickets at zero.
long long row_top2_scratch_words(int NA, int nsplit) {
  return nsplit == 1 ? 0 : 3LL * nsplit * NA + (NA + BM - 1) / BM;
}

const char* row_top2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns 0 on success, a cudaError_t (> 0) for a
// refused launch, or a negative code for a TMA descriptor that could not be
// encoded. A and B are device pointers to row-major (NA, ld) and (NB, ld)
// float32 with a 16-byte-aligned base and ld % 4 == 0 (columns past the
// descriptors' length must be zero); maskB is one byte per column; scratch
// holds row_top2_scratch_words(NA, nsplit) words (unused for one split). The
// launch goes to `device` (the calling thread's current device is restored).
int row_top2_launch(const float* A, const float* B, const uint8_t* maskB, int NA, int NB, int ld,
                    int nsplit, int* scratch, float* best, float* second, int* idx, int device,
                    cudaStream_t stream) {
  if (NA < 1 || NB < 1 || ld < 1 || ld % 4 != 0 || nsplit < 1 ||
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ROW_TOP2_NO_ENCODER;
  CUtensorMap tmA, tmB;
  CUresult r = encode(fn, &tmA, A, NA, ld);
  if (r == CUDA_SUCCESS) r = encode(fn, &tmB, B, NB, ld);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  int caller_dev = device;
  cudaError_t err = cudaGetDevice(&caller_dev);
  const bool switched = err == cudaSuccess && caller_dev != device;
  if (switched) err = cudaSetDevice(device);
  if (err == cudaSuccess && (device >= kMaxDevices || !smem_attr_set[device])) {
    err = cudaFuncSetAttribute(row_top2_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err == cudaSuccess && device < kMaxDevices) smem_attr_set[device] = true;
  }
  if (err == cudaSuccess) {
    const dim3 grid((NA + BM - 1) / BM, nsplit);
    row_top2_wgmma<<<grid, NT, SMEM_BYTES, stream>>>(tmA, tmB, maskB, NA, NB, (ld + BK - 1) / BK,
                                                     cols_per_split(NB, nsplit), scratch, best,
                                                     second, idx);
    err = cudaGetLastError();
  }
  if (switched) cudaSetDevice(caller_dev);
  return static_cast<int>(err);
}

}  // extern "C"
