// Fused row-wise top-2 similarity search for Hopper (sm_90a).
//
// Replaces the TPU kernel hfnet_slam_tpu/ops/pallas_match.py:row_top2 (body
// _match_kernel). For every row a of A it computes s = A[a] . B[j] in full
// float32 over all columns j, with masked columns set to -1e9, and returns
//   best[a]   = max_j s,
//   idx[a]    = the argmax, LOWEST index on exact ties,
//   second[a] = the row max with only the argmax column knocked out to -1e9
//               (so an exact tie gives second == best, and NB == 1 or an
//               all-masked B gives second == -1e9).
// The (NA, NB) similarity matrix never reaches device memory.
//
// What bounds it on an H100: one call at NA = NB = 1024, D = 256 is
// 2 * 1024 * 1024 * 256 = 0.537 GFLOP. The dot products run as float32 FMAs
// on the CUDA cores (not TF32, which flips near-tie argmaxes), 67 TFLOP/s
// at the full power limit: ~8.0 us. Its inputs are 2.1 MB, 0.63 us at
// 3.35 TB/s. So it is bound by operations, not bytes; at NB = 8192 (loop
// association) the bound is ~64 us.
//
// Design. The TPU kernel keeps all of B resident in VMEM; B (up to
// 8192 x 256 f32 = 8 MB) does not fit in the 227 KB of shared memory, and
// the TPU's sequential grid has no counterpart, so:
//   * a block owns TA = 64 rows of A and one split of B's columns, and
//     streams B in TB = 64-column tiles through shared memory, TK = 32 of
//     the D axis at a time (17 KB of static shared memory);
//   * 256 threads compute a 64 x 64 tile of s, 4 x 4 values each, with
//     float32 FMAs accumulated in registers;
//   * each thread keeps a running (best, idx, second) for its 4 rows; the
//     16 threads that share a row merge theirs with warp shuffles, and the
//     block writes one partial state per (row, split);
//   * the splits exist only to fill the 132 SMs when NA is small (1024 rows
//     are just 16 row blocks); a second kernel merges the partial states of
//     each row in split order.
// Merge rule: the winner is decided by (best, -idx); second becomes the max
// of the loser's best and both seconds. Any NA, NB >= 1 and D >= 1 are
// accepted; ragged edges are masked (rows and columns past the end never
// enter a state, the D tail is zero-padded).
//
// wgmma, TMA and 3xTF32 are later work; this version is the simple, exact
// one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TA = 64;        // A rows per block
constexpr int TB = 64;        // B columns per tile
constexpr int TK = 32;        // D slice staged per step
constexpr int NT = 256;       // threads per block: 16 x 16, 4 x 4 outputs each
constexpr float kNeg = -1e9f;
constexpr int kNoIdx = 0x7fffffff;

__device__ __forceinline__ void push(float v, int j, float& best, float& second, int& idx) {
  if (v > best || (v == best && j < idx)) {
    second = best;  // the old best is the max of the old state
    best = v;
    idx = j;
  } else {
    second = fmaxf(second, v);
  }
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

__global__ void __launch_bounds__(NT)
row_top2_partial(const float* __restrict__ A, const float* __restrict__ B,
                 const uint8_t* __restrict__ maskB, int NA, int NB, int D,
                 int cols_per_split, float* __restrict__ pbest,
                 float* __restrict__ psecond, int* __restrict__ pidx) {
  __shared__ float As[TK][TA + 1];
  __shared__ float Bs[TK][TB + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int a0 = blockIdx.x * TA;
  const int split = blockIdx.y;
  const int c_begin = split * cols_per_split;
  const int c_end = min(NB, c_begin + cols_per_split);

  float best[4], second[4];
  int idx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -INFINITY;
    second[i] = -INFINITY;
    idx[i] = kNoIdx;
  }

  for (int b0 = c_begin; b0 < c_end; b0 += TB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < D; k0 += TK) {
      // stage A[a0:a0+TA, k0:k0+TK] and B[b0:b0+TB, k0:k0+TK], transposed
      // so the inner loop reads rows/columns at a fixed k; consecutive
      // threads load consecutive k of one row (coalesced)
#pragma unroll
      for (int l = 0; l < (TA * TK) / NT; ++l) {
        const int e = tid + l * NT;
        const int r = e / TK, kk = e % TK;
        const int row = a0 + r, k = k0 + kk;
        As[kk][r] = (row < NA && k < D) ? A[(size_t)row * D + k] : 0.f;
      }
#pragma unroll
      for (int l = 0; l < (TB * TK) / NT; ++l) {
        const int e = tid + l * NT;
        const int r = e / TK, kk = e % TK;
        const int col = b0 + r, k = k0 + kk;
        Bs[kk][r] = (col < c_end && k < D) ? B[(size_t)col * D + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = b0 + tx + 16 * c;
      if (j < c_end) {
        const bool valid = maskB[j] != 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          push(valid ? acc[i][c] : kNeg, j, best[i], second[i], idx[i]);
      }
    }
  }

  // the 16 threads of a row group are lanes [0,16) or [16,32) of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[i], off);
      merge(best[i], second[i], idx[i], ob, os, oi);
    }
    const int row = a0 + ty + 16 * i;
    if (tx == 0 && row < NA) {
      const size_t o = (size_t)split * NA + row;
      pbest[o] = best[i];
      psecond[o] = second[i];
      pidx[o] = idx[i];
    }
  }
}

__global__ void row_top2_merge(const float* __restrict__ pbest,
                               const float* __restrict__ psecond,
                               const int* __restrict__ pidx, int NA, int nsplit,
                               float* __restrict__ best_out,
                               float* __restrict__ second_out,
                               int* __restrict__ idx_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= NA) return;
  float best = pbest[row], second = psecond[row];
  int idx = pidx[row];
  for (int s = 1; s < nsplit; ++s) {
    const size_t o = (size_t)s * NA + row;
    merge(best, second, idx, pbest[o], psecond[o], pidx[o]);
  }
  best_out[row] = best;
  // the reference knocks the argmax out to -1e9, so second is never below it
  second_out[row] = fmaxf(second, kNeg);
  idx_out[row] = idx;
}

int cols_per_split(int NB, int nsplit) {
  const int tiles = (NB + TB - 1) / TB;
  return ((tiles + nsplit - 1) / nsplit) * TB;
}

}  // namespace

extern "C" {

// Number of column splits for an (NA, NB) problem on a card with n_sm SMs:
// enough blocks for two per SM, never more splits than B tiles. The caller
// sizes the partial-state scratch as nsplit * NA.
int row_top2_nsplit(int NA, int NB, int n_sm) {
  const int row_blocks = (NA + TA - 1) / TA;
  const int tiles = (NB + TB - 1) / TB;
  int want = (2 * n_sm + row_blocks - 1) / row_blocks;
  if (want < 1) want = 1;
  if (want > tiles) want = tiles;
  const int cps = cols_per_split(NB, want);
  return (NB + cps - 1) / cps;  // splits that actually hold columns
}

// Launches both kernels on `stream`; returns the cudaError_t of the launches
// (0 on success). Pointers are device pointers; maskB is one byte per column.
int row_top2_launch(const float* A, const float* B, const uint8_t* maskB,
                    int NA, int NB, int D, int nsplit,
                    float* scratch_best, float* scratch_second, int* scratch_idx,
                    float* best, float* second, int* idx, cudaStream_t stream) {
  if (NA < 1 || NB < 1 || D < 1 || nsplit < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((NA + TA - 1) / TA, nsplit);
  row_top2_partial<<<grid, NT, 0, stream>>>(A, B, maskB, NA, NB, D,
                                            cols_per_split(NB, nsplit),
                                            scratch_best, scratch_second, scratch_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_top2_merge<<<(NA + 255) / 256, 256, 0, stream>>>(
      scratch_best, scratch_second, scratch_idx, NA, nsplit, best, second, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
