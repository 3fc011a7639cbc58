// Fused Hamming matcher for Hopper (sm_90a): running best / second best /
// argbest per query over a set of points, no [F, P] array ever formed.
//
// Replaces the Pallas TPU kernel rumi_slam_tpu/ops/pallas_matcher.py::_kernel
// (wrapper fused_match, with the gates the wrapper applies on the way out).
// Two instantiations of one template:
//
//   gated     (fused_match)  a (query, point) pair counts only if
//             |uv_q - uv_p|^2 <= r2: tracking against the projected map.
//   gate-off  (match_bank)   every (valid query, valid point) pair counts:
//             the contract of ops/matcher.py::match_chunked, relocalisation
//             against the bank of every stored observation.
//
// Both keep the TPU kernel's order: ties go to the lowest point index, best
// and second start at "none" (1e9 on the way out) and idx at -1, and a match
// is kept only if the query is valid, best <= max_dist and
// best < ratio * second.
//
// What bounds each mode on this card.  Both are operation bound; the inputs
// (32 B of descriptor, 8 B of uv and 1 B of validity a row) are under 1 MB in
// the gated mode and 8.4 MB for a 262144-row bank, stay in the 50 MB L2 and
// cost microseconds to read once.
//   gated:    F x P pairs x 6 fp32 lane instructions (2 sub, 2 mul, 1 add,
//             1 compare; no FMA, see below) at 128 lanes a clock an SM.  About
//             0.2% of pairs pass a 15 px gate in a 640x480 image, so the
//             popcounts add nothing.  F = 2048 x P = 16384 all valid is about
//             6 us of instructions; with the usual few thousand valid points
//             the launches themselves are the larger part.
//   gate-off: valid pairs x 8 popcounts at 16 a clock an SM: 1024 x 262144
//             all valid is about 0.46 ms.  That is the bound of this design,
//             not of the card: the TPU kernel took the distance from a matrix
//             product of +-1 vectors, and the same product in int8 (or b1) on
//             the tensor cores is bounded at about 0.07 ms.  Left for later.
//
// Design.
//   * Grid (query tiles, point splits).  A block is 128 threads, one query
//     each: its 8 descriptor words, its uv and its running (best, second,
//     idx) stay in registers.  A split is a contiguous run of 256-point
//     tiles; the wrapper sizes the splits so that the grid has several blocks
//     for every SM at F = 1024 as at F = 2048.
//   * A tile is staged in shared memory (descriptors, and uv or validity),
//     where all threads read the same element (a broadcast).  While it is
//     loaded the block votes once (__syncthreads_or) whether any of its
//     points is valid, and skips the tile if none is: invalid rows are most
//     of a map and of an observation bank, and they can never match.
//   * Gated inner loop: four points a step, two points' uv per 16-byte shared
//     load, four independent gates in flight; the popcount path is entered
//     only if one of the four passed, and then handles them in index order.
//     An invalid point's uv is staged as NaN, which fails the gate at any
//     radius.
//   * Gate-off inner loop: a block-uniform validity test per point, then
//     8 XOR + __popc and a branch-free top-2 update.
//   * Each block writes one packed partial (best | second << 16, idx) per
//     query to scratch [S, F] allocated by the wrapper.  A second small
//     kernel on the same stream merges the partials of a query in increasing
//     split order with a strict '<' and
//     second = min(second_a, second_b, max(best_a, best_b)), the rule of the
//     TPU kernel's running update, so the lowest index wins a tie whatever
//     order the blocks ran in.  No atomics; the result is a function of the
//     inputs alone.  Distances are integers <= 256 throughout and become
//     float32 only in the merge.
//   * The gate is computed with explicitly rounded __fsub_rn / __fmul_rn /
//     __fadd_rn (and the file is built with -fmad=false) so that nvcc does
//     not contract du*du + dv*dv into an FMA: a point exactly on the radius
//     must fall on the same side as in the plain PyTorch version.
//   * wgmma, TMA and clusters are not used: the gated mode is a sparse
//     integer reduction whose inputs fit in L2, and shared memory is 10 KB a
//     block.
//
// Limits that remain: splits are contiguous, so when the valid rows are
// bunched at the front of the points (a young map, a bank with few
// keyframes) only the blocks of those splits have work; a warp runs the
// popcount path whenever one of its 32 queries passes a gate; one query per
// thread reads every staged point once per thread (two queries a thread would
// halve the shared-memory reads).  Measured on an H100 (700 W) at F = 1024 and
// 2048 x P = 16384 with 2048 valid points: partial kernel 10 us, merge 4 us,
// against a bound under 1 us; what is left is two launches, a block's serial
// walk of its one 256-point tile with four warps on its SM and nothing to
// hide the shared-memory latency behind, and the merge's 64 partials a query
// read eight at a time.  Gate-off with all 262144 rows valid: 0.59 ms, which
// is 78% of the popcount pipe's bound (0.46 ms) and about 12% of the card's
// (0.07 ms on the tensor cores).
//
// QUERIES_PER_BLOCK and POINTS_PER_TILE come from the build command alone
// (the Python wrapper plans the grid with the same two numbers).

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(QUERIES_PER_BLOCK) || !defined(POINTS_PER_TILE)
#error "build with -DQUERIES_PER_BLOCK=... -DPOINTS_PER_TILE=... (ops/fused_matcher.py)"
#endif

namespace {

constexpr int kQueriesPerBlock = QUERIES_PER_BLOCK;
constexpr int kPointsPerTile = POINTS_PER_TILE;
constexpr int kNone = 0x7fff;     // "no candidate": above any Hamming distance
constexpr float kBig = 1e9f;      // what kNone becomes on the way out

static_assert(kPointsPerTile % 4 == 0, "the gated loop takes four points a step");

__device__ __forceinline__ int hamming(const uint4& q0, const uint4& q1,
                                       const uint4& a, const uint4& b) {
  return __popc(q0.x ^ a.x) + __popc(q0.y ^ a.y) + __popc(q0.z ^ a.z) +
         __popc(q0.w ^ a.w) + __popc(q1.x ^ b.x) + __popc(q1.y ^ b.y) +
         __popc(q1.z ^ b.z) + __popc(q1.w ^ b.w);
}

__device__ __forceinline__ bool in_gate(float qx, float qy, float px, float py, float r2) {
  const float du = __fsub_rn(qx, px);
  const float dv = __fsub_rn(qy, py);
  return __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2;   // false for NaN
}

// Top-2 of one split of the points for every query of one query tile.
template <bool kGated>
__global__ void __launch_bounds__(kQueriesPerBlock)
match_partial_kernel(const uint4* __restrict__ desc_q,      // [F, 2] x uint4 (8 words)
                     const uint4* __restrict__ desc_p,      // [P, 2] x uint4
                     const float2* __restrict__ uv_q,       // [F]   (gated only)
                     const float2* __restrict__ uv_p,       // [P]   (gated only)
                     const uint8_t* __restrict__ valid_q,   // [F]
                     const uint8_t* __restrict__ valid_p,   // [P]
                     int n_q, int n_p, int tiles_per_split, float r2,
                     int2* __restrict__ partial) {          // [S, F]
  __shared__ uint4 s_desc[kPointsPerTile][2];
  __shared__ float4 s_uv[kGated ? kPointsPerTile / 2 : 1];     // two points each
  __shared__ uint8_t s_valid[kGated ? 1 : kPointsPerTile];

  const int f = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const bool in_range = f < n_q;
  const bool active = in_range && valid_q[f] != 0;

  uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;
  float qx = 0.f, qy = 0.f;
  if (active) {
    q0 = desc_q[2 * f];
    q1 = desc_q[2 * f + 1];
    if (kGated) {
      const float2 uv = uv_q[f];
      qx = uv.x;
      qy = uv.y;
    }
  }

  int best = kNone, second = kNone, best_idx = -1;

  const int p_begin = blockIdx.y * tiles_per_split * kPointsPerTile;
  const int p_end = min(n_p, p_begin + tiles_per_split * kPointsPerTile);

  for (int p0 = p_begin; p0 < p_end; p0 += kPointsPerTile) {
    int any_valid = 0;
    for (int i = threadIdx.x; i < kPointsPerTile; i += kQueriesPerBlock) {
      const int p = p0 + i;
      const bool v = p < p_end && valid_p[p] != 0;
      if (v) {
        s_desc[i][0] = desc_p[2 * p];
        s_desc[i][1] = desc_p[2 * p + 1];
      }
      if (kGated) {
        const float nan = __int_as_float(0x7fc00000);
        reinterpret_cast<float2*>(s_uv)[i] = v ? uv_p[p] : make_float2(nan, nan);
      } else {
        s_valid[i] = v;
      }
      any_valid |= v;
    }
    // one vote, which is also the barrier after the stores above; a tile
    // with no valid point is read by nobody, so the next load may follow
    if (!__syncthreads_or(any_valid)) continue;

    if (active) {
      if (kGated) {
#pragma unroll 2
        for (int i = 0; i < kPointsPerTile; i += 4) {
          const float4 a = s_uv[i / 2];
          const float4 b = s_uv[i / 2 + 1];
          const bool m0 = in_gate(qx, qy, a.x, a.y, r2);
          const bool m1 = in_gate(qx, qy, a.z, a.w, r2);
          const bool m2 = in_gate(qx, qy, b.x, b.y, r2);
          const bool m3 = in_gate(qx, qy, b.z, b.w, r2);
          if (m0 | m1 | m2 | m3) {
            const bool m[4] = {m0, m1, m2, m3};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (m[j]) {
                const int h = hamming(q0, q1, s_desc[i + j][0], s_desc[i + j][1]);
                if (h < best) {
                  second = best;
                  best = h;
                  best_idx = p0 + i + j;
                } else if (h < second) {
                  second = h;
                }
              }
            }
          }
        }
      } else {
        const int n_tile = min(kPointsPerTile, p_end - p0);
#pragma unroll 4
        for (int i = 0; i < n_tile; ++i) {
          if (!s_valid[i]) continue;            // the same for every thread
          const int h = hamming(q0, q1, s_desc[i][0], s_desc[i][1]);
          const bool lt = h < best;
          second = lt ? best : min(second, h);
          best_idx = lt ? p0 + i : best_idx;
          best = min(best, h);
        }
      }
    }
    __syncthreads();
  }

  if (in_range) {
    partial[static_cast<size_t>(blockIdx.y) * n_q + f] =
        make_int2(best | (second << 16), best_idx);
  }
}

// Merges the partials of each query in increasing split order and applies
// the caller's gates.
__global__ void __launch_bounds__(kQueriesPerBlock)
match_merge_kernel(const int2* __restrict__ partial,        // [S, F]
                   const uint8_t* __restrict__ valid_q,     // [F]
                   int n_q, int n_splits, float max_dist, float ratio,
                   int32_t* __restrict__ out_idx,           // [F]
                   float* __restrict__ out_dist) {          // [F]
  const int f = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  if (f >= n_q) return;
  int best = kNone, second = kNone, best_idx = -1;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const int2 p = partial[static_cast<size_t>(s) * n_q + f];
    const int p_best = p.x & 0xffff;
    const int p_second = p.x >> 16;
    second = min(min(second, p_second), max(best, p_best));
    if (p_best < best) {
      best = p_best;
      best_idx = p.y;
    }
  }
  const float best_f = best == kNone ? kBig : static_cast<float>(best);
  const float second_f = second == kNone ? kBig : static_cast<float>(second);
  const bool ok = valid_q[f] != 0 && best_idx >= 0 && best_f <= max_dist &&
                  best_f < __fmul_rn(ratio, second_f);
  out_idx[f] = ok ? best_idx : -1;
  out_dist[f] = ok ? best_f : __int_as_float(0x7f800000);  // +inf
}

}  // namespace

extern "C" {

// Launches the partial pass over a grid of (query tiles, n_splits) and the
// merge pass on `stream`, and returns cudaGetLastError() (0 = ok).  `gated`
// selects the instantiation; uv_q and uv_p are read only when it is set.
// `partial` is scratch of n_splits * n_q * 8 bytes.  n_splits *
// tiles_per_split tiles must cover n_p.  Descriptor pointers must be 16-byte
// aligned, uv and partial pointers 8-byte aligned; the Python wrapper checks
// this with the shapes, dtypes and devices.
int fused_match_launch(const void* desc_q, const void* desc_p,
                       const void* uv_q, const void* uv_p,
                       const void* valid_q, const void* valid_p,
                       int n_q, int n_p, int gated, int n_splits, int tiles_per_split,
                       float r2, float max_dist, float ratio,
                       void* partial, void* out_idx, void* out_dist, void* stream) {
  const int q_tiles = (n_q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const dim3 grid(q_tiles, n_splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dq = static_cast<const uint4*>(desc_q);
  const auto* dp = static_cast<const uint4*>(desc_p);
  const auto* uq = static_cast<const float2*>(uv_q);
  const auto* up = static_cast<const float2*>(uv_p);
  const auto* vq = static_cast<const uint8_t*>(valid_q);
  const auto* vp = static_cast<const uint8_t*>(valid_p);
  auto* part = static_cast<int2*>(partial);
  if (gated) {
    match_partial_kernel<true><<<grid, kQueriesPerBlock, 0, s>>>(
        dq, dp, uq, up, vq, vp, n_q, n_p, tiles_per_split, r2, part);
  } else {
    match_partial_kernel<false><<<grid, kQueriesPerBlock, 0, s>>>(
        dq, dp, uq, up, vq, vp, n_q, n_p, tiles_per_split, r2, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_merge_kernel<<<q_tiles, kQueriesPerBlock, 0, s>>>(
      part, vq, n_q, n_splits, max_dist, ratio,
      static_cast<int32_t*>(out_idx), static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
