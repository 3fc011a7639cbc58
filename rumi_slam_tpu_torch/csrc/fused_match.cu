// Fused radius-gated Hamming matcher for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rumi_slam_tpu/ops/pallas_matcher.py::_kernel
// (wrapper fused_match).  For every query feature f and map point p it forms
// the Hamming distance of their 256-bit descriptors, counts it only if
// |uv_q[f] - uv_p[p]|^2 <= r2, and keeps a running best, second best and
// argbest per query; no [F, P] array is ever formed.  The caller's ratio and
// distance gates are applied on the way out.
//
// What bounds it: integer ALU work.  At F = 2048 queries and P = 16384 map
// points a frame is about 33.5 M (query, point) pairs: one float gate each,
// plus 8 XOR + popcount for the pairs inside the gate.  The inputs are about
// 600 KB (descriptors 32 B and uv 8 B per row) and stay in L2.  The TPU kernel
// had to use an f32 matmul on +-1 vectors (Mosaic would not take int8); here
// the distance is __popc on the packed words and the gate runs first, so only
// points inside the window pay for the popcounts.
//
// Design: one thread owns one query row; its 8 descriptor words, its uv and
// its running (best, second, idx) stay in registers.  A block of 128 queries
// streams tiles of points (descriptor words and uv) through shared memory,
// where every thread reads the same element (a broadcast).  Points are
// visited in increasing index with strict '<', which reproduces the Pallas
// kernel's tie order (lowest index wins) and its "fewer than two candidates"
// semantics (best/second start at 1e9, idx at -1).  Validity is positional,
// as in the Pallas wrapper: invalid queries sit at (-1e9, -1e9), invalid
// points at (1e9, 1e9), so the gate rejects them.  Ragged tails are masked,
// so F and P need no particular multiple.
//
// Known limits, left for later work: F = 2048 gives only 16 blocks on 132
// SMs; splitting P across blocks with a merge pass, or int8 mma on +-1
// vectors, would fill the card.
//
// The gate is computed with explicitly rounded __fmul_rn/__fadd_rn (and the
// file is built with -fmad=false) so that nvcc does not contract
// du*du + dv*dv into an FMA: a point exactly on the radius must fall on the
// same side as in the plain PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQueriesPerBlock = 128;
constexpr int kPointsPerTile = 256;
constexpr float kBig = 1e9f;

__global__ void __launch_bounds__(kQueriesPerBlock)
fused_match_kernel(const uint4* __restrict__ desc_q,      // [F, 2] x uint4 (8 words)
                   const uint4* __restrict__ desc_p,      // [P, 2] x uint4
                   const float2* __restrict__ uv_q,       // [F]
                   const float2* __restrict__ uv_p,       // [P]
                   const uint8_t* __restrict__ valid_q,   // [F]
                   const uint8_t* __restrict__ valid_p,   // [P]
                   int n_q, int n_p, float r2, float max_dist, float ratio,
                   int32_t* __restrict__ out_idx,         // [F]
                   float* __restrict__ out_dist) {        // [F]
  __shared__ uint4 s_desc[kPointsPerTile][2];
  __shared__ float2 s_uv[kPointsPerTile];

  const int f = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const bool active = f < n_q;

  uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;
  float qx = -kBig, qy = -kBig;
  bool q_valid = false;
  if (active) {
    q0 = desc_q[2 * f];
    q1 = desc_q[2 * f + 1];
    q_valid = valid_q[f] != 0;
    if (q_valid) {
      const float2 uv = uv_q[f];
      qx = uv.x;
      qy = uv.y;
    }
  }

  float best = kBig, second = kBig;
  int32_t best_idx = -1;

  for (int p0 = 0; p0 < n_p; p0 += kPointsPerTile) {
    for (int i = threadIdx.x; i < kPointsPerTile; i += kQueriesPerBlock) {
      const int p = p0 + i;
      float2 uv = make_float2(kBig, kBig);
      if (p < n_p) {
        s_desc[i][0] = desc_p[2 * p];
        s_desc[i][1] = desc_p[2 * p + 1];
        if (valid_p[p] != 0) uv = uv_p[p];
      }
      s_uv[i] = uv;
    }
    __syncthreads();

    const int n_tile = min(kPointsPerTile, n_p - p0);
    if (active) {
      for (int i = 0; i < n_tile; ++i) {
        const float2 uv = s_uv[i];
        const float du = __fsub_rn(qx, uv.x);
        const float dv = __fsub_rn(qy, uv.y);
        const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
        if (d2 <= r2) {
          const uint4 a = s_desc[i][0];
          const uint4 b = s_desc[i][1];
          const int h = __popc(q0.x ^ a.x) + __popc(q0.y ^ a.y) +
                        __popc(q0.z ^ a.z) + __popc(q0.w ^ a.w) +
                        __popc(q1.x ^ b.x) + __popc(q1.y ^ b.y) +
                        __popc(q1.z ^ b.z) + __popc(q1.w ^ b.w);
          const float d = static_cast<float>(h);
          if (d < best) {
            second = best;
            best = d;
            best_idx = p0 + i;
          } else if (d < second) {
            second = d;
          }
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    const bool ok = q_valid && best_idx >= 0 && best <= max_dist &&
                    best < __fmul_rn(ratio, second);
    out_idx[f] = ok ? best_idx : -1;
    out_dist[f] = ok ? best : __int_as_float(0x7f800000);  // +inf
  }
}

}  // namespace

extern "C" {

// Launches the matcher on `stream` and returns cudaGetLastError() (0 = ok).
// Descriptor pointers must be 16-byte aligned and uv pointers 8-byte aligned;
// the Python wrapper checks this with the shapes, dtypes and devices.
int fused_match_launch(const void* desc_q, const void* desc_p,
                       const void* uv_q, const void* uv_p,
                       const void* valid_q, const void* valid_p,
                       int n_q, int n_p, float r2, float max_dist, float ratio,
                       void* out_idx, void* out_dist, void* stream) {
  const int blocks = (n_q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  fused_match_kernel<<<blocks, kQueriesPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc_q), static_cast<const uint4*>(desc_p),
      static_cast<const float2*>(uv_q), static_cast<const float2*>(uv_p),
      static_cast<const uint8_t*>(valid_q), static_cast<const uint8_t*>(valid_p),
      n_q, n_p, r2, max_dist, ratio,
      static_cast<int32_t*>(out_idx), static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
