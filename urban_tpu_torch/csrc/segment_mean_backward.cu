// Gradient of the segment mean with respect to the edge embeddings, for
// Hopper (sm_90a). Built by urban_tpu_torch/ops/segment_ops.py with nvcc
// into a shared library with a plain C interface and called through ctypes
// from the backward of the SegmentMean autograd function.
//
// No TPU counterpart: the JAX package's Pallas segment-mean kernels
// (urban_tpu/ops/pallas/segment_ops.py) cannot be differentiated, and its
// trainer differentiates XLA's scatter or one-hot matmul instead. With g
// the gradient of the (B, N, D) mean and c the (B, N) counts of the
// forward,
//
//   dh[b, e, :] = keep[b, e] * (g[b, u_e, :] / (c[b, u_e] + 1e-6)
//                               + g[b, v_e, :] / (c[b, v_e] + 1e-6))
//
// where an endpoint outside [0, N) adds nothing and a masked edge gets a
// zero row.
//
// Design. A gather: one thread per (edge, column), one grid row per batch
// element, D a compile-time width so that the index arithmetic is shifts.
// Neighbouring threads read neighbouring columns of one node
// row of g and write neighbouring floats of dh, so both are coalesced; the
// endpoint pair, the mask byte and the two counts are shared by the D
// threads of an edge and come from L1. No atomics: the result is the same
// bits on every launch.
//
// What bounds it on this card: bytes. Per call it writes B * E * D * 4
// bytes and reads at most twice that of g (rows of g are reused by every
// edge of a node, from L2), plus 9 bytes of indices and mask per edge.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int D>
__global__ void __launch_bounds__(kThreads)
segment_mean_backward_kernel(const float* __restrict__ g,         // (B, N, D)
                             const float* __restrict__ counts,    // (B, N)
                             const int32_t* __restrict__ edges,   // (B, E, 2)
                             const uint8_t* __restrict__ mask,    // (B, E)
                             float* __restrict__ dh,              // (B, E, D)
                             int E, int N) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;   // e * D + c
  if (i >= E * D) return;
  const int e = i / D;
  const int c = i % D;
  const size_t be = (size_t)b * E + e;
  float acc = 0.f;
  if (mask[be] != 0) {
    const int u = edges[2 * be];
    const int v = edges[2 * be + 1];
    const float* gb = g + (size_t)b * N * D;
    const float* cb = counts + (size_t)b * N;
    if (u >= 0 && u < N) acc += gb[(size_t)u * D + c] / (cb[u] + 1e-6f);
    if (v >= 0 && v < N) acc += gb[(size_t)v * D + c] / (cb[v] + 1e-6f);
  }
  dh[be * D + c] = acc;
}

template <int D>
int launch(const void* g, const void* counts, const void* edges,
           const void* mask, void* dh, int B, int E, int N,
           cudaStream_t stream) {
  dim3 grid((unsigned)(((long long)E * D + kThreads - 1) / kThreads), B);
  segment_mean_backward_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(counts),
      static_cast<const int32_t*>(edges), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dh), E, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on a successful launch. Supported widths are
// D in {8, 16, 32, 64}; the Python wrapper checks shapes and types first.
// B is bounded by the grid's y limit and E * D by the int range.
extern "C" int segment_mean_backward_f32(const void* g, const void* counts,
                                         const void* edges, const void* mask,
                                         void* dh, int B, int E, int N, int D,
                                         void* stream) {
  if (B <= 0 || E <= 0) return 0;
  if (B > 65535 || (long long)E * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8>(g, counts, edges, mask, dh, B, E, N, s);
    case 16: return launch<16>(g, counts, edges, mask, dh, B, E, N, s);
    case 32: return launch<32>(g, counts, edges, mask, dh, B, E, N, s);
    case 64: return launch<64>(g, counts, edges, mask, dh, B, E, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
