// Gradient of the segment mean with respect to the edge embeddings, for
// Hopper (sm_90a). Built by urban_tpu_torch/ops/segment_ops.py with nvcc
// into a shared library with a plain C interface and called through ctypes
// from the backward of the SegmentMean autograd function.
//
// No TPU counterpart: the JAX package's Pallas segment-mean kernels
// (urban_tpu/ops/pallas/segment_ops.py) cannot be differentiated, and its
// trainer differentiates XLA's scatter or one-hot matmul instead. With g
// the gradient of the (B, N, D) mean and c the (B, N) counts of the
// forward, s[b, n, :] = g[b, n, :] / (c[b, n] + 1e-6) and
//
//   dh[b, e, :] = (keep_u ? s[b, u_e, :] : 0) + (keep_v ? s[b, v_e, :] : 0)
//
// where keep is "edge unmasked and endpoint inside [0, N)": a masked edge
// gets a zero row, an endpoint outside [0, N) adds nothing and a self-loop
// adds its node's row twice. Each quotient is one IEEE division and the
// sum one add, so the result has exactly the bits of the plain version
// (segment_mean_backward_ref), on every launch: no atomics, and nothing
// for the compiler to contract into an FMA.
//
// What bounds it on this card: bytes. Per batch element it must write
// E * D * 4 bytes of dh (two thirds of the total at the trainer's shape)
// and read the rows of g, the counts, the endpoints and the mask once. On
// an H100 it reaches 58-68% of that bound at kernel_bench's three shapes:
// the part of its time that grows with D runs at ~66% of the memory's
// peak rate, because the blocks sharing an SM stage at the same time and
// then stream at the same time, so reads and writes do not overlap there
// (PERF.md).
//
// Design. One block owns a (batch element, column tile) pair: the columns
// [c0, c0 + T) of every node row, T a multiple of 4 dividing D, chosen
// with the shared-memory bytes and the block size by backward_plan in
// segment_ops.py: 512 threads where two blocks share an SM, 1024 where a
// block is alone on its SM (kernel_bench's tile sweep on an H100: the
// large graph's one-block plan 20% faster with 1024 threads, the
// trainer's two-block plan 10% slower).
//   1. Stage: the block reads its tile of g[b] and the counts with float4
//      loads, several in flight per thread, divides each element once by
//      count + 1e-6 and keeps the scaled rows in shared memory (N * T * 4
//      bytes: 86,016 at the trainer's N = 1344, D = 16, so two blocks
//      share an SM and the whole batch is one wave). The division is done
//      once per (node, column), B * N * D in all, not once per use.
//   2. Stream: each thread owns 16 bytes (4 columns) of an edge's output
//      row. It reads the endpoint pair as one int2 and the mask byte once
//      for several edges, all loads issued before the first store, then
//      adds the two scaled float4s from shared memory and writes dh with a
//      16-byte streaming store (st.global.cs: dh is written once and not
//      read back by this kernel).
// Where no tile of 4 columns of N rows fits in shared memory (N above
// 14,528), or D has no divisor that is a multiple of 4, the plan has 0
// shared bytes and the same kernel takes its gather path: full rows, each
// thread reading its two rows of g and the two counts from device memory
// and dividing per use, each element's edges spread over enough blocks to
// give the card about two an SM (a block an element would leave a batch of
// 8 on 8 SMs).
//
// Widths: any D >= 1. A staged tile is a multiple of 4 columns dividing D
// (D itself runtime), so every D with such a divisor stages; the gather
// path has its own instantiations for D in {8, 16, 32, 64} and a
// runtime-width one (T = 0 below) for any other D, with float4 pieces
// where D % 4 == 0 and scalar loads and stores else (forced at D = 16 on
// 40,000 nodes, the runtime-width one took 10-18% longer: PERF.md).
//
// Staging goes through registers rather than TMA because every element
// has to pass through a division anyway; a bulk copy would add a shared
// memory round trip before it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStageUnroll = 4;   // float4 rows of g in flight per thread
constexpr int kEdgeUnroll = 4;    // edges in flight per thread

__device__ __forceinline__ float4 scale(float4 x, float c) {
  const float d = c + 1e-6f;
  return make_float4(x.x / d, x.y / d, x.z / d, x.w / d);
}

__device__ __forceinline__ float scale(float x, float c) {
  return x / (c + 1e-6f);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}

// The gather path at a runtime width: element b's (E, C) pieces of dh
// (V: float4 or float, C = D / (sizeof V / 4)), each (0 + s_u) + s_v from
// the two endpoints' rows of g scaled per use, as the templated gather;
// this block takes the chunks of kEdgeUnroll x kThreads pieces slice,
// slice + slices, ...
template <typename V, int kThreads>
__device__ __forceinline__ void gather_any(const float* g, const float* cb,
                                           const int2* eb, const uint8_t* mb,
                                           float* dh, int E, int N, int D,
                                           int slice, int slices) {
  const int C = D / (int)(sizeof(V) / sizeof(float));
  const V* gb = reinterpret_cast<const V*>(g);
  V* ob = reinterpret_cast<V*>(dh);
  const int total = E * C;
  for (int j0 = slice * kEdgeUnroll * kThreads + threadIdx.x; j0 < total;
       j0 += slices * kEdgeUnroll * kThreads) {
    int u[kEdgeUnroll], v[kEdgeUnroll];
#pragma unroll
    for (int k = 0; k < kEdgeUnroll; ++k) {
      const int j = j0 + k * kThreads;
      u[k] = -1;
      v[k] = -1;
      if (j < total) {
        const int2 uv = __ldg(eb + j / C);
        const bool keep = __ldg(mb + j / C) != 0;
        u[k] = (keep && uv.x >= 0 && uv.x < N) ? uv.x : -1;
        v[k] = (keep && uv.y >= 0 && uv.y < N) ? uv.y : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kEdgeUnroll; ++k) {
      const int j = j0 + k * kThreads;
      if (j >= total) continue;
      const int q = j % C;
      V su = zero<V>(), sv = zero<V>();
      if (u[k] >= 0) su = scale(__ldg(gb + (size_t)u[k] * C + q),
                                __ldg(cb + u[k]));
      if (v[k] >= 0) sv = scale(__ldg(gb + (size_t)v[k] * C + q),
                                __ldg(cb + v[k]));
      __stcs(ob + (size_t)(j / C) * C + q, add(su, sv));
    }
  }
}

// T: columns of the tile; kStaged: scaled rows in shared memory (else the
// gather path, T == D, or T == 0 for a width without its own
// instantiation, with `slices` blocks an element, each taking every
// slices-th chunk of its edges; 1 where staged); kThreads: 512 or 1024, at
// most 64 registers each
template <int T, bool kStaged, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
segment_mean_backward_kernel(const float* __restrict__ g,         // (B, N, D)
                             const float* __restrict__ counts,    // (B, N)
                             const int32_t* __restrict__ edges,   // (B, E, 2)
                             const uint8_t* __restrict__ mask,    // (B, E)
                             float* __restrict__ dh,              // (B, E, D)
                             int E, int N, int D, int slices) {
  if constexpr (T == 0) {   // the gather path at any width
    const size_t b = blockIdx.x / slices;
    const int slice = blockIdx.x % slices;
    const float* gb = g + b * N * D;
    const int2* eb = reinterpret_cast<const int2*>(edges) + b * E;
    float* ob = dh + b * E * D;
    if (D % 4 == 0) {
      gather_any<float4, kThreads>(gb, counts + b * N, eb, mask + b * E, ob,
                                   E, N, D, slice, slices);
    } else {
      gather_any<float, kThreads>(gb, counts + b * N, eb, mask + b * E, ob,
                                  E, N, D, slice, slices);
    }
  } else {
    constexpr int Q = T / 4;          // float4 columns of a tile
    extern __shared__ float4 rows[];  // (N, Q) scaled rows of the tile
    const int tiles = D / T;          // 1 on the gather path (T == D)
    const int b = blockIdx.x / (kStaged ? tiles : slices);
    const int c0 = kStaged ? (blockIdx.x % tiles) * T : 0;
    // the gather path's block takes every slices-th chunk of the edges
    const int first = kStaged ? 0 : (blockIdx.x % slices) * kEdgeUnroll *
                                        kThreads;
    const int stride = (kStaged ? 1 : slices) * kEdgeUnroll * kThreads;
    const int tid = threadIdx.x;
    const int D4 = D / 4;
    const float* cb = counts + (size_t)b * N;
    const float4* gb =
        reinterpret_cast<const float4*>(g + (size_t)b * N * D + c0);

    if (kStaged) {
      const int total = N * Q;
      for (int i0 = tid; i0 < total; i0 += kStageUnroll * kThreads) {
        float4 x[kStageUnroll];
        float c[kStageUnroll];
#pragma unroll
        for (int k = 0; k < kStageUnroll; ++k) {
          const int i = i0 + k * kThreads;
          if (i < total) {
            x[k] = __ldg(gb + (size_t)(i / Q) * D4 + i % Q);
            c[k] = __ldg(cb + i / Q);
          }
        }
#pragma unroll
        for (int k = 0; k < kStageUnroll; ++k) {
          const int i = i0 + k * kThreads;
          if (i < total) rows[i] = scale(x[k], c[k]);
        }
      }
      __syncthreads();
    }

    const int2* eb = reinterpret_cast<const int2*>(edges) + (size_t)b * E;
    const uint8_t* mb = mask + (size_t)b * E;
    float4* ob = reinterpret_cast<float4*>(dh + (size_t)b * E * D + c0);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int total = E * Q;
    for (int j0 = first + tid; j0 < total; j0 += stride) {
      int u[kEdgeUnroll], v[kEdgeUnroll];
#pragma unroll
      for (int k = 0; k < kEdgeUnroll; ++k) {
        const int j = j0 + k * kThreads;
        u[k] = -1;
        v[k] = -1;
        if (j < total) {
          const int2 uv = __ldg(eb + j / Q);
          const bool keep = __ldg(mb + j / Q) != 0;
          u[k] = (keep && uv.x >= 0 && uv.x < N) ? uv.x : -1;
          v[k] = (keep && uv.y >= 0 && uv.y < N) ? uv.y : -1;
        }
      }
#pragma unroll
      for (int k = 0; k < kEdgeUnroll; ++k) {
        const int j = j0 + k * kThreads;
        if (j >= total) continue;
        const int q = j % Q;
        float4 su = zero, sv = zero;
        if (kStaged) {
          if (u[k] >= 0) su = rows[u[k] * Q + q];
          if (v[k] >= 0) sv = rows[v[k] * Q + q];
        } else {
          if (u[k] >= 0) su = scale(__ldg(gb + (size_t)u[k] * D4 + q),
                                    __ldg(cb + u[k]));
          if (v[k] >= 0) sv = scale(__ldg(gb + (size_t)v[k] * D4 + q),
                                    __ldg(cb + v[k]));
        }
        __stcs(ob + (size_t)(j / Q) * D4 + q, add(su, sv));
      }
    }
  }
}

int optin_limit() {
  int device = 0;
  int limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return limit;
}

// A launch's arguments, as the C entry point received them.
struct Args {
  const void* g;
  const void* counts;
  const void* edges;
  const void* mask;
  void* dh;
  int B, E, N, D, tile, shared_bytes;
  cudaStream_t stream;
};

// Blocks an element of the gather path: about two blocks an SM in all,
// at most one a chunk of kEdgeUnroll x kThreads pieces (`pieces` a row).
int gather_slices(const Args& a, int pieces, int threads, int* slices) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long chunk = (long long)kEdgeUnroll * threads;
  const long long chunks = ((long long)a.E * pieces + chunk - 1) / chunk;
  long long s = (2LL * sms + a.B - 1) / a.B;
  if (s > chunks) s = chunks;
  *slices = s < 1 ? 1 : (int)s;
  return 0;
}

template <int T, bool kStaged, int kThreads>
int launch(const Args& a) {
  int slices = 1;
  if (kStaged) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_mean_backward_kernel<T, kStaged, kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared_bytes);
    if (err != cudaSuccess) return (int)err;
  } else {
    const int pieces = a.D % 4 == 0 ? a.D / 4 : a.D;
    const int rc = gather_slices(a, pieces, kThreads, &slices);
    if (rc != 0) return rc;
  }
  const long long blocks =
      (long long)a.B * (kStaged ? a.D / (T ? T : 1) : slices);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_mean_backward_kernel<T, kStaged, kThreads>
      <<<(unsigned)blocks, kThreads, a.shared_bytes, a.stream>>>(
          static_cast<const float*>(a.g),
          static_cast<const float*>(a.counts),
          static_cast<const int32_t*>(a.edges),
          static_cast<const uint8_t*>(a.mask), static_cast<float*>(a.dh),
          a.E, a.N, a.D, slices);
  return (int)cudaGetLastError();
}

// The launch for one block size: the gather path (no shared memory, tile
// == D; D's own instantiation or the runtime-width one) or a staged tile.
template <int kThreads>
int launch_plan(const Args& a) {
  if (a.shared_bytes == 0) {
    if (a.tile != a.D) return (int)cudaErrorInvalidValue;
    switch (a.D) {
      case 8: return launch<8, false, kThreads>(a);
      case 16: return launch<16, false, kThreads>(a);
      case 32: return launch<32, false, kThreads>(a);
      case 64: return launch<64, false, kThreads>(a);
      default: return launch<0, false, kThreads>(a);
    }
  }
  switch (a.tile) {
    case 4: return launch<4, true, kThreads>(a);
    case 8: return launch<8, true, kThreads>(a);
    case 16: return launch<16, true, kThreads>(a);
    case 32: return launch<32, true, kThreads>(a);
    case 64: return launch<64, true, kThreads>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a successful launch. Any width D >= 1.
// tile, shared_bytes and threads come from backward_plan in segment_ops.py:
// shared_bytes == N * tile * 4 stages the scaled rows (tile in {4, 8, 16,
// 32, 64}, dividing D), shared_bytes == 0 takes the gather path (tile ==
// D); threads is 512 or 1024. The Python wrapper checks shapes, types and
// alignment (16 bytes for g and dh where D % 4 == 0, 8 for edges) first.
extern "C" int segment_mean_backward_f32(const void* g, const void* counts,
                                         const void* edges, const void* mask,
                                         void* dh, int B, int E, int N, int D,
                                         int tile, int shared_bytes,
                                         int threads, void* stream) {
  if (B <= 0 || E <= 0) return 0;
  if (N <= 0 || tile <= 0 || D % tile != 0 ||
      (long long)B * (D / tile) > 0x7fffffffLL ||
      (long long)E * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (shared_bytes != 0 &&
      ((long long)shared_bytes != (long long)N * tile * 4 ||
       shared_bytes > optin_limit()))
    return (int)cudaErrorInvalidValue;
  const Args a{g, counts, edges, mask, dh, B, E, N, D, tile, shared_bytes,
               static_cast<cudaStream_t>(stream)};
  switch (threads) {
    case 512: return launch_plan<512>(a);
    case 1024: return launch_plan<1024>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
