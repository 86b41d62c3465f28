// Segment mean of edge embeddings onto their endpoint nodes by per-edge
// accumulation, for Hopper (sm_90a). Built by
// urban_tpu_torch/ops/segment_ops.py with nvcc into a shared library with a
// plain C interface and called through ctypes. The training forward runs
// it (inside the SegmentMean autograd function); it also returns the
// per-node counts, which the backward kernel (segment_mean_backward.cu)
// reads.
//
// Replaces the TPU kernel urban_tpu/ops/pallas/segment_ops.py:
// segment_mean_pallas (_segment_mean_kernel). For batch b and node n
//
//   count[b, n] = #{unmasked e : u_e == n} + #{unmasked e : v_e == n}
//   out[b, n, :] = (sum_{unmasked e, u_e == n} h[b, e, :]
//                   + sum_{unmasked e, v_e == n} h[b, e, :]) / (count + 1e-6)
//
// A self-loop counts twice; masked edges add to neither the sum nor the
// count; an endpoint index outside [0, N) adds nothing.
//
// Design. The TPU kernel walked each batch element's edges serially and
// added each row into a VMEM table, with a sink row for masked edges. Here
// one block owns (batch element b, a slice of DC columns) and keeps the
// slice's (N x DC) f32 sums and the N counts in dynamic shared memory.
// Warp 0 walks the edges in edge order: lanes 0-15 add the edge's row to
// its u endpoint and lanes 16-31 to its v endpoint, lane c & 15 owning
// column c, both in the same instruction (a self-loop's two adds go to
// the u half as one add of 2x). Each (node, column) sum is thus taken by
// one lane in edge order, with no float atomics: repeated launches give
// identical bits. The other three warps stage the next chunk of edges
// meanwhile (double buffer): endpoints, with masked and out-of-range ones
// rewritten to -1, the chunk's DC-wide slice of h, and the counts, added
// with integer shared-memory atomics (exact in any order). DC is the
// widest power of two <= 16 dividing D whose table fits in a block's
// shared memory; where not even DC = 1 fits, segment_mean_edge_columns
// returns -1 and the wrapper raises.
//
// What bounds it on this card: the walk, a serial chain of one
// shared-memory read-modify-write per edge (the next edge may hit the
// same row), about E x (shared-memory latency + add) per block; the
// staging and the bytes (E * (9 + 4 * D) read, N * (4 * D + 4) written per
// batch element) hide behind it. At the trainer's shape (N = 1344,
// D = 16, DC = 16) a block holds 109 KB, two fit on an SM, and B = 256
// batch elements take one wave of the 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // warp 0 walks, warps 1-3 stage
constexpr int kChunk = 128;     // edges per staged chunk
constexpr int kMaxCols = 16;    // one half-warp of column lanes

size_t shared_bytes(int N, int dc) {
  return (size_t)2 * kChunk * dc * sizeof(float)     // h slices, 2 buffers
         + (size_t)N * dc * sizeof(float)            // sums
         + (size_t)N * sizeof(int)                   // counts
         + (size_t)2 * 2 * kChunk * sizeof(int);     // endpoints, 2 buffers
}

// Stage edges [e0, e0 + ne) into one buffer with threads t0, t0 + stride,
// ...: endpoints (-1 where masked or out of range), the h slice, and the
// counts.
template <int DC>
__device__ __forceinline__ void stage(const float* __restrict__ hb,
                                      const int32_t* __restrict__ eb,
                                      const uint8_t* __restrict__ mb,
                                      int e0, int ne, int N, int D, bool vec,
                                      int* su, int* sv, float* sh, int* cnt,
                                      int t0, int stride) {
  for (int i = t0; i < ne; i += stride) {
    const bool keep = mb[e0 + i] != 0;
    const int u = eb[2 * (e0 + i)];
    const int v = eb[2 * (e0 + i) + 1];
    const int su_i = (keep && u >= 0 && u < N) ? u : -1;
    const int sv_i = (keep && v >= 0 && v < N) ? v : -1;
    su[i] = su_i;
    sv[i] = sv_i;
    if (su_i >= 0) atomicAdd(&cnt[su_i], 1);
    if (sv_i >= 0) atomicAdd(&cnt[sv_i], 1);
  }
  if constexpr (DC % 4 == 0) {
    if (vec) {
      constexpr int kVecs = DC / 4;
      for (int i = t0; i < ne * kVecs; i += stride) {
        const int r = i / kVecs;
        const int j = i % kVecs;
        reinterpret_cast<float4*>(sh)[i] = *reinterpret_cast<const float4*>(
            hb + (size_t)(e0 + r) * D + 4 * j);
      }
      return;
    }
  }
  for (int i = t0; i < ne * DC; i += stride) {
    const int r = i / DC;
    const int c = i % DC;
    sh[i] = hb[(size_t)(e0 + r) * D + c];
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
segment_mean_edge_kernel(const float* __restrict__ h,         // (B, E, D)
                         const int32_t* __restrict__ edges,   // (B, E, 2)
                         const uint8_t* __restrict__ mask,    // (B, E)
                         float* __restrict__ out,             // (B, N, D)
                         float* __restrict__ counts,          // (B, N)
                         int E, int N, int D, bool vec) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);       // 2 x kChunk * DC
  float* table = sh + 2 * kChunk * DC;               // N * DC
  int* cnt = reinterpret_cast<int*>(table + (size_t)N * DC);   // N
  int* su = cnt + N;                                 // 2 x kChunk
  int* sv = su + 2 * kChunk;                         // 2 x kChunk

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * DC;
  const int tid = threadIdx.x;
  const float* hb = h + (size_t)b * E * D + c0;
  const int32_t* eb = edges + (size_t)b * E * 2;
  const uint8_t* mb = mask + (size_t)b * E;

  for (int i = tid; i < N * DC; i += kThreads) table[i] = 0.f;
  for (int i = tid; i < N; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int n_chunks = (E + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    stage<DC>(hb, eb, mb, 0, min(kChunk, E), N, D, vec, su, sv, sh, cnt,
              tid, kThreads);
  }
  __syncthreads();

  const int half = (tid >> 4) & 1;   // walking lanes: 0 = u, 1 = v
  const int c = tid & 15;
  for (int k = 0; k < n_chunks; ++k) {
    const int buf = k & 1;
    if (tid < 32) {
      const int ne = min(kChunk, E - k * kChunk);
      const int* bu = su + buf * kChunk;
      const int* bv = sv + buf * kChunk;
      const float* bh = sh + buf * kChunk * DC;
      for (int i = 0; i < ne; ++i) {
        const int u = bu[i];
        const int v = bv[i];
        if (c < DC) {
          const float x = bh[i * DC + c];
          const bool loop = u == v;
          const int n = half ? v : u;
          if (n >= 0 && !(half && loop)) {
            table[n * DC + c] += (loop ? x + x : x);
          }
        }
        __syncwarp();   // this edge's adds land before the next edge's
      }
    } else if (k + 1 < n_chunks) {
      const int e0 = (k + 1) * kChunk;
      const int nb = buf ^ 1;
      stage<DC>(hb, eb, mb, e0, min(kChunk, E - e0), N, D, vec,
                su + nb * kChunk, sv + nb * kChunk, sh + nb * kChunk * DC,
                cnt, tid - 32, kThreads - 32);
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * N * D + c0;
  for (int i = tid; i < N * DC; i += kThreads) {
    const int n = i / DC;
    ob[(size_t)n * D + i % DC] = table[i] / ((float)cnt[n] + 1e-6f);
  }
  if (blockIdx.x == 0) {
    for (int n = tid; n < N; n += kThreads) {
      counts[(size_t)b * N + n] = (float)cnt[n];
    }
  }
}

template <int DC>
int launch(const void* h, const void* edges, const void* mask, void* out,
           void* counts, int B, int E, int N, int D, cudaStream_t stream) {
  const size_t bytes = shared_bytes(N, DC);
  cudaError_t err = cudaFuncSetAttribute(
      segment_mean_edge_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // float4 staging needs 16-byte aligned rows of the slice
  const bool vec = (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  dim3 grid(D / DC, B);
  segment_mean_edge_kernel<DC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(h), static_cast<const int32_t*>(edges),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out),
      static_cast<float*>(counts), E, N, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The column-slice width the kernel uses for N nodes of width D on the
// current device: the widest power of two <= 16 dividing D whose table
// fits in a block's opt-in shared memory, or -1 where none fits.
extern "C" int segment_mean_edge_columns(int N, int D) {
  int device = 0;
  int limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  for (int dc = kMaxCols; dc >= 1; dc /= 2) {
    if (D % dc == 0 && shared_bytes(N, dc) <= (size_t)limit) return dc;
  }
  return -1;
}

// Returns a cudaError_t: 0 on a successful launch. The Python wrapper
// checks shapes and types first; B is bounded by the grid's y limit.
extern "C" int segment_mean_edge_f32(const void* h, const void* edges,
                                     const void* mask, void* out,
                                     void* counts, int B, int E, int N,
                                     int D, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (segment_mean_edge_columns(N, D)) {
    case 16: return launch<16>(h, edges, mask, out, counts, B, E, N, D, s);
    case 8: return launch<8>(h, edges, mask, out, counts, B, E, N, D, s);
    case 4: return launch<4>(h, edges, mask, out, counts, B, E, N, D, s);
    case 2: return launch<2>(h, edges, mask, out, counts, B, E, N, D, s);
    case 1: return launch<1>(h, edges, mask, out, counts, B, E, N, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
