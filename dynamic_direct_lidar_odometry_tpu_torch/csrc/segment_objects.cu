// The segment gates and object slots of a label image for Hopper (sm_90a).
//
// Computes what the JAX package's segment_objects
// (dynamic_direct_lidar_odometry_tpu/ops/segmentation.py:360) computes
// after label_components: each component's pixel count, the K largest
// components of at least min_size pixels as candidates (size descending,
// then root ascending: lax.top_k's order over the sorted roots), each
// candidate's distinct rows, z extent, largest range and mean positive
// residual, the gates of labelComponents (detection.cpp:659-699, with its
// hard-coded size 50), the S largest feasible candidates as object slots
// and each pixel's slot. It replaces no Pallas kernel: the JAX package
// leaves this function to XLA, which runs the candidates' statistics as
// dense (K, H*W) masked reductions (the MXU/VPU's shape). The port's plain
// version is ops/segmentation.py segment_objects_plain; it writes the
// residual sum's order out, so kernel and plain version agree bit for bit.
//
// A root is the smallest flat pixel index of its component
// (label_components), so sizes need no sort: one integer atomicAdd a
// pixel (warp-aggregated by label) into a per-root count gives each root's
// size exactly, an atomicMax its last pixel, and the add that carries a
// count to min_size appends the root to a list of qualifying roots (its
// length, every root at or above min_size, is the device count seg_roots).
//
// The launches, all on the caller's stream (one memset, four kernels):
//   memset   the counts, the last pixels and the list length;
//   count    one thread a pixel: the counts, last pixels and the list;
//   select   one block: if more than K roots qualify, a radix select of
//            the K-th largest 64-bit key (count << 32 | ~root) over the
//            list in device memory (8 passes of 8 bits, warp-aggregated
//            shared histograms), exact for any count; the K (or fewer)
//            keys at or above it sorted in shared memory (bitonic,
//            descending); the root -> candidate map written into the
//            count array itself (-(c + 1)), since no count is read again;
//   stats    one block a candidate, over its pixel range [root, last]
//            only: the rows present (a bit each in shared memory), min z,
//            max z and max range (exact in any order), the residual count
//            and sum;
//   finish   one thread a pixel: every block evaluates the gates of the K
//            candidates and numbers the feasible ones in candidate order
//            (a block scan; block 0 writes the S slots), then maps its
//            pixel through root -> candidate -> slot.
//
// The residual sum's order (written here and in the plain version): the
// flat pixels are dealt to kLanes = 2048 lanes (pixel p to lane p mod
// 2048); each lane sums its members' positive residuals in ascending p,
// from +0, in f32; then the lanes are added in a halving tree (lane i +=
// lane i + s, s = 1024, 512, ..., 1). A stats thread holds 4 lanes (t,
// t + 512, t + 1024, t + 1536), so the first two levels are its own; the
// rest run in shared memory. avg = sum / count (an f32 division) where the
// count is positive, else 0. Skipping the pixels before the candidate's
// root and after its last pixel leaves every lane's sum as it is.
//
// What bounds it on an H100: bytes. Each pixel's label, range, residual
// (4 B each) and point (12 B) read once and its slot written once: 28 B a
// pixel, 3.67 MB at 64 x 2048 (1.1 us at 3.35 TB/s). The design reads
// the labels twice (count and finish), each candidate's label range once
// more from L2 (the label image, 512 KB, stays there), and members' z,
// range and residual once; launch latency (five graph nodes) outweighs
// the bytes. The dense design moved ~0.7 GB a scan at K = 128.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;               // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = 4;          // stats: lanes a thread sums
constexpr int kLanes = kThreads * kLanesPerThread;  // the residual sum's lanes
constexpr int kMaxCandidates = 4096;        // select's keys: 32 KB of shared memory
constexpr float kBig = 1.0e9f;              // the empty extent (segment_objects' big)

// the scratch, carved from one int32 buffer; the first 2 n + 2 words are
// zeroed by the memset
struct Work {
  int* cnt;         // (n) per-root count; a candidate's entry is -(c + 1) after select
  int* last;        // (n) per-root last pixel
  int* nq;          // roots at or above min_size (the list's length)
  int* ncand;       // candidates: min(nq, K)
  int* list;        // (n) qualifying roots, in the order the adds reached min_size
  int* cand_root;   // (K) candidate c's root (-1 past ncand)
  int* cand_size;   // (K)
  int* line_count;  // (K) stats, written for c < ncand
  float* min_z;
  float* max_z;
  float* max_r;
  float* avg_res;
};

long long work_words(long long n, long long K) { return 3 * n + 2 + 7 * K; }

Work carve(void* base, int n, int K)
{
  int* w = static_cast<int*>(base);
  Work o;
  o.cnt = w;
  o.last = w + n;
  o.nq = w + 2 * static_cast<size_t>(n);
  o.ncand = o.nq + 1;
  o.list = o.nq + 2;
  int* c = o.list + n;
  o.cand_root = c;
  o.cand_size = c + K;
  o.line_count = c + 2 * K;
  o.min_z = reinterpret_cast<float*>(c + 3 * K);
  o.max_z = reinterpret_cast<float*>(c + 4 * K);
  o.max_r = reinterpret_cast<float*>(c + 5 * K);
  o.avg_res = reinterpret_cast<float*>(c + 6 * K);
  return o;
}

struct Gates {
  int min_line_num, valid_point_num, valid_line_num;
  float max_distance, min_delta_z, max_delta_z, max_elevation;
};

__global__ void __launch_bounds__(kThreads) seg_count_kernel(const int* __restrict__ lab, int n, int min_size,
                                                             Work w)
{
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int l = p < n ? lab[p] : -1;
  const unsigned members = __ballot_sync(0xffffffffu, l >= 0);
  if (l < 0) return;
  const unsigned peers = __match_any_sync(members, l);
  const int lane = threadIdx.x & 31;
  if (lane == __ffs(peers) - 1) {
    const int add = __popc(peers);
    const int old = atomicAdd(&w.cnt[l], add);
    if (old < min_size && old + add >= min_size) w.list[atomicAdd(w.nq, 1)] = l;
  }
  if (lane == 31 - __clz(peers)) atomicMax(&w.last[l], p);  // the peers' largest pixel
}

// larger is better: the count, then the smaller root
__device__ __forceinline__ unsigned long long root_key(const int* cnt, int r)
{
  return (static_cast<unsigned long long>(static_cast<unsigned>(cnt[r])) << 32)
         | (0xffffffffu - static_cast<unsigned>(r));
}

__global__ void __launch_bounds__(kThreads) seg_select_kernel(int K, Work w, long long* seg_roots)
{
  extern __shared__ unsigned long long keys[];  // next power of two >= K
  __shared__ unsigned hist[256];
  __shared__ unsigned long long s_prefix;
  __shared__ unsigned s_need, s_taken;
  const int t = threadIdx.x;
  const int q = *w.nq;
  unsigned long long lo = 0;  // the keys >= lo are the candidates
  if (q > K) {
    // the K-th largest key, a digit at a time from the top; keys are
    // distinct (one per root), so exactly K keys are >= it
    unsigned long long prefix = 0, pmask = 0;
    unsigned need = K;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = t; i < 256; i += kThreads) hist[i] = 0;
      __syncthreads();
      for (int base = 0; base < q; base += kThreads) {
        const int i = base + t;
        unsigned long long k = 0;
        bool in = false;
        if (i < q) {
          k = root_key(w.cnt, w.list[i]);
          in = (k & pmask) == prefix;
        }
        const unsigned digit = static_cast<unsigned>(k >> shift) & 255u;
        const unsigned who = __ballot_sync(0xffffffffu, in);
        if (in) {
          const unsigned peers = __match_any_sync(who, digit);
          if ((t & 31) == __ffs(peers) - 1) atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
        }
      }
      __syncthreads();
      if (t == 0) {
        unsigned above = 0;
        int d = 255;
        for (; d > 0; --d) {
          if (above + hist[d] >= need) break;
          above += hist[d];
        }
        s_need = need - above;
        s_prefix = prefix | (static_cast<unsigned long long>(d) << shift);
      }
      __syncthreads();
      need = s_need;
      prefix = s_prefix;
      pmask |= 255ull << shift;
    }
    lo = prefix;
  }
  if (t == 0) s_taken = 0;
  __syncthreads();
  for (int i = t; i < q; i += kThreads) {
    const unsigned long long k = root_key(w.cnt, w.list[i]);
    if (k >= lo) keys[atomicAdd(&s_taken, 1u)] = k;
  }
  __syncthreads();
  const int m = static_cast<int>(s_taken);  // min(q, K)
  int P = 1;
  while (P < m) P <<= 1;
  for (int i = m + t; i < P; i += kThreads) keys[i] = 0;  // below every real key
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < P; i += kThreads) {
        const int x = i ^ j;
        if (x > i) {
          const unsigned long long a = keys[i], b = keys[x];
          if ((i & k) == 0 ? a < b : a > b) {
            keys[i] = b;
            keys[x] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int c = t; c < K; c += kThreads) {
    if (c < m) {
      const int r = static_cast<int>(0xffffffffu - static_cast<unsigned>(keys[c]));
      w.cand_root[c] = r;
      w.cand_size[c] = static_cast<int>(keys[c] >> 32);
      w.cnt[r] = -(c + 1);
    } else {
      w.cand_root[c] = -1;
      w.cand_size[c] = 0;
    }
  }
  if (t == 0) {
    *w.ncand = m;
    *seg_roots += q;  // the launching branch's own count row
  }
}

__device__ __forceinline__ float warp_min(float v)
{
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v)
{
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v)
{
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) seg_stats_kernel(const int* __restrict__ lab,
                                                             const float* __restrict__ points,
                                                             const float* __restrict__ ranges,
                                                             const float* __restrict__ res, int H, int W,
                                                             Work w)
{
  extern __shared__ unsigned rows[];  // a bit a row
  __shared__ float part[kThreads];
  __shared__ float s_lo[kWarps], s_hi[kWarps], s_r[kWarps];
  __shared__ int s_n[kWarps];
  const int c = blockIdx.x;
  if (c >= *w.ncand) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int root = w.cand_root[c];
  const int last = w.last[root];
  const int words = (H + 31) / 32;
  for (int i = t; i < words; i += kThreads) rows[i] = 0;
  __syncthreads();
  float lo = kBig, hi = -kBig, rmax = -kBig;
  float sum[kLanesPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cnt = 0;
  for (int base = root - root % kLanes; base <= last; base += kLanes) {
    int l[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int p = base + t + j * kThreads;
      l[j] = p <= last ? lab[p] : -1;
    }
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      if (l[j] != root) continue;
      const int p = base + t + j * kThreads;
      const int row = p / W;
      atomicOr(&rows[row >> 5], 1u << (row & 31));
      const float z = points[3 * static_cast<size_t>(p) + 2];
      lo = z < lo ? z : lo;
      hi = z > hi ? z : hi;
      const float r = ranges[p];
      rmax = r > rmax ? r : rmax;
      const float v = res[p];
      if (v > 0.0f) {
        ++cnt;
        sum[j] = __fadd_rn(sum[j], v);
      }
    }
  }
  // the tree's levels s = 1024 and 512 are the thread's own lanes
  part[t] = __fadd_rn(__fadd_rn(sum[0], sum[2]), __fadd_rn(sum[1], sum[3]));
  lo = warp_min(lo);
  hi = warp_max(hi);
  rmax = warp_max(rmax);
  cnt = warp_sum(cnt);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_r[warp] = rmax;
    s_n[warp] = cnt;
  }
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) part[t] = __fadd_rn(part[t], part[t + s]);
    __syncthreads();
  }
  if (warp == 0) {
    int lines = 0;
    for (int i = lane; i < words; i += 32) lines += __popc(rows[i]);
    lines = warp_sum(lines);
    lo = lane < kWarps ? s_lo[lane] : kBig;
    hi = lane < kWarps ? s_hi[lane] : -kBig;
    rmax = lane < kWarps ? s_r[lane] : -kBig;
    cnt = warp_sum(lane < kWarps ? s_n[lane] : 0);
    lo = warp_min(lo);
    hi = warp_max(hi);
    rmax = warp_max(rmax);
    if (lane == 0) {
      w.line_count[c] = lines;
      w.min_z[c] = lo;
      w.max_z[c] = hi;
      w.max_r[c] = rmax;
      w.avg_res[c] = cnt > 0 ? __fdiv_rn(part[0], static_cast<float>(cnt)) : 0.0f;
    }
  }
}

// detection.cpp:659-699 as segment_objects_plain writes them, in f32
// (each integer bar compared as the f32 it rounds to, as torch compares a
// tensor with a Python number)
__device__ __forceinline__ bool feasible(const Work& w, int c, float height, const Gates& g)
{
  const float size = static_cast<float>(w.cand_size[c]);
  const float lines = static_cast<float>(w.line_count[c]);
  bool f = size >= 50.0f && lines >= static_cast<float>(g.min_line_num);
  f = f || (size >= static_cast<float>(g.valid_point_num) && lines >= static_cast<float>(g.valid_line_num));
  f = f && w.max_r[c] <= g.max_distance;
  const float dz = __fsub_rn(w.max_z[c], w.min_z[c]);
  f = f && g.min_delta_z <= dz && dz <= g.max_delta_z;
  f = f && __fsub_rn(w.min_z[c], height) <= g.max_elevation;
  return f && size > 0.0f;
}

__global__ void __launch_bounds__(kThreads) seg_finish_kernel(const int* __restrict__ lab, int n, int K,
                                                              int S, const float* __restrict__ sensor_height,
                                                              Gates g, Work w, int* slot_roots,
                                                              unsigned char* slot_valid, float* slot_avg,
                                                              int* pixel_slot)
{
  extern __shared__ int slot_of[];  // (K) candidate -> slot, -1 none
  __shared__ int warp_n[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m = *w.ncand;
  const float height = *sensor_height;
  int taken = 0;  // feasible candidates before this chunk
  for (int base = 0; base < K; base += kThreads) {
    const int c = base + t;
    const bool f = c < m && feasible(w, c, height, g);
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_n[warp] = __popc(b);
    __syncthreads();
    int rank = taken + __popc(b & ((1u << lane) - 1u));
    int chunk = 0;
    for (int i = 0; i < kWarps; ++i) {
      rank += i < warp ? warp_n[i] : 0;
      chunk += warp_n[i];
    }
    if (c < K) slot_of[c] = f && rank < S ? rank : -1;
    taken += chunk;
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    for (int s = (taken < S ? taken : S) + t; s < S; s += kThreads) {
      slot_roots[s] = -1;
      slot_valid[s] = 0;
      slot_avg[s] = 0.0f;
    }
    for (int c = t; c < K; c += kThreads) {
      const int s = slot_of[c];
      if (s >= 0) {
        slot_roots[s] = w.cand_root[c];
        slot_valid[s] = 1;
        slot_avg[s] = w.avg_res[c];
      }
    }
  }
  const int p = blockIdx.x * kThreads + t;
  if (p < n) {
    const int l = lab[p];
    int s = -1;
    if (l >= 0) {
      const int v = w.cnt[l];
      if (v < 0) s = slot_of[-v - 1];
    }
    pixel_slot[p] = s;
  }
}

}  // namespace

extern "C" {

// int32 words of the scratch buffer ddlo_segment_objects takes
long long ddlo_segment_objects_work_words(int n, int K) { return work_words(n, K); }

int ddlo_segment_objects_max_candidates() { return kMaxCandidates; }

// the residual sum's lanes (segmentation.SUM_LANES)
int ddlo_segment_objects_lanes() { return kLanes; }

// labels (H, W) int32 (-1 = none), points (H, W, 3), ranges and residual
// (H, W) f32, sensor_height one f32, all contiguous on the device; work
// ddlo_segment_objects_work_words(H * W, K) int32 words; seg_roots one
// int64 (the count row's seg_roots slot, added to); out slot_roots (S)
// int32, slot_valid (S) bool, slot_avg (S) f32, pixel_slot (H, W) int32.
// 1 <= K <= min(H * W, 4096), S >= 1. Launches on `stream`, allocates
// nothing, does not synchronize, and returns the first CUDA error.
int ddlo_segment_objects(const void* labels, const void* points, const void* ranges, const void* residual,
                         const void* sensor_height, int H, int W, int K, int S, int min_size,
                         int min_line_num, int valid_point_num, int valid_line_num, float max_distance,
                         float min_delta_z, float max_delta_z, float max_elevation, void* work,
                         void* seg_roots, void* slot_roots, void* slot_valid, void* slot_avg,
                         void* pixel_slot, void* stream)
{
  const long long n64 = static_cast<long long>(H) * W;
  if (H <= 0 || W <= 0 || n64 >= (1LL << 31) - kLanes || K < 1 || K > kMaxCandidates || K > n64 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(n64);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work w = carve(work, n, K);
  const int* lab = static_cast<const int*>(labels);
  cudaError_t err = cudaMemsetAsync(work, 0, (2 * static_cast<size_t>(n) + 2) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  seg_count_kernel<<<blocks, kThreads, 0, st>>>(lab, n, min_size, w);
  int P = 1;
  while (P < K) P <<= 1;
  seg_select_kernel<<<1, kThreads, P * sizeof(unsigned long long), st>>>(
      K, w, static_cast<long long*>(seg_roots));
  seg_stats_kernel<<<K, kThreads, ((H + 31) / 32) * sizeof(unsigned), st>>>(
      lab, static_cast<const float*>(points), static_cast<const float*>(ranges),
      static_cast<const float*>(residual), H, W, w);
  const Gates g{min_line_num, valid_point_num, valid_line_num, max_distance, min_delta_z, max_delta_z,
                max_elevation};
  seg_finish_kernel<<<blocks, kThreads, K * sizeof(int), st>>>(
      lab, n, K, S, static_cast<const float*>(sensor_height), g, w, static_cast<int*>(slot_roots),
      static_cast<unsigned char*>(slot_valid), static_cast<float*>(slot_avg), static_cast<int*>(pixel_slot));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
