// K3: the attention and gate of one decode step, fused, as thread-block
// clusters on Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` / `_fused_attention_gate_tpu` of
// stroke_derenderer_tpu/kernels/decode_attention.py. For each row b:
//
//     dec     = h W_att + b_att                                   (A)
//     score_p = v . relu(enc_proj[p] + dec)                       (P)
//     alpha   = softmax_p(score)                                  (P)
//     out     = sigmoid(h W_f + b_f) * sum_p alpha_p enc[p]       (E)
//
// Numerics (the TPU kernel's contract): every input is streamed as
// bfloat16 (h may come as float32 and is rounded to bfloat16 here), all
// arithmetic is float32, and out and alpha are float32. The bias of v is
// left out: it shifts every score equally and cancels in the softmax.
//
// What bounds it on an H100: the bytes. [W_att | W_f] are 1 MB in bfloat16
// and each row brings 0.4 MB of encoder rows and projections (P = 196, E =
// A = D = 512), for about 1.6 MFLOP per row. At the CLI's batch sizes the
// bytes that must move take well under a microsecond at 3.35 TB/s, so a
// launch costs what its latency chain costs: how many bytes one SM pulls
// through its own load path, and how many dependent round trips it makes.
// The first design (one block per row) had each SM read all 1 MB of weights
// with scalar 2-byte loads, and walk the 196 positions in a serial chain.
//
// Design: one thread-block cluster of C CTAs (neighbouring SMs sharing
// distributed shared memory) per group of rows. G clusters, at most as many
// as the card holds at once and at most B, share the rows evenly. In a
// cluster, CTA c owns
//   - a contiguous slice of the columns of the packed [W_att | W_f]
//     (kernels/decode_attention.py:pack_attention_weights: each column's D
//     values contiguous and padded to a multiple of 8, so that a slice is
//     one contiguous, 16-byte-aligned stretch). Each lane keeps 16 chunks of
//     16 bytes in flight, so a CTA's whole slice (64 KB at C = 16) is
//     requested at once, right after the tile's h (loads are served in
//     issue order, so h does not wait behind the weights); the slice is
//     applied to every row of a row tile (up to 16 rows). A weight is read
//     once per cluster and tile, not once per row, and an SM reads 1/C of
//     the weights;
//   - a contiguous range of the P positions. Its rows of enc_proj and enc do
//     not depend on h, so their copies (cp.async.bulk: a 1-D TMA copy into
//     shared memory that completes on an mbarrier) start as soon as the
//     weights are requested, into a ring of stages of one row each, and
//     arrive while the weights stream;
//   - a contiguous range of the E output columns.
// Data moves between CTAs only by stores into the reader's shared memory
// (distributed shared memory), which do not wait for a reply; a load from
// a peer costs a round trip of about 0.3 us on an H100, a store does not
// stall. One row tile:
//   1. each CTA computes its columns of dec = h W_att + b_att and of the
//      gate sigmoid(h W_f + b_f), and stores each column of dec into every
//      CTA and each gate column into the CTA that owns that output column.
//      Cluster barrier 1.
//   2. each CTA scores its positions (a warp per position, 16-byte loads,
//      v and the row's dec in registers) and keeps a local softmax: its max
//      m_c, its sum s_c = sum_p exp(score_p - m_c) and its partial attended
//      vector awe_c = sum_p exp(score_p - m_c) enc_p; it stores (m_c, s_c)
//      into every CTA and each column of awe_c into the CTA that owns it.
//      Cluster barrier 2.
//   3. each CTA combines, from its own shared memory, the C partials of its
//      output columns with the factors exp(m_c - m) / sum_c s_c exp(m_c -
//      m) (flash-decoding inside a cluster), multiplies by the gate, writes
//      out, and writes alpha for its own positions.
// Two cluster barriers per row tile, plus one between tiles (so that a
// tile's stores do not overwrite what a peer still reads) and a split
// arrive/wait at entry (no CTA stores into a peer before the peer runs).
// No grid barrier, no global scratch, no atomics. The ownership plan is
// computed on the host (kernels/decode_attention.py:attention_plan) and
// passed by value; the host checks it against the shared-memory layout.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_GROUPS = 512;
constexpr size_t MAX_SMEM = 232448;  // what one block may use on an H100
constexpr int WREGS = 16;  // 16-byte weight chunks a lane keeps in flight

typedef __nv_bfloat16 bf16;

// The int array `dims` of the C entries, in this order.
enum Dim { D_B, D_P, D_E, D_A, D_D, D_C, D_G, D_HF32, N_DIMS };
// The pointer array `ptrs` of sd_attention_gate, in this order.
enum Ptr {
  P_ENC, P_PROJ, P_H, P_M1, P_BIAS, P_V, P_OUT, P_ALPHA, P_STAMPS, N_PTRS
};
// The phase clock: with a stamps array, thread 0 of CTA 0 writes its SM's
// cycle counter at kernel entry and after each of these points of its first
// row tile (the T_WAIT..T_AWE points: of the tile's first row), and the
// global timer (ns) at entry and after the last point, to scale cycles to
// time.
enum Stamp {
  T_ENTRY, T_LOADS, T_INIT, T_ISSUED, T_HSTORED, T_STAGED, T_FIRST_ROW,
  T_PROJECT, T_BARRIER1, T_WAIT, T_SCORES, T_SOFTMAX, T_AWE,
  T_POSITIONS, T_BARRIER2, T_COMBINE, G_ENTRY, G_EXIT, N_STAMPS
};

// Start offsets, as in attention_plan: rows of each cluster, and columns of
// [W_att | W_f], positions and output columns of each CTA of a cluster.
struct Plan {
  int rows[MAX_GROUPS + 1];
  int cols[MAX_CLUSTER + 1];
  int pos[MAX_CLUSTER + 1];
  int outs[MAX_CLUSTER + 1];
};

struct Args {
  const bf16* enc;
  const bf16* proj;
  const void* h;
  const bf16* m1;
  const bf16* bias;
  const bf16* v;
  float* out;
  float* alpha;
  long long* stamps;  // N_STAMPS, or null
  int B, P, E, A, D, Dp, C, h_f32;
  int row_tile, stages, pc_max, oc_max, groups, kmax;
  // Byte offsets into dynamic shared memory.
  int o_bar, o_outs, o_h, o_dec, o_gate, o_sc, o_ml, o_awe, o_red, o_scale,
      o_stat, o_stage;
  int stage_elems;  // bfloat16 elements of one stage
};

// --- PTX helpers: mbarriers and 1-D bulk copies --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void stamp(const Args& a, bool on, int at) {
  if (on) {
    a.stamps[at] = clock64();
    if (at == T_ENTRY || at == T_COMBINE) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      a.stamps[at == T_ENTRY ? G_ENTRY : G_EXIT] = t;
    }
  }
}

// --- arithmetic helpers -------------------------------------------------

__device__ __forceinline__ float bf_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void unpack8(const uint4 u, float* f) {
  f[0] = bf_lo(u.x); f[1] = bf_hi(u.x); f[2] = bf_lo(u.y); f[3] = bf_hi(u.y);
  f[4] = bf_lo(u.z); f[5] = bf_hi(u.z); f[6] = bf_lo(u.w); f[7] = bf_hi(u.w);
}

__device__ __forceinline__ float dot8(const uint4 w, const uint4 x,
                                      float acc) {
  acc = fmaf(bf_lo(w.x), bf_lo(x.x), acc);
  acc = fmaf(bf_hi(w.x), bf_hi(x.x), acc);
  acc = fmaf(bf_lo(w.y), bf_lo(x.y), acc);
  acc = fmaf(bf_hi(w.y), bf_hi(x.y), acc);
  acc = fmaf(bf_lo(w.z), bf_lo(x.z), acc);
  acc = fmaf(bf_hi(w.z), bf_hi(x.z), acc);
  acc = fmaf(bf_lo(w.w), bf_lo(x.w), acc);
  acc = fmaf(bf_hi(w.w), bf_hi(x.w), acc);
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Starts the copies of one row's enc_proj and enc rows at the CTA's
// positions into a stage (proj first, then enc at pc_max * A elements).
__device__ __forceinline__ void load_row(const Args& a, int row, int p0,
                                         int np, bf16* stage, uint64_t* bar) {
  const uint32_t pb = (uint32_t)np * a.A * 2;
  const uint32_t eb = (uint32_t)np * a.E * 2;
  mbar_expect_tx(bar, pb + eb);
  bulk_load(stage, a.proj + ((size_t)row * a.P + p0) * a.A, pb, bar);
  bulk_load(stage + (size_t)a.pc_max * a.A,
            a.enc + ((size_t)row * a.P + p0) * a.E, eb, bar);
}

// A warp's batch of NB consecutive weight columns from jb: every 16-byte
// chunk requested before any is used.
template <int K>
__device__ __forceinline__ void load_batch(const Args& a, int jb, int j1,
                                           uint4 (&w)[WREGS / K][K]) {
  constexpr int NB = WREGS / K;
  const int lane = threadIdx.x % 32;
  const int D8 = a.Dp / 8;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int k8 = lane + 32 * kk;
      w[b][kk] = (jb + b < j1 && k8 < D8)
                     ? __ldg(reinterpret_cast<const uint4*>(
                           a.m1 + (size_t)(jb + b) * a.Dp + 8 * k8))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
}

// Sums v[b] over the warp for every b at once: at each of log2(N) steps a
// lane keeps half of its values and swaps the other half with the lane
// `off` away, so N sums take N - 1 + log2(32 / N) shuffles instead of
// 5 N. Afterwards v[0] is the whole sum of column `idx`, held alike by the
// 32 / N lanes of a group; returns idx.
template <int N>
__device__ __forceinline__ int split_sum(float (&v)[N]) {
  const int lane = threadIdx.x % 32;
  int idx = 0, off = 16;
#pragma unroll
  for (int n = N; n > 1; n /= 2, off /= 2) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    idx += up ? n / 2 : 0;
  }
  for (; off > 0; off /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return idx;
}

// The CTA that owns entry x of a start-offset array of C + 1 entries over
// n entries: starting from where an even split puts it.
__device__ __forceinline__ int owner(const int* starts, int x, int n, int C) {
  int q = min(x * C / n, C - 1);
  while (starts[q] > x) --q;
  while (starts[q + 1] <= x) ++q;
  return q;
}

// h for a row tile, staged in shared memory as bfloat16, zero-padded to
// Dp. Where D is a multiple of 8 a thread moves 8 values at a time (one
// 16-byte load, two for float32), HU per round: h_load issues a round's
// loads and h_store converts and writes them, so that other loads can be
// issued in between without waiting for these.
constexpr int HU = 4;

__device__ __forceinline__ void h_load(const Args& a, int row, int n8, int i0,
                                       uint4 (&x)[HU][2]) {
#pragma unroll
  for (int u = 0; u < HU; ++u) {
    const int i = i0 + u * THREADS;
    if (i >= n8) continue;
    if (a.h_f32) {
      const uint4* src =
          static_cast<const uint4*>(a.h) + (size_t)row * a.D / 4 + 2 * i;
      x[u][0] = __ldg(src);
      x[u][1] = __ldg(src + 1);
    } else {
      x[u][0] =
          __ldg(static_cast<const uint4*>(a.h) + (size_t)row * a.D / 8 + i);
    }
  }
}

__device__ __forceinline__ void h_store(const Args& a, int n8, int i0,
                                        const uint4 (&x)[HU][2], bf16* s_h) {
#pragma unroll
  for (int u = 0; u < HU; ++u) {
    const int i = i0 + u * THREADS;
    if (i >= n8) continue;
    uint4 y = x[u][0];
    if (a.h_f32) {
      const uint4 lo = x[u][0], hi = x[u][1];
      __nv_bfloat162 p[4] = {
          __floats2bfloat162_rn(__uint_as_float(lo.x), __uint_as_float(lo.y)),
          __floats2bfloat162_rn(__uint_as_float(lo.z), __uint_as_float(lo.w)),
          __floats2bfloat162_rn(__uint_as_float(hi.x), __uint_as_float(hi.y)),
          __floats2bfloat162_rn(__uint_as_float(hi.z), __uint_as_float(hi.w))};
      y = *reinterpret_cast<uint4*>(p);
    }
    const int r = i / (a.D / 8), k8 = i % (a.D / 8);
    *reinterpret_cast<uint4*>(s_h + r * a.Dp + 8 * k8) = y;
  }
}

// The rest of h after the first round (all of it when D is not a multiple
// of 8: one value at a time).
__device__ __forceinline__ void h_rest(const Args& a, int row, int nt,
                                       bf16* s_h) {
  if (a.D % 8 == 0) {
    const int n8 = nt * (a.D / 8);
    for (int i0 = threadIdx.x + HU * THREADS; i0 < n8; i0 += HU * THREADS) {
      uint4 x[HU][2];
      h_load(a, row, n8, i0, x);
      h_store(a, n8, i0, x, s_h);
    }
    return;
  }
  for (int i = threadIdx.x; i < nt * a.Dp; i += THREADS) {
    const int r = i / a.Dp, k = i % a.Dp;
    const size_t src = (size_t)(row + r) * a.D + k;
    s_h[i] = k >= a.D ? __float2bfloat16_rn(0.0f)
             : a.h_f32
                 ? __float2bfloat16_rn(static_cast<const float*>(a.h)[src])
                 : static_cast<const bf16*>(a.h)[src];
  }
}

// Phase 1: the CTA's columns j0..j1 of [dec | gate] for the tile's nt rows
// (h from row `row` on), pushed to where they are read: a column of dec
// into every CTA's s_dec, a gate column into the s_gate of the CTA that
// owns that output column. A warp takes NB consecutive columns at a time;
// its first batch is requested before h is staged, so that the two
// overlap.
template <int K, typename Between>
__device__ __forceinline__ void project(cg::cluster_group& cluster,
                                        const Args& a, int j0, int j1,
                                        int row, int nt, bool first_tile,
                                        bf16* s_h, float* s_dec,
                                        float* s_gate, const int* s_outs,
                                        Between between) {
  constexpr int NB = WREGS / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D8 = a.Dp / 8;
  const int first = j0 + warp * NB;
  // h's first round, then the weights, then `between`, then h's stores:
  // the loads are served in the order they were issued.
  const int n8 = a.D % 8 == 0 ? nt * (a.D / 8) : 0;
  uint4 hx[HU][2];
  h_load(a, row, n8, threadIdx.x, hx);
  uint4 w[NB][K];
  load_batch<K>(a, first, j1, w);
  stamp(a, a.stamps && first_tile && blockIdx.x == 0 && threadIdx.x == 0,
        T_LOADS);
  between();
  h_store(a, n8, threadIdx.x, hx, s_h);
  h_rest(a, row, nt, s_h);
  stamp(a, a.stamps && first_tile && blockIdx.x == 0 && threadIdx.x == 0,
        T_HSTORED);
  __syncthreads();
  stamp(a, a.stamps && first_tile && blockIdx.x == 0 && threadIdx.x == 0,
        T_STAGED);
  // A CTA may store into a peer's shared memory only once the peer runs:
  // wait for the arrival every CTA made at its start.
  if (first_tile) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int jb = first; jb < j1; jb += WARPS * NB) {
    if (jb != first) load_batch<K>(a, jb, j1, w);
    // This lane's column after split_sum, and where its values go.
    int col = -1;
    float bias = 0.0f;
    float* gate_dst = nullptr;
    for (int r = 0; r < nt; ++r) {
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int k8 = lane + 32 * kk;
        if (k8 < D8) {
          const uint4 x =
              *reinterpret_cast<const uint4*>(s_h + r * a.Dp + 8 * k8);
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[b] = dot8(w[b][kk], x, acc[b]);
        }
      }
      const int j = jb + split_sum<NB>(acc);
      stamp(a, a.stamps && first_tile && blockIdx.x == 0 &&
                   threadIdx.x == 0 && r == 0 && jb == first,
            T_FIRST_ROW);
      if (lane % (32 / NB) != 0 || j >= j1) continue;
      if (col != j) {  // first row: this lane's column, bias, destination
        col = j;
        bias = __bfloat162float(a.bias[j]);
        if (j >= a.A) {
          const int e = j - a.A, q = owner(s_outs, e, a.E, a.C);
          gate_dst = cluster.map_shared_rank(s_gate, q) + (e - s_outs[q]);
        }
      }
      const float x = acc[0] + bias;
      if (j < a.A) {
        for (int q = 0; q < a.C; ++q)
          cluster.map_shared_rank(s_dec, q)[r * a.A + j] = x;
      } else {
        gate_dst[r * a.oc_max] = 1.0f / (1.0f + expf(-x));
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1)
    attention_gate_kernel(const __grid_constant__ Args a,
                          const __grid_constant__ Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = a.C, A = a.A, E = a.E, P = a.P;
  const int c = (int)cluster.block_rank();
  const int g = blockIdx.x / C;
  const int row0 = plan.rows[g], nrows = plan.rows[g + 1] - row0;
  const int j0 = plan.cols[c], j1 = plan.cols[c + 1];
  const int p0 = plan.pos[c], np = plan.pos[c + 1] - p0;
  const int o0 = plan.outs[c], no = plan.outs[c + 1] - o0;
  const int S = a.stages, pcm = a.pc_max, ocm = a.oc_max;
  const int A8 = A / 8, E8 = E / 8;

  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + a.o_bar);
  int* s_outs = reinterpret_cast<int*>(smem + a.o_outs);
  bf16* s_h = reinterpret_cast<bf16*>(smem + a.o_h);
  float* s_dec = reinterpret_cast<float*>(smem + a.o_dec);     // RT x A
  float* s_gate = reinterpret_cast<float*>(smem + a.o_gate);   // RT x ocm
  float* s_sc = reinterpret_cast<float*>(smem + a.o_sc);       // RT x pcm
  float* s_ml = reinterpret_cast<float*>(smem + a.o_ml);       // RT x 16 x 2
  float* s_awe = reinterpret_cast<float*>(smem + a.o_awe);     // RT x C x ocm
  float* s_red = reinterpret_cast<float*>(smem + a.o_red);     // groups x E
  float* s_scale = reinterpret_cast<float*>(smem + a.o_scale); // RT x 16
  float* s_stat = reinterpret_cast<float*>(smem + a.o_stat);   // RT x 2
  bf16* s_stage = reinterpret_cast<bf16*>(smem + a.o_stage);

  stamp(a, a.stamps && blockIdx.x == 0 && tid == 0, T_ENTRY);
  if (tid <= C) s_outs[tid] = plan.outs[tid];
  // Once the first weights are requested: the ring's barriers, and the
  // copies of the first rows' encoder data, which do not depend on h (they
  // are waited for only after cluster barrier 1).
  auto start_ring = [&]() {
    if (tid != 0) return;
    for (int s = 0; s < S; ++s) mbar_init(&s_bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    stamp(a, a.stamps && blockIdx.x == 0, T_INIT);
    if (np > 0)
      for (int i = 0; i < S && i < nrows; ++i)
        load_row(a, row0 + i, p0, np, s_stage + (size_t)i * a.stage_elems,
                 &s_bar[i]);
    stamp(a, a.stamps && blockIdx.x == 0, T_ISSUED);
  };
  // v in registers, still packed (unpacking here would wait for the load
  // before the weights are requested): a lane's chunks a8 = lane + 32 kk.
  uint4 vr[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int a8 = lane + 32 * kk;
    vr[kk] = a8 < A8 ? __ldg(reinterpret_cast<const uint4*>(a.v + 8 * a8))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  // Tell the peers this CTA runs (project waits for theirs).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  for (int t0 = 0; t0 < nrows; t0 += a.row_tile) {
    const int nt = min(a.row_tile, nrows - t0);
    const bool clock = a.stamps && blockIdx.x == 0 && tid == 0 && t0 == 0;
    // 1. The CTA's columns of [dec | gate], pushed to their readers.
    if (t0 == 0)
      project<K>(cluster, a, j0, j1, row0, nt, true, s_h, s_dec, s_gate,
                 s_outs, start_ring);
    else
      project<K>(cluster, a, j0, j1, row0 + t0, nt, false, s_h, s_dec,
                 s_gate, s_outs, [] {});
    stamp(a, clock, T_PROJECT);
    cluster.sync();
    stamp(a, clock, T_BARRIER1);

    // 2. Scores, local softmax and partial attended sum, row by row, each
    //    pushed to the CTAs that combine them.
    for (int r = 0; r < nt; ++r) {
      const int i = t0 + r;  // the row's index in the cluster's rows
      if (np == 0) {  // a CTA without positions publishes an empty part
        if (lane < C && warp == 0) {
          float* ml = cluster.map_shared_rank(s_ml, lane);
          ml[(r * MAX_CLUSTER + c) * 2] = -INFINITY;
          ml[(r * MAX_CLUSTER + c) * 2 + 1] = 0.0f;
        }
        for (int e4 = tid; e4 < E / 4; e4 += THREADS) {
          const int q = owner(s_outs, 4 * e4, E, C);
          *reinterpret_cast<float4*>(cluster.map_shared_rank(s_awe, q) +
                                     (r * C + c) * ocm + 4 * e4 - s_outs[q]) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
        continue;
      }
      const int st = i % S;
      bf16* stage = s_stage + (size_t)st * a.stage_elems;
      float4 dv[K][2];  // this row's dec at the lane's chunks
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int a8 = lane + 32 * kk;
        const float4* src = reinterpret_cast<const float4*>(s_dec + r * A);
        dv[kk][0] = a8 < A8 ? src[2 * a8] : make_float4(0.f, 0.f, 0.f, 0.f);
        dv[kk][1] = a8 < A8 ? src[2 * a8 + 1] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      mbar_wait(&s_bar[st], (i / S) & 1);
      stamp(a, clock && r == 0, T_WAIT);

      for (int p = warp; p < np; p += WARPS) {
        const bf16* pr = stage + (size_t)p * A;
        float s = 0.0f;
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const int a8 = lane + 32 * kk;
          if (a8 < A8) {
            float x[8], vf[8];
            unpack8(*reinterpret_cast<const uint4*>(pr + 8 * a8), x);
            unpack8(vr[kk], vf);
            const float d[8] = {dv[kk][0].x, dv[kk][0].y, dv[kk][0].z,
                                dv[kk][0].w, dv[kk][1].x, dv[kk][1].y,
                                dv[kk][1].z, dv[kk][1].w};
#pragma unroll
            for (int k = 0; k < 8; ++k)
              s = fmaf(fmaxf(x[k] + d[k], 0.0f), vf[k], s);
          }
        }
        s = warp_sum(s);
        if (lane == 0) s_sc[r * pcm + p] = s;
      }
      __syncthreads();
      stamp(a, clock && r == 0, T_SCORES);

      // Every thread takes the local max itself; warp 0 also the sum.
      const float* sc = s_sc + r * pcm;
      float m = -INFINITY;
      for (int p = 0; p < np; ++p) m = fmaxf(m, sc[p]);
      if (warp == 0) {
        float sum = 0.0f;
        for (int p = lane; p < np; p += 32) sum += expf(sc[p] - m);
        sum = warp_sum(sum);
        if (lane < C) {
          float* ml = cluster.map_shared_rank(s_ml, lane);
          ml[(r * MAX_CLUSTER + c) * 2] = m;
          ml[(r * MAX_CLUSTER + c) * 2 + 1] = sum;
        }
      }
      stamp(a, clock && r == 0, T_SOFTMAX);

      const bf16* enc_s = stage + (size_t)pcm * A;
      for (int u = tid; u < a.groups * E8; u += THREADS) {
        const int ch = u % E8, grp = u / E8;
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int p = grp; p < np; p += a.groups) {
          const float wgt = expf(sc[p] - m);
          float x[8];
          unpack8(*reinterpret_cast<const uint4*>(enc_s + (size_t)p * E +
                                                   8 * ch),
                  x);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(wgt, x[k], acc[k]);
        }
        float* dst = s_red + grp * E + 8 * ch;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
      __syncthreads();  // the stage is consumed
      stamp(a, clock && r == 0, T_AWE);
      if (tid == 0 && i + S < nrows) {
        // Order this CTA's reads of the stage before the copy's writes.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_row(a, row0 + i + S, p0, np, stage, &s_bar[st]);
      }
      for (int e4 = tid; e4 < E / 4; e4 += THREADS) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int grp = 0; grp < a.groups; ++grp) {
          const float4 x = reinterpret_cast<const float4*>(s_red)[
              grp * (E / 4) + e4];
          s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
        }
        const int q = owner(s_outs, 4 * e4, E, C);
        *reinterpret_cast<float4*>(cluster.map_shared_rank(s_awe, q) +
                                   (r * C + c) * ocm + 4 * e4 - s_outs[q]) = s;
      }
    }
    stamp(a, clock, T_POSITIONS);
    cluster.sync();
    stamp(a, clock, T_BARRIER2);

    // 3. Combine the partials, now all in this CTA's shared memory: a
    //    warp per row takes its factors exp(m_c - m) / sum_c s_c exp(m_c -
    //    m), then out and alpha.
    for (int r = warp; r < nt; r += WARPS) {
      const float* ml = s_ml + r * MAX_CLUSTER * 2;
      const float mq = lane < C ? ml[2 * lane] : -INFINITY;
      const float sq = lane < C ? ml[2 * lane + 1] : 0.0f;
      const float m = warp_max(mq);
      const float f = lane < C ? expf(mq - m) : 0.0f;
      const float sum = warp_sum(sq * f);
      if (lane < C) s_scale[r * MAX_CLUSTER + lane] = f / sum;
      if (lane == 0) {
        s_stat[2 * r] = m;
        s_stat[2 * r + 1] = sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < nt * no; i += THREADS) {
      const int r = i / no, k = i % no;
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < C)
          acc = fmaf(s_awe[(r * C + q) * ocm + k],
                     s_scale[r * MAX_CLUSTER + q], acc);
      a.out[(size_t)(row0 + t0 + r) * E + o0 + k] = s_gate[r * ocm + k] * acc;
    }
    for (int i = tid; i < nt * np; i += THREADS) {
      const int r = i / np, p = i % np;
      a.alpha[(size_t)(row0 + t0 + r) * P + p0 + p] =
          expf(s_sc[r * pcm + p] - s_stat[2 * r]) / s_stat[2 * r + 1];
    }
    stamp(a, clock, T_COMBINE);
    // Before the next tile's pushes overwrite what the peers still read.
    if (t0 + a.row_tile < nrows) cluster.sync();
  }
}

// Crosses n cluster barriers. With `exchange`, each thread first reads a
// value its neighbour CTA wrote before the previous barrier and writes one
// for the next: a barrier plus a round trip through distributed shared
// memory per iteration.
__global__ void __launch_bounds__(THREADS)
    cluster_probe_kernel(int n, int exchange, float* sink) {
  __shared__ float slot[2][THREADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int peer = (cluster.block_rank() + 1) % cluster.num_blocks();
  const float* remote = cluster.map_shared_rank(&slot[0][0], peer);
  slot[0][threadIdx.x] = (float)threadIdx.x;
  slot[1][threadIdx.x] = 0.0f;
  float acc = 0.0f;
  cluster.sync();
  for (int i = 0; i < n; ++i) {
    if (exchange) {
      acc += remote[(i & 1) * THREADS + threadIdx.x];
      slot[(i + 1) & 1][threadIdx.x] = acc;
    }
    cluster.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = acc;
}

typedef void (*KernelFn)(Args, Plan);

KernelFn kernel_for(int kmax) {
  switch (kmax) {
    case 1: return attention_gate_kernel<1>;
    case 2: return attention_gate_kernel<2>;
    default: return attention_gate_kernel<4>;
  }
}

// Lays out the dynamic shared memory for a's row tile and stages; returns
// its bytes.
size_t layout(Args* a) {
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o = (o + bytes + 15) & ~(size_t)15;
    return (int)at;
  };
  const size_t rt = a->row_tile;
  a->o_bar = take(8 * (size_t)a->stages);
  a->o_outs = take(4 * (MAX_CLUSTER + 1));
  a->o_h = take(2 * rt * a->Dp);
  a->o_dec = take(4 * rt * a->A);
  a->o_gate = take(4 * rt * a->oc_max);
  a->o_sc = take(4 * rt * a->pc_max);
  a->o_ml = take(8 * rt * MAX_CLUSTER);
  a->o_awe = take(4 * rt * a->C * a->oc_max);
  a->o_red = take(4 * (size_t)a->groups * a->E);
  a->o_scale = take(4 * rt * MAX_CLUSTER);
  a->o_stat = take(8 * rt);
  a->stage_elems = a->pc_max * (a->A + a->E);
  a->o_stage = take(2 * (size_t)a->stage_elems * a->stages);
  return o;
}

// The launch's Args (without pointers) and shared memory from `dims`;
// sets the kernel's attributes. Returns a CUDA error code.
int prepare(const int* dims, Args* a, size_t* smem) {
  *a = Args{};
  a->B = dims[D_B]; a->P = dims[D_P]; a->E = dims[D_E]; a->A = dims[D_A];
  a->D = dims[D_D]; a->C = dims[D_C]; a->h_f32 = dims[D_HF32];
  if (a->C < 1 || a->C > MAX_CLUSTER || a->P < 1 || a->E < 8 || a->A < 8 ||
      a->D < 1 || a->E % 8 || a->A % 8)
    return (int)cudaErrorInvalidValue;
  a->Dp = (a->D + 7) / 8 * 8;
  // 16-byte chunks per lane of a weight column and of v: 256 values each.
  const int width = a->Dp > a->A ? a->Dp : a->A;
  a->kmax = width <= 256 ? 1 : width <= 512 ? 2 : width <= 1024 ? 4 : 0;
  if (!a->kmax) return (int)cudaErrorInvalidValue;
  a->pc_max = (a->P + a->C - 1) / a->C;
  // Output columns in whole groups of 4 (16-byte stores between CTAs).
  a->oc_max = 4 * ((a->E / 4 + a->C - 1) / a->C);
  const int per_pass = THREADS / (a->E / 8);
  a->groups = per_pass < 1 ? 1 : (per_pass < a->pc_max ? per_pass : a->pc_max);
  static const int choices[][2] = {{16, 3}, {16, 2}, {8, 2}, {8, 1},
                                   {4, 1},  {2, 1},  {1, 1}};
  *smem = 0;
  for (const auto& ch : choices) {
    a->row_tile = ch[0];
    a->stages = ch[1];
    const size_t bytes = layout(a);
    if (bytes <= MAX_SMEM) {
      *smem = bytes;
      break;
    }
  }
  if (!*smem) return (int)cudaErrorInvalidValue;
  // The attributes are set once per kernel and size, not on every launch.
  static size_t set_bytes[5] = {0, 0, 0, 0, 0};
  if (set_bytes[a->kmax] >= *smem) return 0;
  const KernelFn fn = kernel_for(a->kmax);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)fn,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) set_bytes[a->kmax] = *smem;
  return (int)err;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int ctas, int cluster, size_t smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

bool ascending(const int* s, int n, int last, int most, int multiple) {
  if (s[0] != 0 || s[n] != last) return false;
  for (int i = 0; i < n; ++i)
    if (s[i + 1] < s[i] || s[i + 1] - s[i] > most || s[i] % multiple)
      return false;
  return true;
}

}  // namespace

extern "C" {

// The launch configuration for dims (D_B and D_G are not read): out[0] the
// clusters of C CTAs the card holds at once (cudaOccupancyMaxActiveClusters),
// out[1] the dynamic shared memory of a CTA in bytes, out[2] the row tile,
// out[3] the stages of the encoder ring, out[4] the threads of a CTA,
// out[5] the 16-byte chunks of a weight column per lane. Returns a CUDA
// error code.
int sd_attention_config(const int* dims, int* out) {
  cudaGetLastError();
  Args a;
  size_t smem;
  int err = prepare(dims, &a, &smem);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, a.C, a.C, smem, nullptr);
  int clusters = 0;
  err = (int)cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)kernel_for(a.kmax), &cfg);
  if (err) return err;
  out[0] = clusters;
  out[1] = (int)smem;
  out[2] = a.row_tile;
  out[3] = a.stages;
  out[4] = THREADS;
  out[5] = a.kmax;
  return 0;
}

// One launch of G clusters of C CTAs. ptrs in `enum Ptr` order: enc (B, P,
// E) and proj (B, P, A) bfloat16, contiguous, 16-byte aligned; h (B, D),
// float32 if dims[D_HF32] else bfloat16; m1 (A + E, Dp), bias (A + E) and v
// (A) as pack_attention_weights lays them out; out (B, E) and alpha (B, P)
// float32; stamps null, or N_STAMPS int64 for the phase clock. plan: rows
// (G + 1), then cols, pos and outs (C + 1 each), as
// attention_plan returns them. Returns the CUDA error code of the launch.
int sd_attention_gate(void* const* ptrs, const int* dims, const int* plan,
                      void* stream) {
  cudaGetLastError();  // report this launch's error, not an earlier one
  Args a;
  size_t smem;
  int err = prepare(dims, &a, &smem);
  if (err) return err;
  const int G = dims[D_G], C = a.C;
  if (G < 1 || G > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  Plan pl;
  for (int i = 0; i <= G; ++i) pl.rows[i] = plan[i];
  for (int i = 0; i <= C; ++i) {
    pl.cols[i] = plan[G + 1 + i];
    pl.pos[i] = plan[G + 1 + (C + 1) + i];
    pl.outs[i] = plan[G + 1 + 2 * (C + 1) + i];
  }
  if (!ascending(pl.rows, G, a.B, a.B, 1) ||
      !ascending(pl.cols, C, a.A + a.E, a.A + a.E, 1) ||
      !ascending(pl.pos, C, a.P, a.pc_max, 1) ||
      !ascending(pl.outs, C, a.E, a.oc_max, 4))
    return (int)cudaErrorInvalidValue;
  a.enc = static_cast<const bf16*>(ptrs[P_ENC]);
  a.proj = static_cast<const bf16*>(ptrs[P_PROJ]);
  a.h = ptrs[P_H];
  a.m1 = static_cast<const bf16*>(ptrs[P_M1]);
  a.bias = static_cast<const bf16*>(ptrs[P_BIAS]);
  a.v = static_cast<const bf16*>(ptrs[P_V]);
  a.out = static_cast<float*>(ptrs[P_OUT]);
  a.alpha = static_cast<float*>(ptrs[P_ALPHA]);
  a.stamps = static_cast<long long*>(ptrs[P_STAMPS]);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, G * C, C, smem, stream);
  void* args[] = {&a, &pl};
  err = (int)cudaLaunchKernelExC(&cfg, (const void*)kernel_for(a.kmax), args);
  if (err) return err;
  return (int)cudaGetLastError();
}

// One launch of G clusters of C CTAs that crosses n cluster barriers (with
// `exchange`, each preceded by a read of the neighbour CTA's shared memory);
// sink: one float32 on the card. Returns the CUDA error code.
int sd_cluster_probe(int n, int cluster, int G, int exchange, void* sink,
                     void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)cluster_probe_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, G * cluster, cluster, 0, stream);
  float* s = static_cast<float*>(sink);
  void* args[] = {&n, &exchange, &s};
  err = cudaLaunchKernelExC(&cfg, (const void*)cluster_probe_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
