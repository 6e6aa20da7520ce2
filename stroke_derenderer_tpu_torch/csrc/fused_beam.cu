// K2: the whole beam search of the stroke decoder in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `_fused_beam_decode_tpu` of
// stroke_derenderer_tpu/kernels/fused_beam.py. One block per image owns its
// K beams, which share the image's encoder sequence. Each step of each
// beam does what K1 (csrc/fused_decode.cu) does for a greedy row: additive
// attention over the P encoder positions, the gated attended vector, an
// LSTM step and the float32 vocabulary head. Then, per beam, the float32
// log-softmax; a finished beam may only extend with PAD, at its frozen
// score; `total = score + logp`; the top K of the K x V totals (largest
// first, ties to the lowest flat index, as lax.top_k); and the beams are
// reordered by parent. Output: every beam's tokens, score and length.
//
// What bounds it on an H100: as for K1, the weights' trip through the
// memory system. A block-step streams about 8 MB of weights (bfloat16 plus
// the float32 head) and the image's 0.4 MB of encoder data, for about
// 8.2 MFLOP per beam; far too few operations per byte for the tensor cores.
// The weights stay resident in the 50 MB L2 cache across steps.
//
// Design (simple first, as K1):
//   * one launch per decode call; one block per image runs the whole step
//     loop; blocks never talk to each other (no grid sync, no atomics, no
//     spin-wait), so nothing can deadlock whatever the number of blocks;
//   * the beams are processed in groups of up to GROUP = 8: a thread owns
//     one output column of a matrix-vector product and keeps GROUP sums in
//     registers, so one read of a weight serves the group; in the attention
//     the image's encoder rows are read once for the group. At K <= 8 (the
//     shipped K is 5) each block-step reads the weights once;
//   * per beam, only h, c (float32, holding values of the stream type) and
//     the K x V totals persist in shared memory; the group's scratch ([emb;
//     awe], scores, gate pre-activations) is reused from group to group.
//     At the shipped widths that is 137 KB of dynamic shared memory at
//     K = 5 and 200 KB at K = 16, the largest K taken (MAX_BEAM);
//   * top-K is K rounds of a block-wide argmax that keeps the lowest index;
//   * instead of gathering every beam's token row at every step (the TPU
//     kernel's one-hot matmul), each step stores each beam's parent and
//     written token in global scratch; the rows are traced back once at the
//     end. h and c are reordered column by column in registers;
//   * a block stops as soon as all its beams have finished.
//
// Rounding is K1's and matches the PyTorch step in models/decoder.py:
// products, the attention softmax and the attended sum in float64, rounded
// once at flax's points; the log-softmax sums its exponentials in float64.
// Elementwise float32 arithmetic that must round after each operation uses
// the _rn intrinsics, so that the compiler cannot contract it into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int GROUP = 8;      // beams per pass over the weights
constexpr int MAX_BEAM = 16;  // largest K taken
constexpr int THREADS = 512;  // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int PAD_TOK = 0;
constexpr int BOS_TOK = 1;
constexpr int EOS_TOK = 2;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// A float64 sum rounded to T the way PyTorch's cast does it: to float32
// first, then to T.
template <typename T> __device__ __forceinline__ float rnd64(double x) {
  return rnd<T>((float)x);
}
template <typename T> __device__ __forceinline__ float sig(float x) {
  return rnd<T>(1.0f / (1.0f + expf(-x)));
}
template <typename T> __device__ __forceinline__ float tnh(float x) {
  return rnd<T>(tanhf(x));
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_maxf(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// (value, index) of the larger, ties to the lower index; index -1 = none.
__device__ __forceinline__ void arg_better(float& best, int& bi, float ov,
                                           int oi) {
  if (oi >= 0 && (bi < 0 || ov > best || (ov == best && oi < bi))) {
    best = ov;
    bi = oi;
  }
}

// acc[r] = sum_k x[r][k] * w[k * ldw] in float64 for the group's GROUP
// rows (rows at or past nr repeat row 0): the caller points w at its
// column. x rows are float32, 16-byte aligned, ldx and K multiples of 4.
template <typename W>
__device__ __forceinline__ void matvec(const float* __restrict__ x, int ldx,
                                       int nr, int K,
                                       const W* __restrict__ w, int ldw,
                                       double (&acc)[GROUP]) {
  const float* xr[GROUP];
#pragma unroll
  for (int r = 0; r < GROUP; ++r) {
    acc[r] = 0.0;
    xr[r] = x + (r < nr ? r : 0) * ldx;
  }
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const double w0 = ldf(w + (size_t)k * ldw);
    const double w1 = ldf(w + (size_t)(k + 1) * ldw);
    const double w2 = ldf(w + (size_t)(k + 2) * ldw);
    const double w3 = ldf(w + (size_t)(k + 3) * ldw);
#pragma unroll
    for (int r = 0; r < GROUP; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(xr[r] + k);
      acc[r] = fma((double)xv.x, w0, acc[r]);
      acc[r] = fma((double)xv.y, w1, acc[r]);
      acc[r] = fma((double)xv.z, w2, acc[r]);
      acc[r] = fma((double)xv.w, w3, acc[r]);
    }
  }
}

struct Dims {
  int B, P, E, A, H, D, V, K, max_length;
  int X;    // D + E: LSTM input width
  int G;    // 4H: gate width
  int Pp;   // P rounded up to 4
  int Vp;   // V rounded up to 4
  int GW;   // group scratch row: max(4H, A + E)
};

__host__ __device__ inline Dims make_dims(int B, int P, int E, int A, int H,
                                          int D, int V, int K,
                                          int max_length) {
  Dims d{B, P, E, A, H, D, V, K, max_length, D + E, 4 * H, (P + 3) & ~3,
         (V + 3) & ~3, 0};
  d.GW = d.G > A + E ? d.G : A + E;
  return d;
}

// Dynamic shared memory: doubles first (alignment), then float32 arrays
// whose row lengths are multiples of 4 (16-byte aligned rows).
__host__ __device__ inline size_t smem_bytes(const Dims& d) {
  return sizeof(double) * (size_t)GROUP * d.Pp +
         sizeof(float) * ((size_t)2 * d.K * d.H + (size_t)d.K * d.Vp +
                          (size_t)GROUP * (d.X + d.GW));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) beam_decode_kernel(
    const T* __restrict__ enc, const T* __restrict__ proj,
    const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ watt, const T* __restrict__ batt,
    const T* __restrict__ v, const T* __restrict__ bv,
    const T* __restrict__ wf, const T* __restrict__ bf,
    const T* __restrict__ wx, const T* __restrict__ wh,
    const T* __restrict__ blstm, const T* __restrict__ emb,
    const float* __restrict__ wfc, const float* __restrict__ bfc,
    int* __restrict__ preds, float* __restrict__ score_out,
    int* __restrict__ lens_out, int* __restrict__ bp_parent,
    int* __restrict__ bp_write, Dims d) {
  extern __shared__ double2 smem2[];
  const int P = d.P, E = d.E, A = d.A, H = d.H, D = d.D, V = d.V, K = d.K;
  const int X = d.X, G = d.G, Pp = d.Pp, Vp = d.Vp, GW = d.GW;
  double* s_sc = reinterpret_cast<double*>(smem2);  // GROUP x Pp
  float* s_h = reinterpret_cast<float*>(s_sc + GROUP * Pp);  // K x H
  float* s_c = s_h + K * H;                                  // K x H
  float* s_tot = s_c + K * H;      // K x Vp: logits, then totals
  float* s_x = s_tot + K * Vp;     // GROUP x X: [emb | awe]
  float* s_g = s_x + GROUP * X;    // GROUP x GW: [dp | gate], then gates
  __shared__ int s_tok[MAX_BEAM];  // token each beam embeds next
  __shared__ float s_score[MAX_BEAM];
  __shared__ int s_fin[MAX_BEAM];
  __shared__ int s_len[MAX_BEAM];
  __shared__ int s_par[MAX_BEAM];   // this step's parents
  __shared__ int s_new[MAX_BEAM];   // this step's tokens
  __shared__ float s_val[MAX_BEAM];
  __shared__ float s_rv[WARPS];
  __shared__ int s_ri[WARPS];
  __shared__ int s_done;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const T* enc_b = enc + (size_t)b * P * E;
  const T* proj_b = proj + (size_t)b * P * A;
  int* par_b = bp_parent + (size_t)b * d.max_length * K;
  int* wr_b = bp_write + (size_t)b * d.max_length * K;

  for (int i = tid; i < K * H; i += THREADS) {
    s_h[i] = ldf(h0 + (size_t)b * H + i % H);
    s_c[i] = ldf(c0 + (size_t)b * H + i % H);
  }
  if (tid < K) {
    s_tok[tid] = BOS_TOK;
    s_score[tid] = tid == 0 ? 0.0f : NEG_INF;  // only beam 0 is live
    s_fin[tid] = 0;
    s_len[tid] = 0;
  }
  if (tid == 0) s_done = 0;
  __syncthreads();

  int t = 0;
  for (; t < d.max_length && !s_done; ++t) {
    for (int g0 = 0; g0 < K; g0 += GROUP) {
      const int nr = min(GROUP, K - g0);
      float* hg = s_h + g0 * H;  // the group's h and c
      float* cg = s_c + g0 * H;

      // 1. From h: the attention projection h Watt + b and the gate.
      for (int col = tid; col < A + E; col += THREADS) {
        double acc[GROUP];
        if (col < A) {
          matvec(hg, H, nr, H, watt + col, A, acc);
          const float bb = ldf(batt + col);
#pragma unroll
          for (int r = 0; r < GROUP; ++r)
            if (r < nr) s_g[r * GW + col] = rnd<T>(rnd64<T>(acc[r]) + bb);
        } else {
          const int e = col - A;
          matvec(hg, H, nr, H, wf + e, E, acc);
          const float bb = ldf(bf + e);
#pragma unroll
          for (int r = 0; r < GROUP; ++r)
            if (r < nr)
              s_g[r * GW + col] = sig<T>(rnd<T>(rnd64<T>(acc[r]) + bb));
        }
      }
      __syncthreads();

      // 2. Scores v . relu(enc_proj + h Watt + b) + bv: a warp per
      //    position, which reads the position's projection once for the
      //    group.
      const float bvv = ldf(bv);
      for (int p = warp; p < P; p += WARPS) {
        const T* pp = proj_b + (size_t)p * A;
        double s[GROUP];
#pragma unroll
        for (int r = 0; r < GROUP; ++r) s[r] = 0.0;
        for (int a = lane; a < A; a += 32) {
          const float pv = ldf(pp + a);
          const double vv = ldf(v + a);
#pragma unroll
          for (int r = 0; r < GROUP; ++r)
            if (r < nr)
              s[r] = fma((double)fmaxf(rnd<T>(pv + s_g[r * GW + a]), 0.0f),
                         vv, s[r]);
        }
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          if (r < nr) {
            const double tot = warp_sum(s[r]);
            if (lane == 0) s_sc[r * Pp + p] = rnd<T>(rnd64<T>(tot) + bvv);
          }
        }
      }
      __syncthreads();

      // 3. Softmax over the positions, a warp per beam, in float64.
      if (warp < nr) {
        double* sc = s_sc + warp * Pp;
        double m = -INFINITY;
        for (int p = lane; p < P; p += 32) m = fmax(m, sc[p]);
        m = warp_max(m);
        double sum = 0.0;
        for (int p = lane; p < P; p += 32) {
          const double ex = exp(sc[p] - m);
          sc[p] = ex;
          sum += ex;
        }
        sum = warp_sum(sum);
        for (int p = lane; p < P; p += 32) sc[p] = sc[p] / sum;
      }
      __syncthreads();

      // 4. Attended vector sum_p alpha enc in float64 (each encoder value
      //    read once for the group), times the gate, rounded into the awe
      //    half of x; the embedding of each beam's token into the other.
      for (int e = tid; e < E; e += THREADS) {
        double acc[GROUP];
#pragma unroll
        for (int r = 0; r < GROUP; ++r) acc[r] = 0.0;
        for (int p = 0; p < P; ++p) {
          const double ev = ldf(enc_b + (size_t)p * E + e);
#pragma unroll
          for (int r = 0; r < GROUP; ++r)
            if (r < nr) acc[r] = fma(s_sc[r * Pp + p], ev, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < GROUP; ++r)
          if (r < nr)
            s_x[r * X + D + e] =
                rnd64<T>((double)s_g[r * GW + A + e] * acc[r]);
      }
      for (int i = tid; i < nr * D; i += THREADS) {
        const int r = i / D, j = i % D;
        s_x[r * X + j] = ldf(emb + (size_t)s_tok[g0 + r] * D + j);
      }
      __syncthreads();

      // 5. LSTM pre-activations x Wx + (h Wh + b) (the attention scratch
      //    in s_g is spent).
      for (int n = tid; n < G; n += THREADS) {
        double acc[GROUP];
        float ax[GROUP];
        matvec(s_x, X, nr, X, wx + n, G, acc);
#pragma unroll
        for (int r = 0; r < GROUP; ++r) ax[r] = rnd64<T>(acc[r]);
        matvec(hg, H, nr, H, wh + n, G, acc);
        const float bb = ldf(blstm + n);
#pragma unroll
        for (int r = 0; r < GROUP; ++r)
          if (r < nr)
            s_g[r * GW + n] = rnd<T>(ax[r] + rnd<T>(rnd64<T>(acc[r]) + bb));
      }
      __syncthreads();

      // 6. Cell update, in place.
      for (int i = tid; i < nr * H; i += THREADS) {
        const int r = i / H, j = i % H;
        const float* g = s_g + r * GW;
        const float ig = sig<T>(g[j]);
        const float fg = sig<T>(g[H + j]);
        const float gg = tnh<T>(g[2 * H + j]);
        const float og = sig<T>(g[3 * H + j]);
        const float c = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(fg, cg[i])),
                                         rnd<T>(__fmul_rn(ig, gg))));
        cg[i] = c;
        hg[i] = rnd<T>(__fmul_rn(og, tnh<T>(c)));
      }
      __syncthreads();

      // 7. Vocabulary head in float32.
      for (int n = tid; n < V; n += THREADS) {
        double acc[GROUP];
        matvec(hg, H, nr, H, wfc + n, V, acc);
        const float bb = ldf(bfc + n);
#pragma unroll
        for (int r = 0; r < GROUP; ++r)
          if (r < nr) s_tot[(g0 + r) * Vp + n] = __fadd_rn((float)acc[r], bb);
      }
      __syncthreads();

      // 8. Log-softmax (x - max, then - log(sum exp) with the sum in
      //    float64), the finished-beam rule and total = score + logp.
      if (warp < nr) {
        const int k = g0 + warp;
        float* lg = s_tot + k * Vp;
        float m = -INFINITY;
        for (int n = lane; n < V; n += 32) m = fmaxf(m, lg[n]);
        m = warp_maxf(m);
        double sum = 0.0;
        for (int n = lane; n < V; n += 32) sum += exp((double)(lg[n] - m));
        sum = warp_sum(sum);
        const float lse = (float)log(sum);
        const float sc = s_score[k];
        const int fin = s_fin[k];
        for (int n = lane; n < V; n += 32) {
          const float lp = fin ? (n == PAD_TOK ? 0.0f : NEG_INF)
                               : __fsub_rn(__fsub_rn(lg[n], m), lse);
          lg[n] = __fadd_rn(sc, lp);
        }
      }
      __syncthreads();
    }

    // 9. Top K of the K x V totals: K rounds of a block-wide argmax (ties
    //    to the lowest flat index k * V + n), masking each pick.
    for (int j = 0; j < K; ++j) {
      float best = 0.0f;
      int bi = -1;
      for (int k = 0; k < K; ++k)  // flat indices rise along each thread
        for (int n = tid; n < V; n += THREADS)
          arg_better(best, bi, s_tot[k * Vp + n], k * V + n);
      for (int o = 16; o > 0; o >>= 1)
        arg_better(best, bi, __shfl_xor_sync(0xffffffffu, best, o),
                   __shfl_xor_sync(0xffffffffu, bi, o));
      if (lane == 0) {
        s_rv[warp] = best;
        s_ri[warp] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < WARPS; ++w) arg_better(best, bi, s_rv[w], s_ri[w]);
        s_par[j] = bi / V;
        s_new[j] = bi % V;
        s_val[j] = best;
        s_tot[(bi / V) * Vp + bi % V] = NEG_INF;
      }
      __syncthreads();
    }

    // 10. Reorder the beams by parent: back-pointers, state, h and c.
    int fin_j = 0, len_j = 0;
    if (tid < K) {
      const int par = s_par[tid];
      const int tok = s_new[tid];
      const int fp = s_fin[par];
      par_b[(size_t)t * K + tid] = par;
      wr_b[(size_t)t * K + tid] = fp ? PAD_TOK : tok;
      fin_j = fp || tok == EOS_TOK;
      len_j = fp ? s_len[par] : s_len[par] + 1;
    }
    for (int col = tid; col < 2 * H; col += THREADS) {
      float* base = col < H ? s_h + col : s_c + (col - H);
      float tmp[MAX_BEAM];
#pragma unroll
      for (int j = 0; j < MAX_BEAM; ++j)
        if (j < K) tmp[j] = base[s_par[j] * H];
#pragma unroll
      for (int j = 0; j < MAX_BEAM; ++j)
        if (j < K) base[j * H] = tmp[j];
    }
    __syncthreads();
    if (tid < K) {
      s_fin[tid] = fin_j;
      s_len[tid] = len_j;
      s_score[tid] = s_val[tid];
      s_tok[tid] = s_new[tid];
    }
    __syncthreads();
    if (tid == 0) {
      int all = 1;
      for (int k = 0; k < K; ++k) all &= s_fin[k];
      s_done = all;
    }
    __syncthreads();
  }

  // Trace every beam's tokens back through the parents; later positions
  // keep the PAD the caller filled in.
  if (tid < K) {
    int cur = tid;
    int* row = preds + ((size_t)b * K + tid) * d.max_length;
    for (int s = t - 1; s >= 0; --s) {
      row[s] = wr_b[(size_t)s * K + cur];
      cur = par_b[(size_t)s * K + cur];
    }
    score_out[(size_t)b * K + tid] = s_score[tid];
    lens_out[(size_t)b * K + tid] = s_len[tid];
  }
}

template <typename T>
int launch(const void* const* ptrs, int* preds, float* score, int* lens,
           int* bp_parent, int* bp_write, const Dims& d,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      beam_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_decode_kernel<T><<<d.B, THREADS, smem, stream>>>(
      (const T*)ptrs[0], (const T*)ptrs[1], (const T*)ptrs[2],
      (const T*)ptrs[3], (const T*)ptrs[4], (const T*)ptrs[5],
      (const T*)ptrs[6], (const T*)ptrs[7], (const T*)ptrs[8],
      (const T*)ptrs[9], (const T*)ptrs[10], (const T*)ptrs[11],
      (const T*)ptrs[12], (const T*)ptrs[13], (const float*)ptrs[14],
      (const float*)ptrs[15], preds, score, lens, bp_parent, bp_write, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, for the caller's check.
size_t sd_fused_beam_smem(int K, int P, int E, int A, int H, int D, int V) {
  return smem_bytes(make_dims(1, P, E, A, H, D, V, K, 1));
}

// dtype: 0 = float32 stream, 1 = bfloat16 stream (wfc, bfc are float32 in
// both). preds (B, K, max_length) int32 must hold PAD already; score (B, K)
// float32 and lens (B, K) int32 are written; bp_parent and bp_write are
// (B, max_length, K) int32 scratch. 1 <= K <= 16; E, A, H, D multiples of
// 4. Returns the CUDA error code of the launch (0 on success).
int sd_fused_beam_decode(int dtype, const void* enc, const void* proj,
                         const void* h0, const void* c0, const void* watt,
                         const void* batt, const void* v, const void* bv,
                         const void* wf, const void* bf, const void* wx,
                         const void* wh, const void* blstm, const void* emb,
                         const void* wfc, const void* bfc, void* preds,
                         void* score, void* lens, void* bp_parent,
                         void* bp_write, int B, int P, int E, int A, int H,
                         int D, int V, int K, int max_length, void* stream) {
  cudaGetLastError();  // report this launch's error, not an earlier one
  if (K < 1 || K > MAX_BEAM) return (int)cudaErrorInvalidValue;
  const void* ptrs[16] = {enc, proj, h0, c0, watt, batt, v, bv,
                          wf, bf, wx, wh, blstm, emb, wfc, bfc};
  const Dims d = make_dims(B, P, E, A, H, D, V, K, max_length);
  auto s = static_cast<cudaStream_t>(stream);
  auto pr = static_cast<int*>(preds);
  auto sc = static_cast<float*>(score);
  auto ln = static_cast<int*>(lens);
  auto bp = static_cast<int*>(bp_parent);
  auto bw = static_cast<int*>(bp_write);
  if (dtype == 0) return launch<float>(ptrs, pr, sc, ln, bp, bw, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ptrs, pr, sc, ln, bp, bw, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
