// The decode step engine shared by K1 (csrc/fused_decode.cu, greedy) and
// K2 (csrc/fused_beam.cu, beam search): one persistent cooperative launch
// per decode call, whose blocks split every step's work over the whole card
// and meet at grid-wide barriers.
//
// What bounds a step on an H100: it streams about 8.7 MB of weights (7.3 MB
// in bfloat16 plus the 0.9 MB float32 head) and 0.4 MB of encoder data per
// row, for about 8.3 MFLOP per row: far too few operations per byte for the
// tensor cores, and far too little work per step to hide the latency of one
// SM streaming all of it. So no SM streams all of it: each block owns a
// slice of the output columns of every matrix (about 66 KB of weights at 132
// blocks, which stay resident in the 50 MB L2 cache across steps) and the
// step is cut into four phases separated by `grid.sync()`:
//
//   A  from h: the owned columns of the head ([W_att | W_f] (H x (A+E)) and
//      the float32 W_fc (H x V)): dp = h W_att + b, gate = sigmoid(h W_f +
//      b_f) for the next step, and the logits of the step just finished;
//   B  (K1: every block takes the argmax of every row redundantly, in the
//      same order, so that all blocks agree on which rows retire and leave
//      the loop together; K2: a separate phase and barrier picks the beams)
//      then the scores v . relu(enc_proj + dp) + b_v, a warp per (row,
//      position) pair over the whole grid;
//   C  the softmax over the positions (recomputed by each block for the
//      rows it needs) and the attended sum alpha . enc times the gate, over
//      (row, 32 encoder columns) units;
//   D  the LSTM: a block owns whole units j, i.e. the gate columns j, H+j,
//      2H+j and 3H+j of [W_x; W_h] ((D+E+H) x 4H), so it updates the cell of
//      unit j with no further barrier.
//
// The ownership plan (which head columns and which units each block owns)
// is computed on the host (kernels/fused_decode.py:step_plan) and passed in
// as two int32 arrays. Weights are packed once per model
// (pack_step_weights): each output column's K values contiguous and padded
// to a multiple of 8, so that a warp reads a column with 16-byte loads, each
// lane taking every 32nd chunk of the reduction, and combines its lanes with
// a fixed xor butterfly (every lane ends with the same sum).
//
// State that lives across barriers (h and c, double-buffered; dp, gate,
// scores, the attended vector, the logits; K2's beam state) is global
// scratch that the wrapper allocates, as is each block's own list of active
// rows. The shared state is written inside the kernel, so it is never read through __ldg or a const __restrict__
// pointer: a non-coherent load could return a stale value after grid.sync().
// Only the weights and the encoder inputs are read through __ldg.
//
// Every block reaches every grid.sync(): loops whose bounds differ between
// blocks never contain one, and the decision to stop is taken by every block
// from identical data.
//
// Rows are processed in tiles of at most TILE = 8: for each tile the block
// stages the tile's inputs in shared memory (as float32, which holds values
// of the stream type exactly) and each warp keeps one float64 sum per row
// while it streams a weight column, so one weight read serves the tile.
// There is no limit on the number of rows.
//
// Rounding (the contract of models/decoder.py): products, the attention
// softmax and the attended sum in float64, rounded once at flax's points;
// elementwise float32 arithmetic through the _rn intrinsics so that the
// compiler cannot contract it into an FMA.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace sd {

namespace cg = cooperative_groups;

constexpr int THREADS = 512;  // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 8;        // rows per pass over a weight column
constexpr int UNIT_CHUNK = 16; // LSTM units per pass of phase D
constexpr int PAD_TOK = 0;
constexpr int BOS_TOK = 1;
constexpr int EOS_TOK = 2;
constexpr float NEG_INF = -1e30f;

// Order of the pointer array the C entry points take; the wrapper
// (kernels/fused_decode.py:STEP_POINTERS) passes them in this order.
enum Ptr {
  P_ENC, P_PROJ, P_H0, P_C0,                    // inputs
  P_M1, P_FC, P_M3,                             // packed weights
  P_BATT, P_V, P_BV, P_BF, P_BLSTM, P_EMB, P_BFC,
  P_HEAD_START, P_UNIT_START,                   // ownership plan
  P_H, P_C, P_DP, P_GATE, P_SC, P_AWE, P_LOGITS, P_ROWS,  // scratch
  P_TOK, P_PARENT, P_SCORE, P_FIN, P_LEN, P_DONE, P_STEPS,  // beam state
  P_BP_PARENT, P_BP_WRITE,
  P_PREDS, P_SCORE_OUT, P_LENS_OUT,             // outputs
  P_STAMPS,                                     // optional phase clock
  N_PTR
};
// Order of the int array of dimensions.
enum Dim { D_B, D_P, D_E, D_A, D_H, D_D, D_V, D_K, D_MAX_LENGTH, N_DIM };

struct Dims {
  int B, P, E, A, H, D, V, K, max_length;
  int R;    // rows: B * K
  int X;    // D + E
  int Xp;   // X rounded up to 8
  int Hp;   // H rounded up to 8
  int Pp;   // P rounded up to 4
  int LDX;  // Xp + Hp: a staged LSTM input row, and a packed W_x|W_h column
  int NH;   // A + E + V head columns
};

inline Dims make_dims(const int* v) {
  Dims d;
  d.B = v[D_B]; d.P = v[D_P]; d.E = v[D_E]; d.A = v[D_A]; d.H = v[D_H];
  d.D = v[D_D]; d.V = v[D_V]; d.K = v[D_K]; d.max_length = v[D_MAX_LENGTH];
  d.R = d.B * d.K;
  d.X = d.D + d.E;
  d.Xp = (d.X + 7) & ~7;
  d.Hp = (d.H + 7) & ~7;
  d.Pp = (d.P + 3) & ~3;
  d.LDX = d.Xp + d.Hp;
  d.NH = d.A + d.E + d.V;
  return d;
}

template <typename T>
struct Params {
  const T* enc;     // (B, P, E)
  const T* proj;    // (B, P, A)
  const T* h0;      // (B, H)
  const T* c0;      // (B, H)
  const T* m1;      // (A + E, Hp): W_att columns, then W_f columns
  const float* fc;  // (V, Hp): W_fc columns
  const T* m3;      // (4H, LDX): row 4j + g = gate g of unit j, [W_x | W_h]
  const T* batt;
  const T* v;
  const T* bv;
  const T* bf;
  const T* blstm;
  const T* emb;     // (V, D)
  const float* bfc;
  const int* head_start;  // (grid + 1): block b owns head columns
                          // [head_start[b], head_start[b + 1])
  const int* unit_start;  // (grid + 1): ... and units [unit_start[b], ...)
  float* h;       // (2, R, Hp), double-buffered by step parity
  float* c;       // (2, R, H)
  float* dp;      // (R, A)
  float* gate;    // (R, E)
  float* sc;      // (R, Pp)
  float* awe;     // (R, E)
  float* logits;  // (R, V); K2 turns them into totals in place
  int* rows;      // (grid, 2R): each block's list of active rows, and (K1)
                  // each row's next token
  int* tok;       // K2 (R): the token each beam embeds next
  int* parent;    // K2 (R): the row whose state each beam continues
  float* score;   // K2 (R)
  int* fin;       // K2 (R)
  int* len;       // K2 (R)
  int* done;      // K2 (B): all the image's beams have finished
  int* steps;     // K2 (B): steps the image took
  int* bp_parent; // K2 (B, max_length, K)
  int* bp_write;  // K2 (B, max_length, K)
  int* preds;     // K1 (B, max_length); K2 (B, K, max_length); hold PAD
  float* score_out;  // K2 (B, K)
  int* lens_out;     // K2 (B, K)
  // Optional (null: off): block 0 writes the global timer (ns) after each
  // grid barrier: [0] at the start, [1] after the set-up, [2] after the
  // prologue, then 2 + t * phases + i after phase i of step t.
  unsigned long long* stamps;
  Dims d;
};

template <typename T>
Params<T> make_params(const void* const* p, const Dims& d) {
  Params<T> q;
  q.enc = (const T*)p[P_ENC];
  q.proj = (const T*)p[P_PROJ];
  q.h0 = (const T*)p[P_H0];
  q.c0 = (const T*)p[P_C0];
  q.m1 = (const T*)p[P_M1];
  q.fc = (const float*)p[P_FC];
  q.m3 = (const T*)p[P_M3];
  q.batt = (const T*)p[P_BATT];
  q.v = (const T*)p[P_V];
  q.bv = (const T*)p[P_BV];
  q.bf = (const T*)p[P_BF];
  q.blstm = (const T*)p[P_BLSTM];
  q.emb = (const T*)p[P_EMB];
  q.bfc = (const float*)p[P_BFC];
  q.head_start = (const int*)p[P_HEAD_START];
  q.unit_start = (const int*)p[P_UNIT_START];
  q.h = (float*)p[P_H];
  q.c = (float*)p[P_C];
  q.dp = (float*)p[P_DP];
  q.gate = (float*)p[P_GATE];
  q.sc = (float*)p[P_SC];
  q.awe = (float*)p[P_AWE];
  q.logits = (float*)p[P_LOGITS];
  q.rows = (int*)p[P_ROWS];
  q.tok = (int*)p[P_TOK];
  q.parent = (int*)p[P_PARENT];
  q.score = (float*)p[P_SCORE];
  q.fin = (int*)p[P_FIN];
  q.len = (int*)p[P_LEN];
  q.done = (int*)p[P_DONE];
  q.steps = (int*)p[P_STEPS];
  q.bp_parent = (int*)p[P_BP_PARENT];
  q.bp_write = (int*)p[P_BP_WRITE];
  q.preds = (int*)p[P_PREDS];
  q.score_out = (float*)p[P_SCORE_OUT];
  q.lens_out = (int*)p[P_LENS_OUT];
  q.stamps = (unsigned long long*)p[P_STAMPS];
  q.d = d;
  return q;
}

// Shared memory: dynamic, doubles first.
struct Smem {
  double* alpha;  // Pp: a row's attention weights
  double* part;   // WARPS x 32: phase C's per-warp partial sums
  float* xs;      // TILE x LDX: a tile's staged inputs
  float* pre;     // TILE x 4 UNIT_CHUNK: gate pre-activations
  int* bpar;      // K2, 5 x K: top-K parents, tokens, values, fin, len
  int* bnew;
  float* bval;
  int* bfin;
  int* blen;
};

inline size_t smem_bytes(const Dims& d) {
  return sizeof(double) * ((size_t)d.Pp + WARPS * 32) +
         sizeof(float) * ((size_t)TILE * d.LDX + TILE * 4 * UNIT_CHUNK) +
         sizeof(int) * 5 * (size_t)d.K;
}

__device__ inline Smem carve(void* base, const Dims& d) {
  Smem s;
  s.alpha = (double*)base;
  s.part = s.alpha + d.Pp;
  s.xs = (float*)(s.part + WARPS * 32);
  s.pre = s.xs + TILE * d.LDX;
  s.bpar = (int*)(s.pre + TILE * 4 * UNIT_CHUNK);
  s.bnew = s.bpar + d.K;
  s.bval = (float*)(s.bnew + d.K);
  s.bfin = (int*)(s.bval + d.K);
  s.blen = s.bfin + d.K;
  return s;
}

// ---- loads and rounding -------------------------------------------------

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// 16 bytes of a weight column (16-byte aligned) as floats.
__device__ __forceinline__ void ld16(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&w)[8]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// Round a float32 value to the stream type T (and hold it as float32).
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

// Xor butterflies: every lane ends with the same value.
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
__device__ __forceinline__ void warp_argmax(float& best, int& bi) {
  for (int o = 16; o > 0; o >>= 1)
    arg_better(best, bi, __shfl_xor_sync(0xffffffffu, best, o),
               __shfl_xor_sync(0xffffffffu, bi, o));
}

// The phase clock: block 0 notes the time in stamps[i] (see Params).
template <typename T>
__device__ __forceinline__ void stamp(const Params<T>& p, int i) {
  if (p.stamps && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    p.stamps[i] = ns;
  }
}

// A cooperative launch that only crosses `n` grid barriers: what one
// barrier costs when every block arrives at once.
__global__ void __launch_bounds__(THREADS, 1) barrier_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// ---- the warp's column product ---------------------------------------------

// acc[r] = sum_k x[r][k] * w[k] in float64 for the tile's rows (rows at or
// past nr repeat row 0 and are not used): w is one packed column of K
// values (K a multiple of 8, 16-byte aligned); x rows are float32 in shared
// memory, ldx floats apart. Lane l takes the 16-byte chunks l, l + 32, ...;
// the lanes are combined by a butterfly, so every lane holds every sum.
template <int TR, typename W>
__device__ __forceinline__ void col_dot(const W* w, int K, const float* x,
                                        int ldx, int nr, int lane,
                                        double (&acc)[TR]) {
  constexpr int VEC = 16 / sizeof(W);
  const float* xr[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    acc[r] = 0.0;
    xr[r] = x + (r < nr ? r : 0) * ldx;
  }
  for (int k = lane * VEC; k < K; k += 32 * VEC) {
    float wv[VEC];
    ld16(w + k, wv);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr[r] + k + i);
        acc[r] = fma((double)xv.x, (double)wv[i], acc[r]);
        acc[r] = fma((double)xv.y, (double)wv[i + 1], acc[r]);
        acc[r] = fma((double)xv.z, (double)wv[i + 2], acc[r]);
        acc[r] = fma((double)xv.w, (double)wv[i + 3], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r] = warp_sum(acc[r]);
}

// Row of the state a row continues from: itself (K1) or its beam's parent.
template <typename T>
__device__ __forceinline__ int src_row(const Params<T>& p, int r) {
  return p.parent ? p.parent[r] : r;
}

// ---- phase A: the head ----------------------------------------------------

template <int TR, typename T>
__device__ void head_tile(const Params<T>& p, const Smem& s, const int* act,
                          int ts, int nr, int c0, int c1) {
  const Dims& d = p.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int col = c0 + warp; col < c1; col += WARPS) {
    double acc[TR];
    if (col < d.A + d.E) {
      col_dot<TR>(p.m1 + (size_t)col * d.Hp, d.Hp, s.xs, d.Hp, nr, lane,
                  acc);
    } else {
      col_dot<TR>(p.fc + (size_t)(col - d.A - d.E) * d.Hp, d.Hp, s.xs, d.Hp,
                  nr, lane, acc);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (r != lane || r >= nr) continue;  // lane r writes row r
      const int row = act[ts + r];
      if (col < d.A) {
        p.dp[(size_t)row * d.A + col] =
            rnd<T>(__fadd_rn(rnd64<T>(acc[r]), ldf(p.batt + col)));
      } else if (col < d.A + d.E) {
        const int e = col - d.A;
        p.gate[(size_t)row * d.E + e] =
            sig<T>(rnd<T>(__fadd_rn(rnd64<T>(acc[r]), ldf(p.bf + e))));
      } else {
        const int n = col - d.A - d.E;
        p.logits[(size_t)row * d.V + n] =
            __fadd_rn((float)acc[r], ldf(p.bfc + n));
      }
    }
  }
}

// From h (buffer hb) of the active rows: dp and gate, and with `logits` the
// head's logits, for the columns this block owns.
template <typename T>
__device__ void phase_head(const Params<T>& p, const Smem& s, const int* act,
                           int nact, int hb, bool logits) {
  const Dims& d = p.d;
  const int c0 = p.head_start[blockIdx.x];
  const int c1 = min(p.head_start[blockIdx.x + 1],
                     logits ? d.NH : d.A + d.E);
  if (c0 >= c1) return;  // block-uniform; no grid.sync() inside
  const float* h = p.h + (size_t)hb * d.R * d.Hp;
  for (int ts = 0; ts < nact; ts += TILE) {
    const int nr = min(TILE, nact - ts);
    for (int i = threadIdx.x; i < nr * d.Hp; i += THREADS)
      s.xs[i] = h[(size_t)act[ts + i / d.Hp] * d.Hp + i % d.Hp];
    __syncthreads();
    if (nr <= 4)
      head_tile<4>(p, s, act, ts, nr, c0, c1);
    else
      head_tile<TILE>(p, s, act, ts, nr, c0, c1);
    __syncthreads();
  }
}

// ---- phase B: attention scores ------------------------------------------

// v . relu(enc_proj + dp) + b_v for every (active row, position), a warp
// per pair over the whole grid.
template <typename T>
__device__ void phase_scores(const Params<T>& p, const int* act, int nact) {
  const Dims& d = p.d;
  const int lane = threadIdx.x % 32;
  const int gw = blockIdx.x * WARPS + threadIdx.x / 32;
  const int nw = gridDim.x * WARPS;
  const float bvv = ldf(p.bv);
  for (int pr = gw; pr < nact * d.P; pr += nw) {
    const int r = act[pr / d.P], pos = pr % d.P;
    const T* pp = p.proj + ((size_t)(r / d.K) * d.P + pos) * d.A;
    const float* dp = p.dp + (size_t)src_row(p, r) * d.A;
    double acc = 0.0;
    for (int a = lane; a < d.A; a += 32)
      acc = fma((double)fmaxf(rnd<T>(__fadd_rn(ldf(pp + a), dp[a])), 0.0f),
                (double)ldf(p.v + a), acc);
    acc = warp_sum(acc);
    if (lane == 0)
      p.sc[(size_t)r * d.Pp + pos] = rnd<T>(__fadd_rn(rnd64<T>(acc), bvv));
  }
}

// ---- phase C: softmax and attended vector -----------------------------------

// alpha = softmax of row r's scores, in float64, into s.alpha (the whole
// block; every block computes the same values for the same row).
template <typename T>
__device__ void row_softmax(const Params<T>& p, const Smem& s, int r) {
  __shared__ double red[WARPS];
  const Dims& d = p.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double m = -INFINITY;
  for (int i = threadIdx.x; i < d.P; i += THREADS) {
    const double x = p.sc[(size_t)r * d.Pp + i];
    s.alpha[i] = x;
    m = fmax(m, x);
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < WARPS; ++w) m = fmax(m, red[w]);
  __syncthreads();
  double sum = 0.0;
  for (int i = threadIdx.x; i < d.P; i += THREADS) {
    const double ex = exp(s.alpha[i] - m);
    s.alpha[i] = ex;
    sum += ex;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.0;
  for (int w = 0; w < WARPS; ++w) sum += red[w];
  for (int i = threadIdx.x; i < d.P; i += THREADS) s.alpha[i] /= sum;
  __syncthreads();
}

// awe = gate * sum_p alpha_p enc_p, over units of (active row, 32 encoder
// columns); a block takes a contiguous range of units and recomputes the
// softmax only when the row changes. Inside a unit, warp w sums the
// positions w, w + 16, ... and the 16 partial sums are added in order.
template <typename T>
__device__ void phase_attend(const Params<T>& p, const Smem& s,
                             const int* act, int nact) {
  const Dims& d = p.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = (d.E + 31) / 32;
  const long long nu = (long long)nact * nc;
  const int u0 = (int)(nu * blockIdx.x / gridDim.x);
  const int u1 = (int)(nu * (blockIdx.x + 1) / gridDim.x);
  int have = -1;
  for (int u = u0; u < u1; ++u) {
    const int r = act[u / nc];
    if (r != have) {
      row_softmax(p, s, r);
      have = r;
    }
    const int e = (u % nc) * 32 + lane;
    double acc = 0.0;
    if (e < d.E) {
      const T* ep = p.enc + (size_t)(r / d.K) * d.P * d.E + e;
      for (int pos = warp; pos < d.P; pos += WARPS)
        acc = fma(s.alpha[pos], (double)ldf(ep + (size_t)pos * d.E), acc);
    }
    s.part[warp * 32 + lane] = acc;
    __syncthreads();
    if (warp == 0 && e < d.E) {
      double tot = 0.0;
      for (int w = 0; w < WARPS; ++w) tot += s.part[w * 32 + lane];
      const float g = p.gate[(size_t)src_row(p, r) * d.E + e];
      p.awe[(size_t)r * d.E + e] = rnd64<T>((double)g * tot);
    }
    __syncthreads();
  }
}

// ---- phase D: the LSTM ----------------------------------------------------

template <int TR, typename T>
__device__ void lstm_cols(const Params<T>& p, const Smem& s, int nr, int uc,
                          int ncol) {
  const Dims& d = p.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int lc = warp; lc < ncol; lc += WARPS) {
    const int j = uc + lc / 4, g = lc % 4;
    const T* w = p.m3 + (size_t)(4 * j + g) * d.LDX;
    double acc[TR];
    float ax[TR];
    col_dot<TR>(w, d.Xp, s.xs, d.LDX, nr, lane, acc);
#pragma unroll
    for (int r = 0; r < TR; ++r) ax[r] = rnd64<T>(acc[r]);
    col_dot<TR>(w + d.Xp, d.Hp, s.xs + d.Xp, d.LDX, nr, lane, acc);
    const float b = ldf(p.blstm + g * d.H + j);
#pragma unroll
    for (int r = 0; r < TR; ++r)
      if (r == lane && r < nr)
        s.pre[r * 4 * UNIT_CHUNK + lc] = rnd<T>(
            __fadd_rn(ax[r], rnd<T>(__fadd_rn(rnd64<T>(acc[r]), b))));
  }
}

// h, c (buffer hb) -> buffer hb ^ 1 for the active rows and the units this
// block owns. `tok` gives each row's input token; K2 rows continue their
// parent's state.
template <typename T>
__device__ void phase_lstm(const Params<T>& p, const Smem& s, const int* act,
                           int nact, const int* tok, int hb) {
  const Dims& d = p.d;
  const int j0 = p.unit_start[blockIdx.x], j1 = p.unit_start[blockIdx.x + 1];
  if (j0 >= j1) return;  // block-uniform
  const float* h = p.h + (size_t)hb * d.R * d.Hp;
  float* h2 = p.h + (size_t)(hb ^ 1) * d.R * d.Hp;
  const float* c = p.c + (size_t)hb * d.R * d.H;
  float* c2 = p.c + (size_t)(hb ^ 1) * d.R * d.H;
  for (int ts = 0; ts < nact; ts += TILE) {
    const int nr = min(TILE, nact - ts);
    // Stage x = [emb(tok) | awe | 0 | h(src) | 0] for the tile's rows.
    for (int i = threadIdx.x; i < nr * d.LDX; i += THREADS) {
      const int rr = i / d.LDX, k = i % d.LDX;
      const int r = act[ts + rr];
      float x = 0.0f;
      if (k < d.D)
        x = ldf(p.emb + (size_t)tok[r] * d.D + k);
      else if (k < d.X)
        x = p.awe[(size_t)r * d.E + k - d.D];
      else if (k >= d.Xp && k < d.Xp + d.H)
        x = h[(size_t)src_row(p, r) * d.Hp + k - d.Xp];
      s.xs[i] = x;
    }
    __syncthreads();
    for (int uc = j0; uc < j1; uc += UNIT_CHUNK) {
      const int nu = min(UNIT_CHUNK, j1 - uc);
      if (nr <= 4)
        lstm_cols<4>(p, s, nr, uc, 4 * nu);
      else
        lstm_cols<TILE>(p, s, nr, uc, 4 * nu);
      __syncthreads();
      for (int i = threadIdx.x; i < nr * nu; i += THREADS) {
        const int rr = i / nu, j = uc + i % nu;
        const int r = act[ts + rr];
        const float* g = s.pre + rr * 4 * UNIT_CHUNK + 4 * (i % nu);
        const float ig = sig<T>(g[0]);
        const float fg = sig<T>(g[1]);
        const float gg = tnh<T>(g[2]);
        const float og = sig<T>(g[3]);
        const float cold = c[(size_t)src_row(p, r) * d.H + j];
        const float cn = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(fg, cold)),
                                          rnd<T>(__fmul_rn(ig, gg))));
        c2[(size_t)r * d.H + j] = cn;
        h2[(size_t)r * d.Hp + j] = rnd<T>(__fmul_rn(og, tnh<T>(cn)));
      }
      __syncthreads();
    }
  }
}

// ---- set-up and launch ------------------------------------------------------

// Row r's initial h (both buffers' padding zeroed) and c, from image r / K.
template <typename T>
__device__ void init_state(const Params<T>& p) {
  const Dims& d = p.d;
  const size_t n = (size_t)d.R * d.Hp;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    const int r = (int)(i / d.Hp), k = (int)(i % d.Hp);
    const size_t src = (size_t)(r / d.K) * d.H + k;
    p.h[i] = k < d.H ? ldf(p.h0 + src) : 0.0f;
    p.h[n + i] = 0.0f;
    if (k < d.H) p.c[(size_t)r * d.H + k] = ldf(p.c0 + src);
  }
}

// A block's list of active rows: all rows.
__device__ inline int all_rows(int* act, int R) {
  for (int i = threadIdx.x; i < R; i += THREADS) act[i] = i;
  __syncthreads();
  return R;
}

// Grid size for the cooperative launch: as many blocks as fit on the card
// at once, at most one per LSTM unit. Returns a CUDA error code.
template <typename Kernel>
int grid_size(Kernel kernel, const Dims& d, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes(d);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return (int)err;
  *grid = sms * per_sm < d.H ? sms * per_sm : d.H;
  return 0;
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* const* ptrs, const Dims& d, int grid,
           cudaStream_t stream) {
  int most = 0;
  int err = grid_size(kernel, d, &most);
  if (err) return err;
  if (grid < 1 || grid > most) return (int)cudaErrorInvalidConfiguration;
  Params<T> params = make_params<T>(ptrs, d);
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                          dim3(THREADS), args,
                                          smem_bytes(d), stream);
}

}  // namespace sd
