// The decode step engine shared by K1 (csrc/fused_decode.cu, greedy) and
// K2 (csrc/fused_beam.cu, beam search): one persistent cooperative launch
// per decode call, whose blocks split every step's work over the whole card
// and meet at grid-wide barriers.
//
// A step streams about 8.7 MB of weights (7.3 MB in bfloat16 plus the 0.9
// MB float32 head) and 0.4 MB of encoder data per row, for about 8.3 MFLOP
// per row. No SM streams all of it: each block owns a slice of the output
// columns of every matrix and the step is cut into four phases separated by
// `grid.sync()`:
//
//   A  from h: the owned columns of the head ([W_att | W_f] (H x (A+E)) and
//      W_fc (H x V)): dp = h W_att + b, gate = sigmoid(h W_f + b_f) for the
//      next step, and the logits of the step just finished;
//   B  (K1: every block takes the argmax of every row redundantly, in the
//      same order, so that all blocks agree on which rows retire and leave
//      the loop together; K2: a separate phase and barrier picks the beams)
//      then the scores v . relu(enc_proj + dp) + b_v over the whole grid, in
//      tasks of (image, positions, beam) ordered so that the beams of one
//      image read the same enc_proj bytes in the same warp instruction;
//   C  per group of an image's rows (all K2's beams of it, up to ATT_G),
//      the softmax over the positions once and the attended sum alpha . enc
//      times the gate, each enc element read once for all the group's rows;
//      with fewer groups than the grid holds, a group's columns are split
//      over blocks and its positions over warps (AttTiling);
//   D  the LSTM: a block owns whole units j, i.e. the gate columns j, H+j,
//      2H+j and 3H+j of [W_x; W_h] ((D+E+H) x 4H), so it updates the cell of
//      unit j with no further barrier.
//
// The ownership plan (which head columns and which units each block owns)
// is computed on the host (kernels/fused_decode.py:step_plan) and passed in
// as two int32 arrays. Weights are packed once per model
// (pack_step_weights): each output column's K values contiguous and padded
// to a multiple of 8.
//
// Two paths run phases A and D, chosen by the stream type at compile time:
//
// * float32 streams: the CUDA-core path. Per row a float64 sum of float32
//   products: a warp streams a weight column from L2 with 16-byte loads,
//   each lane taking every 32nd chunk of the reduction and the lanes joined
//   by a fixed xor butterfly, for a tile of at most TILE = 8 rows staged in
//   shared memory as float32. One weight read serves 8 rows. Per row this
//   is a matrix-vector product with far too few operations per byte for
//   the tensor cores, and its float64 sums make the tokens those of the
//   plain version (kernels/fused_decode.py:fused_greedy_decode_plain).
//
// * bfloat16 streams: the tensor-core path. At the rows the batched paths
//   decode (197 glyphs, 985 beams) every weight byte serves ~190 FLOP, and
//   the CUDA-core path re-read each block's slice from L2 once per 8 rows.
//   Here each block copies its slices into shared memory once, in the
//   prologue (cp.async), and keeps them for the whole launch: the rows 4j..
//   4j+3 of [W_x | W_h] for its units (`m3map`), and the head columns it
//   owns (`hmap`), W_fc split at pack time into three bfloat16 parts whose
//   sum is the float32 weight exactly. Both maps come from the host
//   (kernels/fused_decode.py:mma_slices). A phase then runs `mma.sync
//   m16n8k16` (bf16 in, float32 sums) with 16 weight rows as M and the rows
//   as N in steps of 8: every resident weight fragment serves every live
//   row. The rows' inputs ([emb(tok) | awe | 0 | h | 0] for D, h for A) are
//   bfloat16 already, so they are staged as bfloat16 with no rounding, in
//   K-chunks of KC columns for NT rows at a time, double-buffered with
//   cp.async: the slices and a whole staged row tile do not fit in shared
//   memory together at an encoder width of 2048 (LDX 3072). mma.sync and
//   not wgmma: a block owns 12-16 gate columns and 11-23 head columns, far
//   below wgmma's 64-row tile, and a 16-row m-tile wastes at most a quarter
//   of it. With fewer (m-tile, 8-row) pairs than warps, the warps split the
//   k-steps of a pair and their partial sums are added in warp order.
//   What bounds it: each block reads every live row's inputs from L2 once
//   a step (~80 MB a step at 197 rows over 132 blocks), not the weights.
//
// State that lives across barriers (h and c, double-buffered; dp, gate,
// scores, the attended vector, the logits; K2's beam state) is global
// scratch that the wrapper allocates, as is each block's own list of active
// rows; the tensor-core path keeps h and the attended vector in bfloat16
// (h16, awe16), the values it stages. The shared state is written inside
// the kernel, so it is never read through __ldg or a const __restrict__
// pointer: a non-coherent load could return a stale value after grid.sync().
// Only the weights and the encoder inputs are read through __ldg (and the
// weights and staged rows through cp.async, which reads L2).
//
// Every block reaches every grid.sync(): loops whose bounds differ between
// blocks never contain one, and the decision to stop is taken by every block
// from identical data. There is no limit on the number of rows.
//
// Rounding (the contract of models/decoder.py), kept at flax's points:
//
// * float32 streams: products, the attention softmax and the attended sum
//   in float64, rounded once at flax's points; elementwise float32
//   arithmetic through the _rn intrinsics so that the compiler cannot
//   contract it into an FMA. The tokens are the plain version's.
// * bfloat16 streams: phases B and C and every elementwise step as above.
//   Phases A and D: each k-step's 16 products (exact in float32) are summed
//   by the tensor core from zero, and the k-steps' sums are added in
//   float64 (x W_x and h W_h apart); a second MMA on |W| and |x| bounds how
//   far that is from the float64 sum (BOUND, below). A sum is rounded once
//   at flax's point where every value within the bound rounds alike; else
//   the element is recomputed in float64 on CUDA cores. So every value
//   rounded to bfloat16 is the float64 sum's, as on the float32 path (it
//   could go wrong only if the tensor core's error exceeded the bound;
//   `fixstat` records the largest error seen among the recomputed
//   elements, as a share of the bound). W_fc goes in as hi, mid and lo,
//   three MMAs into one accumulator a k-step; the logits are that sum,
//   within the bound of the float64 one, rounded to float32, plus b_fc:
//   a logit can be an ulp off the plain version's, which changes a token
//   only at a near-tie (a greedy argmax, or the ranking of beams).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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
// The tensor-core path (bfloat16 streams).
constexpr int MAXJ = 1;     // (m-tile, 8-row) jobs a warp holds at once
constexpr int SPAD = 8;     // bf16 padding after every shared row (banks)
constexpr int MAX_LT = 16;  // head m-tiles a block may own (hkind's width)
// Phases B and C.
constexpr int ATT_G = 8;       // rows of one image in a phase-C group, at most
constexpr int ATT_RED = 4096;  // bytes of one row's cross-warp partial sums
                               // (WARPS x 32 columns of doubles)
constexpr int ATT_OV = 2;      // a phase-C unit's fixed cost (softmax,
                               // reduction), in 16ths of a full pass

template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

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
  P_MH, P_M3MAP, P_HMAP, P_HKIND, P_H16, P_AWE16,  // tensor-core path
  P_FIX, P_FIXSTAT,
  P_ASTAT,                                      // phase C's tiling record
  N_PTR
};
// Order of the int array of dimensions.
// NT, KC, R3, RH: the tensor-core path's shared-memory plan (0 for float32
// streams), from kernels/fused_decode.py:mma_plan.
enum Dim {
  D_B, D_P, D_E, D_A, D_H, D_D, D_V, D_K, D_MAX_LENGTH,
  D_NT, D_KC, D_R3, D_RH,
  N_DIM
};

struct Dims {
  int B, P, E, A, H, D, V, K, max_length;
  int R;    // rows: B * K
  int X;    // D + E
  int Xp;   // X rounded up to 8
  int Hp;   // H rounded up to 8
  int Pp;   // P rounded up to 4
  int LDX;  // Xp + Hp: a staged LSTM input row, and a packed W_x|W_h column
  int NH;   // A + E + V head columns
  // The tensor-core path: K-steps of 16, so the x and h parts are padded
  // to 16 in shared memory.
  int Xq;   // X rounded up to 16
  int Hq;   // H rounded up to 16
  int LDQ;  // Xq + Hq
  int NT;   // rows staged at a time
  int KC;   // columns staged at a time (a multiple of 16)
  int R3;   // resident rows of [W_x | W_h] per block (a multiple of 16)
  int RH;   // resident head rows per block (a multiple of 16)
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
  d.Xq = (d.X + 15) & ~15;
  d.Hq = (d.H + 15) & ~15;
  d.LDQ = d.Xq + d.Hq;
  d.NT = v[D_NT]; d.KC = v[D_KC]; d.R3 = v[D_R3]; d.RH = v[D_RH];
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
  // The tensor-core path (null for float32 streams):
  const __nv_bfloat16* mh;  // (A + E + 3V, Hp): m1's rows, then W_fc's hi,
                            // mid and lo parts, column n at A + E + n
  const int* m3map;   // (grid, R3): block b's resident row i is m3 row
                      // m3map[b][i] (-1: zeros)
  const int* hmap;    // (grid, RH): ... and its head row i is mh row
                      // hmap[b][i] (-1: zeros)
  const int* hkind;   // (grid, MAX_LT): its head m-tiles in order, 1 (16
                      // rows of mh) or 3 (hi, mid, lo: 48 rows); 0 ends
  __nv_bfloat16* h16;    // (2, R, Hp): h, double-buffered
  __nv_bfloat16* awe16;  // (R, E): the attended vector
  int* fix;      // (grid, FIXCAP, FIXWORDS): elements to recompute
  int* fixstat;  // (grid, 2): elements recomputed, and the largest
                 // |tensor-core sum - float64 sum| / bound seen (float)
  int* astat;    // 2 (null: off), written at the end of the launch: the
                 // steps whose attended sum split a group's columns over
                 // blocks, and the steps run
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
  q.mh = (const __nv_bfloat16*)p[P_MH];
  q.m3map = (const int*)p[P_M3MAP];
  q.hmap = (const int*)p[P_HMAP];
  q.hkind = (const int*)p[P_HKIND];
  q.h16 = (__nv_bfloat16*)p[P_H16];
  q.awe16 = (__nv_bfloat16*)p[P_AWE16];
  q.fix = (int*)p[P_FIX];
  q.fixstat = (int*)p[P_FIXSTAT];
  q.astat = (int*)p[P_ASTAT];
  q.d = d;
  return q;
}

// Shared memory: dynamic; the regions 16-byte aligned (cp.async, 16-byte
// loads and doubles).
struct Smem {
  double* vs;     // A: v x Att<T>::UP, for phase B (loaded once a launch)
  char* att;      // phase C (att_bytes), over xs or xb: those are only
                  // used inside phases A and D
  float* xs;      // CUDA cores: TILE x LDX, a tile's staged inputs
  float* pre;     // CUDA cores: TILE x 4 UNIT_CHUNK, gate pre-activations;
                  // tensor cores: NT x R3
  __nv_bfloat16* w3;  // tensor cores: R3 x (LDQ + SPAD), resident W_x|W_h
  __nv_bfloat16* wh;  // tensor cores: RH x (Hq + SPAD), resident head
  __nv_bfloat16* xb;  // tensor cores: 2 x NT x (KC + SPAD), staged chunks
                      // (and, after the last chunk, split-k partial sums)
  int* hoff;          // tensor cores: MAX_LT, head m-tile t's first row
  int* hkind;         // tensor cores: MAX_LT, its parts (0: no tile)
  int* m3map;         // tensor cores: R3, the block's row of m3map
  int* hmap;          // tensor cores: RH, the block's row of hmap
  int* own;           // tensor cores: 4, the block's head_start[b],
                      // head_start[b + 1], unit_start[b], unit_start[b + 1]
  float* bias3;       // tensor cores: R3, the bias of each resident m3 row
  float* biash;       // tensor cores: RH, the bias of each head column
  int* bpar;      // K2, 5 x K: top-K parents, tokens, values, fin, len
  int* bnew;
  float* bval;
  int* bfin;
  int* blen;
};

// The tensor-core path's staging region: two buffers of NT rows x (KC +
// SPAD) bf16 (a tile of fewer rows stages wider chunks in the same room);
// after a tile's last chunk it holds the split-k partial sums.
__host__ __device__ inline size_t mma_stage_bytes(const Dims& d) {
  return 2 * 2 * (size_t)d.NT * (d.KC + SPAD);
}

// Phase C's region: the softmax weights of a group's rows (att_rows x Pp
// doubles) and at least one row of cross-warp partial sums (ATT_RED).
__host__ __device__ inline int att_rows(const Dims& d) {
  return d.K < ATT_G ? d.K : ATT_G;
}
__host__ __device__ inline size_t att_bytes(const Dims& d) {
  return sizeof(double) * (size_t)att_rows(d) * d.Pp + ATT_RED;
}
// The region that phases A and D stage in and C works in.
template <typename T>
__host__ __device__ inline size_t work_bytes(const Dims& d) {
  const size_t own = kMma<T> ? mma_stage_bytes(d)
                             : sizeof(float) * (size_t)TILE * d.LDX;
  const size_t att = att_bytes(d);
  return own > att ? own : att;
}

template <typename T>
inline size_t smem_bytes(const Dims& d) {
  const size_t beam = sizeof(int) * 5 * (size_t)d.K;
  const size_t vs = sizeof(double) * (size_t)d.A;
  if (kMma<T>)
    return vs + 2 * (size_t)d.R3 * (d.LDQ + SPAD) +
           2 * (size_t)d.RH * (d.Hq + SPAD) + work_bytes<T>(d) +
           sizeof(float) * (size_t)d.NT * d.R3 +
           sizeof(int) * (2 * MAX_LT + (size_t)d.R3 + d.RH + 4) +
           sizeof(float) * ((size_t)d.R3 + d.RH) + beam;
  return vs + work_bytes<T>(d) + sizeof(float) * TILE * 4 * UNIT_CHUNK +
         beam;
}

template <typename T>
__device__ inline Smem carve(void* base, const Dims& d) {
  Smem s = {};
  s.vs = (double*)base;
  char* next = (char*)(s.vs + d.A);
  if constexpr (kMma<T>) {
    s.w3 = (__nv_bfloat16*)next;
    s.wh = s.w3 + (size_t)d.R3 * (d.LDQ + SPAD);
    s.xb = s.wh + (size_t)d.RH * (d.Hq + SPAD);
    s.att = (char*)s.xb;
    s.pre = (float*)((char*)s.xb + work_bytes<T>(d));
    s.hoff = (int*)(s.pre + (size_t)d.NT * d.R3);
    s.hkind = s.hoff + MAX_LT;
    s.m3map = s.hkind + MAX_LT;
    s.hmap = s.m3map + d.R3;
    s.own = s.hmap + d.RH;
    s.bias3 = (float*)(s.own + 4);
    s.biash = s.bias3 + d.R3;
    next = (char*)(s.biash + d.RH);
  } else {
    s.xs = (float*)next;
    s.att = next;
    s.pre = (float*)(next + work_bytes<T>(d));
    next = (char*)(s.pre + TILE * 4 * UNIT_CHUNK);
  }
  s.bpar = (int*)next;
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

template <typename T>
__device__ void phase_head_mma(const Params<T>& p, const Smem& s,
                               const int* act, int nact, int hb, bool logits);
template <typename T>
__device__ void phase_lstm_mma(const Params<T>& p, const Smem& s,
                               const int* act, int nact, const int* tok,
                               int hb);

// From h (buffer hb) of the active rows: dp and gate, and with `logits` the
// head's logits, for the columns this block owns.
template <typename T>
__device__ void phase_head_f64(const Params<T>& p, const Smem& s,
                               const int* act, int nact, int hb,
                               bool logits) {
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

template <typename T>
__device__ void phase_head(const Params<T>& p, const Smem& s, const int* act,
                           int nact, int hb, bool logits) {
  if constexpr (kMma<T>)
    phase_head_mma(p, s, act, nact, hb, logits);
  else
    phase_head_f64(p, s, act, nact, hb, logits);
}

// ---- phases B and C: attention ------------------------------------------
//
// What bounds them: at a page's ~2,400 beams a step's scores and attended
// sum are 2 x 2,400 x 196 x 512 float64 products, and the images' enc_proj
// and enc (196 x 512 bf16 each, ~96 MB apiece a step at 480 images, more
// than L2 holds) stream from device memory. What kept them at a few
// percent of the float64 rate: a conversion of each bf16 value to float64
// (cvt, a quarter of the float64 FMA rate; two a score product), short
// dependent chains (a warp per (row, position) pair: 16 FMAs, then a
// 5-level shuffle), and each beam reading its image's enc_proj and enc
// again. Here:
//
// * A bfloat16 value becomes a float64 by its bits: its sign, exponent and
//   mantissa moved into a float64's high word give the value times 2^-896
//   exactly (bfloat16 subnormals become float64 subnormals). The other
//   factor of each product carries 2^896 (v, and the softmax weights; both
//   stay below 2^1024), so each product is the exact product and each sum
//   the float64 sum, in another order. (An infinite or NaN input would turn
//   finite; finite weights and features give none.)
// * rnd(enc_proj + dp) and the relu are one bfloat16x2 FMA (x 1 + dp,
//   rounded once, clamped at 0). That is the float32 sum rounded to
//   bfloat16: the float32 sum of two bfloat16 values is exact, or so close
//   to one of them that no rounding point lies between.
// * Every thread holds several independent float64 sums, a reduction
//   across lanes or warps runs once for many products, and phase C issues
//   the loads of several positions before it uses them: with one block of
//   16 warps an SM, the loads' latency bounds these phases more than the
//   float64 rate does.
// * Registers: phases A and D need nearly all of a thread's 128, and the
//   bfloat16 kernels must spill nothing. Hence four positions (not more)
//   a score task, no batched loads in phase B, four positions a batch in
//   K2's phase C, and the softmax computed before a unit's other values
//   exist (its float64 division may call a subroutine, and every value
//   live across that call costs registers).

template <typename T> struct Att;

// Float32 streams: plain conversions (not the fast path).
template <> struct Att<float> {
  static constexpr double UP = 1.0;  // the scale of v and the weights alpha
  using Raw4 = float4;               // four enc_proj values as loaded
  using Raw2 = float2;               // two enc values as loaded
  using Dp = float4;
  __device__ static Dp dp4(const float* dp) {
    return *reinterpret_cast<const float4*>(dp);
  }
  __device__ static Raw4 ld4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static Raw2 ld2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  // relu(rnd(proj + dp)) of four elements, as float64.
  __device__ static void relu4(const Raw4& v, const Dp& dp, double (&y)[4]) {
    y[0] = fmaxf(__fadd_rn(v.x, dp.x), 0.0f);
    y[1] = fmaxf(__fadd_rn(v.y, dp.y), 0.0f);
    y[2] = fmaxf(__fadd_rn(v.z, dp.z), 0.0f);
    y[3] = fmaxf(__fadd_rn(v.w, dp.w), 0.0f);
  }
  __device__ static void f64x2(const Raw2& v, double (&x)[2]) {
    x[0] = v.x;
    x[1] = v.y;
  }
};

// The bfloat16 in the low or high half of w as a float64 times 2^-896.
__device__ __forceinline__ double bf16lo_f64(uint32_t w) {
  return __hiloint2double(
      (int)((uint32_t)((int)(w << 16) >> 3) & 0x8fffe000u), 0);
}
__device__ __forceinline__ double bf16hi_f64(uint32_t w) {
  return __hiloint2double((int)((uint32_t)((int)w >> 3) & 0x8fffe000u), 0);
}
// The same for a value with its sign bit clear, or -0 (made +0).
__device__ __forceinline__ double bf16lo_f64_pos(uint32_t w) {
  return __hiloint2double((int)((w << 13) & 0x0fffe000u), 0);
}
__device__ __forceinline__ double bf16hi_f64_pos(uint32_t w) {
  return __hiloint2double((int)((w >> 3) & 0x0fffe000u), 0);
}
// Keeps the compiler from moving loads across it: the loads issued before
// stay batched, and shared-memory loads after it are not hoisted above
// (which would hold a whole unrolled loop's values in registers).
__device__ __forceinline__ void order_point() {
  asm volatile("" ::: "memory");
}

// Two float32 values rounded to bfloat16 and packed (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
// max(rnd(a + b), 0) of two bfloat16 pairs: a x 1 + b rounded once.
__device__ __forceinline__ uint32_t add_relu_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

template <> struct Att<__nv_bfloat16> {
  static constexpr double UP = 0x1p896;
  using Raw4 = uint2;
  using Raw2 = uint32_t;
  using Dp = uint2;  // dp's four values as bfloat16 (exact: dp is rounded)
  __device__ static Dp dp4(const float* dp) {
    const float4 v = *reinterpret_cast<const float4*>(dp);
    return make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  }
  __device__ static Raw4 ld4(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static Raw2 ld2(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ static void relu4(const Raw4& v, const Dp& dp, double (&y)[4]) {
    const uint32_t s0 = add_relu_bf16x2(v.x, dp.x);
    const uint32_t s1 = add_relu_bf16x2(v.y, dp.y);
    y[0] = bf16lo_f64_pos(s0);
    y[1] = bf16hi_f64_pos(s0);
    y[2] = bf16lo_f64_pos(s1);
    y[3] = bf16hi_f64_pos(s1);
  }
  __device__ static void f64x2(const Raw2& v, double (&x)[2]) {
    x[0] = bf16lo_f64(v);
    x[1] = bf16hi_f64(v);
  }
};

// v x UP into the block's copy (s.vs), once per launch.
template <typename T>
__device__ void load_v(const Params<T>& p, const Smem& s) {
  for (int a = threadIdx.x; a < p.d.A; a += THREADS)
    s.vs[a] = (double)ldf(p.v + a) * Att<T>::UP;
}

// Phase B's tasks (image, PQ positions, beam) over the whole grid: LA
// lanes share a task, lane i of them taking the elements 4i .. 4i + 3,
// 4i + 4LA .. of A, with a float64 sum per position; the lanes are joined
// by an xor butterfly. Tasks go to the
// grid's lane groups in order, so the beams of an image at the same
// positions sit in neighbouring lanes and read the same enc_proj bytes in
// one instruction.
template <int LA, int PQ, typename T>
__device__ void score_tasks(const Params<T>& p, int tid, int bid, int grid,
                            const double* vs, const int* act, int nact) {
  using A4 = Att<T>;
  const Dims& d = p.d;
  const int lane = tid % 32, sub = lane % LA;
  const unsigned mask =
      LA == 32 ? 0xffffffffu : ((1u << LA) - 1u) << (lane - sub);
  const int per_img = (d.P + PQ - 1) / PQ * d.K;
  const int ntask = nact / d.K * per_img;
  const int nlg = grid * (THREADS / LA);
  const float bvv = ldf(p.bv);
#pragma unroll 1
  for (int t = (bid * THREADS + tid) / LA; t < ntask; t += nlg) {
    const int slot = t / per_img, rem = t - slot * per_img;
    const int q = rem / d.K;
    const int r = act[slot * d.K + rem - q * d.K];
    const int pos0 = q * PQ;
    const T* pp = p.proj + ((size_t)(r / d.K) * d.P + pos0) * d.A;
    int off[PQ];  // position pos0 + j; past the last one, pos0 again
#pragma unroll
    for (int j = 0; j < PQ; ++j) off[j] = pos0 + j < d.P ? j * d.A : 0;
    const float* dp = p.dp + (size_t)src_row(p, r) * d.A;
    double acc[PQ];
#pragma unroll
    for (int j = 0; j < PQ; ++j) acc[j] = 0.0;
#pragma unroll 1
    for (int a = 4 * sub; a < d.A; a += 4 * LA) {
      const typename A4::Dp dv = A4::dp4(dp + a);
      typename A4::Raw4 pv[PQ];
#pragma unroll
      for (int j = 0; j < PQ; ++j) pv[j] = A4::ld4(pp + off[j] + a);
      const double2 v01 = *reinterpret_cast<const double2*>(vs + a);
      const double2 v23 = *reinterpret_cast<const double2*>(vs + a + 2);
#pragma unroll
      for (int j = 0; j < PQ; ++j) {
        double y[4];
        A4::relu4(pv[j], dv, y);
        acc[j] = fma(y[0], v01.x, acc[j]);
        acc[j] = fma(y[1], v01.y, acc[j]);
        acc[j] = fma(y[2], v23.x, acc[j]);
        acc[j] = fma(y[3], v23.y, acc[j]);
      }
    }
#pragma unroll
    for (int o = LA / 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < PQ; ++j) acc[j] += __shfl_xor_sync(mask, acc[j], o);
    double mine = acc[0];
#pragma unroll
    for (int j = 1; j < PQ; ++j)
      if (sub == j) mine = acc[j];
    if (sub < PQ && pos0 + sub < d.P)  // lane j writes position pos0 + j
      p.sc[(size_t)r * d.Pp + pos0 + sub] =
          rnd<T>(__fadd_rn(rnd64<T>(mine), bvv));
  }
}

// v . relu(enc_proj + dp) + b_v for every (active row, position): eight
// lanes and four positions a task while the tasks fill at least half the
// grid's lanes, else (few rows) a warp per pair, for shorter chains.
// (Loads of several chunks at once would hold more registers than phases
// A and D leave: the kernel would spill.)
template <typename T>
__device__ void phase_scores(const Params<T>& p, const Smem& s,
                             const int* act, int nact) {
  const int tid = threadIdx.x, bid = blockIdx.x, grid = gridDim.x;
  if (2LL * nact * ((p.d.P + 3) / 4) * 8 >= (long long)grid * THREADS)
    score_tasks<8, 4>(p, tid, bid, grid, s.vs, act, nact);
  else
    score_tasks<32, 1>(p, tid, bid, grid, s.vs, act, nact);
}

// Phase C's tiling for ng groups on a grid of `grid` blocks. A block's
// WARPS warps take 32 cw columns: cw column chunks of 32, each summed by
// WARPS / cw warps over interleaved positions, and within a warp by two
// lane slices (lanes 16s .. 16s + 15 take slice s, 2 columns a lane). With
// cw = WARPS a unit is a whole group, its columns in passes of 32 WARPS;
// else a unit is one tile of 32 cw columns of a group (ntile of them). The
// cw that ends the phase soonest, a unit costing its passes and ATT_OV
// (the softmax and the reduction), in 16ths of a full pass; ties to the
// wider. The host computes the same (kernels/fused_decode.py:att_tiling).
struct AttTiling {
  int cw, ntile, units;
  __host__ __device__ AttTiling(int ng, int E, int grid) {
    const int nct = (E + 31) / 32;
    cw = WARPS;
    ntile = 1;
    // 32-bit arithmetic: a 64-bit division is a subroutine call, whose
    // register saves would spill.
    int best = (ng + grid - 1) / grid *
               (WARPS * ((nct + WARPS - 1) / WARPS) + ATT_OV);
    for (int c = WARPS / 2; c >= 1; c /= 2) {
      const int nt = (nct + c - 1) / c;
      const int cost = (ng * nt + grid - 1) / grid * (c + ATT_OV);
      if (cost < best) {
        best = cost;
        cw = c;
        ntile = nt;
      }
    }
    units = ng * ntile;
  }
  // A group's columns spread over several blocks.
  __host__ __device__ bool split() const { return ntile > 1; }
};

// gate * tot rounded at flax's point into the attended vector (1 or 2
// columns from col).
template <typename T>
__device__ __forceinline__ void awe_put(const Params<T>& p, int E, int r,
                                        int col, float g, double tot) {
  if constexpr (kMma<T>)
    p.awe16[(size_t)r * E + col] =
        __float2bfloat16_rn(rnd64<T>((double)g * tot));
  else
    p.awe[(size_t)r * E + col] = rnd64<T>((double)g * tot);
}
template <typename T>
__device__ __forceinline__ void awe_store(const Params<T>& p, int E, int r,
                                          int col, double tot) {
  awe_put(p, E, r, col, p.gate[(size_t)src_row(p, r) * E + col], tot);
}
template <typename T>
__device__ __forceinline__ void awe_store2(const Params<T>& p, int E, int r,
                                           int col, const double (&tot)[2]) {
  const size_t at = (size_t)r * E + col;
  const float2 g = *reinterpret_cast<const float2*>(
      p.gate + (size_t)src_row(p, r) * E + col);
  const float o0 = rnd64<T>((double)g.x * tot[0]);
  const float o1 = rnd64<T>((double)g.y * tot[1]);
  if constexpr (kMma<T>)
    *reinterpret_cast<uint32_t*>(p.awe16 + at) = pack_bf16x2(o0, o1);
  else
    *reinterpret_cast<float2*>(p.awe + at) = make_float2(o0, o1);
}

// The softmax of the nr rows rows[0 ..] into alpha (nr x Pp doubles, times
// UP), in float64: WARPS / nr warps a row (the whole block), the row's
// warps joined through shared memory, a warp's value a lane, by a
// butterfly.
template <typename T>
__device__ void group_softmax(const Params<T>& p, int tid, const int* rows,
                              int nr, double* alpha) {
  __shared__ double red[2][WARPS];  // each warp's max, then sum
  const Dims& d = p.d;
  const int WPR = WARPS / nr;
  const int warp = tid / 32, lane = tid % 32;
  const int rr = warp / WPR;
  const bool mine = rr < nr, joins = mine && lane < WPR;
  const int i0 = (warp % WPR) * 32 + lane, w0 = rr * WPR + lane;
  const float* sc = p.sc + (size_t)rows[mine ? rr : 0] * d.Pp;
  double* al = alpha + (size_t)rr * d.Pp;
  double m = -INFINITY;
  if (mine)
#pragma unroll 4
    for (int i = i0; i < d.P; i += 32 * WPR) {
      const double x = sc[i];
      al[i] = x;
      m = fmax(m, x);
    }
  m = warp_max(m);
  if (lane == 0) red[0][warp] = m;
  __syncthreads();
  m = warp_max(joins ? red[0][w0] : -INFINITY);
  double sum = 0.0;
  if (mine)
    for (int i = i0; i < d.P; i += 32 * WPR) {
      const double ex = exp(al[i] - m);
      al[i] = ex;
      sum += ex;
    }
  sum = warp_sum(sum);
  if (lane == 0) red[1][warp] = sum;
  __syncthreads();
  sum = warp_sum(joins ? red[1][w0] : 0.0);
  if (mine)
    for (int i = i0; i < d.P; i += 32 * WPR) al[i] = al[i] / sum * Att<T>::UP;
  __syncthreads();
}

// One unit of phase C (BEAM: of K2) after its softmax: the NR rows
// rows[0 ..] of image img, columns [c0, c1) in passes of 32 cw
// (AttTiling), UC positions loaded at once; partial sums of rb rows at a
// time through shared memory where several warps share a column chunk.
template <int NR, bool BEAM, typename T>
__device__ void attend_unit(const Params<T>& p, int tid, double* alpha,
                            const int* rows, int img, int c0, int c1, int cw,
                            int rb) {
  using A2 = Att<T>;
  constexpr int UC = BEAM ? 4 : 8;  // K1's one row leaves room for more
  const Dims& d = p.d;
  const int warp = tid / 32, lane = tid % 32;
  double* red = alpha + (size_t)NR * d.Pp;  // rb x ATT_RED bytes
  const int cp = lane & 15, ls = lane >> 4;
  const int cwl = __ffs(cw) - 1;  // cw is a power of two
  const int cwi = warp & (cw - 1), ws = warp >> cwl, nws = WARPS >> cwl;
  const int ns = 2 * nws, slice = 2 * ws + ls, tw = 32 * cw;
  const T* enc = p.enc + (size_t)img * d.P * d.E;
#pragma unroll 1
  for (int t0 = c0; t0 < c1; t0 += tw) {
    const int col = t0 + 32 * cwi + 2 * cp;
    const bool live = col < c1;  // E is a multiple of 4: whole pairs
    double acc[NR][2];
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) acc[rr][0] = acc[rr][1] = 0.0;
    // K1, split: thread tid writes column t0 + tid; its gate, loaded now.
    float g1 = 0.0f;
    if (!BEAM && nws > 1 && tid < tw && t0 + tid < c1)
      g1 = p.gate[(size_t)src_row(p, rows[0]) * d.E + t0 + tid];
    if (live) {
      const T* ep = enc + col;
#pragma unroll 1
      for (int pos0 = slice; pos0 < d.P; pos0 += ns * UC) {
        typename A2::Raw2 raw[UC];
#pragma unroll
        for (int u = 0; u < UC; ++u) {
          const int pos = pos0 + ns * u;
          if (pos < d.P) raw[u] = A2::ld2(ep + (size_t)pos * d.E);
        }
#pragma unroll
        for (int u = 0; u < UC; ++u) {
          const int pos = pos0 + ns * u;
          order_point();
          if (pos < d.P) {
            double x[2];
            A2::f64x2(raw[u], x);
#pragma unroll
            for (int rr = 0; rr < NR; ++rr) {
              const double a = alpha[rr * d.Pp + pos];
              acc[rr][0] = fma(a, x[0], acc[rr][0]);
              acc[rr][1] = fma(a, x[1], acc[rr][1]);
            }
          }
        }
      }
    }
    // The warp's two lane slices; every lane gets the sums.
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      acc[rr][0] += __shfl_xor_sync(0xffffffffu, acc[rr][0], 16);
      acc[rr][1] += __shfl_xor_sync(0xffffffffu, acc[rr][1], 16);
    }
    if (nws == 1) {  // lane slice s writes the rows s, s + 2, ...
      if (live)
#pragma unroll
        for (int rr = 0; rr < NR; ++rr)
          if ((rr & 1) == ls) awe_store2(p, d.E, rows[rr], col, acc[rr]);
      continue;
    }
    // The warps of a column chunk, added in warp order.
#pragma unroll 1
    for (int r0 = 0; r0 < NR; r0 += rb) {
#pragma unroll
      for (int rr = 0; rr < NR; ++rr)
        if (rr >= r0 && rr < r0 + rb && ls == 0 && live) {
          double* at =
              red + ((size_t)(rr - r0) * nws + ws) * tw + 32 * cwi + 2 * cp;
          at[0] = acc[rr][0];
          at[1] = acc[rr][1];
        }
      __syncthreads();
      const int nrr = min(rb, NR - r0);
      for (int i = tid; i < nrr * tw; i += THREADS) {
        const int rr = i >> (5 + cwl), c = i - rr * tw;
        if (t0 + c >= c1) continue;
        const double* q = red + (size_t)rr * nws * tw + c;
        double tot = 0.0;
        if constexpr (!BEAM) {  // four sums in flight (nws: 2, 4, 8, 16)
          double q1 = 0.0, q2 = 0.0, q3 = 0.0;
          for (int w = 0; w < nws; w += 4) {
            tot += q[(size_t)w * tw];
            q1 += q[(size_t)(w + 1) * tw];
            if (w + 2 < nws) {
              q2 += q[(size_t)(w + 2) * tw];
              q3 += q[(size_t)(w + 3) * tw];
            }
          }
          awe_put(p, d.E, rows[0], t0 + c, g1, (tot + q1) + (q2 + q3));
        } else {
          for (int w = 0; w < nws; ++w) tot += q[(size_t)w * tw];
          awe_store(p, d.E, rows[r0 + rr], t0 + c, tot);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();  // the next unit rewrites alpha
}

// attend_unit<nr> for any nr in 1 .. NR.
template <int NR = ATT_G, typename T>
__device__ __forceinline__ void attend_rows(int nr, const Params<T>& p,
                                            int tid, double* alpha,
                                            const int* rows, int img, int c0,
                                            int c1, int cw, int rb) {
  if constexpr (NR > 1) {
    if (nr < NR) {
      attend_rows<NR - 1>(nr, p, tid, alpha, rows, img, c0, c1, cw, rb);
      return;
    }
  }
  attend_unit<NR, true>(p, tid, alpha, rows, img, c0, c1, cw, rb);
}

// awe = gate * sum_p alpha_p enc_p for the active rows, in units of
// AttTiling over groups of up to att_rows(d) rows of one image (K2, BEAM:
// an image's beams; K1: a row, and only that unit's code in the kernel).
// Returns whether a group's columns were split over blocks (the same in
// every block).
template <bool BEAM, typename T>
__device__ bool phase_attend(const Params<T>& p, const Smem& s,
                             const int* act, int nact) {
  const Dims& d = p.d;
  const int tid = threadIdx.x, grid = gridDim.x;
  double* alpha = reinterpret_cast<double*>(s.att);
  const int K = BEAM ? d.K : 1;  // K1: a group is a row
  const int g = BEAM ? att_rows(d) : 1, cpi = (K + g - 1) / g;
  const AttTiling tl(nact / K * cpi, d.E, grid);
  const int room = (int)((work_bytes<T>(d) -
                          sizeof(double) * (size_t)g * d.Pp) / ATT_RED);
#pragma unroll 1
  for (int u = blockIdx.x; u < tl.units; u += grid) {
    const int grp = u / tl.ntile;
    const int slot = grp / cpi, chunk = grp - slot * cpi;
    const int* rows = act + slot * K + chunk * g;
    const int nr = min(g, K - chunk * g);
    group_softmax(p, tid, rows, nr, alpha);  // first: little else is live
    const int tile = u - grp * tl.ntile;
    const int img = rows[0] / K;
    const int c0 = tile * 32 * tl.cw;
    const int c1 = tl.cw == WARPS ? d.E : min(d.E, c0 + 32 * tl.cw);
    const int rb = min(nr, room);
    if constexpr (BEAM)
      attend_rows(nr, p, tid, alpha, rows, img, c0, c1, tl.cw, rb);
    else
      attend_unit<1, false>(p, tid, alpha, rows, img, c0, c1, tl.cw, rb);
  }
  return tl.split();
}

// Phase C's record: block 0 counts the split steps and the steps in
// shared memory and writes them out at the end of the launch (a global
// read-modify-write at each step would hold block 0 at the barrier).
__device__ __forceinline__ int* att_count() {
  __shared__ int n[2];
  return n;
}
__device__ __forceinline__ void att_note(bool split) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    att_count()[0] += split;
    att_count()[1] += 1;
  }
}
template <typename T>
__device__ __forceinline__ void att_flush(const Params<T>& p) {
  if (p.astat && blockIdx.x == 0 && threadIdx.x < 2)
    p.astat[threadIdx.x] = att_count()[threadIdx.x];
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
__device__ void phase_lstm_f64(const Params<T>& p, const Smem& s,
                               const int* act, int nact, const int* tok,
                               int hb) {
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


template <typename T>
__device__ void phase_lstm(const Params<T>& p, const Smem& s, const int* act,
                           int nact, const int* tok, int hb) {
  if constexpr (kMma<T>)
    phase_lstm_mma(p, s, act, nact, tok, hb);
  else
    phase_lstm_f64(p, s, act, nact, tok, hb);
}

// ---- the tensor-core path (bfloat16 streams) --------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// Global -> shared copies of 16 bytes (bypassing L1) or 8 bytes, outside
// the registers; a null source zero-fills (`any` is a valid address that
// is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           const void* any) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src ? src : any), "r"(src ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          const void* any) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src ? src : any), "r"(src ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b for one m16n8k16 tile: a 16 x 16 bf16 (row-major), b 16 x 8
// bf16 (column-major), c float32; products exact, sums in float32.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Where a staged row comes from: element k of row r, or null for a zero.
// Phase D: [emb(tok) | awe | 0 .. Xq | h(src) | 0 .. Hq].
struct LstmRows {
  const __nv_bfloat16* emb;
  const __nv_bfloat16* awe;
  const __nv_bfloat16* h;
  const int* tok;
  const int* parent;  // K2: the row whose state a beam continues
  int D, E, X, Xq, H, Hp;
  __device__ __forceinline__ const __nv_bfloat16* at(int r, int k) const {
    if (k < D) return emb + (size_t)tok[r] * D + k;
    if (k < X) return awe + (size_t)r * E + (k - D);
    k -= Xq;
    if (k >= 0 && k < H) return h + (size_t)(parent ? parent[r] : r) * Hp + k;
    return nullptr;
  }
};
// Phase A: [h | 0 .. Hq].
struct HeadRows {
  const __nv_bfloat16* h;
  int H, Hp;
  __device__ __forceinline__ const __nv_bfloat16* at(int r, int k) const {
    return k < H ? h + (size_t)r * Hp + k : nullptr;
  }
};

// The block's resident weight tiles of one phase: n m-tiles of 16 output
// rows; tile t starts at shared row off[t] and has kind[t] parts of 16
// rows each (3: W_fc's hi, mid and lo, summed by three MMAs into one
// accumulator). Null off and kind: tile t at row 16 t, one part.
struct Tiles {
  const __nv_bfloat16* w;
  int lw;  // shared row stride (elements)
  int n;
  const int* off;
  const int* kind;
  __device__ __forceinline__ int row(int t) const {
    return off ? off[t] : 16 * t;
  }
  __device__ __forceinline__ int parts(int t) const {
    return kind ? kind[t] : 1;
  }
};

// Bytes of one split-k partial a warp hands on: per lane 8 float64 sums
// and 8 float32 bounds.
constexpr int RED_JOB_BYTES = 32 * (8 * 8 + 8 * 4);

// How one row tile of rows8 rows (a multiple of 8) stages K columns in the
// staging region: chunks of kc columns, rows ldb apart, in two buffers that
// each hold NT x (KC + SPAD) elements (a tile of fewer rows stages wider
// chunks, the whole K when it fits). The split-k partial sums go after the
// first buffer when the whole K is one chunk, so that the staged rows
// stay for the recomputation of elements (`fix`), else over the buffers.
struct Chunks {
  int kc, ldb, nch;
  size_t red_off, red_bytes;  // bytes into the region, and how many
  __device__ Chunks(const Dims& d, int rows8, int K) {
    kc = min(K, ((d.NT * (d.KC + SPAD)) / rows8 - SPAD) & ~15);
    ldb = kc + SPAD;
    nch = (K + kc - 1) / kc;
    red_off = nch == 1 ? 2 * (size_t)rows8 * ldb : 0;
    red_bytes = mma_stage_bytes(d) - red_off;
  }
};

// The work of one row tile of nt rows: pairs of (m-tile, 8 rows), each
// split over wk warps by k-step while the pairs do not fill the warps (as
// far as the staging region holds every job's partial sums). Job j is pair
// j % npairs, k-part j / npairs; warp w holds the jobs w, w + WARPS, ...
// (at most MAXJ).
struct Work {
  int n8s, npairs, wk, njobs;
  __device__ Work(int nt, int nlog, size_t red_bytes) {
    n8s = (nt + 7) / 8;
    npairs = nlog * n8s;
    wk = npairs >= WARPS ? 1 : WARPS / npairs;
    const int slots = (int)(red_bytes / RED_JOB_BYTES);
    if (wk > slots / npairs) wk = max(1, slots / npairs);
    njobs = npairs * wk;
  }
};

// Rows that a tile can hold so that its jobs fit MAXJ per warp.
__device__ __forceinline__ int tile_rows(const Dims& d, int nlog) {
  return min(d.NT, 8 * (WARPS * MAXJ / nlog));
}

// Stage columns [k0, k0 + kc) of the tile's rows (act[ts ..]) into buf,
// rows ldb apart, the rows past nt (to a multiple of 8) zero.
template <class Rows>
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* buf, int ldb,
                                            const Rows& src, const int* act,
                                            int ts, int nt, int n8s, int k0,
                                            int kc, bool vec16,
                                            const void* any) {
  if (vec16) {
    const int per = kc / 8;
    for (int i = threadIdx.x; i < n8s * 8 * per; i += THREADS) {
      const int rr = i / per, kk = (i - rr * per) * 8;
      cp_async16(buf + rr * ldb + kk,
                 rr < nt ? src.at(act[ts + rr], k0 + kk) : nullptr, any);
    }
  } else {
    const int per = kc / 4;
    for (int i = threadIdx.x; i < n8s * 8 * per; i += THREADS) {
      const int rr = i / per, kk = (i - rr * per) * 4;
      cp_async8(buf + rr * ldb + kk,
                rr < nt ? src.at(act[ts + rr], k0 + kk) : nullptr, any);
    }
  }
}

// The warp's jobs on one staged chunk: k-steps [s0, s0 + nsteps) of the
// whole K (the chunk's local steps 0 .. nsteps - 1); steps below xsteps
// go to acc[.][0], the rest to acc[.][1]. Each k-step's tile is summed by
// the tensor core from zero (its parts, at most parts_cap, into one
// float32 accumulator) and added to the float64 sums; a second MMA on |a|
// and |b| sums the products' magnitudes (sab), for the error bound.
__device__ __forceinline__ void mma_chunk(const Tiles& tl, const Work& wk,
                                          const __nv_bfloat16* buf, int ldb,
                                          int s0, int nsteps, int xsteps,
                                          int parts_cap,
                                          double (&acc)[MAXJ][2][4],
                                          float (&sab)[MAXJ][2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr uint32_t ABS = 0x7fff7fffu;  // clears both bf16 sign bits
#pragma unroll
  for (int i = 0; i < MAXJ; ++i) {
    const int job = warp + WARPS * i;
    if (job < wk.njobs) {
      const int pair = job % wk.npairs, kp = job / wk.npairs;
      const int mt = pair / wk.n8s, n8 = pair - mt * wk.n8s;
      const __nv_bfloat16* b = buf + (n8 * 8 + g) * ldb + 2 * t4;
      const __nv_bfloat16* a =
          tl.w + (size_t)(tl.row(mt) + g) * tl.lw + 2 * t4;
      const int parts = min(tl.parts(mt), parts_cap);
      int first = (kp - s0 % wk.wk) % wk.wk;
      if (first < 0) first += wk.wk;
      for (int st = first; st < nsteps; st += wk.wk) {
        const int gs = s0 + st;
        const uint32_t b0 = lds32(b + 16 * st), b1 = lds32(b + 16 * st + 8);
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
        for (int q = 0; q < parts; ++q) {
          const __nv_bfloat16* aq = a + (size_t)q * 16 * tl.lw + 16 * gs;
          const uint32_t a0 = lds32(aq), a1 = lds32(aq + 8 * tl.lw);
          const uint32_t a2 = lds32(aq + 8), a3 = lds32(aq + 8 * tl.lw + 8);
          mma16816(c, a0, a1, a2, a3, b0, b1);
          if (q == 0) {
            m0 = a0 & ABS; m1 = a1 & ABS; m2 = a2 & ABS; m3 = a3 & ABS;
          }
        }
        if (gs < xsteps) {
          mma16816(sab[i][0], m0, m1, m2, m3, b0 & ABS, b1 & ABS);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][0][e] += (double)c[e];
        } else {
          mma16816(sab[i][1], m0, m1, m2, m3, b0 & ABS, b1 & ABS);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][1][e] += (double)c[e];
        }
      }
    }
  }
}

// acc and sab of every pair (k-part 0) = the sum of its k-parts', in
// k-part order: every job writes its partials to slot `job` of `red`, the
// whole block adds them up, k-part 0 reads the sums back (the whole block;
// only when wk.wk > 1, where every warp holds at most one job).
__device__ __forceinline__ void reduce_split(const Work& wk, char* red,
                                             double (&acc)[MAXJ][2][4],
                                             float (&sab)[MAXJ][2][4]) {
  constexpr int F = 32 * 8 * 8;  // the floats after the doubles
  const int job = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (job < wk.njobs) {
    char* base = red + (size_t)job * RED_JOB_BYTES;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      ((double*)base)[q * 32 + lane] = acc[0][q / 4][q % 4];
      ((float*)(base + F))[q * 32 + lane] = sab[0][q / 4][q % 4];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < wk.npairs * 256; i += THREADS) {
    const int pair = i / 256, at = i % 256;
    double* y = (double*)(red + (size_t)pair * RED_JOB_BYTES) + at;
    float* b = (float*)(red + (size_t)pair * RED_JOB_BYTES + F) + at;
    double ys = *y;
    float bs = *b;
    for (int kp = 1; kp < wk.wk; ++kp) {
      const char* base = red + (size_t)(pair + kp * wk.npairs) * RED_JOB_BYTES;
      ys += ((const double*)base)[at];
      bs += ((const float*)(base + F))[at];
    }
    *y = ys;
    *b = bs;
  }
  __syncthreads();
  if (job < wk.npairs) {
    const char* base = red + (size_t)job * RED_JOB_BYTES;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc[0][q / 4][q % 4] = ((const double*)base)[q * 32 + lane];
      sab[0][q / 4][q % 4] = ((const float*)(base + F))[q * 32 + lane];
    }
  }
}

// The products of the resident tiles with one row tile's inputs (K columns,
// a multiple of 16): staged chunk by chunk, double-buffered, each chunk as
// wide as the staging region holds for the tile's rows (the whole K when
// the rows are few); on return the warps' jobs below wk.npairs hold the
// sums (the whole block).
// The products of the resident tiles with one row tile's inputs (K columns,
// a multiple of 16): staged chunk by chunk as `ch` says, double-buffered;
// on return the warps' jobs below wk.npairs hold the sums (the whole
// block).
template <class Rows>
__device__ void mma_rows(const Dims& d, const Smem& s, const Rows& src,
                         const int* act, int ts, int nt, const Tiles& tl,
                         const Chunks& ch, const Work& wk, int K, int xsteps,
                         int parts_cap, const void* any,
                         double (&acc)[MAXJ][2][4],
                         float (&sab)[MAXJ][2][4]) {
#pragma unroll
  for (int i = 0; i < MAXJ; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc[i][q / 4][q % 4] = 0.0;
      sab[i][q / 4][q % 4] = 0.0f;
    }
  const bool vec16 = ((d.D | d.E | d.H) & 7) == 0;
  const int kc = ch.kc, ldb = ch.ldb, nch = ch.nch;
  __nv_bfloat16* buf0 = s.xb;
  __nv_bfloat16* buf1 = s.xb + (size_t)wk.n8s * 8 * ldb;
  stage_chunk(buf0, ldb, src, act, ts, nt, wk.n8s, 0, kc, vec16, any);
  cp_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      const int k1 = (c + 1) * kc;
      stage_chunk((c & 1) ? buf0 : buf1, ldb, src, act, ts, nt, wk.n8s, k1,
                  min(kc, K - k1), vec16, any);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    mma_chunk(tl, wk, (c & 1) ? buf1 : buf0, ldb, c * kc / 16,
              min(kc, K - c * kc) / 16, xsteps, parts_cap, acc, sab);
    __syncthreads();
  }
  if (wk.wk > 1) reduce_split(wk, (char*)s.xb + ch.red_off, acc, sab);
}

// The float64 sums of the tensor-core path are exact up to the tensor
// core's own rounding inside each k-step, which BOUND x (the sum of the
// products' magnitudes) bounds. A sum is rounded to T at flax's point only
// where every value within that bound rounds alike (rounding is monotone,
// so the two ends decide); else the element is recomputed in float64 on
// CUDA cores (`fix` lists it), so the rounded value is always that of the
// float64 sum, as in the plain version.
constexpr double BOUND = 1.0 / (1 << 22);
// Elements a block may list for recomputation per row tile: every element
// of the tile (WARPS x MAXJ jobs of 16 x 8), with 5 words each.
constexpr int FIXCAP = WARPS * MAXJ * 128;
constexpr int FIXWORDS = 5;
// The first FIXS of them are listed in shared memory, the rest in `fix`.
constexpr int FIXS = 64;

// Entry i of a row tile's list of elements to recompute.
__device__ __forceinline__ int* fix_entry(int* sfix, int* gfix, int i) {
  return i < FIXS ? sfix + i * FIXWORDS : gfix + (size_t)(i - FIXS) * FIXWORDS;
}

template <typename T>
__device__ __forceinline__ bool rounds_alike(double y, float sab,
                                             float* out) {
  const double m = BOUND * (double)sab;
  const float lo = rnd64<T>(y - m);
  *out = lo;
  return lo == rnd64<T>(y + m);
}

// List element (n, m) of the tile for recomputation, with its tensor-core
// sums and bounds (for the record of how far they were off).
__device__ __forceinline__ void fix_push(int* sfix, int* fix, int* count,
                                         int n, int m, double y0, float s0,
                                         double y1, float s1) {
  int* f = fix_entry(sfix, fix, atomicAdd(count, 1));
  f[0] = (n << 16) | m;
  f[1] = __float_as_int((float)y0);
  f[2] = __float_as_int(s0);
  f[3] = __float_as_int((float)y1);
  f[4] = __float_as_int(s1);
}

// The warp's float64 sums of w[k] x(k) over k in [0, split) (y0) and
// [split, K) (y1), split and K multiples of 16: w a resident row (shared),
// x a row source (global; read as written, not through the read-only path),
// 8 (vec16) or 4 elements a load, the loads of four pieces in flight at
// once. Every lane gets the sums.
template <class Rows>
__device__ __forceinline__ void warp_dot2(const __nv_bfloat16* w,
                                          const Rows& src, int r, int split,
                                          int K, bool vec16, double& y0,
                                          double& y1) {
  const int lane = threadIdx.x % 32;
  const int step = vec16 ? 8 : 4;
  double a0 = 0.0, a1 = 0.0;
#pragma unroll 4
  for (int k = step * lane; k < K; k += 32 * step) {
    const __nv_bfloat16* xp = src.at(r, k);
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), wv = make_uint4(0u, 0u, 0u, 0u);
    if (vec16) {
      if (xp) xv = *reinterpret_cast<const uint4*>(xp);
      wv = *reinterpret_cast<const uint4*>(w + k);
    } else {
      if (xp) {
        const uint2 v = *reinterpret_cast<const uint2*>(xp);
        xv.x = v.x;
        xv.y = v.y;
      }
      const uint2 v = *reinterpret_cast<const uint2*>(w + k);
      wv.x = v.x;
      wv.y = v.y;
    }
    const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* wb = reinterpret_cast<const __nv_bfloat162*>(&wv);
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(xb[i]);
      const float2 wf = __bfloat1622float2(wb[i]);
      part = fma((double)xf.x, (double)wf.x, part);
      part = fma((double)xf.y, (double)wf.y, part);
    }
    if (k < split)
      a0 += part;
    else
      a1 += part;
  }
  y0 = warp_sum(a0);
  y1 = warp_sum(a1);
}

// As warp_dot2 with the row staged in shared memory (x, K elements).
__device__ __forceinline__ void warp_dot2_staged(const __nv_bfloat16* w,
                                                 const __nv_bfloat16* x,
                                                 int split, int K,
                                                 double& y0, double& y1) {
  const int lane = threadIdx.x % 32;
  double a0 = 0.0, a1 = 0.0;
  for (int k = 8 * lane; k < K; k += 256) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k);
    const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* wb = reinterpret_cast<const __nv_bfloat162*>(&wv);
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(xb[i]);
      const float2 wf = __bfloat1622float2(wb[i]);
      part = fma((double)xf.x, (double)wf.x, part);
      part = fma((double)xf.y, (double)wf.y, part);
    }
    if (k < split)
      a0 += part;
    else
      a1 += part;
  }
  y0 = warp_sum(a0);
  y1 = warp_sum(a1);
}

// Note a recomputed element in the block's record: one more, and the
// largest |tensor-core sum - float64 sum| / bound seen.
__device__ __forceinline__ void fix_note(int* stat, float y, float sab,
                                         double exact) {
  if (sab > 0.0f)
    atomicMax(stat + 1, __float_as_int((float)(fabs((double)y - exact) /
                                               (BOUND * (double)sab))));
}

// The block's resident slices, once per launch: rows m3map[b] of m3 (the x
// part to [0, Xp), the h part to [Xq, Xq + Hp), zeros elsewhere) and rows
// hmap[b] of mh, and the maps and the head's m-tiles into shared memory.
// Zeroes the block's record of recomputed elements.
template <typename T>
__device__ void load_slices(const Params<T>& p, const Smem& s) {
  const Dims& d = p.d;
  const int* m3map = p.m3map + (size_t)blockIdx.x * d.R3;
  const int* hmap = p.hmap + (size_t)blockIdx.x * d.RH;
  const int lw3 = d.LDQ + SPAD, per3 = d.LDQ / 8;
  for (int i = threadIdx.x; i < d.R3 * per3; i += THREADS) {
    const int row = i / per3, k = (i - row * per3) * 8;
    const int q = m3map[row];
    const T* src = nullptr;
    if (q >= 0 && k < d.Xp) {
      src = p.m3 + (size_t)q * d.LDX + k;
    } else if (q >= 0 && k >= d.Xq && k - d.Xq < d.Hp) {
      src = p.m3 + (size_t)q * d.LDX + d.Xp + (k - d.Xq);
    }
    cp_async16(s.w3 + (size_t)row * lw3 + k, src, p.m3);
  }
  const int lwh = d.Hq + SPAD, perh = d.Hq / 8;
  for (int i = threadIdx.x; i < d.RH * perh; i += THREADS) {
    const int row = i / perh, k = (i - row * perh) * 8;
    const int q = hmap[row];
    cp_async16(s.wh + (size_t)row * lwh + k,
               q >= 0 && k < d.Hp ? p.mh + (size_t)q * d.Hp + k : nullptr,
               p.mh);
  }
  for (int i = threadIdx.x; i < d.R3; i += THREADS) {
    const int q = m3map[i];  // 4 j + gate
    s.m3map[i] = q;
    s.bias3[i] = q >= 0 ? ldf(p.blstm + (q & 3) * d.H + (q >> 2)) : 0.0f;
  }
  for (int i = threadIdx.x; i < d.RH; i += THREADS) {
    const int col = hmap[i];  // a head column on the rows of hi parts
    s.hmap[i] = col;
    s.biash[i] = col < 0 || col >= d.NH ? 0.0f
                 : col < d.A            ? ldf(p.batt + col)
                 : col < d.A + d.E      ? ldf(p.bf + col - d.A)
                                        : ldf(p.bfc + col - d.A - d.E);
  }
  if (threadIdx.x < MAX_LT)
    s.hkind[threadIdx.x] = p.hkind[(size_t)blockIdx.x * MAX_LT + threadIdx.x];
  if (threadIdx.x < 2) {
    s.own[threadIdx.x] = p.head_start[blockIdx.x + threadIdx.x];
    s.own[2 + threadIdx.x] = p.unit_start[blockIdx.x + threadIdx.x];
  }
  if (threadIdx.x < 2) p.fixstat[2 * blockIdx.x + threadIdx.x] = 0;
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0;
    for (int t = 0; t < MAX_LT; ++t) {
      s.hoff[t] = off;
      off += 16 * s.hkind[t];
    }
  }
  __syncthreads();
}

// Phase A on the tensor cores: dp, gate and (with `logits`) the logits of
// the active rows for the head columns this block owns, from h16 (buffer
// hb). A head row's hmap entry is its column: [0, A) W_att, [A, A + E)
// W_f, [A + E, NH) W_fc (hi part; mid and lo follow in its tile).
template <typename T>
__device__ void phase_head_mma(const Params<T>& p, const Smem& s,
                               const int* act, int nact, int hb,
                               bool logits) {
  __shared__ int s_nfix, s_fix[FIXS * FIXWORDS];
  const Dims& d = p.d;
  const int c0 = s.own[0];
  const int c1 = min(s.own[1], logits ? d.NH : d.A + d.E);
  if (c0 >= c1) return;  // block-uniform; no grid.sync() inside
  int nlog = 0;
  while (nlog < MAX_LT && s.hkind[nlog] > 0) ++nlog;
  const Tiles tl{s.wh, d.Hq + SPAD, nlog, s.hoff, s.hkind};
  const HeadRows src{p.h16 + (size_t)hb * d.R * d.Hp, d.H, d.Hp};
  const int* hmap = s.hmap;
  const bool vec16 = ((d.D | d.E | d.H) & 7) == 0;
  int* fix = p.fix + (size_t)blockIdx.x * FIXCAP * FIXWORDS;
  int* stat = p.fixstat + 2 * blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = tile_rows(d, nlog);
  for (int ts = 0; ts < nact; ts += rows) {
    const int nt = min(rows, nact - ts);
    const Chunks ch(d, (nt + 7) / 8 * 8, d.Hq);
    const Work wk(nt, nlog, ch.red_bytes);
    double acc[MAXJ][2][4];
    float sab[MAXJ][2][4];
    if (threadIdx.x == 0) s_nfix = 0;
    mma_rows(d, s, src, act, ts, nt, tl, ch, wk, d.Hq, d.Hq / 16,
             logits ? 3 : 1, p.emb, acc, sab);
#pragma unroll
    for (int i = 0; i < MAXJ; ++i) {
      const int pair = warp + WARPS * i;
      if (pair >= wk.npairs) continue;
      const int mt = pair / wk.n8s, n8 = pair - mt * wk.n8s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n8 * 8 + 2 * t4 + (e & 1);
        const int m = s.hoff[mt] + g + 8 * (e >> 1);
        const int col = hmap[m];
        if (n >= nt || col < 0) continue;
        const int row = act[ts + n];
        const double y = acc[i][0][e];
        float v;
        if (col < d.A + d.E) {
          if (!rounds_alike<T>(y, sab[i][0][e], &v)) {
            fix_push(s_fix, fix, &s_nfix, n, m, y, sab[i][0][e], 0.0, 0.0f);
          } else if (col < d.A) {
            p.dp[(size_t)row * d.A + col] =
                rnd<T>(__fadd_rn(v, s.biash[m]));
          } else {
            p.gate[(size_t)row * d.E + col - d.A] =
                sig<T>(rnd<T>(__fadd_rn(v, s.biash[m])));
          }
        } else if (logits) {
          p.logits[(size_t)row * d.V + col - d.A - d.E] =
              __fadd_rn((float)y, s.biash[m]);
        }
      }
    }
    __syncthreads();
    const int nfix = s_nfix;
    for (int it = warp; it < nfix; it += WARPS) {
      const int* f = fix_entry(s_fix, fix, it);
      const int n = f[0] >> 16, m = f[0] & 0xffff;
      const int row = act[ts + n], col = hmap[m];
      const __nv_bfloat16* w = s.wh + (size_t)m * (d.Hq + SPAD);
      double y, unused;
      if (ch.nch == 1)
        warp_dot2_staged(w, s.xb + (size_t)n * ch.ldb, d.Hq, d.Hq, y,
                         unused);
      else
        warp_dot2(w, src, row, d.Hq, d.Hq, vec16, y, unused);
      if (lane == 0) {
        fix_note(stat, __int_as_float(f[1]), __int_as_float(f[2]), y);
        if (col < d.A)
          p.dp[(size_t)row * d.A + col] =
              rnd<T>(__fadd_rn(rnd64<T>(y), s.biash[m]));
        else
          p.gate[(size_t)row * d.E + col - d.A] =
              sig<T>(rnd<T>(__fadd_rn(rnd64<T>(y), s.biash[m])));
      }
    }
    if (threadIdx.x == 0) atomicAdd(stat, nfix);
    __syncthreads();
  }
}

// Phase D on the tensor cores: h16, c (buffer hb) -> buffer hb ^ 1 for the
// active rows and the units this block owns.
template <typename T>
__device__ void phase_lstm_mma(const Params<T>& p, const Smem& s,
                               const int* act, int nact, const int* tok,
                               int hb) {
  __shared__ int s_nfix, s_fix[FIXS * FIXWORDS];
  const Dims& d = p.d;
  const int j0 = s.own[2], j1 = s.own[3];
  if (j0 >= j1) return;  // block-uniform
  const __nv_bfloat16* h = p.h16 + (size_t)hb * d.R * d.Hp;
  __nv_bfloat16* h2 = p.h16 + (size_t)(hb ^ 1) * d.R * d.Hp;
  const float* c = p.c + (size_t)hb * d.R * d.H;
  float* c2 = p.c + (size_t)(hb ^ 1) * d.R * d.H;
  const int nlog = d.R3 / 16;
  const Tiles tl{s.w3, d.LDQ + SPAD, nlog, nullptr, nullptr};
  const LstmRows src{p.emb, p.awe16, h,   tok,  p.parent,
                     d.D,   d.E,     d.X, d.Xq, d.H,      d.Hp};
  const int* m3map = s.m3map;
  int* fix = p.fix + (size_t)blockIdx.x * FIXCAP * FIXWORDS;
  int* stat = p.fixstat + 2 * blockIdx.x;
  const bool vec16 = ((d.D | d.E | d.H) & 7) == 0;
  const int nu = j1 - j0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = tile_rows(d, nlog);
  for (int ts = 0; ts < nact; ts += rows) {
    const int nt = min(rows, nact - ts);
    const Chunks ch(d, (nt + 7) / 8 * 8, d.LDQ);
    const Work wk(nt, nlog, ch.red_bytes);
    double acc[MAXJ][2][4];
    float sab[MAXJ][2][4];
    if (threadIdx.x == 0) s_nfix = 0;
    mma_rows(d, s, src, act, ts, nt, tl, ch, wk, d.LDQ, d.Xq / 16, 1, p.emb,
             acc, sab);
    // Gate pre-activations: rnd(rnd(x W_x) + rnd(rnd(h W_h) + b)).
#pragma unroll
    for (int i = 0; i < MAXJ; ++i) {
      const int pair = warp + WARPS * i;
      if (pair >= wk.npairs) continue;
      const int mt = pair / wk.n8s, n8 = pair - mt * wk.n8s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n8 * 8 + 2 * t4 + (e & 1);
        const int m = mt * 16 + g + 8 * (e >> 1);
        const int q = m3map[m];  // 4 j + gate
        if (n >= nt || q < 0) continue;
        float ax, ah;
        const bool ok_x = rounds_alike<T>(acc[i][0][e], sab[i][0][e], &ax);
        const bool ok_h = rounds_alike<T>(acc[i][1][e], sab[i][1][e], &ah);
        if (ok_x && ok_h) {
          s.pre[(size_t)n * d.R3 + m] =
              rnd<T>(__fadd_rn(ax, rnd<T>(__fadd_rn(ah, s.bias3[m]))));
        } else {
          fix_push(s_fix, fix, &s_nfix, n, m, acc[i][0][e], sab[i][0][e],
                   acc[i][1][e], sab[i][1][e]);
        }
      }
    }
    __syncthreads();
    const int nfix = s_nfix;
    for (int it = warp; it < nfix; it += WARPS) {
      const int* f = fix_entry(s_fix, fix, it);
      const int n = f[0] >> 16, m = f[0] & 0xffff;
      const __nv_bfloat16* w = s.w3 + (size_t)m * (d.LDQ + SPAD);
      double yx, yh;
      if (ch.nch == 1)
        warp_dot2_staged(w, s.xb + (size_t)n * ch.ldb, d.Xq, d.LDQ, yx, yh);
      else
        warp_dot2(w, src, act[ts + n], d.Xq, d.LDQ, vec16, yx, yh);
      if (lane == 0) {
        fix_note(stat, __int_as_float(f[1]), __int_as_float(f[2]), yx);
        fix_note(stat, __int_as_float(f[3]), __int_as_float(f[4]), yh);
        s.pre[(size_t)n * d.R3 + m] = rnd<T>(__fadd_rn(
            rnd64<T>(yx), rnd<T>(__fadd_rn(rnd64<T>(yh), s.bias3[m]))));
      }
    }
    if (threadIdx.x == 0) atomicAdd(stat, nfix);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * nu; i += THREADS) {
      const int n = i / nu, u = i - n * nu, j = j0 + u;
      const int r = act[ts + n];
      const float* gt = s.pre + (size_t)n * d.R3 + 4 * u;
      const float ig = sig<T>(gt[0]);
      const float fg = sig<T>(gt[1]);
      const float gg = tnh<T>(gt[2]);
      const float og = sig<T>(gt[3]);
      const float cold = c[(size_t)src_row(p, r) * d.H + j];
      const float cn = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(fg, cold)),
                                        rnd<T>(__fmul_rn(ig, gg))));
      c2[(size_t)r * d.H + j] = cn;
      h2[(size_t)r * d.Hp + j] =
          __float2bfloat16_rn(rnd<T>(__fmul_rn(og, tnh<T>(cn))));
    }
    __syncthreads();
  }
}

// ---- set-up and launch ------------------------------------------------------

// Row r's initial h (both buffers' padding zeroed) and c, from image r / K;
// phase C's record zeroed.
template <typename T>
__device__ void init_state(const Params<T>& p) {
  const Dims& d = p.d;
  if (blockIdx.x == 0 && threadIdx.x < 2) att_count()[threadIdx.x] = 0;
  const size_t n = (size_t)d.R * d.Hp;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    const int r = (int)(i / d.Hp), k = (int)(i % d.Hp);
    const size_t src = (size_t)(r / d.K) * d.H + k;
    if constexpr (kMma<T>) {
      p.h16[i] = k < d.H ? __ldg(p.h0 + src) : __float2bfloat16_rn(0.0f);
      p.h16[n + i] = __float2bfloat16_rn(0.0f);
    } else {
      p.h[i] = k < d.H ? ldf(p.h0 + src) : 0.0f;
      p.h[n + i] = 0.0f;
    }
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
// at once, at most one per LSTM unit. The tensor-core path's shared memory
// depends on the grid (its plan is made for it), so there a block is asked
// to fit with all the shared memory a block may have. Returns a CUDA error
// code.
template <typename T, typename Kernel>
int grid_size(Kernel kernel, const Dims& d, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t smem = smem_bytes<T>(d);
  if (kMma<T> && err == cudaSuccess) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess) smem = (size_t)optin - fa.sharedSizeBytes;
  }
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
  int err = grid_size<T>(kernel, d, &most);
  if (err) return err;
  if (grid < 1 || grid > most) return (int)cudaErrorInvalidConfiguration;
  if (kMma<T> && (d.NT < 8 || d.NT % 8 || d.KC < 16 || d.KC % 16 ||
                  d.R3 < 16 || d.R3 % 16 || d.RH % 16))
    return (int)cudaErrorInvalidValue;
  Params<T> params = make_params<T>(ptrs, d);
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                          dim3(THREADS), args,
                                          smem_bytes<T>(d), stream);
}

}  // namespace sd
