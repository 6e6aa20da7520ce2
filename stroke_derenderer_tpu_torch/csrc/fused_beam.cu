// K2: the whole beam search of the stroke decoder in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `_fused_beam_decode_tpu` of
// stroke_derenderer_tpu/kernels/fused_beam.py. Each step of each of the
// B x K beams does what K1 (csrc/fused_decode.cu) does for a greedy row:
// additive attention over the image's P encoder positions, the gated
// attended vector, an LSTM step and the float32 vocabulary head. Then, per
// beam, the float32 log-softmax; a finished beam may only extend with PAD,
// at its frozen score; `total = score + logp`; per image the top K of the
// K x V totals (largest first, ties to the lowest flat index, as
// lax.top_k); and the beams continue from their parents. Output: every
// beam's tokens, score and length.
//
// The step runs on the engine of decode_step.cuh (one cooperative launch,
// every block owning a slice of every matrix's columns), over rows = B x K
// beams of every image in one grid. After phase A, one more phase and
// barrier pick the beams:
//
//   prologue  A (dp, gate from h0) | sync
//   step t    B scores | sync | C attend | sync | D LSTM | sync |
//             A (logits of t; dp, gate for t + 1) | sync |
//             select: image i's block (i % grid) turns its beams' logits
//             into totals in place, takes the top K in K rounds of a
//             block-wide argmax, records each beam's parent and written
//             token for the final trace-back, and updates the beams'
//             score, finished flag, length and next token | sync |
//             every block lists the rows of images still searching.
//
// Beams are not reordered: a beam's row keeps its index and reads its
// parent's row of h, c, dp and gate through `parent` (dp and gate are
// row-wise functions of h, so gathering them is gathering h). All beam
// state lives in global scratch, so any K up to V is taken. Once an image's
// beams have all finished its rows drop out of every phase.

#include "decode_step.cuh"

namespace {

using namespace sd;

// Image i's selection step t (the whole block; i is this block's image).
template <typename T>
__device__ void select_beams(const Params<T>& p, const Smem& s, int i,
                             int t) {
  __shared__ float s_rv[WARPS];
  __shared__ int s_ri[WARPS];
  const Dims& d = p.d;
  const int K = d.K, V = d.V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int base = i * K;
  float* tot = p.logits + (size_t)base * V;  // K x V, in place

  // Log-softmax (x - max, then - log(sum exp) with the sum in float64), the
  // finished-beam rule and total = score + logp: a warp per beam.
  for (int k = warp; k < K; k += WARPS) {
    float* lg = tot + (size_t)k * V;
    float m = -INFINITY;
    for (int n = lane; n < V; n += 32) m = fmaxf(m, lg[n]);
    m = warp_maxf(m);
    double sum = 0.0;
    for (int n = lane; n < V; n += 32) sum += exp((double)(lg[n] - m));
    sum = warp_sum(sum);
    const float lse = (float)log(sum);
    const float sc = p.score[base + k];
    const int fin = p.fin[base + k];
    for (int n = lane; n < V; n += 32) {
      const float lp = fin ? (n == PAD_TOK ? 0.0f : NEG_INF)
                           : __fsub_rn(__fsub_rn(lg[n], m), lse);
      lg[n] = __fadd_rn(sc, lp);
    }
  }
  __syncthreads();

  // Top K: K rounds of a block-wide argmax (ties to the lowest flat index
  // k * V + n), masking each pick.
  for (int j = 0; j < K; ++j) {
    float best = 0.0f;
    int bi = -1;
    for (int f = threadIdx.x; f < K * V; f += THREADS)  // rising per thread
      arg_better(best, bi, tot[f], f);
    warp_argmax(best, bi);
    if (lane == 0) {
      s_rv[warp] = best;
      s_ri[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w) arg_better(best, bi, s_rv[w], s_ri[w]);
      s.bpar[j] = bi / V;
      s.bnew[j] = bi % V;
      s.bval[j] = best;
      tot[bi] = NEG_INF;
    }
    __syncthreads();
  }

  // Back-pointers and the beams' new state.
  int* bp_par = p.bp_parent + ((size_t)i * d.max_length + t) * K;
  int* bp_wr = p.bp_write + ((size_t)i * d.max_length + t) * K;
  for (int j = threadIdx.x; j < K; j += THREADS) {
    const int par = base + s.bpar[j];
    const int fp = p.fin[par];
    bp_par[j] = s.bpar[j];
    bp_wr[j] = fp ? PAD_TOK : s.bnew[j];
    s.bfin[j] = fp || s.bnew[j] == EOS_TOK;
    s.blen[j] = fp ? p.len[par] : p.len[par] + 1;
  }
  __syncthreads();
  int all = 1;
  for (int j = 0; j < K; ++j) all &= s.bfin[j];
  for (int j = threadIdx.x; j < K; j += THREADS) {
    p.fin[base + j] = s.bfin[j];
    p.len[base + j] = s.blen[j];
    p.score[base + j] = s.bval[j];
    p.tok[base + j] = s.bnew[j];
    p.parent[base + j] = base + s.bpar[j];
  }
  if (threadIdx.x == 0 && all) {
    p.done[i] = 1;
    p.steps[i] = t + 1;
  }
  __syncthreads();
}

// The rows of the images still searching, in order (the whole block).
template <typename T>
__device__ int searching_rows(const Params<T>& p, int* act) {
  __shared__ int s_n;
  const Dims& d = p.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    int kept = 0;
    for (int i0 = 0; i0 < d.R; i0 += 32) {
      const int r = i0 + lane;
      const bool keep = r < d.R && !p.done[r / d.K];
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) act[kept + __popc(m & ((1u << lane) - 1u))] = r;
      kept += __popc(m);
    }
    if (lane == 0) s_n = kept;
  }
  __syncthreads();
  const int n = s_n;
  __syncthreads();
  return n;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) beam_decode_kernel(Params<T> p) {
  extern __shared__ double2 smem_raw[];
  const Dims& d = p.d;
  const Smem s = carve<T>(smem_raw, d);
  cg::grid_group grid = cg::this_grid();
  // The rows of images still searching.
  int* act = p.rows + (size_t)blockIdx.x * 2 * d.R;

  stamp(p, 0);
  init_state(p);
  if constexpr (kMma<T>) load_slices(p, s);
  load_v(p, s);
  for (size_t r = (size_t)blockIdx.x * THREADS + threadIdx.x; r < (size_t)d.R;
       r += (size_t)gridDim.x * THREADS) {
    p.tok[r] = BOS_TOK;
    p.parent[r] = (int)r;
    p.score[r] = r % d.K == 0 ? 0.0f : NEG_INF;  // only beam 0 is live
    p.fin[r] = 0;
    p.len[r] = 0;
    if (r % d.K == 0) {
      p.done[r / d.K] = 0;
      p.steps[r / d.K] = d.max_length;
    }
  }
  int nact = all_rows(act, d.R);
  grid.sync();
  stamp(p, 1);
  phase_head(p, s, act, nact, 0, false);
  grid.sync();
  stamp(p, 2);

  int hb = 0;
  for (int t = 0;; ++t) {
    const int st = 3 + t * 5;
    phase_scores(p, s, act, nact);
    grid.sync();
    stamp(p, st);
    att_note(phase_attend<true>(p, s, act, nact));
    grid.sync();
    stamp(p, st + 1);
    phase_lstm(p, s, act, nact, p.tok, hb);
    grid.sync();
    stamp(p, st + 2);
    phase_head(p, s, act, nact, hb ^ 1, true);
    grid.sync();
    stamp(p, st + 3);
    for (int i = blockIdx.x; i < d.B; i += gridDim.x)
      if (!p.done[i]) select_beams(p, s, i, t);
    grid.sync();
    stamp(p, st + 4);
    nact = searching_rows(p, act);
    if (nact == 0 || t + 1 == d.max_length) break;  // the same in every block
    hb ^= 1;
  }
  att_flush(p);

  // Trace every beam's tokens back through the parents; later positions
  // keep the PAD the caller filled in.
  for (int i = blockIdx.x; i < d.B; i += gridDim.x) {
    for (int k = threadIdx.x; k < d.K; k += THREADS) {
      int cur = k;
      int* row = p.preds + ((size_t)i * d.K + k) * d.max_length;
      for (int st = p.steps[i] - 1; st >= 0; --st) {
        const size_t at = ((size_t)i * d.max_length + st) * d.K + cur;
        row[st] = p.bp_write[at];
        cur = p.bp_parent[at];
      }
      p.score_out[(size_t)i * d.K + k] = p.score[i * d.K + k];
      p.lens_out[(size_t)i * d.K + k] = p.len[i * d.K + k];
    }
  }
}

}  // namespace

extern "C" {

// As sd_fused_decode_grid, for K2 at dims[D_K] beams.
int sd_fused_beam_grid(int dtype, const int* dims, int* grid) {
  const Dims d = make_dims(dims);
  if (dtype == 0)
    return grid_size<float>(beam_decode_kernel<float>, d, grid);
  if (dtype == 1)
    return grid_size<__nv_bfloat16>(beam_decode_kernel<__nv_bfloat16>, d,
                                    grid);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32 stream, 1 = bfloat16 stream (the head is float32 in
// both). ptrs in sd::Ptr order; preds (B, K, max_length) int32 must hold PAD
// already; score_out (B, K) float32 and lens_out (B, K) int32 are written.
// 1 <= K <= V. One cooperative launch of `grid` blocks on `stream`. Returns
// the CUDA error code of the launch (0 on success).
int sd_fused_beam_decode(int dtype, const void* const* ptrs, const int* dims,
                         int grid, void* stream) {
  cudaGetLastError();  // report this launch's error, not an earlier one
  const Dims d = make_dims(dims);
  if (d.K < 1 || d.K > d.V) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(beam_decode_kernel<float>, ptrs, d, grid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(beam_decode_kernel<__nv_bfloat16>, ptrs, d,
                                 grid, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
