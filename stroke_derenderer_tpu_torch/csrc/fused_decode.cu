// K1: the whole greedy decode loop of the stroke decoder in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `_fused_greedy_decode_tpu` of
// stroke_derenderer_tpu/kernels/fused_decode.py. Each step of each row does:
// additive attention over the P encoder positions with a softmax, the
// attended vector times sigmoid(h Wf + bf), an LSTM step on [emb; awe]
// (Wx (D+E, 4H), Wh (H, 4H), bias), the float32 vocabulary head, argmax
// (ties to the lowest index), the embedding of the chosen token, and masked
// retirement: a row that emitted EOS writes PAD from then on.
//
// The step runs on the engine of decode_step.cuh, which says what bounds it
// and how the work is spread over the card: one cooperative launch, every
// block owning a slice of every matrix's columns, four grid barriers per
// step; phases A and D on the tensor cores for bfloat16 streams (the
// block's slices resident in shared memory for the launch), on CUDA cores
// in float64 for float32 streams. The loop is skewed by one phase so that the head of step t shares
// phase A with the projections of step t + 1:
//
//   prologue  A (dp, gate from h0) | sync
//   step t    B scores | sync | C attend | sync | D LSTM | sync |
//             A (logits of t; dp, gate for t + 1) | sync |
//             argmax of t, in every block, on the same logits in the same
//             order: each block retires the same rows, compacts the same
//             list of active rows and decides alike whether to stop.
//
// A retired row's state is never read again, so it is not kept.

#include "decode_step.cuh"

namespace {

using namespace sd;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    greedy_decode_kernel(Params<T> p) {
  extern __shared__ double2 smem_raw[];
  __shared__ int s_nact;
  const Dims& d = p.d;
  const Smem s = carve<T>(smem_raw, d);
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // This block's copy of the active rows and of each row's next token.
  int* act = p.rows + (size_t)blockIdx.x * 2 * d.R;
  int* tok = act + d.R;

  stamp(p, 0);
  init_state(p);
  if constexpr (kMma<T>) load_slices(p, s);
  load_v(p, s);
  for (int i = threadIdx.x; i < d.R; i += THREADS) tok[i] = BOS_TOK;
  int nact = all_rows(act, d.R);
  grid.sync();
  stamp(p, 1);
  phase_head(p, s, act, nact, 0, false);
  grid.sync();
  stamp(p, 2);

  int hb = 0;
  for (int t = 0;; ++t) {
    const int st = 3 + t * 4;
    phase_scores(p, s, act, nact);
    grid.sync();
    stamp(p, st);
    att_note(phase_attend<false>(p, s, act, nact));
    grid.sync();
    stamp(p, st + 1);
    phase_lstm(p, s, act, nact, tok, hb);
    grid.sync();
    stamp(p, st + 2);
    phase_head(p, s, act, nact, hb ^ 1, true);
    grid.sync();
    stamp(p, st + 3);

    // Argmax of every active row, ties to the lowest index; the row's
    // owner (row % grid) writes it.
    for (int i = warp; i < nact; i += WARPS) {
      const int r = act[i];
      const float* lg = p.logits + (size_t)r * d.V;
      float best = 0.0f;
      int bi = -1;
      for (int n = lane; n < d.V; n += 32) arg_better(best, bi, lg[n], n);
      warp_argmax(best, bi);
      if (lane == 0) {
        tok[r] = bi;
        if (r % gridDim.x == blockIdx.x)
          p.preds[(size_t)r * d.max_length + t] = bi;
      }
    }
    __syncthreads();
    // Keep the rows that did not emit EOS, in order.
    if (warp == 0) {
      int kept = 0;
      for (int i0 = 0; i0 < nact; i0 += 32) {
        const int i = i0 + lane;
        const int r = i < nact ? act[i] : -1;
        const bool keep = r >= 0 && tok[r] != EOS_TOK;
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) act[kept + __popc(m & ((1u << lane) - 1u))] = r;
        kept += __popc(m);
      }
      if (lane == 0) s_nact = kept;
    }
    __syncthreads();
    nact = s_nact;
    if (nact == 0 || t + 1 == d.max_length) break;  // the same in every block
    hb ^= 1;
  }
  att_flush(p);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 stream, 1 = bfloat16 stream (the head is float32 in
// both). `dims` in sd::Dim order with K = 1. Writes the largest grid the
// card runs at once to *grid. Returns a CUDA error code (0 on success).
int sd_fused_decode_grid(int dtype, const int* dims, int* grid) {
  const Dims d = make_dims(dims);
  if (dtype == 0)
    return grid_size<float>(greedy_decode_kernel<float>, d, grid);
  if (dtype == 1)
    return grid_size<__nv_bfloat16>(greedy_decode_kernel<__nv_bfloat16>, d,
                                    grid);
  return (int)cudaErrorInvalidValue;
}

// ptrs in sd::Ptr order (the beam entries may be null); preds (B,
// max_length) int32 must hold PAD already. One cooperative launch of
// `grid` blocks on `stream`. Returns the CUDA error code of the launch.
int sd_fused_greedy_decode(int dtype, const void* const* ptrs,
                           const int* dims, int grid, void* stream) {
  cudaGetLastError();  // report this launch's error, not an earlier one
  const Dims d = make_dims(dims);
  auto s = static_cast<cudaStream_t>(stream);
  if (dims[D_K] != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(greedy_decode_kernel<float>, ptrs, d, grid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(greedy_decode_kernel<__nv_bfloat16>, ptrs,
                                 d, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The barrier probe: one cooperative launch of `grid` blocks crossing `n`
// grid barriers. Returns the CUDA error code of the launch.
int sd_barrier_probe(int n, int grid, void* stream) {
  cudaGetLastError();
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)barrier_probe_kernel, dim3(grid), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
