// K3: the attention and gate of one decode step, fused.
//
// Replaces the Pallas TPU kernel `_kernel` / `_fused_attention_gate_tpu` of
// stroke_derenderer_tpu/kernels/decode_attention.py. For each row b:
//
//     dec     = h W_att + b_att                                   (A)
//     score_p = v . relu(enc_proj[p] + dec)                       (P)
//     alpha   = softmax_p(score)                                  (P)
//     out     = sigmoid(h W_f + b_f) * sum_p alpha_p enc[p]       (E)
//
// Every input is bfloat16, as the TPU kernel streams it; all arithmetic is
// float32, and out and alpha are float32. The bias of v is left out: it
// shifts every score equally and cancels in the softmax (so does the TPU
// kernel).
//
// What bounds it on an H100: the bytes. At the shipped widths one row reads
// its 196 x 512 encoder rows and projections (0.4 MB) and the 1 MB of W_att
// and W_f for about 1 MFLOP; the weights are shared by all rows and stay in
// the 50 MB L2 cache.
//
// Design (simple first): one block per row, so B rows run on B SMs at
// once. A thread owns one output column of h W_att and h W_f (neighbouring
// threads read neighbouring weights); a warp owns one position of the
// scores; one warp takes the softmax; a thread owns one column of the
// attended sum. h, dec, the gate and the scores live in shared memory.
// The TPU kernel padded P and B to its tile sizes; here nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(__ldg(p));
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

__global__ void __launch_bounds__(THREADS) attention_gate_kernel(
    const bf16* __restrict__ enc, const bf16* __restrict__ proj,
    const bf16* __restrict__ h, const bf16* __restrict__ watt,
    const bf16* __restrict__ batt, const bf16* __restrict__ v,
    const bf16* __restrict__ wf, const bf16* __restrict__ bf,
    float* __restrict__ out, float* __restrict__ alpha, int P, int E, int A,
    int D) {
  extern __shared__ float smem[];
  float* s_h = smem;         // D
  float* s_dec = s_h + D;    // A: h W_att + b_att
  float* s_gate = s_dec + A; // E: sigmoid(h W_f + b_f)
  float* s_sc = s_gate + E;  // P: scores, then alpha

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const bf16* enc_b = enc + (size_t)b * P * E;
  const bf16* proj_b = proj + (size_t)b * P * A;

  for (int i = tid; i < D; i += THREADS) s_h[i] = ld(h + (size_t)b * D + i);
  __syncthreads();

  // 1. h W_att + b_att and the gate, a column per thread.
  for (int col = tid; col < A + E; col += THREADS) {
    const bool is_att = col < A;
    const int n = is_att ? col : col - A;
    const int ldw = is_att ? A : E;
    const bf16* w = (is_att ? watt : wf) + n;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) acc = fmaf(s_h[k], ld(w + (size_t)k * ldw), acc);
    if (is_att)
      s_dec[n] = acc + ld(batt + n);
    else
      s_gate[n] = 1.0f / (1.0f + expf(-(acc + ld(bf + n))));
  }
  __syncthreads();

  // 2. Scores, a warp per position.
  for (int p = warp; p < P; p += WARPS) {
    const bf16* pp = proj_b + (size_t)p * A;
    float s = 0.0f;
    for (int a = lane; a < A; a += 32)
      s = fmaf(fmaxf(ld(pp + a) + s_dec[a], 0.0f), ld(v + a), s);
    s = warp_sum(s);
    if (lane == 0) s_sc[p] = s;
  }
  __syncthreads();

  // 3. Softmax over the positions, one warp.
  if (warp == 0) {
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, s_sc[p]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int p = lane; p < P; p += 32) {
      const float ex = expf(s_sc[p] - m);
      s_sc[p] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int p = lane; p < P; p += 32) {
      const float al = s_sc[p] / sum;
      s_sc[p] = al;
      alpha[(size_t)b * P + p] = al;
    }
  }
  __syncthreads();

  // 4. The attended sum, a column per thread, times the gate.
  for (int e = tid; e < E; e += THREADS) {
    float acc = 0.0f;
#pragma unroll 4
    for (int p = 0; p < P; ++p)
      acc = fmaf(s_sc[p], ld(enc_b + (size_t)p * E + e), acc);
    out[(size_t)b * E + e] = s_gate[e] * acc;
  }
}

}  // namespace

extern "C" {

// All inputs bfloat16 and contiguous: enc (B, P, E), proj (B, P, A), h
// (B, D), watt (D, A), batt (A), v (A), wf (D, E), bf (E). Writes out
// (B, E) and alpha (B, P), float32. Returns the CUDA error code of the
// launch (0 on success).
int sd_attention_gate(const void* enc, const void* proj, const void* h,
                      const void* watt, const void* batt, const void* v,
                      const void* wf, const void* bf, void* out, void* alpha,
                      int B, int P, int E, int A, int D, void* stream) {
  cudaGetLastError();  // report this launch's error, not an earlier one
  const size_t smem = sizeof(float) * ((size_t)D + A + E + P);
  cudaError_t err = cudaFuncSetAttribute(
      attention_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_gate_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(
                                                stream)>>>(
      (const bf16*)enc, (const bf16*)proj, (const bf16*)h,
      (const bf16*)watt, (const bf16*)batt, (const bf16*)v, (const bf16*)wf,
      (const bf16*)bf, (float*)out, (float*)alpha, P, E, A, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
