// Flash attention forward over explicit positions, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body `_kernel`): causal or sliding-window GQA attention
// with an online softmax whose state (m, l, acc) stays in f32 on chip,
// scale dh^-0.5, masked logits dropped, output acc / max(l, 1e-30) in the
// inputs' type.  Serving needs three things the TPU kernel lacks, which
// the reference model's XLA path (models/layers.py::_attn_chunk) has:
//   * positions instead of implicit indices: q_pos (B, Tq), k_pos (B, Tk)
//     int32.  A key is live for a query when k_pos >= 0 and, if causal,
//     0 <= q_pos - k_pos < window (window = 1 << 30 means unbounded);
//     without `causal` every key with k_pos >= 0 is live.  Empty cache
//     slots (k_pos = -1) and wrapped rings fall out of this;
//   * any Tq and Tk (Tq = 1 for decode; Tk a 1024-slot ring or a paged
//     logical length, plus the chunk);
//   * the block skip in positions: a block skips a K/V tile when no key of
//     it is live for any valid query of its Q tile, tested from the tile's
//     smallest and largest valid k_pos against the Q tile's smallest and
//     largest valid q_pos and the window.  This keeps a window of W at
//     O(S * W), and skips the empty slots of a cache.
// Rows with q_pos < 0 are padding that no caller reads: a Q tile made only
// of them writes zeros and returns, and such rows in a mixed tile are
// written as zeros.  Masked keys get probability 0 exactly (not
// exp(-1e30 - m)), so a row without a live key gives 0, as the TPU kernel
// gives for a row whose key blocks were all skipped.
//
// Layout: one block of 256 threads per (64-query tile, query head, batch
// row); the KV head is h / (Hq / Hkv).  Q (64 x dh) is held in shared
// memory as f32, K and V stream through it 32 keys at a time, converted to
// f32; scores, the softmax and the product with V are f32 FMAs (the TPU
// kernel also keeps the probabilities in f32).  Shared memory at dh = 256:
// 141 KB, so one block per SM.  Instantiated for dh in {16, 32, 64, 128,
// 256} and f32 or bf16 inputs.  A decode call (Tq = 1, at most 8 query heads
// per KV head) goes to a second layout instead (flash_decode below): one
// block per (128-key split, KV head, batch row) holding all the KV head's
// query heads, then a small kernel that merges the splits' (m, l, acc).
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the work is
// 4 * dh * Hq * (live query-key pairs) operations against the bytes it
// needs moved once: the valid query rows of q and the output, the K/V
// rows of keys live for some valid query of their batch row, and the
// positions.  The served chunk ticks are bound by operations; a decode
// tick (Tq = 1) is bound by reading the cache.  This first version reaches neither: it uses f32 FMAs
// from shared memory (no tensor cores, no TMA, no wgmma) and reads K/V
// after the caller has concatenated (and, for paged entries, gathered)
// them.  What it does do about the bound is the positional skip, which
// cuts the work to the live pairs' tiles, and, for decode, the key splits
// that spread one token's read of the cache over the card instead of over
// B x Hq blocks.  Tensor cores and reading K/V through the block table are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 32;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int SS = BK + 1;  // padded row stride of the score tile
constexpr int NW = NT / 32;   // warps per block
constexpr int DSPLIT = 128;   // keys per block of the decode kernel
constexpr int MAXG = 8;       // query heads per KV head it takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int dh) {
  const size_t qs = (size_t)dh + 1;          // padded q/k row stride
  const size_t floats = BQ * qs              // Q tile
                      + BK * qs              // K tile
                      + (size_t)BK * dh      // V tile
                      + (size_t)BQ * SS      // scores / probabilities
                      + 3 * BQ;              // m, l, alpha per row
  return floats * sizeof(float) + (BQ + BK) * sizeof(int);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ q_pos,
          const int* __restrict__ k_pos, T* __restrict__ out, int Tq, int Tk,
          int Hq, int Hkv, int window, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = DH + 1;
  constexpr int CJ = DH / 16;         // output columns per thread
  float* Qs = smem;                   // BQ x QS
  float* Ks = Qs + BQ * QS;           // BK x QS
  float* Vs = Ks + BK * QS;           // BK x DH
  float* Ss = Vs + BK * DH;           // BQ x SS
  float* m_s = Ss + BQ * SS;          // BQ
  float* l_s = m_s + BQ;              // BQ
  float* a_s = l_s + BQ;              // BQ
  int* qp = reinterpret_cast<int*>(a_s + BQ);  // BQ
  int* kp = qp + BQ;                           // BK

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_row = (size_t)Hq * DH;      // stride between query rows
  const size_t kv_row = (size_t)Hkv * DH;    // stride between key rows
  const T* q_base = q + ((size_t)b * Tq * Hq + h) * DH;
  T* o_base = out + ((size_t)b * Tq * Hq + h) * DH;
  const T* k_base = k + ((size_t)b * Tk * Hkv + hk) * DH;
  const T* v_base = v + ((size_t)b * Tk * Hkv + hk) * DH;

  for (int r = tid; r < BQ; r += NT)
    qp[r] = q0 + r < Tq ? q_pos[(size_t)b * Tq + q0 + r] : -1;
  __syncthreads();
  int qmin = INT_MAX, qmax = -1;             // over the tile's valid rows
  for (int r = 0; r < BQ; ++r) {
    const int p = qp[r];
    if (p >= 0) { qmin = min(qmin, p); qmax = max(qmax, p); }
  }
  if (qmax < 0) {                            // only padding rows
    for (int i = tid; i < BQ * DH; i += NT) {
      const int r = i / DH, c = i % DH;
      if (q0 + r < Tq) store_f(o_base + (size_t)(q0 + r) * q_row + c, 0.f);
    }
    return;
  }
  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, c = i % DH;
    Qs[r * QS + c] =
        q0 + r < Tq ? to_f(q_base[(size_t)(q0 + r) * q_row + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // roles: scores rows {sr, sr + 32} x cols {sc + 8j}; softmax 4 threads a
  // row; output rows ar*4 .. ar*4+3 x cols {ac + 16j}
  const int sr = tid >> 3, sc = tid & 7;
  const int xr = tid >> 2, xl = tid & 3;
  const int ar = tid >> 4, ac = tid & 15;
  const long long lo = (long long)qmin - window;   // live keys have k > lo
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  __syncthreads();
  const bool s_any = qp[sr] >= 0 || qp[sr + 32] >= 0;
  const bool a_any = qp[ar * 4] >= 0 || qp[ar * 4 + 1] >= 0 ||
                     qp[ar * 4 + 2] >= 0 || qp[ar * 4 + 3] >= 0;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();                         // the last tile's readers are done
    for (int c = tid; c < BK; c += NT)
      kp[c] = k0 + c < Tk ? k_pos[(size_t)b * Tk + k0 + c] : -1;
    __syncthreads();
    int kmin = INT_MAX, kmax = -1;
    for (int c = 0; c < BK; ++c) {
      const int p = kp[c];
      if (p >= 0) { kmin = min(kmin, p); kmax = max(kmax, p); }
    }
    if (kmax < 0) continue;                  // no valid key in the tile
    if (causal && (kmin > qmax || (long long)kmax <= lo)) continue;

    for (int i = tid; i < BK * DH; i += NT) {
      const int r = i / DH, c = i % DH;
      const bool in = k0 + r < Tk;
      const size_t off = (size_t)(k0 + r) * kv_row + c;
      Ks[r * QS + c] = in ? to_f(k_base[off]) : 0.f;
      Vs[r * DH + c] = in ? to_f(v_base[off]) : 0.f;
    }
    __syncthreads();

    {  // scores of the tile, masked to -inf
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      if (s_any) {
        const float* qa = Qs + sr * QS;
        const float* qb = Qs + (sr + 32) * QS;
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
          const float a0 = qa[d], a1 = qb[d];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float kk = Ks[(sc + 8 * j) * QS + d];
            s[0][j] = fmaf(a0, kk, s[0][j]);
            s[1][j] = fmaf(a1, kk, s[1][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = sr + 32 * i;
        const int pq = qp[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc + 8 * j;
          const int pk = kp[c];
          const int rel = pq - pk;
          const bool live = pq >= 0 && pk >= 0 &&
                            (!causal || (rel >= 0 && rel < window));
          Ss[r * SS + c] = live ? s[i][j] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    {  // online softmax, 4 threads per row
      float* row = Ss + xr * SS;
      float mx = -INFINITY;
      for (int c = xl; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[xr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = xl; c < BK; c += 4) {
        const float x = row[c];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      if (xl == 0) {
        m_s[xr] = m_new;
        l_s[xr] = l_s[xr] * alpha + sum;
        a_s[xr] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {            // acc = acc * alpha + P V
      const float al = a_s[ar * 4 + i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= al;
    }
    if (a_any) {
      for (int kk = 0; kk < BK; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ss[(ar * 4 + i) * SS + kk];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const float vv = Vs[kk * DH + ac + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ar * 4 + i;
    if (q0 + r >= Tq) continue;
    const bool valid = qp[r] >= 0;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* o = o_base + (size_t)(q0 + r) * q_row;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      store_f(o + ac + 16 * j, valid ? acc[i][j] / den : 0.f);
  }
}

// Decode (Tq = 1): the kernel above would give a block one valid query row
// and leave 8 of its 256 threads computing.  Here a block takes one KV head
// with its G query heads and a split of DSPLIT keys; each warp walks every
// 8th key of the split, its lanes holding dh/32 elements of the key, the
// value and G running (m, l, acc); the warps are merged in shared memory
// and the block writes its split's (m, l, acc) to a workspace that
// flash_decode_combine merges over the splits.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_decode(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos, float* __restrict__ part, int Tk,
             int Hq, int Hkv, int window, int causal, float scale,
             int n_split) {
  constexpr int E = (DH + 31) / 32;   // elements per lane
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* qs = smem;                   // G x DH
  float* wm = qs + G * DH;            // NW x G
  float* wl = wm + NW * G;            // NW x G
  float* wacc = wl + NW * G;          // NW x G x DH
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = q_pos[b];

  for (int i = tid; i < G * DH; i += NT)
    qs[i] = to_f(q[((size_t)b * Hq + hk * G) * DH + i]);
  __syncthreads();
  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  const int k_hi = min((sp + 1) * DSPLIT, Tk);
  for (int kk = sp * DSPLIT + warp; qp >= 0 && kk < k_hi; kk += NW) {
    const int pk = k_pos[(size_t)b * Tk + kk];
    const int rel = qp - pk;
    if (pk < 0 || (causal && (rel < 0 || rel >= window))) continue;
    const size_t row = ((size_t)(b * Tk + kk) * Hkv + hk) * DH;
    float kr[E], vr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      kr[e] = d < DH ? to_f(k[row + d]) : 0.f;
      vr[e] = d < DH ? to_f(v[row + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + 32 * e;
        if (d < DH) dot = fmaf(qs[g * DH + d], kr[e], dot);
      }
      for (int o = 16; o; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float sc = dot * scale;
      const float m_new = fmaxf(m[g], sc);
      const float alpha = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(acc[g][e], alpha, p * vr[e]);
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      if (d < DH) wacc[(warp * G + g) * DH + d] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float mw = wm[w * G + g];
      const float c = mw == -INFINITY ? 0.f : expf(mw - M);
      L = fmaf(wl[w * G + g], c, L);
      A = fmaf(wacc[(w * G + g) * DH + d], c, A);
    }
    float* o = part + (((size_t)b * Hq + hk * G + g) * n_split + sp) * (DH + 2);
    if (d == 0) {
      o[0] = M;
      o[1] = L;
    }
    o[2 + d] = A;
  }
}

// Merge the splits' (m, l, acc) of one (batch row, query head); one thread
// per output element.
template <typename T, int DH>
__global__ void flash_decode_combine(const float* __restrict__ part,
                                     const int* __restrict__ q_pos,
                                     T* __restrict__ out, int Hq,
                                     int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* p = part + ((size_t)b * Hq + h) * n_split * (DH + 2);
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, p[s * (DH + 2)]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = p[s * (DH + 2)];
    const float c = ms == -INFINITY ? 0.f : expf(ms - M);
    L = fmaf(p[s * (DH + 2) + 1], c, L);
    A = fmaf(p[s * (DH + 2) + 2 + d], c, A);
  }
  store_f(out + ((size_t)b * Hq + h) * DH + d,
          q_pos[b] >= 0 ? A / fmaxf(L, 1e-30f) : 0.f);
}

int n_splits(int Tk) { return (Tk + DSPLIT - 1) / DSPLIT; }

bool use_decode(int Tq, int Hq, int Hkv) { return Tq == 1 && Hq / Hkv <= MAXG; }

size_t decode_smem_bytes(int G, int dh) {
  return ((size_t)G * dh + 2 * NW * G + (size_t)NW * G * dh) * sizeof(float);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* out, void* part, int B, int Tq, int Tk,
           int Hq, int Hkv, int window, int causal, float scale,
           cudaStream_t stream) {
  cudaError_t err;
  if (use_decode(Tq, Hq, Hkv)) {
    const int ns = n_splits(Tk);
    const size_t smem = decode_smem_bytes(Hq / Hkv, DH);
    err = cudaFuncSetAttribute(flash_decode<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_decode<T, DH><<<dim3(ns, Hkv, B), NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(q_pos),
        static_cast<const int*>(k_pos), static_cast<float*>(part), Tk, Hq,
        Hkv, window, causal, scale, ns);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_decode_combine<T, DH><<<dim3(Hq, B), DH, 0, stream>>>(
        static_cast<const float*>(part), static_cast<const int*>(q_pos),
        static_cast<T*>(out), Hq, ns);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_bytes(DH);
  err = cudaFuncSetAttribute(flash_fwd<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<T*>(out), Tq, Tk, Hq, Hkv,
      window, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v,
             const void* q_pos, const void* k_pos, void* out, void* part,
             int B, int Tq, int Tk, int Hq, int Hkv, int window, int causal,
             float scale, cudaStream_t s) {
#define FLASH_CASE(D)                                                      \
  case D:                                                                  \
    return launch<T, D>(q, k, v, q_pos, k_pos, out, part, B, Tq, Tk, Hq,   \
                        Hkv, window, causal, scale, s);
  switch (dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// q (B, Tq, Hq, dh), k/v (B, Tk, Hkv, dh), out (B, Tq, Hq, dh): contiguous,
// all f32 (bf16 = 0) or all bf16 (bf16 = 1); q_pos (B, Tq), k_pos (B, Tk)
// int32; part: f32 workspace of flash_attention_workspace_bytes (may be
// null when that is 0).  Returns 0 or the CUDA error of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, void* out,
                        void* part, int B, int Tq, int Tk, int Hq, int Hkv,
                        int dh, int bf16, int window, int causal, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, q_pos, k_pos, out, part, B,
                                   Tq, Tk, Hq, Hkv, window, causal, scale, s);
  return dispatch<float>(dh, q, k, v, q_pos, k_pos, out, part, B, Tq, Tk, Hq,
                         Hkv, window, causal, scale, s);
}

size_t flash_attention_workspace_bytes(int B, int Tq, int Tk, int Hq,
                                       int Hkv, int dh) {
  if (!use_decode(Tq, Hq, Hkv)) return 0;
  return (size_t)B * Hq * n_splits(Tk) * (dh + 2) * sizeof(float);
}

size_t flash_attention_smem_bytes(int dh) { return smem_bytes(dh); }

}  // extern "C"
