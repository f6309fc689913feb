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
// Which layout runs is a pure function of (dtype, dh, Tq, Hq / Hkv)
// (flash_attention_layout):
//   * decode: Tq = 1 and at most 8 query heads per KV head, any dtype and
//     dh (flash_decode below): one block per (128-key split, KV head, batch
//     row) holding all the KV head's query heads, then a small kernel that
//     merges the splits' (m, l, acc);
//   * wgmma: otherwise, bf16 at dh in {64, 128, 256} (wg::flash_wgmma
//     below): TMA loads into a two-stage ring, Q K^T and P V on the tensor
//     cores with wgmma, the softmax in f32 registers;
//   * fma: otherwise (f32, since wgmma has no f32 mode and TF32 would not
//     hold f32 to 1e-4; bf16 at dh 16 and 32): one block of 256 threads per
//     (64-query tile, query head, batch row).  Q (64 x dh) is held in
//     shared memory as f32, K and V stream through it 32 keys at a time,
//     converted to f32; scores, the softmax and the product with V are f32
//     FMAs.  Shared memory at dh = 256: 141 KB.
// No call is retried in another layout: a call its layout cannot launch
// returns the CUDA error, and the wrapper raises.  Instantiated for dh in
// {16, 32, 64, 128, 256} and f32 or bf16 inputs.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the work is
// 4 * dh * Hq * (live query-key pairs) operations against the bytes it
// needs moved once: the valid query rows of q and the output, the K/V
// rows of keys live for some valid query of their batch row, and the
// positions.  The served chunk ticks are bound by operations; a decode
// tick (Tq = 1) is bound by reading the cache.  The wgmma layout puts the
// chunk ticks' products on the tensor cores, overlaps the loads of the
// next K/V tile with them, and skips by positions the tiles no query can
// see; it still does half again the tensor work the bound counts (P in two
// bf16 terms) and reads K/V after the caller has concatenated (and, for
// paged entries, gathered) them.  The decode layout spreads one token's
// read of the cache over the card in key splits.  Reading K/V through the
// block table is later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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

enum Layout { FMA = 1, WGMMA = 2, DECODE = 3 };

int layout_of(bool bf16, int dh, int Tq, int Hq, int Hkv) {
  if (use_decode(Tq, Hq, Hkv)) return DECODE;
  if (bf16 && (dh == 64 || dh == 128 || dh == 256)) return WGMMA;
  return FMA;
}

// ---------------------------------------------------------------------------
// Tensor-core layout (bf16, dh in {64, 128, 256}, every call that does not
// take the decode layout).
//
// A block of 384 threads takes 128 query rows of one (query head, batch
// row): two consumer warpgroups of 64 rows each and a producer warpgroup
// of which one warp works (setmaxnreg gives it 40 registers a thread and
// each consumer 232, which the O accumulator, dh/2 f32 a thread at dh 256,
// S (32) and P (32) need without spilling).  Within a batch row, blocks
// start with the last query tiles of every head, which see the most keys.
//
// The producer loads the Q tile once, then streams K and V tiles of 64
// keys through a ring of two stages in shared memory with TMA (4-d tensor
// maps over (dh, head, position, batch); 128-byte swizzle; positions past
// Tq or Tk read as zeros), each stage guarded by two `full` mbarriers (K,
// V: the scores start while V still loads) and an `empty` one.  It reads
// the tile's 64 k_pos first and does not load a tile whose keys are all
// empty or, if causal, all outside every valid query's window; it hands
// the consumers the tile's start, its smallest and largest valid position
// and the positions themselves, and ends the ring with a stage whose start
// is -1.
//
// A consumer warpgroup skips, in the same way, a tile no row of its own 64
// can see, and otherwise computes
//   S = Q K^T           wgmma m64n64k16 from shared memory (K-major both),
//   the masked online softmax in f32 registers (exp2 of logits scaled by
//   dh^-0.5 * log2 e; a masked key gets probability 0 exactly),
//   O = O * alpha + P V  wgmma m64n{dh}k16, P from registers, V MN-major.
// P enters the product as two bf16 terms, P = hi + lo with hi = bf16(P) and
// lo = bf16(P - hi): with one bf16 term the product would round each
// probability to 8 bits, an error that does not shrink where the output
// itself is near 0; with two it keeps P to about 16 bits, as the FMA layout
// keeps it in f32.  This costs half again the tensor work of S and P V.
// Shared memory at dh = 256: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) =
// 192 KB, so one block per SM.
namespace wg {

constexpr int BM = 128;             // query rows per block
constexpr int BN = 64;              // keys per K/V tile
constexpr int NSTAGE = 2;           // stages of the K/V ring
constexpr int PF = 8;               // tiles of k_pos the producer reads at once
constexpr int NCONS = 256;          // consumer threads (two warpgroups)
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int ATOM = 64 * 128;      // bytes of 64 rows x 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Smem {                       // byte offsets from a 1024-aligned base
  static constexpr int NA = DH / 64;              // 64-column atoms a row
  static constexpr int Q = 0;
  static constexpr int Q_BYTES = BM * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;    // K or V, one stage
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + NSTAGE * KV_BYTES;
  static constexpr int KPOS = V + NSTAGE * KV_BYTES;  // NSTAGE x BN int
  static constexpr int META = KPOS + NSTAGE * BN * 4; // NSTAGE x 4 int
  static constexpr int QPOS = META + NSTAGE * 16;     // BM int
  static constexpr int BAR = QPOS + BM * 4;  // q, full_k[], full_v[], empty[]
  static constexpr int END = BAR + (1 + 3 * NSTAGE) * 8;
  static constexpr int ALLOC = END + 1024;            // room to align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// waits until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The inline PTX names every accumulator register, so each shape is
// written out.
// d (64 x 64, f32) = (scale_d ? d : 0) + A B^T; A (64 x 16) and B (64 x 16)
// bf16 in shared memory, both K-major, by descriptor
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A B; A (64 x 16 bf16) from registers, B (16 x 64
// bf16) in shared memory, MN-major (transposed), by descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A B; A (64 x 16 bf16) from registers, B (16 x 128
// bf16) in shared memory, MN-major (transposed), by descriptor
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A B; A (64 x 16 bf16) from registers, B (16 x 256
// bf16) in shared memory, MN-major (transposed), by descriptor
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  wgmma_rs_n64(d, a0, a1, a2, a3, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  wgmma_rs_n128(d, a0, a1, a2, a3, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  wgmma_rs_n256(d, a0, a1, a2, a3, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tmQ,
            const __grid_constant__ CUtensorMap tmK,
            const __grid_constant__ CUtensorMap tmV,
            const int* __restrict__ q_pos, const int* __restrict__ k_pos,
            __nv_bfloat16* __restrict__ out, int Tq, int Tk, int Hq, int Hkv,
            int window, int causal, float scale_log2) {
  using L = Smem<DH>;
  constexpr int NA = L::NA;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(sm);
  int* kpos = reinterpret_cast<int*>(sm + L::KPOS);
  int* meta = reinterpret_cast<int*>(sm + L::META);
  int* qp = reinterpret_cast<int*>(sm + L::QPOS);
  const uint32_t qbar = sb + L::BAR;
  const uint32_t full = qbar + 8, full_v = full + 8 * NSTAGE;
  const uint32_t empty = full_v + 8 * NSTAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // blocks in the order (batch row, query tile from the last, head): the
  // last query tiles see the most keys, so every head's start first
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int per_b = gridDim.x * gridDim.y;
  const int b = lin / per_b, r = lin % per_b;
  const int q0 = (gridDim.x - 1 - r / gridDim.y) * BM;
  const int h = r % gridDim.y;
  const int hk = h / (Hq / Hkv);
  for (int r = tid; r < BM; r += NTHREADS)
    qp[r] = q0 + r < Tq ? q_pos[(size_t)b * Tq + q0 + r] : -1;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 32);          // the producer warp's lanes
      mbar_init(full_v + 8 * s, 1);         // its first lane
      mbar_init(empty + 8 * s, NCONS);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = -1;            // over the block's valid rows
  for (int r = 0; r < BM; ++r) {
    const int p = qp[r];
    if (p >= 0) { qmin = min(qmin, p); qmax = max(qmax, p); }
  }
  if (qmax < 0) {                           // only padding rows
    const size_t row = (size_t)Hq * DH;
    __nv_bfloat16* o = out + ((size_t)b * Tq * Hq + h) * DH;
    for (int i = tid; i < BM * DH; i += NTHREADS) {
      const int r = i / DH, c = i % DH;
      if (q0 + r < Tq) o[(size_t)(q0 + r) * row + c] = __float2bfloat16(0.f);
    }
    return;
  }

  if (warp >= NCONS / 32) {
    // ---- producer warpgroup: its first warp loads, the others leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != NCONS / 32) return;
    const long long lo = (long long)qmin - window;   // live keys have k > lo
    if (lane == 0) {
      mbar_arrive_tx(qbar, L::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < NA; ++a)
          tma_load(sb + L::Q + (w * NA + a) * ATOM, &tmQ, qbar, a * 64, h,
                   q0 + w * 64, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    const int* kpb = k_pos + (size_t)b * Tk;
    // the positions of PF tiles per round trip to memory: a long run of
    // empty cache slots costs one load latency for every PF tiles
    for (int kb0 = 0; kb0 < Tk; kb0 += PF * BN) {
      int pos[PF][2];
#pragma unroll
      for (int t = 0; t < PF; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = kb0 + t * BN + 32 * e + lane;
          pos[t][e] = kk < Tk ? kpb[kk] : -1;
        }
#pragma unroll
      for (int t = 0; t < PF; ++t) {
        const int k0 = kb0 + t * BN;
        if (k0 >= Tk) break;
        const int p0 = pos[t][0], p1 = pos[t][1];
        const int mn = __reduce_min_sync(
            0xffffffffu, min(p0 >= 0 ? p0 : INT_MAX, p1 >= 0 ? p1 : INT_MAX));
        const int mx = __reduce_max_sync(0xffffffffu, max(p0, p1));
        const int lowest = __reduce_min_sync(0xffffffffu, min(p0, p1));
        if (mx < 0) continue;                 // no valid key in the tile
        if (causal && (mn > qmax || (long long)mx <= lo)) continue;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        kpos[stage * BN + lane] = p0;
        kpos[stage * BN + 32 + lane] = p1;
        if (lane == 0) {
          meta[stage * 4] = k0;
          meta[stage * 4 + 1] = mn;
          meta[stage * 4 + 2] = mx;
          meta[stage * 4 + 3] = lowest >= 0;  // every key of the tile valid
          mbar_arrive_tx(full + 8 * stage, L::KV_BYTES);
          for (int a = 0; a < NA; ++a)
            tma_load(sb + L::K + stage * L::KV_BYTES + a * ATOM, &tmK,
                     full + 8 * stage, a * 64, hk, k0, b);
          mbar_arrive_tx(full_v + 8 * stage, L::KV_BYTES);
          for (int a = 0; a < NA; ++a)
            tma_load(sb + L::V + stage * L::KV_BYTES + a * ATOM, &tmV,
                     full_v + 8 * stage, a * 64, hk, k0, b);
        } else {
          mbar_arrive(full + 8 * stage);
        }
        if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
      }
    }
    mbar_wait(empty + 8 * stage, phase ^ 1);  // the end of the ring
    if (lane == 0) meta[stage * 4] = -1;
    mbar_arrive(full + 8 * stage);
  } else {
    // ---- consumer warpgroup w: rows 64w .. 64w+63 of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = warp >> 2, wl = warp & 3;
    const int ra = 16 * wl + (lane >> 2), rb = ra + 8;   // in the warpgroup
    const int pa = qp[64 * w + ra], pb = qp[64 * w + rb];
    int wmin = INT_MAX, wmax = -1, wvalid = 0;
    for (int r = 64 * w; r < 64 * w + 64; ++r) {
      const int p = qp[r];
      if (p >= 0) { wmin = min(wmin, p); wmax = max(wmax, p); ++wvalid; }
    }
    const long long wlo = (long long)wmin - window;
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
    const uint32_t qdesc_base = sb + L::Q + w * NA * ATOM;
    mbar_wait(qbar, 0);
    __syncwarp();
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full + 8 * stage, phase);
      __syncwarp();
      const int k0 = meta[stage * 4];
      if (k0 < 0) break;
      const int kmn = meta[stage * 4 + 1], kmx = meta[stage * 4 + 2];
      const bool live = wmax >= 0 &&
          !(causal && (kmn > wmax || (long long)kmx <= wlo));
      // every (row, key) pair of the tile live: no mask to apply
      const bool interior = wvalid == 64 && meta[stage * 4 + 3] &&
          (!causal || (kmx <= wmin && (long long)wmax - kmn < window));
      if (live) {                            // uniform in the warpgroup
        const uint32_t kb = sb + L::K + stage * L::KV_BYTES;
        const uint32_t vb = sb + L::V + stage * L::KV_BYTES;
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t off = (kk >> 2) * ATOM + (kk & 3) * 32;
          wgmma_ss_n64(s, desc(qdesc_base + off, 16, 1024),
                       desc(kb + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);

        const int* kp = kpos + stage * BN;
        float mxa = -INFINITY, mxb = -INFINITY;
        if (interior) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s[4 * j + e] *= scale_log2;
              s[4 * j + 2 + e] *= scale_log2;
              mxa = fmaxf(mxa, s[4 * j + e]);
              mxb = fmaxf(mxb, s[4 * j + 2 + e]);
            }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int pk = kp[8 * j + 2 * (lane & 3) + e];
              const int rel_a = pa - pk, rel_b = pb - pk;
              const bool la_ok = pa >= 0 && pk >= 0 &&
                                 (!causal || (rel_a >= 0 && rel_a < window));
              const bool lb_ok = pb >= 0 && pk >= 0 &&
                                 (!causal || (rel_b >= 0 && rel_b < window));
              const float xa = la_ok ? s[4 * j + e] * scale_log2 : -INFINITY;
              const float xb =
                  lb_ok ? s[4 * j + 2 + e] * scale_log2 : -INFINITY;
              s[4 * j + e] = xa;
              s[4 * j + 2 + e] = xb;
              mxa = fmaxf(mxa, xa);
              mxb = fmaxf(mxb, xb);
            }
        }
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
        const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
        const float aa = ma == -INFINITY ? 0.f : exp2f(ma - na);
        const float ab = mb == -INFINITY ? 0.f : exp2f(mb - nb);
        ma = na;
        mb = nb;
        float sa = 0.f, sbm = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xa = s[4 * j + e], xb = s[4 * j + 2 + e];
            const float pa_ = xa == -INFINITY ? 0.f : exp2f(xa - na);
            const float pb_ = xb == -INFINITY ? 0.f : exp2f(xb - nb);
            s[4 * j + e] = pa_;
            s[4 * j + 2 + e] = pb_;
            sa += pa_;
            sbm += pb_;
          }
        la = la * aa + sa;
        lb = lb * ab + sbm;
        // O keeps its scale where no row of the warp has a new maximum
        if (__any_sync(0xffffffffu, aa != 1.f || ab != 1.f)) {
#pragma unroll
          for (int i = 0; i < DH / 2; ++i) o[i] *= (i & 2) ? ab : aa;
        }

        // P as A fragments: k-step kk holds keys 16kk .. 16kk+15
        uint32_t hi[16], lo[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float x0 = s[2 * i], x1 = s[2 * i + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
          const __nv_bfloat162 l2 = __floats2bfloat162_rn(
              x0 - __bfloat162float(h2.x), x1 - __bfloat162float(h2.y));
          hi[i] = bf16x2_bits(h2);
          lo[i] = bf16x2_bits(l2);
        }
        fence_regs(o);
        mbar_wait(full_v + 8 * stage, phase);
        __syncwarp();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = desc(vb + kk * 16 * 128, 64 * 128, 1024);
          wgmma_rs<DH>(o, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                       hi[4 * kk + 3], dv);
          wgmma_rs<DH>(o, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                       lo[4 * kk + 3], dv);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
      } else {
        // the stage is released only once its V has landed as well
        mbar_wait(full_v + 8 * stage, phase);
      }
      mbar_arrive(empty + 8 * stage);
      if (++stage == NSTAGE) { stage = 0; phase ^= 1; }
    }

    la += __shfl_xor_sync(0xffffffffu, la, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    const float da = fmaxf(la, 1e-30f), db = fmaxf(lb, 1e-30f);
    const size_t row = (size_t)Hq * DH;
    __nv_bfloat16* ob = out + ((size_t)b * Tq * Hq + h) * DH;
    const int qa = q0 + 64 * w + ra, qb = q0 + 64 * w + rb;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (qa < Tq) {
        const __nv_bfloat162 x = pa >= 0
            ? __floats2bfloat162_rn(o[4 * j] / da, o[4 * j + 1] / da)
            : __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qa * row + c) = x;
      }
      if (qb < Tq) {
        const __nv_bfloat162 x = pb >= 0
            ? __floats2bfloat162_rn(o[4 * j + 2] / db, o[4 * j + 3] / db)
            : __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qb * row + c) = x;
      }
    }
  }
}

}  // namespace wg

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;   // found at init

// (batch, len, heads, dh) bf16, contiguous, as a 4-d map read in boxes of
// 64 rows x 64 columns of one head, 128-byte swizzle, zeros out of range
bool tensor_map(CUtensorMap* m, const void* p, int dh, int heads, int len,
                int batch) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)len * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(p), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* q_pos, const void* k_pos, void* out, int B,
                 int Tq, int Tk, int Hq, int Hkv, int window, int causal,
                 float scale, cudaStream_t stream) {
  if (encode_tiled == nullptr) return (int)cudaErrorInitializationError;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, DH, Hq, Tq, B) ||
      !tensor_map(&mk, k, DH, Hkv, Tk, B) ||
      !tensor_map(&mv, v, DH, Hkv, Tk, B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tq + wg::BM - 1) / wg::BM, Hq, B);
  wg::flash_wgmma<DH><<<grid, wg::NTHREADS, wg::Smem<DH>::ALLOC, stream>>>(
      mq, mk, mv, static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<__nv_bfloat16*>(out), Tq,
      Tk, Hq, Hkv, window, causal, scale * wg::LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* out, void* part, int B, int Tq, int Tk,
           int Hq, int Hkv, int window, int causal, float scale,
           cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int layout = layout_of(kBf16, DH, Tq, Hq, Hkv);
  if (layout == DECODE) {
    const int ns = n_splits(Tk);
    const size_t smem = decode_smem_bytes(Hq / Hkv, DH);
    flash_decode<T, DH><<<dim3(ns, Hkv, B), NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(q_pos),
        static_cast<const int*>(k_pos), static_cast<float*>(part), Tk, Hq,
        Hkv, window, causal, scale, ns);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_decode_combine<T, DH><<<dim3(Hq, B), DH, 0, stream>>>(
        static_cast<const float*>(part), static_cast<const int*>(q_pos),
        static_cast<T*>(out), Hq, ns);
    return (int)cudaGetLastError();
  }
  if (layout == WGMMA) {
    if constexpr (kBf16 && DH >= 64)
      return launch_wgmma<DH>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, Hq, Hkv,
                              window, causal, scale, stream);
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, DH><<<grid, NT, smem_bytes(DH), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<T*>(out), Tq, Tk, Hq, Hkv,
      window, causal, scale);
  return (int)cudaGetLastError();
}

// the shared-memory limits of every instantiation, set once
template <typename T, int DH>
cudaError_t init_kernels() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(DH));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_decode<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)decode_smem_bytes(MAXG, DH));
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && DH >= 64)
    err = cudaFuncSetAttribute(wg::flash_wgmma<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wg::Smem<DH>::ALLOC);
  return err;
}

template <typename T>
cudaError_t init_dtype() {
  cudaError_t err;
  if ((err = init_kernels<T, 16>()) != cudaSuccess) return err;
  if ((err = init_kernels<T, 32>()) != cudaSuccess) return err;
  if ((err = init_kernels<T, 64>()) != cudaSuccess) return err;
  if ((err = init_kernels<T, 128>()) != cudaSuccess) return err;
  return init_kernels<T, 256>();
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

// Sets every kernel's shared-memory limit and looks up
// cuTensorMapEncodeTiled; once per process, before the first call.
int flash_attention_init() {
  cudaError_t err = init_dtype<float>();
  if (err != cudaSuccess) return (int)err;
  if ((err = init_dtype<__nv_bfloat16>()) != cudaSuccess) return (int)err;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found);
  if (err != cudaSuccess) return (int)err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return (int)cudaErrorSymbolNotFound;
  encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  return 0;
}

// The layout a call takes: 1 fma, 2 wgmma, 3 decode.
int flash_attention_layout(int bf16, int dh, int Tq, int Hq, int Hkv) {
  return layout_of(bf16 != 0, dh, Tq, Hq, Hkv);
}

// q (B, Tq, Hq, dh), k/v (B, Tk, Hkv, dh), out (B, Tq, Hq, dh): contiguous,
// 16-byte aligned, all f32 (bf16 = 0) or all bf16 (bf16 = 1); q_pos (B, Tq),
// k_pos (B, Tk) int32; part: f32 workspace of
// flash_attention_workspace_bytes (may be null when that is 0).  Returns 0
// or the CUDA error of the launch.
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

// the shared memory a call's layout asks
size_t flash_attention_smem_bytes(int bf16, int dh, int Tq, int Hq, int Hkv) {
  switch (layout_of(bf16 != 0, dh, Tq, Hq, Hkv)) {
    case DECODE: return decode_smem_bytes(Hq / Hkv, dh);
    case WGMMA:
      return dh == 64 ? wg::Smem<64>::ALLOC
             : dh == 128 ? wg::Smem<128>::ALLOC : wg::Smem<256>::ALLOC;
    default: return smem_bytes(dh);
  }
}

}  // extern "C"
