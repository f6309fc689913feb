// Chunkwise-parallel mLSTM forward for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk.py::mlstm_chunk
// (body `_kernel`) and, like the reference model's chunk loop
// (models/ssm.py::mlstm_forward over `_mlstm_chunk`), takes the carried
// state (C, n, m) as input; m may be -inf.  With a zero state it computes
// what the Pallas kernel computes.
//
// Per (b, h) and chunk of L steps, with b = chunk-local cumsum of the log
// forget gate (computed by the caller) and li the log input gate:
//   g[t,s] = b_t - b_s + li_s (s <= t),  m_t = max(m_in + b_t, max_s g[t,s])
//   w[t,s] = (q_t.k_s * scale) * exp(g[t,s] - m_t)
//   h_t    = (sum_s w[t,s] v_s + e^{m_in+b_t-m_t} scale q_t C_in)
//            / max(|sum_s w[t,s] + e^{m_in+b_t-m_t} scale q_t.n_in|, e^{-m_t})
//   then C, n, m advance by the chunk's decayed k v^T, k and max.
//
// Layout for this card.  The TPU kernel holds the dh x dh carry and the
// L x L score matrix whole in VMEM and walks chunks on a sequential grid
// axis.  At dh = L = 256 each is 256 KB, more than a block's 227 KB of
// shared memory, and a sequential grid axis does not exist here.  So:
//   * the value dimension is split across blocks: block (x, bh) owns the
//     32 columns C[:, 32x : 32x+32] of one (b, h) and the same columns of h.
//     A batch-1 prefill at 4 heads x dh 256 thus runs 32 blocks, not 4.
//   * each block walks the chunks itself, the carry staying in shared memory.
//   * scores are built 32 query rows x 32 key rows at a time, with k and v
//     streamed through shared memory, so any L (1 for decode, S when
//     S % chunk != 0) fits.  Every block recomputes the scores, the row
//     stabilisers and n: cheap against the products, and it keeps the
//     blocks independent.
// Shared memory at dh = 256: about 108 KB (carry tile 32 KB, q tile 32 KB,
// padded k tile 33 KB, the rest small).
//
// Bound on the H100 (fp32 without tensor cores, 67 TFLOP/s; 3.35 TB/s):
// a prefill call at (B, H, S, dh) = (1, 4, 4096, 256), L = 256 needs
// 2*dh*L*(L+1) (the causal halves of q k^T and w v) + 4*L*dh*dh (q C and
// k^T v) flops per chunk and head, 6.45 GFLOP in all (0.096 ms), against
// 69 MB read and written once (0.021 ms): it is bound by operations.  A decode call (S = L = 1) moves the carry in and
// out (2 MB per slot) and does almost no arithmetic: bound by bytes, and in
// practice by launch overhead.  This first version uses plain FMAs from
// shared memory (no TF32, no wgmma); making it fast is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TT = 32;        // query rows per tile
constexpr int TS = 32;        // key rows per tile
constexpr int TJ = 32;        // value columns a block owns
constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int RPT = TT / NW;  // query rows per thread

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_max(x);
  __syncthreads();                       // earlier readers of red are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < NW; ++w) x = fmaxf(x, red[w]);
  return x;
}

size_t smem_floats(int dh) {
  return (size_t)dh * TJ          // carry tile C[:, j0:j0+TJ]
       + dh                       // n
       + (size_t)TT * dh          // q tile
       + (size_t)TS * (dh + 1)    // k tile, rows padded against bank conflicts
       + TS * TJ                  // v tile
       + TT * TS                  // weights w of the current tile
       + TS                       // state-update coefficients
       + NW;                      // block reduction scratch
}

__global__ void __launch_bounds__(NT) mlstm_chunk_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bc,
    const float* __restrict__ li, const float* __restrict__ C_in,
    const float* __restrict__ n_in, const float* __restrict__ m_in,
    float* __restrict__ h, float* __restrict__ C_out,
    float* __restrict__ n_out, float* __restrict__ m_out,
    int S, int L, int dh, float scale) {
  extern __shared__ float smem[];
  float* Cs = smem;
  float* ns = Cs + (size_t)dh * TJ;
  float* qs = ns + dh;
  float* ks = qs + (size_t)TT * dh;
  float* vs = ks + (size_t)TS * (dh + 1);
  float* ws = vs + TS * TJ;
  float* kvc = ws + TT * TS;
  float* red = kvc + TS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * TJ;
  const int j = j0 + lane;               // the value column of this thread
  const bool jok = j < dh;
  const int kp = dh + 1;                 // padded k row stride

  const size_t row0 = (size_t)bh * S;    // first (b, h, s) row
  const float* qb = q + row0 * dh;
  const float* kb = k + row0 * dh;
  const float* vb = v + row0 * dh;
  float* hb = h + row0 * dh;
  const size_t cbase = (size_t)bh * dh * dh;

  for (int i = tid; i < dh * TJ; i += NT) {
    const int d = i / TJ, jj = j0 + i % TJ;
    Cs[i] = jj < dh ? C_in[cbase + (size_t)d * dh + jj] : 0.f;
  }
  for (int d = tid; d < dh; d += NT) ns[d] = n_in[(size_t)bh * dh + d];
  float m = m_in[bh];
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += L) {
    const float* bcc = bc + row0 + c0;
    const float* lic = li + row0 + c0;

    // ---- outputs: TT query rows at a time; warp w owns rows w + NW*i
    for (int t0 = 0; t0 < L; t0 += TT) {
      for (int i = tid; i < TT * dh; i += NT) {
        const int r = i / dh, d = i % dh;
        qs[i] = t0 + r < L ? qb[(size_t)(c0 + t0 + r) * dh + d] : 0.f;
      }
      __syncthreads();

      float mt[RPT], den[RPT], acc[RPT];
      for (int i = 0; i < RPT; ++i) {
        const int r = warp + NW * i, t = t0 + r;
        mt[i] = 0.f; den[i] = 0.f; acc[i] = 0.f;
        if (t < L) {                      // uniform across the warp
          const float bt = bcc[t];
          float mx = -INFINITY;
          for (int s = lane; s <= t; s += 32) mx = fmaxf(mx, bt - bcc[s] + lic[s]);
          mx = warp_max(mx);
          mt[i] = fmaxf(m + bt, mx);
          float qn = 0.f;
          for (int d = lane; d < dh; d += 32) qn += qs[r * dh + d] * ns[d];
          qn = warp_sum(qn);
          const float inter = expf(m + bt - mt[i]) * scale;
          den[i] = inter * qn;
          acc[i] = inter;                 // scales q.C below
        }
      }
      // inter-chunk term: acc = inter * (q_t . C[:, j])
      {
        float qc[RPT] = {};
        for (int d = 0; d < dh; ++d) {
          const float c = Cs[d * TJ + lane];
          for (int i = 0; i < RPT; ++i) qc[i] += qs[(warp + NW * i) * dh + d] * c;
        }
        for (int i = 0; i < RPT; ++i) acc[i] *= qc[i];
      }

      const int s_end = min(t0 + TT, L);  // causal: later keys never count
      for (int s0 = 0; s0 < s_end; s0 += TS) {
        __syncthreads();                  // ks/vs/ws free again
        for (int i = tid; i < TS * dh; i += NT) {
          const int r = i / dh, d = i % dh;
          ks[r * kp + d] = s0 + r < L ? kb[(size_t)(c0 + s0 + r) * dh + d] : 0.f;
        }
        for (int i = tid; i < TS * TJ; i += NT) {
          const int r = i / TJ, jj = j0 + i % TJ;
          vs[i] = (s0 + r < L && jj < dh) ? vb[(size_t)(c0 + s0 + r) * dh + jj] : 0.f;
        }
        __syncthreads();

        // scores for (row warp + NW*i, key s0 + lane)
        float sc[RPT] = {};
        for (int d = 0; d < dh; ++d) {
          const float kd = ks[lane * kp + d];
          for (int i = 0; i < RPT; ++i) sc[i] += qs[(warp + NW * i) * dh + d] * kd;
        }
        const int s = s0 + lane;
        for (int i = 0; i < RPT; ++i) {
          const int r = warp + NW * i, t = t0 + r;
          float w = 0.f;
          if (t < L && s <= t) {
            const float g = bcc[t] - bcc[s] + lic[s];
            w = sc[i] * scale * expf(g - mt[i]);
          }
          ws[r * TS + lane] = w;
          den[i] += warp_sum(w);
        }
        __syncthreads();

        for (int s2 = 0; s2 < TS; ++s2) {
          const float vv = vs[s2 * TJ + lane];
          for (int i = 0; i < RPT; ++i) acc[i] += ws[(warp + NW * i) * TS + s2] * vv;
        }
      }

      for (int i = 0; i < RPT; ++i) {
        const int t = t0 + warp + NW * i;
        if (t < L && jok)
          hb[(size_t)(c0 + t) * dh + j] = acc[i] / fmaxf(fabsf(den[i]), expf(-mt[i]));
      }
      __syncthreads();                    // qs is reloaded by the next tile
    }

    // ---- state update: C, n, m advance past the chunk
    const float bL = bcc[L - 1];
    float mx = -INFINITY;
    for (int s = tid; s < L; s += NT) mx = fmaxf(mx, bL - bcc[s] + lic[s]);
    mx = block_max(mx, red);
    const float m_new = fmaxf(m + bL, mx);
    const float carry = expf(m + bL - m_new);
    for (int i = tid; i < dh * TJ; i += NT) Cs[i] *= carry;
    for (int d = tid; d < dh; d += NT) ns[d] *= carry;

    for (int s0 = 0; s0 < L; s0 += TS) {
      __syncthreads();
      for (int i = tid; i < TS * dh; i += NT) {
        const int r = i / dh, d = i % dh;
        ks[r * kp + d] = s0 + r < L ? kb[(size_t)(c0 + s0 + r) * dh + d] : 0.f;
      }
      for (int i = tid; i < TS * TJ; i += NT) {
        const int r = i / TJ, jj = j0 + i % TJ;
        vs[i] = (s0 + r < L && jj < dh) ? vb[(size_t)(c0 + s0 + r) * dh + jj] : 0.f;
      }
      if (tid < TS) {
        const int s = s0 + tid;
        kvc[tid] = s < L ? expf(bL - bcc[s] + lic[s] - m_new) : 0.f;
      }
      __syncthreads();
      for (int d = warp; d < dh; d += NW) {
        float a = 0.f;
        for (int s2 = 0; s2 < TS; ++s2) a += ks[s2 * kp + d] * kvc[s2] * vs[s2 * TJ + lane];
        Cs[d * TJ + lane] += a;
      }
      for (int d = tid; d < dh; d += NT) {
        float a = 0.f;
        for (int s2 = 0; s2 < TS; ++s2) a += kvc[s2] * ks[s2 * kp + d];
        ns[d] += a;
      }
    }
    m = m_new;
    __syncthreads();
  }

  for (int i = tid; i < dh * TJ; i += NT) {
    const int d = i / TJ, jj = j0 + i % TJ;
    if (jj < dh) C_out[cbase + (size_t)d * dh + jj] = Cs[i];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < dh; d += NT) n_out[(size_t)bh * dh + d] = ns[d];
    if (tid == 0) m_out[bh] = m;
  }
}

}  // namespace

extern "C" size_t mlstm_chunk_smem_bytes(int dh) {
  return smem_floats(dh) * sizeof(float);
}

// q/k/v/h: (BH, S, dh); bc/li: (BH, S); C: (BH, dh, dh); n: (BH, dh);
// m: (BH,); all fp32, contiguous.  S % L == 0.  Launches on `stream` and
// returns the CUDA error of the launch (0 when it was accepted).
extern "C" int mlstm_chunk_fwd(
    const float* q, const float* k, const float* v, const float* bc,
    const float* li, const float* C_in, const float* n_in, const float* m_in,
    float* h, float* C_out, float* n_out, float* m_out,
    int BH, int S, int L, int dh, float scale, void* stream) {
  const size_t smem = mlstm_chunk_smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((dh + TJ - 1) / TJ, BH);
  mlstm_chunk_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, k, v, bc, li, C_in, n_in, m_in, h, C_out, n_out, m_out, S, L, dh, scale);
  return (int)cudaGetLastError();
}
