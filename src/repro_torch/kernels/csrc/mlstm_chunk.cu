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
// Which layout runs is a function of S alone (mlstm_chunk_layout):
//   * S = 1, the one-step layout (mlstm_step): one step updates the carry,
//     which is all the bytes the call moves.  A block takes one (b, h) and
//     a slab of 8 columns of C: it reads its slab once (each thread a row
//     of 32 bytes), computes q.k, q.n and m itself, writes h for its
//     columns and the same slab of C_out.  At B*H = 4, dh = 256: 128 blocks.
//   * S > 1, the chunk-parallel layout, in two launches:
//     1. states (mlstm_states): a block owns a 32 x 64 tile of C of one
//        (b, h) in registers (4 x 4 per thread) and walks the chunks in
//        order.  At each chunk's start it writes the state entering that
//        chunk (C_k, n_k, m_k; k >= 1) to a workspace, then adds the
//        chunk's decayed k^T v, the operands staged through shared memory
//        by cp.async in a ring of four slabs.  Four groups of 128 threads split
//        each chunk's steps and sum their parts at its end, so 16 warps
//        hide each other's latency on the 128 blocks of the prefill.  The
//        last state goes to the outputs.
//     2. outputs (mlstm_outputs): one block per (64 query rows, chunk,
//        b*h), 256 blocks at the prefill.  It reads its chunk's entering
//        state (the input state for chunk 0), computes q C for its rows,
//        then the causal scores of its rows against the keys up to its
//        last row, 64 x 64 at a time, and w v.  Every score is computed by
//        one block only (the rows, not the columns of h, are split), and
//        each thread owns an 8 x 8 tile of h (4 x 4 of the scores) in
//        registers; q, k, v and C are staged in shared memory by cp.async,
//        k of the next tile and v loading while this tile's products run.
//   The chunk length L is the caller's (chunk, or S when S % chunk != 0):
//   a single chunk leaves phase 1 nothing to carry but the final state.
// Head dims: any multiple of 4 up to 256 (16-byte copies of rows).
//
// Bound on the H100 (fp32 without tensor cores, 67 TFLOP/s; 3.35 TB/s):
// a prefill call at (B, H, S, dh) = (1, 4, 4096, 256), L = 256 needs
// 2*dh*L*(L+1) (the causal halves of q k^T and w v) + 4*L*dh*dh (q C and
// k^T v) flops per chunk and head, 6.45 GFLOP in all (0.096 ms), against
// 69 MB read and written once (0.021 ms): it is bound by operations.  The
// layout above does that work once (no score or state product is
// recomputed) on 128 + 256 blocks, in fp32 FMAs from registers (16 FMAs
// for every two 16-byte shared-memory reads).  A decode call (S = 1) moves
// the carry in and out (2 MB per slot) and does almost no arithmetic: it
// is bound by bytes, and the one-step layout reads and writes each byte
// of the carry once.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int DMAX = 256;      // largest head dim the layouts take
constexpr int NT = 256;        // threads per block: one-step and outputs
constexpr int NW = NT / 32;
// one-step layout
constexpr int SJ = 8;          // columns of C per block
constexpr int NRED = SJ + 2;   // q.C for each column, q.k, q.n
// states layout
constexpr int TD = 32;         // rows of C per block
constexpr int TJ = 64;         // columns of C per block
constexpr int SL = 64;         // steps per staged slab of k and v
constexpr int NG = 4;          // groups of 128 threads that split a slab
constexpr int NT1 = NG * 128;  // threads per block
constexpr int NSTG = 4;        // slabs in the cp.async ring
// outputs layout
constexpr int RT = 64;         // query rows per block
constexpr int KT = 64;         // keys per tile, and rows of C per slab
constexpr int QS = DMAX + 4;   // padded row stride of the q, k, v, C tiles
constexpr int WS = RT + 4;     // row stride of w^T

enum Layout { ONE_STEP = 1, CHUNK_PARALLEL = 2 };

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int NWARPS>
__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_max(x);
  __syncthreads();                       // earlier readers of red are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < NWARPS; ++w) x = fmaxf(x, red[w]);
  return x;
}

__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// ---------------------------------------------------------------- S = 1
__global__ void __launch_bounds__(NT) mlstm_step(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lf,
    const float* __restrict__ li, const float* __restrict__ C_in,
    const float* __restrict__ n_in, const float* __restrict__ m_in,
    float* __restrict__ h, float* __restrict__ C_out,
    float* __restrict__ n_out, float* __restrict__ m_out, int dh,
    float scale) {
  __shared__ float red[NW][NRED];
  __shared__ float tot[NRED];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * SJ, bh = blockIdx.y;
  const size_t base = (size_t)bh * dh;
  const float* Cb = C_in + base * dh;
  float* Co = C_out + base * dh;
  const float m0 = m_in[bh], f = lf[bh], ig = li[bh];
  // for L = 1: g = li, the chunk's decay is li, m_t = m_out
  const float mt = fmaxf(m0 + f, ig);
  const float carry = expf(m0 + f - mt);
  const float ek = expf(ig - mt);
  const bool lo_in = j0 < dh, hi_in = j0 + 4 < dh;
  float4 v_lo = make_float4(0.f, 0.f, 0.f, 0.f), v_hi = v_lo;
  if (lo_in) v_lo = *reinterpret_cast<const float4*>(v + base + j0);
  if (hi_in) v_hi = *reinterpret_cast<const float4*>(v + base + j0 + 4);

  float part[NRED];
#pragma unroll
  for (int i = 0; i < NRED; ++i) part[i] = 0.f;
  for (int d = tid; d < dh; d += NT) {
    const float qd = q[base + d], kd = k[base + d], nd = n_in[base + d];
    const float kv = kd * ek;
    part[SJ] += qd * kd;
    part[SJ + 1] += qd * nd;
    const size_t row = (size_t)d * dh + j0;
    if (lo_in) {
      const float4 c = *reinterpret_cast<const float4*>(Cb + row);
      part[0] += qd * c.x; part[1] += qd * c.y;
      part[2] += qd * c.z; part[3] += qd * c.w;
      *reinterpret_cast<float4*>(Co + row) = make_float4(
          c.x * carry + kv * v_lo.x, c.y * carry + kv * v_lo.y,
          c.z * carry + kv * v_lo.z, c.w * carry + kv * v_lo.w);
    }
    if (hi_in) {
      const float4 c = *reinterpret_cast<const float4*>(Cb + row + 4);
      part[4] += qd * c.x; part[5] += qd * c.y;
      part[6] += qd * c.z; part[7] += qd * c.w;
      *reinterpret_cast<float4*>(Co + row + 4) = make_float4(
          c.x * carry + kv * v_hi.x, c.y * carry + kv * v_hi.y,
          c.z * carry + kv * v_hi.z, c.w * carry + kv * v_hi.w);
    }
    if (blockIdx.x == 0) n_out[base + d] = nd * carry + kv;
  }
#pragma unroll
  for (int i = 0; i < NRED; ++i) {
    const float s = warp_sum(part[i]);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (tid < NRED) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w][tid];
    tot[tid] = s;
  }
  __syncthreads();
  if (tid < SJ && j0 + tid < dh) {
    const float inter = expf(m0 + f - mt) * scale;
    const float w = tot[SJ] * scale * ek;
    const float den = w + inter * tot[SJ + 1];
    const float vj = v[base + j0 + tid];
    h[base + j0 + tid] =
        (w * vj + inter * tot[tid]) / fmaxf(fabsf(den), expf(-mt));
  }
  if (blockIdx.x == 0 && tid == 0) m_out[bh] = mt;
}

// ------------------------------------------------------- S > 1: phase 1
// Block (x, y, bh) owns C[32x : 32x+32, 64y : 64y+64] of one (b, h), and
// for y = 0 also n[32x : 32x+32].  Its 512 threads are NG groups of 128
// that split each staged slab's steps (group g takes steps 16g .. 16g+15
// of 64); in a group, thread (ty, tx) owns rows 4ty..4ty+3 and columns
// 4tx..4tx+3 of the tile, and the threads with tx = 0 the rows' n.  Group
// 0 holds the state; the others' partial sums are added to it at each
// chunk's end.
constexpr int PART = 20;       // a thread's partial sums: 16 of C, 4 of n

size_t states_smem_bytes() {
  return (NSTG * SL * (TD + TJ + 2) + SL + (NG - 1) * 128 * PART + NT1 / 32) *
         sizeof(float);
}

__global__ void __launch_bounds__(NT1, 1) mlstm_states(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bc, const float* __restrict__ li,
    const float* __restrict__ C_in, const float* __restrict__ n_in,
    const float* __restrict__ m_in, float* __restrict__ wsC,
    float* __restrict__ wsN, float* __restrict__ wsM,
    float* __restrict__ C_out, float* __restrict__ n_out,
    float* __restrict__ m_out, int S, int L, int dh, int BH) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [NSTG][SL][TD]
  float* vs = ks + NSTG * SL * TD;           // [NSTG][SL][TJ]
  float* bs = vs + NSTG * SL * TJ;           // [NSTG][SL] b of each step
  float* ls = bs + NSTG * SL;                // [NSTG][SL] li of each step
  float* cf = ls + NSTG * SL;                // [SL] this slab's k weights
  float* part = cf + SL;                     // [NG-1][128][PART]
  float* red = part + (NG - 1) * 128 * PART; // [NT1 / 32]
  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127;
  const int ty = t >> 4, tx = t & 15;
  const int d0 = blockIdx.x * TD, j0 = blockIdx.y * TJ, bh = blockIdx.z;
  const size_t row0 = (size_t)bh * S;
  const float* kb = k + row0 * dh;
  const float* vb = v + row0 * dh;
  const float* bcb = bc + row0;
  const float* lib = li + row0;
  const size_t cbase = (size_t)bh * dh * dh;
  const int dr = d0 + ty * 4, jc = j0 + tx * 4;
  const bool jok = jc < dh;
  // whether this thread's n rows are state (group 0) or a partial sum
  const bool n_rows = blockIdx.y == 0 && tx == 0;

  float acc[4][4], nacc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool in = grp == 0 && dr + i < dh;
    if (in && jok)
      c = *reinterpret_cast<const float4*>(C_in + cbase + (size_t)(dr + i) * dh + jc);
    acc[i][0] = c.x; acc[i][1] = c.y; acc[i][2] = c.z; acc[i][3] = c.w;
    nacc[i] = in && n_rows ? n_in[(size_t)bh * dh + dr + i] : 0.f;
  }
  float m = m_in[bh];

  const int nc = S / L, nsl = (L + SL - 1) / SL, total = nc * nsl;
  auto stage_slab = [&](int idx) {
    const int c = idx / nsl, s0 = (idx - c * nsl) * SL;
    const int rows = min(SL, L - s0);
    const float* kr = kb + (size_t)(c * L + s0) * dh;
    const float* vr = vb + (size_t)(c * L + s0) * dh;
    float* kd = ks + (idx % NSTG) * SL * TD;
    float* vd = vs + (idx % NSTG) * SL * TJ;
    if (tid < SL) {
      const bool in = tid < rows;
      const size_t o = (size_t)c * L + s0 + tid;
      cp_async4(bs + (idx % NSTG) * SL + tid, in ? bcb + o : bcb, in);
      cp_async4(ls + (idx % NSTG) * SL + tid, in ? lib + o : lib, in);
    }
    for (int i = tid; i < SL * (TD / 4); i += NT1) {
      const int r = i / (TD / 4), cc = (i % (TD / 4)) * 4;
      const bool in = r < rows && d0 + cc < dh;
      cp_async16(kd + r * TD + cc, in ? kr + (size_t)r * dh + d0 + cc : kb, in);
    }
    for (int i = tid; i < SL * (TJ / 4); i += NT1) {
      const int r = i / (TJ / 4), cc = (i % (TJ / 4)) * 4;
      const bool in = r < rows && j0 + cc < dh;
      cp_async16(vd + r * TJ + cc, in ? vr + (size_t)r * dh + j0 + cc : vb, in);
    }
  };

  for (int i = 0; i < NSTG - 1; ++i) {  // slabs in flight ahead of use
    if (i < total) stage_slab(i);
    cp_commit();
  }
  float bL = 0.f;
  for (int idx = 0; idx < total; ++idx) {
    const int c = idx / nsl, sl = idx - c * nsl, s0 = sl * SL, c0 = c * L;
    if (idx + NSTG - 1 < total) stage_slab(idx + NSTG - 1);
    cp_commit();
    if (s0 == 0) {                      // the chunk starts: advance m
      bL = bcb[c0 + L - 1];
      float mx = -INFINITY;
      for (int s = tid; s < L; s += NT1)
        mx = fmaxf(mx, bL - bcb[c0 + s] + lib[c0 + s]);
      mx = block_max<NT1 / 32>(mx, red);
      const float m_new = fmaxf(m + bL, mx);
      const float carry = expf(m + bL - m_new);
      if (c > 0 && grp == 0) {          // the state entering chunk c
        const size_t slot = (size_t)(c - 1) * BH + bh;
        float* wc = wsC + slot * dh * dh;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (dr + i < dh) {
            if (jok)
              *reinterpret_cast<float4*>(wc + (size_t)(dr + i) * dh + jc) =
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            if (n_rows) wsN[slot * dh + dr + i] = nacc[i];
          }
        if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) wsM[slot] = m;
      }
      const float f = grp == 0 ? carry : 0.f;   // partial sums restart at 0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= f;
        nacc[i] *= f;
      }
      m = m_new;
    }
    cp_wait<NSTG - 1>();
    __syncthreads();
    const int b = idx % NSTG, ns = min(SL, L - s0);
    if (tid < SL)                       // the slab's decay of each k
      cf[tid] = tid < ns ? expf(bL - bs[b * SL + tid] + ls[b * SL + tid] - m)
                         : 0.f;
    __syncthreads();
    const float* kq_b = ks + b * SL * TD;
    const float* vq_b = vs + b * SL * TJ;
    const int s_lo = grp * (SL / NG), s_hi = min(s_lo + SL / NG, ns);
#pragma unroll 4
    for (int s = s_lo; s < s_hi; ++s) {
      const float f = cf[s];
      const float4 kq = *reinterpret_cast<const float4*>(kq_b + s * TD + ty * 4);
      const float4 vq = *reinterpret_cast<const float4*>(vq_b + s * TJ + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = comp(kq, i) * f;
        acc[i][0] = fmaf(a, vq.x, acc[i][0]);
        acc[i][1] = fmaf(a, vq.y, acc[i][1]);
        acc[i][2] = fmaf(a, vq.z, acc[i][2]);
        acc[i][3] = fmaf(a, vq.w, acc[i][3]);
        nacc[i] += a;
      }
    }
    if (sl == nsl - 1) {                // the chunk ends: gather the groups
      if (grp > 0) {
        float* pp = part + ((grp - 1) * 128 + t) * PART;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) pp[i * 4 + j] = acc[i][j];
          pp[16 + i] = nacc[i];
        }
      }
      __syncthreads();
      if (grp == 0)
        for (int g = 0; g < NG - 1; ++g) {
          const float* pp = part + (g * 128 + t) * PART;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += pp[i * 4 + j];
            nacc[i] += pp[16 + i];
          }
        }
    }
    __syncthreads();                    // this buffer is refilled next
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (dr + i < dh) {
        if (jok)
          *reinterpret_cast<float4*>(C_out + cbase + (size_t)(dr + i) * dh + jc) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (n_rows) n_out[(size_t)bh * dh + dr + i] = nacc[i];
      }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) m_out[bh] = m;
}

// ------------------------------------------------------- S > 1: phase 2
size_t outputs_smem_bytes() {
  return (3 * (size_t)KT * QS + (size_t)KT * WS + 6 * RT) * sizeof(float);
}

// rows [0, rows) of a (., dh) row-major matrix at src into a KT x QS tile;
// rows past `rows` are zero-filled (columns past dh are left alone)
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows, int dh) {
  const int cpr = dh >> 2;
  for (int i = threadIdx.x; i < KT * cpr; i += NT) {
    const int r = i / cpr, c = (i - r * cpr) << 2;
    const bool in = r < rows;
    cp_async16(dst + r * QS + c, in ? src + (size_t)r * dh + c : src, in);
  }
}

// Block (x, c, bh): rows t0 = 64x .. t0+63 of chunk c of one (b, h).
// Products: thread (tr = warp, lane) owns h rows 8tr..8tr+7 and columns
// 4lane..4lane+3, 128+4lane..128+4lane+3; for the scores, thread (ty, tx)
// rows ty + 16i and keys tx + 16j, i, j < 4.
__global__ void __launch_bounds__(NT, 1) mlstm_outputs(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bc,
    const float* __restrict__ li, const float* __restrict__ C_in,
    const float* __restrict__ n_in, const float* __restrict__ m_in,
    const float* __restrict__ wsC, const float* __restrict__ wsN,
    const float* __restrict__ wsM, float* __restrict__ h, int S, int L,
    int dh, int BH, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // RT x QS
  float* buf0 = qs + KT * QS;          // k tiles and even C slabs
  float* buf1 = buf0 + KT * QS;        // v tiles and odd C slabs
  float* wT = buf1 + KT * QS;          // KT x WS: w[t][s] at wT[s * WS + t]
  float* bt_s = wT + KT * WS;          // per row: b_t, m_t, inter * scale,
  float* mt_s = bt_s + RT;             //   denominator
  float* in_s = mt_s + RT;
  float* den_s = in_s + RT;
  float* bs_s = den_s + RT;            // per key of the tile: b_s, li_s
  float* ls_s = bs_s + KT;

  const int tid = threadIdx.x, lane = tid & 31, tr = tid >> 5;
  const int t0 = blockIdx.x * RT, c = blockIdx.y, bh = blockIdx.z;
  const int c0 = c * L;
  const size_t row0 = (size_t)bh * S + c0;     // first row of the chunk
  const float* qb = q + row0 * dh;
  const float* kb = k + row0 * dh;
  const float* vb = v + row0 * dh;
  const float* bcb = bc + row0;
  const float* lib = li + row0;
  const float *Cc, *nc_;
  float mc;
  if (c == 0) {
    Cc = C_in + (size_t)bh * dh * dh;
    nc_ = n_in + (size_t)bh * dh;
    mc = m_in[bh];
  } else {
    const size_t slot = (size_t)(c - 1) * BH + bh;
    Cc = wsC + slot * dh * dh;
    nc_ = wsN + slot * dh;
    mc = wsM[slot];
  }
  const int nslab = (dh + KT - 1) / KT;
  const int ntile = min(t0 + RT, L);          // keys the rows can see
  const int nkt = (ntile + KT - 1) / KT;

  // groups: q, C slab 0, C slab 1
  load_tile(qs, qb + (size_t)t0 * dh, min(RT, L - t0), dh);
  cp_commit();
  load_tile(buf0, Cc, min(KT, dh), dh);
  cp_commit();
  if (nslab > 1) load_tile(buf1, Cc + (size_t)KT * dh, min(KT, dh - KT), dh);
  cp_commit();
  cp_wait<2>();
  __syncthreads();

  {  // per row: m_t, the inter-chunk factor, q.n; four threads a row
    const int r = tid >> 2, part = tid & 3, t = t0 + r;
    const bool ok = t < L;
    float bt = 0.f, mx = -INFINITY, qn = 0.f;
    if (ok) {
      bt = bcb[t];
      for (int s = part; s <= t; s += 4) mx = fmaxf(mx, bt - bcb[s] + lib[s]);
      for (int d = part * 4; d < dh; d += 16) {
        const float4 a = *reinterpret_cast<const float4*>(qs + r * QS + d);
        const float4 n4 = *reinterpret_cast<const float4*>(nc_ + d);
        qn += a.x * n4.x + a.y * n4.y + a.z * n4.z + a.w * n4.w;
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
    if (part == 0) {
      const float mt = ok ? fmaxf(mc + bt, mx) : 0.f;
      const float inter = ok ? expf(mc + bt - mt) * scale : 0.f;
      bt_s[r] = bt;
      mt_s[r] = mt;
      in_s[r] = inter;
      den_s[r] = inter * qn;
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // q C over slabs of 64 rows of C, double-buffered
  for (int sl = 0; sl < nslab; ++sl) {
    cp_wait<1>();
    __syncthreads();
    const float* Cb = (sl & 1) ? buf1 : buf0;
    const int dd0 = sl * KT, nd = min(KT, dh - dd0);
    for (int d = 0; d < nd; d += 4) {
      float4 qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (tr * 8 + i) * QS + dd0 + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 x0 = *reinterpret_cast<const float4*>(Cb + (d + e) * QS + lane * 4);
        const float4 x1 = *reinterpret_cast<const float4*>(Cb + (d + e) * QS + 128 + lane * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = comp(qv[i], e);
          acc[i][0] = fmaf(a, x0.x, acc[i][0]);
          acc[i][1] = fmaf(a, x0.y, acc[i][1]);
          acc[i][2] = fmaf(a, x0.z, acc[i][2]);
          acc[i][3] = fmaf(a, x0.w, acc[i][3]);
          acc[i][4] = fmaf(a, x1.x, acc[i][4]);
          acc[i][5] = fmaf(a, x1.y, acc[i][5]);
          acc[i][6] = fmaf(a, x1.z, acc[i][6]);
          acc[i][7] = fmaf(a, x1.w, acc[i][7]);
        }
      }
    }
    __syncthreads();
    if (sl + 2 < nslab)
      load_tile((sl & 1) ? buf1 : buf0, Cc + (size_t)(sl + 2) * KT * dh,
                min(KT, dh - (sl + 2) * KT), dh);
    cp_commit();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float f = in_s[tr * 8 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= f;
  }

  // intra-chunk: key tiles 0 .. nkt-1; k of tile j into buf0, v into buf1
  load_tile(buf0, kb, min(KT, L), dh);
  cp_commit();
  load_tile(buf1, vb, min(KT, L), dh);
  cp_commit();
  const int ty = tid >> 4, tx = tid & 15;
  for (int kt = 0; kt < nkt; ++kt) {
    const int s0 = kt * KT;
    if (tid < KT) {
      const int s = s0 + tid;
      bs_s[tid] = s < L ? bcb[s] : 0.f;
      ls_s[tid] = s < L ? lib[s] : 0.f;
    }
    cp_wait<1>();                      // k of this tile
    __syncthreads();
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int d = 0; d < dh; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + d);
          b[i] = *reinterpret_cast<const float4*>(buf0 + (tx + 16 * i) * QS + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(a[i].x, b[j].x, sc[i][j]);
            sc[i][j] = fmaf(a[i].y, b[j].y, sc[i][j]);
            sc[i][j] = fmaf(a[i].z, b[j].z, sc[i][j]);
            sc[i][j] = fmaf(a[i].w, b[j].w, sc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, t = t0 + r;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sl = tx + 16 * j, s = s0 + sl;
          float w = 0.f;
          if (t < L && s <= t) {
            const float g = bt_s[r] - bs_s[sl] + ls_s[sl];
            w = sc[i][j] * scale * expf(g - mt_s[r]);
          }
          wT[sl * WS + r] = w;
          rs += w;
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        rs += __shfl_xor_sync(0xffffffffu, rs, 4);
        rs += __shfl_xor_sync(0xffffffffu, rs, 8);
        if (tx == 0) den_s[r] += rs;
      }
    }
    __syncthreads();                   // w ready, buf0 free
    if (kt + 1 < nkt)
      load_tile(buf0, kb + (size_t)(s0 + KT) * dh, min(KT, L - s0 - KT), dh);
    cp_commit();
    cp_wait<1>();                      // v of this tile
    __syncthreads();
    const int ns = min(KT, L - s0);
    for (int s = 0; s < ns; ++s) {
      const float4 w0 = *reinterpret_cast<const float4*>(wT + s * WS + tr * 8);
      const float4 w1 = *reinterpret_cast<const float4*>(wT + s * WS + tr * 8 + 4);
      const float4 x0 = *reinterpret_cast<const float4*>(buf1 + s * QS + lane * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(buf1 + s * QS + 128 + lane * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = i < 4 ? comp(w0, i) : comp(w1, i - 4);
        acc[i][0] = fmaf(a, x0.x, acc[i][0]);
        acc[i][1] = fmaf(a, x0.y, acc[i][1]);
        acc[i][2] = fmaf(a, x0.z, acc[i][2]);
        acc[i][3] = fmaf(a, x0.w, acc[i][3]);
        acc[i][4] = fmaf(a, x1.x, acc[i][4]);
        acc[i][5] = fmaf(a, x1.y, acc[i][5]);
        acc[i][6] = fmaf(a, x1.z, acc[i][6]);
        acc[i][7] = fmaf(a, x1.w, acc[i][7]);
      }
    }
    __syncthreads();                   // buf1 and wT free
    if (kt + 1 < nkt)
      load_tile(buf1, vb + (size_t)(s0 + KT) * dh, min(KT, L - s0 - KT), dh);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tr * 8 + i, t = t0 + r;
    if (t >= L) continue;
    const float dn = fmaxf(fabsf(den_s[r]), expf(-mt_s[r]));
    float* o = h + (row0 + t) * dh;
    if (lane * 4 < dh)
      *reinterpret_cast<float4*>(o + lane * 4) = make_float4(
          acc[i][0] / dn, acc[i][1] / dn, acc[i][2] / dn, acc[i][3] / dn);
    if (128 + lane * 4 < dh)
      *reinterpret_cast<float4*>(o + 128 + lane * 4) = make_float4(
          acc[i][4] / dn, acc[i][5] / dn, acc[i][6] / dn, acc[i][7] / dn);
  }
}

int layout_of(int S) { return S == 1 ? ONE_STEP : CHUNK_PARALLEL; }

}  // namespace

extern "C" {

// Sets the two-phase kernels' shared-memory limits once per process.
int mlstm_chunk_init() {
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)states_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(mlstm_outputs,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)outputs_smem_bytes());
}

// The layout a call of S steps takes: 1 one-step, 2 chunk-parallel.
int mlstm_chunk_layout(int S) { return layout_of(S); }

// The shared memory the outputs kernel asks, the most of any layout.
size_t mlstm_chunk_smem_bytes() { return outputs_smem_bytes(); }

// The states entering chunks 1 .. S/L - 1 (chunk-parallel layout).
size_t mlstm_chunk_workspace_bytes(int BH, int S, int L, int dh) {
  if (layout_of(S) != CHUNK_PARALLEL) return 0;
  return (size_t)(S / L - 1) * BH * ((size_t)dh * dh + dh + 1) * sizeof(float);
}

// q/k/v/h: (BH, S, dh); bc/li: (BH, S) (bc: the chunk-local cumsum of the
// log forget gate, which is lf itself when L = 1); C: (BH, dh, dh); n: (BH,
// dh); m: (BH,); all fp32, contiguous, 16-byte aligned; dh % 4 == 0, dh <=
// 256, S % L == 0; ws: mlstm_chunk_workspace_bytes of scratch.  Launches
// on `stream` and returns the CUDA error of the launch (0 when accepted).
int mlstm_chunk_fwd(const float* q, const float* k, const float* v,
                    const float* bc, const float* li, const float* C_in,
                    const float* n_in, const float* m_in, float* h,
                    float* C_out, float* n_out, float* m_out, float* ws,
                    int BH, int S, int L, int dh, float scale, void* stream) {
  if (dh % 4 || dh > DMAX || dh < 4 || S % L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout_of(S) == ONE_STEP) {
    mlstm_step<<<dim3((dh + SJ - 1) / SJ, BH), NT, 0, st>>>(
        q, k, v, bc, li, C_in, n_in, m_in, h, C_out, n_out, m_out, dh, scale);
    return (int)cudaGetLastError();
  }
  const int nc = S / L;
  const size_t slots = (size_t)(nc - 1) * BH;
  float* wsC = ws;
  float* wsN = wsC + slots * dh * dh;
  float* wsM = wsN + slots * dh;
  mlstm_states<<<dim3((dh + TD - 1) / TD, (dh + TJ - 1) / TJ, BH), NT1,
                 states_smem_bytes(), st>>>(k, v, bc, li, C_in, n_in, m_in, wsC, wsN, wsM, C_out,
                       n_out, m_out, S, L, dh, BH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_outputs<<<dim3((L + RT - 1) / RT, nc, BH), NT, outputs_smem_bytes(),
                  st>>>(q, k, v, bc, li, C_in, n_in, m_in, wsC, wsN, wsM, h,
                        S, L, dh, BH, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
