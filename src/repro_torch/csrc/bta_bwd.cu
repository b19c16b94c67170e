// Ball-Tree Attention backward: dQ, dK, dV of full softmax attention inside
// each contiguous ball of m keys, recomputed from the forward's lse.
//
// Replaces repro/kernels/bta.py::_bwd_kernel (Pallas, TPU).
//
// Layout (GQA-native): q, dO (B*Hkv, rep, N, D), k/v (B*Hkv, N, D), key_bias
// (B, N) fp32, live (B, N/m) int32, lse and delta = rowsum(dO*O) (B*Hkv, rep,
// N) fp32 -> dq like q, dk/dv like k.
//
// Bound on the H100: at the paper's shapes (m = 256, D = 32, fp32) the five
// products (S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ = dS K) are
// 10*m*D FLOP per query row against a few D-wide rows of bytes, so the fp32
// FMA rate bounds it.
//
// Design.  The ball is the tile, so a ball's gradients depend on that ball
// alone and one thread block per (batch*KV-head, ball) produces all three in
// a single pass, as the TPU kernel does: no other block touches the ball's
// dK, dV (no atomics, no staging buffer, a fixed order of sums).  Two paths,
// one rule (kernels/bta.py::bta_plan):
//   fma   fp32, m a multiple of 64 up to 256, D 16 or 32 (shapenet): the
//         ball's K, V and bias are staged once (cp.async; 72 KB at m 256, D
//         32), the ball's dK and dV stay in registers for the whole block (256
//         threads, a thread holding 8 keys x D/8 dims of each: 64 floats at
//         D 32), and the block walks the ball's rep*m query rows in tiles of
//         32, Q, dO, lse and delta double-buffered by cp.async.  Per tile,
//         register micro-tiles on the FMA pipes:
//           A  S^T and dP^T (a thread: 4 keys x 8 rows, 24 float4 loads a
//              step of four dims feed 256 FMAs), P = exp(s - lse) and
//              dS = P (dP - delta) scale, both to shared memory (keys x rows);
//           B  dV += P^T dO and dK += dS^T Q into the registers;
//           C  dQ = dS K of the tile's rows: each 64-key chunk's part in
//              registers (4 rows x D/8 dims a thread), the chunks summed in a
//              fixed order through shared memory and stored.
//         Five products per (row, key), none recomputed.  The shared memory
//         (184 KB at D 32) holds one block an SM.  (512 threads, 128
//         registers each, spilled at D 32 and were no faster.)
//   rows  bf16 and the other shapes: one thread per query row runs the
//         ball's keys for dQ (K, V staged as fp32), then one thread per key
//         runs the query rows, staged one rep head at a time, for dK and dV
//         (s and dO.v computed in both passes).  p and dS are rounded to the
//         operand dtype before their products (bf16 in, bf16 operands, fp32
//         sums).
// Masked keys and rows with lse = LSE_EMPTY give p = 0; a dead ball (live =
// 0) writes exact zeros without reading K or V.
#include "tiles.cuh"

namespace {

using rt::dot4;
using rt::lane_of;
using rt::load_vec;
using rt::set_smem;
using rt::stage_rows;
using rt::stage_vals;

template <typename T>
__device__ __forceinline__ void zero_ball(T* dq, T* dk, T* dv, int bh, int ball, int rep,
                                          int N, int m, int D) {
  for (int r = 0; r < rep; ++r)
    rt::store_zeros(dq + (((size_t)bh * rep + r) * N + (size_t)ball * m) * D, m * D);
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;
  rt::store_zeros(dk + kv0, m * D);
  rt::store_zeros(dv + kv0, m * D);
}

// ---------------------------------------------------------------------------
// rows: two passes, one query row then one key per thread.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256)
bta_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ key_bias,
             const int* __restrict__ live, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int rep,
             int N, int m, int n_heads, float scale) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // pass 1: K      pass 2: Q
  float* Bm = A + m * D;                        // pass 1: V      pass 2: dO
  float* c1 = Bm + m * D;                       // pass 1: bias   pass 2: lse
  float* c2 = c1 + m;                           //                pass 2: delta

  const int bh = blockIdx.y;
  const int ball = blockIdx.x;
  const int b = bh / n_heads;
  const int rows = rep * m;
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;

  if (live[b * (N / m) + ball] == 0) {          // all keys masked: p == 0
    zero_ball(dq, dk, dv, bh, ball, rep, N, m, D);
    return;
  }

  // ---- pass 1: dQ, one query row per thread
  rt::stage(k + kv0, A, m * D);
  rt::stage(v + kv0, Bm, m * D);
  rt::stage(key_bias + (size_t)b * N + (size_t)ball * m, c1, m);
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const size_t qrow = ((size_t)bh * rep + r / m) * N + (size_t)ball * m + r % m;
    float qr[D], dor[D], acc[D];
    rt::load_row<T, D>(q + qrow * D, qr);
    rt::load_row<T, D>(dout + qrow * D, dor);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    const float l = lse[qrow], dl = delta[qrow];
    if (l < rt::LSE_HALF) {
      for (int j = 0; j < m; ++j) {
        const float p = rt::p_from_lse(rt::dot_row<D>(qr, A + j * D) * scale + c1[j], l);
        if (p == 0.f) continue;
        const float ds = p * (rt::dot_row<D>(dor, Bm + j * D) - dl) * scale;
        rt::axpy_row<D>(acc, rt::pv_operand<T>(ds), A + j * D);
      }
    }
    rt::store_row<T, D>(acc, dq + qrow * D);
  }

  // ---- pass 2: dK, dV, one key per thread, query rows staged per rep head
  for (int j0 = 0; j0 < m; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool has_key = j < m;
    float kr[D], vr[D], dka[D], dva[D];
    float bj = 0.f;
    if (has_key) {
      rt::load_row<T, D>(k + kv0 + (size_t)j * D, kr);
      rt::load_row<T, D>(v + kv0 + (size_t)j * D, vr);
      bj = key_bias[(size_t)b * N + (size_t)ball * m + j];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
    for (int r = 0; r < rep; ++r) {
      const size_t row0 = ((size_t)bh * rep + r) * N + (size_t)ball * m;
      __syncthreads();                        // previous contents consumed
      rt::stage(q + row0 * D, A, m * D);
      rt::stage(dout + row0 * D, Bm, m * D);
      rt::stage(lse + row0, c1, m);
      rt::stage(delta + row0, c2, m);
      __syncthreads();
      if (!has_key || bj <= rt::NEG_HALF) continue;
      for (int i = 0; i < m; ++i) {
        const float l = c1[i];
        if (l >= rt::LSE_HALF) continue;      // empty row: p == 0
        const float p = rt::p_from_lse(rt::dot_row<D>(kr, A + i * D) * scale + bj, l);
        if (p == 0.f) continue;
        rt::axpy_row<D>(dva, rt::pv_operand<T>(p), Bm + i * D);
        const float ds = p * (rt::dot_row<D>(vr, Bm + i * D) - c2[i]) * scale;
        rt::axpy_row<D>(dka, rt::pv_operand<T>(ds), A + i * D);
      }
    }
    if (has_key) {
      rt::store_row<T, D>(dka, dk + kv0 + (size_t)j * D);
      rt::store_row<T, D>(dva, dv + kv0 + (size_t)j * D);
    }
  }
}

// ---------------------------------------------------------------------------
// fma, fp32: one block a ball, register tiles on the FMA pipes.  NT threads,
// W = NT/32 warps; MMAX keys at most (the registers hold MMAX*D*2/NT floats
// of dK, dV a thread).  Shared memory (floats): K, V (MMAX rows of stride
// LD), bias, Q and dO [2][BM rows], lse and delta [2][BM], P^T and dS^T
// (MMAX keys x BM rows, stride LP), the dQ parts [NC chunks][BM][D].
//   A  warp (wk, wr) = (w % 8, w / 8): keys 32wk + kx + 8i (i < 4), rows
//      16... : lane (kx, ry) = (lane % 8, lane / 8), rows BM/WR*wr + ry + 4j
//      (j < RJ); a warp reads 8 keys and 4 rows a load (no bank conflicts).
//   B  warp w: keys KB*w + kq + 4i (i < KI), lane (kq, dy) = (lane % 4,
//      lane / 4), dims dy*DPT..
//   C  warp w: key chunk w / (BM/16) of CK keys, lane (dg, rg): dims dg*DPT,
//      rows 4rg..4rg+3 of the tile.
// ---------------------------------------------------------------------------
template <int D>
struct BwdFma {
  static constexpr int MMAX = 256, BM = 32, NT = 256;
  static constexpr int W = NT / 32, WR = W / 8, RJ = BM / (4 * WR), KB = MMAX / W;
  static constexpr int KI = KB / 4, DPT = D / 8, NC = W / (BM / 16), CK = MMAX / NC;
  static constexpr int LD = D + 4, LP = BM + 4;
  static constexpr int K_OFF = 0, V_OFF = MMAX * LD, B_OFF = 2 * MMAX * LD;
  static constexpr int Q_OFF = B_OFF + MMAX, DO_OFF = Q_OFF + 2 * BM * LD;
  static constexpr int L_OFF = DO_OFF + 2 * BM * LD, DL_OFF = L_OFF + 2 * BM;
  static constexpr int P_OFF = DL_OFF + 2 * BM, S_OFF = P_OFF + MMAX * LP;
  static constexpr int DQ_OFF = S_OFF + MMAX * LP;
  static constexpr size_t SMEM = (size_t)(DQ_OFF + NC * BM * D) * 4;
};

template <int D>
__global__ void __launch_bounds__(BwdFma<D>::NT, 1)
bta_bwd_fma(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ key_bias,
            const int* __restrict__ live, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int rep,
            int N, int m, int n_heads, float scale) {
  using C = BwdFma<D>;
  constexpr int BM = C::BM, NT = C::NT, LD = C::LD, LP = C::LP, DPT = C::DPT;
  constexpr int RJ = C::RJ, KI = C::KI, CK = C::CK;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  const float* Ks = sm + C::K_OFF;
  const float* Vs = sm + C::V_OFF;
  const float* bs = sm + C::B_OFF;
  float* Ps = sm + C::P_OFF;
  float* Ss = sm + C::S_OFF;
  float* parts = sm + C::DQ_OFF;

  const int bh = blockIdx.y, ball = blockIdx.x;
  const int b = bh / n_heads;
  if (live[b * (N / m) + ball] == 0) {          // all keys masked: p == 0
    zero_ball(dq, dk, dv, bh, ball, rep, N, m, D);
    return;
  }
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;
  stage_rows<float, D, LD>(sm + C::K_OFF, k + kv0, m, m, NT);
  stage_rows<float, D, LD>(sm + C::V_OFF, v + kv0, m, m, NT);
  stage_vals(sm + C::B_OFF, key_bias + (size_t)b * N + (size_t)ball * m, m, m, rt::NEG_INF,
             NT);
  // tile it: rows [it*BM, it*BM + BM) of the ball's rep*m, in one query head
  auto first_row = [&](int it) {
    const int row0 = it * BM;
    return ((size_t)bh * rep + row0 / m) * N + (size_t)ball * m + row0 % m;
  };
  auto load_tile = [&](int it, int buf) {
    const size_t g0 = first_row(it);
    stage_rows<float, D, LD>(sm + C::Q_OFF + buf * BM * LD, q + g0 * D, BM, BM, NT);
    stage_rows<float, D, LD>(sm + C::DO_OFF + buf * BM * LD, dout + g0 * D, BM, BM, NT);
    stage_vals(sm + C::L_OFF + buf * BM, lse + g0, BM, BM, rt::LSE_EMPTY, NT);
    stage_vals(sm + C::DL_OFF + buf * BM, delta + g0, BM, BM, 0.f, NT);
  };

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // A
  const int ka = (warp % 8) * 32 + lane % 8, ra = (warp / 8) * (BM / C::WR) + lane / 8;
  // B
  const int kb0 = warp * C::KB + lane % 4, db = (lane / 4) * DPT;
  // C
  const int chunk = warp / (BM / 16), dc = (lane % 8) * DPT;
  const int rc = ((warp % (BM / 16)) * 4 + lane / 8) * 4;
  const int n_chunks = m / CK;

  float dka[KI][DPT], dva[KI][DPT];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) dka[i][d] = dva[i][d] = 0.f;

  const int n_tiles = rep * m / BM;
  load_tile(0, 0);                              // joins K, V and bias's group
  rt::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const float* Qt = sm + C::Q_OFF + buf * BM * LD;
    const float* Dt = sm + C::DO_OFF + buf * BM * LD;
    const float* lt = sm + C::L_OFF + buf * BM;
    const float* dlt = sm + C::DL_OFF + buf * BM;

    // ---- A: S^T, dP^T (4 keys x RJ rows), then P and dS to shared memory
    if (ka - lane % 8 < m) {                    // warp-uniform: the warp's keys exist
      float st[4][RJ], dp[4][RJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
      for (int d = 0; d < D; d += 4) {
        float4 kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = *reinterpret_cast<const float4*>(Ks + (ka + 8 * i) * LD + d);
          vv[i] = *reinterpret_cast<const float4*>(Vs + (ka + 8 * i) * LD + d);
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const float4 qq = *reinterpret_cast<const float4*>(Qt + (ra + 4 * j) * LD + d);
          const float4 oo = *reinterpret_cast<const float4*>(Dt + (ra + 4 * j) * LD + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            st[i][j] = dot4(kk[i], qq, st[i][j]);
            dp[i][j] = dot4(vv[i], oo, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int row = ra + 4 * j;
        const float l = lt[row], dl = dlt[row];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = ka + 8 * i;
          const float p = rt::p_from_lse(st[i][j] * scale + bs[key], l);
          Ps[key * LP + row] = p;
          Ss[key * LP + row] = p * (dp[i][j] - dl) * scale;
        }
      }
    }
    __syncthreads();

    // ---- B: dV += P^T dO, dK += dS^T Q (KI keys x DPT dims)
    if (kb0 - lane % 4 < m) {                   // warp-uniform
#pragma unroll 1
      for (int r = 0; r < BM; r += 4) {
        float4 pp[KI], ss[KI];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pp[i] = *reinterpret_cast<const float4*>(Ps + (kb0 + 4 * i) * LP + r);
          ss[i] = *reinterpret_cast<const float4*>(Ss + (kb0 + 4 * i) * LP + r);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float od[DPT], qd[DPT];
          load_vec<DPT>(od, Dt + (r + c) * LD + db);
          load_vec<DPT>(qd, Qt + (r + c) * LD + db);
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            const float pv = lane_of(pp[i], c), sv = lane_of(ss[i], c);
#pragma unroll
            for (int d = 0; d < DPT; ++d) {
              dva[i][d] = fmaf(pv, od[d], dva[i][d]);
              dka[i][d] = fmaf(sv, qd[d], dka[i][d]);
            }
          }
        }
      }
    }

    // ---- C: this chunk's part of dQ = dS K (4 rows x DPT dims), then the
    // chunks summed in order
    if (chunk < n_chunks) {                     // warp-uniform
      float acc[4][DPT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[r][d] = 0.f;
#pragma unroll 4
      for (int key = chunk * CK; key < chunk * CK + CK; ++key) {
        const float4 sd = *reinterpret_cast<const float4*>(Ss + key * LP + rc);
        float kd[DPT];
        load_vec<DPT>(kd, Ks + key * LD + dc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float sv = lane_of(sd, r);
#pragma unroll
          for (int d = 0; d < DPT; ++d) acc[r][d] = fmaf(sv, kd[d], acc[r][d]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* dst = parts + (chunk * BM + rc + r) * D + dc;
#pragma unroll
        for (int d = 0; d < DPT; ++d) dst[d] = acc[r][d];
      }
    }
    __syncthreads();
    const size_t g0 = first_row(it);
    for (int e = threadIdx.x; e < BM * D; e += NT) {
      float sum = parts[e];
      for (int c = 1; c < n_chunks; ++c) sum += parts[c * BM * D + e];
      dq[g0 * D + e] = sum;
    }
  }
  rt::cp_async_wait<0>();

  if (kb0 - lane % 4 < m) {
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const size_t off = kv0 + (size_t)(kb0 + 4 * i) * D + db;
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dk[off + d] = dka[i][d];
        dv[off + d] = dva[i][d];
      }
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, const void* key_bias,
                const void* live, const void* dout, const void* lse, const void* delta,
                void* dq, void* dk, void* dv, int BH, int rep, int N, int m, int n_heads,
                float scale, cudaStream_t stream) {
  const int rows = rep * m;
  const int threads = rows < 256 ? ((rows + 31) / 32) * 32 : 256;
  const dim3 grid(N / m, BH);
  const size_t smem = (size_t)(2 * m * D + 2 * m) * sizeof(float);
  auto kern = bta_bwd_rows<T, D>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), rep, N, m, n_heads, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* live, const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, int BH, int rep, int N, int m, int n_heads,
               float scale, cudaStream_t stream) {
  using C = BwdFma<D>;
  if (m % 64 != 0 || m > C::MMAX) return (int)cudaErrorInvalidValue;
  auto kern = bta_bwd_fma<D>;
  if (int err = set_smem(kern, C::SMEM)) return err;
  kern<<<dim3(N / m, BH), C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const int*>(live), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), rep, N, m,
      n_heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// tiles: kernels/bta.py::bta_plan's path ("fma" = 1: fp32, D 16 or 32)
extern "C" int bta_bwd(const void* q, const void* k, const void* v,
                       const void* key_bias, const void* live, const void* dout,
                       const void* lse, const void* delta, void* dq, void* dk,
                       void* dv, int BH, int rep, int N, int D, int m, int n_heads,
                       int bf16, int tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % m != 0) return (int)cudaErrorInvalidValue;
  if (BH == 0 || rep == 0 || N == 0) return 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  if (tiles) {
    if (bf16) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 16: return launch_fma<16>(q, k, v, key_bias, live, dout, lse, delta, dq, dk, dv,
                                     BH, rep, N, m, n_heads, scale, s);
      case 32: return launch_fma<32>(q, k, v, key_bias, live, dout, lse, delta, dq, dk, dv,
                                     BH, rep, N, m, n_heads, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  RT_DISPATCH_D(D, {
    return bf16 ? launch_rows<__nv_bfloat16, kD>(q, k, v, key_bias, live, dout, lse, delta,
                                                 dq, dk, dv, BH, rep, N, m, n_heads, scale, s)
                : launch_rows<float, kD>(q, k, v, key_bias, live, dout, lse, delta, dq, dk,
                                         dv, BH, rep, N, m, n_heads, scale, s);
  });
  return 0;
}
