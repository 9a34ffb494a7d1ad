// Flash-attention backward for Hopper (sm_90a), part 1 of 2: dK and dV.
//
// Replaces: deeplearning_cfn_tpu/ops/attention.py `_flash_bwd_dkdv_kernel` (the
// Pallas TPU kernel launched by `_flash_backward`). Same function, same
// conventions: the forward saved only O and the per-row logsumexp `lse` of the
// SCALED logits; this kernel rebuilds P = exp(scale*Q K^T - lse) tile by tile in
// f32 (after loading bf16 inputs, as the Pallas kernel does), with the forward's
// masking (`_bwd_mask`): keys past Sk and, when causal, keys above the diagonal
// that aligns the ends of the true Sq and Sk contribute exactly 0. With
// delta = rowsum(dO * O) computed outside (a plain torch op, as JAX does):
//   dV = P^T dO,   dS = P * (dO V^T - delta),   dK = scale * dS^T Q.
// Rows that saw no key carry lse = +1e30, so their P underflows to exactly 0.
// Both variants loop over the Q tiles inside one block per KV tile (the TPU
// grid's sequential "arbitrary" axis becomes that loop), so dK and dV stay in
// f32 registers for the whole loop and are written once. No atomics: every
// output element has exactly one writer, so gradients are deterministic. Causal
// Q tiles that lie wholly above the diagonal for this KV tile are skipped (the
// `(qi+1)*bq + (Sk-Sq) > ik*bk` rule of the Pallas kernel), and q, k, v and dO
// are read through their batch/head/sequence strides (unit stride on the head
// dim), so the model's transposed views - dO arrives as one from `_merge` -
// need no copy.
//
// Two variants, chosen by one explicit rule on dtype and shape,
// ops/attention.py:dkdv_variant, which passes its choice to the C entry point:
//   tc   - bf16, D in {64, 128}: tensor cores (wgmma) fed by TMA;
//   simt - everything else, f32 above all: the CUDA-core kernel of the first
//          port, kept as it was. It is exact in f32, which chip_smoke.py's f32
//          gradient parity (1e-3 of each gradient's norm) relies on.
// The entry point launches the variant it is given or returns an error.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the training
// shape (B=128, H=8, Sq=Sk=128, D=64, bf16, causal) the call must read q, k, v,
// dO, lse and delta and write dK and dV, ~101.7 MB, about 30 us; its ~4 GFLOP
// (halved by the causal skip) take ~4 us at the tensor-core rate, so bytes bound
// it. The tensor cores are there to take the FMAs off the critical path, TMA
// and the ring to keep the bytes in flight.
//
// tc design. One block = one warpgroup (128 threads) per (64-key tile, head,
// batch); thread 0 doubles as the TMA producer. K and V arrive once; the Q and
// dO tiles of 64 rows arrive by TMA into a two-stage ring (128-byte swizzle,
// hopper.cuh), lse and delta by plain loads. Keys are the M dimension of every
// product, so nothing but the loaded tiles goes through shared memory:
//   S^T  = K Q^T            wgmma, A = K and B = Q from shared memory (K-major);
//   dP^T = V dO^T           wgmma, A = V and B = dO from shared memory;
//   P^T  = exp(scale*S^T - lse), masked, in f32 registers;
//   dS^T = P^T * (dP^T - delta), in f32 registers;
//   dV  += P^T dO           wgmma, A = P^T in registers (bf16), B = dO N-major;
//   dK  += dS^T Q           wgmma, A = dS^T in registers (bf16), B = Q N-major;
// and dK is scaled once when it is written. P^T and dS^T are rounded to bf16
// for their products (the forward rounds P the same way); the sums stay f32.
//
// simt design (the first port's kernel, CUDA-core FMAs): one block of 8 warps
// per 32-key tile looping over 32-row Q tiles; K, V, Q and dO staged in shared
// memory as f32 (rows padded to D+1 floats); phase 1 scores lane j's key against
// 4 rows per warp and writes P and scale*dS to shared memory, phase 2
// accumulates dV and dK with each lane owning head-dim columns d, d+32, ....

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 32;                  // query rows per inner tile
constexpr int kBlockK = 32;                  // keys per block (one per lane)
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 4 rows (phase 1), 4 keys (phase 2)
constexpr int kMaxCols = 4;                  // D <= 128 = 4 * 32
constexpr int kLdS = kBlockK + 1;            // padded row of the P / dS tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq] contiguous
  const float* delta;  // [B, H, Sq] contiguous
  void* dk;            // [B, H, Sk, D] contiguous
  void* dv;            // [B, H, Sk, D] contiguous
  int B, H, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // dO
  float scale;
  int causal;
};

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (2 * kBlockK * ld + 2 * kBlockQ * ld + 2 * kBlockQ * kLdS +
                          2 * kBlockQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* k_s = smem;                       // [kBlockK][ld]
  float* v_s = k_s + kBlockK * ld;         // [kBlockK][ld]
  float* q_s = v_s + kBlockK * ld;         // [kBlockQ][ld]
  float* do_s = q_s + kBlockQ * ld;        // [kBlockQ][ld]
  float* p_s = do_s + kBlockQ * ld;        // [kBlockQ][kLdS]
  float* ds_s = p_s + kBlockQ * kLdS;      // [kBlockQ][kLdS], scale folded in
  float* lse_s = ds_s + kBlockQ * kLdS;    // [kBlockQ]
  float* delta_s = lse_s + kBlockQ;        // [kBlockQ]

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  const float* lse = p.lse + row0;
  const float* delta = p.delta + row0;

  for (int i = tid; i < kBlockK * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const int kj = k0 + j;
    const bool in = kj < p.Sk;
    k_s[j * ld + d] = in ? to_float(k[kj * p.k_ss + d]) : 0.f;
    v_s[j * ld + d] = in ? to_float(v[kj * p.v_ss + d]) : 0.f;
  }

  float dk_acc[kRowsPerWarp][kMaxCols], dv_acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      dk_acc[r][c] = 0.f;
      dv_acc[r][c] = 0.f;
    }
  }

  const int shift = p.Sk - p.Sq;  // ends-aligned causal diagonal
  int q_begin = 0;
  if (p.causal) {
    // Row qi sees key kj iff kj <= qi + shift: the first row that can see
    // this tile's first key is k0 - shift; earlier Q tiles are all masked.
    q_begin = max(0, k0 - shift) / kBlockQ * kBlockQ;
  }

  const int j = lane;  // phase 1: this lane's key
  const int kj = k0 + j;
  for (int q0 = q_begin; q0 < p.Sq; q0 += kBlockQ) {
    __syncthreads();  // previous Q tile consumed (and K/V tile written)
    for (int i = tid; i < kBlockQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int qi = q0 + r;
      const bool in = qi < p.Sq;
      q_s[r * ld + d] = in ? to_float(q[qi * p.q_ss + d]) : 0.f;
      do_s[r * ld + d] = in ? to_float(dout[qi * p.o_ss + d]) : 0.f;
    }
    if (tid < kBlockQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < p.Sq ? lse[qi] : 0.f;
      delta_s[tid] = qi < p.Sq ? delta[qi] : 0.f;
    }
    __syncthreads();

    // Phase 1: P and scale*dS for (row i, key j).
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp + r * kWarps;
      const int qi = q0 + i;
      const bool live = qi < p.Sq && kj < p.Sk && !(p.causal && kj > qi + shift);
      float pr = 0.f, ds = 0.f;
      if (live) {
        const float* qr = q_s + i * ld;
        const float* dr = do_s + i * ld;
        const float* kr = k_s + j * ld;
        const float* vr = v_s + j * ld;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(dr[d], vr[d], dp);
        }
        pr = expf(s * p.scale - lse_s[i]);
        ds = pr * (dp - delta_s[i]) * p.scale;
      }
      p_s[i * kLdS + j] = pr;
      ds_s[i * kLdS + j] = ds;
    }
    __syncthreads();

    // Phase 2: this warp's keys, this lane's head-dim columns.
    const int n_rows = min(kBlockQ, p.Sq - q0);
    for (int i = 0; i < n_rows; ++i) {
      const float* qr = q_s + i * ld;
      const float* dr = do_s + i * ld;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int jr = warp + r * kWarps;
        const float pr = p_s[i * kLdS + jr];
        const float ds = ds_s[i * kLdS + jr];
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int d = lane + c * 32;
          if (d < D) {
            dv_acc[r][c] = fmaf(pr, dr[d], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(ds, qr[d], dk_acc[r][c]);
          }
        }
      }
    }
  }

  const long long out0 = ((long long)b * p.H + h) * p.Sk * D;
  T* dk = static_cast<T*>(p.dk) + out0;
  T* dv = static_cast<T*>(p.dv) + out0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp + r * kWarps;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = lane + c * 32;
      if (d < D) {
        dk[(long long)key * D + d] = from_float<T>(dk_acc[r][c]);
        dv[(long long)key * D + d] = from_float<T>(dv_acc[r][c]);
      }
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.Sk + kBlockK - 1) / kBlockK, p.H, p.B);
  flash_attn_bwd_dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------- tc variant

constexpr int kTcKeys = 64;   // keys per block (every product's M)
constexpr int kTcRows = 64;   // query rows per inner tile
constexpr int kTcThreads = 128;
constexpr int kPanelBytes = 64 * hopper::kSwizzleRow;  // [64 rows][64 cols] bf16

struct TcParams {
  const float* lse;    // [B, H, Sq] contiguous
  const float* delta;  // [B, H, Sq] contiguous
  void* dk;            // [B, H, Sk, D] contiguous
  void* dv;            // [B, H, Sk, D] contiguous
  int H, Sq, Sk;
  float scale;
  int causal;
};

template <int D>
constexpr size_t tc_smem_bytes() {
  // K, V, two Q stages, two dO stages, lse/delta per stage, 3 barriers, align.
  return 6 * (D / 64) * kPanelBytes + 2 * 2 * kTcRows * sizeof(float) +
         3 * sizeof(uint64_t) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attn_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do, const TcParams p) {
  using namespace hopper;
  constexpr int kPanels = D / 64;
  constexpr int kTile = kPanels * kPanelBytes;  // one [64][D] bf16 tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + kTile;
  uint8_t* q_s = v_s + kTile;       // [2 stages][tile]
  uint8_t* do_s = q_s + 2 * kTile;  // [2 stages][tile]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile);  // [2 stages][64]
  float* delta_s = lse_s + 2 * kTcRows;                       // [2 stages][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(delta_s + 2 * kTcRows);  // K/V, stage 0, 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kTcKeys;
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = p.Sk - p.Sq;  // ends-aligned causal diagonal
  // Row qi sees key kj iff kj <= qi + shift: the first row that can see this
  // tile's first key is k0 - shift; earlier Q tiles are all masked.
  const int q_begin = p.causal ? max(0, k0 - shift) / kTcRows * kTcRows : 0;
  const int n_tiles = (p.Sq - q_begin + kTcRows - 1) / kTcRows;

  const CUtensorMap* map_q = &tm_q;
  const CUtensorMap* map_do = &tm_do;
  auto load_q = [&](int j, int st) {
    mbar_expect_tx(&bar[1 + st], 2 * kTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(q_s + st * kTile + pn * kPanelBytes, map_q, &bar[1 + st], pn * 64,
               q_begin + j * kTcRows, h, b);
      tma_load(do_s + st * kTile + pn * kPanelBytes, map_do, &bar[1 + st], pn * 64,
               q_begin + j * kTcRows, h, b);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], 2 * kTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(k_s + pn * kPanelBytes, &tm_k, &bar[0], pn * 64, k0, h, b);
      tma_load(v_s + pn * kPanelBytes, &tm_v, &bar[0], pn * 64, k0, h, b);
    }
    for (int j = 0; j < min(2, n_tiles); ++j) load_q(j, j);
  }

  // This thread's keys (kr, kr + 8) and Q-tile columns (c_lo + 8n + {0, 1}).
  const int kr = k0 + warp * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  const long long row0 = ((long long)b * p.H + h) * p.Sq;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(&bar[0], 0);
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const int qt = q_begin + j * kTcRows;
    // lse and delta of this Q tile (the stage's copy was last read two tiles
    // ago, before the barrier that ended that tile).
    {
      const int r = tid & (kTcRows - 1);
      const float* src = tid < kTcRows ? p.lse : p.delta;
      float* dst = (tid < kTcRows ? lse_s : delta_s) + st * kTcRows;
      dst[r] = qt + r < p.Sq ? src[row0 + qt + r] : 0.f;
    }
    named_barrier_sync(1, kTcThreads);
    mbar_wait(&bar[1 + st], (j >> 1) & 1);
    const uint32_t q_addr = smem_u32(q_s + st * kTile);
    const uint32_t do_addr = smem_u32(do_s + st * kTile);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(s, kmajor_desc(k_addr, kk, kPanelBytes),
                         kmajor_desc(q_addr, kk, kPanelBytes), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dp, kmajor_desc(v_addr, kk, kPanelBytes),
                         kmajor_desc(do_addr, kk, kPanelBytes), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const float* lse_t = lse_s + st * kTcRows;
    const float* delta_t = delta_s + st * kTcRows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kr + 8 * (e >> 1);
        const int c = 8 * n + c_lo + (e & 1);
        const int qi = qt + c;
        const bool live = qi < p.Sq && kj < p.Sk && !(p.causal && kj > qi + shift);
        const float pr = live ? __expf(s[4 * n + e] * p.scale - lse_t[c]) : 0.f;
        s[4 * n + e] = pr;
        dp[4 * n + e] = pr * (dp[4 * n + e] - delta_t[c]);
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, dsa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs_m64n64k16(dv, pa[kk], nmajor_desc(do_addr, kk, kPanelBytes), 1);
      } else {
        wgmma_rs_m64n128k16(dv, pa[kk], nmajor_desc(do_addr, kk, kPanelBytes), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs_m64n64k16(dk, dsa[kk], nmajor_desc(q_addr, kk, kPanelBytes), 1);
      } else {
        wgmma_rs_m64n128k16(dk, dsa[kk], nmajor_desc(q_addr, kk, kPanelBytes), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);

    // Every warp is done with this stage: refill it with tile j + 2.
    named_barrier_sync(1, kTcThreads);
    if (tid == 0 && j + 2 < n_tiles) load_q(j + 2, st);
  }

  const long long out0 = ((long long)b * p.H + h) * p.Sk;
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kr + 8 * i;
    if (kj >= p.Sk) continue;
    const long long row = (out0 + kj) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + c_lo;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + row + c) = __floats2bfloat162_rn(
          dk[4 * n + 2 * i] * p.scale, dk[4 * n + 2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + row + c) =
          __floats2bfloat162_rn(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const TcParams& tp, int B, long long q_sb, long long q_sh, long long q_ss,
              long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss, long long o_sb, long long o_sh, long long o_ss,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::make_map(&tq, q, B, tp.H, tp.Sq, D, q_ss, q_sh, q_sb, kTcRows) ||
      !hopper::make_map(&tk, k, B, tp.H, tp.Sk, D, k_ss, k_sh, k_sb, kTcKeys) ||
      !hopper::make_map(&tv, v, B, tp.H, tp.Sk, D, v_ss, v_sh, v_sb, kTcKeys) ||
      !hopper::make_map(&tdo, dout, B, tp.H, tp.Sq, D, o_ss, o_sh, o_sb, kTcRows))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bwd_dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((tp.Sk + kTcKeys - 1) / kTcKeys, tp.H, B);
  flash_attn_bwd_dkdv_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, tdo, tp);
  return (int)cudaGetLastError();
}

enum Variant { kSimt = 0, kTc = 1 };

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dK, dV share it). Strides are
// in elements. `variant` is the one the caller's rule picked (0 simt, 1 tc);
// the caller also checks shapes and, for tc, that rows start on 16 bytes.
// Returns a cudaError_t (0 = launched); refuses head dims the kernels were not
// written for and tc asked for another dtype or head dim.
int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv,
                        int B, int H, int Sq, int Sk, int D,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        float scale, int causal, int dtype, int variant, void* stream) {
  if (D < 16 || D > 32 * kMaxCols || D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (variant != kSimt && (variant != kTc || dtype != 1 || (D != 64 && D != 128)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (variant == kTc) {
    const TcParams tp{lse, delta, dk, dv, H, Sq, Sk, scale, causal};
    err = D == 64 ? launch_tc<64>(q, k, v, dout, tp, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                  v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, s)
                  : launch_tc<128>(q, k, v, dout, tp, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                   v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, s);
  } else {
    Params p{q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D,
             q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
             o_sb, o_sh, o_ss, scale, causal};
    err = dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
  }
  return err;
}

}  // extern "C"
