// Flash-attention backward for Hopper (sm_90a), part 2 of 2: dQ.
//
// Replaces: deeplearning_cfn_tpu/ops/attention.py `_flash_bwd_dq_kernel` (the
// Pallas TPU kernel launched by `_flash_backward`). Same function, same
// conventions as csrc/flash_attn_bwd_dkdv.cu: P = exp(scale*Q K^T - lse) is
// rebuilt tile by tile in f32 with the forward's masking (keys past Sk and, when
// causal, keys above the ends-aligned diagonal contribute exactly 0), and with
// delta = rowsum(dO * O) computed outside:
//   dS = P * (dO V^T - delta),   dQ = scale * dS K.
// A row that saw no key carries lse = +1e30 (the forward kernel writes it), so
// its P underflows to 0 and its dQ is exactly 0. Both variants loop over the KV
// tiles inside one block per Q tile (the TPU grid's sequential axis becomes
// that loop), so dQ stays in f32 registers and is written once. No atomics:
// every output element has one writer, so gradients are deterministic. Causal
// KV tiles wholly above the diagonal for this Q tile are skipped (the Pallas
// kernel's `kb*bk < (iq+1)*bq + (Sk-Sq)` rule), and q, k, v and dO are read
// through their batch/head/sequence strides (unit stride on the head dim).
//
// Two variants, chosen by the one rule for both backward kernels,
// ops/attention.py:backward_variant, which passes its choice to the C entry
// point:
//   tc   - bf16, D in {64, 128}: tensor cores (wgmma) fed by TMA;
//   simt - everything else, f32 above all: the CUDA-core kernel of the first
//          port, kept as it was. It is exact in f32, which chip_smoke.py's f32
//          gradient parity (1e-3 of each gradient's norm) relies on.
// The entry point launches the variant it is given or returns an error.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the training
// shape (B=128, H=8, Sq=Sk=128, D=64, bf16, causal) the call must read q, k, v,
// dO, lse and delta and write dQ, ~84.9 MB, about 25 us; its ~3.25 GFLOP
// (QK^T, dO V^T and dS K over the pairs the causal mask keeps) take ~3.3 us at
// the tensor-core rate, so bytes bound it.
//
// tc design. One block = one warpgroup (128 threads) per (64-row Q tile, head,
// batch), Q tiles scheduled heaviest first; thread 0 doubles as the TMA
// producer. Q and dO arrive once by TMA, K and V tiles of 64 keys through a
// two-stage TMA ring with one mbarrier per stage (128-byte swizzle,
// hopper.cuh); each thread keeps lse and delta of its two fragment rows in
// registers. Q rows are the M dimension of every product, so nothing but the
// loaded tiles goes through shared memory:
//   S  = Q K^T     wgmma, A = Q and B = K from shared memory (K-major);
//   dP = dO V^T    wgmma, A = dO and B = V from shared memory (K-major);
//   P  = exp(scale*S - lse), masked, and dS = P * (dP - delta), f32 registers;
//   dQ += dS K     wgmma, A = dS in registers (bf16), B = the same K tile read
//                  N-major;
// and dQ is scaled once when it is written. TMA zero-fills keys past Sk (S is
// 0 there, not -inf), so they are masked in the fragment like causal keys.
// Numerics: dS is rounded to bf16 for its product with K and the sums stay
// f32, as the dK/dV tc variant does for P^T and dS^T and the forward for P;
// the Pallas kernel keeps dS and K in f32 for that product
// (attention.py:432-434).
//
// simt design (the first port's kernel, CUDA-core FMAs, no tensor cores):
//   - one thread block of 8 warps per (Q tile of 32 rows, head, batch) looping
//     over KV tiles of 32 keys;
//   - Q and dO (once) and each K, V tile are staged in shared memory as f32,
//     rows padded to D+1 floats;
//   - phase 1 of a KV tile: lane j scores key j against 4 query rows of its
//     warp (q.k and dO.v) and writes scale*dS to shared memory; phase 2: each
//     warp owns 4 query rows, lane d owns head-dim columns d, d+32, d+64, d+96,
//     and accumulates dQ += dS K.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 32;                     // query rows per block
constexpr int kBlockK = 32;                     // keys per inner tile (one per lane)
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 4
constexpr int kMaxCols = 4;                     // D <= 128 = 4 * 32
constexpr int kLdS = kBlockK + 1;               // padded row of the dS tile

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
  void* dq;            // [B, H, Sq, D] contiguous
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
  return sizeof(float) * (2 * kBlockQ * ld + 2 * kBlockK * ld + kBlockQ * kLdS +
                          2 * kBlockQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* q_s = smem;                       // [kBlockQ][ld]
  float* do_s = q_s + kBlockQ * ld;        // [kBlockQ][ld]
  float* k_s = do_s + kBlockQ * ld;        // [kBlockK][ld]
  float* v_s = k_s + kBlockK * ld;         // [kBlockK][ld]
  float* ds_s = v_s + kBlockK * ld;        // [kBlockQ][kLdS], scale folded in
  float* lse_s = ds_s + kBlockQ * kLdS;    // [kBlockQ]
  float* delta_s = lse_s + kBlockQ;        // [kBlockQ]

  const int q0 = blockIdx.x * kBlockQ;
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

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    const bool in = qi < p.Sq;
    q_s[r * ld + d] = in ? to_float(q[qi * p.q_ss + d]) : 0.f;
    do_s[r * ld + d] = in ? to_float(dout[qi * p.o_ss + d]) : 0.f;
  }
  if (tid < kBlockQ) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < p.Sq ? p.lse[row0 + qi] : 0.f;
    delta_s[tid] = qi < p.Sq ? p.delta[row0 + qi] : 0.f;
  }

  float acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  const int shift = p.Sk - p.Sq;  // ends-aligned causal diagonal
  int k_end = p.Sk;
  if (p.causal) {
    // Last key any row of this tile may see; tiles wholly above it are skipped.
    const int q_last = min(q0 + kBlockQ, p.Sq) - 1 + shift;
    k_end = min(k_end, q_last + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // previous K/V tile consumed (and Q/dO tile written)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int kj = k0 + j;
      const bool in = kj < p.Sk;
      k_s[j * ld + d] = in ? to_float(k[kj * p.k_ss + d]) : 0.f;
      v_s[j * ld + d] = in ? to_float(v[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // Phase 1: scale*dS for (row i, key j = lane).
    const int j = lane;
    const int kj = k0 + j;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp + r * kWarps;
      const int qi = q0 + i;
      const bool live = qi < p.Sq && kj < p.Sk && !(p.causal && kj > qi + shift);
      float ds = 0.f;
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
        const float pr = expf(s * p.scale - lse_s[i]);
        ds = pr * (dp - delta_s[i]) * p.scale;
      }
      ds_s[i * kLdS + j] = ds;
    }
    __syncthreads();

    // Phase 2: this warp's rows, this lane's head-dim columns.
    const int n_keys = min(kBlockK, p.Sk - k0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const float* kr = k_s + jj * ld;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds = ds_s[(warp + r * kWarps) * kLdS + jj];
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int d = lane + c * 32;
          if (d < D) acc[r][c] = fmaf(ds, kr[d], acc[r][c]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + row0 * D;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp + r * kWarps;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = lane + c * 32;
      if (d < D) dq[(long long)qi * D + d] = from_float<T>(acc[r][c]);
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_attn_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- tc variant

constexpr int kTcRows = 64;   // query rows per block (every product's M)
constexpr int kTcKeys = 64;   // keys per K/V tile
constexpr int kTcThreads = 128;
constexpr int kPanelBytes = 64 * hopper::kSwizzleRow;  // [64 rows][64 cols] bf16

struct TcParams {
  const float* lse;    // [B, H, Sq] contiguous
  const float* delta;  // [B, H, Sq] contiguous
  void* dq;            // [B, H, Sq, D] contiguous
  int H, Sq, Sk;
  float scale;
  int causal;
};

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, dO, two K stages, two V stages, three mbarriers, and room to align.
  return 6 * (D / 64) * kPanelBytes + 3 * sizeof(uint64_t) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attn_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do, const TcParams p) {
  using namespace hopper;
  constexpr int kPanels = D / 64;
  constexpr int kTile = kPanels * kPanelBytes;  // one [64][D] bf16 tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + kTile;
  uint8_t* k_s = do_s + kTile;     // [2 stages][tile]
  uint8_t* v_s = k_s + 2 * kTile;  // [2 stages][tile]
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + 2 * kTile);  // Q/dO, stage 0, 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = p.Sk - p.Sq;  // ends-aligned causal diagonal
  // The last key any row of this tile may see is min(q0 + 64, Sq) - 1 + shift;
  // KV tiles wholly past it are skipped.
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, min(q0 + kTcRows, p.Sq) + shift);
  const int n_tiles = max(0, (k_end + kTcKeys - 1) / kTcKeys);

  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int j, int st) {
    mbar_expect_tx(&bar[1 + st], 2 * kTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(k_s + st * kTile + pn * kPanelBytes, map_k, &bar[1 + st], pn * 64,
               j * kTcKeys, h, b);
      tma_load(v_s + st * kTile + pn * kPanelBytes, map_v, &bar[1 + st], pn * 64,
               j * kTcKeys, h, b);
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
      tma_load(q_s + pn * kPanelBytes, &tm_q, &bar[0], pn * 64, q0, h, b);
      tma_load(do_s + pn * kPanelBytes, &tm_do, &bar[0], pn * 64, q0, h, b);
    }
    for (int j = 0; j < min(2, n_tiles); ++j) load_kv(j, j);
  }

  // This thread's rows (r_lo, r_lo + 8) with their lse and delta, and its
  // columns (c_lo + 8n + {0, 1}) of every fragment.
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  bool row_in[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r_lo + 8 * i;
    row_in[i] = qi < p.Sq;
    lse_r[i] = row_in[i] ? p.lse[row0 + qi] : 0.f;
    delta_r[i] = row_in[i] ? p.delta[row0 + qi] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(&bar[0], 0);
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    mbar_wait(&bar[1 + st], (j >> 1) & 1);
    const uint32_t k_addr = smem_u32(k_s + st * kTile);
    const uint32_t v_addr = smem_u32(v_s + st * kTile);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(s, kmajor_desc(q_addr, kk, kPanelBytes),
                         kmajor_desc(k_addr, kk, kPanelBytes), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(dp, kmajor_desc(do_addr, kk, kPanelBytes),
                         kmajor_desc(v_addr, kk, kPanelBytes), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of dP. TMA zero-fills keys past Sk (S = 0 there, not
    // -inf), so they are masked here like the causal ones: exactly 0.
    const int k0 = j * kTcKeys;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kj = k0 + 8 * n + c_lo + (e & 1);
        const bool live = row_in[i] && kj < p.Sk && !(p.causal && kj > r_lo + 8 * i + shift);
        const float pr = live ? __expf(s[4 * n + e] * p.scale - lse_r[i]) : 0.f;
        dp[4 * n + e] = pr * (dp[4 * n + e] - delta_r[i]);
      }
    }
    uint32_t dsa[4][4];
    to_a_frags(dp, dsa);  // dS rounded to bf16 for the dS K product

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs_m64n64k16(dq, dsa[kk], nmajor_desc(k_addr, kk, kPanelBytes), 1);
      } else {
        wgmma_rs_m64n128k16(dq, dsa[kk], nmajor_desc(k_addr, kk, kPanelBytes), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);

    // Every warp is done with this stage: refill it with tile j + 2.
    named_barrier_sync(1, kTcThreads);
    if (tid == 0 && j + 2 < n_tiles) load_kv(j + 2, st);
  }

  __nv_bfloat16* dq_out = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_in[i]) continue;
    const long long row = (row0 + r_lo + 8 * i) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dq_out + row + 8 * n + c_lo) = __floats2bfloat162_rn(
          dq[4 * n + 2 * i] * p.scale, dq[4 * n + 2 * i + 1] * p.scale);
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
        flash_attn_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((tp.Sq + kTcRows - 1) / kTcRows, tp.H, B);
  flash_attn_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, tdo, tp);
  return (int)cudaGetLastError();
}

enum Variant { kSimt = 0, kTc = 1 };

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dQ share it). Strides are in
// elements. `variant` is the one the caller's rule picked (0 simt, 1 tc); the
// caller also checks shapes and, for tc, that rows start on 16 bytes. Returns
// a cudaError_t (0 = launched); refuses head dims the kernels were not written
// for and tc asked for another dtype or head dim.
int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq,
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
  if (variant == kTc) {
    const TcParams tp{lse, delta, dq, H, Sq, Sk, scale, causal};
    return D == 64 ? launch_tc<64>(q, k, v, dout, tp, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                   v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, s)
                   : launch_tc<128>(q, k, v, dout, tp, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                    v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, s);
  }
  Params p{q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, scale, causal};
  return dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
}

}  // extern "C"
