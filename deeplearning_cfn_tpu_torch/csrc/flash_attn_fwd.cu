// Flash-attention forward for Hopper (sm_90a): O = softmax(scale*Q K^T + bias, causal) V.
//
// Replaces: deeplearning_cfn_tpu/ops/attention.py `_flash_kernel` (the Pallas TPU
// online-softmax kernel launched by `_flash_forward`). Same function, same
// conventions: q is scaled before the softmax (see the tensor-core note for
// where), bias masking uses -1e30 (a row whose every key is masked comes out as
// a uniform softmax, never NaN), the causal diagonal aligns the ends of the true
// Sq and Sk, P is rounded to V's dtype before the PV product, and the optional
// lse is m + log(l) per row (+1e30 for a row that saw no key). One corner
// differs from the plain version: keys above the causal diagonal do not exist
// for the kernel (their tiles are skipped), so a causal row whose every visible
// key the bias also masks spreads its uniform weight over the visible keys only,
// where the plain version spreads it over all Sk. The serving path never
// combines causal with a bias.
//
// Three variants, chosen by one explicit rule on dtype and shape,
// ops/attention.py:forward_variant, which passes its choice to the C entry point
// (never a retry after a failed launch):
//   tc     - bf16, Sq >= 16, D in {64, 128}: tensor cores (wgmma) fed by TMA;
//   decode - bf16, Sq < 16: split-K over all warps of a block, vector loads;
//   simt   - everything else, f32 above all: the CUDA-core kernel of the first
//            port, kept as it was. It is exact in f32 (the f32 token identity
//            and gradient parity of chip_smoke.py depend on that); TF32 tensor
//            cores would round the products to 10 mantissa bits.
// The entry point launches the variant it is given or returns an error.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): ~4*D FLOPs per
// (query, key) pair against 2*D bytes per key row and 2*D per query row. At the
// decode shapes (Sq = 1) that is ~1 FLOP/byte, at the encoder and training
// shapes (Sq = Sk = 128, D = 64) ~64 FLOP/byte: all below the ~295 FLOP/byte
// ridge, so the bytes of Q, K, V, O (and the bias) bound every call.
//
// tc design. One block = one consumer warpgroup (128 threads) per (64-row Q
// tile, head, batch); thread 0 doubles as the TMA producer:
//   - Q arrives once, K/V tiles of 64 keys arrive by TMA into a two-stage ring
//     with one mbarrier per stage, in bf16 with the 128-byte swizzle wgmma
//     reads (hopper.cuh). The tensor maps carry the wrapper's strides, so the
//     model's [B,S,H,D] -> [B,H,S,D] views need no copy. A stage is refilled as
//     soon as the warpgroup has finished the tile in it, so the next tile's
//     load is always in flight during this tile's math; several blocks per SM
//     overlap the rest.
//   - S = Q K^T is a wgmma with both operands in shared memory (K-major);
//     O += P V is a wgmma with P in registers (the f32 S fragment converted to
//     bf16 in place, as in FlashAttention-3) and V read N-major.
//   - Online softmax on the S fragment in f32, row max and sum over the four
//     lanes of a quad. The scale multiplies the f32 product q.k: that equals
//     scaling q first up to one f32 rounding (none at D = 64, where the scale
//     is a power of two), while scaling the bf16 Q tile in shared memory would
//     round q a second time.
//   - Keys past Sk and above the causal diagonal are masked in the fragment
//     (TMA's zero fill is never scored); tiles wholly above the diagonal are
//     skipped, and Q tiles are scheduled heaviest first. The bias is read
//     through its strides in f32 (stride 0 on broadcast dims).
//   - 64-row Q tiles keep B*H*Sq/64 blocks in flight: 128 at the encoder shape
//     for 132 SMs, 2048 at the training shape.
//
// simt design (the first port's kernel, CUDA-core FMAs): one block of 4 warps
// per (16-row Q tile, head, batch); K/V tiles of 32 keys staged in shared
// memory as f32 (K rows padded to D+1 floats); lane j scores key j of the tile,
// the warp reduces max and sum with shuffles, and lane d accumulates output
// columns d, d+32, d+64, d+96; q, k, v and the bias are read through strides.
//
// decode design (Sq < 16; tensor cores do not fit a 1-row Q: a wgmma needs 64
// rows). One block of 8 warps per (query row, head, batch). The block splits the
// keys over all its warps: each key row is read by D/8 lanes (rounded up to a
// power of two) with one 16-byte load each for K and for V, the lanes reduce the
// dot with shuffles, and each lane group keeps its own online-softmax state
// (m, l, and 8 output columns). The groups of a warp merge with shuffles, the
// warps through shared memory. So every warp streams K and V, where the first
// kernel kept one warp of four busy walking Sk serially.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 32;                     // one key per lane
constexpr int kMaxCols = 4;                     // D <= 128 = 4 * 32
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P rounded to V's dtype before the PV product (attention.py:154).
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_float(from_float<T>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // nullptr = no bias
  void* out;          // [B, H, Sq, D] contiguous
  float* lse;         // [B, H, Sq] contiguous, nullptr = not wanted
  int B, H, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
  int causal;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attn_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  float* q_s = smem;                        // [kBlockQ][D]
  float* k_s = q_s + kBlockQ * D;           // [kBlockK][D + 1]
  float* v_s = k_s + kBlockK * (D + 1);     // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;           // [kWarps][kBlockK]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nthreads = kWarps * 32;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;

  // Q tile, scaled before the dot as the TPU kernel does (attention.py:129).
  for (int i = tid; i < kBlockQ * D; i += nthreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    q_s[i] = qi < p.Sq ? to_float(q[qi * p.q_ss + d]) * p.scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[i][c] = 0.f;
  }

  const int shift = p.Sk - p.Sq;  // ends-aligned causal diagonal
  int k_end = p.Sk;
  if (p.causal) {
    // Last key any row of this tile may see; tiles wholly above it are skipped.
    const int q_last = min(q0 + kBlockQ, p.Sq) - 1 + shift;
    k_end = min(k_end, q_last + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and Q tile written)
    for (int i = tid; i < kBlockK * D; i += nthreads) {
      const int j = i / D, d = i - j * D;
      const int kj = k0 + j;
      const bool in = kj < p.Sk;
      k_s[j * (D + 1) + d] = in ? to_float(k[kj * p.k_ss + d]) : 0.f;
      v_s[i] = in ? to_float(v[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const int n_in = min(kBlockK, p.Sk - k0);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      const int qi = q0 + r;
      if (qi >= p.Sq) break;  // warp-uniform
      // Keys past Sk and keys above the causal diagonal contribute exactly
      // 0, whether their tile is skipped or not; bias-masked keys carry
      // -1e30 like the reference, so an all-masked row stays uniform.
      const bool visible = kj < p.Sk && !(p.causal && kj > qi + shift);
      float s = kNegInf;
      if (visible) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + lane * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
        if (bias) s += bias[qi * p.b_sq + kj * p.b_sk];
      }
      const float m_cur = warp_max(visible ? s : -CUDART_INF_F);
      const float m_new = fmaxf(m[i], m_cur);
      const float pr = visible ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(pr);
      m[i] = m_new;
      p_s[warp * kBlockK + lane] = round_p<T>(pr);
      __syncwarp();
      const float* pw = p_s + warp * kBlockK;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int d = lane + c * 32;
        if (d < D) {
          float a = acc[i][c] * alpha;
          for (int j = 0; j < n_in; ++j) a = fmaf(pw[j], v_s[j * D + d], a);
          acc[i][c] = a;
        }
      }
      __syncwarp();  // p_s reused by this warp's next row
    }
  }

  T* out = static_cast<T*>(p.out) + ((long long)b * p.H + h) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp + i * kWarps;
    if (qi >= p.Sq) break;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = lane + c * 32;
      if (d < D) out[(long long)qi * D + d] = from_float<T>(acc[i][c] * inv);
    }
    if (p.lse && lane == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + qi] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : 1e30f;
    }
  }
}


// ------------------------------------------------------------- tc variant

constexpr int kTcRows = 64;   // query rows per block (one wgmma M)
constexpr int kTcKeys = 64;   // keys per K/V tile (the S wgmma's N)
constexpr int kTcThreads = 128;
constexpr int kPanelBytes = kTcKeys * hopper::kSwizzleRow;  // [64 rows][64 cols] bf16

struct TcParams {
  const float* bias;  // nullptr = no bias
  void* out;          // [B, H, Sq, D] contiguous
  float* lse;         // [B, H, Sq] contiguous, nullptr = not wanted
  int H, Sq, Sk;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
  int causal;
};

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, two K stages, two V stages, three mbarriers, and room to align.
  return 5 * (D / 64) * kPanelBytes + 3 * sizeof(uint64_t) + 1024;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const TcParams p) {
  using namespace hopper;
  constexpr int kPanels = D / 64;
  constexpr int kTile = kPanels * kPanelBytes;  // one [64][D] bf16 tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* k_s = q_s + kTile;      // [2 stages][tile]
  uint8_t* v_s = k_s + 2 * kTile;  // [2 stages][tile]
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + 2 * kTile);  // Q, stage 0, stage 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int shift = p.Sk - p.Sq;  // ends-aligned causal diagonal
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, min(q0 + kTcRows, p.Sq) + shift);
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;

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
    mbar_expect_tx(&bar[0], kTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
      tma_load(q_s + pn * kPanelBytes, &tm_q, &bar[0], pn * 64, q0, h, b);
    for (int j = 0; j < min(2, n_tiles); ++j) load_kv(j, j);
  }

  // This thread's rows (r_lo, r_lo + 8) and columns (c_lo + 8n + {0, 1}).
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  bool row_in[2];
  const float* bias_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r_lo + 8 * i;
    row_in[i] = qi < p.Sq;
    bias_row[i] = (p.bias && row_in[i])
                      ? p.bias + b * p.b_sb + h * p.b_sh + qi * p.b_sq : nullptr;
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  mbar_wait(&bar[0], 0);
  const uint32_t q_addr = smem_u32(q_s);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    mbar_wait(&bar[1 + st], (j >> 1) & 1);
    const uint32_t k_addr = smem_u32(k_s + st * kTile);
    const uint32_t v_addr = smem_u32(v_s + st * kTile);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(s, kmajor_desc(q_addr, kk, kPanelBytes),
                         kmajor_desc(k_addr, kk, kPanelBytes), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Scale, bias, mask; then the online softmax of this tile.
    const int k0 = j * kTcKeys;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kj = k0 + 8 * n + c_lo + (e & 1);
        const bool vis = row_in[i] && kj < p.Sk && !(p.causal && kj > r_lo + 8 * i + shift);
        float x = s[4 * n + e] * p.scale;
        if (vis && bias_row[i]) x += bias_row[i][kj * p.b_sk];
        x = vis ? x : -CUDART_INF_F;
        s[4 * n + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      alpha[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __expf(s[4 * n + e] - m_r[e >> 1]);  // exp(-inf) = 0
        l_r[e >> 1] += pr;  // this thread's share; the quad sums at the end
        s[4 * n + e] = pr;
      }
    }
    uint32_t pa[4][4];
    to_a_frags(s, pa);  // P rounded to bf16 before the PV product
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * n + e] *= alpha[e >> 1];
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs_m64n64k16(o, pa[kk], nmajor_desc(v_addr, kk, kPanelBytes), 1);
      } else {
        wgmma_rs_m64n128k16(o, pa[kk], nmajor_desc(v_addr, kk, kPanelBytes), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    // Every warp is done with this stage: refill it with tile j + 2.
    named_barrier_sync(1, kTcThreads);
    if (tid == 0 && j + 2 < n_tiles) load_kv(j + 2, st);
  }

  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_r[i]);
    if (!row_in[i]) continue;
    const int qi = r_lo + 8 * i;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = out + (row0 + qi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + c_lo) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
    if (p.lse && (lane & 3) == 0)
      p.lse[row0 + qi] = l > 0.f ? m_r[i] + logf(fmaxf(l, 1e-37f)) : 1e30f;
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const TcParams& tp, int B,
              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!hopper::make_map(&tq, q, B, tp.H, tp.Sq, D, q_ss, q_sh, q_sb, kTcRows) ||
      !hopper::make_map(&tk, k, B, tp.H, tp.Sk, D, k_ss, k_sh, k_sb, kTcKeys) ||
      !hopper::make_map(&tv, v, B, tp.H, tp.Sk, D, v_ss, v_sh, v_sb, kTcKeys))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((tp.Sq + kTcRows - 1) / kTcRows, tp.H, B);
  flash_attn_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, tp);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- decode variant

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;

// LPK lanes share one key row, 8 bf16 columns (16 bytes) each.
template <int LPK>
__global__ void __launch_bounds__(kDecThreads)
flash_attn_fwd_decode_kernel(Params p) {
  constexpr int kKeysPerWarp = 32 / LPK;
  constexpr int kGroups = kDecWarps * kKeysPerWarp;  // keys the block reads at once
  __shared__ float red_m[kDecWarps], red_l[kDecWarps];
  __shared__ float red_acc[kDecWarps][8 * LPK];

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = (lane % LPK) * 8;
  const bool active = d0 < p.D;
  const int slot = lane / LPK;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh + qi * p.q_ss;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias ? p.bias + b * p.b_sb + h * p.b_sh + qi * p.b_sq : nullptr;

  // q scaled before the dot, in f32 (attention.py:129).
  float qv[8];
  {
    uint4 raw = active ? *reinterpret_cast<const uint4*>(q + d0) : make_uint4(0, 0, 0, 0);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      qv[2 * e] = f.x * p.scale;
      qv[2 * e + 1] = f.y * p.scale;
    }
  }
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, qi + p.Sk - p.Sq + 1);

  float m = kNegInf, l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  // Warp-uniform trip count: the shuffles below need every lane.
  for (int base = warp * kKeysPerWarp; base < k_end; base += kGroups) {
    const int kj = base + slot;
    const bool live = kj < k_end;
    uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
    if (live && active) {
      kr = *reinterpret_cast<const uint4*>(k + kj * p.k_ss + d0);
      vr = *reinterpret_cast<const uint4*>(v + kj * p.v_ss + d0);
    }
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kr);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(k2[e]);
      dot = fmaf(qv[2 * e], f.x, dot);
      dot = fmaf(qv[2 * e + 1], f.y, dot);
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (live) {
      const float sc = bias ? dot + bias[kj * p.b_sk] : dot;
      const float m_new = fmaxf(m, sc);
      const float alpha = __expf(m - m_new);
      const float pr = __expf(sc - m_new);
      const float pv = round_p<__nv_bfloat16>(pr);  // P rounded before PV
      l = l * alpha + pr;
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vr);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        acc[2 * e] = fmaf(pv, f.x, acc[2 * e] * alpha);
        acc[2 * e + 1] = fmaf(pv, f.y, acc[2 * e + 1] * alpha);
      }
      m = m_new;
    }
  }
  // Merge the lane groups of this warp (same columns, other keys).
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
    const float m_new = fmaxf(m, m_o);
    const float a = __expf(m - m_new), c = __expf(m_o - m_new);
    l = l * a + l_o * c;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], o) * c;
    m = m_new;
  }
  if (lane < LPK) {
    if (lane == 0) {
      red_m[warp] = m;
      red_l[warp] = l;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red_acc[warp][d0 + e] = acc[e];
  }
  __syncthreads();
  // Merge the warps: thread t owns output column t.
  if (tid < p.D) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, red_m[w]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = __expf(red_m[w] - mm);
      ll += red_l[w] * c;
      oo += red_acc[w][tid] * c;
    }
    const long long row = ((long long)b * p.H + h) * p.Sq + qi;
    static_cast<__nv_bfloat16*>(p.out)[row * p.D + tid] =
        __float2bfloat16(oo / fmaxf(ll, 1e-30f));
    if (p.lse && tid == 0) p.lse[row] = ll > 0.f ? mm + logf(fmaxf(ll, 1e-37f)) : 1e30f;
  }
}

int launch_decode(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.Sq, p.H, p.B);
  const int lanes = p.D / 8;  // 2..16
  if (lanes <= 2) {
    flash_attn_fwd_decode_kernel<2><<<grid, kDecThreads, 0, stream>>>(p);
  } else if (lanes <= 4) {
    flash_attn_fwd_decode_kernel<4><<<grid, kDecThreads, 0, stream>>>(p);
  } else if (lanes <= 8) {
    flash_attn_fwd_decode_kernel<8><<<grid, kDecThreads, 0, stream>>>(p);
  } else {
    flash_attn_fwd_decode_kernel<16><<<grid, kDecThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

enum Variant { kSimt = 0, kTc = 1, kDecode = 2 };

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `variant` is the
// one the caller's rule picked (0 simt, 1 tc, 2 decode); the caller also
// checks shapes and, for tc and decode, that rows start on 16 bytes. Returns
// a cudaError_t (0 = launched); refuses head dims the kernels were not
// written for and a bf16 variant asked for another dtype or head dim.
int flash_attn_fwd(const void* q, const void* k, const void* v, const float* bias,
                   void* out, float* lse, int B, int H, int Sq, int Sk, int D,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   long long b_sb, long long b_sh, long long b_sq, long long b_sk,
                   float scale, int causal, int dtype, int variant, void* stream) {
  if (D < 16 || D > 32 * kMaxCols || D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (variant != kSimt && variant != kTc && variant != kDecode) return (int)cudaErrorInvalidValue;
  if (variant != kSimt && (dtype != 1 || (variant == kTc && D != 64 && D != 128)))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, bias, out, lse, B, H, Sq, Sk, D,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           b_sb, b_sh, b_sq, b_sk, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (variant == kTc) {
    const TcParams tp{bias, out, lse, H, Sq, Sk, b_sb, b_sh, b_sq, b_sk, scale, causal};
    err = D == 64 ? launch_tc<64>(q, k, v, tp, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                  v_sh, v_ss, s)
                  : launch_tc<128>(q, k, v, tp, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                   v_sh, v_ss, s);
  } else if (variant == kDecode) {
    err = launch_decode(p, s);
  } else {
    const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
    const dim3 block(kWarps * 32);
    const size_t smem = sizeof(float) *
        (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kWarps * kBlockK);
    if (dtype == 0) {
      flash_attn_fwd_kernel<float><<<grid, block, smem, s>>>(p);
    } else {
      flash_attn_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(p);
    }
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // extern "C"
