// Flash-attention forward for Hopper (sm_90a): O = softmax(scale*Q K^T + bias, causal) V.
//
// Replaces: deeplearning_cfn_tpu/ops/attention.py `_flash_kernel` (the Pallas TPU
// online-softmax kernel launched by `_flash_forward`). Same function, same
// conventions: q is scaled before the QK^T dot, bias masking uses -1e30 (a row
// whose every key is masked comes out as a uniform softmax, never NaN), the
// causal diagonal aligns the ends of the true Sq and Sk, P is rounded to V's
// dtype before the PV product, and the optional lse is m + log(l) per row (+1e30
// for a row that saw no key). One corner differs from the plain version: keys
// above the causal diagonal do not exist for the kernel (their tiles are
// skipped), so a causal row whose every visible key the bias also masks spreads
// its uniform weight over the visible keys only, where the plain version
// spreads it over all Sk. The serving path never combines causal with a bias.
//
// Design (a first, simple, correct kernel; CUDA-core FMAs, no tensor cores):
//   - one thread block of 4 warps per (q-tile of 16 rows, head, batch);
//   - a loop over K/V tiles of 32 keys staged in shared memory as f32 (K rows
//     padded to D+1 floats so the per-lane key reads are bank-conflict free);
//   - each warp owns 4 query rows; lane j scores key j of the tile, the warp
//     reduces max and sum with shuffles, and lane d accumulates output column
//     d (d, d+32, d+64, d+96) of the PV product; m, l and acc stay in f32
//     registers across the whole K/V loop;
//   - the bias is read through element strides (stride 0 on broadcast dims), so
//     a [B,1,1,Sk] padding bias is never materialised at [B,H,Sq,Sk];
//   - ragged Sq and Sk are masked in the kernel (no padding to a tile multiple);
//     causal tiles wholly above the diagonal are skipped.
//   - q, k and v are read through their batch/head/sequence strides (the head
//     dim must have unit stride), so the model's [B,S,H,D] -> [B,H,S,D] views
//     need no copy.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the serving
// decode shapes (Sq = 1, Sk = 128, D = 64) the work is ~2*Sk*D FLOPs per row
// against 2*Sk*D*2 bytes of K and V, about 0.5 FLOP/byte, so the bound is the
// bytes of K, V and bias. At the encoder shape (Sq = Sk = 128) it is ~64
// FLOP/byte, still below the ~295 FLOP/byte ridge, so bytes bound it too.
// What this design does about that bound: each K/V element is read from device
// memory once per q-tile (Sq = 1 means once), the [Sq,Sk] score matrix never
// leaves registers/shared memory, and the bias is read at its broadcast size.
// What it does not do: it uses CUDA cores, not wgmma; it stages tiles with
// plain loads, not TMA/cp.async double buffering; a decode call launches only
// B*H blocks with one busy warp each, so it is latency/launch bound far above
// the byte bound. Those are the later PRs' work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t (0 = launched). The caller checks shapes; this only refuses head
// dims the kernel was not written for.
int flash_attn_fwd(const void* q, const void* k, const void* v, const float* bias,
                   void* out, float* lse, int B, int H, int Sq, int Sk, int D,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   long long b_sb, long long b_sh, long long b_sq, long long b_sk,
                   float scale, int causal, int dtype, void* stream) {
  if (D < 16 || D > 32 * kMaxCols || D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, bias, out, lse, B, H, Sq, Sk, D,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           b_sb, b_sh, b_sq, b_sk, scale, causal};
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  const dim3 block(kWarps * 32);
  const size_t smem = sizeof(float) *
      (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kWarps * kBlockK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_attn_fwd_kernel<float><<<grid, block, smem, s>>>(p);
  } else if (dtype == 1) {
    flash_attn_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
