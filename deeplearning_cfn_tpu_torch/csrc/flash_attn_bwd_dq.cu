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
// its P underflows to 0 and its dQ is exactly 0.
//
// Design (a first, simple, correct kernel; CUDA-core FMAs, no tensor cores):
//   - one thread block of 8 warps per (Q tile of 32 rows, head, batch); the loop
//     over KV tiles of 32 keys runs inside the block, so dQ stays in f32
//     registers and is written once. No atomics: deterministic gradients;
//   - Q and dO (once) and each K, V tile are staged in shared memory as f32,
//     rows padded to D+1 floats;
//   - phase 1 of a KV tile: lane j scores key j against 4 query rows of its
//     warp (q.k and dO.v) and writes scale*dS to shared memory; phase 2: each
//     warp owns 4 query rows, lane d owns head-dim columns d, d+32, d+64, d+96,
//     and accumulates dQ += dS K;
//   - causal KV tiles wholly above the diagonal for this Q tile are skipped;
//   - q, k, v and dO are read through their strides (unit stride on the head
//     dim).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the training
// shape (B=128, H=8, Sq=Sk=128, D=64, bf16, causal) the call must read q, k, v,
// dO, lse and delta and write dQ, ~84.9 MB, about 25 us; its ~3 GFLOP (halved by
// the causal skip) take ~3 us at the tensor-core rate, so bytes bound it. Like
// the dK/dV kernel it runs on CUDA cores with plain loads, far above that bound;
// wgmma and TMA are a later PR's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dQ share it). Strides are in
// elements. `variant` is 0: this file has one kernel, the CUDA-core one
// ("simt"), and takes the argument as the other entry points do. Returns a
// cudaError_t (0 = launched). The caller checks shapes; this only refuses
// head dims the kernel was not written for.
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
  if (variant != 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
