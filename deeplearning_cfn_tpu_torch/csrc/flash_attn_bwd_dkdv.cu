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
//
// Design (a first, simple, correct kernel; CUDA-core FMAs, no tensor cores):
//   - one thread block of 8 warps per (KV tile of 32 keys, head, batch); the
//     loop over Q tiles of 32 rows runs inside the block (the TPU grid's
//     sequential "arbitrary" axis becomes this loop), so dK and dV stay in f32
//     registers for the whole loop and are written once. No atomics: every
//     output element has exactly one writer, so gradients are deterministic;
//   - K, V (once) and each Q, dO tile are staged in shared memory as f32, rows
//     padded to D+1 floats so per-lane row reads are bank-conflict free;
//   - phase 1 of a Q tile: lane j scores key j against 4 query rows of its warp
//     (two dot products: q.k and dO.v) and writes P and scale*dS to shared
//     memory; phase 2: each warp owns 4 keys, lane d owns head-dim columns
//     d, d+32, d+64, d+96, and accumulates dV += P^T dO and dK += dS^T Q;
//   - causal Q tiles that lie wholly above the diagonal for this KV tile are
//     skipped (the `(qi+1)*bq + (Sk-Sq) > ik*bk` rule of the Pallas kernel);
//   - q, k, v and dO are read through their batch/head/sequence strides (unit
//     stride on the head dim), so the model's transposed views need no copy.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the training
// shape (B=128, H=8, Sq=Sk=128, D=64, bf16, causal) the call must read q, k, v,
// dO, lse and delta and write dK and dV, ~101.7 MB, about 30 us; its ~4 GFLOP
// (halved by the causal skip) take ~4 us at the tensor-core rate, so bytes bound
// it. What the design does about it: each K/V element is read once per block
// and each Q/dO element once per KV tile; the [Sq,Sk] P and dS tiles never leave
// shared memory. What it does not do: it runs on CUDA cores, not wgmma, and
// stages tiles with plain loads, not TMA; so it is compute-latency bound far
// above the byte bound. Making it fast is a later PR's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dK, dV share it). Strides are
// in elements. Returns a cudaError_t (0 = launched). The caller checks shapes;
// this only refuses head dims the kernel was not written for.
int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv,
                        int B, int H, int Sq, int Sk, int D,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        float scale, int causal, int dtype, void* stream) {
  if (D < 16 || D > 32 * kMaxCols || D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
