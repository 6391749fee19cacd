// Blocked online-softmax attention (causal and sliding-window), with the
// ends of q and k aligned, GQA read in place.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:65
// `flash_attention` (pl.pallas_call at :82); on the JAX serving path its
// jnp twin is models/attention.py:31 `blocked_attention`.  The plain
// version is src/repro_torch/kernels/flash_attn/ref.py
// `flash_attention_ref`, which visits the same tiles.
//
// Bound on an H100: bytes.  qwen3-0.6b prefill (B=4, S=512, Hq=16, Hkv=8,
// D=128, bf16): q 8.4 MB + k 4.2 MB + v 4.2 MB + o 8.4 MB = 25.2 MB, 7.5 us
// at 3.35 TB/s; the causal products are 4.3 GFLOP, 4.3 us at 989 TFLOP/s.
//
// Design (simple and right first; no wgmma or TMA yet): one block of 256
// threads per (batch*head, 64-row q tile), the heaviest causal tiles
// first.  The q tile (pre-scaled) and each 64-row k and v tile sit in
// shared memory as f32 (rows padded to D+1 floats: no bank conflicts);
// each thread owns a 4x4 block of scores and a 4x(D/16) block of the f32
// accumulator, with the running max and sum reduced over the 16 threads
// of a row by warp shuffles.  Query head h reads kv head h / (Hq / Hkv)
// (no materialized repeat).  V and O have their own head dim Dv <= D (MLA:
// q/k 96, v 64): V is loaded and O stored for columns < Dv only, the
// columns Dv..D of the V tile are zeros.  Ragged Sq and Sk are masked in the kernel:
// out-of-range keys weigh exactly 0.  Masked scores are -1e30 as in the
// TPU kernel; tiles that are masked for every row are skipped only when
// every row of the tile has an unmasked key, which changes no bit of the
// function (see ref.py `key_tiles`).  Arithmetic is f32 with expf
// (no fast math); the products use explicit fmaf.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math_constants.h>

// Mirror of kernel.py `_Args`, passed by value.
struct FlashArgs {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
    int b, hq, hkv, sq, sk, d, dv, causal, window, dtype;
    float scale;
};

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int DMAX = 128;
constexpr int NT = 256;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int key_lo(const FlashArgs& a, int p) {
    return a.window > 0 ? max(0, p - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const FlashArgs& a, int p) {
    return a.causal ? min(p, a.sk - 1) : a.sk - 1;
}

size_t smem_bytes(int d) {
    const int ld = d + 1;
    return sizeof(float) * (size_t)(BQ * ld + 2 * BK * ld + BQ * (BK + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_attn_kernel(FlashArgs a) {
    extern __shared__ float smem[];
    const int D = a.d, ld = D + 1;
    float* Qs = smem;               // [BQ][ld]
    float* Ks = Qs + BQ * ld;       // [BK][ld]
    float* Vs = Ks + BK * ld;       // [BK][ld]
    float* Ps = Vs + BK * ld;       // [BQ][BK + 1]

    const int nqt = (a.sq + BQ - 1) / BQ;
    const int qt = nqt - 1 - (int)(blockIdx.x % nqt);   // heaviest tiles first
    const int bh = (int)(blockIdx.x / nqt);
    const int bi = bh / a.hq, h = bh % a.hq, hk = h / (a.hq / a.hkv);
    const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + h * a.q_sh;
    const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + hk * a.k_sh;
    const T* v = static_cast<const T*>(a.v) + bi * a.v_sb + hk * a.v_sh;
    T* o = static_cast<T*>(a.o) + bi * a.o_sb + h * a.o_sh;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = qt * BQ;
    const int rows = min(BQ, a.sq - q0);
    const int qbase = a.sk - a.sq;

    for (int e = tid; e < BQ * D; e += NT) {
        const int r = e / D, c = e % D;
        Qs[r * ld + c] = r < rows ? to_f(q[(q0 + r) * a.q_ss + c]) * a.scale : 0.f;
    }

    // key tiles to visit (ref.py key_tiles)
    int t_begin = 0, t_end = (a.sk + BK - 1) / BK;
    const int p_lo = qbase + q0, p_hi = qbase + q0 + rows - 1;
    if (a.sk > 0 && key_lo(a, p_lo) <= key_hi(a, p_lo) &&
        key_lo(a, p_hi) <= key_hi(a, p_hi)) {
        t_begin = key_lo(a, p_lo) / BK;
        t_end = key_hi(a, p_hi) / BK + 1;
    }

    float m[4], l[4], acc[4][DMAX / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_BIG;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.f;
    }

    for (int t = t_begin; t < t_end; ++t) {
        const int k0 = t * BK;
        const int nk = min(BK, a.sk - k0);
        __syncthreads();            // the previous tile's K, V and P are done
        for (int e = tid; e < BK * D; e += NT) {
            const int r = e / D, c = e % D;
            Ks[r * ld + c] = r < nk ? to_f(k[(k0 + r) * a.k_ss + c]) : 0.f;
            Vs[r * ld + c] = r < nk && c < a.dv ? to_f(v[(k0 + r) * a.v_ss + c]) : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int c = 0; c < D; ++c) {
            float qa[4], kb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * ld + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            const int qpos = qbase + q0 + r;
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kk = tx + 16 * j, kpos = k0 + kk;
                bool ok = true;
                if (a.causal) ok = ok && kpos <= qpos;
                if (a.window > 0) ok = ok && kpos > qpos - a.window;
                s[i][j] = kk >= nk ? -CUDART_INF_F : (ok ? s[i][j] : NEG_BIG);
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                Ps[r * (BK + 1) + tx + 16 * j] = p;
                ps += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l[i] = alpha * l[i] + ps;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DMAX / 16; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();            // P complete

        for (int c = 0; c < nk; ++c) {
            float pa[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
            for (int j = 0; j < DMAX / 16; ++j) {
                const int dd = tx + 16 * j;
                if (dd < a.dv) {
                    const float vb = Vs[c * ld + dd];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < DMAX / 16; ++j) {
            const int dd = tx + 16 * j;
            if (dd < a.dv) o[(q0 + r) * a.o_ss + dd] = from_f<T>(acc[i][j] / den);
        }
    }
}

template <typename T>
int launch(const FlashArgs& a, cudaStream_t stream) {
    const size_t smem = smem_bytes(a.d);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)a.b * a.hq * ((a.sq + BQ - 1) / BQ);
    if (blocks > 0) flash_attn_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int repro_flash_attention(FlashArgs a, void* stream) {
    if (a.d < 1 || a.d > DMAX || a.dv < 1 || a.dv > a.d || a.hkv < 1 || a.hq % a.hkv)
        return (int)cudaErrorInvalidValue;
    return a.dtype == 1 ? launch<__nv_bfloat16>(a, (cudaStream_t)stream)
                        : launch<float>(a, (cudaStream_t)stream);
}
