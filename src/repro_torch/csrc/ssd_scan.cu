// Mamba-2 SSD intra-chunk pass, one block per (sequence*head, chunk), the
// f32 path of kernels/ssd_scan/kernel.py (bf16 B/C go to ssd_scan_tc.cu,
// or here with variant="simt"); B and C may come in group form, one row
// for every `rep` heads (head row bh reads row bh / rep):
//
//     L        = cumsum(loga)                             # [chunk]
//     y_intra  = ((C B^T) o exp(L_i - L_j) o causal) x    # [chunk, P]
//     S_chunk  = (B o exp(L_end - L))^T x                 # [N, P]
//     T_chunk  = exp(L_end)
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:51
// `ssd_chunk_scan` (pl.pallas_call at :67); on the JAX serving path its
// twin is the intra-chunk half of kernels/ssd_scan/ops.py:60
// `ssd_jnp_with_state`.  The plain version is
// src/repro_torch/kernels/ssd_scan/ref.py `ssd_chunk_scan_ref`.
//
// Bound on an H100: bytes and operations alike.  mamba2-780m prefill
// (B=4, S=512, 48 heads, BH=192, chunk=128, N=128, P=64, B and C bf16 and
// expanded to every head, the layout this kernel was first written for):
// x 25.2 MB + B 25.2 MB + C 25.2 MB + y 25.2 MB + s 25.2 MB = 126 MB, 37.7 us
// at 3.35 TB/s; C B^T over the causal pairs is 1.62 GFLOP on bf16 inputs
// (1.6 us at 989 TFLOP/s) and G x and (B o decay)^T x are 2.42 GFLOP of f32
// products (36.1 us at 67 TFLOP/s without tensor cores): 37.8 us.
//
// Design (simple and right first; no tensor cores, wgmma or TMA yet): the
// whole chunk's B, C (as f32, rows padded to N+1 floats: no bank
// conflicts) and x sit in shared memory (199 KB at chunk=128, N=128, P=64:
// dynamic shared memory).  One thread takes the cumulative sum in order.
// Each product is register-tiled (a thread keeps a 4x8, 8x4 or 4x4 block
// of outputs, so a shared-memory read feeds several fmaf): S from B o decay
// and x; then the gated score matrix G = (C B^T) o exp(L_i - L_j), 64 rows
// at a time, multiplied into x straight away.  G[i][j] for j > i is
// exactly 0 (exp(-1e30) in the TPU kernel), so column tiles wholly above
// the diagonal are skipped.  Every product is computed here, none by a
// library.  Arithmetic is f32 with expf (no fast math); the products use
// explicit fmaf.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int NT = 256;
constexpr int CHUNK_MAX = 128;
constexpr int RB = 64;              // rows of G at a time (kernel.py ROW_BLOCK)

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

size_t smem_bytes(int chunk, int n, int p) {
    return sizeof(float) * (size_t)(2 * chunk + 2 * chunk * (n + 1) + chunk * p +
                                    RB * (chunk + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_kernel(
        const float* __restrict__ x, const float* __restrict__ loga,
        const T* __restrict__ Bm, const T* __restrict__ Cm,
        float* __restrict__ y, float* __restrict__ s, float* __restrict__ t,
        int L, int P, int N, int chunk, int rep) {
    extern __shared__ float smem[];
    const int nb = N + 1, gb = chunk + 1;
    float* Ls = smem;                   // [chunk] cumulative log-decay
    float* dec = Ls + chunk;            // [chunk] exp(L_end - L_j)
    float* Bs = dec + chunk;            // [chunk][N + 1]
    float* Cs = Bs + chunk * nb;        // [chunk][N + 1]
    float* xs = Cs + chunk * nb;        // [chunk][P]
    float* Gs = xs + chunk * P;         // [RB][chunk + 1]

    const int nc = L / chunk;
    const int bh = (int)(blockIdx.x / nc), c = (int)(blockIdx.x % nc);
    const size_t row0 = (size_t)bh * L + (size_t)c * chunk;   // first row of the chunk
    const size_t grow0 = (size_t)(bh / rep) * L + (size_t)c * chunk;   // of B and C
    const int tid = threadIdx.x;

    for (int e = tid; e < chunk * N; e += NT) {
        const int r = e / N, n = e % N;
        Bs[r * nb + n] = ld_f(Bm + (grow0 + r) * N + n);
        Cs[r * nb + n] = ld_f(Cm + (grow0 + r) * N + n);
    }
    for (int e = tid; e < chunk * P; e += NT) xs[e] = x[row0 * P + e];
    if (tid == 0) {
        float acc = 0.f;
        for (int r = 0; r < chunk; ++r) {
            acc += loga[row0 + r];
            Ls[r] = acc;
        }
    }
    __syncthreads();
    const float l_end = Ls[chunk - 1];
    for (int r = tid; r < chunk; r += NT) dec[r] = expf(l_end - Ls[r]);
    if (tid == 0) t[(size_t)bh * nc + c] = expf(l_end);
    __syncthreads();

    // S[n][p] = sum_j (B[j][n] * dec[j]) * x[j][p]: 128 x 64 output tiles,
    // 4 x 8 a thread (n = tn + 32a, p = tp + 8b)
    float* sc = s + ((size_t)bh * nc + c) * (size_t)N * P;
    {
        const int tn = tid >> 3, tp = tid & 7;
        for (int n0 = 0; n0 < N; n0 += 128) {
            for (int p0 = 0; p0 < P; p0 += 64) {
                float acc[4][8];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
                for (int j = 0; j < chunk; ++j) {
                    float bv[4], xv[8];
#pragma unroll
                    for (int a = 0; a < 4; ++a) {
                        const int n = n0 + tn + 32 * a;
                        bv[a] = n < N ? Bs[j * nb + n] * dec[j] : 0.f;
                    }
#pragma unroll
                    for (int b = 0; b < 8; ++b) {
                        const int p = p0 + tp + 8 * b;
                        xv[b] = p < P ? xs[j * P + p] : 0.f;
                    }
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(bv[a], xv[b], acc[a][b]);
                }
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 8; ++b) {
                        const int n = n0 + tn + 32 * a, p = p0 + tp + 8 * b;
                        if (n < N && p < P) sc[(size_t)n * P + p] = acc[a][b];
                    }
            }
        }
    }

    // y = G x, G built RB rows at a time; G[i][j] for j > i is exactly 0
    // (exp(-1e30) in the TPU kernel), so those products are skipped
    for (int i0 = 0; i0 < chunk; i0 += RB) {
        const int i_last = min(i0 + RB, chunk) - 1;
        {   // G rows i = i0 + ti + 8a (a < 8), columns j = tj + 32b (b < 4)
            const int ti = tid >> 5, tj = tid & 31;
            float acc[8][4];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
            for (int n = 0; n < N; ++n) {
                float cv[8], bv[4];
#pragma unroll
                for (int a = 0; a < 8; ++a) {
                    const int i = min(i0 + ti + 8 * a, chunk - 1);
                    cv[a] = Cs[i * nb + n];
                }
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const int j = min(tj + 32 * b, chunk - 1);
                    bv[b] = Bs[j * nb + n];
                }
#pragma unroll
                for (int a = 0; a < 8; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b)
                        if (32 * b <= i_last) acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
            }
#pragma unroll
            for (int a = 0; a < 8; ++a) {
                const int i = i0 + ti + 8 * a;
                if (i > i_last) continue;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const int j = tj + 32 * b;
                    if (j < chunk)
                        Gs[(i - i0) * gb + j] = j <= i ? acc[a][b] * expf(Ls[i] - Ls[j]) : 0.f;
                }
            }
        }
        __syncthreads();
        {   // y rows i = i0 + ti + 16a (a < 4), columns p = p0 + tp + 16b (b < 4)
            const int ti = tid >> 4, tp = tid & 15;
            for (int p0 = 0; p0 < P; p0 += 64) {
                float acc[4][4];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
                for (int j = 0; j <= i_last; ++j) {
                    float gv[4], xv[4];
#pragma unroll
                    for (int a = 0; a < 4; ++a)
                        gv[a] = Gs[min(ti + 16 * a, RB - 1) * gb + j];
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int p = p0 + tp + 16 * b;
                        xv[b] = p < P ? xs[j * P + p] : 0.f;
                    }
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(gv[a], xv[b], acc[a][b]);
                }
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const int i = i0 + ti + 16 * a;
                    if (i > i_last) continue;
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int p = p0 + tp + 16 * b;
                        if (p < P) y[(row0 + i) * P + p] = acc[a][b];
                    }
                }
            }
        }
        __syncthreads();            // Gs is rewritten by the next row block
    }
}

template <typename T>
int launch(const float* x, const float* loga, const void* B, const void* C,
           float* y, float* s, float* t, int bh, int rep, int L, int P, int N, int chunk,
           cudaStream_t stream) {
    const size_t smem = smem_bytes(chunk, N, P);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)bh * (L / chunk);
    if (blocks > 0)
        ssd_chunk_kernel<T><<<(unsigned)blocks, NT, smem, stream>>>(
            x, loga, static_cast<const T*>(B), static_cast<const T*>(C), y, s, t,
            L, P, N, chunk, rep);
    return (int)cudaGetLastError();
}

}  // namespace

// B/C [bg, L, N], bh % bg == 0.
REPRO_EXPORT int repro_ssd_chunk_scan(const float* x, const float* loga, const void* B,
                                      const void* C, float* y, float* s, float* t,
                                      int bh, int bg, int L, int P, int N, int chunk,
                                      int bc_dtype, void* stream) {
    if (chunk < 1 || chunk > CHUNK_MAX || L % chunk || bg < 1 || bh % bg)
        return (int)cudaErrorInvalidValue;
    const int rep = bh / bg;
    return bc_dtype == 1
        ? launch<__nv_bfloat16>(x, loga, B, C, y, s, t, bh, rep, L, P, N, chunk,
                                (cudaStream_t)stream)
        : launch<float>(x, loga, B, C, y, s, t, bh, rep, L, P, N, chunk,
                        (cudaStream_t)stream);
}
