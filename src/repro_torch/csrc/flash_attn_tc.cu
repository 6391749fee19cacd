// Blocked online-softmax attention (causal and sliding-window) in bf16 on
// the H100's tensor cores, with the ends of q and k aligned, GQA read in
// place.  The bf16 path of kernels/flash_attn/kernel.py; f32 stays on the
// SIMT kernel of flash_attn.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:65
// `flash_attention` (pl.pallas_call at :82).  The plain version is
// src/repro_torch/kernels/flash_attn/ref.py `flash_attention_ref`, which
// visits the same 64-row query and key tiles (`key_tiles`).
//
// Bound on an H100: bytes.  qwen3-0.6b prefill (B=4, S=512, Hq=16, Hkv=8,
// D=128, bf16): q 8.4 MB + k 4.2 MB + v 4.2 MB + o 8.4 MB = 25.2 MB, 7.51 us
// at 3.35 TB/s; the causal products are 4.30 GFLOP, 4.35 us at 989 TFLOP/s.
//
// Design.  One CTA of 4 warps for each (batch*head, 64-row q tile), the
// heaviest causal tiles first; each warp owns 16 query rows.  What it does
// about the four faults of the SIMT kernel:
// - f32 FMA on the CUDA cores: both products run on the tensor cores,
//   mma.sync.m16n8k16 with bf16 operands and f32 sums.  Q's fragments are
//   read once with ldmatrix and kept in registers; K is read with
//   ldmatrix, V with ldmatrix.trans.
// - bf16 tiles widened to f32 in shared memory: tiles stay bf16, rows
//   padded by 16 bytes so that every ldmatrix phase hits 32 distinct banks
//   (row pitch 272 B / 144 B = 4 banks apart).  Q plus two stages of K and
//   V is 85 KB at DPAD = 128: two CTAs an SM.
// - P through shared memory: the m16n8 C fragments of S are the A
//   fragments of P·V, so P is packed to bf16 in registers and never stored.
// - synchronous loads: cp.async.cg in 16-byte chunks, K and V double
//   buffered, so the next key tile loads while this one is computed.
//   Ragged rows and keys, and columns D..DPAD, are zero-filled by the
//   src-size-0 form of cp.async.
// V and O may have a head dim Dv <= D of their own (MLA: q/k 96, v 64;
// a multiple of 8): V is loaded and O stored for columns < Dv only; the
// V tile's columns Dv..DPAD are zero-filled, so P·V over DPAD columns
// gives zeros there and nothing else changes.
// Numerics: S is summed in f32 and scaled in f32 by D^-0.5 * log2(e)
// (Q is not pre-scaled, so it is rounded only once, as given); the
// softmax runs in the log2 domain with exp2f.  A masked score is -1e30
// (causal, window), set after the scale so it stays finite; a key >= Sk is
// -inf (weight exactly 0); a row with no unmasked key averages every value,
// as in the plain version.  P is rounded to bf16 before P·V (the one
// difference from the plain version besides the order of the sums); the
// row sums l are taken in f32 from the unrounded P.  O stays f32 in
// registers and is divided by max(l, 1e-30) and rounded once to bf16.
//
// bf16 scores (the template's BF16S, repro_flash_attention_tc_bf16s): the
// variant of the plain version's score_dtype=bf16 (cfg.attn_bf16, the JAX
// package's blocked_attention(score_dtype=bf16)).  Each score is scaled
// in the natural domain (S * D^-0.5), masked (-1e30), rounded to bf16,
// and only then moved to the log2 domain (* log2(e)), so the running max
// is taken from the rounded scores; each probability is rounded to bf16
// before it enters both the row sum and P·V.  The running max starts at
// -1e30 in the natural domain, as there: a row with no unmasked key then
// ends at 0 (bf16(-1e30) lies below -1e30), as in the plain version.
#include "common.cuh"
#include "tc.cuh"

#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

// Mirror of kernel.py `_Args`, passed by value (the same struct as
// flash_attn.cu's: one argument layout for both kernels).
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

using namespace tc;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NW = 4;                // warps a CTA, 16 query rows each
constexpr int NT = 32 * NW;
constexpr int PAD = 8;               // bf16 elements (16 bytes) added to a row
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DPAD>
constexpr size_t smem_bytes() {      // Q, K[2], V[2]
    return 5 * (size_t)BQ * (DPAD + PAD) * sizeof(bf16);
}

__device__ __forceinline__ int key_lo(const FlashArgs& a, int p) {
    return a.window > 0 ? max(0, p - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const FlashArgs& a, int p) {
    return a.causal ? min(p, a.sk - 1) : a.sk - 1;
}

// Issue the cp.async copies of one 64-row tile into shared address `dst`:
// each thread copies one 16-byte column chunk of every (NT / CH)-th row.
// Rows >= nrows and columns >= d (a multiple of 8) are zero-filled.
template <int DPAD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long ss,
                                          int nrows, int d, int tid) {
    constexpr int CH = DPAD / 8, LD = DPAD + PAD, RS = NT / CH;
    const int c = tid % CH, r0 = tid / CH;
    const bool col_ok = c * 8 < d;
    const bf16* p = src + r0 * ss + c * 8;
    dst += (uint32_t)(r0 * LD + c * 8) * sizeof(bf16);
#pragma unroll
    for (int i = 0; i < BQ / RS; ++i) {
        const bool ok = col_ok && r0 + i * RS < nrows;
        cp_async16(dst + i * RS * LD * sizeof(bf16), ok ? p + i * RS * ss : src, ok);
    }
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <int DPAD, bool BF16S>
__global__ void __launch_bounds__(NT, 2) flash_attn_tc_kernel(FlashArgs a) {
    constexpr int LD = DPAD + PAD, TILE = BQ * LD;
    constexpr int KS = DPAD / 16;    // k-steps of Q K^T
    constexpr int NN = BK / 8;       // 8-key column tiles of S
    constexpr int ND = DPAD / 8;     // 8-wide column tiles of O
    constexpr int CH = DPAD / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr uint32_t TB = TILE * sizeof(bf16);     // bytes a tile
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    const uint32_t q_s = smem_u32(Qs);
    const uint32_t k_s = q_s + TB;       // two stages
    const uint32_t v_s = k_s + 2 * TB;   // two stages

    const int bhn = a.b * a.hq;
    const int nqt = (a.sq + BQ - 1) / BQ;
    const int qt = nqt - 1 - (int)(blockIdx.x / bhn);   // heaviest causal tiles first
    const int bh = (int)(blockIdx.x % bhn);
    const int bi = bh / a.hq, h = bh % a.hq, hk = h / (a.hq / a.hkv);
    const bf16* q = static_cast<const bf16*>(a.q) + bi * a.q_sb + h * a.q_sh;
    const bf16* k = static_cast<const bf16*>(a.k) + bi * a.k_sb + hk * a.k_sh;
    const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_sb + hk * a.v_sh;
    bf16* o = static_cast<bf16*>(a.o) + bi * a.o_sb + h * a.o_sh;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;      // the mma fragment's row and column pair
    const int mi = lane >> 3, mr = lane & 7;     // ldmatrix.x4: which matrix, which row
    const int q0 = qt * BQ;
    const int rows = min(BQ, a.sq - q0);
    const int qbase = a.sk - a.sq;

    // key tiles to visit (ref.py key_tiles)
    int t_begin = 0, t_end = (a.sk + BK - 1) / BK;
    const int p_lo = qbase + q0, p_hi = qbase + q0 + rows - 1;
    if (a.sk > 0 && key_lo(a, p_lo) <= key_hi(a, p_lo) &&
        key_lo(a, p_hi) <= key_hi(a, p_hi)) {
        t_begin = key_lo(a, p_lo) / BK;
        t_end = key_hi(a, p_hi) / BK + 1;
    }

    load_tile<DPAD>(q_s, q + q0 * a.q_ss, a.q_ss, rows, a.d, tid);
    if (t_begin < t_end) {
        const int k0 = t_begin * BK, nk = min(BK, a.sk - k0);
        load_tile<DPAD>(k_s, k + k0 * a.k_ss, a.k_ss, nk, a.d, tid);
        load_tile<DPAD>(v_s, v + k0 * a.v_ss, a.v_ss, nk, a.dv, tid);
    }
    cp_async_commit();

    const float sl2 = a.scale * LOG2E;
    // BF16S: a masked score, rounded, in the log2 domain; the running max's start
    const float neg_s = BF16S ? round_bf16(NEG_BIG) * LOG2E : NEG_BIG;
    const float m_start = BF16S ? NEG_BIG * LOG2E : NEG_BIG;
    const int r0 = warp * 16 + g;                // this thread's rows: r0 and r0 + 8
    const int qp0 = qbase + q0 + r0, qp1 = qp0 + 8;
    // each lane's ldmatrix row address (bytes), before the tile's offsets
    const uint32_t q_lane = q_s + ((warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8) * 2;
    const uint32_t k_lane = k_s + (((mi >> 1) * 8 + mr) * LD + (mi & 1) * 8) * 2;
    const uint32_t v_lane = v_s + (((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8) * 2;
    uint32_t qf[KS][4];
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m0 = m_start, m1 = m_start, l0 = 0.f, l1 = 0.f;   // l: this thread's share

    for (int t = t_begin; t < t_end; ++t) {
        const uint32_t st = ((t - t_begin) & 1) * TB;   // this stage's offset
        if (t + 1 < t_end) {         // the next tile loads while this one is computed
            const int k1 = (t + 1) * BK, n1 = min(BK, a.sk - k1);
            load_tile<DPAD>(k_s + (TB - st), k + k1 * a.k_ss, a.k_ss, n1, a.d, tid);
            load_tile<DPAD>(v_s + (TB - st), v + k1 * a.v_ss, a.v_ss, n1, a.dv, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (t == t_begin) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
                ldmatrix_x4(qf[ks], q_lane + ks * 32);
        }

        // S = Q K^T, 16 x 64 a warp
        float s[NN][4];
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int np = 0; np < NN / 2; ++np) {
                uint32_t b[4];
                ldmatrix_x4(b, k_lane + st + np * 16 * LD * 2 + ks * 32);
                mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
                mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
            }
        }

        // scale, mask, online softmax (rows r0 and r0 + 8; a quad shares a row)
        const int k0 = t * BK, nk = min(BK, a.sk - k0);
        // a tile whose every key every row of the q tile sees needs no mask
        const bool open = nk == BK && (!a.causal || k0 + BK - 1 <= qbase + q0) &&
                          (a.window <= 0 || k0 > qbase + q0 + BQ - 1 - a.window);
        if (open) {
#pragma unroll
            for (int n = 0; n < NN; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[n][e] = BF16S ? round_bf16(s[n][e] * a.scale) * LOG2E : s[n][e] * sl2;
        } else {
            auto score = [&](float x, int kk, int qp) {
                if (kk >= nk) return -CUDART_INF_F;
                const int kp = k0 + kk;
                bool ok = true;
                if (a.causal) ok = kp <= qp;
                if (a.window > 0) ok = ok && kp > qp - a.window;
                if (!BF16S) return ok ? x * sl2 : NEG_BIG;
                return ok ? round_bf16(x * a.scale) * LOG2E : neg_s;
            };
#pragma unroll
            for (int n = 0; n < NN; ++n) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kk = n * 8 + 2 * t4 + e;
                    s[n][e] = score(s[n][e], kk, qp0);
                    s[n][2 + e] = score(s[n][2 + e], kk, qp1);
                }
            }
        }
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
            mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
            mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= al0;
        l1 *= al1;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            acc[n][0] *= al0;
            acc[n][1] *= al0;
            acc[n][2] *= al1;
            acc[n][3] *= al1;
        }
        // P as the A fragments of P V: key step j takes S tiles 2j and 2j + 1
        uint32_t pf[NN / 2][4];
#pragma unroll
        for (int n = 0; n < NN; ++n) {
            float p0 = exp2f(s[n][0] - mn0), p1 = exp2f(s[n][1] - mn0);
            float p2 = exp2f(s[n][2] - mn1), p3 = exp2f(s[n][3] - mn1);
            if (BF16S) {
                p0 = round_bf16(p0);
                p1 = round_bf16(p1);
                p2 = round_bf16(p2);
                p3 = round_bf16(p3);
            }
            l0 += p0 + p1;
            l1 += p2 + p3;
            pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
            pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
        }

        // O += P V
#pragma unroll
        for (int j = 0; j < NN / 2; ++j) {
#pragma unroll
            for (int dp = 0; dp < ND / 2; ++dp) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, v_lane + st + j * 16 * LD * 2 + dp * 32);
                mma_bf16(acc[2 * dp], pf[j], b[0], b[1]);
                mma_bf16(acc[2 * dp + 1], pf[j], b[2], b[3]);
            }
        }
        __syncthreads();             // this stage is free for the load after next
    }
    cp_async_wait<0>();              // no tile visited: the Q copies may be in flight
    __syncthreads();

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    // O through the warp's own Q rows in shared memory, then 16-byte stores
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(Qs + r0 * LD + c) =
            __floats2bfloat162_rn(acc[n][0] / den0, acc[n][1] / den0);
        *reinterpret_cast<__nv_bfloat162*>(Qs + (r0 + 8) * LD + c) =
            __floats2bfloat162_rn(acc[n][2] / den1, acc[n][3] / den1);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * CH / 32; ++i) {
        const int e = lane + 32 * i, r = warp * 16 + e / CH, c = e % CH;
        if (r < rows && c * 8 < a.dv)
            *reinterpret_cast<uint4*>(o + (q0 + r) * a.o_ss + c * 8) =
                *reinterpret_cast<const uint4*>(Qs + r * LD + c * 8);
    }
}

template <int DPAD, bool BF16S>
int launch(const FlashArgs& a, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<DPAD>();
    cudaError_t err = cudaFuncSetAttribute(flash_attn_tc_kernel<DPAD, BF16S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)a.b * a.hq * ((a.sq + BQ - 1) / BQ);
    if (blocks > 0)
        flash_attn_tc_kernel<DPAD, BF16S><<<(unsigned)blocks, NT, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool BF16S>
int launch_tc(const FlashArgs& a, void* stream) {
    if (a.dtype != 1 || a.d < 8 || a.d > 128 || a.d % 8 || a.dv < 8 || a.dv > a.d ||
        a.dv % 8 || a.hkv < 1 || a.hq % a.hkv)
        return (int)cudaErrorInvalidValue;
    return a.d <= 64 ? launch<64, BF16S>(a, (cudaStream_t)stream)
                     : launch<128, BF16S>(a, (cudaStream_t)stream);
}

}  // namespace

// bf16 only; D a multiple of 8 up to 128, Dv a multiple of 8 up to D;
// every row 16-byte aligned (the wrapper checks the pointers and strides).
REPRO_EXPORT int repro_flash_attention_tc(FlashArgs a, void* stream) {
    return launch_tc<false>(a, stream);
}

// The same with bf16 scores and probabilities (BF16S above).
REPRO_EXPORT int repro_flash_attention_tc_bf16s(FlashArgs a, void* stream) {
    return launch_tc<true>(a, stream);
}
