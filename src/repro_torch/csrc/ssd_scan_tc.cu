// Mamba-2 SSD intra-chunk pass on the H100's tensor cores, B and C read in
// group form (one row for every `rep` heads).  The bf16 path of
// kernels/ssd_scan/kernel.py; f32 B/C stay on the SIMT kernel of
// ssd_scan.cu.  Per (head row, chunk):
//
//     L        = cumsum(loga)                             # [chunk]
//     y_intra  = ((C B^T) o exp(L_i - L_j) o causal) x    # [chunk, P]
//     S_chunk  = (B o exp(L_end - L))^T x                 # [N, P]
//     T_chunk  = exp(L_end)
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:51
// `ssd_chunk_scan` (pl.pallas_call at :67).  The plain version is
// src/repro_torch/kernels/ssd_scan/ref.py `ssd_chunk_scan_ref`.
//
// Bound on an H100: bytes.  mamba2-780m prefill (B=4, S=512, 48 heads of
// one group, chunk 128, N=128, P=64): x, y, s 25.2 MB each, B and C 0.52 MB
// each, loga 0.39 MB: 76.9 MB, 23.0 us at 3.35 TB/s.  C B^T once a
// (group, chunk) over the causal pairs is 33.8 MFLOP of bf16; the two f32
// products (2.42 GFLOP) run as split TF32, three products each: 7.26 GFLOP,
// 14.7 us at 495 TFLOP/s.
//
// Design.  One CTA of 8 warps for each (group row, chunk, tile of `ht`
// heads of the group); the wrapper picks `ht` from the shape so that the
// busiest SM runs as few heads as it can.  What it does about the faults
// of the SIMT kernel (ssd_scan.cu):
// - C B^T repeated for every head: it does not depend on the head (only
//   the decay does), so a CTA computes it once, on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 sums; ldmatrix from rows padded by
//   16 bytes, as in flash_attn_tc.cu), over the causal 16x16 tiles only,
//   and keeps it in shared memory (f32, rows padded by 8 floats so the
//   float2 reads of an A fragment hit 32 banks) for every head.
// - B and C expanded to every head: they are read in group form, once a
//   (group, chunk, head tile), by 16-byte cp.async.
// - f32 FMA on the CUDA cores: both f32 products run on the tensor cores
//   in split TF32 (mma.sync m16n8k8): an operand v is hi + lo, each
//   rounded to tf32, and lo·hi + hi·lo + hi·hi is summed in f32, which
//   keeps ~21 bits of each product (plain TF32 keeps ~11 and would miss
//   the 2e-4 tolerance).  x is split once a head into shared memory in
//   fragment order (one 16-byte read a thread per k-step and n-tile); the
//   A operands are formed in registers: G = CB o exp(L_i - L_j) for y
//   (never stored; exactly 0 above the diagonal, as exp(-1e30) in the
//   reference; k-steps wholly above it are skipped), B o dec for S (B read
//   transposed by ldmatrix.trans).
// - one thread's sequential cumsum while 255 wait: warp 0 scans (shuffles)
//   the next head's loga while the other warps start this head's
//   products; x and loga of the next head arrive by cp.async meanwhile,
//   and head 0's while C B^T is computed.
// - scalar staging with a divide per element: 16-byte copies; B and C
//   stay bf16 in shared memory.
// A head's work is items 64 columns wide: 32 rows of S (an x fragment read
// from shared memory feeds two row tiles) and 16 rows of y (the causal
// triangle: the row tiles differ in length); warps take the next item
// from a shared counter, the longest first, so they finish together.
// Outputs are written from the mma C fragments (32-byte segments).
// exp(L_i - L_j) is taken from the difference, never as exp(L_i) exp(-L_j),
// which overflows over long chunks: exp2f(L2_i - L2_j) of L2 = L log2(e)
// rounded to f32 (one rounding more than the plain version's expf: a
// relative 2^-24 |L2| in the decay, below the cumsum's own).  dec and t
// take expf.  Arithmetic is f32 (no fast math).
#include "common.cuh"
#include "tc.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using namespace tc;
using bf16 = __nv_bfloat16;

constexpr int NW = 8;                // warps a CTA
constexpr int NT = 32 * NW;
constexpr int CHUNK_MAX = 128;
constexpr int BPAD = 8;              // bf16 elements (16 bytes) added to a B/C row
constexpr int RPAD = 4;              // floats added to a raw x row
constexpr int CBPAD = 8;             // floats added to a C B^T row
constexpr float LOG2E = 1.4426950408889634f;

// B [chunk][N + 8] bf16, CB [chunk][chunk + 8] f32, raw x [chunk][P + 4] f32,
// then x split (hi/lo, fragment order, 8 bytes an element) sharing its
// space with C [chunk][N + 8] bf16 (only the C B^T pass reads C), then
// loga [chunk], L and dec [2][chunk] (this head's and the next's) f32 and
// the work counter.
__host__ __device__ size_t x2_bytes(int chunk, int n, int p) {
    const size_t x2 = (size_t)chunk * p * 8, cs = (size_t)chunk * (n + BPAD) * sizeof(bf16);
    return x2 > cs ? x2 : cs;
}
size_t smem_bytes(int chunk, int n, int p) {
    return (size_t)chunk * (n + BPAD) * sizeof(bf16) +
           (size_t)chunk * (chunk + CBPAD) * sizeof(float) +
           (size_t)chunk * (p + RPAD) * sizeof(float) + x2_bytes(chunk, n, p) +
           5 * (size_t)chunk * sizeof(float) + 16;
}

// One head's products.  Every operand element is the sum hi + lo of two
// tf32 values; a k-step of 8 takes rows j = 8 kk + 2 t4 and j + 1 in its
// slots t4 and t4 + 4 (any order of k gives the same sum, and this one
// lets a float2 read C B^T and L, and ldmatrix.trans read B).  x is split
// once a head into x2: for k-step kk and n-tile n, lane l holds
// {hi x[j][p], hi x[j+1][p], lo x[j][p], lo x[j+1][p]}, p = 8 n + l / 4.
//
// acc[m][n] += A_m x for MT A fragments (16-row tiles) and NTI n-tiles
// from nb: lo·hi, then hi·lo, then hi·hi, each over every tile in turn, so
// no mma waits on the one before it.  Each x fragment read from shared
// memory feeds MT row tiles.  A ragged P repeats its last n-tile (not
// stored).
template <int MT, int NTI>
__device__ __forceinline__ void mma_split(float (&acc)[MT][NTI][4], const uint32_t (&ah)[MT][4],
                                          const uint32_t (&al)[MT][4], const uint4* xk, int nb,
                                          int NTN) {
    uint32_t bh[NTI][2], bl[NTI][2];
#pragma unroll
    for (int n = 0; n < NTI; ++n) {
        const uint4 v = xk[min(nb + n, NTN - 1) * 32];
        bh[n][0] = v.x;
        bh[n][1] = v.y;
        bl[n][0] = v.z;
        bl[n][1] = v.w;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTI; ++n) mma_tf32(acc[m][n], al[m], bh[n]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTI; ++n) mma_tf32(acc[m][n], ah[m], bl[n]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTI; ++n) mma_tf32(acc[m][n], ah[m], bh[n]);
}

template <int MT, int NTI>
__device__ __forceinline__ void zero(float (&acc)[MT][NTI][4]) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTI; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
}

// rows r0 and r0 + 8 of a C fragment tile, NTI n-tiles from nb, to out
// (row pitch P)
template <int NTI>
__device__ __forceinline__ void store(float* __restrict__ out, const float (&acc)[NTI][4],
                                      int r0, int nb, int NTN, int P, int t4) {
#pragma unroll
    for (int n = 0; n < NTI; ++n) {
        if (nb + n >= NTN) break;
        const int col = 8 * (nb + n) + 2 * t4;
        *reinterpret_cast<float2*>(out + (size_t)r0 * P + col) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * P + col) =
            make_float2(acc[n][2], acc[n][3]);
    }
}

// y rows 16 r .. 16 r + 15, NTI n-tiles from n-tile nb: A = G, formed in
// registers from C B^T and L2 = L log2(e) (exp(L_i - L_j) is
// exp2(L2_i - L2_j)), exactly 0 above the diagonal.
template <int NTI>
__device__ __forceinline__ void y_item(float* __restrict__ y, const float* CBs,
                                       const float* Ls, const uint4* x2, int r, int nb,
                                       int CBP, int NTN, int P, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
    const int i0 = 16 * r + g, i1 = i0 + 8;
    const float li0 = Ls[i0], li1 = Ls[i1];
    float acc[1][NTI][4];
    zero(acc);
    for (int kk = 0; kk < 2 * r + 2; ++kk) {
        const int j = 8 * kk + 2 * t4;
        const float2 lj = *reinterpret_cast<const float2*>(Ls + j);
        const float2 c0 = *reinterpret_cast<const float2*>(CBs + i0 * CBP + j);
        const float2 c1 = *reinterpret_cast<const float2*>(CBs + i1 * CBP + j);
        uint32_t ah[1][4], al[1][4];
        split_tf32(j <= i0 ? c0.x * exp2f(li0 - lj.x) : 0.f, ah[0][0], al[0][0]);
        split_tf32(j <= i1 ? c1.x * exp2f(li1 - lj.x) : 0.f, ah[0][1], al[0][1]);
        split_tf32(j + 1 <= i0 ? c0.y * exp2f(li0 - lj.y) : 0.f, ah[0][2], al[0][2]);
        split_tf32(j + 1 <= i1 ? c1.y * exp2f(li1 - lj.y) : 0.f, ah[0][3], al[0][3]);
        mma_split(acc, ah, al, x2 + kk * NTN * 32 + lane, nb, NTN);
    }
    store(y, acc[0], i0, nb, NTN, P, t4);
}

// S rows (of N) 16 nr .. 16 nr + 31 (two row tiles; the second repeats the
// first when nr is the last tile, and is not stored), NTI n-tiles from nb:
// A = (B o dec)^T, B read transposed by ldmatrix.trans (two k-steps a
// call), times dec and split in registers.
template <int NTI>
__device__ __forceinline__ void s_item(float* __restrict__ sc, const bf16* Bs,
                                       const float* dec, const uint4* x2, int nr, int nb,
                                       int BP, int NTN, int NR, int P, int chunk, int lane) {
    constexpr int MT = 2;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[MT][NTI][4];
    zero(acc);
    // matrices: (k-step, columns 16 nr ..+7), (k-step, +8 ..+15), the same for k-step + 1
    uint32_t b_lane[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
        b_lane[m] = smem_u32(Bs + ((lane >> 4) * 8 + (lane & 7)) * BP +
                             16 * min(nr + m, NR - 1) + ((lane >> 3) & 1) * 8);
    for (int kk = 0; kk < chunk / 8; kk += 2) {
        uint32_t bt[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
            ldmatrix_x4_trans(bt[m], b_lane[m] + kk * 8 * BP * (int)sizeof(bf16));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int k8 = kk + h, j = 8 * k8 + 2 * t4;
            const float2 d = *reinterpret_cast<const float2*>(dec + j);
            uint32_t ah[MT][4], al[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                const uint32_t lo = bt[m][2 * h], hi = bt[m][2 * h + 1];   // columns n0, n0 + 8
                split_tf32(__uint_as_float(lo << 16) * d.x, ah[m][0], al[m][0]);
                split_tf32(__uint_as_float(hi << 16) * d.x, ah[m][1], al[m][1]);
                split_tf32(__uint_as_float(lo & 0xffff0000u) * d.y, ah[m][2], al[m][2]);
                split_tf32(__uint_as_float(hi & 0xffff0000u) * d.y, ah[m][3], al[m][3]);
            }
            mma_split(acc, ah, al, x2 + k8 * NTN * 32 + lane, nb, NTN);
        }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
        if (nr + m < NR) store(sc, acc[m], 16 * (nr + m) + g, nb, NTN, P, t4);
}

// One warp: L = cumsum(la) over the chunk (each lane sums E consecutive
// values, then a shuffle scan over the lanes' totals); writes L2 = L
// log2(e), dec = exp(L_end - L) and returns exp(L_end).
__device__ __forceinline__ float scan_warp(const float* la, float* L2, float* dec, int chunk,
                                           int lane) {
    const int E = (chunk + 31) / 32;
    float run[4], tot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int i = lane * E + e;
        if (e < E && i < chunk) tot += la[i];
        run[e] = tot;
    }
    float incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
    }
    const float base = incl - tot;
    float last = 0.f;                                  // L at chunk - 1, as stored
#pragma unroll
    for (int e = 0; e < 4; ++e)
        if (e == (chunk - 1) % E) last = base + run[e];
    const float l_end = __shfl_sync(0xffffffffu, last, (chunk - 1) / E);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int i = lane * E + e;
        if (e < E && i < chunk) {
            dec[i] = expf(l_end - (base + run[e]));
            L2[i] = (base + run[e]) * LOG2E;                 // y's decays take exp2
        }
    }
    return expf(l_end);
}

template <int NTI>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_tc_kernel(
        const float* __restrict__ x, const float* __restrict__ loga,
        const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
        float* __restrict__ y, float* __restrict__ s, float* __restrict__ t,
        int L, int P, int N, int chunk, int rep, int ht) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int BP = N + BPAD, RP = P + RPAD, CBP = chunk + CBPAD, NTN = P / 8;
    bf16* Bs = reinterpret_cast<bf16*>(smem_raw);
    float* CBs = reinterpret_cast<float*>(Bs + chunk * BP);
    float* xr = CBs + chunk * CBP;
    unsigned char* x2_raw = reinterpret_cast<unsigned char*>(xr + chunk * RP);
    uint4* x2 = reinterpret_cast<uint4*>(x2_raw);
    bf16* Cs = reinterpret_cast<bf16*>(x2_raw);
    float* la = reinterpret_cast<float*>(x2_raw + x2_bytes(chunk, N, P));
    float* Ls = la + chunk;                            // 2 x [chunk] L log2(e), L = cumsum(loga)
    float* dec = Ls + 2 * chunk;                       // 2 x [chunk] exp(L_end - L)
    int* next = reinterpret_cast<int*>(dec + 2 * chunk);   // the head's next work item

    const int nc = L / chunk, tiles = (rep + ht - 1) / ht;
    const int tile = (int)(blockIdx.x % tiles), gc = (int)(blockIdx.x / tiles);
    const int bg = gc / nc, c = gc % nc;
    const int h0 = bg * rep + tile * ht;               // first head row of the tile
    const int nh = min(ht, rep - tile * ht);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    // loga (copied by warp 0, which scans it) and raw x of head h0 + k
    auto load_loga = [&](int k) {
        const size_t row0 = (size_t)(h0 + k) * L + (size_t)c * chunk;
        if (tid < chunk / 4) cp_async16(smem_u32(la + tid * 4), loga + row0 + tid * 4);
    };
    auto load_x = [&](int k) {
        const size_t row0 = (size_t)(h0 + k) * L + (size_t)c * chunk;
        const int cpr = P / 4;                         // 16-byte copies a row
        for (int e = tid; e < chunk * cpr; e += NT) {
            const int r = e / cpr, q = e - r * cpr;
            cp_async16(smem_u32(xr + r * RP + q * 4), x + (row0 + r) * P + q * 4);
        }
    };
    {
        const size_t grow0 = (size_t)bg * L + (size_t)c * chunk;   // the group's rows
        const int cpr = N / 8;
        for (int e = tid; e < chunk * cpr; e += NT) {
            const int r = e / cpr, q = e - r * cpr;
            cp_async16(smem_u32(Bs + r * BP + q * 8), Bm + (grow0 + r) * N + q * 8);
            cp_async16(smem_u32(Cs + r * BP + q * 8), Cm + (grow0 + r) * N + q * 8);
        }
    }
    cp_async_commit();
    load_loga(0);                                      // these land during the C B^T pass
    load_x(0);
    cp_async_commit();
    cp_async_wait<1>();                                // B and C have landed
    __syncthreads();
    if (warp == 0) {                                   // head 0's cumsum (warp 0 copied loga)
        cp_async_wait<0>();
        __syncwarp();
        const float t0 = scan_warp(la, Ls, dec, chunk, lane);
        if (lane == 0) t[(size_t)h0 * nc + c] = t0;
    }

    // CB = C B^T over the causal 16x16 tiles (r, m), m <= r, dealt round
    // robin to warps 1.. (warp 0 scans)
    const int RT = chunk / 16;
    {
        const int g = lane >> 2, t4 = lane & 3, KS = N / 16;
        int q = 0;
        for (int r = 0; r < RT; ++r) {
            for (int m = 0; m <= r; ++m, ++q) {
                if (q % (NW - 1) + 1 != warp) continue;
                float acc[2][4];
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
                const uint32_t a_addr = smem_u32(Cs + (16 * r + (lane & 15)) * BP + (lane >> 4) * 8);
                const uint32_t b_addr = smem_u32(
                    Bs + (16 * m + (lane >> 4) * 8 + (lane & 7)) * BP + ((lane >> 3) & 1) * 8);
#pragma unroll 4
                for (int ks = 0; ks < KS; ++ks) {
                    uint32_t a[4], b[4];
                    ldmatrix_x4(a, a_addr + ks * 32);
                    ldmatrix_x4(b, b_addr + ks * 32);
                    mma_bf16(acc[0], a, b[0], b[1]);
                    mma_bf16(acc[1], a, b[2], b[3]);
                }
#pragma unroll
                for (int n = 0; n < 2; ++n) {
                    const int col = 16 * m + 8 * n + 2 * t4;
                    *reinterpret_cast<float2*>(CBs + (16 * r + g) * CBP + col) =
                        make_float2(acc[n][0], acc[n][1]);
                    *reinterpret_cast<float2*>(CBs + (16 * r + g + 8) * CBP + col) =
                        make_float2(acc[n][2], acc[n][3]);
                }
            }
        }
    }
    cp_async_wait<0>();                                // head 0's x has landed
    __syncthreads();                                   // C is no longer read: x2 takes its place

    // work items of a head, heaviest first: the S items (two row tiles
    // over the whole chunk), then the y row tiles, longest first; NTI
    // n-tiles an item, warps take the next item as they come free
    const int CGN = (NTN + NTI - 1) / NTI, NR = N / 16;
    const int nsi = (NR + 1) / 2 * CGN, items = nsi + RT * CGN;
    for (int k = 0; k < nh; ++k) {
        const int hb = h0 + k;
        // split x once a head: a thread takes one (n-tile, lane) over every k-step
        for (int e = tid; e < NTN * 32; e += NT) {
            const float* xj = xr + 2 * (lane & 3) * RP + 8 * (e >> 5) + (lane >> 2);
            uint4* dst = x2 + e;
#pragma unroll 4
            for (int kk = 0; kk < chunk / 8; ++kk) {
                uint32_t h0v, h1v, l0v, l1v;
                split_tf32(xj[8 * kk * RP], h0v, l0v);
                split_tf32(xj[(8 * kk + 1) * RP], h1v, l1v);
                dst[kk * NTN * 32] = make_uint4(h0v, h1v, l0v, l1v);
            }
        }
        if (tid == 0) *next = 0;
        __syncthreads();                               // x2 visible; raw x and loga are free
        if (k + 1 < nh) load_loga(k + 1);              // these land while the products run
        cp_async_commit();
        if (k + 1 < nh) load_x(k + 1);
        cp_async_commit();
        if (warp == 0 && k + 1 < nh) {                 // the next head's cumsum, off the
            cp_async_wait<1>();                        // critical path: warp 0 joins the
            __syncwarp();                              // work queue after it
            const float tn = scan_warp(la, Ls + ((k + 1) & 1) * chunk,
                                       dec + ((k + 1) & 1) * chunk, chunk, lane);
            if (lane == 0) t[(size_t)(hb + 1) * nc + c] = tn;
        }
        const float* Lk = Ls + (k & 1) * chunk;
        const float* deck = dec + (k & 1) * chunk;

        const size_t row0 = (size_t)hb * L + (size_t)c * chunk;
        float* sc = s + ((size_t)hb * nc + c) * (size_t)N * P;
        for (;;) {
            int q = 0;
            if (lane == 0) q = atomicAdd(next, 1);
            q = __shfl_sync(0xffffffffu, q, 0);
            if (q >= items) break;
            if (q < nsi) {
                s_item<NTI>(sc, Bs, deck, x2, 2 * (q / CGN), (q % CGN) * NTI, BP, NTN, NR, P,
                            chunk, lane);
            } else {
                const int qy = q - nsi;
                y_item<NTI>(y + row0 * P, CBs, Lk, x2, RT - 1 - qy / CGN, (qy % CGN) * NTI,
                            CBP, NTN, P, lane);
            }
        }
        cp_async_wait<0>();
        __syncthreads();                               // the next head's raw x has landed
    }
}

template <int NTI>
int launch(const float* x, const float* loga, const void* B, const void* C, float* y,
           float* s, float* t, int bh, int bg, int L, int P, int N, int chunk, int ht,
           cudaStream_t stream) {
    const int rep = bh / bg;
    const size_t smem = smem_bytes(chunk, N, P);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_tc_kernel<NTI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)bg * (L / chunk) * ((rep + ht - 1) / ht);
    if (blocks > 0)
        ssd_chunk_tc_kernel<NTI><<<(unsigned)blocks, NT, smem, stream>>>(
            x, loga, static_cast<const bf16*>(B), static_cast<const bf16*>(C), y, s, t,
            L, P, N, chunk, rep, ht);
    return (int)cudaGetLastError();
}

}  // namespace

// bf16 B/C in group form [BH / rep, L, N]; x [BH, L, P] and loga [BH, L]
// f32.  chunk and N multiples of 16 (chunk <= 128), P a multiple of 8,
// every pointer 16-byte aligned (the wrapper checks them), `ht` heads a
// CTA.
REPRO_EXPORT int repro_ssd_chunk_scan_tc(const float* x, const float* loga, const void* B,
                                         const void* C, float* y, float* s, float* t,
                                         int bh, int bg, int L, int P, int N, int chunk,
                                         int ht, void* stream) {
    if (chunk < 16 || chunk > CHUNK_MAX || chunk % 16 || L % chunk || N < 16 || N % 16 ||
        P < 8 || P % 8 || bg < 1 || bh % bg || ht < 1)
        return (int)cudaErrorInvalidValue;
    // 8 n-tiles (64 columns of P) an item, or 4 when P is narrower
    return P >= 64 ? launch<8>(x, loga, B, C, y, s, t, bh, bg, L, P, N, chunk, ht,
                               (cudaStream_t)stream)
                   : launch<4>(x, loga, B, C, y, s, t, bh, bg, L, P, N, chunk, ht,
                               (cudaStream_t)stream);
}
