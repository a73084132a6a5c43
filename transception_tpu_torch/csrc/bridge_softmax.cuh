// The bridge softmax attention's core on Hopper (K3; the K10 kernels use
// its building blocks): shared-memory staging of K/V chunks with cp.async,
// mma.sync.m16n8k16 products whose operands come from registers and
// ldmatrix, and the TPU kernel's rounding points
// (transception_tpu/ops/pallas/bridge_attention_kernel.py:59-75): fp32
// logits, the row max over all M keys before any exponential, e = exp(l − m)
// summed unrounded in fp32 with bf16(e) multiplied into V, one divide of the
// fp32 output by the sum at the caller. At fp32 (K3's and K8's fp32
// forms) the core is attend32 below: 3xTF32 products on the tensor cores,
// one pass with an online max.
//
// Layouts (PTX ISA, mma.m16n8k16 with .bf16): a warp's 16 x 16 A fragment
// is 4 registers of two bf16 (rows g and g+8, columns 2t, 2t+1 and 8 more;
// g = lane/4, t = lane%4); a 16 x 8 B fragment is 2 registers (rows 2t,
// 2t+1 and 8 more, column g); the 16 x 8 fp32 accumulator is 4 floats
// (row g, columns 2t, 2t+1; row g+8, the same). So the accumulators of two
// neighbouring 8-key tiles, rounded and packed in pairs, are the A fragment
// of the next product over those 16 keys: probabilities never leave the
// registers.
//
// Shared tiles are (rows, 64) bf16, 128 bytes a row, with the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8): the 8 row addresses of an
// ldmatrix 8 x 8 matrix (8 consecutive rows, one chunk) then fall in 8
// different bank groups, with and without .trans.
#pragma once

#include "common.cuh"

namespace bsa {

constexpr int D = 64;                 // head dim
constexpr int ROW_BYTES = D * 2;      // one staged row
constexpr int KC = 112;               // keys per staged chunk (784 = 7 x 112)
constexpr int KSTEPS = KC / 16;       // 16-key steps per chunk
constexpr int TILE_BYTES = KC * ROW_BYTES;
constexpr int STAGES = 2;             // depth of the K/V ring
constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;  // K + V per stage
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a · b on the tensor cores (16 x 8 x 16, bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x (the MUFU instruction; exp(l − m) = 2^(l·log2e − m·log2e)).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// Rows [0, rows) of a (rows, 64) bf16 tile at g into the swizzled tile at
// s, by all threads of the block, 16 bytes each; rows >= valid zero-filled.
__device__ __forceinline__ void load_tile(uint32_t s, const bf16* g, int rows,
                                          int valid) {
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < valid;
    cp_async16(s + swz(r, c), g + (size_t)(ok ? r : 0) * D + c * 8, ok);
  }
}

// A fragments of the 16 x 64 row block at row r0 of a (n, 64) bf16 matrix
// in device memory, straight into registers; rows >= n are zero.
__device__ __forceinline__ void load_a(const bf16* p, int r0, int n,
                                       uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(p + (size_t)(r < n ? r : 0) * D);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][h] = r < n ? row[kk * 8 + t] : 0u;
      a[kk][h + 2] = r < n ? row[kk * 8 + 4 + t] : 0u;
    }
  }
}

// s[j] = A · Bᵀ for the two 8-row tiles j of rows r0..r0+15 of the
// swizzled tile at b (A: a 16 x 64 block in A fragments; B rows are
// keys, or query rows in the K10 columns kernel). Accumulates into s.
__device__ __forceinline__ void abt16(const uint32_t (&a)[4][4], uint32_t b,
                                      int r0, float (&s)[2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + j * 8 + (lane & 7);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t f[4];
      ldsm_x4(b + swz(r, (lane >> 3) + 4 * h), f);
      mma(s[j], a[2 * h], f[0], f[1]);
      mma(s[j], a[2 * h + 1], f[2], f[3]);
    }
  }
}

// o += P · B for 16 rows of the swizzled tile at b from r0 (P: a 16 x 16
// A fragment over those rows; o: 16 x 64 in eight 8-column tiles).
__device__ __forceinline__ void pb16(const uint32_t (&p)[4], uint32_t b,
                                     int r0, float (&o)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t f[4];
    ldsm_x4_t(b + swz(r0 + (lane & 15), 2 * dp + (lane >> 4)), f);
    mma(o[2 * dp], p, f[0], f[1]);
    mma(o[2 * dp + 1], p, f[2], f[3]);
  }
}

// One warp's 16 query rows of softmax(q·Kᵀ·scale)·V before the divide:
// o (16 x 64, fp32) = Σ bf16(e)·V and rs[h] the fp32 row sums of e for
// rows g + 8h, with e = exp(l − m) and m the row max over all M keys.
// qa: the rows' q as A fragments; kg, vg: this batch·head's (M, 64) K and
// V; sl2 = scale·log2(e); ring: RING_BYTES of shared memory. Called by
// every thread of the block (it synchronises the block).
//
// K and V go through a ring of STAGES chunks of KC keys, filled with
// cp.async by the whole block and read by all its warps. Steps 0..C-1
// (C = ceil(M / KC)) stage K alone for pass 1, the max; steps C..2C-1
// stage K and V for pass 2. The copy of step t + STAGES - 1 is in flight
// while step t computes. A last chunk shorter than KC (M % KC, a multiple
// of 16) is computed over its whole 16-key steps only.
__device__ __forceinline__ void softmax_av(const uint32_t (&qa)[4][4],
                                           const bf16* kg, const bf16* vg,
                                           int M, float sl2, uint32_t ring,
                                           float (&o)[8][4], float (&rs)[2]) {
  const int nch = (M + KC - 1) / KC, steps = 2 * nch;
  auto fetch = [&](int t) {
    if (t < steps) {
      const int key0 = (t < nch ? t : t - nch) * KC;
      const int rows = min(KC, M - key0);
      const uint32_t slot = ring + (t % STAGES) * 2 * TILE_BYTES;
      load_tile(slot, kg + (size_t)key0 * D, rows, rows);
      if (t >= nch)
        load_tile(slot + TILE_BYTES, vg + (size_t)key0 * D, rows, rows);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  float mx[2] = {-INFINITY, -INFINITY}, m2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  rs[0] = rs[1] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t landed; step t-1's slot is free
    fetch(t + STAGES - 1);
    const int key0 = (t < nch ? t : t - nch) * KC;
    const int nks = min(KC, M - key0) / 16;
    const uint32_t ks = ring + (t % STAGES) * 2 * TILE_BYTES;
    if (t < nch) {
      // Pass 1: the row max of the raw logits (the max of the scaled ones:
      // the Python launchers refuse a scale that is not positive).
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        if (st < nks) {
          float s[2][4] = {};
          abt16(qa, ks, st * 16, s);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
          }
        }
      }
      if (t == nch - 1) {
        m2[0] = quad_max(mx[0]) * sl2;
        m2[1] = quad_max(mx[1]) * sl2;
      }
    } else {
      // Pass 2: e = exp(l − m), its fp32 sum, bf16(e) · V.
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        if (st < nks) {
          float s[2][4] = {};
          abt16(qa, ks, st * 16, s);
          uint32_t p[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float e0 = ex2(fmaf(s[j][2 * h], sl2, -m2[h]));
              const float e1 = ex2(fmaf(s[j][2 * h + 1], sl2, -m2[h]));
              rs[h] += e0 + e1;
              p[2 * j + h] = pack(e0, e1);
            }
          }
          pb16(p, ks + TILE_BYTES, st * 16, o);
        }
      }
    }
  }
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller
}

// ---- The fp32 product step ----
// The fp32 forms of the staged kernels (mixffn_stages.cuh,
// expand_stages.cuh) multiply on the CUDA cores with FFMA (K3's and K8's
// use the 3xTF32 core below).
// Their staged tiles keep the bf16 layout's 128-byte swizzled panel rows,
// which hold 32 fp32 columns: a product step is 32 deep at fp32.

// Byte address of fp32 element (r, c) of a tile staged in swizzled
// 128-byte panel rows of 32 columns, the panels ps bytes apart.
__device__ __forceinline__ uint32_t at32(uint32_t s, int ps, int r, int c) {
  return s + (c >> 5) * ps + swz(r, (c >> 2) & 7) + (c & 3) * 4;
}

// acc += A·B over one 32-deep fp32 step for a warp's MT x NT m16n8 tiles
// from row wm and column wn, acc in mma's accumulator layout (row g + 8h,
// columns 2t + e of each n8 tile in acc[i][j][2h + e]; g = lane / 4, t =
// lane % 4), so the epilogues of the bf16 path take it unchanged. A at sa:
// AMK, rows m of 32 (one panel row each), else 32 rows of M columns in
// panels aps bytes apart; B at sb: BNK, rows n of 32, else 32 rows of N
// columns in panels bps bytes apart. Four k at a time: one 16-byte load
// per row of A (AMK) and column of B (BNK); each sum runs in k order.
template <int MT, int NT, bool AMK, bool BNK>
__device__ __forceinline__ void ffma_step(uint32_t sa, uint32_t sb, int wm,
                                          int wn, int aps, int bps,
                                          float (&acc)[MT][NT][4]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += 4) {
    float a[MT][2][4], b[NT][2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + i * 16 + g + 8 * h;
        if (AMK) {
          const float4 v = lds128(sa + swz(m, k0 >> 2));
          a[i][h][0] = v.x;
          a[i][h][1] = v.y;
          a[i][h][2] = v.z;
          a[i][h][3] = v.w;
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            a[i][h][kk] = lds32(at32(sa, aps, k0 + kk, m));
        }
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn + j * 8 + 2 * t;
      if (BNK) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 v = lds128(sb + swz(n + e, k0 >> 2));
          b[j][e][0] = v.x;
          b[j][e][1] = v.y;
          b[j][e][2] = v.z;
          b[j][e][3] = v.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float2 v = lds64(at32(sb, bps, k0 + kk, n));
          b[j][0][kk] = v.x;
          b[j][1][kk] = v.y;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[i][j][2 * h + e] =
                  fmaf(a[i][h][kk], b[j][e][kk], acc[i][j][2 * h + e]);
  }
}

// ---- Rows of 64 fp32 ----
// Rows of 64 fp32 (256 bytes), 16-byte chunk c (0..15) of row r at chunk
// c ^ (r % 8) (the XOR keeps each half of the row in place): the 8 rows a
// quad-strided load or an ldmatrix 8 x 8 matrix touches fall in 8
// different bank groups. A warp's 16 rows take Q32 bytes; the 3xTF32
// core below and K10's fp32 form stage their rows this way.
constexpr int ROW32 = D * 4;
constexpr int Q32 = 16 * ROW32;              // a warp's rows

__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return r * ROW32 + ((c ^ (r & 7)) << 4);
}

// Rows [0, rows) of a (rows, 64) fp32 matrix at g into the swizzled tile
// at s, by all threads of the block; rows >= valid zero-filled.
__device__ __forceinline__ void load_tile32(uint32_t s, const float* g,
                                            int rows, int valid) {
  for (int i = threadIdx.x; i < rows * 16; i += blockDim.x) {
    const int r = i >> 4, c = i & 15;
    const bool ok = r < valid;
    cp_async16(s + swz32(r, c), g + (size_t)(ok ? r : 0) * D + c * 4, ok);
  }
}

// ---- The fp32 attention core: 3xTF32 on the tensor cores ----
// K3's and K8's fp32 forms. Hopper's tensor cores take fp32 operands only
// as TF32 (10 mantissa bits), so each operand x is split into hi =
// tf32(x) and lo = tf32(x − hi) (round to nearest, ties away) and a
// product is lo·hi + hi·lo + hi·hi, accumulated in fp32: about 2^-22
// relative per operand against fp32, where hi·hi alone keeps ~5e-4.
// Products are mma.m16n8k8 (.tf32, fp32 accumulate; g = lane / 4, t =
// lane % 4): the A fragment holds rows g, g + 8 at columns t, t + 4; the
// B fragment rows t, t + 4 at column g; the accumulator row g, g + 8 at
// columns 2t, 2t + 1. Every fragment is one ldmatrix.x4 of 16-byte chunks
// of 8 rows (a lane's 32-bit word t of row g), hi and lo apart:
// - q (16 rows x 64 a warp) is split once, into the warp's own rows of
//   shared memory;
// - each chunk of K and V is split once per block, not once per warp:
//   the block's threads turn the chunk's raw fp32 rows (cp.async ring)
//   into K hi and lo rows and Vᵀ hi and lo rows (channel-major);
// - an 8-key tile of logits holds keys t and t + 4 where the accumulator
//   has columns 2t and 2t + 1 (the lanes' ldmatrix row addresses pick K's
//   rows in that order), so after ex2 it is the A fragment of P·V over
//   those 8 keys with no shuffle.
// The tensor cores' fp32 sums round toward zero, a bias that grows with
// the number of products added into one accumulator (over all 784 keys,
// several times the error of the split): the logits keep hi·hi apart
// from the two small terms, P·V sums one step of keys apart, and both are
// added in fp32 (round to nearest).
// One pass over K and V with an online max: when a row's max rises, its
// sum and output are rescaled by 2^(m_old − m_new). Nothing is rounded to
// a narrower type (the TPU kernel's e.astype(v.dtype) is the identity at
// fp32).
constexpr int F32_WARPS = 12;  // warps a block, 16 query rows each
constexpr int F32_KC = 64;     // keys per staged chunk
constexpr int F32_STAGES = 2;  // depth of the raw K/V ring
constexpr int F32_KS = 32;     // keys per online-softmax step
constexpr int F32_ROWS = 16 * F32_WARPS;
constexpr int F32_TILE = F32_KC * ROW32;  // a chunk of K or V (or of Vᵀ)
constexpr int F32_VROW = F32_KC * 4;      // a Vᵀ row (channel): its keys
constexpr int F32_RING = F32_STAGES * 2 * F32_TILE;  // raw K + V a stage
constexpr int F32_SPLIT = 4 * F32_TILE;  // K hi, K lo, Vᵀ hi, Vᵀ lo
constexpr int F32_Q = 2 * Q32;           // a warp's q rows, hi and lo
constexpr int F32_SMEM = F32_RING + F32_SPLIT + F32_WARPS * F32_Q;
static_assert(F32_KC % 32 == 0, "Vᵀ rows of at least 8 16-byte chunks");
static_assert(F32_KC % F32_KS == 0 && F32_KS % 16 == 0, "whole steps");

// Byte offset of 16-byte chunk c of row r of Vᵀ (swizzled as swz32).
__device__ __forceinline__ uint32_t swzv(int r, int c) {
  return r * F32_VROW + ((c ^ (r & 7)) << 4);
}

// x rounded to TF32: round to nearest, ties away from zero, 10 mantissa
// bits (the low 13 bits zero); infinities and NaNs kept, so a NaN in an
// operand reaches the output as in the plain version.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32(x), lo = tf32(x − hi) (x − hi is exact).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// split for the probabilities e in [0, 1], in the inner loop: the same
// rounding as an add and a mask (cvt.rna adds a compare and select for
// infinities and NaNs). A NaN e (a NaN logit) becomes a zero here, but
// the row sum takes e itself, so the row still comes out NaN.
__device__ __forceinline__ void split_unit(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split4(const float4& x, uint4& h, uint4& l) {
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
}

// c += a · b on the tensor cores (16 x 8 x 8, TF32 in, fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a · b at fp32 accuracy (3xTF32), the small terms first: a = ah +
// al, b = (b0, b1) in fp32, split here. The projections of K8.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

__device__ __forceinline__ void sts128(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(a), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w));
}

__device__ __forceinline__ void sts64(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1,%2};\n" ::"r"(a), "r"(x), "r"(y));
}

// The warp's 16 rows r0.. of a (n, 64) fp32 matrix in device memory,
// split, into its q rows at qs (hi, then lo Q32 bytes on; swz32); rows
// >= n are zero.
__device__ __forceinline__ void stage_q(const float* p, int r0, int n,
                                        uint32_t qs) {
#pragma unroll
  for (int i = threadIdx.x & 31; i < 16 * 16; i += 32) {
    const int r = i >> 4, c = i & 15;
    const float4 x =
        r0 + r < n
            ? *reinterpret_cast<const float4*>(p + (size_t)(r0 + r) * D + c * 4)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint4 h, l;
    split4(x, h, l);
    sts128(qs + swz32(r, c), h);
    sts128(qs + Q32 + swz32(r, c), l);
  }
}

// Chunk c of K and V into its slot of the raw ring, by all threads of the
// block, as one cp.async group (empty past the last chunk, so the count
// of groups stays uniform).
__device__ __forceinline__ void fetch_kv(uint32_t ring, const float* kg,
                                         const float* vg, int M, int c) {
  if (c * F32_KC < M) {
    const int key0 = c * F32_KC, rows = min(F32_KC, M - key0);
    const uint32_t slot = ring + (c % F32_STAGES) * 2 * F32_TILE;
    load_tile32(slot, kg + (size_t)key0 * D, rows, rows);
    load_tile32(slot + F32_TILE, vg + (size_t)key0 * D, rows, rows);
  }
  cp_async_commit();
}

// The ring's first F32_STAGES - 1 chunks, before attend32 (which waits
// for them): the caller's own loads overlap them.
__device__ __forceinline__ void prefetch_kv(uint32_t ring, const float* kg,
                                            const float* vg, int M) {
#pragma unroll
  for (int c = 0; c < F32_STAGES - 1; ++c) fetch_kv(ring, kg, vg, M, c);
}

// The first `rows` keys of a raw chunk (K at slot, V after it) split at
// sp into K hi and lo (rows as staged, swz32) and Vᵀ hi and lo (row =
// channel, 16-byte chunk kc = keys 4kc..4kc + 3, swzv). By all threads of
// the block: 4 channels of a key or 4 keys of a channel each, every
// access free of bank conflicts.
__device__ __forceinline__ void split_kv(uint32_t slot, uint32_t sp,
                                         int rows) {
  for (int i = threadIdx.x; i < rows * 16; i += blockDim.x) {
    const uint32_t at = swz32(i >> 4, i & 15);
    uint4 h, l;
    split4(lds128(slot + at), h, l);
    sts128(sp + at, h);
    sts128(sp + F32_TILE + at, l);
  }
  for (int i = threadIdx.x; i < rows * 16; i += blockDim.x) {
    const int ch = i & (D - 1), kc = i / D;
    const uint32_t col = slot + F32_TILE + 4 * (ch & 3);
    float4 x;
    x.x = lds32(col + swz32(4 * kc, ch >> 2));
    x.y = lds32(col + swz32(4 * kc + 1, ch >> 2));
    x.z = lds32(col + swz32(4 * kc + 2, ch >> 2));
    x.w = lds32(col + swz32(4 * kc + 3, ch >> 2));
    uint4 h, l;
    split4(x, h, l);
    const uint32_t at = swzv(ch, kc);
    sts128(sp + 2 * F32_TILE + at, h);
    sts128(sp + 3 * F32_TILE + at, l);
  }
}

// One warp's 16 query rows of softmax(q·Kᵀ·scale)·V at fp32 before the
// divide: o (16 x 64, the accumulator layout: o[n] columns 8n + 2t, + 1)
// = Σ e·V and rs[h] the row sums of e for rows g + 8h, with e = exp(l −
// m), m the running row max. qs: the warp's split q rows (stage_q's
// layout); kg, vg: this batch·head's (M, 64) K and V; sl2 =
// scale·log2(e); smem: the block's shared memory (the raw ring, then the
// split chunk), the ring's first chunks issued by prefetch_kv. Called by
// every thread of the block (it synchronises the block).
//
// K and V go through a ring of F32_STAGES raw chunks of F32_KC keys,
// filled with cp.async by the whole block (the copy of chunk c +
// F32_STAGES - 1 is in flight while chunk c computes). Per chunk: a
// barrier, split_kv, a barrier, then steps of F32_KS keys: the logits
// (per 16 channels: four ldmatrix.x4 of q, hi and lo of two channel
// steps, then two of K and 6 mma an 8-key tile), the new row max and the
// factor on the old sums, e = 2^(l·sl2 − m·sl2) (ex2.approx), and P·V
// (two ldmatrix.x2 and 3 mma 8 keys and 8 channels: one 8-key tile's P at
// a time keeps the registers within the 168 a thread of 12 warps an SM).
// A last step shorter than F32_KS (M is a multiple of 16) skips its
// missing 8-key tiles, their logits −inf.
__device__ __forceinline__ void attend32(uint32_t qs, const float* kg,
                                         const float* vg, int M, float sl2,
                                         uint32_t smem, float (&o)[8][4],
                                         float (&rs)[2]) {
  constexpr int NT = F32_KS / 8;  // 8-key tiles a step
  const int lane = threadIdx.x & 31, l7 = lane & 7, l3 = lane >> 3;
  const int nch = (M + F32_KC - 1) / F32_KC;
  const uint32_t sp = smem + F32_RING;  // K hi, K lo, Vᵀ hi, Vᵀ lo
  // q's ldmatrix rows: l7 + 8 (l3 % 2) at chunk 2kk + l3 / 2 (the four 8 x
  // 4 blocks of an A fragment); K's: key (l7 / 2) + 4 (l7 % 2) of an
  // 8-key tile, so that accumulator columns 2t, 2t + 1 are keys t, t + 4,
  // at chunk 4m + l3 (channel steps 2m and 2m + 1).
  const uint32_t qrow = qs + (l7 + 8 * (l3 & 1)) * ROW32;
  const int kr = (l7 >> 1) + 4 * (l7 & 1);
  float m2[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  rs[0] = rs[1] = 0.0f;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<F32_STAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    fetch_kv(smem, kg, vg, M, c + F32_STAGES - 1);
    const int rows = min(F32_KC, M - c * F32_KC);
    split_kv(smem + (c % F32_STAGES) * 2 * F32_TILE, sp, rows);
    __syncthreads();  // the split chunk is ready
    for (int k0 = 0; k0 < rows; k0 += F32_KS) {
      const int nv = min(F32_KS, rows - k0) / 8;  // 8-key tiles present
      // The logits: keys k0 + 8j + t (column 2t) and + 4 (2t + 1), rows
      // g, g + 8; hi·hi in sh, the small terms in sl.
      float sh[NT][4], sl[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sh[j][i] = sl[j][i] = 0.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t ah[2][4], al[2][4];  // q's channel steps 2m + v
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const uint32_t qa = qrow + (((4 * m + 2 * v + (l3 >> 1)) ^ l7) << 4);
          ldsm_x4(qa, ah[v]);
          ldsm_x4(qa + Q32, al[v]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nv) {
            uint32_t h[4], l[4];  // b0, b1 of channel steps 2m, 2m + 1
            const uint32_t at =
                sp + (k0 + 8 * j) * ROW32 + swz32(kr, 4 * m + l3);
            ldsm_x4(at, h);
            ldsm_x4(at + F32_TILE, l);
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              mma_tf32(sl[j], al[v], h[2 * v], h[2 * v + 1]);
              mma_tf32(sl[j], ah[v], l[2 * v], l[2 * v + 1]);
              mma_tf32(sh[j], ah[v], h[2 * v], h[2 * v + 1]);
            }
          }
        }
      }
      float(&s)[NT][4] = sh;  // the logits, hi·hi and the small terms added
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[j][i] = j < nv ? sh[j][i] + sl[j][i] : -INFINITY;
      // The running max (log2 units; the max of the raw logits, as the
      // launchers refuse a scale that is not positive) and the factor
      // 2^(m_old − m_new) on the row's sum and output (0 at the first
      // step: m2 = −inf).
      float a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          cm = fmaxf(cm, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        const float mn = fmaxf(m2[h], quad_max(cm) * sl2);
        a[h] = ex2(m2[h] - mn);
        m2[h] = mn;
        rs[h] *= a[h];
      }
      // e, its row sums, and the step's P·V in an accumulator of its own,
      // added to the rescaled output with one FFMA. Tile u's e is its A
      // fragment (keys 8u + t, + 4 at columns t, t + 4); 8 keys of Vᵀ's
      // rows 8n.. (channels) its B fragment, hi and lo.
      float po[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        po[n][0] = po[n][1] = po[n][2] = po[n][3] = 0.0f;
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        if (u < nv) {
          float e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            e[i] = ex2(fmaf(s[u][i], sl2, -m2[i >> 1]));
          rs[0] += e[0] + e[1];
          rs[1] += e[2] + e[3];
          uint32_t ph[4], pl[4];
          split_unit(e[0], ph[0], pl[0]);
          split_unit(e[2], ph[1], pl[1]);
          split_unit(e[1], ph[2], pl[2]);
          split_unit(e[3], ph[3], pl[3]);
          const uint32_t vo = sp + 2 * F32_TILE +
                              swzv(l7, (k0 >> 2) + 2 * u + (l3 & 1));
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            uint32_t h[2], l[2];
            ldsm_x2(vo + n * 8 * F32_VROW, h);
            ldsm_x2(vo + n * 8 * F32_VROW + F32_TILE, l);
            mma_tf32(po[n], pl, h[0], h[1]);
            mma_tf32(po[n], ph, l[0], l[1]);
            mma_tf32(po[n], ph, h[0], h[1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[n][i] = fmaf(o[n][i], a[i >> 1], po[n][i]);
    }
  }
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);
  cp_async_wait<0>();
  __syncthreads();  // the ring and the split chunk are free for the caller
}

// A warp's 16 x 64 fp32 block o divided by f[h] for rows g + 8h, to rows
// r0.. of a (n, 64) fp32 matrix, rows >= n skipped: through the warp's 4
// KB of swizzled shared memory at st, then 16-byte coalesced writes.
__device__ __forceinline__ void store_rows32(const float (&o)[8][4],
                                             const float (&f)[2], uint32_t st,
                                             float* p, int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // every lane is done with the rows staged at st
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v2.f32 [%0], {%1,%2};\n" ::"r"(
                       st + swz32(g + 8 * h, 2 * j + (t >> 1)) + 8 * (t & 1)),
                   "f"(o[j][2 * h] / f[h]), "f"(o[j][2 * h + 1] / f[h]));
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 16; i += 32) {
    const int r = i >> 4, c = i & 15;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(st + swz32(r, c)));
    if (r0 + r < n)
      reinterpret_cast<uint4*>(p + (size_t)(r0 + r) * D)[c] = v;
  }
}

// Store a warp's 16 x 64 fp32 block o, times f[h] for rows g + 8h and
// rounded to bf16, to rows r0.. of a (n, 64) bf16 matrix, rows >= n
// skipped: through the warp's 2 KB of swizzled shared memory at st, then
// 16-byte coalesced writes. DIV: divide by f instead of multiplying.
template <bool DIV>
__device__ __forceinline__ void store_rows(const float (&o)[8][4],
                                           const float (&f)[2], uint32_t st,
                                           bf16* p, int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = DIV ? o[j][2 * h] / f[h] : o[j][2 * h] * f[h];
      const float b = DIV ? o[j][2 * h + 1] / f[h] : o[j][2 * h + 1] * f[h];
      const uint32_t v = pack(a, b);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       st + swz(g + 8 * h, j) + 4 * t),
                   "r"(v));
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(st + swz(r, c)));
    if (r0 + r < n)
      reinterpret_cast<uint4*>(p + (size_t)(r0 + r) * D)[c] = v;
  }
}

}  // namespace bsa
