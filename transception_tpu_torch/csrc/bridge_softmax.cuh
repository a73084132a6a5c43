// The bridge softmax attention's core on Hopper (K3; the K10 kernels use
// its building blocks): shared-memory staging of K/V chunks with cp.async,
// mma.sync.m16n8k16 products whose operands come from registers and
// ldmatrix, and the TPU kernel's rounding points
// (transception_tpu/ops/pallas/bridge_attention_kernel.py:59-75): fp32
// logits, the row max over all M keys before any exponential, e = exp(l − m)
// summed unrounded in fp32 with bf16(e) multiplied into V, one divide of the
// fp32 output by the sum at the caller.
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
// Hopper has no fp32 tensor-core product (TF32 keeps ~3 decimal digits),
// so the fp32 forms of the kernels multiply on the CUDA cores with FFMA.
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

// ---- K3's fp32 form ----
// Rows of 64 fp32 (256 bytes), 16-byte chunk c (0..15) of row r at chunk
// c ^ (r % 8) (the XOR keeps each half of the row in place): the 8 rows a
// quad-strided load touches fall in 8 different bank groups. K and V go
// through the same 2-deep ring as at bf16, in chunks of 64 keys (16 KB a
// tile); each warp keeps its 16 query rows in its own 4 KB of shared
// memory, which later stages its output rows.
constexpr int ROW32 = D * 4;
constexpr int KC32 = 64;                     // keys per staged chunk
constexpr int TILE32 = KC32 * ROW32;
constexpr int RING32 = STAGES * 2 * TILE32;  // K + V per stage
constexpr int Q32 = 16 * ROW32;              // a warp's query rows

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

// The dots of a warp's 16 rows staged at qs (rows of 64 fp32, swz32)
// with the 16 rows n0.. of the tile at ks: lane (g, t) forms those of its
// rows g, g + 8 with rows n0 + 8j + 2t + e, in s[j][e] and s[j][2 + e] (the
// mma accumulator layout), each sum in column order. The logits of
// softmax_av_f32 (ks a K chunk) and the products of K8's fp32 form with a
// 64 x 64 weight (ks its rows, the output columns).
__device__ __forceinline__ void dots16_f32(uint32_t qs, uint32_t ks, int n0,
                                           float (&s)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll 1  // 6 live float4 a step: 2 blocks an SM need <= 128 regs
  for (int c = 0; c < 16; ++c) {
    const float4 q0 = lds128(qs + swz32(g, c));
    const float4 q1 = lds128(qs + swz32(g + 8, c));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 kv = lds128(ks + swz32(n0 + 8 * j + 2 * t + e, c));
        float& a = s[j][e];
        float& b = s[j][2 + e];
        a = fmaf(q0.x, kv.x, a);
        a = fmaf(q0.y, kv.y, a);
        a = fmaf(q0.z, kv.z, a);
        a = fmaf(q0.w, kv.w, a);
        b = fmaf(q1.x, kv.x, b);
        b = fmaf(q1.y, kv.y, b);
        b = fmaf(q1.z, kv.z, b);
        b = fmaf(q1.w, kv.w, b);
      }
  }
}

// softmax_av at fp32 on the CUDA cores, for the warp's 16 query rows
// staged at qs: o (16 x 64) = Σ e·V and rs[h] the row sums of e for rows
// g + 8h, e = exp(l − m) with m the row max over all M keys, nothing
// rounded. Lane (g, t) forms the logits of rows g and g + 8 against keys
// 8j + 2t + e of each 16-key step (the layout of the bf16 path), then the
// quad's shuffles hand each lane the probabilities of all 16 keys for
// P·V into its columns 8j + 2t, 8j + 2t + 1. The ring schedule is
// softmax_av's (pass 1 the max, pass 2 the sums and P·V); a last chunk
// shorter than KC32 (a multiple of 16) runs its whole 16-key steps only.
__device__ __forceinline__ void softmax_av_f32(uint32_t qs, const float* kg,
                                               const float* vg, int M,
                                               float sl2, uint32_t ring,
                                               float (&o)[8][4],
                                               float (&rs)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nch = (M + KC32 - 1) / KC32, steps = 2 * nch;
  auto fetch = [&](int st) {
    if (st < steps) {
      const int key0 = (st < nch ? st : st - nch) * KC32;
      const int rows = min(KC32, M - key0);
      const uint32_t slot = ring + (st % STAGES) * 2 * TILE32;
      load_tile32(slot, kg + (size_t)key0 * D, rows, rows);
      if (st >= nch)
        load_tile32(slot + TILE32, vg + (size_t)key0 * D, rows, rows);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) fetch(st);

  float mx[2] = {-INFINITY, -INFINITY}, m2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  rs[0] = rs[1] = 0.0f;
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step st (and the query rows) landed
    fetch(st + STAGES - 1);
    const int key0 = (st < nch ? st : st - nch) * KC32;
    const int nks = min(KC32, M - key0) / 16;
    const uint32_t ks = ring + (st % STAGES) * 2 * TILE32;
    for (int k16 = 0; k16 < nks; ++k16) {
      float s[2][4];
      dots16_f32(qs, ks, k16 * 16, s);
      if (st < nch) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[j][2 * h] = ex2(fmaf(s[j][2 * h], sl2, -m2[h]));
          s[j][2 * h + 1] = ex2(fmaf(s[j][2 * h + 1], sl2, -m2[h]));
          rs[h] += s[j][2 * h] + s[j][2 * h + 1];
        }
      // Keys 8j + 2m + e of the step are lane (g, m)'s s[j][e] (row g)
      // and s[j][2 + e] (row g + 8).
      const uint32_t vs = ks + TILE32;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll 1
        for (int m = 0; m < 4; ++m) {
          const int src = (lane & ~3) | m;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = __shfl_sync(FULL_MASK, s[j][e], src);
            const float p1 = __shfl_sync(FULL_MASK, s[j][2 + e], src);
            const int key = k16 * 16 + 8 * j + 2 * m + e;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float2 v =
                  lds64(vs + swz32(key, 2 * c + (t >> 1)) + 8 * (t & 1));
              o[c][0] = fmaf(p0, v.x, o[c][0]);
              o[c][1] = fmaf(p0, v.y, o[c][1]);
              o[c][2] = fmaf(p1, v.x, o[c][2]);
              o[c][3] = fmaf(p1, v.y, o[c][3]);
            }
          }
        }
      }
    }
    if (st == nch - 1) {
      m2[0] = quad_max(mx[0]) * sl2;
      m2[1] = quad_max(mx[1]) * sl2;
    }
  }
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller
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
