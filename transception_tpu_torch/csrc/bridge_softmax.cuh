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
