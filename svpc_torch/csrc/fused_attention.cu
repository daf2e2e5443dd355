// Fused multi-head masked attention, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel svpc_tpu/ops/pallas_attention.py::_flash_kernel
// (:37; pallas_call at :145, wrapper fused_attention :89).  Same function:
//
//     out = softmax(q . k^T * scale + (1 - m) * -1e4) . v       per head
//
// with a streaming (running max, running sum, accumulator) softmax in f32
// and out = acc / max(l, 1e-30).  q (N, Lq, H), k/v (N, Lk, H) are read in
// the JAX package's (N, L, H) layout at head offset h*dh through their
// sequence/row strides (head dim contiguous, bases and row strides 16-byte
// aligned: the wrapper checks).  The mask is (N, 1, Lk) key-padding or
// (N, Lq, Lk) full, read through its three strides (stride 0 broadcasts).
// Keys beyond Lk are EXCLUDED (probability 0), not padded with mask 0 as
// the TPU kernel does, so a row whose keys are all masked computes what
// the plain attention_core computes.
//
// Two paths, chosen per call by the wrapper (ops/attention.py::_plan):
//
// TILE (Lq > 4: clip encoder N=96 Lq=Lk=100, step encoder, the uncached
//   decoder).  One block per (query block of up to 128 rows, head,
//   sequence), so K/V leave device memory once per (sequence, head).  One
//   producer warp bulk-copies the block's Q rows once and streams key
//   tiles of 64 rows through a 2-stage shared-memory ring: cp.async.bulk,
//   one row per copy, completing on an mbarrier with expect_tx (no tensor
//   map, so no libcuda link).  It also stages each tile's additive mask
//   terms, -inf for keys past Lk (a full mask: each consumer warp stages
//   its own rows).  Rows land at a pitch of dh_pad + 16 bytes, which keeps
//   the fragment loads free of bank conflicts; padded head columns are
//   zeroed once.  Below one tile of keys the ring shrinks to the rows Lk
//   needs, so the small calls leave room for more blocks an SM.  In f32
//   with dh > 64 a block holds at most 64 query rows: 128 rows with a full
//   mask would need 270 KB, past the 227 KB a block may have.  Consumer
//   warps own 16 query rows each and run q.k^T and p.v on the tensor cores
//   with mma.sync: m16n8k16 bf16, or m16n8k8 TF32 in the 3xTF32 split for
//   f32 (x = big + small, big = tf32(x), small = tf32(x - big); sum
//   small.big + big.small + big.big, as CUTLASS's OpMultiplyAddFastF32),
//   which keeps about 21 mantissa bits and holds 1e-5 against full f32.
//   The S accumulator of m16n8k8 (columns 2t, 2t+1) is not the A layout
//   p.v needs (columns t, t+4): instead of shuffling P, key 2t of each
//   8-key step is fed as k-index t and key 2t+1 as t+4, and V's rows are
//   read in the same order, which leaves the product unchanged.  8-key
//   blocks wholly past Lk are skipped.  When all keys fit one tile, p is
//   normalised before p.v, as the plain version does (a bf16 p is then
//   rounded where it is rounded there).  In bf16 over several tiles the
//   ring streams K alone once, to find each row's max and sum, then K
//   and V, and p is normalised the same way: rounding an unnormalised p
//   to bf16 moves an output by up to one bf16 unit in the last place,
//   0.031 at |out| >= 4, past the 2e-2 the kernel is held to.
//   Bound at the clip encoder (f32): 118 MB of q/k/v/out at 3.35 TB/s =
//   35 us; 3 x 2.95 GFLOP at the 495 TFLOP/s TF32 peak = 18 us: bytes.
//   The loop is short (2 tiles), so the kernel is bound by latency and
//   issue (3 MMAs and the splits a product), not by either roofline.
//
// DECODE (Lq <= 4: the cached decoder steps, Lq=1 against Lk=22 self and
//   Lk=3 cross).  Registers only: no shared memory, no block barrier.  One
//   warp per (sequence, head, query row), two warps a block.  Each lane
//   holds 4 head columns; a key takes dh/4 lanes (rounded up to 8, 16 or
//   32), so one 16-byte load instruction covers 2 keys at dh=64.  The K
//   loads of a chunk are issued, then its V loads and mask values, then
//   the arithmetic.  q.k reduces over a key's lanes with xor shuffles; the
//   online softmax runs chunk by chunk (any Lk; in bf16 over several
//   chunks, two passes as in the tile path); p.v accumulates per lane
//   and the key groups are combined once at the end.  Bound: 13.6 MB
//   (self) / 2.4 MB (cross) at 3.35 TB/s = 4.1 / 0.7 us: bytes, with the
//   launch's latency on top.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBN = 64;           // keys per ring stage
constexpr int kStages = 2;        // ring depth
constexpr int kMaxConsumers = 8;  // 16-row consumer warps a tile block
// K (and V) loads in flight a decode lane: 4 in f32 (more made the kernel
// slower: registers and code grow, measured on the H100); 16 in bf16, so
// that the 22-key self-attention cache fits one chunk and p is normalised
// and rounded where the plain version rounds it
template <typename T>
constexpr int kChunkLoads = std::is_same<T, float>::value ? 4 : 16;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int n, lq, lk, nh, dh, mask_bf16;
  long long q_sn, q_sl, k_sn, k_sl, v_sn, v_sl;
  long long m_sn, m_sq, m_sk;
  float scale;
};

// additive mask term (1 - m) * -1e4 of query row qi against key kj
__device__ __forceinline__ float mask_add(const void* mask, const Args& a,
                                          long long n, int qi, int kj) {
  const long long off = n * a.m_sn + qi * a.m_sq + kj * a.m_sk;
  const float m =
      a.mask_bf16
          ? __uint_as_float(static_cast<unsigned>(__ldg(
                static_cast<const unsigned short*>(mask) + off)) << 16)
          : __ldg(static_cast<const float*>(mask) + off);
  return (1.f - m) * -10000.f;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// a probability as the plain version hands it to p.v: cast to v's type
__device__ __forceinline__ float as_value_type(float p, float) { return p; }
__device__ __forceinline__ float as_value_type(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ------------------------------------------------------------------------
// mbarrier, bulk copy and tensor-core primitives (inline PTX)
// ------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing as transaction bytes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value; x - big is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b to about f32 accuracy: the two cross terms before big.big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of m16n8k16 from a row-major (key, d) tile: keys k0..k0+15
// (row pointers from lanes 0-15), columns d0..d0+7, transposed on load
__device__ __forceinline__ void ldmatrix_x2_trans(const void* row_ptr,
                                                  uint32_t& b0, uint32_t& b1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(row_ptr)));
}

// ------------------------------------------------------------------------
// tile path
// ------------------------------------------------------------------------

constexpr int kMaskPitch = kBN + 8;  // floats a row of additive mask terms

// The ring as a call needs it: no more stages than key tiles, and rows
// for Lk rounded up to 16 when Lk is below one tile (the step encoder and
// the decoder then take a fraction of the shared memory, so more blocks
// share an SM).  Stage arithmetic stays modulo kStages: with one tile only
// stage 0 is touched.
struct Ring {
  int stages, rows;
  __host__ __device__ explicit Ring(int lk)
      : stages(min(kStages, (lk + kBN - 1) / kBN)),
        rows(min(kBN, (lk + 15) / 16 * 16)) {}
};

// K and V rings, the block's Q rows, per stage the tile's additive mask
// terms (one row for a key-padding mask, one per query row for a full
// one), then the ring's full and empty barriers and Q's barrier
template <typename T, int kD>  // kD: head width padded to 64 or 128
struct TileSmem {
  static constexpr int kPitch = kD + 16 / sizeof(T);  // elements a row
  static size_t bytes(const Ring& ring, int q_rows, int mask_rows) {
    return (2 * ring.stages * ring.rows + q_rows) * kPitch * sizeof(T) +
           ring.stages * mask_rows * kMaskPitch * sizeof(float) +
           (2 * kStages + 1) * sizeof(uint64_t);
  }
};

template <typename T, int kD>
__global__ void __launch_bounds__((kMaxConsumers + 1) * 32, kD <= 64 ? 2 : 1)
    tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const void* __restrict__ mask,
                T* __restrict__ out, Args a) {
  using S = TileSmem<T, kD>;
  constexpr int P = S::kPitch;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kKQ = kF32 ? kD / 8 : kD / 16;  // MMA steps over dh
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int consumers = (blockDim.x >> 5) - 1;  // the last warp produces
  const int rows = consumers * 16;
  const int mask_rows = a.m_sq ? rows : 1;
  const Ring ring(a.lk);
  // two stages hold 64 rows each; one stage may hold fewer: the stride
  // between stages stays kBN rows
  const int kv_rows = ring.stages * ring.rows;
  T* k_s = reinterpret_cast<T*>(smem_raw);  // ring.stages x ring.rows x P
  T* v_s = k_s + kv_rows * P;               // ring.stages x ring.rows x P
  T* q_s = v_s + kv_rows * P;               // rows x P
  float* m_s = reinterpret_cast<float*>(q_s + rows * P);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      m_s + ring.stages * mask_rows * kMaskPitch);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int h = blockIdx.y;
  const long long n = blockIdx.z;
  const int q0 = blockIdx.x * rows;
  // warps whose 16 rows all lie beyond Lq take no part
  const int active = min(consumers, (a.lq - q0 + 15) / 16);
  const int tiles = (a.lk + kBN - 1) / kBN;
  // bf16 over several tiles: a first pass over K finds each row's max and
  // sum, so that the second forms p normalised and rounds it where the
  // plain version rounds it (see the header)
  const bool two_pass = !kF32 && tiles > 1;
  const int steps = two_pass ? 2 * tiles : tiles;  // ring fills
  if (active <= 0) return;  // the whole block lies beyond Lq

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes
      mbar_init(&empty[s], active);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (a.dh < kD) {  // padded head columns: the copies never write them
    const int pad = kD - a.dh;
    for (int i = threadIdx.x; i < (2 * kv_rows + rows) * pad;
         i += blockDim.x)
      k_s[(i / pad) * P + a.dh + i % pad] = static_cast<T>(0.f);
  }
  __syncthreads();

  if (warp == consumers) {
    // producer: the Q rows once, then per tile one bulk copy a K or V row
    // and the tile's mask terms
    const uint32_t row_bytes = a.dh * sizeof(T);
    const T* qb = q + n * a.q_sn + (long long)h * a.dh;
    const T* kb = k + n * a.k_sn + (long long)h * a.dh;
    const T* vb = v + n * a.v_sn + (long long)h * a.dh;
    if (lane == 0) mbar_arrive_expect_tx(q_bar, active * 16 * row_bytes);
    __syncwarp();
    for (int r = lane; r < active * 16; r += 32) {
      // rows past Lq repeat the last row: finite, and never stored
      const long long qi = min(q0 + r, a.lq - 1);
      bulk_copy(q_s + r * P, qb + qi * a.q_sl, row_bytes, q_bar);
    }
    for (int u = 0; u < steps; ++u) {
      const int t = u < tiles ? u : u - tiles, s = u % kStages;
      const bool with_v = u >= steps - tiles;  // not in a first pass
      // the rows of the 16-key blocks that hold a key < Lk (the consumers
      // skip 8-key blocks past Lk; bf16's p.v steps over 16 keys); rows
      // past Lk repeat the last key: finite, and excluded by their mask
      // terms
      const int nrows = min(kBN, (a.lk - t * kBN + 15) / 16 * 16);
      if (u >= kStages) mbar_wait(&empty[s], ((u / kStages) - 1) & 1);
      if (lane == 0)
        mbar_expect_tx(&full[s], (with_v ? 2 : 1) * nrows * row_bytes);
      __syncwarp();
      for (int r = lane; r < nrows; r += 32) {
        const long long key = min(t * kBN + r, a.lk - 1);
        bulk_copy(k_s + (s * kBN + r) * P, kb + key * a.k_sl, row_bytes,
                  &full[s]);
        if (with_v)
          bulk_copy(v_s + (s * kBN + r) * P, vb + key * a.v_sl, row_bytes,
                    &full[s]);
      }
      if (!a.m_sq) {  // a key-padding mask's row; a full mask: below
        float* ms = m_s + s * kMaskPitch;
        for (int j = lane; j < kBN; j += 32) {
          const int key = t * kBN + j;
          ms[j] = key < a.lk ? mask_add(mask, a, n, 0, key) : -INFINITY;
        }
      }
      mbar_arrive(&full[s]);  // each lane after its own stores
    }
    return;
  }
  if (warp >= active) return;

  // consumer: rows g and g + 8 of the warp's 16, as the m16n8 fragments
  // lay them out (g = lane / 4, t4 = lane % 4)
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16 + g;  // the lane's first row in the block
  // the rows' mask terms within a stage (row 0 for a key-padding mask)
  const int mo0 = a.m_sq ? wr * kMaskPitch : 0;
  const int mo1 = a.m_sq ? mo0 + 8 * kMaskPitch : 0;
  const T* qs0 = q_s + wr * P;
  const T* qs1 = qs0 + 8 * P;

  float o[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float i0 = 1.f, i1 = 1.f;  // 1 / the row sums, once they are final
  const auto final_sums = [&]() {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, off);
      l1 += __shfl_xor_sync(kFull, l1, off);
    }
    i0 = 1.f / fmaxf(l0, 1e-30f);
    i1 = 1.f / fmaxf(l1, 1e-30f);
  };
  // p is normalised before p.v, as the plain version does, so that a bf16
  // p is rounded where it is there: with one tile, and in two passes
  const bool normalised = tiles == 1 || two_pass;
  mbar_wait(q_bar, 0);

  for (int u = 0; u < steps; ++u) {
    const int t = u < tiles ? u : u - tiles, s = u % kStages;
    const bool pv = u >= steps - tiles;  // a first pass forms no p.v
    // 8-key blocks wholly past Lk are skipped (their mask terms are -inf)
    const int jn = min(kBN / 8, (a.lk - t * kBN + 7) / 8);
    if (a.m_sq) {
      // a full mask: the warp stages the terms of its own 16 rows, all
      // loads in flight at once; the slot was last read by this warp
      float* mw = m_s + (s * mask_rows + warp * 16) * kMaskPitch;
#pragma unroll 8
      for (int i = lane; i < 16 * kBN; i += 32) {
        const int r = i / kBN, j = i % kBN, key = t * kBN + j;
        mw[r * kMaskPitch + j] =
            key < a.lk
                ? mask_add(mask, a, n, min(q0 + warp * 16 + r, a.lq - 1), key)
                : -INFINITY;
      }
      __syncwarp();
    }
    mbar_wait(&full[s], (u / kStages) & 1);
    const T* ks = k_s + s * kBN * P;
    const T* vs = v_s + s * kBN * P;

    // S = Q K^T: 16 rows x 64 keys, n-tile j holds keys 8j..8j+7
    float sc[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kKQ; ++kk) {
      if constexpr (kF32) {
        uint32_t ab[4], as[4];
        const int c = kk * 8 + t4;
        split_tf32(qs0[c], ab[0], as[0]);
        split_tf32(qs1[c], ab[1], as[1]);
        split_tf32(qs0[c + 4], ab[2], as[2]);
        split_tf32(qs1[c + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          if (j < jn) {
            const float* kr = ks + (j * 8 + g) * P + c;
            uint32_t bb[2], bs[2];
            split_tf32(kr[0], bb[0], bs[0]);
            split_tf32(kr[4], bb[1], bs[1]);
            mma_3xtf32(sc[j], ab, as, bb, bs);
          }
        }
      } else {
        const int c = kk * 16 + 2 * t4;
        const uint32_t qa[4] = {*reinterpret_cast<const uint32_t*>(qs0 + c),
                                *reinterpret_cast<const uint32_t*>(qs1 + c),
                                *reinterpret_cast<const uint32_t*>(qs0 + c + 8),
                                *reinterpret_cast<const uint32_t*>(qs1 + c + 8)};
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          if (j < jn) {
            const T* kr = ks + (j * 8 + g) * P + c;
            mma_bf16(sc[j], qa, *reinterpret_cast<const uint32_t*>(kr),
                     *reinterpret_cast<const uint32_t*>(kr + 8));
          }
        }
      }
    }

    // scale, add the mask terms (-inf past Lk); online softmax per row
    const float* ms = m_s + s * mask_rows * kMaskPitch + 2 * t4;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 add0 = *reinterpret_cast<const float2*>(ms + mo0 + j * 8);
      const float2 add1 = *reinterpret_cast<const float2*>(ms + mo1 + j * 8);
      sc[j][0] = sc[j][0] * a.scale + add0.x;
      sc[j][1] = sc[j][1] * a.scale + add0.y;
      sc[j][2] = sc[j][2] * a.scale + add1.x;
      sc[j][3] = sc[j][3] * a.scale + add1.y;
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    if (two_pass && pv) {
      // the second pass: the row max and sum are final
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[j][c] = expf(sc[j][c] - m0) * i0;
          sc[j][2 + c] = expf(sc[j][2 + c] - m1) * i1;
        }
      }
    } else {
      // a row's 64 scores sit in the 4 lanes of a quad; key t*kBN < Lk is
      // among them, so the maxima are finite
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;  // this lane's part of the row sums
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[j][c] = expf(sc[j][c] - m0);
          sc[j][2 + c] = expf(sc[j][2 + c] - m1);
          rs0 += sc[j][c];
          rs1 += sc[j][2 + c];
        }
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
      if (normalised && u == tiles - 1) {
        final_sums();  // the last tile of the (first) pass
        if (pv) {      // one tile
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            sc[j][0] *= i0;
            sc[j][1] *= i0;
            sc[j][2] *= i1;
            sc[j][3] *= i1;
          }
        }
      }
#pragma unroll
      for (int d = 0; d < kD / 8; ++d) {
        o[d][0] *= al0;
        o[d][1] *= al0;
        o[d][2] *= al1;
        o[d][3] *= al1;
      }
    }

    // O += P V (not in a first pass)
    if (pv) {
      if constexpr (kF32) {
        // k-index t carries key 2t and t+4 key 2t+1 (see the header)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          if (j < jn) {
            uint32_t pb[4], ps[4];
            split_tf32(sc[j][0], pb[0], ps[0]);
            split_tf32(sc[j][2], pb[1], ps[1]);
            split_tf32(sc[j][1], pb[2], ps[2]);
            split_tf32(sc[j][3], pb[3], ps[3]);
            const float* vr = vs + (j * 8 + 2 * t4) * P + g;
#pragma unroll
            for (int d = 0; d < kD / 8; ++d) {
              uint32_t bb[2], bs[2];
              split_tf32(vr[d * 8], bb[0], bs[0]);
              split_tf32(vr[P + d * 8], bb[1], bs[1]);
              mma_3xtf32(o[d], pb, ps, bb, bs);
            }
          }
        }
      } else {
        // the S accumulator of n-tiles 2jj, 2jj+1 is the A operand as is
#pragma unroll
        for (int jj = 0; jj < kBN / 16; ++jj) {
          if (2 * jj < jn) {
            const uint32_t pa[4] = {
                pack_bf16x2(sc[2 * jj][0], sc[2 * jj][1]),
                pack_bf16x2(sc[2 * jj][2], sc[2 * jj][3]),
                pack_bf16x2(sc[2 * jj + 1][0], sc[2 * jj + 1][1]),
                pack_bf16x2(sc[2 * jj + 1][2], sc[2 * jj + 1][3])};
            const T* vr = vs + (jj * 16 + (lane & 15)) * P;
#pragma unroll
            for (int d = 0; d < kD / 8; ++d) {
              uint32_t b0, b1;
              ldmatrix_x2_trans(vr + d * 8, b0, b1);
              mma_bf16(o[d], pa, b0, b1);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // stage s may be refilled
  }

  if (normalised)
    i0 = i1 = 1.f;
  else
    final_sums();
  const int r0 = q0 + wr, r1 = r0 + 8;
  const long long H = (long long)a.nh * a.dh;
  T* ob = out + n * a.lq * H + (long long)h * a.dh;
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) {
    const int c = d * 8 + 2 * t4;
    if (c < a.dh) {  // dh % 4 == 0: columns c and c + 1 together
      if (r0 < a.lq) store2(ob + r0 * H + c, o[d][0] * i0, o[d][1] * i0);
      if (r1 < a.lq) store2(ob + r1 * H + c, o[d][2] * i1, o[d][3] * i1);
    }
  }
}

// ------------------------------------------------------------------------
// decode path
// ------------------------------------------------------------------------

// 4 consecutive elements: one 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 as_float4(float4 x) { return x; }
__device__ __forceinline__ float4 as_float4(uint2 x) {
  const float2 lo = bf16x2_to_float2(x.x), hi = bf16x2_to_float2(x.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
using Raw4 = decltype(load4(static_cast<const T*>(nullptr)));

template <int kLPK>  // lanes a key: sum over them
__device__ __forceinline__ float key_sum(float x) {
#pragma unroll
  for (int off = kLPK / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int kLPK>  // combine the 32 / kLPK key groups of the warp
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kLPK; off < 32; off <<= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int kLPK>
__global__ void __launch_bounds__(256)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const void* __restrict__ mask,
                  T* __restrict__ out, Args a) {
  constexpr int kKPI = 32 / kLPK;               // keys a load instruction
  constexpr int kChunk = kChunkLoads<T> * kKPI;    // keys a round trip
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= (long long)a.n * a.nh * a.lq) return;
  // warps of a block: query rows, then heads, of one sequence
  const int qi = static_cast<int>(w % a.lq);
  const int h = static_cast<int>((w / a.lq) % a.nh);
  const long long n = w / ((long long)a.lq * a.nh);
  const int grp = lane / kLPK, col = (lane % kLPK) * 4;
  const bool col_ok = col < a.dh;
  const long long hoff = (long long)h * a.dh + col;

  const float4 qv = col_ok ? as_float4(load4(q + n * a.q_sn + qi * a.q_sl +
                                             hoff))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  const T* kb = k + n * a.k_sn + hoff;
  const T* vb = v + n * a.v_sn + hoff;
  // p is normalised before p.v, as in the tile path: when the keys fit
  // one chunk, and in bf16 over several chunks in two passes (a first
  // over K finds the max and the sum)
  const bool one_chunk = a.lk <= kChunk;
  const bool two_pass = !std::is_same<T, float>::value && !one_chunk;
  float m_run = -INFINITY, l_run = 0.f, inv_l = 1.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int pass = two_pass ? 0 : 1; pass < 2; ++pass) {
    for (int k0 = 0; k0 < a.lk; k0 += kChunk) {
      Raw4<T> kr[kChunkLoads<T>], vr[kChunkLoads<T>];
      float s[kChunkLoads<T>];
      // every K load, then every V load and mask value, before arithmetic
#pragma unroll
      for (int i = 0; i < kChunkLoads<T>; ++i) {
        const int key = k0 + i * kKPI + grp;
        kr[i] = (key < a.lk && col_ok) ? load4(kb + key * a.k_sl) : Raw4<T>{};
      }
#pragma unroll
      for (int i = 0; i < kChunkLoads<T>; ++i) {
        const int key = k0 + i * kKPI + grp;
        vr[i] = (pass && key < a.lk && col_ok) ? load4(vb + key * a.v_sl)
                                               : Raw4<T>{};
        s[i] = key < a.lk ? mask_add(mask, a, n, qi, key) : 0.f;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kChunkLoads<T>; ++i) {
        const float4 kk = as_float4(kr[i]);
        float dot = qv.x * kk.x;
        dot = fmaf(qv.y, kk.y, dot);
        dot = fmaf(qv.z, kk.z, dot);
        dot = fmaf(qv.w, kk.w, dot);
        dot = key_sum<kLPK>(dot);
        s[i] = k0 + i * kKPI + grp < a.lk ? dot * a.scale + s[i] : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      if (two_pass && pass) {  // the second pass: max and sum are final
#pragma unroll
        for (int i = 0; i < kChunkLoads<T>; ++i)
          s[i] = as_value_type(expf(s[i] - m_run) * inv_l, T{});
      } else {
#pragma unroll
        for (int off = kLPK; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        // key k0 < Lk is in the chunk, so mx is finite
        const float m_new = fmaxf(m_run, mx);
        const float alpha = expf(m_run - m_new);
        m_run = m_new;
        acc.x *= alpha;
        acc.y *= alpha;
        acc.z *= alpha;
        acc.w *= alpha;
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < kChunkLoads<T>; ++i) {
          s[i] = expf(s[i] - m_new);
          psum += s[i];
        }
        l_run = l_run * alpha + psum;
        if (one_chunk) {
          const float l = fmaxf(group_sum<kLPK>(l_run), 1e-30f);
#pragma unroll
          for (int i = 0; i < kChunkLoads<T>; ++i)
            s[i] = as_value_type(s[i] / l, T{});
        }
      }
      if (pass) {
#pragma unroll
        for (int i = 0; i < kChunkLoads<T>; ++i) {
          const float p = s[i];
          const float4 vv = as_float4(vr[i]);
          acc.x = fmaf(p, vv.x, acc.x);
          acc.y = fmaf(p, vv.y, acc.y);
          acc.z = fmaf(p, vv.z, acc.z);
          acc.w = fmaf(p, vv.w, acc.w);
        }
      }
    }
    if (!pass) inv_l = 1.f / fmaxf(group_sum<kLPK>(l_run), 1e-30f);
  }

  // each key group summed its own keys (every lane of a group holds the
  // same p, so l_run is the group's sum): add the groups
  const float l = one_chunk || two_pass
                      ? 1.f
                      : fmaxf(group_sum<kLPK>(l_run), 1e-30f);
  acc.x = group_sum<kLPK>(acc.x);
  acc.y = group_sum<kLPK>(acc.y);
  acc.z = group_sum<kLPK>(acc.z);
  acc.w = group_sum<kLPK>(acc.w);
  if (grp == 0 && col_ok) {
    T* orow = out + (n * a.lq + qi) * a.nh * a.dh + hoff;
    store2(orow, acc.x / l, acc.y / l);
    store2(orow + 2, acc.z / l, acc.w / l);
  }
}

// ------------------------------------------------------------------------
// launch
// ------------------------------------------------------------------------

template <typename T, int kD>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const void* mask, void* out, const Args& a,
                        int blocks, int warps, cudaStream_t stream) {
  using S = TileSmem<T, kD>;
  const size_t bytes =
      S::bytes(Ring(a.lk), warps * 16, a.m_sq ? warps * 16 : 1);
  // above 48 KB needs the opt-in: raised to the largest call so far, so a
  // call past the card's limit (227 KB a block on the H100) fails here
  static size_t opt_in = 48 * 1024;
  if (bytes > opt_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next call's check
      return err;
    }
    opt_in = bytes;
  }
  tile_kernel<T, kD><<<dim3(blocks, a.nh, a.n), (warps + 1) * 32, bytes,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T, int kLPK>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* mask, void* out, const Args& a,
                          int blocks, int warps, cudaStream_t stream) {
  decode_kernel<T, kLPK><<<blocks, warps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, const Args& a, int path,
                   int blocks, int warps, cudaStream_t stream) {
  if (path == 0) {
    if ((long long)blocks * warps * 16 < a.lq || warps > kMaxConsumers ||
        (sizeof(T) == 2 && (a.dh & 7)))  // a bf16 row: whole 16 bytes
      return cudaErrorInvalidValue;
    return a.dh <= 64
               ? launch_tile<T, 64>(q, k, v, mask, out, a, blocks, warps,
                                    stream)
               : launch_tile<T, 128>(q, k, v, mask, out, a, blocks, warps,
                                     stream);
  }
  if ((long long)blocks * warps < (long long)a.n * a.nh * a.lq || warps > 8)
    return cudaErrorInvalidValue;
  const int lanes = a.dh / 4;  // lanes a key holds
  if (lanes <= 8)
    return launch_decode<T, 8>(q, k, v, mask, out, a, blocks, warps, stream);
  if (lanes <= 16)
    return launch_decode<T, 16>(q, k, v, mask, out, a, blocks, warps, stream);
  return launch_decode<T, 32>(q, k, v, mask, out, a, blocks, warps, stream);
}

}  // namespace

// dtype / mask_dtype: 0 = float32, 1 = bfloat16.  path: 0 = tile (grid
// blocks x nh x n, warps consumer warps + 1 producer), 1 = decode (grid
// blocks, warps warps a block); ops/attention.py::_plan chooses them.
// Returns the cudaGetLastError() code after the launch (0 = launched); the
// caller checks shapes, strides, alignment and devices before calling.
extern "C" int svpc_fused_attention(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    int dtype, int mask_dtype, int n, int lq, int lk, int nh, int dh,
    long long q_sn, long long q_sl, long long k_sn, long long k_sl,
    long long v_sn, long long v_sl, long long m_sn, long long m_sq,
    long long m_sk, float scale, int path, int blocks, int warps,
    void* stream) {
  if (n <= 0 || lq <= 0 || lk <= 0 || nh <= 0 || dh <= 0 || dh > 128 ||
      (dh & 3) || n > 65535 || nh > 65535 || (path != 0 && path != 1) ||
      blocks <= 0 || warps <= 0 || (mask_dtype != 0 && mask_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{n,    lq,   lk,   nh,   dh,   mask_dtype, q_sn, q_sl,
               k_sn, k_sl, v_sn, v_sl, m_sn, m_sq,       m_sk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, mask, out, a, path, blocks, warps, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, mask, out, a, path, blocks, warps,
                                s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
