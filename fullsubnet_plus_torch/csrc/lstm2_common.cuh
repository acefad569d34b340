// Conversions, activations and the mma.sync helpers shared by the float
// LSTM kernels' sweeps (lstm2_fwd_sweep.cuh, lstm2_bwd_sweep.cuh). T is the
// weight type, float or __nv_bfloat16; arithmetic is float32 throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm2 {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v.astype(weight type), kept as a float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// An element's bits as a plain integer or float, so that a batch of loads
// can be issued before any of them is converted, and zero bits are 0.0.
template <typename T> struct Bits;
template <> struct Bits<float> {
  using type = float;
  static __device__ __forceinline__ float to_f(float v) { return v; }
};
template <> struct Bits<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float to_f(unsigned short v) {
    return __uint_as_float((unsigned)v << 16);
  }
};

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// The tensor-core sweeps' operand loads and products (mma.sync m16n8k16 for
// bf16, m16n8k8 for float32).

// Lane l gives the address of row l % 16, column 8 * (l / 16) of a 16 x 16
// bf16 tile; a[0..3] come back as mma.sync's A fragment of that tile. For a
// 16 x 8 float32 tile the same byte addresses (row l % 16, column 4 (l / 16))
// give m16n8k8's TF32 A fragment: each 8 x 8 b16 matrix is 8 x 4 float32.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The same four 8 x 8 bf16 matrices, each transposed on the way: lane l
// gives the address of row l % 8 of matrix l / 8, and a[i] comes back as
// {M_i[2 (l % 4)][l / 4], M_i[2 (l % 4) + 1][l / 4]}. For operands stored
// with the contraction index as the row (lstm2_bwd_wgrad.cu), this is
// mma.sync's A fragment and the col B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += A (16 x 16, row) B (16 x 8, col): bf16 products, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Float32 products on the tensor cores as three TF32 products of split
// operands (mma.sync m16n8k8). TF32 keeps 10 of float32's 23 mantissa bits,
// so one TF32 product loses the float32 agreement floors; a = big + small with
// big = a rounded to TF32 and small the remainder carries 22 bits, and
// small.big + big.small + big.big, each exact in float32, drops only
// small.small (about 2^-22 relative).
//
// a = big + small: big is a rounded to TF32, to nearest with ties away from
// zero (cvt.rna.tf32.f32's bits for every finite a: half of the 13 dropped
// bits added to the magnitude, then cleared); small, a - big (exact in
// float32), is rounded to TF32 the same way, as CUTLASS's 3xTF32 rounds both
// halves: half of its 13 dropped bits are added here, and the tensor core,
// which ignores a TF32 operand's low 13 bits, drops them. So the tensor
// core's small is within 2^-22 |a| of a - big, without bias (left for it to
// truncate, within 2^-21 and always toward zero; with that split the float32
// training check of chip_smoke.py phase 6 took the other branch, PERF.md).
// Three integer operations and a FADD: cvt.rna.tf32.f32 compiles to a longer
// guarded sequence on sm_90, and with it the float32 sweep took 126 ms
// instead of 92 at the batch fold on an H100 (PERF.md).
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& big, uint32_t& small) {
  big = (a + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(a) - __uint_as_float(big)) + 0x1000u;
}

// d += A (16 x 8, row) B (8 x 8, col): TF32 operands, float32 sums. Lane (g,
// t) = (lane / 4, lane % 4) holds a = {A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]}, b0 = B[t][g], b1 = B[t + 4][g]; d as in mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B over one k-step of 8 from split operands: the small terms first,
// then big.big, all into the float32 accumulators
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use (sm_90)

// A k-chunk: the 64 bytes of an operand row that one 16-byte B word a lane
// covers, two k-steps (of 16 bf16, of 8 float32). Both sweeps pack their
// weights in this unit (ops/lstm2.py: pack_mma_b, pack_tf32_b).
constexpr int CHUNK_BYTES = 64;

// elements of a k-chunk
template <typename T> __host__ __device__ constexpr int k_chunk() {
  return CHUNK_BYTES / (int)sizeof(T);
}

// One k-chunk of an m-tile's A operand, as the products read it (lane l
// gives the ldmatrix address of row l % 16, byte 16 (l / 16) of the chunk),
// and its products with one n-tile's B word (b: this lane's 16 bytes of the
// chunk).
template <typename T> struct AFrag;

template <> struct AFrag<__nv_bfloat16> {
  uint32_t r[2][4];  // k-steps of 16
  __device__ __forceinline__ void load(uint32_t addr) {
    ldmatrix_x4(r[0], addr);
    ldmatrix_x4(r[1], addr + 32);
  }
  __device__ __forceinline__ void mma(float (&d)[4], const uint4& b) const {
    mma_bf16(d, r[0], b.x, b.y);
    mma_bf16(d, r[1], b.z, b.w);
  }
};

template <> struct AFrag<float> {
  uint32_t big[2][4], small[2][4];  // k-steps of 8, split once for every n-tile
  __device__ __forceinline__ void load(uint32_t addr) {
    uint32_t r[2][4];
    ldmatrix_x4(r[0], addr);
    ldmatrix_x4(r[1], addr + 32);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(r[ks][i], big[ks][i], small[ks][i]);
  }
  // b = {b0, b1} of k-step 0, then of k-step 1. The chunk's six products
  // sum into a zeroed partial that one round-to-nearest FADD adds to d: the
  // tensor core truncates each sum at its accumulator's scale, and over the
  // 456 products of the forward's K 1216 sums that bias alone cost about
  // 25 dB (PERF.md).
  __device__ __forceinline__ void mma(float (&d)[4], const uint4& b) const {
    uint32_t bb[4], bs[4];
    split_tf32(b.x, bb[0], bs[0]);
    split_tf32(b.y, bb[1], bs[1]);
    split_tf32(b.z, bb[2], bs[2]);
    split_tf32(b.w, bb[3], bs[3]);
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_3xtf32(p, big[0], small[0], bb[0], bb[1], bs[0], bs[1]);
    mma_3xtf32(p, big[1], small[1], bb[2], bb[3], bs[2], bs[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += p[e];
  }
};

// The sweeps' cluster forms (lstm2_fwd_sweep.cuh, lstm2_bwd_sweep.cuh): a
// cluster of CTAs a row tile, each owning a slice of the hidden units, whose
// blocks are all-gathered through distributed shared memory by TMA bulk
// copies that complete on the receivers' mbarriers.

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_idx() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  return v;
}

// The cluster barrier, in halves: arrive (release: this thread's earlier
// shared-memory reads come first) and wait (acquire: every thread of the
// cluster has arrived).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_address(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival on the mbarrier, and `bytes` more for it to expect
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the mbarrier's phase of this parity has completed; a phase
// that never completes (a block that never arrives) traps, a CUDA error
// for the launch's caller, rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// `bytes` of this CTA's shared memory at `src` to `dst` in a peer's, by the
// Tensor Memory Accelerator, completing on the peer's mbarrier `bar` (dst
// and bar: shared::cluster addresses)
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// this thread's bulk copies issued since the last commit, as one bulk group
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read their source
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// this thread's generic-proxy writes to shared memory, visible to the bulk
// copies it or its block issue next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace lstm2
