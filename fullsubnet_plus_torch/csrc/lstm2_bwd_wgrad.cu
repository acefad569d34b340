// Reverse-sweep backward of the fused 2-layer LSTM with the weight
// gradients summed inside, for Hopper (sm_90a): the training step's
// backward where `fused_wgrad` (ops/lstm2_train.py) takes it.
//
// Replaces the TPU kernel `_make_bwd_kernel_fused` launched by `_train_bwd`
// with FUSED_WGRAD = True (fullsubnet_plus_tpu/ops/lstm_pallas.py:472, :695,
// pallas_call at :752). It yields dx [T, N, D] in x's type and, in float32,
//   dW1 [D, 4H] = sum_t x_t^T dg1_t        dU1 [H, 4H] = sum_t h1_{t-1}^T dg1_t
//   dW2 [H, 4H] = sum_t h1_t^T dg2_t       dU2 [H, 4H] = sum_t h2_{t-1}^T dg2_t
//   db1, db2 [4H] = sum over rows and steps of the UNROUNDED dgates
// where dg is the dgates rounded to the weight type, h_{-1} = 0, products
// are exact and sums float32. Its point is kept: no [T, N, 4H] array of
// dgates reaches device memory.
//
// What bounds it on the H100. At the training fold (N = 2304, D = 34,
// H = 384, O = 2, T = 195) it does 3.27 TFLOP (the sweep's 1.64 and as much
// again for the weight gradients) and must read the residuals and x
// ((12H + D) elements per row and step; h_{t-1} and c_{t-1} are the same
// arrays read again) and write dx: 8.4 GB in float32, 4.2 GB in bf16.
// Operations bound it in both types (19.9 ms of three TF32 products a
// product at the TF32 rate in float32 against 2.5 ms of bytes; 3.3 ms at
// the tensor cores' bf16 rate against 1.3 ms). Every product runs on the
// tensor cores in both types, in float32 as three TF32 products of split
// operands: the reverse sweep's three on mma.sync (lstm2_bwd_sweep.cuh says
// what bounds it: each CTA's step latency) and the four weight-gradient
// products, where a step has a slice of rows (the sub-band folds) on wgmma
// fed by TMA tensor maps, `wgrad_wgmma_kernel` in bf16 and
// `wgrad_wgmma_tf32_kernel` in float32, and elsewhere on mma.sync,
// `wgrad_mma_kernel` and `wgrad_tf32_kernel` (below).
//
// Design. The TPU kernel keeps all 7.3 MB of float32 accumulators resident
// and relies on its grid running in order; here CTAs run at once and have
// 227 KB each. So the work is cut in time, not in rows: the steps are swept
// in chunks of `chunk` steps, newest first. For each chunk
//   1. the sweep (lstm2_bwd_sweep.cuh, in the form the caller chooses:
//      `sweep_mma_kernel`, one CTA per row tile of 16, or in waves of a CTA
//      an SM over items of a tile and a few steps where the card does not
//      hold every tile at once, or at folds of a few tiles
//      `sweep_cluster_kernel`, a cluster of CTAs per tile) runs the
//      chunk's steps, reads and leaves the four carries in a [4][N][H]
//      float32 array, writes the chunk's rounded dgates into a scratch
//      [chunk, N, 4H] x 2 (reused by every chunk: its size does not grow
//      with T and is chosen to stay near the L2's size), and adds the tile's
//      unrounded dgates into its own row of db_part;
//   2. the weight-gradient kernel adds A^T dg of the chunk into the four
//      weight gradients, each output element owned by one thread that reads
//      it, adds the chunk's steps and rows in a fixed order, and writes it
//      back (the wgmma kernels: one owner for each run of row slices, into
//      that run's partial; see below).
// Then `db_reduce_kernel` sums the tiles' bias rows in tile order, and
// `wgmma_reduce_kernel` the runs' partials in run order. Kernels
// on one stream run in order and every sum has one owner and a fixed
// order, so the result is the same bit for bit on every run: no atomics.
//
// The C entry point launches on the caller's stream, allocates nothing
// (the caller passes outputs, zeroed weight gradients, scratch and carry
// arrays) and returns the first CUDA error.

#include "lstm2_bwd_sweep.cuh"
#include "lstm2_wgmma.cuh"

namespace {

template <typename T>
struct WgradArgs {
  const T* x;     // [T, N, x_cols<T>(D)], the pad columns zero
  const T* h1;    // [T, N, H]
  const T* h2;    // [T, N, H]
  const T* dg1;   // scratch [chunk, N, 4H]: step t at index t - t_lo
  const T* dg2;
  float* dw1;     // [D, 4H]
  float* du1;     // [H, 4H]
  float* dw2;     // [H, 4H]
  float* du2;     // [H, 4H]
  float* part;    // the wgmma kernels' partials of runs 1 .. SPLITS - 1 (run 0's is C)
  int n_rows, D, H;
  int t_hi, t_lo;
  int first;      // the call's first chunk: the wgmma kernels' sums start from zero
};

// The row pitch of x as the weight-gradient kernels read it: D rounded up
// to whole 16-byte copies (8 bf16, 4 float32); the wrapper pads x with
// zero columns to it.
template <typename T> __host__ __device__ constexpr int x_cols(int D) {
  return (D + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
}

// ---------------------------------------------------------------------------
// bf16: the weight gradients on the tensor cores
// ---------------------------------------------------------------------------
//
// `wgrad_mma_kernel`: C[k][c] += sum over the chunk's steps t (t_hi first)
// and rows n of A_t[n][k] G_t[n][c], every product on
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16 operands, float32 sums:
// the TPU kernel's `tdot` with preferred_element_type=f32, lstm_pallas.py
// :532-536, :555-556). At the training fold the four products are
// 2 N T (D + 3H) 4H = 1.64 TFLOP, 1.66 ms at the bf16 peak; their bytes
// (x, h1, h2 read once, the accumulators read and written once a chunk)
// take about 0.65 ms, so operations bound it.
//
// A CTA owns a tile of one gradient: rows k (of D or H) x gate columns c.
// The grid is one dimension: the tiles of dU1, dW2 and dU2 (shape SHAPE,
// wgrad_tile below; WGRAD_H_TILES in ops/lstm2_train.py) first, then dW1's
// tiles of W1_ROWS x W1_COLS (D = 34 padded to 48 = three m16 tiles, not to
// a whole tile). At the training fold the rule's 64 x 128 tiles make 216 +
// 24 = 240 CTAs, two resident on an SM (122 registers, 106 KB of shared
// memory each): 16 warps an SM. The contraction
// runs over slices of WG_BK rows n of one step (four k16 steps), t_hi first,
// n in order: a fixed order, so each sum is the same bit for bit on a
// repeat.
//   Staging: both operands stay bf16 and n-major in shared memory, A as
//   [n][k] and G as [n][c], copied by cp.async 16 bytes a thread into a ring
//   of WG_STAGES slices, so the next three slices load while one multiplies.
//   A row of the ring is padded by 8 bf16 (16 bytes), so the 8 rows an
//   ldmatrix phase reads fall in 8 different bank groups. Tails are zero
//   fill (cp.async with a source size of 0): rows n past N, columns past
//   the row's end, and h_{-1} at t = 0. x arrives padded to x_cols(D)
//   columns, so its rows are 16-byte aligned like h's.
//   Products: the contraction index is the row of both staged operands, so
//   the A fragment (rows k, columns n) and the col B fragment (rows n,
//   columns c) both come from ldmatrix .trans. Each warp owns a rectangle of
//   MI m16 x NI n8 tiles of C, its float32 accumulators in registers from
//   the read of C to the write back.
// The bytes through L2 per product fall as 1 / BM + 1 / BN: the tile shape
// trades them against the CTAs that fill the card's 132 SMs.
//
// What bounds it (H100, training fold; scripts/time_torch_wgrad_tiles.py on
// edited copies, PERF.md): at 128 x 128 the loads alone take 6.7 ms (25.6 GB
// of operand tiles through L2, 3.8 TB/s) and ldmatrix + mma alone 5.6 ms;
// together 10.2 ms, so the L2 traffic of the operand tiles bounds it and
// the products hide under it only in part. A deeper ring (6 slices) did not
// help; slices of 64 rows (half the barriers) gained 14 %; 64 x 128, with
// 50 % more L2 bytes but 16 warps an SM, was the fastest shape (9.0-9.4 ms),
// and 128 x 256 (a quarter fewer bytes, 78 CTAs) the slowest (15-17 ms).

constexpr int WG_THREADS = 256;  // 8 warps
constexpr int WG_BK = 64;        // contraction rows staged a slice: four k16 steps
constexpr int WG_STAGES = 4;     // slices in the cp.async ring
constexpr int WG_PAD = 8;        // bf16 pad of a staged row
constexpr int W1_ROWS = 48, W1_COLS = 64;  // dW1's tile (WGRAD_W1_TILE)

// The tiles of dU1, dW2, dU2: BM rows x BN gate columns, WM x WN warps,
// CTAs an SM must hold (WGRAD_H_TILES in ops/lstm2_train.py, same order).
template <int SHAPE> struct HTile;
template <> struct HTile<0> { static constexpr int BM = 64, BN = 128, WM = 2, WN = 4, CTAS = 2; };
template <> struct HTile<1> { static constexpr int BM = 128, BN = 128, WM = 2, WN = 4, CTAS = 1; };
// shapes H_MMA_TILES .. H_TILES - 1 are `wgrad_wgmma_kernel`'s (WgmmaTile below)
constexpr int H_MMA_TILES = 2, H_TILES = 3;

// The tile of dU1, dW2 and dU2 at (D, H) on a fold of n_rows rows:
// `wgrad_tiles` in ops/lstm2_train.py (the wgmma kernel's 128 x 256 in two
// runs, measured faster at the sub-band and the full-band training folds).
inline int wgrad_tile(int D, int H, int n_rows) {
  (void)D, (void)H, (void)n_rows;
  return 2;
}

// -1: the rule above; otherwise the shape every launch takes (timing only)
int g_forced_tile = -1;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int BM, int BN>
constexpr int wgrad_smem_bytes() {
  return WG_STAGES * WG_BK * (BM + WG_PAD + BN + WG_PAD) * 2;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// C[k0 .. k0 + BM)[c0 .. c0 + BN) of gradient `which` (0 dW1, 1 dU1, 2 dW2,
// 3 dU2) += the chunk's A^T G, as described above.
template <int BM, int BN, int WM, int WN>
__device__ __forceinline__ void wgrad_mma_tile(const WgradArgs<__nv_bfloat16>& a, int which,
                                               int k0, int c0, uint32_t smem) {
  using bf16 = __nv_bfloat16;
  constexpr int MI = BM / WM / 16, NI = BN / WN / 8;  // a warp's m16 and n8 tiles
  static_assert(MI >= 1 && NI % 2 == 0 && WM * WN <= WG_THREADS / 32, "warp tiling");
  constexpr int LDA = BM + WG_PAD, LDG = BN + WG_PAD;  // staged row pitch, bf16
  constexpr int STAGE_BYTES = WG_BK * (LDA + LDG) * 2;
  constexpr int A_COPIES = WG_BK * BM / 8, G_COPIES = WG_BK * BN / 8;  // 16-byte copies a slice
  const int G = 4 * a.H;
  const int K = which == 0 ? a.D : a.H;                   // live rows of C
  const int lda = which == 0 ? x_cols<bf16>(a.D) : a.H;  // row pitch of A in device memory
  const bf16* A = which == 0 ? a.x : (which == 3 ? a.h2 : a.h1);
  const int shift = (which == 1 || which == 3) ? 1 : 0;  // reads h of step t - 1
  const bf16* Gm = which < 2 ? a.dg1 : a.dg2;
  float* C = which == 0 ? a.dw1 : (which == 1 ? a.du1 : (which == 2 ? a.dw2 : a.du2));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp - (warp / WN) * WN;
  const int m0 = wm * MI * 16, n0 = wn * NI * 8;  // the warp's rectangle in the tile
  const bool live = warp < WM * WN && k0 + m0 < K && c0 + n0 < G;
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // accumulator rows fr, fr + 8; columns fc, fc + 1

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + m0 + 16 * i + fr + 8 * h, c = c0 + n0 + 8 * j + fc;
        float2 v = make_float2(0.0f, 0.0f);
        if (live && k < K && c < G) v = *reinterpret_cast<const float2*>(C + (size_t)k * G + c);
        acc[i][j][2 * h] = v.x;
        acc[i][j][2 * h + 1] = v.y;
      }

  const int row_slices = (a.n_rows + WG_BK - 1) / WG_BK;
  const int slices = (a.t_hi - a.t_lo + 1) * row_slices;
  auto load = [&](int slice) {
    const int t = a.t_hi - slice / row_slices, nb = (slice % row_slices) * WG_BK;
    const bool a_live = !(shift && t == 0);  // h_{-1} = 0
    const bf16* At = A + (size_t)(a_live ? t - shift : 0) * a.n_rows * lda;
    const bf16* Gt = Gm + (size_t)(t - a.t_lo) * a.n_rows * G;
    const uint32_t as = smem + (slice % WG_STAGES) * STAGE_BYTES, gs = as + WG_BK * LDA * 2;
#pragma unroll
    for (int e = 0; e < cdiv(A_COPIES, WG_THREADS); ++e) {
      const int idx = tid + e * WG_THREADS;
      if (A_COPIES % WG_THREADS != 0 && idx >= A_COPIES) break;
      const int r = idx / (BM / 8), kk = 8 * (idx % (BM / 8)), n = nb + r;
      const bool ok = a_live && n < a.n_rows && k0 + kk < lda;
      cp_async16(as + (r * LDA + kk) * 2, ok ? At + (size_t)n * lda + k0 + kk : A, ok);
    }
#pragma unroll
    for (int e = 0; e < cdiv(G_COPIES, WG_THREADS); ++e) {
      const int idx = tid + e * WG_THREADS;
      if (G_COPIES % WG_THREADS != 0 && idx >= G_COPIES) break;
      const int r = idx / (BN / 8), cc = 8 * (idx % (BN / 8)), n = nb + r;
      const bool ok = n < a.n_rows && c0 + cc < G;
      cp_async16(gs + (r * LDG + cc) * 2, ok ? Gt + (size_t)n * G + c0 + cc : Gm, ok);
    }
  };

  // this lane's ldmatrix rows: A's matrices are (n 0-7 | 8-15) x (k 0-7 | 8-15)
  // with n the slower; G's are (n 0-7 | 8-15) x (c 0-7 | 8-15) with c the slower
  const int a_row = (lane & 7) + 8 * (lane >> 4), a_col = m0 + 8 * ((lane >> 3) & 1);
  const int g_row = (lane & 7) + 8 * ((lane >> 3) & 1), g_col = n0 + 8 * (lane >> 4);

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<WG_STAGES - 2>();  // slice s has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; slice s - 1's buffer is free
    if (s + WG_STAGES - 1 < slices) load(s + WG_STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const uint32_t as = smem + (s % WG_STAGES) * STAGE_BYTES, gs = as + WG_BK * LDA * 2;
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        lstm2::ldmatrix_x4_trans(af[i], as + ((16 * ks + a_row) * LDA + a_col + 16 * i) * 2);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t r[4];
        lstm2::ldmatrix_x4_trans(r, gs + ((16 * ks + g_row) * LDG + g_col + 16 * j) * 2);
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) lstm2::mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + m0 + 16 * i + fr + 8 * h, c = c0 + n0 + 8 * j + fc;
        if (live && k < K && c < G)
          *reinterpret_cast<float2*>(C + (size_t)k * G + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

template <int SHAPE>
__global__ void __launch_bounds__(WG_THREADS, HTile<SHAPE>::CTAS)
wgrad_mma_kernel(const WgradArgs<__nv_bfloat16> a) {
  using S = HTile<SHAPE>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t smem = (uint32_t)__cvta_generic_to_shared(wg_smem);
  const int G = 4 * a.H;
  const int h_rows = cdiv(a.H, S::BM), h_cols = cdiv(G, S::BN), h_blocks = 3 * h_rows * h_cols;
  int b = blockIdx.x;
  if (b < h_blocks) {
    const int which = 1 + b / (h_rows * h_cols);
    b -= (which - 1) * h_rows * h_cols;
    wgrad_mma_tile<S::BM, S::BN, S::WM, S::WN>(a, which, (b / h_cols) * S::BM,
                                               (b % h_cols) * S::BN, smem);
  } else {
    b -= h_blocks;
    const int w1_cols = cdiv(G, W1_COLS);
    wgrad_mma_tile<W1_ROWS, W1_COLS, 3, 2>(a, 0, (b / w1_cols) * W1_ROWS, (b % w1_cols) * W1_COLS,
                                           smem);
  }
}

template <int SHAPE>
int launch_wgrad_mma(const WgradArgs<__nv_bfloat16>& w, cudaStream_t stream) {
  using S = HTile<SHAPE>;
  constexpr int smem_h = wgrad_smem_bytes<S::BM, S::BN>();
  constexpr int smem_w1 = wgrad_smem_bytes<W1_ROWS, W1_COLS>();
  constexpr int smem = smem_h > smem_w1 ? smem_h : smem_w1;
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_mma_kernel<SHAPE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int G = 4 * w.H;
  const int blocks = 3 * cdiv(w.H, S::BM) * cdiv(G, S::BN) + cdiv(w.D, W1_ROWS) * cdiv(G, W1_COLS);
  wgrad_mma_kernel<SHAPE><<<blocks, WG_THREADS, smem, stream>>>(w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the weight gradients on the tensor cores as 3xTF32
// ---------------------------------------------------------------------------
//
// `wgrad_tf32_kernel`: the same sums as `wgrad_mma_kernel` from float32
// operands, every product on mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 as
// three TF32 products of split operands (lstm2::split_tf32, mma_3xtf32:
// small.big + big.small + big.big, each exact in float32; only small.small,
// about 2^-22 of a product, is dropped), float32 sums. The products are
// 2 N T (D + 3H) 4H = 1.64 TFLOP at the training fold, three TF32 products
// each: 9.9 ms at the TF32 peak.
//
// Its structure is `wgrad_mma_kernel`'s: a CTA owns a tile of one gradient
// (the tiles of dU1, dW2 and dU2 first, then dW1's W1_ROWS x W1_COLS), a
// ring of contraction slices of BK rows n of one step, t_hi first, n in
// order, each warp a rectangle of MI m16 x NI n8 tiles of C whose float32
// sums stay in registers from the read of C to the write back. What float32
// changes:
//   Staging: A [n][k] and G [n][c] stay float32 and n-major; x arrives
//   padded to x_cols(D) columns (D 34 to 36, 257 to 260), so every row is
//   16-byte aligned. A staged row is padded to a pitch of 8 (mod 32) words
//   (f32_pitch: 72 for 48 and 64 columns, 136 for 128), which makes each
//   fragment load free of bank conflicts. A slice reaches the ring in one
//   of two ways (F32Tile::BULK): cp.async, 16 bytes a thread with zero fill
//   (a source size of 0) for rows past N, h_{-1} and columns past the row;
//   or bulk copies by the Tensor Memory Accelerator, one thread a row of A
//   and one a row of G, completing on the slot's mbarrier, the zero rows
//   and columns copied from a zero row in device memory.
//   Fragments: ldmatrix moves b16 only, so each lane (g, t) = (lane / 4,
//   lane % 4) loads its words with 32-bit shared loads: A's m16n8k8 TF32
//   fragment of m-tile i at k-step ks is As[8 ks + t][m + g], As[8 ks +
//   t][m + g + 8], As[8 ks + t + 4][m + g], As[8 ks + t + 4][m + g + 8]
//   (row k of C is the row of A, the contraction index n its column), and
//   the col B fragment of n-tile j is Gs[8 ks + t][c + g], Gs[8 ks + t +
//   4][c + g]: lanes read word 8 t + g (mod 32) of their row pair, 32
//   banks. Each word is split once after its load and serves the warp's NI
//   (A) or MI (B) products.
//   Sums: the tensor core truncates its float32 accumulation, so each
//   slice's products (3 BK / 8 mma.sync a tile of C) go into a zeroed
//   partial that one round-to-nearest FADD adds to the running sum, as the
//   sweeps do (lstm2_common.cuh, AFrag<float>, where the truncation alone
//   cost about 25 dB).
// Every element of C has one owner that adds its steps and rows in a fixed
// order, so K3 stays equal to itself on a repeat, as in bf16; a slice never
// spans two steps, so the weight gradients are the same bits at any chunk.
//
// What bounds it (H100, training fold; PERF.md, scripts/time_torch_wgrad_
// tiles.py and, on edited copies, scripts/profile_torch_wgrad_f32.py): each
// of the three TF32 passes cost about 7.7 ms, so mma.sync's TF32 products
// ran at about half the tensor cores' TF32 peak (which needs wgmma), and
// the 108 128 x 128 tiles of dU1, dW2, dU2 leave 24 of the 132 SMs with
// dW1's small tiles: the products alone take about 23 ms.
// With cp.async staging the kernel took 33.7 ms (the copies added about 8,
// the splits about 5: little of either ran under the products); bulk copies
// take the copies off the threads: 28.2 ms. The tile rule (`wgrad_f32_tile`,
// `wgrad_tiles` in ops/lstm2_train.py): 128 x 128, 64-row slices, bulk
// copies (the other candidates took 31.6-37.6 ms; accumulators in shared
// memory, 16 warps a CTA, or the three products issued kind by kind over
// the warp's tiles took as long or longer); but where a step has fewer than
// 64 rows (FullSubNet's full-band fold, N 18) most of a slice is zero rows,
// which cp.async fills without reading memory: 128 x 128 with 32-row slices
// there, 1.05 ms against 8.9 with bulk copies.

// The float32 tiles of dU1, dW2 and dU2: BM rows x BN gate columns, BK
// contraction rows a slice, WM x WN warps (dW1's 48 x 64 tile takes 3 x 2
// of them), STAGES slices in the ring, CTAs an SM must hold, and the
// staging: BULK copies or cp.async (WGRAD_F32_TILES in ops/lstm2_train.py,
// same order).
template <int SHAPE> struct F32Tile;
template <> struct F32Tile<0> {
  static constexpr int BM = 64, BN = 128, BK = 32, WM = 2, WN = 4, STAGES = 4, CTAS = 2;
  static constexpr bool BULK = false;
};
template <> struct F32Tile<1> {
  static constexpr int BM = 64, BN = 128, BK = 64, WM = 2, WN = 4, STAGES = 2, CTAS = 2;
  static constexpr bool BULK = false;
};
template <> struct F32Tile<2> {
  static constexpr int BM = 128, BN = 128, BK = 32, WM = 2, WN = 4, STAGES = 4, CTAS = 1;
  static constexpr bool BULK = false;
};
template <> struct F32Tile<3> {
  static constexpr int BM = 128, BN = 128, BK = 64, WM = 2, WN = 4, STAGES = 3, CTAS = 1;
  static constexpr bool BULK = false;
};
template <> struct F32Tile<4> {
  static constexpr int BM = 128, BN = 128, BK = 64, WM = 2, WN = 4, STAGES = 3, CTAS = 1;
  static constexpr bool BULK = true;
};
template <> struct F32Tile<5> {
  static constexpr int BM = 64, BN = 128, BK = 64, WM = 2, WN = 4, STAGES = 2, CTAS = 2;
  static constexpr bool BULK = true;
};
// shapes F32_MMA_TILES .. F32_TILES - 1 are `wgrad_wgmma_tf32_kernel`'s
constexpr int F32_MMA_TILES = 6, F32_TILES = 7;

// The float32 tile at (D, H) on a fold of n_rows rows: `wgrad_tiles` in
// ops/lstm2_train.py (the wgmma kernel, measured faster at both folds).
inline int wgrad_f32_tile(int D, int H, int n_rows) {
  (void)D, (void)H, (void)n_rows;
  return 6;
}

// -1: the rule above; otherwise the float32 tile every launch takes (timing only)
int g_forced_f32_tile = -1;

// A staged float32 row of `cols` words padded to a pitch of 8 (mod 32)
// words: a fragment's 32 loads (rows t and t + 4 of a k-step, 8 columns
// from g) then hit word 8 t + g of 32 banks
__host__ __device__ constexpr int f32_pitch(int cols) { return cols + (40 - cols % 32) % 32; }

// the ring, then (BULK) an 8-byte mbarrier a slot
template <int BM, int BN, int BK, int STAGES, bool BULK>
constexpr int wgrad_f32_smem_bytes() {
  return STAGES * BK * (f32_pitch(BM) + f32_pitch(BN)) * 4 + (BULK ? STAGES * 8 : 0);
}

// a zero row for the bulk copies' zero fill (rows past the chunk's, h_{-1},
// the columns of a tile past the A row's end)
__device__ __align__(16) float g_zero_row[128];

// `bytes` (a multiple of 16) from device memory at `src` to this CTA's shared
// memory at `dst` by the Tensor Memory Accelerator, completing on the
// mbarrier `bar`
__device__ __forceinline__ void bulk_copy_in(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one float32 word's TF32 halves, as the tensor core reads them
__device__ __forceinline__ void split_word(float v, uint32_t& big, uint32_t& small) {
  lstm2::split_tf32(__float_as_uint(v), big, small);
}

// C[k0 .. k0 + BM)[c0 .. c0 + BN) of gradient `which` (0 dW1, 1 dU1, 2 dW2,
// 3 dU2) += the chunk's A^T G in float32, as described above.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, int THREADS, bool BULK>
__device__ __forceinline__ void wgrad_tf32_tile(const WgradArgs<float>& a, int which, int k0,
                                                int c0, const float* smem) {
  constexpr int MI = BM / WM / 16, NI = BN / WN / 8;  // a warp's m16 and n8 tiles
  static_assert(MI >= 1 && NI >= 1 && WM * WN <= THREADS / 32 && BK % 8 == 0, "warp tiling");
  constexpr int LDA = f32_pitch(BM), LDG = f32_pitch(BN);  // staged row pitch, floats
  constexpr int STAGE = BK * (LDA + LDG);                   // floats a slice
  constexpr int A_COPIES = BK * BM / 4, G_COPIES = BK * BN / 4;  // 16-byte copies a slice
  const int G = 4 * a.H;
  const int K = which == 0 ? a.D : a.H;                    // live rows of C
  const int lda = which == 0 ? x_cols<float>(a.D) : a.H;  // row pitch of A in device memory
  const float* A = which == 0 ? a.x : (which == 3 ? a.h2 : a.h1);
  const int shift = (which == 1 || which == 3) ? 1 : 0;  // reads h of step t - 1
  const float* Gm = which < 2 ? a.dg1 : a.dg2;
  float* C = which == 0 ? a.dw1 : (which == 1 ? a.du1 : (which == 2 ? a.dw2 : a.du2));
  const uint32_t smem_u32 = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp - (warp / WN) * WN;
  const int m0 = wm * MI * 16, n0 = wn * NI * 8;  // the warp's rectangle in the tile
  const bool live = warp < WM * WN && k0 + m0 < K && c0 + n0 < G;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + m0 + 16 * i + g + 8 * h, c = c0 + n0 + 8 * j + 2 * t;
        float2 v = make_float2(0.0f, 0.0f);
        if (live && k < K && c < G) v = *reinterpret_cast<const float2*>(C + (size_t)k * G + c);
        acc[i][j][2 * h] = v.x;
        acc[i][j][2 * h + 1] = v.y;
      }

  const int row_slices = (a.n_rows + BK - 1) / BK;
  const int slices = (a.t_hi - a.t_lo + 1) * row_slices;
  auto load = [&](int slice) {
    const int step = a.t_hi - slice / row_slices, nb = (slice % row_slices) * BK;
    const bool a_live = !(shift && step == 0);  // h_{-1} = 0
    const float* At = A + (size_t)(a_live ? step - shift : 0) * a.n_rows * lda;
    const float* Gt = Gm + (size_t)(step - a.t_lo) * a.n_rows * G;
    const uint32_t as = smem_u32 + (slice % STAGES) * STAGE * 4, gs = as + BK * LDA * 4;
#pragma unroll
    for (int e = 0; e < cdiv(A_COPIES, THREADS); ++e) {
      const int idx = tid + e * THREADS;
      if (A_COPIES % THREADS != 0 && idx >= A_COPIES) break;
      const int r = idx / (BM / 4), kk = 4 * (idx % (BM / 4)), n = nb + r;
      const bool ok = a_live && n < a.n_rows && k0 + kk < lda;
      cp_async16(as + (r * LDA + kk) * 4, ok ? At + (size_t)n * lda + k0 + kk : A, ok);
    }
#pragma unroll
    for (int e = 0; e < cdiv(G_COPIES, THREADS); ++e) {
      const int idx = tid + e * THREADS;
      if (G_COPIES % THREADS != 0 && idx >= G_COPIES) break;
      const int r = idx / (BN / 4), cc = 4 * (idx % (BN / 4)), n = nb + r;
      const bool ok = n < a.n_rows && c0 + cc < G;
      cp_async16(gs + (r * LDG + cc) * 4, ok ? Gt + (size_t)n * G + c0 + cc : Gm, ok);
    }
  };

  // BULK: a slice staged by bulk copies of whole rows, thread r < BK
  // copying A's row r (the part inside the row's lda columns, then zeros)
  // and thread BK + r G's, completing on the slot's mbarrier
  const uint32_t full = smem_u32 + STAGES * STAGE * 4;
  const int a_cols = max(0, min(BM, lda - k0));  // A's columns inside the tile; the rest zero
  auto load_bulk = [&](int slice) {
    const uint32_t bar = full + 8 * (slice % STAGES);
    const uint32_t as = smem_u32 + (slice % STAGES) * STAGE * 4, gs = as + BK * LDA * 4;
    if (tid == 0) lstm2::mbar_arrive_expect(bar, BK * (BM + BN) * 4);
    if (tid >= 2 * BK) return;
    const int r = tid % BK, step = a.t_hi - slice / row_slices;
    const int n = (slice % row_slices) * BK + r;
    const bool ok = n < a.n_rows;
    if (tid >= BK) {
      const float* src = ok ? Gm + ((size_t)(step - a.t_lo) * a.n_rows + n) * G + c0 : g_zero_row;
      bulk_copy_in(gs + r * LDG * 4, src, BN * 4, bar);
    } else {
      const int cols = ok && !(shift && step == 0) ? a_cols : 0;  // h_{-1} = 0
      const uint32_t dst = as + r * LDA * 4;
      if (cols) bulk_copy_in(dst, A + ((size_t)(step - shift) * a.n_rows + n) * lda + k0, cols * 4, bar);
      if (cols < BM) bulk_copy_in(dst + cols * 4, g_zero_row, (BM - cols) * 4, bar);
    }
  };
  if constexpr (BULK) {
    static_assert(BM <= 128 && BN <= 128 && 2 * BK <= THREADS, "bulk staging");
    if (tid < STAGES) lstm2::mbar_init(full + 8 * tid, 1);
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if constexpr (BULK) {
      if (s < slices) load_bulk(s);
    } else {
      if (s < slices) load(s);
      cp_async_commit();
    }
  }
  for (int s = 0; s < slices; ++s) {
    const int next = s + STAGES - 1;  // the slice whose copies this iteration issues
    if constexpr (BULK) {
      __syncthreads();  // every warp is done with slice s - 1: its slot is free
      if (next < slices) load_bulk(next);
      lstm2::mbar_wait(full + 8 * (s % STAGES), (s / STAGES) & 1);  // slice s has landed
    } else {
      cp_async_wait<STAGES - 2>();  // slice s has landed (this thread's copies)
      __syncthreads();              // ... everyone's; slice s - 1's buffer is free
      if (next < slices) load(next);
      cp_async_commit();
    }
    if (!live) continue;
    // this lane's first A and G words of the slice: row t, columns m0 + g and n0 + g
    const float* as = smem + (s % STAGES) * STAGE + t * LDA + m0 + g;
    const float* gs = smem + (s % STAGES) * STAGE + BK * LDA + t * LDG + n0 + g;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      // the k-step's B fragments of the warp's NI n-tiles, then one m-tile's
      // A fragment at a time against them
      uint32_t b_big[NI][2], b_small[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float* q = gs + 8 * ks * LDG + 8 * j;
        split_word(q[0], b_big[j][0], b_small[j][0]);
        split_word(q[4 * LDG], b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t a_big[4], a_small[4];
        const float* p = as + 8 * ks * LDA + 16 * i;
        split_word(p[0], a_big[0], a_small[0]);
        split_word(p[8], a_big[1], a_small[1]);
        split_word(p[4 * LDA], a_big[2], a_small[2]);
        split_word(p[4 * LDA + 8], a_big[3], a_small[3]);
#pragma unroll
        for (int j = 0; j < NI; ++j)
          lstm2::mma_3xtf32(part[i][j], a_big, a_small, b_big[j][0], b_big[j][1], b_small[j][0],
                            b_small[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  if constexpr (!BULK) cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + m0 + 16 * i + g + 8 * h, c = c0 + n0 + 8 * j + 2 * t;
        if (live && k < K && c < G)
          *reinterpret_cast<float2*>(C + (size_t)k * G + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

template <int SHAPE>
__global__ void __launch_bounds__(32 * F32Tile<SHAPE>::WM * F32Tile<SHAPE>::WN,
                                  F32Tile<SHAPE>::CTAS)
wgrad_tf32_kernel(const WgradArgs<float> a) {
  using S = F32Tile<SHAPE>;
  constexpr int THREADS = 32 * S::WM * S::WN;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const float* smem = reinterpret_cast<const float*>(wg_smem);
  const int G = 4 * a.H;
  const int h_rows = cdiv(a.H, S::BM), h_cols = cdiv(G, S::BN), h_blocks = 3 * h_rows * h_cols;
  int b = blockIdx.x;
  if (b < h_blocks) {
    const int which = 1 + b / (h_rows * h_cols);
    b -= (which - 1) * h_rows * h_cols;
    wgrad_tf32_tile<S::BM, S::BN, S::BK, S::WM, S::WN, S::STAGES, THREADS, S::BULK>(
        a, which, (b / h_cols) * S::BM, (b % h_cols) * S::BN, smem);
  } else {
    b -= h_blocks;
    const int w1_cols = cdiv(G, W1_COLS);
    wgrad_tf32_tile<W1_ROWS, W1_COLS, S::BK, 3, 2, S::STAGES, THREADS, S::BULK>(
        a, 0, (b / w1_cols) * W1_ROWS, (b % w1_cols) * W1_COLS, smem);
  }
}

template <int SHAPE>
int launch_wgrad_tf32(const WgradArgs<float>& w, cudaStream_t stream) {
  using S = F32Tile<SHAPE>;
  constexpr int smem_h = wgrad_f32_smem_bytes<S::BM, S::BN, S::BK, S::STAGES, S::BULK>();
  constexpr int smem_w1 = wgrad_f32_smem_bytes<W1_ROWS, W1_COLS, S::BK, S::STAGES, S::BULK>();
  constexpr int smem = smem_h > smem_w1 ? smem_h : smem_w1;
  static_assert(smem <= (int)lstm2::SMEM_LIMIT, "a float32 tile's ring exceeds a block");
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_tf32_kernel<SHAPE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int G = 4 * w.H;
  const int blocks = 3 * cdiv(w.H, S::BM) * cdiv(G, S::BN) + cdiv(w.D, W1_ROWS) * cdiv(G, W1_COLS);
  wgrad_tf32_kernel<SHAPE><<<blocks, 32 * S::WM * S::WN, smem, stream>>>(w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// both dtypes: the weight gradients on wgmma
// ---------------------------------------------------------------------------
//
// `wgrad_wgmma_kernel` (bf16) and `wgrad_wgmma_tf32_kernel` (float32, as
// 3xTF32): the same sums as the kernels above, every product on Hopper's
// warpgroup products (wgmma.mma_async, lstm2_wgmma.cuh), the operand tiles
// loaded by the Tensor Memory Accelerator from 3-D tensor maps
// ([T][N][cols] of x, h1, h2 and [chunk][N][4H] of the dgates scratch): a box
// of [1][rows][cols] never crosses from one step's rows into the next, rows
// past N and columns past the array's arrive as zeros (so x's pad columns
// past x_cols(D) and a ragged last slice need nothing), and the slices of
// h_{t-1} at t = 0 are skipped, not loaded as zeros.
//
// A CTA of 384 threads owns a BM x BN tile of one gradient (rows k of D or
// H, gate columns c; the tiles of dU1, dW2 and dU2 first, then dW1's, all
// of one shape) over one split of each step's row slices: warpgroup 0
// stages, warpgroups 1 and 2 each multiply 64 rows k of the tile (a
// warpgroup whose rows all lie past D or H has nothing to do). The
// contraction runs over slices of BK rows n of one step, t_hi first, the
// split's slices in row order, through a ring of slices in shared memory,
// each completing on an mbarrier ("full") and released on another
// ("empty") once the products that read it have retired.
//   bf16: a slice is the A tile [BK n][BM k] and the G tile [BK n][BN c] as
//   they lie in device memory, boxes of 64 x 64 with the 128-byte swizzle;
//   wgmma reads both MN-major (A is M = k, B is N = c), so nothing is
//   transposed. One thread issues the boxes; each consumer warpgroup runs
//   four m64n256k16 products a slice into float32 accumulators in
//   registers, one commit group a slice, with the next slice's products
//   issued before the last one's have retired.
//   float32: TF32 wgmma reads B only K-major from shared memory and A
//   K-major or from registers, so a slice lands as float32 [BK n][BM k]
//   (boxes of 32 x 32, swizzled) and [BK n][BN c] (one box, plain);
//   warp 0 of warpgroup 0 issues the boxes, and its warps 1-3 split each G
//   word once into big and small TF32 halves with integer operations
//   (lstm2::split_tf32) and write both K-major and swizzled into a second
//   ring of two slices, [BN c][BK n] each; the consumers load
//   their A words from the landed slice as mma.sync m16n8k8's A fragment
//   (the register A of wgmma), split them, and issue small.big, big.small
//   and big.big a k8 step, m64n128k8. The tensor core truncates its float32
//   sums, so a slice's products go into a zeroed partial (scale-d 0 on its
//   first product) that one round-to-nearest FADD adds to the running sum,
//   as `wgrad_tf32_kernel` does.
// Split partials: where the tiles alone leave SMs idle, each step's row
// slices are cut into SPLITS runs, a CTA a (tile, run); run 0 sums into C
// itself and run s > 0 into its own float32 partial of C (`part`), each for
// the whole K3 call, across chunks: the first chunk starts from zero, later
// ones read the partial back. After the last chunk `wgmma_reduce_kernel`
// adds the runs' partials to C in run order. Every element has one owner a
// run and a fixed order, so the weight gradients are equal on a repeat and
// the same bits at any chunk: no atomics.
//
// What bounds it (H100, training fold N 2304, D 34, H 384, T 195): the
// products are 1.64 TFLOP (1.66 ms at the bf16 peak, 9.93 ms as three TF32
// products at the TF32 peak). The operand tiles through L2 are about
// 2 N T (D + 3H) 4H (1 / BM + 1 / BN) elements: 19 GB in bf16 at 128 x 256,
// 51 GB in float32 at 128 x 128. Measured (scripts/profile_torch_wgrad_
// wgmma.py on edited copies; PERF.md): bf16 2.65 ms, its loads alone 2.2-2.6
// and its products alone 2.35, so the two overlap almost whole; float32
// 17.7 ms, its loads and splits alone 10.3 and its products alone 14.4.
// The 120 CTAs are one wave, so 12 of 132 SMs idle. ptxas serialises the
// bf16 wgmma chain because its accumulators are read back from memory
// (C7515); read from zero it took 2.37 ms, but the sums must continue
// across chunks to keep their bits at any chunk.

// The wgmma tiles: BM rows x BN gate columns, BK contraction rows a slice,
// SPLITS runs of each step's row slices (WGRAD_H_TILES / WGRAD_F32_TILES
// in ops/lstm2_train.py, from H_MMA_TILES / F32_MMA_TILES on).
template <int SHAPE> struct WgmmaTile;
template <> struct WgmmaTile<2> { static constexpr int BM = 128, BN = 256, BK = 64, SPLITS = 2; };
template <> struct WgmmaTile<6> { static constexpr int BM = 128, BN = 128, BK = 32, SPLITS = 1; };

constexpr int WGMMA_THREADS = 384;  // a staging warpgroup and two consumer warpgroups

struct WgmmaMaps {
  CUtensorMap a[3];  // x [T][N][x_cols(D)], h1, h2 [T][N][H]
  CUtensorMap g[2];  // the dgates scratch dg1, dg2 [chunk][N][4H]
};

// A CTA's work: rows k0.. and columns c0.. of gradient `which` (0 dW1, 1
// dU1, 2 dW2, 3 dU2; K live rows), over run `split` of each step's row
// slices (`row_slices` slices of BK rows from `first_slice`), steps t_hi
// down to t_end: `slices` in all, summed into `dst` ([K][4H]).
struct WgmmaWork {
  int which, k0, c0, K, shift;
  int first_slice, row_slices, t_hi, t_end, slices;
  float* dst;
};

template <typename T, int BM, int BN, int BK>
__device__ __forceinline__ WgmmaWork wgmma_work(const WgradArgs<T>& a, int b, int split,
                                                int splits) {
  WgmmaWork w;
  const int G = 4 * a.H;
  const int cols = cdiv(G, BN), h_tiles = cdiv(a.H, BM) * cols;
  if (b < 3 * h_tiles) {
    w.which = 1 + b / h_tiles;
    b -= (w.which - 1) * h_tiles;
    w.K = a.H;
  } else {
    w.which = 0;
    b -= 3 * h_tiles;
    w.K = a.D;
  }
  w.k0 = (b / cols) * BM;
  w.c0 = (b % cols) * BN;
  w.shift = (w.which == 1 || w.which == 3) ? 1 : 0;  // reads h of step t - 1
  const int all = cdiv(a.n_rows, BK), per = cdiv(all, splits);
  w.first_slice = split * per;
  w.row_slices = max(0, min(all, w.first_slice + per) - w.first_slice);
  w.t_hi = a.t_hi;
  w.t_end = (w.shift && a.t_lo == 0) ? 1 : a.t_lo;  // h_{-1} = 0: t = 0 adds nothing
  w.slices = max(0, w.t_hi - w.t_end + 1) * w.row_slices;
  float* C = w.which == 0 ? a.dw1 : (w.which == 1 ? a.du1 : (w.which == 2 ? a.dw2 : a.du2));
  const size_t off = w.which == 0 ? 0 : (size_t)a.D * G + (size_t)(w.which - 1) * a.H * G;
  w.dst = split == 0 ? C : a.part + (size_t)(split - 1) * (a.D + 3 * a.H) * G + off;
  return w;
}

// slice s of the work: its step and first row
__device__ __forceinline__ int slice_step(const WgmmaWork& w, int s) {
  return w.t_hi - s / w.row_slices;
}
__device__ __forceinline__ int slice_row(const WgmmaWork& w, int s, int bk) {
  return (w.first_slice + s % w.row_slices) * bk;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// A consumer thread's accumulators of an m64nBN tile, row k, columns c and
// c + 1 for each n8 block j: register 4 j + 2 h + e is (k_lo + 8 h, c_lo +
// 8 j + e), the layout of wgmma's float32 D fragment. Read back from
// w.dst (zero on the call's first chunk) or written to it.
template <int R>
__device__ __forceinline__ void wgmma_acc_load(float (&acc)[R], const WgmmaWork& w, int G,
                                               int k_lo, int c_lo, bool first) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k_lo + 8 * h, c = c_lo + 8 * j;
      float2 v = make_float2(0.0f, 0.0f);
      if (!first && k < w.K && c < G)
        v = *reinterpret_cast<const float2*>(w.dst + (size_t)k * G + c);
      acc[4 * j + 2 * h] = v.x;
      acc[4 * j + 2 * h + 1] = v.y;
    }
}
template <int R>
__device__ __forceinline__ void wgmma_acc_store(const float (&acc)[R], const WgmmaWork& w, int G,
                                                int k_lo, int c_lo) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k_lo + 8 * h, c = c_lo + 8 * j;
      if (k < w.K && c < G)
        *reinterpret_cast<float2*>(w.dst + (size_t)k * G + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

constexpr int BF16_BOX = 64 * 128;  // a bf16 box: 64 rows of 64 (128 bytes)
constexpr int WGMMA_STAGES = 4;     // bf16 slices in the ring; float32 landed slices

template <int BN>
constexpr int wgmma_bf16_smem_bytes() {
  return 1024 + WGMMA_STAGES * (2 + BN / 64) * BF16_BOX + 2 * WGMMA_STAGES * 8;
}

template <int SHAPE>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ WgmmaMaps maps, const WgradArgs<__nv_bfloat16> a) {
  using S = WgmmaTile<SHAPE>;
  constexpr int BM = S::BM, BN = S::BN, BK = S::BK, NB = BN / 64;
  static_assert(BM == 128 && BK == 64 && BN == 256, "bf16 wgmma tile");
  constexpr int STAGE = (2 + NB) * BF16_BOX;  // A's two boxes, then G's NB
  extern __shared__ __align__(16) unsigned char wg_smem[];  // aligned to 1024 below
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(wg_smem) + 1023) & ~1023u;
  const uint32_t full = base + WGMMA_STAGES * STAGE, empty = full + 8 * WGMMA_STAGES;
  const WgmmaWork w = wgmma_work<__nv_bfloat16, BM, BN, BK>(a, blockIdx.x, blockIdx.y, S::SPLITS);
  const int G = 4 * a.H;
  const int live = w.k0 + 64 < w.K ? 2 : 1;  // consumer warpgroups with live rows
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < WGMMA_STAGES; ++s) {
      lstm2::mbar_init(full + 8 * s, 1);
      lstm2::mbar_init(empty + 8 * s, live);
    }
  }
  __syncthreads();

  if (tid < 128) {  // staging: one thread issues every box
    if (tid != 0) return;
    const CUtensorMap* am = &maps.a[w.which == 0 ? 0 : (w.which == 3 ? 2 : 1)];
    const CUtensorMap* gm = &maps.g[w.which < 2 ? 0 : 1];
    const int g_boxes = min(NB, cdiv(G - w.c0, 64));
    const uint32_t bytes = (live + g_boxes) * BF16_BOX;
    for (int s = 0; s < w.slices; ++s) {
      const int st = s % WGMMA_STAGES;
      const uint32_t bar = full + 8 * st, dst = base + st * STAGE;
      lstm2::mbar_wait(empty + 8 * st, ((s / WGMMA_STAGES) & 1) ^ 1);
      lstm2::mbar_arrive_expect(bar, bytes);
      const int t = slice_step(w, s), n = slice_row(w, s, BK);
      for (int b = 0; b < live; ++b)
        wgmma::tma_load_3d(dst + b * BF16_BOX, am, w.k0 + 64 * b, n, t - w.shift, bar);
      for (int j = 0; j < g_boxes; ++j)
        wgmma::tma_load_3d(dst + (2 + j) * BF16_BOX, gm, w.c0 + 64 * j, n, t - a.t_lo, bar);
    }
    return;
  }

  const int cw = tid / 128 - 1;  // this consumer warpgroup's 64 rows of the tile
  if (cw >= live) return;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int k_lo = w.k0 + 64 * cw + 16 * warp + (lane >> 2), c_lo = w.c0 + 2 * (lane & 3);
  float acc[BN / 2];
  wgmma_acc_load(acc, w, G, k_lo, c_lo, a.first);
  for (int s = 0; s < w.slices; ++s) {
    const int st = s % WGMMA_STAGES;
    lstm2::mbar_wait(full + 8 * st, (s / WGMMA_STAGES) & 1);
    const uint32_t as = base + st * STAGE + cw * BF16_BOX, gs = base + st * STAGE + 2 * BF16_BOX;
    wgmma::hold(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 rows n: two groups of 8 rows, 2048 bytes
      const uint64_t da = wgmma::desc_b128(as + 2048 * kk, BF16_BOX, 1024);
      const uint64_t db = wgmma::desc_b128(gs + 2048 * kk, BF16_BOX, 1024);
      wgmma::wgmma_bf16_n256(acc, da, db, 1);
    }
    wgmma::commit();
    wgmma::wait<1>();  // slice s - 1's products have retired: its slot is free
    wgmma::hold(acc);
    if (s > 0 && tid % 128 == 0) mbar_arrive(empty + 8 * ((s - 1) % WGMMA_STAGES));
  }
  wgmma::wait<0>();
  wgmma::hold(acc);
  wgmma_acc_store(acc, w, G, k_lo, c_lo);
}

template <int SHAPE>
int launch_wgrad_wgmma(const WgmmaMaps& maps, const WgradArgs<__nv_bfloat16>& w,
                       cudaStream_t stream) {
  using S = WgmmaTile<SHAPE>;
  constexpr int smem = wgmma_bf16_smem_bytes<S::BN>();
  static_assert(smem <= (int)lstm2::SMEM_LIMIT, "the bf16 wgmma ring exceeds a block");
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_wgmma_kernel<SHAPE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = cdiv(4 * w.H, S::BN);
  const dim3 grid(3 * cdiv(w.H, S::BM) * cols + cdiv(w.D, S::BM) * cols, S::SPLITS);
  wgrad_wgmma_kernel<SHAPE><<<grid, WGMMA_THREADS, smem, stream>>>(maps, w);
  return (int)cudaGetLastError();
}

// float32: a landed slice is A [32 n][128 k] in four swizzled boxes of 32
// columns (4096 bytes each), then G [32 n][128 c] in one plain box; a split
// slice is big, then small, each [128 c][32 n] K-major and swizzled.
constexpr int F32_A_BOX = 32 * 128;
constexpr int F32_LANDED = 4 * F32_A_BOX + 32 * 128 * 4;
constexpr int F32_SPLIT = 2 * 128 * 128;
constexpr int F32_SPLIT_STAGES = 2;
constexpr int SPLITTERS = 96;  // warps 1-3 of the staging warpgroup

constexpr int wgmma_tf32_smem_bytes() {
  return 1024 + WGMMA_STAGES * F32_LANDED + F32_SPLIT_STAGES * F32_SPLIT +
         2 * (WGMMA_STAGES + F32_SPLIT_STAGES) * 8;
}

// the 128-byte swizzle of byte `off` of a 1024-aligned atom
__device__ __forceinline__ uint32_t swz128(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}

template <int SHAPE>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
wgrad_wgmma_tf32_kernel(const __grid_constant__ WgmmaMaps maps, const WgradArgs<float> a) {
  using S = WgmmaTile<SHAPE>;
  constexpr int BM = S::BM, BN = S::BN, BK = S::BK, LST = WGMMA_STAGES, BST = F32_SPLIT_STAGES;
  static_assert(BM == 128 && BN == 128 && BK == 32, "float32 wgmma tile");
  extern __shared__ __align__(16) unsigned char wg_smem[];  // aligned to 1024 below
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(wg_smem) + 1023) & ~1023u;
  const uint32_t split_base = base + LST * F32_LANDED;
  const uint32_t lfull = split_base + BST * F32_SPLIT, lempty = lfull + 8 * LST;
  const uint32_t bfull = lempty + 8 * LST, bempty = bfull + 8 * BST;
  const WgmmaWork w = wgmma_work<float, BM, BN, BK>(a, blockIdx.x, blockIdx.y, S::SPLITS);
  const int G = 4 * a.H;
  const int live = w.k0 + 64 < w.K ? 2 : 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < LST; ++s) {
      lstm2::mbar_init(lfull + 8 * s, 1);
      lstm2::mbar_init(lempty + 8 * s, SPLITTERS + 128 * live);  // the splitters, the consumers
    }
    for (int s = 0; s < BST; ++s) {
      lstm2::mbar_init(bfull + 8 * s, SPLITTERS);
      lstm2::mbar_init(bempty + 8 * s, live);
    }
  }
  __syncthreads();

  if (tid < 32) {  // staging: one thread issues every box
    if (tid != 0) return;
    const CUtensorMap* am = &maps.a[w.which == 0 ? 0 : (w.which == 3 ? 2 : 1)];
    const CUtensorMap* gm = &maps.g[w.which < 2 ? 0 : 1];
    const int a_boxes = min(4, cdiv(w.K - w.k0, 32));
    const uint32_t bytes = a_boxes * F32_A_BOX + BK * BN * 4;
    for (int s = 0; s < w.slices; ++s) {
      const int st = s % LST;
      const uint32_t bar = lfull + 8 * st, dst = base + st * F32_LANDED;
      lstm2::mbar_wait(lempty + 8 * st, ((s / LST) & 1) ^ 1);
      lstm2::mbar_arrive_expect(bar, bytes);
      const int t = slice_step(w, s), n = slice_row(w, s, BK);
      for (int b = 0; b < a_boxes; ++b)
        wgmma::tma_load_3d(dst + b * F32_A_BOX, am, w.k0 + 32 * b, n, t - w.shift, bar);
      wgmma::tma_load_3d(dst + 4 * F32_A_BOX, gm, w.c0, n, t - a.t_lo, bar);
    }
    return;
  }
  if (tid < 128) {  // splitting: warps 1-3 split G into the second ring
    for (int s = 0; s < w.slices; ++s) {
      lstm2::mbar_wait(lfull + 8 * (s % LST), (s / LST) & 1);
      lstm2::mbar_wait(bempty + 8 * (s % BST), ((s / BST) & 1) ^ 1);
      const uint32_t gl = base + (s % LST) * F32_LANDED + 4 * F32_A_BOX;
      const uint32_t big = split_base + (s % BST) * F32_SPLIT, small = big + BN * 128;
      for (int i = tid - 32; i < BN * BK / 4; i += SPLITTERS) {
        const int c = i % BN, q = i / BN;  // rows 4 q .. 4 q + 3 of column c
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) lstm2::split_tf32(lds32(gl + ((4 * q + e) * BN + c) * 4), hi[e], lo[e]);
        const uint32_t off = swz128(c * 128 + q * 16);
        sts128(big + off, hi);
        sts128(small + off, lo);
      }
      lstm2::fence_proxy_async();  // the split words, visible to wgmma
      mbar_arrive(bfull + 8 * (s % BST));
      mbar_arrive(lempty + 8 * (s % LST));
    }
    return;
  }

  const int cw = tid / 128 - 1;
  if (cw >= live) return;
  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int k_lo = w.k0 + 64 * cw + 16 * warp + g, c_lo = w.c0 + 2 * t4;
  // this thread's A words: rows k (box kb, column kc) and k + 8 of the tile
  const int kb = (64 * cw + 16 * warp) / 32, kc = (16 * warp + g) % 32;
  float acc[BN / 2], part[BN / 2];
  uint32_t a_big[2][4], a_small[2][4];  // a k8 step's A words, two steps in flight
  wgmma_acc_load(acc, w, G, k_lo, c_lo, a.first);
  for (int s = 0; s < w.slices; ++s) {
    lstm2::mbar_wait(lfull + 8 * (s % LST), (s / LST) & 1);
    lstm2::mbar_wait(bfull + 8 * (s % BST), (s / BST) & 1);
    const uint32_t al = base + (s % LST) * F32_LANDED + kb * F32_A_BOX;
    const uint32_t big = split_base + (s % BST) * F32_SPLIT, small = big + BN * 128;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int h = kk & 1, n = 8 * kk + t4;
      const uint32_t raw[4] = {lds32(al + swz128(n * 128 + kc * 4)),
                               lds32(al + swz128(n * 128 + (kc + 8) * 4)),
                               lds32(al + swz128((n + 4) * 128 + kc * 4)),
                               lds32(al + swz128((n + 4) * 128 + (kc + 8) * 4))};
#pragma unroll
      for (int e = 0; e < 4; ++e) lstm2::split_tf32(raw[e], a_big[h][e], a_small[h][e]);
      if (kk == BK / 8 - 1) mbar_arrive(lempty + 8 * (s % LST));  // this thread's reads are done
      wgmma::hold(part);
      wgmma::fence();
      const uint64_t db_big = wgmma::desc_b128(big + 32 * kk, 16, 1024);
      const uint64_t db_small = wgmma::desc_b128(small + 32 * kk, 16, 1024);
      wgmma::wgmma_tf32_n128(part, a_small[h], db_big, kk > 0);
      wgmma::wgmma_tf32_n128(part, a_big[h], db_small, 1);
      wgmma::wgmma_tf32_n128(part, a_big[h], db_big, 1);
      wgmma::commit();
      if (kk > 0) {
        wgmma::wait<1>();  // step kk - 1 has retired: its A registers are free
        wgmma::hold(part);
        wgmma::hold(a_big[h ^ 1]);
        wgmma::hold(a_small[h ^ 1]);
      }
    }
    wgmma::wait<0>();  // the slice's products have retired: fold them into the sums
    wgmma::hold(part);
    wgmma::hold(a_big[1]);
    wgmma::hold(a_small[1]);
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] += part[r];
    if (tid % 128 == 0) mbar_arrive(bempty + 8 * (s % BST));
  }
  wgmma_acc_store(acc, w, G, k_lo, c_lo);
}

template <int SHAPE>
int launch_wgrad_wgmma_tf32(const WgmmaMaps& maps, const WgradArgs<float>& w,
                            cudaStream_t stream) {
  using S = WgmmaTile<SHAPE>;
  constexpr int smem = wgmma_tf32_smem_bytes();
  static_assert(smem <= (int)lstm2::SMEM_LIMIT, "the float32 wgmma rings exceed a block");
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_wgmma_tf32_kernel<SHAPE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = cdiv(4 * w.H, S::BN);
  const dim3 grid(3 * cdiv(w.H, S::BM) * cols + cdiv(w.D, S::BM) * cols, S::SPLITS);
  wgrad_wgmma_tf32_kernel<SHAPE><<<grid, WGMMA_THREADS, smem, stream>>>(maps, w);
  return (int)cudaGetLastError();
}

// C += the runs' partials 1 .. parts, in run order (run 0's sums are C);
// part holds each run's [dW1 | dU1 | dW2 | dU2] in turn
__global__ void wgmma_reduce_kernel(float* dw1, float* du1, float* dw2, float* du2,
                                    const float* __restrict__ part, int D, int H, int parts) {
  const size_t G = 4 * (size_t)H, w1 = (size_t)D * G, h = (size_t)H * G, total = w1 + 3 * h;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float* C = i < w1 ? dw1 + i
                    : (i < w1 + h ? du1 + (i - w1) : (i < w1 + 2 * h ? dw2 + (i - w1 - h)
                                                                     : du2 + (i - w1 - 2 * h)));
  float v = *C;
  for (int s = 0; s < parts; ++s) v += part[(size_t)s * total + i];
  *C = v;
}

// The tile the next launch in T takes at (D, H, n_rows): forced, or the rule.
template <typename T>
int wgrad_choice(int D, int H, int n_rows) {
  if constexpr (std::is_same_v<T, float>)
    return g_forced_f32_tile >= 0 ? g_forced_f32_tile : wgrad_f32_tile(D, H, n_rows);
  else
    return g_forced_tile >= 0 ? g_forced_tile : wgrad_tile(D, H, n_rows);
}

template <typename T>
bool wgmma_tile(int tile) {
  return tile >= (std::is_same_v<T, float> ? F32_MMA_TILES : H_MMA_TILES);
}

// the runs of each step's row slices at `tile` (1 for the mma.sync kernels)
template <typename T>
int wgrad_splits(int tile) {
  if constexpr (std::is_same_v<T, float>)
    return tile == 6 ? WgmmaTile<6>::SPLITS : 1;
  else
    return tile == 2 ? WgmmaTile<2>::SPLITS : 1;
}

// The wgmma kernels' maps of x, h1, h2 and the dgates scratch in T: boxes
// of 64 x 64 swizzled (bf16); 32 x 32 swizzled for A and 32 x 128 plain
// for G (float32). Returns 0 or ENCODE_FAILED + the CUresult.
template <typename T>
int encode_wgmma_maps(WgmmaMaps* maps, const WgradArgs<T>& w, int steps, int chunk) {
  constexpr bool f32 = std::is_same_v<T, float>;
  constexpr CUtensorMapDataType type =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int elem = sizeof(T), a_box = f32 ? 32 : 64, rows = f32 ? 32 : 64;
  const int G = 4 * w.H;
  const void* a_arrays[3] = {w.x, w.h1, w.h2};
  for (int i = 0; i < 3; ++i) {
    const int cols = i == 0 ? x_cols<T>(w.D) : w.H;
    const int err = wgmma::encode_3d(&maps->a[i], a_arrays[i], type, elem, steps, w.n_rows, cols,
                                     rows, a_box, true);
    if (err != 0) return err;
  }
  const void* g_arrays[2] = {w.dg1, w.dg2};
  for (int i = 0; i < 2; ++i) {
    const int err = wgmma::encode_3d(&maps->g[i], g_arrays[i], type, elem, chunk, w.n_rows, G,
                                     rows, f32 ? 128 : 64, !f32);
    if (err != 0) return err;
  }
  return 0;
}

template <typename T>
int launch_wgrad(const WgradArgs<T>& w, int tile, const WgmmaMaps& maps, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    switch (tile) {
      case 0: return launch_wgrad_tf32<0>(w, stream);
      case 1: return launch_wgrad_tf32<1>(w, stream);
      case 2: return launch_wgrad_tf32<2>(w, stream);
      case 3: return launch_wgrad_tf32<3>(w, stream);
      case 4: return launch_wgrad_tf32<4>(w, stream);
      case 5: return launch_wgrad_tf32<5>(w, stream);
      case 6: return launch_wgrad_wgmma_tf32<6>(maps, w, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (tile) {
      case 0: return launch_wgrad_mma<0>(w, stream);
      case 1: return launch_wgrad_mma<1>(w, stream);
      case 2: return launch_wgrad_wgmma<2>(maps, w, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// db1[c], db2[c] = sum over the row tiles, in tile order, of db_part[tile][layer][c]
__global__ void db_reduce_kernel(const float* __restrict__ db_part, float* __restrict__ db1,
                                 float* __restrict__ db2, int tiles, int G) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= G) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int tile = 0; tile < tiles; ++tile) {
    s1 += db_part[((size_t)tile * 2) * G + c];
    s2 += db_part[((size_t)tile * 2 + 1) * G + c];
  }
  db1[c] = s1;
  db2[c] = s2;
}

template <typename T>
int run(const void* const* in, void* const* out, int n_rows, int steps, int D, int H, int O,
        int rows, int form, int chunk, int part_steps, cudaStream_t stream) {
  int err = 0;
  bwd::SweepArgs<T> s;
  s.dy = static_cast<const T*>(in[0]);
  s.g1 = static_cast<const T*>(in[2]);
  s.c1 = static_cast<const T*>(in[3]);
  s.g2 = static_cast<const T*>(in[5]);
  s.c2 = static_cast<const T*>(in[6]);
  s.w2p = static_cast<const uint4*>(in[8]);
  s.u1p = static_cast<const uint4*>(in[9]);
  s.w1p = static_cast<const uint4*>(in[10]);
  s.fcw = static_cast<const float*>(in[11]);
  s.dx = static_cast<T*>(out[0]);
  s.dg1 = static_cast<T*>(out[7]);
  s.dg2 = static_cast<T*>(out[8]);
  s.carry = static_cast<float*>(out[9]);
  s.db_part = static_cast<float*>(out[10]);
  s.n_rows = n_rows;
  s.steps = steps;
  s.D = D;
  s.H = H;
  s.O = O;
  s.late_sends = 0;

  WgradArgs<T> w;
  w.x = static_cast<const T*>(in[1]);
  w.h1 = static_cast<const T*>(in[4]);
  w.h2 = static_cast<const T*>(in[7]);
  w.dg1 = s.dg1;
  w.dg2 = s.dg2;
  w.dw1 = static_cast<float*>(out[1]);
  w.du1 = static_cast<float*>(out[2]);
  w.dw2 = static_cast<float*>(out[3]);
  w.du2 = static_cast<float*>(out[4]);
  w.part = static_cast<float*>(out[11]);
  w.n_rows = n_rows;
  w.D = D;
  w.H = H;

  const int G = 4 * H;
  const int tile = wgrad_choice<T>(D, H, n_rows);
  WgmmaMaps maps;
  if (wgmma_tile<T>(tile) && (err = encode_wgmma_maps<T>(&maps, w, steps, chunk)) != 0)
    return err;
  for (int t_hi = steps - 1; t_hi >= 0; t_hi -= chunk) {
    const int t_lo = t_hi - chunk + 1 > 0 ? t_hi - chunk + 1 : 0;
    s.t_hi = w.t_hi = t_hi;
    s.t_lo = s.t_base = w.t_lo = t_lo;
    s.resume = t_hi != steps - 1;
    w.first = t_hi == steps - 1;
    err = bwd::launch_sweep<T>(s, rows, form, part_steps, stream);
    if (err != 0) return err;
    err = launch_wgrad<T>(w, tile, maps, stream);
    if (err != 0) return err;
  }
  const int parts = wgrad_splits<T>(tile) - 1;
  if (parts > 0) {  // C = run 0's sums + run 1's + ..., in run order
    if (w.part == nullptr) return (int)cudaErrorInvalidValue;
    const size_t total = (size_t)(D + 3 * H) * G;
    wgmma_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        w.dw1, w.du1, w.dw2, w.du2, w.part, D, H, parts);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  const int tiles = (n_rows + rows - 1) / rows;
  db_reduce_kernel<<<(G + 255) / 256, 256, 0, stream>>>(
      s.db_part, static_cast<float*>(out[5]), static_cast<float*>(out[6]), tiles, G);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, x, the residuals, the weights, dx
// and the dgates scratch; fcw and every gradient sum are float32). w2p,
// u1p, w1p: [W2; U2], U1 and W1 packed into mma fragments
// (ops/lstm2.py: pack_tf32_b for float32, pack_mma_b for bfloat16); rows
// is 16. form and part_steps: the sweep's form, as lstm2_bwd takes it
// (lstm2_bwd.cu; the wave form's parts cut each chunk's sweep, their
// carries in `carry`). chunk: the steps the scratch holds. dw1, du1, dw2,
// du2 must arrive zeroed; wgrad_part holds SPLITS - 1 float32 partials of
// [dW1 | dU1 | dW2 | dU2] for a wgmma tile of SPLITS runs (null for one
// run and for the mma.sync kernels); carry is [4][ceil(N / rows) * rows][H] and
// db_part [ceil(N / rows)][2][4H] float32. x is [T, N, x_cols(D)] (D
// rounded up to 16 bytes: 4 float32, 8 bf16), its pad columns zero.
extern "C" int lstm2_bwd_wgrad(const void* dy, const void* x, const void* g1, const void* c1,
                               const void* h1, const void* g2, const void* c2, const void* h2,
                               const void* w2p, const void* u1p, const void* w1p,
                               const void* fcw, void* dx, void* dw1, void* du1, void* dw2,
                               void* du2, void* db1, void* db2, void* scratch_dg1,
                               void* scratch_dg2, void* carry, void* db_part, void* wgrad_part,
                               int n_rows, int steps, int D, int H, int O, int rows, int form,
                               int chunk, int part_steps, int dtype, void* stream) {
  if (!bwd::valid_shape(n_rows, steps, D, H, O) || chunk < 1) return (int)cudaErrorInvalidValue;
  const void* in[12] = {dy, x, g1, c1, h1, g2, c2, h2, w2p, u1p, w1p, fcw};
  void* out[12] = {dx,  dw1,         du1,         dw2,   du2,     db1,
                   db2, scratch_dg1, scratch_dg2, carry, db_part, wgrad_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(in, out, n_rows, steps, D, H, O, rows, form, chunk, part_steps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(in, out, n_rows, steps, D, H, O, rows, form, chunk, part_steps, s);
  return (int)cudaErrorInvalidValue;
}

// Forces the tile of dU1, dW2 and dU2 for later launches in `dtype` (0
// float32: 0 .. F32_TILES - 1, WGRAD_F32_TILES order; 1 bfloat16: 0 ..
// H_TILES - 1, WGRAD_H_TILES order; -1: the rule `wgrad_f32_tile` or
// `wgrad_tile`), to time the candidates. Returns the previous setting, or -2
// for a shape or dtype there is not.
extern "C" int lstm2_bwd_wgrad_force_tile(int shape, int dtype) {
  if (dtype != 0 && dtype != 1) return -2;
  int& forced = dtype == 0 ? g_forced_f32_tile : g_forced_tile;
  if (shape < -1 || shape >= (dtype == 0 ? F32_TILES : H_TILES)) return -2;
  const int before = forced;
  forced = shape;
  return before;
}

// The tile of dU1, dW2 and dU2 (WGRAD_F32_TILES / WGRAD_H_TILES order) that
// a launch in `dtype` at (n_rows, D, H) takes: forced, or the rule's; -1 for
// a dtype there is not.
extern "C" int lstm2_bwd_wgrad_tile(int n_rows, int D, int H, int dtype) {
  if (dtype == 0) return wgrad_choice<float>(D, H, n_rows);
  if (dtype == 1) return wgrad_choice<__nv_bfloat16>(D, H, n_rows);
  return -1;
}
