// Reverse-sweep backward of the fused 2-layer LSTM with the weight
// gradients summed inside, for Hopper (sm_90a): the training step's default
// backward in bf16.
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
// Operations bound it in both types (48.8 ms at 67 TFLOP/s in float32
// against 2.5 ms of bytes; 3.3 ms at the tensor cores' bf16 rate against
// 1.3 ms). The reverse sweep's three products run on mma.sync in both
// types (in float32 as three TF32 products of split operands;
// lstm2_bwd_sweep.cuh says what bounds it: each CTA's step latency); in
// bf16 so do the four weight-gradient products of `wgrad_mma_kernel` below,
// while float32 keeps FMAs in `wgrad_kernel`.
//
// Design. The TPU kernel keeps all 7.3 MB of float32 accumulators resident
// and relies on its grid running in order; here CTAs run at once and have
// 227 KB each. So the work is cut in time, not in rows: the steps are swept
// in chunks of `chunk` steps, newest first. For each chunk
//   1. the sweep (lstm2_bwd_sweep.cuh, in the form the caller chooses:
//      `sweep_mma_kernel`, one CTA per row tile of 16, or at folds of a few
//      tiles `sweep_cluster_kernel`, a cluster of CTAs per tile) runs the
//      chunk's steps, reads and leaves the four carries in a [4][N][H]
//      float32 array, writes the chunk's rounded dgates into a scratch
//      [chunk, N, 4H] x 2 (reused by every chunk: its size does not grow
//      with T and is chosen to stay near the L2's size), and adds the tile's
//      unrounded dgates into its own row of db_part;
//   2. the weight-gradient kernel adds A^T dg of the chunk into the four
//      weight gradients, each output element owned by one thread that reads
//      it, adds the chunk's steps and rows in a fixed order, and writes it
//      back: `wgrad_kernel` (float32, FMAs, operands widened in shared
//      memory) or `wgrad_mma_kernel` (bf16, tensor cores; see below).
// Then `db_reduce_kernel` sums the tiles' bias rows in tile order. Kernels
// on one stream run in order and every sum has one owner and a fixed
// order, so the result is the same bit for bit on every run: no atomics.
//
// The C entry point launches on the caller's stream, allocates nothing
// (the caller passes outputs, zeroed weight gradients, scratch and carry
// arrays) and returns the first CUDA error.

#include "lstm2_bwd_sweep.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: FMA products
// ---------------------------------------------------------------------------

constexpr int TILE = 128;  // output tile of wgrad_kernel: TILE x TILE
constexpr int NB = 16;     // rows of the contraction staged at a time
constexpr int MICRO = 8;   // each of the 16 x 16 threads owns MICRO x MICRO outputs:
                           // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns alike
                           // with tx, so its operands are four float4 loads a slice row

template <typename T>
struct WgradArgs {
  const T* x;     // [T, N, D]; bf16: [T, N, dx_cols(D)], the pad columns zero
  const T* h1;    // [T, N, H]
  const T* h2;    // [T, N, H]
  const T* dg1;   // scratch [chunk, N, 4H]: step t at index t - t_lo
  const T* dg2;
  float* dw1;     // [D, 4H]
  float* du1;     // [H, 4H]
  float* dw2;     // [H, 4H]
  float* du2;     // [H, 4H]
  int n_rows, D, H;
  int t_hi, t_lo;
};

// Element i (of MICRO) of thread coordinate c (of 16) within a TILE
__device__ __forceinline__ int micro(int c, int i) { return 4 * c + 64 * (i >> 2) + (i & 3); }

// One thread's share of a staged tile: NB x TILE elements of A and of G
// over 256 threads, as raw bits so that all 16 loads are in flight at once.
template <typename T>
struct Staged {
  typename lstm2::Bits<T>::type a[NB * TILE / 256], g[NB * TILE / 256];
};

// C[k][c] += sum over t = t_hi .. t_lo and rows n of A_t[n][k] * G_t[n][c].
// blockIdx.x: tile of the 4H gate columns; blockIdx.y: tile of the rows of
// one of the four gradients (dW1's tiles first, then dU1, dW2, dU2). The
// contraction runs over (step, NB rows) slices in a fixed order; the loads
// of the next slice are issued before the products of the current one.
template <typename T>
__global__ void __launch_bounds__(256)
wgrad_kernel(const WgradArgs<T> a) {
  static_assert(std::is_same_v<T, float>, "bf16 weight gradients run on wgrad_mma_kernel");
  using Raw = typename lstm2::Bits<T>::type;
  __shared__ __align__(16) float As[NB][TILE];
  __shared__ __align__(16) float Gs[NB][TILE];
  const int G = 4 * a.H;
  const int tiles_d = (a.D + TILE - 1) / TILE, tiles_h = (a.H + TILE - 1) / TILE;

  int tile = blockIdx.y, which = 0;
  if (tile >= tiles_d) {
    tile -= tiles_d;
    which = 1 + tile / tiles_h;
    tile -= (which - 1) * tiles_h;
  }
  const int K = which == 0 ? a.D : a.H;           // rows of this gradient
  const Raw* A = reinterpret_cast<const Raw*>(which == 0 ? a.x : (which == 3 ? a.h2 : a.h1));
  const int shift = (which == 1 || which == 3) ? 1 : 0;  // reads h of step t - 1
  const Raw* Gm = reinterpret_cast<const Raw*>(which < 2 ? a.dg1 : a.dg2);
  float* C = which == 0 ? a.dw1 : (which == 1 ? a.du1 : (which == 2 ? a.dw2 : a.du2));
  const int k0 = tile * TILE, c0 = blockIdx.x * TILE;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int jj = 0; jj < MICRO; ++jj) {
      const int k = k0 + micro(ty, i), c = c0 + micro(tx, jj);
      acc[i][jj] = (k < K && c < G) ? C[(size_t)k * G + c] : 0.0f;
    }

  const int row_slices = (a.n_rows + NB - 1) / NB;
  const int slices = (a.t_hi - a.t_lo + 1) * row_slices;
  const int col = tid & (TILE - 1), n_first = tid / TILE;  // this thread's staged elements

  auto load = [&](int slice, Staged<T>& st) {
    const int t = a.t_hi - slice / row_slices, n0 = (slice % row_slices) * NB;
    const bool a_ok = k0 + col < K && !(shift && t == 0);  // h_{-1} = 0
    const bool g_ok = c0 + col < G;
    const Raw* At = A + (size_t)(a_ok ? t - shift : 0) * a.n_rows * K;
    const Raw* Gt = Gm + (size_t)(t - a.t_lo) * a.n_rows * G;
#pragma unroll
    for (int e = 0; e < NB * TILE / 256; ++e) {
      const int n = n0 + n_first + (256 / TILE) * e;
      const bool row_ok = n < a.n_rows;
      st.a[e] = (row_ok && a_ok) ? At[(size_t)n * K + k0 + col] : Raw(0);
      st.g[e] = (row_ok && g_ok) ? Gt[(size_t)n * G + c0 + col] : Raw(0);
    }
  };

  Staged<T> st;
  if (slices > 0) load(0, st);
  for (int slice = 0; slice < slices; ++slice) {
#pragma unroll
    for (int e = 0; e < NB * TILE / 256; ++e) {
      As[n_first + (256 / TILE) * e][col] = lstm2::Bits<T>::to_f(st.a[e]);
      Gs[n_first + (256 / TILE) * e][col] = lstm2::Bits<T>::to_f(st.g[e]);
    }
    __syncthreads();
    if (slice + 1 < slices) load(slice + 1, st);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float av[MICRO], gv[MICRO];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[n][micro(ty, 4 * half)]);
        const float4 g4 = *reinterpret_cast<const float4*>(&Gs[n][micro(tx, 4 * half)]);
        av[4 * half] = a4.x, av[4 * half + 1] = a4.y, av[4 * half + 2] = a4.z;
        av[4 * half + 3] = a4.w;
        gv[4 * half] = g4.x, gv[4 * half + 1] = g4.y, gv[4 * half + 2] = g4.z;
        gv[4 * half + 3] = g4.w;
      }
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int jj = 0; jj < MICRO; ++jj) acc[i][jj] = fmaf(av[i], gv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int jj = 0; jj < MICRO; ++jj) {
      const int k = k0 + micro(ty, i), c = c0 + micro(tx, jj);
      if (k < K && c < G) C[(size_t)k * G + c] = acc[i][jj];
    }
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
//   the row's end, and h_{-1} at t = 0. bf16 x arrives padded to
//   dx_cols(D) columns, so its rows are 16-byte aligned like h's.
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
constexpr int H_TILES = 2;

// The tile of dU1, dW2 and dU2 at (D, H): `wgrad_tiles` in ops/lstm2_train.py.
inline int wgrad_tile(int D, int H) {
  (void)D, (void)H;
  return 0;
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
  const int lda = which == 0 ? bwd::dx_cols(a.D) : a.H;  // row pitch of A in device memory
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

template <typename T>
int launch_wgrad(const WgradArgs<T>& w, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    const int G = 4 * w.H;
    const dim3 grid((G + TILE - 1) / TILE,
                    (w.D + TILE - 1) / TILE + 3 * ((w.H + TILE - 1) / TILE));
    wgrad_kernel<float><<<grid, 256, 0, stream>>>(w);
    return (int)cudaGetLastError();
  } else {
    switch (g_forced_tile >= 0 ? g_forced_tile : wgrad_tile(w.D, w.H)) {
      case 0: return launch_wgrad_mma<0>(w, stream);
      case 1: return launch_wgrad_mma<1>(w, stream);
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
        int rows, int form, int chunk, cudaStream_t stream) {
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
  w.n_rows = n_rows;
  w.D = D;
  w.H = H;

  const int G = 4 * H;
  for (int t_hi = steps - 1; t_hi >= 0; t_hi -= chunk) {
    const int t_lo = t_hi - chunk + 1 > 0 ? t_hi - chunk + 1 : 0;
    s.t_hi = w.t_hi = t_hi;
    s.t_lo = s.t_base = w.t_lo = t_lo;
    s.resume = t_hi != steps - 1;
    int err = bwd::launch_sweep<T>(s, rows, form, stream);
    if (err != 0) return err;
    err = launch_wgrad<T>(w, stream);
    if (err != 0) return err;
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
// is 16. form: the sweep's form, as lstm2_bwd takes it (lstm2_bwd.cu).
// chunk: the steps the scratch holds. dw1, du1, dw2,
// du2 must arrive zeroed; carry is [4][ceil(N / rows) * rows][H] and
// db_part [ceil(N / rows)][2][4H] float32. bfloat16 x is [T, N, dx_cols(D)]
// (D rounded up to 8), its pad columns zero.
extern "C" int lstm2_bwd_wgrad(const void* dy, const void* x, const void* g1, const void* c1,
                               const void* h1, const void* g2, const void* c2, const void* h2,
                               const void* w2p, const void* u1p, const void* w1p,
                               const void* fcw, void* dx, void* dw1, void* du1, void* dw2,
                               void* du2, void* db1, void* db2, void* scratch_dg1,
                               void* scratch_dg2, void* carry, void* db_part, int n_rows,
                               int steps, int D, int H, int O, int rows, int form, int chunk,
                               int dtype, void* stream) {
  if (!bwd::valid_shape(n_rows, steps, D, H, O) || chunk < 1) return (int)cudaErrorInvalidValue;
  const void* in[12] = {dy, x, g1, c1, h1, g2, c2, h2, w2p, u1p, w1p, fcw};
  void* out[11] = {dx, dw1, du1, dw2, du2, db1, db2, scratch_dg1, scratch_dg2, carry, db_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, out, n_rows, steps, D, H, O, rows, form, chunk, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(in, out, n_rows, steps, D, H, O, rows, form, chunk, s);
  return (int)cudaErrorInvalidValue;
}

// Forces the tile of dU1, dW2 and dU2 for later bf16 launches (0 .. H_TILES - 1,
// WGRAD_H_TILES order; -1: the rule `wgrad_tile`), to time the candidates.
// Returns the previous setting, or -2 for a shape there is not.
extern "C" int lstm2_bwd_wgrad_force_tile(int shape) {
  if (shape < -1 || shape >= H_TILES) return -2;
  const int before = g_forced_tile;
  g_forced_tile = shape;
  return before;
}
