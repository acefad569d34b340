// Reverse-sweep backward of the fused 2-layer LSTM with the weight
// gradients summed inside, for Hopper (sm_90a): the training step's default
// backward.
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
// 1.3 ms). Tensor cores: the bf16 reverse sweep's three products run on
// mma.sync (54 HMMA instructions in each bf16 sweep function, cuobjdump
// -sass; lstm2_bwd_sweep.cuh says what bounds it now: each CTA's step
// latency). FMA: the float32 sweep and `wgrad_kernel` in both types, so
// they stay well above either bound; `wgrad_kernel` is most of the bf16
// time now.
//
// Design. The TPU kernel keeps all 7.3 MB of float32 accumulators resident
// and relies on its grid running in order; here CTAs run at once and have
// 227 KB each. So the work is cut in time, not in rows: the steps are swept
// in chunks of `chunk` steps, newest first. For each chunk
//   1. the sweep (lstm2_bwd_sweep.cuh: `sweep_kernel` in float32,
//      `sweep_mma_kernel` in bf16; one CTA per row tile) runs the
//      chunk's steps, reads and leaves the four carries in a [4][N][H]
//      float32 array, writes the chunk's rounded dgates into a scratch
//      [chunk, N, 4H] x 2 (reused by every chunk: its size does not grow
//      with T and is chosen to stay near the L2's size), and adds the tile's
//      unrounded dgates into its own row of db_part;
//   2. `wgrad_kernel` adds A^T dg of the chunk into the four weight
//      gradients: a tiled product with both operands staged in shared
//      memory (the next slice's loads in flight during the current one's
//      products), each output element owned by one thread that reads it,
//      adds the chunk's steps and rows in a fixed order, and writes it back.
// Then `db_reduce_kernel` sums the tiles' bias rows in tile order. Kernels
// on one stream run in order and every sum has one owner and a fixed
// order, so the result is the same bit for bit on every run: no atomics.
//
// The C entry point launches on the caller's stream, allocates nothing
// (the caller passes outputs, zeroed weight gradients, scratch and carry
// arrays) and returns the first CUDA error.

#include "lstm2_bwd_sweep.cuh"

namespace {

constexpr int TILE = 128;  // output tile of wgrad_kernel: TILE x TILE
constexpr int NB = 16;     // rows of the contraction staged at a time
constexpr int MICRO = 8;   // each of the 16 x 16 threads owns MICRO x MICRO outputs:
                           // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns alike
                           // with tx, so its operands are four float4 loads a slice row

template <typename T>
struct WgradArgs {
  const T* x;     // [T, N, D]
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
        int rows, int chunk, cudaStream_t stream) {
  bwd::SweepArgs<T> s;
  s.dy = static_cast<const T*>(in[0]);
  s.g1 = static_cast<const T*>(in[2]);
  s.c1 = static_cast<const T*>(in[3]);
  s.g2 = static_cast<const T*>(in[5]);
  s.c2 = static_cast<const T*>(in[6]);
  s.w2t = static_cast<const T*>(in[8]);
  s.u1t = static_cast<const T*>(in[9]);
  s.w1t = static_cast<const T*>(in[10]);
  s.w2p = static_cast<const uint4*>(in[11]);
  s.u1p = static_cast<const uint4*>(in[12]);
  s.w1p = static_cast<const uint4*>(in[13]);
  s.fcw = static_cast<const float*>(in[14]);
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
  const dim3 wgrid((G + TILE - 1) / TILE, (D + TILE - 1) / TILE + 3 * ((H + TILE - 1) / TILE));
  for (int t_hi = steps - 1; t_hi >= 0; t_hi -= chunk) {
    const int t_lo = t_hi - chunk + 1 > 0 ? t_hi - chunk + 1 : 0;
    s.t_hi = w.t_hi = t_hi;
    s.t_lo = s.t_base = w.t_lo = t_lo;
    s.resume = t_hi != steps - 1;
    int err = bwd::launch_sweep<T>(s, rows, stream);
    if (err != 0) return err;
    wgrad_kernel<T><<<wgrid, 256, 0, stream>>>(w);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int tiles = (n_rows + rows - 1) / rows;
  db_reduce_kernel<<<(G + 255) / 256, 256, 0, stream>>>(
      s.db_part, static_cast<float*>(out[5]), static_cast<float*>(out[6]), tiles, G);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, x, the residuals, the weights, dx
// and the dgates scratch; fcw and every gradient sum are float32). float32
// reads the transposed weights w2t, u1t, w1t and rows is 16 or 20;
// bfloat16 reads the packed fragments w2p, u1p, w1p
// (ops/lstm2_train.py::pack_mma_b) and rows is 16; the other three weight
// pointers may be null. chunk: the steps the scratch holds. dw1, du1, dw2,
// du2 must arrive zeroed; carry is [4][ceil(N / rows) * rows][H] and
// db_part [ceil(N / rows)][2][4H] float32.
extern "C" int lstm2_bwd_wgrad(const void* dy, const void* x, const void* g1, const void* c1,
                               const void* h1, const void* g2, const void* c2, const void* h2,
                               const void* w2t, const void* u1t, const void* w1t,
                               const void* w2p, const void* u1p, const void* w1p,
                               const void* fcw, void* dx, void* dw1, void* du1, void* dw2,
                               void* du2, void* db1, void* db2, void* scratch_dg1,
                               void* scratch_dg2, void* carry, void* db_part, int n_rows,
                               int steps, int D, int H, int O, int rows, int chunk, int dtype,
                               void* stream) {
  if (!bwd::valid_shape(n_rows, steps, D, H, O) || chunk < 1) return (int)cudaErrorInvalidValue;
  const void* in[15] = {dy, x, g1, c1, h1, g2, c2, h2, w2t, u1t, w1t, w2p, u1p, w1p, fcw};
  void* out[11] = {dx, dw1, du1, dw2, du2, db1, db2, scratch_dg1, scratch_dg2, carry, db_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(in, out, n_rows, steps, D, H, O, rows, chunk, s);
  if (dtype == 1) return run<__nv_bfloat16>(in, out, n_rows, steps, D, H, O, rows, chunk, s);
  return (int)cudaErrorInvalidValue;
}
