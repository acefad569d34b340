// The reverse sweep of the fused 2-layer LSTM's backward, shared by
// lstm2_bwd.cu (which keeps the dgates of every step) and
// lstm2_bwd_wgrad.cu (which sweeps a few steps at a time and sums the
// weight gradients itself).
//
// Per step t = t_hi .. t_lo, for the R rows of the CTA's tile
// (fullsubnet_plus_tpu/ops/lstm_pallas.py:433-467, cell backward :392-412):
//   dh2   = dy_t W_fc^T + dh2_carry
//   dgates2, dc2 = cell_bwd(dh2, g2_t, c2_t, c2_{t-1}, dc2)     c_{-1} = 0
//   [dh1' | dh2_carry] = round(dgates2) [W2; U2]^T
//   dgates1, dc1 = cell_bwd(dh1' + dh1_carry, g1_t, c1_t, c1_{t-1}, dc1)
//   dh1_carry = round(dgates1) U1^T,   dx_t = round(dgates1) W1^T
// round() is the cast to the weight type T (none in float32); the carries
// stay float32.
//
// Three forms, which the caller chooses by the fold's shape
// (`bwd_sweep_form` in ops/lstm2_train.py): the tile form where the card
// holds every row tile at once, the wave form where it does not (the
// shipped training folds: 144 tiles on 132 SMs), and the cluster form
// (`sweep_cluster_kernel`, below) at FullSubNet's full-band folds. The tile
// and wave forms run `sweep_mma_kernel`.
//
// The wave form runs the tile form's kernel on the same work cut into items
// of (row tile, part of part_steps steps): item k is tile k mod tiles over
// part k div tiles, newest steps first, and each launch runs the next
// min(SMs, tiles) items, a CTA an SM (`launch_mma`). An item starts from the
// carries (and adds to the bias sums) its tile's previous part left in
// device memory, which an earlier launch wrote, so stream order is all the
// synchronisation there is, and each item runs the tile form's arithmetic
// in its order: the same dx and dgates bit for bit (K3's bias sums are
// grouped by item). At N 2304 the tile form runs 144 CTAs as a full wave of
// 132 and a second of 12 that leaves 120 SMs idle for as long again; the
// wave form keeps the 132 SMs busy but for the last launch.
//
// The tile form, `sweep_mma_kernel<T>`: one CTA per tile of R = 16 rows
// (one m16 tile) for all its steps, H threads. Thread j runs the cell
// backward of unit j for every row of the tile, so both dc carries stay in
// its registers; the dh carries live in shared memory [R][H] float32. Its
// dy W_fc^T takes o in the outer loop, so each W_fc word is read from L2
// once a step for the tile's rows (each row still sums in ascending o: the
// same bits as the other order). The three products, which
// contract over the 4H gate columns, run on the tensor cores with float32
// sums, with no FMA product left:
//   bf16: mma.sync.m16n8k16 on bf16 operands (the TPU kernel's contract,
//     lstm_pallas.py:548-575);
//   float32: mma.sync.m16n8k8 on TF32 operands, each product as three TF32
//     products of split operands (lstm2_common.cuh, AFrag<float>): the
//     integer split of lstm2::split_tf32, each k-step of A split once for
//     the n-tiles of a pass, each k-chunk's products summed into a zeroed
//     partial that one FADD adds to the float32 sum (the tensor core
//     truncates its accumulation; PERF.md).
// A: the step's dgates, row-major [16][4H + pad] of T in shared memory (the
// 16-byte pad keeps the row pitch an odd multiple of 16 bytes, so ldmatrix
// is free of bank conflicts), read with ldmatrix (the same byte addresses
// give bf16's m16n8k16 fragment and float32's m16n8k8 one). B: the weights
// [W2; U2] [2H, 4H], U1 [H, 4H] and W1 [D, 4H] (row c: the weights of output
// column c, k-contiguous, the "col" layout), packed once per backward call
// into lane order (ops/lstm2.py: pack_mma_b for bf16, pack_tf32_b for
// float32): [n-tile of 8 columns][k-chunk of 64 bytes][lane][16 bytes] (W1
// zero-padded from D = 34 to 40 rows), read from L2 16 bytes a lane, so a
// warp reads 512 contiguous bytes a k-chunk; a float32 word is split in
// registers after its load, so L2 traffic stays 4 bytes a weight. Warp w
// takes n-tiles 8w .. 8w + 7 of [dh1' | dh2_carry] and 4w .. 4w + 3 of U1^T
// over all k, in passes of 4 n-tiles (float32 accumulators in registers).
// dx takes one of two forms, by `dx_ksplit` (the same rule as
// ops/lstm2_train.py's `bwd_dx_ksplit`):
//   k-split, where its partials fit a block: every n-tile of dx over the
//     warp's own 1 / (H / 32) of the k-chunks (its k-part: 128 of the 4H
//     gate columns), into a partial [16][dx_cols(D)] that the threads add
//     in warp order. At D 34 (5 n-tiles) every one of 12 warps has work.
//   output-stationary, where they do not (FullSubNet's full-band LSTM, D
//     257, H 512, O 257: 16 partials [16][264] alone would take 270,336
//     bytes): warp w owns n-tiles w, w + H / 32, ... of dx (33 n-tiles over
//     16 warps: 3 for warp 0, 2 for the others), multiplies them together
//     over all the k-chunks and stores them from its accumulators straight
//     to dx.
// The epilogues add into or overwrite dh1s / dh2s (each word one writer)
// between barriers, each dx word has one writer and a fixed summation
// order; no atomics, so the result is the same bit for bit on every run.
// Shared memory at H 384, D 34, O 2 (k-split): 129,408 bytes in bf16 and
// 178,560 in float32 (dgates 49.4 / 98.6 KB, dh1 and dh2 24.6 KB each, dx
// partials [12][16][40] 30.7 KB); at H 512, D 257, O 257
// (output-stationary): 147,776 and 213,312 (dgates 65.8 / 131.3 KB, dh1 and
// dh2 32.8 KB each, the dy tile 16.4 KB).
// cuobjdump -sass: 114 HMMA instructions in each of the two bf16 functions
// (H <= 384 and <= 512), 342 HMMA.1688.F32.TF32 in each float32 one, whose
// 384-thread function spills 80 bytes a thread (chip_smoke.py phase 1).
//
// What bounds the tile form (H100, PERF.md; scripts/time_torch_bwd_forms.py
// and scripts/profile_torch_bwd_sweep.py). At the training fold (N 2304, T
// 195) its 144 CTAs run in two waves on 132 SMs: a float32 step takes 220 us
// in the full wave and 188 us for the 12 CTAs of the second (bf16 102-111
// and 77-83), so the second wave costs nearly as much as the first: each
// CTA's step latency bounds the form (its products on one SM's tensor
// cores, the product loops' L2 round trips for the weight fragments, the
// cell backward's loads of the residuals), and the L2's bandwidth only adds
// a sixth to a third in a full wave. The wave form takes the second wave
// away: 247 / 116 us a step at N 2304, 48.1 / 22.6 ms a sweep against 79.2
// / 34.4 in the tile form.
//
// Tried and dropped (PERF.md): each warp's weight fragments streamed
// through a ring of 2 KB stages in shared memory by bulk copies (4 slots in
// bf16, 2 in float32: what fits beside this layout), with the next step's
// residuals prefetched into the L2: 1-9 % slower than the tile form; the
// same ring shared by clusters of 2 CTAs (each stage read once and
// multicast, every CTA's release gathered on an empty mbarrier): twice as
// slow, the handshake on each stage's path; the float32 weights split into
// their TF32 halves at packing (both halves loaded): slower; a persistent
// grid walking the work items with per-tile flags: as the wave form but
// for 500 bytes of spills a thread in float32 (its loop's state), 370
// against 223 us a full-wave step; layer 2 a step ahead in bf16 (two
// barrier intervals a step, one layer's product beside the other layer's
// cells, a dgates tile a layer and two d h1 buffers: 203,392 bytes), the
// same bits: with a warp's cells and product in whole halves nothing
// overlapped (each warp's step is its own chain of loads either way) and a
// full-wave step took 140.9 against 117.5 us (632 bytes of spills a thread
// against 264), with its cell rows between sixteenths of the product 190.1
// (2,824 bytes of spills); in float32 two dgates tiles beside the carries
// take 246,400 bytes, past a block.

#pragma once

#include <algorithm>
#include <type_traits>

#include "lstm2_common.cuh"

namespace bwd {

using lstm2::AFrag;
using lstm2::bulk_commit;
using lstm2::bulk_wait_read;
using lstm2::CHUNK_BYTES;
using lstm2::cluster_arrive;
using lstm2::cluster_ctarank;
using lstm2::cluster_idx;
using lstm2::cluster_nctarank;
using lstm2::cluster_wait;
using lstm2::copy_to_peer;
using lstm2::fence_proxy_async;
using lstm2::from_f;
using lstm2::k_chunk;
using lstm2::mbar_arrive_expect;
using lstm2::mbar_init;
using lstm2::mbar_wait;
using lstm2::peer_address;
using lstm2::SMEM_LIMIT;
using lstm2::to_f;

constexpr int MMA_ROWS = 16;       // the row tile: one m16 tile (MMA_ROWS_PER_CTA)
constexpr int MMA_PAD_BYTES = 16;  // pad of a dgates row in shared memory (MMA_PAD_BYTES)

// W1's rows (the dx columns), zero-padded to n-tiles of 8
__host__ __device__ inline int dx_cols(int D) { return (D + 7) / 8 * 8; }

// elements of a dgates row in shared memory: the 4H gate columns and the pad
template <typename T> __host__ __device__ inline int dgates_pitch(int H) {
  return 4 * H + MMA_PAD_BYTES / (int)sizeof(T);
}

// the dgates [16][pitch] of T, then float32 the dh1 and dh2 carries [16][H],
// the dy tile [16][O] and, in the k-split form, a dx partial per warp
// [H / 32][16][dx_cols(D)]
template <typename T> inline size_t shared_bytes_form(int D, int H, int O, bool ksplit) {
  return sizeof(T) * (size_t)MMA_ROWS * dgates_pitch<T>(H) +
         sizeof(float) * (size_t)MMA_ROWS * (2 * H + O + (ksplit ? (H / 32) * dx_cols(D) : 0));
}

// dx's form: the k-split wherever its partials fit a block, else
// output-stationary (`bwd_dx_ksplit` in ops/lstm2_train.py)
template <typename T> inline bool dx_ksplit(int D, int H, int O) {
  return shared_bytes_form<T>(D, H, O, true) <= SMEM_LIMIT;
}

template <typename T> inline size_t shared_bytes(int D, int H, int O) {
  return shared_bytes_form<T>(D, H, O, dx_ksplit<T>(D, H, O));
}

template <typename T>
struct SweepArgs {
  const T* dy;     // [N, T, O]
  const T* g1;     // [T, N, 4H] activated gates, layer 1
  const T* c1;     // [T, N, H]
  const T* g2;
  const T* c2;
  const uint4* w2p;  // [W2; U2], U1, W1 as packed mma fragments (see above)
  const uint4* u1p;
  const uint4* w1p;
  const float* fcw;  // [H, O]
  T* dg1;          // [t_hi - t_base + 1, N, 4H]: step t at index t - t_base
  T* dg2;
  T* dx;           // [T, N, D]
  float* carry;    // [4][tiles * R][H]: dh1, dc1, dh2, dc2 between sweeps, or null
  float* db_part;  // [tiles][2][4H]: this tile's sums of the unrounded dgates, or null
  int n_rows, steps, D, H, O;
  int t_hi, t_lo, t_base;
  int resume;      // 0: carries and bias sums start from zero; 1: read them
  int dx_ksplit;   // dx's form (set by launch_mma from dx_ksplit<T>)
  // The tile and wave forms' work items: CTA b takes item item0 + b, row
  // tile (item0 + b) % tiles over part (item0 + b) / tiles of part_steps
  // steps, t_hi first (the tile form: item0 0, one part of all the steps)
  int item0, part_steps;
  int late_sends;  // the cluster form: 1 for rank 0 to send its blocks after its own
                   // products (a test of the exchange's order), else 0
};

// One cell's backward from its activated gates (i, f, g, o), c_t and
// c_{t-1}: its four dgates d, unrounded; dc is the carry in and out
// (lstm_pallas.py:392-412).
__device__ __forceinline__ void cell_grads(float dh, float& dc, float gi, float gf, float gg,
                                           float go, float c, float c_prev, float (&d)[4]) {
  const float tanh_c = tanhf(c);
  const float d_o = dh * tanh_c;
  const float d_c = dh * go * (1.0f - tanh_c * tanh_c) + dc;
  const float di = d_c * gg, dg = d_c * gi, df = d_c * c_prev;
  dc = d_c * gf;
  d[0] = di * gi * (1.0f - gi);
  d[1] = df * gf * (1.0f - gf);
  d[2] = dg * (1.0f - gg * gg);
  d[3] = d_o * go * (1.0f - go);
}

// The cell backward of unit j for the tile's rows: rounds the dgates to T,
// stores them in the shared dgates (row-major, pitch ld) and (rows that
// exist) in dg_t, updates dc and adds the unrounded dgates to db.
// (Issuing a quad's 24 loads together from raw bits, without the row
// branch, was tried and ran a third slower: it costs registers.)
template <typename T, int R>
__device__ __forceinline__ void cell_bwd(const float (&dh)[R], float (&dc)[R], float (&db)[4],
                                         const T* __restrict__ g_t, const T* __restrict__ c_t,
                                         const T* __restrict__ c_prev_t,
                                         T* __restrict__ dg_t, T* __restrict__ dgs,
                                         int rows_here, int H, int j, int ld) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f, c = 0.f, c_prev = 0.f;
    if (r < rows_here) {
      const T* gr = g_t + (size_t)r * 4 * H + j;
      gi = to_f(gr[0]);
      gf = to_f(gr[H]);
      gg = to_f(gr[2 * H]);
      go = to_f(gr[3 * H]);
      c = to_f(c_t[(size_t)r * H + j]);
      if (c_prev_t != nullptr) c_prev = to_f(c_prev_t[(size_t)r * H + j]);
    }
    float d[4];
    cell_grads(dh[r], dc[r], gi, gf, gg, go, c, c_prev, d);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      db[g] += d[g];  // a row past N has zero gates, carries and dy: adds 0
      const T rounded = from_f<T>(d[g]);
      if (r < rows_here) dg_t[(size_t)r * 4 * H + g * H + j] = rounded;
      dgs[(size_t)r * ld + g * H + j] = rounded;
    }
  }
}

// acc[i] += dgates . B[n-tile i * stride] over the k-chunks [kc0, kc1) (64
// bytes of a dgates row each, two k-steps), in k order. a_addr: this lane's
// ldmatrix address in the dgates; B: this lane's 16 bytes of n-tile 0 and
// k-chunk 0; n-tile i, k-chunk kc are at B[(i * chunks + kc) * 32].
template <typename T, int NT>
__device__ __forceinline__ void mma_tiles(float (&acc)[NT][4], uint32_t a_addr,
                                          const uint4* __restrict__ B, int chunks, int kc0,
                                          int kc1, int stride = 1) {
#pragma unroll 2
  for (int kc = kc0; kc < kc1; ++kc) {
    uint4 b[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) b[i] = __ldg(B + ((size_t)i * stride * chunks + kc) * 32);
    AFrag<T> a;
    a.load(a_addr + kc * CHUNK_BYTES);
#pragma unroll
    for (int i = 0; i < NT; ++i) a.mma(acc[i], b[i]);
  }
}

// This lane's accumulator words into out[row][8i + column] (row pitch
// ld_out), added to what is there when `add`.
template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], float* out, int ld_out,
                                          int lane, bool add) {
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // rows fr, fr + 8; columns fc, fc + 1
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* word = out + (fr + 8 * (e >> 1)) * ld_out + 8 * i + fc + (e & 1);
      *word = add ? acc[i][e] + *word : acc[i][e];
    }
}

// This lane's accumulator words of dx n-tile `nt` into the step's dx rows
// (row pitch D), rounded to T: rows past rows_here and columns past D are
// not stored.
template <typename T>
__device__ __forceinline__ void store_dx(const float (&acc)[4], T* __restrict__ dx_t, int D,
                                         int nt, int rows_here, int lane) {
  const int fr = lane >> 2, fc = 8 * nt + 2 * (lane & 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = fr + 8 * (e >> 1), c = fc + (e & 1);
    if (r < rows_here && c < D) dx_t[(size_t)r * D + c] = from_f<T>(acc[e]);
  }
}

// Output-stationary dx: NT of this warp's n-tiles, nt0, nt0 + warps, ...,
// each over all the k-chunks, stored to the step's dx rows.
template <typename T, int NT>
__device__ __forceinline__ void dx_tiles(uint32_t a_addr, const uint4* __restrict__ w1p,
                                         T* __restrict__ dx_t, int chunks, int nt0, int warps,
                                         int D, int rows_here, int lane) {
  float acc[NT][4] = {};
  mma_tiles<T, NT>(acc, a_addr, w1p + (size_t)nt0 * chunks * 32 + lane, chunks, 0, chunks, warps);
#pragma unroll
  for (int i = 0; i < NT; ++i) store_dx<T>(acc[i], dx_t, D, nt0 + i * warps, rows_here, lane);
}

// The sweep for a tile of 16 rows. The tile's dgates sit in shared memory
// as T [16][4H + pad], and warp w of the H / 32 computes, in passes of 4
// n-tiles of 8 columns:
//   [dh1' | dh2_carry]: n-tiles 8w .. 8w + 7 of the 2H columns over all k,
//     the first H columns added into dh1s, the last H written to dh2s;
//   dh1_carry: n-tiles 4w .. 4w + 3 of the H columns over all k, into dh1s;
//   dx, k-split: every n-tile of the D columns over its own share of the
//     k-chunks (its k-part), into its own partial, which 16 x D threads then
//     add in warp order; output-stationary: n-tiles w, w + H / 32, ... over
//     all the k-chunks, stored straight to dx.
// Each output word has one writer and each sum a fixed order.
template <typename T, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
sweep_mma_kernel(const SweepArgs<T> a) {
  constexpr int R = MMA_ROWS;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int D = a.D, H = a.H, O = a.O, G = 4 * a.H, ld = dgates_pitch<T>(H);
  const int warps = H / 32, chunks = G / k_chunk<T>(), dxc = dx_cols(D);
  T* dgs = reinterpret_cast<T*>(smem_mma);                         // [R][ld]
  float* dh1s = reinterpret_cast<float*>(dgs + (size_t)R * ld);  // [R][H]
  float* dh2s = dh1s + R * H;                                    // [R][H]
  float* dys = dh2s + R * H;                                     // [R][O]
  float* dxp = dys + R * O;  // k-split: [warps][R][dxc]; output-stationary: not there

  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  const int tiles = (a.n_rows + R - 1) / R, item = a.item0 + blockIdx.x;
  const int part = item / tiles, tile = item - part * tiles;
  const int t_hi = a.t_hi - part * a.part_steps, t_lo = max(a.t_lo, t_hi - a.part_steps + 1);
  const bool resume = a.resume || part > 0;  // a later part starts from the earlier's carries
  const int n0 = tile * R;
  const int rows_here = min(R, a.n_rows - n0);
  const size_t n_pad = (size_t)tiles * R;
  const uint32_t a_addr =
      (uint32_t)__cvta_generic_to_shared(dgs + (size_t)(lane & 15) * ld) + 16 * (lane >> 4);

  float dc1[R], dc2[R];
  float db[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (resume) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = a.carry[((size_t)c * n_pad + n0 + r) * H + j];
    }
    dh1s[r * H + j] = v[0];
    dc1[r] = v[1];
    dh2s[r * H + j] = v[2];
    dc2[r] = v[3];
  }

  for (int t = t_hi; t >= t_lo; --t) {
    const size_t row0 = (size_t)t * a.n_rows + n0;
    const size_t prev0 = row0 - a.n_rows;  // used only when t > 0
    const size_t dg0 = ((size_t)(t - a.t_base) * a.n_rows + n0) * G;
    for (int idx = j; idx < R * O; idx += H) {
      const int r = idx / O, o = idx - r * O;
      dys[idx] = (r < rows_here) ? to_f(a.dy[((size_t)(n0 + r) * a.steps + t) * O + o]) : 0.0f;
    }
    __syncthreads();  // dy tile ready; the last step's reads of dgs and dxp are done

    // layer 2: dy W_fc^T with o outside, so each W_fc word is read once a
    // step for the tile's rows; each row still sums in ascending o
    float dh[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = 0.0f;
    for (int o = 0; o < O; ++o) {
      const float w = a.fcw[j * O + o];
#pragma unroll
      for (int r = 0; r < R; ++r) dh[r] = fmaf(dys[r * O + o], w, dh[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = dh[r] + dh2s[r * H + j];
    cell_bwd<T, R>(dh, dc2, db[1], a.g2 + row0 * G, a.c2 + row0 * H,
                   t > 0 ? a.c2 + prev0 * H : nullptr, a.dg2 + dg0, dgs, rows_here, H, j, ld);
    __syncthreads();  // dgates2 complete

#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int col0 = (8 * warp + 4 * pass) * 8;  // a pass lies in dh1' or in the dh2 carry
      float acc[4][4] = {};
      mma_tiles<T, 4>(acc, a_addr, a.w2p + (size_t)col0 * chunks * 4 + lane, chunks, 0, chunks);
      if (col0 < H)
        store_acc(acc, dh1s + col0, H, lane, true);  // d h1_t = d h1' + the carry
      else
        store_acc(acc, dh2s + col0 - H, H, lane, false);  // d h2_{t-1}
    }
    __syncthreads();  // dgates2 read, dh1s holds d h1_t

    // layer 1
#pragma unroll
    for (int r = 0; r < R; ++r) dh[r] = dh1s[r * H + j];
    cell_bwd<T, R>(dh, dc1, db[0], a.g1 + row0 * G, a.c1 + row0 * H,
                   t > 0 ? a.c1 + prev0 * H : nullptr, a.dg1 + dg0, dgs, rows_here, H, j, ld);
    __syncthreads();  // dgates1 complete; every thread has read its d h1_t

    {
      float acc[4][4] = {};
      mma_tiles<T, 4>(acc, a_addr, a.u1p + (size_t)warp * 32 * chunks * 4 + lane, chunks, 0,
                      chunks);
      store_acc(acc, dh1s + warp * 32, H, lane, false);  // d h1_{t-1}
    }
    if (a.dx_ksplit) {
      for (int nt = 0; nt < dxc / 8; ++nt) {
        float acc[1][4] = {};
        mma_tiles<T, 1>(acc, a_addr, a.w1p + (size_t)nt * chunks * 32 + lane, chunks,
                        warp * chunks / warps, (warp + 1) * chunks / warps);
        store_acc(acc, dxp + (size_t)warp * R * dxc + 8 * nt, dxc, lane, false);
      }
      __syncthreads();  // dx partials complete
      for (int idx = j; idx < R * D; idx += H) {
        const int r = idx / D, d = idx - r * D;
        float s = 0.0f;
        for (int p = 0; p < warps; ++p) s += dxp[((size_t)p * R + r) * dxc + d];
        if (r < rows_here) a.dx[row0 * D + idx] = from_f<T>(s);
      }
    } else {
      // output-stationary, up to 4 of the warp's n-tiles a pass (D <= H
      // gives each warp at most 4); the next step's first barrier orders
      // these reads of the dgates before its cell backward overwrites them
      T* dx_t = a.dx + row0 * D;
      for (int nt = warp; nt < dxc / 8; nt += 4 * warps) {
        switch (min(4, (dxc / 8 - nt + warps - 1) / warps)) {
          case 4: dx_tiles<T, 4>(a_addr, a.w1p, dx_t, chunks, nt, warps, D, rows_here, lane); break;
          case 3: dx_tiles<T, 3>(a_addr, a.w1p, dx_t, chunks, nt, warps, D, rows_here, lane); break;
          case 2: dx_tiles<T, 2>(a_addr, a.w1p, dx_t, chunks, nt, warps, D, rows_here, lane); break;
          default: dx_tiles<T, 1>(a_addr, a.w1p, dx_t, chunks, nt, warps, D, rows_here, lane);
        }
      }
    }
  }

  if (a.carry != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v[4] = {dh1s[r * H + j], dc1[r], dh2s[r * H + j], dc2[r]};
#pragma unroll
      for (int c = 0; c < 4; ++c) a.carry[((size_t)c * n_pad + n0 + r) * H + j] = v[c];
    }
  }
  if (a.db_part != nullptr) {
#pragma unroll
    for (int l = 0; l < 2; ++l)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float* dst = a.db_part + ((size_t)tile * 2 + l) * G + g * H + j;
        *dst = resume ? *dst + db[l][g] : db[l][g];
      }
  }
}

// The tile form (part_steps 0): one launch, a CTA a row tile over all the
// steps. The wave form (part_steps > 0; the note at the top): the tiles x
// parts of part_steps steps as work items, part-major, in launches of as
// many CTAs as the card holds at once, so every item's previous part ran in
// an earlier launch.
template <typename T, int MAX_THREADS>
int launch_mma(const SweepArgs<T>& a, cudaStream_t stream) {
  SweepArgs<T> b = a;
  b.dx_ksplit = dx_ksplit<T>(a.D, a.H, a.O);
  const size_t smem = shared_bytes<T>(a.D, a.H, a.O);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = sweep_mma_kernel<T, MAX_THREADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.n_rows + MMA_ROWS - 1) / MMA_ROWS, span = a.t_hi - a.t_lo + 1;
  if (a.part_steps <= 0) {
    b.item0 = 0;
    b.part_steps = span;
    kernel<<<tiles, a.H, smem, stream>>>(b);
    return (int)cudaGetLastError();
  }
  if (a.carry == nullptr) return (int)cudaErrorInvalidValue;  // the parts' carries
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, a.H, smem)) !=
          cudaSuccess)
    return (int)err;
  // a wave holds no more items than tiles, so an item's previous part (tiles
  // items back) ran in an earlier launch
  const int wave = std::min(sms * per_sm, tiles);
  const int items = tiles * ((span + a.part_steps - 1) / a.part_steps);
  if (wave < 1) return (int)cudaErrorInvalidConfiguration;
  for (b.item0 = 0; b.item0 < items; b.item0 += wave) {
    kernel<<<std::min(wave, items - b.item0), a.H, smem, stream>>>(b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The cluster form, `sweep_cluster_kernel<T>`: for folds of a few row
// tiles (FullSubNet's full-band LSTM in training: N 18 at D 257, H 512, O
// 257), where one CTA a tile leaves the card idle and every step waits on
// one SM pulling all the weight fragments from L2 ([W2; U2], U1 and W1
// padded to 264 rows: 14.7 MB in float32, 7.4 in bf16, a tile and step).
// Each tile of 16 rows gets a cluster of C = H / 32 CTAs (16 at H 512); CTA
// rank c owns the U = 32 hidden units U_c = [cU, (c + 1) U) of both layers,
// and pulls only the weights of the output columns those units need (about
// 0.95 MB a step in float32 and 0.47 in bf16 at H 512):
//   * cell backwards: thread (warp r, lane l) runs cell (r, cU + l) of each
//     layer, with its dc and dh carries in registers;
//     its residuals (g in four strips, c, c_{t-1}) are loaded into registers
//     a phase ahead (layer 1's during layer 2's exchange and product, layer
//     2's for step t - 1 during the reduction of step t);
//   * dy W_fc^T: W_fc's rows of U_c sit in shared memory [U][fc_ld] from the
//     launch on (no word of W_fc is read from L2 twice); the dy tile
//     [16][fc_ld] of step t - 1 is loaded during step t, and 4U threads of
//     the warps that compute dx (fewer n-tiles than the dh1 carry's) sum its
//     dy W_fc^T after their products, 4 rows a thread, each row in
//     ascending o;
//   * the exchange: a product contracts over all 4H gate columns, so each
//     CTA keeps the tile's whole dgates, owner-major: block o (the units of
//     CTA o) is [16][4U + pad] of T, its row the four gates' strips of U
//     (the pad of 16 bytes keeps the row pitch an odd multiple of 16 bytes,
//     so ldmatrix is free of bank conflicts; a k-chunk of 64 bytes lies in
//     one strip). After a cell backward a CTA writes its block, then one
//     thread copies it whole into every peer's copy with the Tensor Memory
//     Accelerator (cp.async.bulk shared::cta -> shared::cluster, 8,448 bytes
//     in float32, 4,352 in bf16), each copy completing its bytes on the
//     peer's mbarrier for that owner. The all-gather is bound by the
//     SM-to-SM network (about 23 GB/s a SM measured on the H100: 5.5 us an
//     exchange in float32), so the products overlap it: their k-chunks run
//     owner-major, a warp's k-part spans C / KP owners' blocks, and the warp
//     waits for an owner's mbarrier only when its chunks reach that block
//     (`owned_mma`). (A k-part taking a chunk of every block in the order
//     the blocks arrive, one wait a block, measured slower: PERF.md.)
//     A block is overwritten in the peers only once every peer has read it:
//     a CTA arrives on the cluster barrier (release) when its products have
//     read the dgates, and waits (acquire) before it sends, two arrive /
//     wait halves a step. And a CTA writes its own block again only once
//     its copies have read it: thread 0 commits its copies as a bulk group
//     and waits for the group's reads before the block barrier that ends
//     the products (`Exchange::sent`); the peers' blocks arriving says
//     nothing of this CTA's copies leaving;
//   * the products on the tensor cores (mma.sync, AFrag<T> as in the tile
//     form), each CTA only the columns its units need: [dh1' | dh2_carry]
//     columns U_c and H + U_c, dh1_carry columns U_c, and the dx n-tiles nt
//     = c (mod C). Warp w runs k-part w % KP (KP runs of k-chunks) of column
//     group w / KP: dh1' or the dh2 carry, then the dh1 carry or dx; the
//     threads add the partials [KP][16][2U + 8] in k-part order.
// Each output word has one writer and each sum a fixed order; no atomics.
// Shared memory at H 512, O 257, C 16: the owners' mbarriers (128 bytes),
// the dgates (135,168 bytes in float32, 69,632 in bf16), W_fc's rows
// (33,280), the dy tile (16,640), the partials (36,864) and dy W_fc^T
// [16][U] (2,048): 224,128 / 158,592 bytes. (64 units a CTA, clusters of
// 8, fit only in bf16 and measured slower there: PERF.md.)
//
// What bounds it on the H100 (N 18, T 195; PERF.md): a float32 step takes
// about 37 us, 6.8 ms a sweep against cuDNN's 13.0 ms backward: its
// products 22 us (their weight loads 7), the copies' share left exposed
// 6-8, dy W_fc^T 3; bf16 17 us (products 6). With no arithmetic a step
// still takes 15 / 11 us (the all-gathers, the barriers, the loads and
// stores): the step floor of this design, 2.9 / 2.1 ms a sweep, far over
// the operations bound (0.16 / 0.03 ms) that no recurrence at 18 rows
// approaches.

constexpr int CL_UNITS = 32;     // hidden units a CTA owns: a lane a unit
constexpr int CL_THREADS = 512;  // 16 warps: a warp a row in the cell backwards
constexpr int CL_KPARTS = 8;     // k-parts of each product
constexpr int CL_MAX_O = 288;    // the dy tile's rows, loaded 32 words a pass: 9 passes
constexpr int CL_BAR_BYTES = 8 * 16;  // an mbarrier an owner, at the start of shared memory

// A row of W_fc's slice and of the dy tile: O rounded up to an odd number
// of 16-byte words, so 8 lanes' float4 reads of 8 rows hit distinct banks.
__host__ __device__ inline int cl_fc_ld(int O) {
  const int ld = (O + 3) / 4 * 4;
  return (ld / 4) % 2 ? ld : ld + 4;
}

// A row of the partials: 2U columns (a product's two column groups) and a
// pad of 8, so a half-warp's rows start 8 banks apart.
__host__ __device__ inline int cl_part_ld(int U) { return 2 * U + 8; }

// elements of a row of an owner's dgates block: the four strips of U and the pad
template <typename T> __host__ __device__ inline int cl_block_pitch(int U) {
  return 4 * U + MMA_PAD_BYTES / (int)sizeof(T);
}

// `bwd_cluster_shared_memory_bytes` in ops/lstm2_train.py
template <typename T> inline size_t cluster_shared_bytes(int H, int O) {
  constexpr int U = CL_UNITS;
  return CL_BAR_BYTES + sizeof(T) * (size_t)(H / U) * MMA_ROWS * cl_block_pitch<T>(U) +
         sizeof(float) * ((size_t)(U + MMA_ROWS) * cl_fc_ld(O) +
                          (size_t)CL_KPARTS * MMA_ROWS * cl_part_ld(U) + (size_t)MMA_ROWS * U);
}

// The cluster form's C (`SWEEP_CLUSTER` in ops/lstm2_train.py): 16 CTAs of
// 32 units, H 512. (Clusters of 8, 64 units a CTA, took longer in bf16 at
// FullSubNet's full-band fold and do not fit a block in float32: PERF.md.)
constexpr int CLUSTER_SIZE = 16;

// Whether the cluster form runs at this shape: H = CLUSTER_SIZE x 32, D <=
// H, O <= CL_MAX_O and a CTA's shared memory fits a block. The caller
// chooses the form (`bwd_sweep_cluster` in ops/lstm2_train.py); a launch of
// the cluster form where this is false returns an error.
template <typename T> inline bool cluster_runs(int D, int H, int O) {
  return H == CLUSTER_SIZE * CL_UNITS && D <= H && O <= CL_MAX_O &&
         cluster_shared_bytes<T>(H, O) <= SMEM_LIMIT;
}

// This thread's residuals of one layer at step t: the activated gates of
// its cell (unit j), c_t and c_{t-1} (zero past the fold's rows and before
// t = 0)
template <typename T>
struct CellInputs {
  T g[4], c, c_prev;
  __device__ __forceinline__ void load(const T* __restrict__ gates, const T* __restrict__ cs,
                                       size_t row, size_t n_rows, int t, int H, int j,
                                       bool live) {
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = live ? gates[row * 4 * H + q * H + j] : from_f<T>(0.0f);
    c = live ? cs[row * H + j] : from_f<T>(0.0f);
    c_prev = live && t > 0 ? cs[(row - n_rows) * H + j] : from_f<T>(0.0f);
  }
};

// The cell backward of this thread's cell -> its dgates d (unrounded)
template <typename T>
__device__ __forceinline__ void cell_bwd_one(float dh, float& dc, float (&db)[4],
                                             const CellInputs<T>& in, float (&d)[4]) {
  cell_grads(dh, dc, to_f(in.g[0]), to_f(in.g[1]), to_f(in.g[2]), to_f(in.g[3]), to_f(in.c),
             to_f(in.c_prev), d);
#pragma unroll
  for (int q = 0; q < 4; ++q) db[q] += d[q];
}

// Where the exchange happens: this CTA's block (own), the shared-memory
// addresses of block 0 and of owner 0's mbarrier (owner o's 8 o bytes on),
// a block's bytes, the parity of the latest exchange's mbarrier phase, this
// CTA's rank c of C, a block row's pitch, and `late` (SweepArgs::late_sends).
template <typename T>
struct Exchange {
  T* own;
  uint32_t blocks, bars, block_bytes, parity;
  int c, C, pitch;
  bool late;

  // Thread 0: each peer's mbarrier here expects one block for the next
  // exchange. Only once every warp has waited on the last phase.
  __device__ __forceinline__ void arm() const {
    if (threadIdx.x == 0)
      for (int o = 0; o < C; ++o)
        if (o != c) mbar_arrive_expect(bars + 8 * o, block_bytes);
  }

  // Thread 0: this CTA's block into every peer's copy, completing on that
  // peer's mbarrier for this owner, the copies committed as one bulk group.
  __device__ __forceinline__ void send() const {
    const uint32_t src = blocks + c * block_bytes, bar = bars + 8 * c;
    for (int p = 1; p < C; ++p) {
      const uint32_t peer = (uint32_t)((c + p) % C);
      copy_to_peer(peer_address(src, peer), src, block_bytes, peer_address(bar, peer));
    }
    bulk_commit();
  }

  // The dgates d of this thread's cell, rounded to T, into dg_t (rows that
  // exist) and this CTA's block; once every peer has read its dgates
  // (cluster wait), thread 0 sends the block (with late_sends, rank 0 sends
  // only at `sent`, after its own products). The products wait for the
  // peers' blocks (`owned_mma`).
  __device__ __forceinline__ void run(const float (&d)[4], T* __restrict__ dg_t, int H, int r,
                                      int lane, bool live) {
    constexpr int U = CL_UNITS;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T v = from_f<T>(d[q]);
      if (live) dg_t[(size_t)r * 4 * H + q * H + c * U + lane] = v;
      own[r * pitch + q * U + lane] = v;
    }
    fence_proxy_async();  // the block, to the copies
    parity ^= 1u;
    __syncthreads();
    cluster_wait();  // every peer has read the dgates these copies overwrite
    if (threadIdx.x == 0 && !(late && c == 0)) send();
  }

  // Before the block barrier that ends this exchange's products: thread 0
  // (late_sends: rank 0 sending now) waits until its copies have read the
  // block, so no thread writes it again under a copy still reading it.
  __device__ __forceinline__ void sent() const {
    if (threadIdx.x != 0) return;
    if (late && c == 0) send();
    bulk_wait_read<0>();
  }
};

// acc[i] += dgates . B[n-tile i * stride] over this warp's k-part: the
// k-chunks q0 .. q1 - 1 in owner-major order (q: owner o's gate g strip's
// chunk s; in the packing, chunk g H / kch + o U / kch + s), waiting for an
// owner's block (its mbarrier's phase of this parity) where the chunks reach
// it; the weights are loaded before the wait. B: this lane's 16 bytes of
// n-tile 0, k-chunk 0.
template <typename T, int NT, int U>
__device__ __forceinline__ void owned_mma(float (&acc)[NT][4], uint32_t a_base,
                                          const uint4* __restrict__ B, int chunks, int q0,
                                          int q1, int stride, int H, int pitch,
                                          const Exchange<T>& ex) {
  constexpr int kch = k_chunk<T>(), strip = U / kch, per_owner = 4 * strip;
  int waited = -1;  // the last owner waited for (its own block needs no wait)
#pragma unroll 2
  for (int q = q0; q < q1; ++q) {
    const int o = q / per_owner, g = q % per_owner / strip, s = q % strip;
    const int kc = g * (H / kch) + o * strip + s;
    uint4 b[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) b[i] = __ldg(&B[((size_t)i * stride * chunks + kc) * 32]);
    if (o != waited && o != ex.c) {
      mbar_wait(ex.bars + 8 * o, ex.parity);
      waited = o;
    }
    AFrag<T> a;
    a.load(a_base + (uint32_t)((o * MMA_ROWS * pitch + g * U + s * kch) * (int)sizeof(T)));
#pragma unroll
    for (int i = 0; i < NT; ++i) a.mma(acc[i], b[i]);
  }
}

// NT n-tiles at stride `stride` (`owned_mma`) into this warp's partial (row
// pitch ld_out), for ndx == NT; fewer by recursion.
template <typename T, int NT, int U>
__device__ __forceinline__ void dx_parts(int ndx, uint32_t a_base, const uint4* __restrict__ B,
                                         int chunks, int q0, int q1, int stride, int H,
                                         int pitch, const Exchange<T>& ex, float* out,
                                         int ld_out, int lane) {
  if (ndx == NT) {
    float acc[NT][4] = {};
    owned_mma<T, NT, U>(acc, a_base, B, chunks, q0, q1, stride, H, pitch, ex);
    store_acc(acc, out, ld_out, lane, false);
  } else if constexpr (NT > 1) {
    dx_parts<T, NT - 1, U>(ndx, a_base, B, chunks, q0, q1, stride, H, pitch, ex, out, ld_out,
                           lane);
  }
}

// A partial's column `col` of row r summed over the k-parts in order
__device__ __forceinline__ float sum_parts(const float* part, int pld, int r, int col) {
  float s = part[r * pld + col];
#pragma unroll
  for (int p = 1; p < CL_KPARTS; ++p) s += part[(p * MMA_ROWS + r) * pld + col];
  return s;
}

// dy W_fc^T for the tile's rows 4 rg .. 4 rg + 3 and unit u of this CTA, each
// row summed in ascending o (fcs: W_fc's rows of the CTA's units, dys: the
// dy tile, both with pitch fc_ld and zero past O) into dyw [16][U]
__device__ __forceinline__ void dy_fc(const float* __restrict__ fcs,
                                      const float* __restrict__ dys, float* __restrict__ dyw,
                                      int fc_ld, int U, int u, int rg) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const float4* wrow = reinterpret_cast<const float4*>(fcs + u * fc_ld);
#pragma unroll 4
  for (int o4 = 0; o4 < fc_ld / 4; ++o4) {
    const float4 w = wrow[o4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 y = reinterpret_cast<const float4*>(dys + (4 * rg + q) * fc_ld)[o4];
      s[q] = fmaf(y.x, w.x, s[q]);
      s[q] = fmaf(y.y, w.y, s[q]);
      s[q] = fmaf(y.z, w.z, s[q]);
      s[q] = fmaf(y.w, w.w, s[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) dyw[(4 * rg + q) * U + u] = s[q];
}

template <typename T>
__global__ void __launch_bounds__(CL_THREADS, 1)
sweep_cluster_kernel(const SweepArgs<T> a) {
  constexpr int R = MMA_ROWS, U = CL_UNITS, NT = U / 8, KP = CL_KPARTS;
  constexpr int DY_WORDS = (CL_MAX_O + 31) / 32;
  constexpr int DYW_FIRST = CL_THREADS / 2;  // dy W_fc^T: threads of the dx warps
  extern __shared__ __align__(16) unsigned char smem_cl[];
  const int D = a.D, H = a.H, O = a.O, G = 4 * a.H, pitch = cl_block_pitch<T>(U);
  const int chunks = G / k_chunk<T>(), fc_ld = cl_fc_ld(O), pld = cl_part_ld(U);
  const int C = (int)cluster_nctarank(), c = (int)cluster_ctarank(), tile = (int)cluster_idx();
  T* dgs = reinterpret_cast<T*>(smem_cl + CL_BAR_BYTES);          // [C][R][pitch]
  float* fcs = reinterpret_cast<float*>(dgs + (size_t)C * R * pitch);  // [U][fc_ld]: W_fc's rows U_c
  float* dys = fcs + U * fc_ld;                                   // [R][fc_ld]
  float* part = dys + R * fc_ld;                                  // [KP][R][pld]
  float* dyw = part + KP * R * pld;                               // [R][U]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = warp, j = c * U + lane;  // this thread's cell: row r, unit j
  const int n0 = tile * R;
  const int rows_here = min(R, a.n_rows - n0);
  const bool live = r < rows_here;
  const size_t n_pad = (size_t)(gridDim.x / C) * R;
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem_cl);
  const uint32_t blocks = (uint32_t)__cvta_generic_to_shared(dgs);
  const uint32_t a_base = blocks + (uint32_t)(((lane & 15) * pitch) * (int)sizeof(T)) + 16 * (lane >> 4);
  const int grp = warp / KP, kp = warp % KP;
  const int kc0 = kp * chunks / KP, kc1 = (kp + 1) * chunks / KP;  // its owner-major k-chunks
  float* my_part = part + (size_t)kp * R * pld + grp * U;
  const int dx_tiles = dx_cols(D) / 8;
  const int ndx = c < dx_tiles ? (dx_tiles - c + C - 1) / C : 0;  // n-tiles c, c + C, ...
  const int fc_u = (tid - DYW_FIRST) % U, fc_rg = (tid - DYW_FIRST) / U;
  const bool fc_thread = tid >= DYW_FIRST && tid < DYW_FIRST + 4 * U;
  Exchange<T> ex{dgs + (size_t)c * R * pitch, blocks, bars,
                 (uint32_t)(R * pitch * (int)sizeof(T)), 1u, c, C, pitch, a.late_sends != 0};

  if (tid == 0)
    for (int o = 0; o < C; ++o) mbar_init(bars + 8 * o, 1);
  ex.arm();  // the first exchange's blocks
  for (int idx = tid; idx < U * fc_ld; idx += CL_THREADS) {
    const int u = idx / fc_ld, o = idx - u * fc_ld;
    fcs[idx] = o < O ? a.fcw[(size_t)(c * U + u) * O + o] : 0.0f;
  }
  for (int idx = tid; idx < R * fc_ld; idx += CL_THREADS) {
    const int rr = idx / fc_ld, o = idx - rr * fc_ld;
    dys[idx] = rr < rows_here && o < O
                   ? to_f(a.dy[((size_t)(n0 + rr) * a.steps + a.t_hi) * O + o]) : 0.0f;
  }

  float carry[4] = {0.f, 0.f, 0.f, 0.f};  // dh1, dc1, dh2, dc2
  if (a.resume) {
#pragma unroll
    for (int q = 0; q < 4; ++q) carry[q] = a.carry[((size_t)q * n_pad + n0 + r) * H + j];
  }
  float dh1c = carry[0], dc1 = carry[1], dh2c = carry[2], dc2 = carry[3];
  float db[2][4] = {};
  CellInputs<T> in2, in1;
  in2.load(a.g2, a.c2, (size_t)a.t_hi * a.n_rows + n0 + r, a.n_rows, a.t_hi, H, j, live);
  __syncthreads();  // W_fc's rows and the first dy tile are in; the mbarriers are set
  if (fc_thread) dy_fc(fcs, dys, dyw, fc_ld, U, fc_u, fc_rg);
  cluster_arrive();  // pairs with the first exchange's wait: the peers' barriers are set
  __syncthreads();   // the first dy W_fc^T is in

  for (int t = a.t_hi; t >= a.t_lo; --t) {
    const size_t row0 = (size_t)t * a.n_rows + n0;
    const size_t dg0 = ((size_t)(t - a.t_base) * a.n_rows + n0) * G;
    const bool more = t > a.t_lo;
    T dy_next[DY_WORDS];  // row r of step t - 1's dy tile, 32 words a pass
#pragma unroll
    for (int i = 0; i < DY_WORDS; ++i) {
      const int o = lane + 32 * i;
      dy_next[i] = more && live && o < O ? a.dy[((size_t)(n0 + r) * a.steps + t - 1) * O + o]
                                         : from_f<T>(0.0f);
    }

    // layer 2
    float d[4];
    cell_bwd_one<T>(dyw[r * U + lane] + dh2c, dc2, db[1], in2, d);
    in1.load(a.g1, a.c1, row0 + r, a.n_rows, t, H, j, live);
    ex.run(d, a.dg2 + dg0, H, r, lane, live);
#pragma unroll
    for (int i = 0; i < DY_WORDS; ++i)
      if (lane + 32 * i < O) dys[r * fc_ld + lane + 32 * i] = to_f(dy_next[i]);

    {  // [dh1' | dh2_carry]: group 0 the columns U_c, group 1 the columns H + U_c
      float acc[NT][4] = {};
      const int nt0 = (grp * H + c * U) / 8;
      owned_mma<T, NT, U>(acc, a_base, a.w2p + (size_t)nt0 * chunks * 32 + lane, chunks, kc0,
                          kc1, 1, H, pitch, ex);
      store_acc(acc, my_part, pld, lane, false);
    }
    ex.sent();         // this CTA's copies have read its block
    __syncthreads();   // the partials are in; every warp has waited for its blocks
    ex.arm();          // layer 1's exchange
    cluster_arrive();  // this CTA has read dgates2
    const float dh1 = sum_parts(part, pld, r, lane) + dh1c;  // d h1_t
    dh2c = sum_parts(part, pld, r, U + lane);                // d h2_{t-1}

    // layer 1
    cell_bwd_one<T>(dh1, dc1, db[0], in1, d);
    ex.run(d, a.dg1 + dg0, H, r, lane, live);
    if (grp == 0) {  // dh1_carry: the columns U_c
      float acc[NT][4] = {};
      owned_mma<T, NT, U>(acc, a_base, a.u1p + (size_t)(c * U / 8) * chunks * 32 + lane,
                          chunks, kc0, kc1, 1, H, pitch, ex);
      store_acc(acc, my_part, pld, lane, false);
    } else {  // dx: the n-tiles c, c + C, ...
      dx_parts<T, NT, U>(ndx, a_base, a.w1p + (size_t)c * chunks * 32 + lane, chunks, kc0, kc1,
                         C, H, pitch, ex, my_part, pld, lane);
    }
    if (more) {
      if (fc_thread) dy_fc(fcs, dys, dyw, fc_ld, U, fc_u, fc_rg);  // step t - 1's
      in2.load(a.g2, a.c2, row0 - a.n_rows + r, a.n_rows, t - 1, H, j, live);
    }
    ex.sent();         // this CTA's copies have read its block
    __syncthreads();   // the partials and dy W_fc^T are in; every warp has waited
    ex.arm();          // the next step's layer 2 exchange
    cluster_arrive();  // this CTA has read dgates1
    dh1c = sum_parts(part, pld, r, lane);  // d h1_{t-1}
    T* dx_t = a.dx + row0 * D;
    for (int idx = tid; idx < R * 8 * ndx; idx += CL_THREADS) {
      const int rr = idx / (8 * ndx), jj = idx - rr * 8 * ndx;
      const int col = (c + (jj >> 3) * C) * 8 + (jj & 7);
      if (rr < rows_here && col < D) dx_t[(size_t)rr * D + col] = from_f<T>(sum_parts(part, pld, rr, U + jj));
    }
  }
  cluster_wait();  // every peer is done with this CTA's shared memory

  if (a.carry != nullptr) {
    const float v[4] = {dh1c, dc1, dh2c, dc2};
#pragma unroll
    for (int q = 0; q < 4; ++q) a.carry[((size_t)q * n_pad + n0 + r) * H + j] = v[q];
  }
  if (a.db_part != nullptr) {  // each unit's sums over the tile's rows, in row order
    __syncthreads();            // the last step's partials are read
    float* dbs = part;          // [R][2][4][U]
#pragma unroll
    for (int l = 0; l < 2; ++l)
#pragma unroll
      for (int q = 0; q < 4; ++q) dbs[((r * 2 + l) * 4 + q) * U + lane] = db[l][q];
    __syncthreads();
    for (int idx = tid; idx < 8 * U; idx += CL_THREADS) {
      float s = dbs[idx];
      for (int rr = 1; rr < R; ++rr) s += dbs[rr * 8 * U + idx];
      const int l = idx / (4 * U), q = idx / U % 4, u = idx % U;
      float* dst = a.db_part + ((size_t)tile * 2 + l) * G + q * H + c * U + u;
      *dst = a.resume ? *dst + s : s;
    }
  }
}

// Launch the cluster form: a cluster of CLUSTER_SIZE CTAs a row tile. The
// clusters share nothing, so a fold of more tiles than the card holds at
// once runs in waves; a launch the card refuses returns its error.
template <typename T>
int launch_cluster(const SweepArgs<T>& a, cudaStream_t stream) {
  constexpr int C = CLUSTER_SIZE;
  if (!cluster_runs<T>(a.D, a.H, a.O)) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_shared_bytes<T>(a.H, a.O);
  cudaError_t err = cudaFuncSetAttribute(sweep_cluster_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // 16 is past the portable 8
    err = cudaFuncSetAttribute(sweep_cluster_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n_rows + MMA_ROWS - 1) / MMA_ROWS * C);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sweep_cluster_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wave form's `form` (SWEEP_WAVE in ops/lstm2_train.py)
constexpr int WAVE_FORM = 1;

// Launch one sweep over [t_lo, t_hi] in the form `form` gives: 0 the tile
// form, WAVE_FORM the wave form (items of part_steps steps, a.carry set),
// CLUSTER_SIZE the cluster form (any other value is refused). rows is the
// row tile, 16. A form that does not run at the shape is refused: nothing
// falls back.
template <typename T>
int launch_sweep(const SweepArgs<T>& a, int rows, int form, int part_steps, cudaStream_t stream) {
  if (rows != MMA_ROWS) return (int)cudaErrorInvalidValue;
  if (form == 0 || form == WAVE_FORM) {
    if ((form == WAVE_FORM) != (part_steps > 0)) return (int)cudaErrorInvalidValue;
    SweepArgs<T> b = a;
    b.part_steps = part_steps;
    return a.H <= 384 ? launch_mma<T, 384>(b, stream) : launch_mma<T, 512>(b, stream);
  }
  if (form == CLUSTER_SIZE) return launch_cluster<T>(a, stream);
  return (int)cudaErrorInvalidValue;
}

inline bool valid_shape(int n_rows, int steps, int D, int H, int O) {
  return H % 32 == 0 && H <= 512 && n_rows > 0 && steps > 0 && D > 0 && D <= H && O > 0;
}

}  // namespace bwd
