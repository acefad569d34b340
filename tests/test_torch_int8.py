"""The port's int8 serving route (ops/lstm2_int8.py, LSTM2.prepare_int8, the
quantized SequenceModel route, Enhancer(compute_dtype="int8")) against the
JAX package's, on the CPU.

The same weights (JAX init, cast to bf16 as the JAX Enhancer casts them) and
numpy inputs go through both. Quantization must agree bit for bit; the plain
int8 LSTM against the TPU kernel `stacked_lstm2_quantized` in interpret
mode, the int8 Enhancer against float32 and against the JAX int8 Enhancer,
each with the floor stated in the test.

The CUDA kernel's tests are in tests/test_torch_cuda_kernels.py, which
imports no JAX and so runs on the card's machine. Here, on the CPU, its
operands are: the fragments `prepare_int8` packs, and a numpy walk of the
kernel's sweep over them, held to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.enhance import Enhancer as JEnhancer
from fullsubnet_plus_tpu.io import torch_convert as jconv
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.nn.init import linear_init
from fullsubnet_plus_tpu.nn.lstm import lstm_init
from fullsubnet_plus_tpu.ops import lstm_pallas
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io.convert import state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.nn import lstm as port_lstm
from fullsubnet_plus_torch.nn.layers import Linear
from fullsubnet_plus_torch.nn.lstm import LSTM2
from fullsubnet_plus_torch.nn.sequence import SequenceModel
from fullsubnet_plus_torch.ops import lstm2 as ops_lstm2
from fullsubnet_plus_torch.ops import lstm2_int8 as ops_int8

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


def _bf16(tree):
    """A JAX tree rounded to bf16, as float32 numpy (exact bf16 values)."""
    return jax.tree_util.tree_map(
        lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)), tree)


def _port_lstm(params, fc):
    """The JAX LSTM and Linear carried into the port's modules."""
    d, h = params["layers"][0]["w_ih"].shape[0], params["layers"][0]["w_hh"].shape[0]
    lstm, linear = LSTM2(d, h), Linear(h, fc["weight"].shape[1])
    sd = {}
    jconv.export_lstm(sd, params, "m")
    lstm.load_state_dict({k.removeprefix("m."): torch.from_numpy(v) for k, v in sd.items()})
    sd = {}
    jconv.export_linear(sd, fc, "m")
    linear.load_state_dict({k.removeprefix("m."): torch.from_numpy(v) for k, v in sd.items()})
    return lstm, linear


def _lstm_case(seed, d, h, o):
    params = jax.tree_util.tree_map(np.asarray, lstm_init(jax.random.PRNGKey(seed), d, h, 2))
    fc = jax.tree_util.tree_map(np.asarray, linear_init(jax.random.PRNGKey(seed + 1), h, o))
    return params, fc


def test_prepare_quantized_lstm_matches_jax_bit_for_bit():
    """Per-column int8 weights and scales from bf16-cast weights: the port's
    numpy function and LSTM2.prepare_int8 against the JAX package's."""
    params, fc = _lstm_case(7, 34, 64, 2)
    params, fc = _bf16(params), _bf16(fc)
    for layer, name in ((0, "w_hh"), (1, "w_ih"), (1, "w_hh")):
        params["layers"][layer][name][:, 5] = 0.0  # all-zero columns take scale 1
    ref = lstm_pallas.prepare_quantized_lstm(params)
    l1, l2 = params["layers"]
    got = ops_int8.prepare_quantized_lstm(
        l1["w_hh"], np.concatenate([l2["w_ih"], l2["w_hh"]], axis=0))
    for key in ("u1q", "w2q"):
        assert got[key].dtype == np.int8
        np.testing.assert_array_equal(got[key], ref[key])
    for key in ("s1", "s2"):
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], ref[key].reshape(-1))
    # the module path casts its (here already bf16) weights and gets the same
    lstm, linear = _port_lstm(params, fc)
    w = lstm.prepare_int8(linear)
    np.testing.assert_array_equal(w.u1q.numpy(), ref["u1q"])
    np.testing.assert_array_equal(w.w2q.numpy(), ref["w2q"])
    np.testing.assert_array_equal(w.s1.numpy(), ref["s1"].reshape(-1))
    np.testing.assert_array_equal(w.s2.numpy(), ref["s2"].reshape(-1))


def test_prepare_int8_casts_float32_weights_to_bf16_first():
    """A float32 module quantizes its bf16-rounded weights, as the JAX
    Enhancer quantizes after casting its parameters to bf16."""
    params, fc = _lstm_case(8, 10, 32, 2)
    lstm, linear = _port_lstm(params, fc)
    ref = lstm_pallas.prepare_quantized_lstm(_bf16(params))
    w = lstm.prepare_int8(linear)
    np.testing.assert_array_equal(w.u1q.numpy(), ref["u1q"])
    np.testing.assert_array_equal(w.s2.numpy(), ref["s2"].reshape(-1))
    assert w.w1.dtype == torch.bfloat16 and w.fc_w.dtype == torch.float32


def test_prepare_int8_rejects_mismatched_shapes(monkeypatch):
    """The prepared weights are checked against the float weights (the port
    does not trust them unchecked, as the JAX int8 path does)."""
    params, fc = _lstm_case(9, 10, 32, 2)
    lstm, linear = _port_lstm(params, fc)
    real = ops_int8.prepare_quantized_lstm

    def transposed(u1, w2):
        q = real(u1, w2)
        return {**q, "u1q": np.ascontiguousarray(q["u1q"].T)}

    monkeypatch.setattr(port_lstm, "prepare_quantized_lstm", transposed)
    with pytest.raises(ValueError, match="u1q"):
        lstm.prepare_int8(linear)


def test_pack_s8_b_layout():
    """Lane 4g + t of n-tile nt, chunk kp holds, for k-steps ks = 0, 1, the
    bytes w[8nt + g, 64kp + 32ks + 4t + 0..3] then w[.., + 16 + 4t + 0..3]
    (mma.sync m16n8k32's b0, b1); unpacking restores the matrix; K and n are
    padded with zeros to whole chunks and n-tiles, so the TINY models' H 16
    and 32 pack without raising."""
    rng = np.random.default_rng(0)
    wq = torch.from_numpy(rng.integers(-127, 128, (20, 192)).astype(np.int8))
    packed = ops_int8.pack_s8_b(wq)
    assert packed.shape == (3, 3, 32, 16) and packed.dtype == torch.int8
    nt, kp, g, t = 1, 2, 5, 3
    lane = packed[nt, kp, 4 * g + t].numpy()
    for ks in range(2):
        k0 = 64 * kp + 32 * ks + 4 * t
        for byte in range(4):
            assert lane[8 * ks + byte] == wq[8 * nt + g, k0 + byte]
            assert lane[8 * ks + 4 + byte] == wq[8 * nt + g, k0 + 16 + byte]
    assert torch.equal(ops_int8.unpack_s8_b(packed, 20, 192), wq)
    assert not ops_int8.unpack_s8_b(packed, 24, 192)[20:].any()
    for hidden in (16, 32):
        wq = torch.from_numpy(rng.integers(-127, 128, (4 * hidden, hidden)).astype(np.int8))
        packed = ops_int8.pack_s8_b(wq)
        assert packed.shape == (hidden // 2, 1, 32, 16)
        assert torch.equal(ops_int8.unpack_s8_b(packed, 4 * hidden, hidden), wq)
        assert not ops_int8.unpack_s8_b(packed, 4 * hidden, 64)[:, hidden:].any()


def _bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _s8_operand(packed, n):
    """The int8 B operand [K', n] (K' = 64 chunks) rebuilt from the packed
    bytes as the lanes hand them to mma.sync m16n8k32: lane 4g + t, byte
    8 ks + 4 half + pos of n-tile nt, chunk kp is B[64kp + 32ks + 16half +
    4t + pos][8nt + g]."""
    p = packed.numpy().astype(np.int64)
    tiles, chunks = p.shape[:2]
    b = np.zeros((64 * chunks, 8 * tiles), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for ks in range(2):
            for half in range(2):
                for pos in range(4):
                    k = 64 * np.arange(chunks)[None, :] + 32 * ks + 16 * half + 4 * t + pos
                    col = 8 * np.arange(tiles)[:, None] + g
                    b[k, col] = p[:, :, lane, 8 * ks + 4 * half + pos]
    return b[:, :n]


def _bf16_operand(packed, n):
    """The bf16 B operand [K, n] as the lanes hand it to mma.sync m16n8k16:
    lane 4g + t, element 4 ks + 2 half + pos of n-tile nt, chunk kp is
    B[32kp + 16ks + 8half + 2t + pos][8nt + g]."""
    p = packed.float().numpy()
    tiles, chunks = p.shape[:2]
    b = np.zeros((32 * chunks, 8 * tiles), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for ks in range(2):
            for half in range(2):
                for pos in range(2):
                    k = 32 * np.arange(chunks)[None, :] + 16 * ks + 8 * half + 2 * t + pos
                    col = 8 * np.arange(tiles)[:, None] + g
                    b[k, col] = p[:, :, lane, 4 * ks + 2 * half + pos]
    return b[:, :n]


def _k_steps(a, b, width):
    """a [M, K] @ b [K, n] in float32, summed k-step by k-step of `width`."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], width):
        acc += a[:, k0:k0 + width] @ b[k0:k0 + width]
    return acc


def _lanes(rows, hidden):
    """Every (row, unit) a lane holds in the sweep's accumulators: warp w,
    pass p (unit group u = 4w + p), lane (g, q), m-tile mt, word e -> row
    16 mt + g + 8 (e / 2), unit 8u + 2q + e % 2, and its gate columns
    32u + 8 gate + 2q + e % 2 of the interleaved product."""
    u, g, q, mt, e = np.meshgrid(np.arange(hidden // 8), np.arange(8), np.arange(4),
                                 np.arange(rows // 16), np.arange(4), indexing="ij")
    row = (16 * mt + g + 8 * (e // 2)).ravel()
    unit = (8 * u + 2 * q + e % 2).ravel()
    col = (32 * u + 2 * q + e % 2).ravel()
    return row, unit, col


def _cell_walk(acc, c, lanes):
    """The kernel's cell over every lane, from the interleaved gate
    pre-activations acc [R, 4H] (float32): -> (h, c) [R, H]."""
    row, unit, col = lanes
    sig = lambda v: np.float32(1) / (np.float32(1) + np.exp(-v))  # noqa: E731
    i, f = sig(acc[row, col]), sig(acc[row, col + 8])
    gg, o = np.tanh(acc[row, col + 16]), sig(acc[row, col + 24])
    c, h = c.copy(), np.zeros_like(c)
    seen = np.zeros(c.shape, np.int64)
    np.add.at(seen, (row, unit), 1)
    assert (seen == 1).all()
    c[row, unit] = f * c[row, unit] + i * gg
    h[row, unit] = o * np.tanh(c[row, unit])
    return h, c


def _int8_sweep_walk(x, w, rows):
    """The int8 sweep walked as the kernel walks it, tile of `rows` by tile:
    int8 rows [h1q | h2q] and bf16 rows [x (x_cols(D)) | bf16(h2)], the
    packed fragments as B, int32 sums in 64-byte chunks (s8), float32 sums
    k-step by k-step of 16 (bf16), gates = (facc + f32(iacc) s1) + b1 and
    iacc s2 + b2 from the interleaved scales and biases, the cell from the
    accumulators, h quantized half to even into the int8 rows, the fc on the
    bf16 h2. Returns y [N, T, O] bf16 and each step's int32 sums of both
    layers, deinterleaved, with the plain products of the same int8 rows."""
    n, d, steps = x.shape
    hidden, out_dim = w.u1q.shape[0], w.fc_w.shape[1]
    m = w.mma
    xc = ops_lstm2.x_cols(d)
    deint = lambda a: ops_lstm2.deinterleave_gates(torch.from_numpy(a)).numpy()  # noqa: E731
    bu1, bw2 = _s8_operand(m.u1q, 4 * hidden), _s8_operand(m.w2q, 4 * hidden)
    bw1, bfc = _bf16_operand(m.w1, 4 * hidden), _bf16_operand(m.fc, out_dim)
    s1, b1, s2, b2 = (v.numpy() for v in (m.s1, m.b1, m.s2, m.b2))
    u1q, w2q = w.u1q.numpy().astype(np.int64), w.w2q.numpy().astype(np.int64)
    lanes = _lanes(rows, hidden)
    y = np.zeros((n, steps, out_dim), np.float32)
    sums = []
    for n0 in range(0, n, rows):
        live = min(rows, n - n0)
        q = np.zeros((rows, 2 * hidden + 64), np.int64)  # past 2H: the pad and beyond
        xr = np.zeros((rows, xc + hidden), np.float32)
        c1, c2 = np.zeros((rows, hidden), np.float32), np.zeros((rows, hidden), np.float32)
        for t in range(steps):
            xr[:live, :d] = x[n0:n0 + live, :, t].float().numpy()
            i1 = q[:, :bu1.shape[0]] @ bu1
            facc = _k_steps(xr[:, :xc], bw1, 16)
            g1 = (facc + i1.astype(np.float32) * s1) + b1
            plain1 = q[:, :hidden] @ u1q
            h1, c1 = _cell_walk(g1, c1, lanes)
            q[:, :hidden] = np.clip(np.rint(h1 * np.float32(127)), -127, 127)
            i2 = q[:, :bw2.shape[0]] @ bw2
            plain2 = q[:, :2 * hidden] @ w2q
            h2, c2 = _cell_walk(i2.astype(np.float32) * s2 + b2, c2, lanes)
            q[:, hidden:2 * hidden] = np.clip(np.rint(h2 * np.float32(127)), -127, 127)
            xr[:, xc:] = _bf16_round(h2)
            y[n0:n0 + live, t] = (_k_steps(xr[:live, xc:], bfc, 16) + w.fc_b.numpy())
            sums.append((deint(i1), plain1, deint(i2), plain2))
    return _bf16_round(y), sums


@pytest.mark.parametrize("n,t,d,h,o,rows", [(37, 5, 34, 64, 3, 16), (45, 4, 10, 32, 2, 32)])
def test_int8_fragment_walk_matches_the_plain_version(rng, n, t, d, h, o, rows):
    """The fragment-order walk of the int8 sweep (`_int8_sweep_walk`, from
    the fields `prepare_int8` packs) at two ragged folds: at H 64, and at H
    32, R 32, where layer 1's one chunk runs past h1q into h2q against zero
    weights. Its int32 gate sums equal the plain products of the same int8
    rows at every step, and its y agrees with `lstm2_int8_fc_reference` at
    >= 40 dB (the floor chip_smoke.py holds the kernel to; measured on an
    x86 CPU: the bf16 outputs are identical, max-abs 0, SNR 296.8 dB at H
    64 and 308.6 dB at H 32; only x W1's and the fc's float32 sum order and
    numpy's exp / tanh could differ)."""
    params, fc = _lstm_case(n + t + h, d, h, o)
    lstm, linear = _port_lstm(_bf16(params), _bf16(fc))
    w = lstm.prepare_int8(linear)
    x = torch.from_numpy((0.5 * rng.standard_normal((n, d, t))).astype(np.float32)).bfloat16()
    y, sums = _int8_sweep_walk(x, w, rows)
    for i1, plain1, i2, plain2 in sums:
        np.testing.assert_array_equal(i1, plain1)
        np.testing.assert_array_equal(i2, plain2)
    ref = ops_int8.lstm2_int8_fc_reference(x, w).float().numpy()
    assert y.shape == ref.shape
    assert _snr(ref, y) >= 40.0, _snr(ref, y)


@pytest.mark.parametrize("n,t,d,h,o", [(100, 17, 34, 64, 2), (20, 9, 10, 16, 3)])
def test_int8_plain_matches_jax_kernel(rng, n, t, d, h, o):
    """The plain int8 LSTM against `stacked_lstm2_quantized` (interpret
    mode) on the same bf16 weights, prepared int8 weights and bf16 input;
    the first shape leaves a ragged last tile. Floor 40 dB (the bar
    chip_smoke.py holds the CUDA kernel to); measured on an x86 CPU: the
    outputs are identical (max-abs 0, SNR above 300 dB), as the int32 sums
    are exact and the float steps round at the same points."""
    params, fc = _lstm_case(n + t, d, h, o)
    params, fc = _bf16(params), _bf16(fc)
    x = (0.5 * rng.standard_normal((n, d, t))).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jparams["int8_prepared"] = {k: jnp.asarray(v) for k, v in
                                lstm_pallas.prepare_quantized_lstm(params).items()}
    jfc = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), fc)
    ref = np.asarray(lstm_pallas.stacked_lstm2_quantized(
        jparams, jnp.asarray(x, jnp.bfloat16), jfc, 64, True).astype(jnp.float32))
    lstm, linear = _port_lstm(params, fc)
    out = ops_int8.lstm2_int8_fc(torch.from_numpy(x).to(torch.bfloat16),
                                 lstm.prepare_int8(linear))
    assert out.dtype == torch.bfloat16 and out.shape == (n, t, o)
    assert _snr(ref, out.float().numpy()) >= 40.0, _snr(ref, out.float().numpy())


def test_int8_plain_close_to_float32(rng):
    """int8 against the port's float32 plain LSTM: SNR > 30 dB, the bar of
    tests/test_pallas_lstm.py::test_pallas_quantized_kernel_snr (measured
    44.8 dB on an x86 CPU)."""
    params, fc = _lstm_case(11, 34, 64, 2)
    x = (0.5 * rng.standard_normal((64, 34, 21))).astype(np.float32)
    lstm, linear = _port_lstm(params, fc)
    ref = ops_lstm2.lstm2_fc(torch.from_numpy(x), lstm.packed(linear)).numpy()
    out = ops_int8.lstm2_int8_fc(torch.from_numpy(x).to(torch.bfloat16),
                                 lstm.prepare_int8(linear)).float().numpy()
    assert np.isfinite(out).all()
    assert _snr(ref, out) > 30.0, _snr(ref, out)


def test_int8_wrapper_rejects_bad_inputs():
    params, fc = _lstm_case(12, 10, 32, 2)
    lstm, linear = _port_lstm(params, fc)
    w = lstm.prepare_int8(linear)
    with pytest.raises(TypeError, match="bfloat16"):
        ops_int8.lstm2_int8_fc(torch.zeros(3, 10, 4), w)
    with pytest.raises(ValueError, match="w1"):
        ops_int8.lstm2_int8_fc(torch.zeros(3, 12, 4, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="unsupported device"):
        ops_int8.lstm2_int8_fc(torch.zeros(3, 10, 4, dtype=torch.bfloat16, device="meta"), w)


def test_quantized_route_needs_prepared_weights():
    model = SequenceModel(10, 2, 32)
    x = torch.zeros(3, 10, 4, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="prepare_int8"):
        model.to(torch.bfloat16)(x, quantized=True)
    model.prepare_int8()
    assert model(x, quantized=True).shape == (3, 2, 4)


@pytest.mark.parametrize("rows,smem", [(16, 103_424), (32, 206_848)])
def test_int8_shared_memory_fits_the_shipped_shape(rows, smem):
    """Two operand buffers of R int8 rows [h1q | h2q | 16] (784 bytes) and R
    bf16 rows [x 64 | h2 384 | 8] (912 bytes), c1 and c2 [R][384] float32,
    at D 34, H 384: both row tiles fit a block."""
    assert ops_int8.shared_memory_bytes(rows, 34, 384) == 2 * rows * (784 + 912) + 8 * rows * 384
    assert ops_int8.shared_memory_bytes(rows, 34, 384) == smem <= ops_int8.SMEM_LIMIT


@pytest.mark.parametrize("n,rows", [(2056, 16), (2313, 32), (771, 16)])
def test_int8_row_tile_rule(n, rows):
    """The row tile by waves on 132 SMs, then the smaller: the serving and
    batch folds (N 2056) and a ragged one take R 16 in one wave; 9
    utterances (N 2313) take R 32, one wave where R 16 needs two (on the
    H100 at T 255: R 32 11.8 ms, R 16 16.4; scripts/time_torch_int8.py)."""
    assert ops_int8.int8_rows_per_cta(n, 132) == rows
    assert ops_int8.int8_row_tile(n, 34, 384, 132) == rows


def test_int8_shared_memory_fits_the_fullsubnet_full_band_shape():
    """FullSubNet's full-band LSTM (D 257, H 512, O 257; ROADMAP Queue 1 item
    7) fits at R 16, since the fc runs on the tensor cores and nothing in
    shared memory grows with O; R 32 does not, and the tile rule falls back
    to 16."""
    assert ops_int8.shared_memory_bytes(16, 257, 512) == 150_528 <= ops_int8.SMEM_LIMIT
    assert ops_int8.shared_memory_bytes(32, 257, 512) > ops_int8.SMEM_LIMIT
    assert ops_int8.int8_row_tile(4626, 257, 512, 132) == 16


# ---------------------------------------------------------------------------
# the cluster form (csrc/lstm2_int8_fwd.cu, int8_sweep_cluster_kernel)
# ---------------------------------------------------------------------------

def _int8_cluster_kparts(d_in, hidden):
    """Each k-part's chunks of the cluster form's products, as a warp of
    `int8_sweep_cluster_kernel` runs them: layer 1 either a run of x's bf16
    chunks (k-parts 0 .. INT8_CLUSTER_X_KPARTS - 1) or of h1q's s8 chunks
    (the others); layer 2 its run of s8 chunks `h` over h2q, then the same
    over h1q; the fc the bf16 chunks of the owners those s8 chunks span (s8
    chunk j: owners 2j, 2j + 1)."""
    parts, xparts = ops_int8.INT8_CLUSTER_KPARTS, ops_int8.INT8_CLUSTER_X_KPARTS
    xch, hq = ops_lstm2.x_cols(d_in) // 32, hidden // 64
    out = []
    for kp in range(parts):
        hs = list(range(kp * hq // parts, (kp + 1) * hq // parts))
        if kp < xparts:
            layer1 = ("x", list(range(kp * xch // xparts, (kp + 1) * xch // xparts)))
        else:
            k, rest = kp - xparts, parts - xparts
            layer1 = ("h1q", list(range(k * hq // rest, (k + 1) * hq // rest)))
        out.append({"layer1": layer1, "h": hs, "fc": [o for j in hs for o in (2 * j, 2 * j + 1)]})
    return out


def _int8_cluster_columns(rank, hidden, out_dim):
    """CTA `rank`'s gate columns of the interleaved products, gate-major
    [4][32] (unit 32c + u, gate g at column 32 (4c + u / 8) + 8g + u % 8),
    and its fc n-tiles c, c + C, .. (C = H / 32)."""
    units, cluster = ops_int8.INT8_CLUSTER_UNITS, hidden // ops_int8.INT8_CLUSTER_UNITS
    cols = np.array([[32 * (4 * rank + u // 8) + 8 * g + u % 8 for u in range(units)]
                     for g in range(4)])
    return cols, list(range(rank, -(-out_dim // 8), cluster))


def _int8_cluster_walk(x, w):
    """The cluster form walked as the kernel walks it, tile of 16 rows by
    tile: each CTA c of C = H / 32 its own gate columns of the packed
    fragments (`_int8_cluster_columns`), as INT8_CLUSTER_KPARTS k-parts in
    the warps' chunk order (`_int8_cluster_kparts`); an s8 chunk's A is the
    two owners' int8 blocks side by side (k-step 0 owner 2j, k-step 1 owner
    2j + 1); x W1's float32 partials k-step by k-step of 16 and added in
    k-part order, the int32 ones summed, gates = (xw + f32(iacc) s1) + b1 and
    f32(iacc) s2 + b2; each CTA's cell into its own blocks (h1q, h2q and
    bf16(h2): the exchange); the fc of its n-tiles over the owners' bf16(h2)
    blocks in k-parts, then + b_fc. The integer products run in float64,
    exact for sums below 2^53. Returns y [N, T, O] bf16 and each step's
    int32 sums of both layers, deinterleaved, with the plain products of
    the same int8 rows."""
    n, d, steps = x.shape
    hidden, out_dim = w.u1q.shape[0], w.fc_w.shape[1]
    units, cluster = ops_int8.INT8_CLUSTER_UNITS, hidden // ops_int8.INT8_CLUSTER_UNITS
    m = w.mma
    xc = ops_lstm2.x_cols(d)
    deint = lambda a: ops_lstm2.deinterleave_gates(torch.from_numpy(a)).numpy()  # noqa: E731
    bu1 = _s8_operand(m.u1q, 4 * hidden).astype(np.float64)
    bw2 = _s8_operand(m.w2q, 4 * hidden).astype(np.float64)
    bw1, bfc = _bf16_operand(m.w1, 4 * hidden), _bf16_operand(m.fc, out_dim)
    s1, b1, s2, b2 = (v.numpy() for v in (m.s1, m.b1, m.s2, m.b2))
    u1q, w2q = w.u1q.numpy().astype(np.float64), w.w2q.numpy().astype(np.float64)
    kparts = _int8_cluster_kparts(d, hidden)
    ctas = [_int8_cluster_columns(c, hidden, out_dim) for c in range(cluster)]
    sig = lambda v: np.float32(1) / (np.float32(1) + np.exp(-v))  # noqa: E731

    def cell(pre, c_state):  # pre [16, 4, 32] -> (h, c) [16, 32]
        i, f, g, o = sig(pre[:, 0]), sig(pre[:, 1]), np.tanh(pre[:, 2]), sig(pre[:, 3])
        c_new = f * c_state + i * g
        return o * np.tanh(c_new), c_new

    def s8_a(blocks, j):
        return np.concatenate([blocks[2 * j], blocks[2 * j + 1]], axis=1)

    def quantize(h):
        return np.clip(np.rint(h * np.float32(127)), -127, 127).astype(np.float64)

    def bf16_rows(chunks):  # rows of a bf16 operand: 32 a chunk
        return [32 * q + i for q in chunks for i in range(32)]

    y = np.zeros((n, steps, out_dim), np.float32)
    sums = []
    for n0 in range(0, n, 16):
        live = min(16, n - n0)
        zeros = np.zeros((16, units))
        h1q, h2q = [zeros] * cluster, [zeros] * cluster  # the owners' blocks
        c1, c2 = np.zeros((cluster, 16, units), np.float32), np.zeros((cluster, 16, units),
                                                                       np.float32)
        xr = np.zeros((16, xc), np.float32)
        for t in range(steps):
            xr[:live, :d] = x[n0:n0 + live, :, t].float().numpy()
            i1, i2 = np.zeros((16, 4 * hidden)), np.zeros((16, 4 * hidden))
            plain1 = np.concatenate(h1q, 1) @ u1q
            new1 = []
            for c, (cols, _) in enumerate(ctas):
                cc = cols.ravel()
                xw, iacc = None, np.zeros((16, cc.size))
                for kp in kparts:
                    kind, chunks = kp["layer1"]
                    if kind == "x":
                        rows = bf16_rows(chunks)
                        part = _k_steps(xr[:, rows], bw1[rows][:, cc], 16)
                        xw = part if xw is None else xw + part
                    else:
                        iacc = iacc + sum(s8_a(h1q, j) @ bu1[64 * j:64 * j + 64][:, cc]
                                          for j in chunks)
                pre = (xw + iacc.astype(np.float32) * s1[cc]) + b1[cc]
                h, c1[c] = cell(pre.reshape(16, 4, units), c1[c])
                new1.append(quantize(h))
                i1[:, cc] = iacc
            h1q = new1
            plain2 = np.concatenate(h1q + h2q, 1) @ w2q
            new2, h2b = [], []
            for c, (cols, _) in enumerate(ctas):
                cc = cols.ravel()
                iacc = np.zeros((16, cc.size))
                for kp in kparts:
                    for j in kp["h"]:  # h2q_{t-1}'s chunks, then h1q_t's
                        iacc = iacc + s8_a(h2q, j) @ bw2[64 * (hidden // 64 + j):][:64][:, cc]
                    for j in kp["h"]:
                        iacc = iacc + s8_a(h1q, j) @ bw2[64 * j:64 * j + 64][:, cc]
                h, c2[c] = cell((iacc.astype(np.float32) * s2[cc] + b2[cc]).reshape(16, 4, units),
                                c2[c])
                new2.append(quantize(h))
                h2b.append(_bf16_round(h))
                i2[:, cc] = iacc
            h2q = new2
            for _, tiles in ctas:
                for nt in tiles:
                    cols_o = [o for o in range(8 * nt, 8 * nt + 8) if o < out_dim]
                    acc = None
                    for kp in kparts:
                        a = np.concatenate([h2b[o] for o in kp["fc"]], axis=1)
                        part = _k_steps(a, bfc[bf16_rows(kp["fc"])][:, cols_o], 16)
                        acc = part if acc is None else acc + part
                    y[n0:n0 + live, t, cols_o] = (acc + w.fc_b.numpy()[cols_o])[:live]
            sums.append((deint(i1), plain1, deint(i2), plain2))
    return _bf16_round(y), sums


def _fb_int8_case(n, t, seed):
    """FullSubNet's full-band LSTM (D 257, H 512, O 257) with numpy-seeded
    weights (uniform in +-1/sqrt(H)), prepared for int8, and x [N, D, T] bf16
    uniform in [0, 2) (positive with mean 1, as after the Laplace norm)."""
    d, h, o = 257, 512, 257
    rng = np.random.default_rng(seed)
    lstm, linear = LSTM2(d, h), Linear(h, o)
    with torch.no_grad():
        for p in [*lstm.parameters(), *linear.parameters()]:
            p.copy_(torch.from_numpy(rng.uniform(-h ** -0.5, h ** -0.5, tuple(p.shape))))
    x = torch.from_numpy(rng.uniform(0.0, 2.0, (n, d, t)).astype(np.float32)).bfloat16()
    return x, lstm.prepare_int8(linear)


@pytest.mark.parametrize("n,t", [(18, 3), (7, 4)])
def test_int8_cluster_walk_matches_the_plain_version(n, t):
    """The cluster form walked in the kernel's order (`_int8_cluster_walk`)
    at FullSubNet's full-band shape (D 257, H 512, O 257: 16 CTAs of 32
    units, 9 x chunks over 2 k-parts, 33 fc n-tiles over the cluster; N 18
    two tiles, the second ragged, and N 7): its int32 gate sums equal the
    plain products of the same int8 rows at every step, and its y agrees
    with `lstm2_int8_fc_reference` at >= 40 dB (the floor chip_smoke.py
    holds the kernel to; measured on an x86 CPU: 311.5 dB at N 18 and 308.8
    at N 7, the bf16 outputs all but identical: only x W1's and the fc's
    float32 sum order and numpy's exp / tanh differ)."""
    x, w = _fb_int8_case(n, t, seed=n + t)
    y, sums = _int8_cluster_walk(x, w)
    for i1, plain1, i2, plain2 in sums:
        np.testing.assert_array_equal(i1, plain1)
        np.testing.assert_array_equal(i2, plain2)
    ref = ops_int8.lstm2_int8_fc_reference(x, w).float().numpy()
    assert y.shape == ref.shape
    assert _snr(ref, y) >= 40.0, _snr(ref, y)


def test_int8_cluster_walk_matches_the_jax_fixture():
    """The cluster form's walk on the JAX fixture's `k5_fb` case (N 7, T 9 at
    the full-band shape: the JAX kernel `stacked_lstm2_quantized` in
    interpret mode, tests/fixtures/gen_torch_kernel_fixture.py) at >= 40 dB,
    the floor the card's tests hold the kernel to there (measured on an x86
    CPU: 76.9 dB)."""
    gen = _fixture_generator()
    x, _, lstm, linear = gen.port_operands("k5_fb")
    assert ops_int8.int8_sweep_cluster(x.shape[0], *gen.CASES["k5_fb"][3:6]) == 16
    y, _ = _int8_cluster_walk(x, lstm.prepare_int8(linear))
    want = gen.load_fixture()["k5_fb"]["y"]
    assert y.shape == want.shape
    assert _snr(want, y) >= 40.0, _snr(want, y)


def _fixture_generator():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures", "gen_torch_kernel_fixture.py")
    spec = importlib.util.spec_from_file_location("gen_torch_kernel_fixture", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("d", [257, 34])
def test_int8_cluster_chunks_have_one_owner(d):
    """Over H 512 split into 16 CTAs of 32 units, every gate column (4H)
    and every fc n-tile (O 257: 33 n-tiles, at most 3 a CTA; 4 at O 512)
    has exactly one owning CTA; each product's k-parts cover its K once
    (layer 1 x_cols(D) + H, layer 2 2H, the fc H) and each k-part's s8
    chunks span 4 owners' blocks."""
    hidden, out_dim = 512, 257
    gates, tiles = np.zeros(4 * hidden, int), np.zeros(-(-out_dim // 8), int)
    for c in range(16):
        cols, own = _int8_cluster_columns(c, hidden, out_dim)
        np.add.at(gates, cols.ravel(), 1)
        np.add.at(tiles, own, 1)
        assert len(own) <= ops_int8.INT8_CLUSTER_FC_TILES
    assert (gates == 1).all() and (tiles == 1).all()
    assert len(_int8_cluster_columns(0, 512, 512)[1]) == ops_int8.INT8_CLUSTER_FC_TILES
    kparts = _int8_cluster_kparts(d, hidden)
    x_chunks = [q for p in kparts if p["layer1"][0] == "x" for q in p["layer1"][1]]
    h1_chunks = [q for p in kparts if p["layer1"][0] == "h1q" for q in p["layer1"][1]]
    assert x_chunks == list(range(ops_lstm2.x_cols(d) // 32))
    assert h1_chunks == list(range(hidden // 64))
    assert sum((p["h"] for p in kparts), []) == list(range(hidden // 64))
    assert sum((p["fc"] for p in kparts), []) == list(range(16))
    assert all(len(p["fc"]) == 4 for p in kparts)


def test_int8_sweep_cluster_rule():
    """The sweep's form (`int8_sweep_cluster`, by shape alone): the tile form
    (0) at the shipped serving and batch folds (D 34, H 384, O 2),
    FullSubNet's sub-band fold (D 32) and a card's half of a fold; clusters
    of 16 at FullSubNet's full-band shape (D 257, H 512, O 257) for N 7 (the
    JAX fixture's), 8 (a batch, the daemon's 8 slots), 18 and up to
    INT8_CLUSTER_MAX_ROWS; the tile form past it, for another H, D > H and
    an O whose fc n-tiles overflow 4 a CTA. INT8_SWEEP_FORM overrides the
    rule."""
    for n, d, h, o in ((2056, 34, 384, 2), (2056, 32, 384, 2), (1028, 34, 384, 2),
                       (8, 257, 384, 257)):
        assert ops_int8.int8_sweep_cluster(n, d, h, o) == 0
    for n in (7, 8, 18, 112, ops_int8.INT8_CLUSTER_MAX_ROWS):
        assert ops_int8.int8_sweep_cluster(n, 257, 512, 257) == ops_int8.INT8_CLUSTER == 16
    assert ops_int8.int8_sweep_cluster(ops_int8.INT8_CLUSTER_MAX_ROWS + 1, 257, 512, 257) == 0
    assert ops_int8.int8_sweep_cluster(8, 257, 256, 257) == 0
    assert ops_int8.int8_sweep_cluster(8, 513, 512, 257) == 0
    assert ops_int8.int8_sweep_cluster(8, 257, 512, 512) == 16
    assert ops_int8.int8_sweep_cluster(8, 257, 512, 513) == 0
    x, w = torch.zeros(8, 257, 1, dtype=torch.bfloat16), _fb_int8_case(1, 1, seed=0)[1]
    assert ops_int8.int8_sweep_form(x, w) == 16
    for forced in (0, 16):
        ops_int8.INT8_SWEEP_FORM = forced
        try:
            assert ops_int8.int8_sweep_form(x, w) == forced
        finally:
            ops_int8.INT8_SWEEP_FORM = None


def test_int8_cluster_shared_memory():
    """The cluster form's shared memory at FullSubNet's full-band shape (D
    257, H 512, O 257), clusters of 16: 64 mbarriers (512 bytes), the h1q
    blocks [2][16][16][48] (24,576) and [h2q | bf16(h2)] blocks [2][16][16]
    [112] (57,344), the x tile [16][288 + 8] bf16 (9,472), the k-part
    partials [4][4][16][40] words (40,960) and the fc's [4][4][16][8]
    (8,192): 141,056 bytes, under the 232,448 a block may use; the .cu's
    constants are the ones reckoned with."""
    import re
    from pathlib import Path

    got = ops_int8.int8_cluster_shared_memory_bytes(257, 512)
    assert got == 512 + 24_576 + 57_344 + 9_472 + 40_960 + 8_192 == 141_056
    assert got <= ops_int8.SMEM_LIMIT
    assert ops_int8.int8_cluster_shared_memory_bytes(34, 512) < got
    source = (Path(ops_int8.__file__).parent.parent / "csrc" / "lstm2_int8_fwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+(?: \+ \d+)?);", source))
    assert consts["CLUSTER_SIZE"] == str(ops_int8.INT8_CLUSTER)
    assert consts["CL_UNITS"] == str(ops_int8.INT8_CLUSTER_UNITS)
    assert consts["CL_KPARTS"] == str(ops_int8.INT8_CLUSTER_KPARTS)
    assert consts["CL_X_KPARTS"] == str(ops_int8.INT8_CLUSTER_X_KPARTS)
    assert consts["CL_FC_TILES"] == str(ops_int8.INT8_CLUSTER_FC_TILES)
    assert consts["CL_Q_PITCH"] == str(ops_int8.INT8_CLUSTER_Q_PITCH)
    assert consts["CL_H2_PITCH"] == str(ops_int8.INT8_CLUSTER_H2_PITCH)
    assert consts["CL_PART_LD"] == "CL_UNITS + 8" and consts["CL_FC_LD"] == "8"
    assert consts["PAD_BYTES"] == str(ops_int8.PAD_BYTES)


class _FakeInt8Library:
    """Stands in for the built K5 library: records each call's row tile and
    form (the C entry point's arguments after n, steps, D, H, O) and refuses
    the cluster form off H 512, as `cluster_runs` in the .cu does."""

    def __init__(self):
        self.calls = []

    def lstm2_int8_fwd(self, *args):
        n, steps, d, h, o, rows, form = args[11:18]
        self.calls.append((rows, form))
        return 1 if form and h != 512 else 0


@pytest.mark.parametrize("n,d,h,o,want", [
    (8, 257, 512, 257, (16, 16)), (7, 257, 512, 257, (16, 16)), (2056, 34, 384, 2, (16, 0)),
    (2313, 34, 384, 2, (32, 0))])
def test_int8_launch_takes_the_rule_form(monkeypatch, n, d, h, o, want):
    """K5's `_launch` passes the rule's (row tile, form) to its C entry point
    (clusters of 16, rows 16, at FullSubNet's full-band folds; the tile form
    with `int8_row_tile`'s R at the shipped folds), counts each launch by
    form in INT8_SWEEP_FORMS, and takes a forced form; a form the kernel
    refuses raises, naming it, with no second launch and nothing counted."""
    import collections
    import contextlib
    import types

    from fullsubnet_plus_torch.ops import nvcc

    lib = _FakeInt8Library()
    monkeypatch.setattr(nvcc, "load", lambda *_: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *_: types.SimpleNamespace(multi_processor_count=132))
    for name in ("LAUNCHES", "INT8_SWEEP_FORMS"):
        monkeypatch.setattr(ops_int8, name, collections.Counter())
    g = torch.Generator().manual_seed(0)
    lstm, linear = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    linear.reset_parameters(g)
    w = lstm.prepare_int8(linear)
    x = torch.zeros(n, d, 2, dtype=torch.bfloat16)
    assert ops_int8._launch(x, w).shape == (n, 2, o)
    assert lib.calls == [want]
    tag = f"cluster{want[1]}" if want[1] else "tile"
    assert ops_int8.INT8_SWEEP_FORMS == {f"lstm2_int8_fwd {tag}": 1}
    monkeypatch.setattr(ops_int8, "INT8_SWEEP_FORM", 16 - want[1])
    if h == 512:
        ops_int8._launch(x, w)
        assert lib.calls[1] == (16 if want[1] else lib.calls[1][0], 16 - want[1])
        assert sum(ops_int8.INT8_SWEEP_FORMS.values()) == 2
    else:
        with pytest.raises(RuntimeError, match="cluster form, clusters of 16"):
            ops_int8._launch(x, w)
        assert lib.calls[1:] == [(16, 16)]
        assert sum(ops_int8.LAUNCHES.values()) == sum(ops_int8.INT8_SWEEP_FORMS.values()) == 1


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(0), JConfig(**TINY)))


@pytest.fixture(scope="module")
def noisy():
    return (0.1 * np.random.default_rng(5).standard_normal((2, 4000))).astype(np.float32)


def _port(params, **kw):
    return Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                    device="cpu", **ACOUSTICS, **kw)


def test_int8_enhancer_close_to_float32(tiny_params, noisy):
    """> 15 dB against float32, the bar of
    tests/test_enhance_modes.py::test_int8_enhance_close_to_fp32
    (measured 45.9 dB on an x86 CPU)."""
    e = _port(tiny_params, compute_dtype="int8")
    assert e.model.config.quantized_lstm and e.dtype == torch.bfloat16
    assert e.model.sb_model.int8_weights is not None
    out = e.enhance_batch(noisy)
    assert np.isfinite(out).all()
    assert _snr(_port(tiny_params).enhance_batch(noisy), out) > 15.0


def test_int8_enhancer_matches_jax_int8(tiny_params, noisy, monkeypatch):
    """The port's int8 Enhancer against the JAX package's, whose quantized
    kernel runs in interpret mode (FORCE_PALLAS_INTERPRET, as its own test
    does), on a length-masked batch. Floor 28 dB: 10 dB under the 38.3 dB
    measured on an x86 CPU (53.3 dB without lengths). Both run bf16 models
    through 8 TCN blocks and the cIRM, rounding at the same points but
    summing in other orders."""
    import fullsubnet_plus_tpu.nn.sequence as jseq

    monkeypatch.setattr(jseq, "FORCE_PALLAS_INTERPRET", True)
    ref = JEnhancer(J_MODEL, JConfig(**TINY), tiny_params, compute_dtype="int8",
                    **ACOUSTICS).enhance_batch(noisy, lengths=[3000, 4000])
    out = _port(tiny_params, compute_dtype="int8").enhance_batch(noisy, lengths=[3000, 4000])
    assert _snr(ref, out) >= 28.0, _snr(ref, out)
