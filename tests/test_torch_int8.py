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
