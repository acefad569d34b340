"""The port's differentiable fused LSTM (fullsubnet_plus_torch/ops/lstm2_train.py)
against the JAX package's custom VJP, on the CPU: the same weights (JAX
init, carried over as numpy), the same numpy inputs and cotangent. The JAX
side runs as its own tests run it: `stacked_lstm2_train(..., interpret=True)`
under HIGHEST matmul precision, with `FUSED_WGRAD` patched for the
dgates-writing form. On the CPU the port takes its plain versions, which are
what the CUDA kernels are held against on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances: float32 atol 1e-4 / rtol 1e-4, the bound
tests/test_pallas_lstm.py holds the TPU kernels to (sum order differs);
bf16 gradients within 5 % of the float32 ones relative to their peak (that
test's own bound) and within 3 % of JAX's bf16 gradients (both round
residuals and dgates to bf16 at the same points; XLA's CPU bf16 products
and torch's differ in sum order, which moves single roundings).
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.nn.init import linear_init
from fullsubnet_plus_tpu.nn.lstm import lstm_init
from fullsubnet_plus_tpu.ops import lstm_pallas as lp
from fullsubnet_plus_torch.ops import lstm2 as ops_lstm2
from fullsubnet_plus_torch.ops import lstm2_train as lt

SHAPES = [(20, 9, 10, 16, 3), (100, 17, 34, 64, 2), (96, 12, 34, 32, 2)]  # N, T, D, H, O


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of tiny CPU ops; intra-op threads only
    add contention when several test workers share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(n, t, d, h, o, seed=0):
    """JAX-initialized weights, x [N, D, T] and the cotangent dy [N, T, O]."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, lstm_init(jax.random.PRNGKey(6), d, h, 2))
    fc = jax.tree_util.tree_map(np.asarray, linear_init(jax.random.PRNGKey(7), h, o))
    x = (rng.standard_normal((n, d, t)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((n, t, o)).astype(np.float32)
    return params, fc, x, dy


def _torch_tensors(params, fc, dtype=torch.float32, requires_grad=True):
    """torch.nn.LSTM's eight tensors and the Linear's two, from the JAX trees
    (stored [in, out]: transposed here)."""
    out = []
    for layer in params["layers"]:
        out += [layer["w_ih"].T, layer["w_hh"].T, layer["b_ih"], layer["b_hh"]]
    out += [fc["weight"].T, fc["bias"]]
    return [torch.tensor(np.ascontiguousarray(a)).to(dtype).requires_grad_(requires_grad)
            for a in out]


def _jax_grads_as_torch_order(g_params, g_x, g_fc):
    """JAX gradient trees -> [dx, then the ten tensors' gradients in torch layout]."""
    out = [np.asarray(g_x, np.float32)]
    for layer in g_params["layers"]:
        out += [np.asarray(layer["w_ih"], np.float32).T, np.asarray(layer["w_hh"], np.float32).T,
                np.asarray(layer["b_ih"], np.float32), np.asarray(layer["b_hh"], np.float32)]
    out += [np.asarray(g_fc["weight"], np.float32).T, np.asarray(g_fc["bias"], np.float32)]
    return out


def _jax_value_and_grads(params, fc, x, dy, dtype=jnp.float32):
    cast = lambda tree: jax.tree_util.tree_map(lambda p: jnp.asarray(p, dtype), tree)

    def loss(p, xx, f):
        y = lp.stacked_lstm2_train(p, xx, f, 256, True)
        return jnp.sum(y.astype(jnp.float32) * dy)

    with jax.default_matmul_precision("highest"):
        value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
            cast(params), jnp.asarray(x, dtype), cast(fc))
    return float(value), grads


def _port_value_and_grads(params, fc, x, dy, dtype=torch.float32):
    tensors = _torch_tensors(params, fc, dtype)
    xt = torch.tensor(x).to(dtype).requires_grad_()
    y = lt.lstm2_fc_train(xt, *tensors)
    value = (y.float() * torch.tensor(dy)).sum()
    grads = torch.autograd.grad(value, (xt, *tensors))
    return float(value.detach()), grads, y


@pytest.mark.parametrize("fused", [True, False], ids=["fused_wgrad", "dgates"])
@pytest.mark.parametrize("n,t,d,h,o", SHAPES)
def test_function_matches_jax_vjp(monkeypatch, n, t, d, h, o, fused):
    """Value and every gradient (x, eight LSTM tensors, fc) in both forms."""
    params, fc, x, dy = _case(n, t, d, h, o)
    monkeypatch.setattr(lp, "FUSED_WGRAD", fused)
    monkeypatch.setattr(lt, "FUSED_WGRAD", fused)
    v_ref, g_ref = _jax_value_and_grads(params, fc, x, dy)
    v, grads, _ = _port_value_and_grads(params, fc, x, dy)
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    for got, want in zip(grads, _jax_grads_as_torch_order(*g_ref)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,t,d,h,o", SHAPES)
def test_plain_forward_residuals_match_jax_kernel(n, t, d, h, o):
    """y and the six residuals of `lstm2_train_fwd_reference` against what
    `_train_fwd(interpret=True)` returns (its rows [:n]; the rest is padding)."""
    params, fc, x, _ = _case(n, t, d, h, o)
    with jax.default_matmul_precision("highest"):
        primal, saved = lp._train_fwd(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            jax.tree_util.tree_map(jnp.asarray, fc), 256, True)
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, requires_grad=False))
    y, res = lt.lstm2_train_fwd_reference(torch.tensor(x), w)
    np.testing.assert_allclose(y.numpy(), np.asarray(primal), atol=3e-5, rtol=1e-4)
    for name, got, want in zip(res._fields, res, saved[3:]):
        assert got.shape == (t, n, 4 * h if name[0] == "g" else h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :n], atol=3e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_wgrad", "dgates"])
@pytest.mark.parametrize("n,t,d,h,o", SHAPES[:2])
def test_plain_backward_matches_autograd_through_scan(monkeypatch, n, t, d, h, o, fused):
    """An independent check: the hand-written reverse sweep against autograd
    through `lstm2_fc_reference` (float32; only sum order differs)."""
    params, fc, x, dy = _case(n, t, d, h, o, seed=1)
    monkeypatch.setattr(lt, "FUSED_WGRAD", fused)
    _, grads, y = _port_value_and_grads(params, fc, x, dy)
    tensors = _torch_tensors(params, fc)
    xt = torch.tensor(x, requires_grad=True)
    y_scan = ops_lstm2.lstm2_fc_reference(xt, ops_lstm2.pack_weights(*tensors))
    want = torch.autograd.grad((y_scan * torch.tensor(dy)).sum(), (xt, *tensors))
    np.testing.assert_allclose(y.detach().numpy(), y_scan.detach().numpy(), atol=1e-6)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)


def test_weight_grad_forms_differ_only_in_the_bias_rounding():
    """In bf16 the fused form sums the unrounded dgates into db and the
    dgates-writing form the rounded ones; every other gradient is the same
    product of the same rounded operands."""
    params, fc, x, dy = _case(24, 7, 10, 16, 2)
    tensors = _torch_tensors(params, fc, torch.bfloat16, requires_grad=False)
    w = ops_lstm2.pack_weights(*tensors)
    xt, dyt = torch.tensor(x).bfloat16(), torch.tensor(dy)
    _, res = lt.lstm2_train_fwd(xt, w)
    fused = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    plain = lt.lstm2_bwd(dyt, xt, w, res, fused=False)
    for name in ("dx", "dw1", "du1", "dw2", "du2"):
        assert torch.equal(getattr(fused, name), getattr(plain, name)), name
    sweep = lt.lstm2_bwd_reference(dyt, xt, w, res)
    assert torch.equal(fused.db1, sweep.db1) and torch.equal(fused.db2, sweep.db2)
    assert torch.equal(plain.db1, sweep.dg1.float().sum((0, 1)))
    assert not torch.equal(fused.db1, plain.db1)
    np.testing.assert_allclose(fused.db1.numpy(), plain.db1.numpy(), atol=2e-2, rtol=2e-2)


def test_backward_form_follows_the_dtype_unless_set(monkeypatch):
    """FUSED_WGRAD None: bf16 and float32 take the fused K3 (measured on the
    card; float32 since its weight gradients run on the tensor cores), as a
    dtype the kernels do not take keeps the JAX package's fused form; True
    or False overrides all."""
    assert lt.FUSED_WGRAD is None
    assert lt.fused_wgrad(torch.bfloat16) and lt.fused_wgrad(torch.float32)
    assert lt.fused_wgrad(torch.float64)
    for value in (True, False):
        monkeypatch.setattr(lt, "FUSED_WGRAD", value)
        assert all(lt.fused_wgrad(dt) is value
                   for dt in (torch.float32, torch.bfloat16, torch.float64))


def test_bf16_gradients_keep_dtype_and_stay_close():
    """bf16: every gradient comes back in its tensor's dtype, within 5 % of
    the float32 one relative to its peak, and within 3 % of JAX's bf16 one."""
    n, t, d, h, o = 24, 7, 10, 16, 2
    params, fc, x, dy = _case(n, t, d, h, o)
    _, g32, _ = _port_value_and_grads(params, fc, x, dy)
    v16, g16, y16 = _port_value_and_grads(params, fc, x, dy, torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    v_jax, g_jax = _jax_value_and_grads(params, fc, x, dy, jnp.bfloat16)
    np.testing.assert_allclose(v16, v_jax, rtol=2e-2)
    for a, b, c in zip(g32, g16, _jax_grads_as_torch_order(*g_jax)):
        assert b.dtype == torch.bfloat16
        scale = float(a.abs().max()) + 1e-6
        assert float((a - b.float()).abs().max()) / scale < 0.05
        assert float((torch.tensor(c) - b.float()).abs().max()) / scale < 0.03


def test_gradcheck_float64_on_the_plain_path():
    """The plain versions admit float64: torch's numerical gradcheck holds
    the hand-written backward to central differences."""
    params, fc, _, _ = _case(3, 4, 5, 6, 2)
    tensors = _torch_tensors(params, fc, torch.float64)
    x = torch.tensor(np.random.default_rng(2).standard_normal((3, 5, 4)) * 0.5,
                     dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lt.lstm2_fc_train, (x, *tensors), eps=1e-6, atol=1e-6)


def test_rows_per_cta_and_chunking():
    """The launch geometry the wrappers compute: the reverse sweep's row
    tile, one m16 tile in both types at every fold (at N 2304 its 144 tiles
    take two waves of 132 SMs), the forward's and the reverse sweep's shared
    memory in a block, and a dgates scratch that does not grow with T: 16
    steps in float32 and 2 in bf16 at the training fold."""
    for n in (2304, 2056, 771):
        assert lt.mma_rows_per_cta(n, 132) == lt.MMA_ROWS_PER_CTA == 16
    for dtype in (torch.float32, torch.bfloat16):
        assert lt.bwd_shared_memory_bytes(16, 34, 384, 2, dtype) <= ops_lstm2.SMEM_LIMIT
    assert lt.fwd_shared_memory_bytes(16, 34, 384, 2) <= ops_lstm2.SMEM_LIMIT
    for steps in (1, 195, 10_000):
        chunk = lt.wgrad_chunk_steps(2304, 384, steps, torch.float32)
        assert chunk == min(steps, 16)
        assert 2 * chunk * 2304 * 1536 * 4 <= lt.WGRAD_SCRATCH_BYTES[torch.float32]
    assert lt.wgrad_chunk_steps(18, 512, 195, torch.float32) == 195  # the full-band fold whole
    assert lt.wgrad_chunk_steps(2304, 384, 195, torch.bfloat16) == 2
    assert lt.wgrad_chunk_steps(20, 16, 9, torch.float32) == 9  # never more than T


def _mma_weights(hidden, d_in, seed=3):
    """[W2; U2] [2H, 4H], U1 [H, 4H] and W1 [D, 4H] in bf16, as the bf16
    sweep's products read them (row c: the weights of output column c)."""
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(rows, 4 * hidden, generator=g) * 0.1).bfloat16()
            for rows in (2 * hidden, hidden, d_in)]


@pytest.mark.parametrize("which", ["w2", "u1", "w1"])
def test_mma_packing_round_trips(which):
    """Unpacking the packed fragments gives the weights back exactly; W1's
    D = 5 rows are padded with zero rows to one n-tile of 8."""
    w = dict(zip(("w2", "u1", "w1"), _mma_weights(32, 5)))[which]
    packed = ops_lstm2.pack_mma_b(w)
    tiles = -(-w.shape[0] // 8)
    assert packed.shape == (tiles, 4 * 32 // 32, 32, 8) and packed.dtype == torch.bfloat16
    assert torch.equal(ops_lstm2.unpack_mma_b(packed, w.shape[0]), w)
    padded = ops_lstm2.unpack_mma_b(packed, 8 * tiles)
    assert not padded[w.shape[0]:].any()


def _mma_emulate(a: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """a [M, K] (M a multiple of 16) times the packed B, walked as the bf16
    sweep walks it: m16 x n8 x k16 tiles in k order, each B tile rebuilt from
    the lanes' words (lane 4g + t, word e = 4 ks + 2 half + pos holds
    B[k = 8 half + 2t + pos][n = g] of k-step ks), float32 sums."""
    m = a.shape[0]
    tiles, kpairs = packed.shape[:2]
    out = torch.zeros(m, 8 * tiles)
    for mt in range(m // 16):
        rows = a[16 * mt:16 * mt + 16].float()
        for nt in range(tiles):
            acc = torch.zeros(16, 8)
            for kp in range(kpairs):
                words = packed[nt, kp].float()  # [32 lanes, 8]
                for ks in range(2):
                    b = torch.zeros(16, 8)
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        for half in range(2):
                            for pos in range(2):
                                b[8 * half + 2 * t + pos, g] = words[lane, 4 * ks + 2 * half + pos]
                    k0 = 32 * kp + 16 * ks
                    acc += rows[:, k0:k0 + 16] @ b
            out[16 * mt:16 * mt + 16, 8 * nt:8 * nt + 8] = acc
    return out


def test_mma_fragment_walk_matches_the_products():
    """At H 32, D 5, R 16: the fragment-order walk of the packed weights
    gives the sweep's three products dg @ [W2; U2]^T, dg @ U1^T and
    dg @ W1^T (float32 sums, another order: within 1e-5)."""
    hidden, d_in = 32, 5
    dg = (torch.randn(16, 4 * hidden, generator=torch.Generator().manual_seed(4))).bfloat16()
    for w in _mma_weights(hidden, d_in):
        got = _mma_emulate(dg, ops_lstm2.pack_mma_b(w))
        want = dg.float() @ w.float().t()
        np.testing.assert_allclose(got[:, :w.shape[0]].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        assert not got[:, w.shape[0]:].any()


@pytest.mark.parametrize("n", [2304, 2056, 771])
def test_bf16_sweep_tile_and_shared_memory(n):
    """The bf16 sweep's row tile is one m16 tile at the training, serving
    and ragged folds, and its shared memory (dgates bf16 [16][4H + 8], the
    float32 carries, dy tile and 12 dx partials [16][40]) fits a block; the
    float32 sweep takes the same tile and layout with float32 dgates
    [16][4H + 4] (`test_f32_bwd_sweep_shared_memory`)."""
    assert lt.mma_rows_per_cta(n, 132) == 16
    smem = lt.bwd_shared_memory_bytes(16, 34, 384, 2, torch.bfloat16)
    assert smem == 2 * 16 * (1536 + lt.MMA_PAD_BYTES // 2) + 4 * 16 * (768 + 2 + 12 * 40) == 129_408
    assert smem <= ops_lstm2.SMEM_LIMIT
    assert lt.bwd_shared_memory_bytes(16, 34, 384, 2) == smem - 2 * 16 * 1544 + 4 * 16 * 1540


def test_cuda_tensor_without_a_card_raises_not_falls_back():
    """A non-CPU tensor never takes the plain version."""
    params, fc, x, _ = _case(4, 3, 6, 32, 2)
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, requires_grad=False))
    meta = torch.tensor(x, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lt.lstm2_train_fwd(meta, w)


# ---------------------------------------------------------------------------
# the bf16 forward sweep's layout (csrc/lstm2_fwd_sweep.cuh, sweep_mma_kernel)
# ---------------------------------------------------------------------------

def _fwd_case(n, t, d, h, o, seed=5):
    """bf16 weights (as the sweep reads them: fc_w bf16-valued) and x [N, D, T]."""
    params, fc, _, _ = _case(n, t, d, h, o, seed)
    tensors = _torch_tensors(params, fc, torch.bfloat16, requires_grad=False)
    x = torch.rand(n, d, t, generator=torch.Generator().manual_seed(seed)).mul(2).bfloat16()
    return x, ops_lstm2.pack_weights(*tensors)


def test_gate_interleave_round_trips():
    """n-tile 4u + gate of the interleaved columns holds that gate of units
    8u .. 8u + 7, and deinterleaving restores the order i, f, g, o."""
    hidden = 32
    cols = torch.arange(4 * hidden)  # gate * H + unit
    inter = ops_lstm2.interleave_gates(cols)
    for u in range(hidden // 8):
        for gate in range(4):
            tile = inter[8 * (4 * u + gate): 8 * (4 * u + gate) + 8]
            assert torch.equal(tile, gate * hidden + 8 * u + torch.arange(8))
    assert torch.equal(ops_lstm2.deinterleave_gates(inter), cols)
    w = torch.randn(3, 5, 4 * hidden)
    assert torch.equal(ops_lstm2.deinterleave_gates(ops_lstm2.interleave_gates(w)), w)


def test_fwd_mma_packing_round_trips():
    """Unpacked and deinterleaved, the fragments are [W1 (zero rows up to 64);
    U1]^T, [W2; U2]^T and W_fc^T in bf16, the biases interleaved alike; O 3
    pads to one n-tile of 8 with zero rows."""
    _, w = _fwd_case(8, 2, 10, 32, 3)
    p = ops_lstm2.pack_fwd_mma(w)
    xc = ops_lstm2.x_cols(10)
    assert xc == 32 and ops_lstm2.x_cols(34) == 64
    assert p.w1.shape == (16, (xc + 32) // 32, 32, 8) and p.w1.dtype == torch.bfloat16
    w1 = ops_lstm2.deinterleave_gates(ops_lstm2.unpack_mma_b(p.w1, 128).t())
    assert torch.equal(w1[:10], w.w1) and not w1[10:xc].any() and torch.equal(w1[xc:], w.u1)
    assert torch.equal(ops_lstm2.deinterleave_gates(ops_lstm2.unpack_mma_b(p.w2, 128).t()), w.w2)
    assert torch.equal(ops_lstm2.unpack_mma_b(p.fc, 3).float(), w.fc_w.t())
    assert not ops_lstm2.unpack_mma_b(p.fc, 8)[3:].any()
    for packed, bias in ((p.b1, w.b1), (p.b2, w.b2)):
        assert torch.equal(ops_lstm2.deinterleave_gates(packed), bias)


def _fragment_matrix(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The B operand [K, n] rebuilt from the packed words as the lanes read
    them: lane 4g + t, word 4 ks + 2 half + pos of n-tile nt, k-pair kp holds
    B[32 kp + 16 ks + 8 half + 2t + pos][8 nt + g]."""
    tiles, kpairs = packed.shape[:2]
    b = torch.zeros(kpairs, 32, tiles, 8)
    words = packed.float()
    for lane in range(32):
        g, t = divmod(lane, 4)
        for ks in range(2):
            for half in range(2):
                for pos in range(2):
                    word = words[:, :, lane, 4 * ks + 2 * half + pos]  # [tiles, kpairs]
                    b[:, 16 * ks + 8 * half + 2 * t + pos, :, g] = word.t()
    return b.reshape(32 * kpairs, 8 * tiles)[:, :n]


def _cell_from_accumulators(acc, c):
    """The kernel's cell_mma over every lane: warp w, pass p (unit group
    u = 4w + p), lane (g, q), accumulator word e of gate n-tile 4u + gate
    holds row 16 mt + g + 8 (e / 2), unit 8u + 2q + e % 2, column 2q + e % 2
    of its n-tile. Returns (h, c, activated gates in order i, f, g, o) and
    checks that every (row, unit) is visited once."""
    rows, hidden = c.shape
    h, c, act = torch.zeros_like(c), c.clone(), torch.zeros(rows, 4 * hidden)
    seen = torch.zeros(rows, hidden, dtype=torch.int64)
    mts = torch.arange(rows // 16) * 16
    for warp in range(hidden // 32):
        for p in range(4):
            u = 4 * warp + p
            for lane in range(32):
                g, q = divmod(lane, 4)
                for e in range(4):
                    r = mts + g + 8 * (e // 2)
                    unit, col = 8 * u + 2 * q + e % 2, 2 * q + e % 2
                    pre = [acc[r, 8 * (4 * u + gate) + col] for gate in range(4)]
                    i, f, gg, o = (torch.sigmoid(pre[0]), torch.sigmoid(pre[1]),
                                   torch.tanh(pre[2]), torch.sigmoid(pre[3]))
                    c[r, unit] = f * c[r, unit] + i * gg
                    h[r, unit] = o * torch.tanh(c[r, unit])
                    for gate, a in enumerate((i, f, gg, o)):
                        act[r, gate * hidden + unit] = a
                    seen[r, unit] += 1
    assert (seen == 1).all()
    return h, c, act


def _fwd_mma_emulate(x: torch.Tensor, w, product=torch.matmul):
    """The sweep walked as the kernel walks it, in the weights' dtype:
    operand rows [x | h1 | h2] (x padded to x_cols(D, dtype)), the packed fragments
    as B (`_fragment_matrix` in bf16, `_tf32_fragment_matrix` in float32),
    float32 sums (`product`) from the interleaved biases, the cell from the
    accumulators, h into the operand rows (rounded to bf16 in bf16), the fc
    over the h2 columns. -> (y [N, T, O], g1, c1, h1, g2, c2, h2 [T, N, .])."""
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    dtype = w.w1.dtype
    p, xc = ops_lstm2.pack_fwd_mma(w), ops_lstm2.x_cols(d, dtype)
    walk = _fragment_matrix if dtype == torch.bfloat16 else _tf32_fragment_matrix
    b1, b2 = (walk(m, 4 * hidden) for m in (p.w1, p.w2))
    bfc = walk(p.fc, out_dim)
    rows = -(-n // 16) * 16
    ops = torch.zeros(rows, xc + 2 * hidden)
    c1, c2 = torch.zeros(rows, hidden), torch.zeros(rows, hidden)
    ys, saved = [], []
    for t in range(steps):
        ops[:n, :d] = x[:, :, t].float()
        h1, c1, a1 = _cell_from_accumulators(p.b1 + product(ops[:, :xc + hidden], b1), c1)
        ops[:, xc:xc + hidden] = h1.to(dtype).float()
        h2, c2, a2 = _cell_from_accumulators(p.b2 + product(ops[:, xc:], b2), c2)
        ops[:, xc + hidden:] = h2.to(dtype).float()
        ys.append(product(ops[:n, xc + hidden:], bfc) + w.fc_b)
        saved.append([a[:n].to(dtype, copy=True) for a in (a1, c1, ops[:, xc:xc + hidden], a2,
                                                           c2, ops[:, xc + hidden:])])
    return (torch.stack(ys, dim=1).to(dtype),
            *(torch.stack(s) for s in zip(*saved)))


@pytest.mark.parametrize("n,t,d,h,o", [(37, 4, 34, 32, 2), (21, 3, 10, 64, 11)])
def test_fwd_fragment_walk_matches_the_plain_forward(n, t, d, h, o):
    """The fragment-order walk of the bf16 forward sweep (products, the cell
    from the accumulators, the fc) gives `lstm2_fc_reference`'s y and
    `lstm2_train_fwd_reference`'s residuals: the same bf16 operands, float32
    sums in another order (a rare bf16 rounding of h may flip, hence the
    bf16 bound of test_torch_nn.py)."""
    x, w = _fwd_case(n, t, d, h, o)
    y, *res = _fwd_mma_emulate(x, w)
    y_plain = ops_lstm2.lstm2_fc_reference(x, w)
    np.testing.assert_allclose(y.float().numpy(), y_plain.float().numpy(), atol=2e-2, rtol=2e-2)
    y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
    assert torch.equal(y_ref, y_plain)
    for name, got, want in zip(lt.Residuals._fields, res, res_ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2,
                                   rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("n,rows", [(2304, 32), (2056, 16), (771, 16)])
def test_fwd_mma_tile_and_shared_memory(n, rows):
    """The bf16 forward's row tile at the training, batch and ragged folds
    (fewest waves of one CTA per SM on 132 SMs, then the smaller tile: 2304
    rows need two waves of 16 and one of 32), the one K2 and K1 both take,
    and its shared memory (two operand buffers [R][64 + 768 + 8] bf16, c1
    and c2 [R][384] float32) in a block at D 34, H 384. The float32 sweep
    takes R 16 at every fold: two operand buffers [16][48 + 768 + 4]
    float32 (x padded to whole float32 k-chunks of 16) and c1, c2 fit; at R
    32 they do not."""
    assert ops_lstm2.fwd_mma_rows_per_cta(n, 132) == rows
    assert ops_lstm2.fwd_mma_row_tile(n, 34, 384, 132) == rows
    smem = lt.fwd_shared_memory_bytes(rows, 34, 384, 2, torch.bfloat16)
    assert smem == ops_lstm2.fwd_mma_shared_memory_bytes(rows, 34, 384)
    assert smem == 4 * rows * 840 + 8 * rows * 384 <= ops_lstm2.SMEM_LIMIT
    assert ops_lstm2.fwd_mma_row_tile(n, 34, 384, 132, torch.float32) == 16
    smem = lt.fwd_shared_memory_bytes(16, 34, 384, 2)
    assert smem == ops_lstm2.fwd_mma_shared_memory_bytes(16, 34, 384, torch.float32)
    assert smem == 8 * 16 * 820 + 8 * 16 * 384 == 154_112 <= ops_lstm2.SMEM_LIMIT
    assert ops_lstm2.fwd_mma_shared_memory_bytes(32, 34, 384, torch.float32) > ops_lstm2.SMEM_LIMIT


def test_fwd_mma_fits_the_fullsubnet_full_band_shape():
    """FullSubNet's full-band LSTM (D 257, H 512, O 257): the bf16 forward fits
    a block at R 16, whose shared memory does not grow with O, and falls back
    to it from R 32; the float32 forward, with x padded to whole float32
    k-chunks (272 columns, not the 288 of bf16's k-chunks of 32), fits at R
    16 too: two operand buffers [16][272 + 1024 + 4] float32 and c1, c2, 512
    bytes under the limit, the row pitch an odd multiple of 16 bytes (5,200 =
    325 x 16), so ldmatrix stays free of bank conflicts."""
    assert ops_lstm2.fwd_mma_shared_memory_bytes(16, 257, 512) == 150_016 <= ops_lstm2.SMEM_LIMIT
    assert ops_lstm2.fwd_mma_shared_memory_bytes(32, 257, 512) > ops_lstm2.SMEM_LIMIT
    assert ops_lstm2.fwd_mma_row_tile(4626, 257, 512, 132) == 16
    assert ops_lstm2.x_cols(257, torch.float32) == 272 and ops_lstm2.x_cols(257) == 288
    f32 = ops_lstm2.fwd_mma_shared_memory_bytes(16, 257, 512, torch.float32)
    assert f32 == 8 * 16 * (272 + 1024 + 4) + 8 * 16 * 512 == 231_936
    assert f32 == ops_lstm2.SMEM_LIMIT - 512
    assert (4 * (272 + 1024 + 4)) % 32 == 16
    for n in (8, 4626):
        assert ops_lstm2.fwd_mma_row_tile(n, 257, 512, 132, torch.float32) == 16
    p = ops_lstm2.pack_fwd_mma(_fwd_f32_case(3, 2, 257, 512, 257)[1])
    assert p.w1.shape == (256, (272 + 512) // 16, 32, 4)
    assert p.fc.shape == (33, 512 // 16, 32, 4)


# ---------------------------------------------------------------------------
# the float32 forward sweep (csrc/lstm2_fwd_sweep.cuh, sweep_mma_kernel<float>):
# mma.sync m16n8k8 fragments and three TF32 products of split operands
# ---------------------------------------------------------------------------

def _fwd_f32_case(n, t, d, h, o, seed=5):
    """float32 weights and x [N, D, T] (uniform in [0, 2), as after the norm)."""
    params, fc, _, _ = _case(n, t, d, h, o, seed)
    tensors = _torch_tensors(params, fc, torch.float32, requires_grad=False)
    x = torch.rand(n, d, t, generator=torch.Generator().manual_seed(seed)).mul(2)
    return x, ops_lstm2.pack_weights(*tensors)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (cvt.rna.tf32.f32's bits), as lstm2::split_tf32 computes it: the
    magnitude bits plus half of the dropped 13, which are then cleared."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(a: torch.Tensor):
    """lstm2::split_tf32 as the tensor core reads it: big = a rounded to
    TF32, small = a - big (exact in float32) rounded to TF32 the same way
    (split_tf32 adds half of the 13 low bits, the tensor core drops them)."""
    big = _tf32(a)
    return big, _tf32(a - big)


def _three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] b [K, N] as the kernel computes it: k-chunks of 16 in k order,
    each summing its two k-steps of 8 (small.big, big.small and big.big of
    the split operands, mma_3xtf32) into a zeroed partial that is then added
    to the float32 sum."""
    (a_big, a_small), (b_big, b_small) = _split_tf32(a), _split_tf32(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for chunk in range(0, a.shape[1], 16):
        part = torch.zeros_like(acc)
        for k in (chunk, chunk + 8):
            part += a_small[:, k:k + 8] @ b_big[k:k + 8]
            part += a_big[:, k:k + 8] @ b_small[k:k + 8]
            part += a_big[:, k:k + 8] @ b_big[k:k + 8]
        acc += part
    return acc


def _one_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same product from TF32 operands alone, float32 sums."""
    return _tf32(a) @ _tf32(b)


def _tf32_fragment_matrix(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The B operand [K, n] rebuilt from `pack_tf32_b`'s words as the lanes of
    mma.sync m16n8k8 read them: lane 4g + t, word 2 ks + half of n-tile nt,
    k-chunk kc is b0 (half 0) or b1 (half 1) of k-step 2 kc + ks, B[16 kc +
    8 ks + 4 half + t][8 nt + g]."""
    words = packed.numpy()
    tiles, chunks = words.shape[:2]
    b = np.zeros((chunks, 16, tiles, 8), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for ks in range(2):
            for half in range(2):
                b[:, 8 * ks + 4 * half + t, :, g] = words[:, :, lane, 2 * ks + half].T
    return torch.from_numpy(b.reshape(16 * chunks, 8 * tiles)[:, :n])


def _snr_db(ref: torch.Tensor, out: torch.Tensor) -> float:
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def test_tf32_packing_round_trips_and_walks_the_lanes():
    """`pack_tf32_b` unpacks to the weight bit for bit, with zero rows past
    n; its words, walked as m16n8k8's B fragments, rebuild B = w^T; and the
    float32 sweep's operands (`pack_fwd_mma` of float32 weights) unpack and
    deinterleave to [W1 (zero rows up to 16, a float32 k-chunk); U1]^T, [W2; U2]^T and W_fc^T,
    O 3 padded to one n-tile of 8, with the biases interleaved alike."""
    w = torch.randn(13, 48, generator=torch.Generator().manual_seed(8))
    packed = ops_lstm2.pack_tf32_b(w)
    assert packed.shape == (2, 3, 32, 4) and packed.dtype == torch.float32
    assert torch.equal(ops_lstm2.unpack_tf32_b(packed, 13), w)
    assert not ops_lstm2.unpack_tf32_b(packed, 16)[13:].any()
    assert torch.equal(_tf32_fragment_matrix(packed, 13), w.t())
    _, wf = _fwd_f32_case(8, 2, 10, 32, 3)
    p = ops_lstm2.pack_fwd_mma(wf)
    assert p.w1.shape == (16, (16 + 32) // 16, 32, 4) and p.w1.dtype == torch.float32
    w1 = ops_lstm2.deinterleave_gates(ops_lstm2.unpack_tf32_b(p.w1, 128).t())
    assert torch.equal(w1[:10], wf.w1) and not w1[10:16].any() and torch.equal(w1[16:], wf.u1)
    w2 = ops_lstm2.deinterleave_gates(_tf32_fragment_matrix(p.w2, 128))
    assert torch.equal(w2, wf.w2)
    assert torch.equal(ops_lstm2.unpack_tf32_b(p.fc, 3), wf.fc_w.t())
    assert not ops_lstm2.unpack_tf32_b(p.fc, 8)[3:].any()
    for packed_bias, bias in ((p.b1, wf.b1), (p.b2, wf.b2)):
        assert torch.equal(ops_lstm2.deinterleave_gates(packed_bias), bias)


def test_tf32_split_keeps_21_bits():
    """On seeded normal values scaled by 1e-30 .. 1e30, and zeros, both
    halves as the tensor core reads them are TF32 (the low 13 bits zero)
    and a - big - small is within 2^-22 |a| (both halves rounded to
    nearest: 22 bits); big + small is exact in float32."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal(20_000) * 10.0 ** rng.uniform(-30, 30, 20_000)
    a = torch.from_numpy(np.concatenate([a, np.zeros(16)]).astype(np.float32))
    big, small = _split_tf32(a)
    for half in (big, small):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    err = (a.double() - big.double() - small.double()).abs()
    assert (err <= 2.0 ** -22 * a.double().abs()).all()
    assert torch.equal((big + small).double(), big.double() + small.double())


@pytest.mark.parametrize("n,t,d,h,o", [(37, 4, 34, 32, 2), (21, 3, 10, 64, 11)])
def test_fwd_three_tf32_walk_holds_the_float32_floors(n, t, d, h, o):
    """The float32 sweep walked as the kernel walks it (the m16n8k8
    fragments, three TF32 products of split operands in k-steps of 8, summed
    a k-chunk at a time into float32 sums, the cell from the accumulators, h
    not rounded) gives
    `lstm2_fc_reference`'s y and `lstm2_train_fwd_reference`'s residuals at
    100 dB or more (136-151 dB); the same walk with one TF32 product falls
    under the 80 dB floor that K2 is held to over y and its residuals (c1 and
    h1 at 71-72 dB here; y alone at 72 and 81 dB at these few steps), which
    is why the kernel takes three."""
    x, w = _fwd_f32_case(n, t, d, h, o)
    y_plain = ops_lstm2.lstm2_fc_reference(x, w)
    y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
    assert torch.equal(y_ref, y_plain)
    snrs = {}
    for name, product in (("3xtf32", _three_tf32), ("1xtf32", _one_tf32)):
        y, *res = _fwd_mma_emulate(x, w, product)
        assert y.dtype == torch.float32 and all(r.shape == e.shape for r, e in zip(res, res_ref))
        snrs[name] = {"y": _snr_db(y_plain, y),
                      **{f: _snr_db(e, r) for f, r, e in zip(lt.Residuals._fields, res, res_ref)}}
    assert min(snrs["3xtf32"].values()) >= 100.0, snrs
    assert min(snrs["1xtf32"].values()) < 80.0, snrs


# ---------------------------------------------------------------------------
# the float32 reverse sweep (csrc/lstm2_bwd_sweep.cuh, sweep_mma_kernel<float>):
# the three transposed products as three TF32 products of split operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["w2", "u1", "w1"])
def test_bwd_tf32_packing_round_trips_and_walks_the_lanes(which):
    """The float32 reverse sweep's B operands, `pack_tf32_b` of [W2; U2]
    [2H, 4H], U1 [H, 4H] and W1 [D, 4H] (row c: the weights of output column
    c), unpack bit for bit, W1's D 34 rows padded with zero rows to five
    n-tiles (40 columns of dx), and walked as m16n8k8's B fragments rebuild
    the transposed weight."""
    hidden, d_in = 32, 34
    rows = {"w2": 2 * hidden, "u1": hidden, "w1": d_in}[which]
    w = torch.randn(rows, 4 * hidden, generator=torch.Generator().manual_seed(12)) * 0.1
    packed = ops_lstm2.pack_tf32_b(w)
    tiles = -(-rows // 8)
    assert packed.shape == (tiles, 4 * hidden // 16, 32, 4) and packed.dtype == torch.float32
    assert torch.equal(ops_lstm2.unpack_tf32_b(packed, rows), w)
    assert not ops_lstm2.unpack_tf32_b(packed, 8 * tiles)[rows:].any()
    assert torch.equal(_tf32_fragment_matrix(packed, rows), w.t())
    if which == "w1":
        assert 8 * tiles == 40


def _bwd_three_tf32_walk(dy, x, w, res, ksplit=True):
    """The float32 reverse sweep walked as the kernel walks it: per step the
    cell backward (no rounding in float32), then the three products from
    the packed fragments (`_tf32_fragment_matrix` of `pack_tf32_b`), each as
    three TF32 products of split operands summed a k-chunk of 16 at a time
    into the float32 sums (`_three_tf32`): [dh1' | dh2_carry] over all 4H
    with dh1' added to the dh1 carry, dh1_carry, and dx either as H / 32
    k-parts, one a warp, each over its own run of k-chunks, added in warp
    order from zero (`ksplit`), or output-stationary, each n-tile over all
    the k-chunks. -> (dx [N, D, T], dg1, dg2 [T, N, 4H])."""
    n, _, steps = x.shape
    hidden = w.u1.shape[0]
    warps, chunks = (hidden // 32 if ksplit else 1), 4 * hidden // 16
    b_w2, b_u1, b_w1 = (_tf32_fragment_matrix(ops_lstm2.pack_tf32_b(m), m.shape[0])
                        for m in (w.w2, w.u1, w.w1))
    zeros = torch.zeros(n, hidden)
    dh1, dc1, dh2, dc2 = zeros, zeros, zeros, zeros
    dx, dg1, dg2 = [None] * steps, [None] * steps, [None] * steps
    for t in range(steps - 1, -1, -1):
        c2_prev = res.c2[t - 1] if t else zeros
        dg2[t], dc2 = lt._cell_bwd(dy[:, t] @ w.fc_w.t() + dh2, res.g2[t], res.c2[t], c2_prev, dc2)
        dinp2 = _three_tf32(dg2[t], b_w2)
        dh2 = dinp2[:, hidden:]
        c1_prev = res.c1[t - 1] if t else zeros
        dg1[t], dc1 = lt._cell_bwd(dinp2[:, :hidden] + dh1, res.g1[t], res.c1[t], c1_prev, dc1)
        dh1 = _three_tf32(dg1[t], b_u1)
        s = torch.zeros(n, b_w1.shape[1])
        for part in range(warps):
            k0, k1 = 16 * (part * chunks // warps), 16 * ((part + 1) * chunks // warps)
            s = s + _three_tf32(dg1[t][:, k0:k1], b_w1[k0:k1])
        dx[t] = s
    return torch.stack(dx, dim=2), torch.stack(dg1), torch.stack(dg2)


@pytest.mark.parametrize("ksplit", [True, False], ids=["ksplit", "output_stationary"])
@pytest.mark.parametrize("n,t,d,h,o", [(37, 4, 34, 64, 2), (21, 3, 10, 96, 11)])
def test_bwd_three_tf32_walk_holds_the_float32_floors(n, t, d, h, o, ksplit):
    """The float32 reverse sweep walked in the kernel's fragment order (split
    operands with the tensor core's 13-bit truncation of small, per-chunk
    partials; dx in either form: k-parts added in warp order, 2 and 3 warps
    here, or each n-tile over all 4H; D 10 padded to two n-tiles) gives
    `lstm2_bwd_reference`'s dx and dgates at the 80 dB floor K3 and K4 are
    held to on the card, at two ragged folds."""
    x, w = _fwd_f32_case(n, t, d, h, o)
    _, res = lt.lstm2_train_fwd_reference(x, w)
    dy = torch.randn(n, t, o, generator=torch.Generator().manual_seed(13))
    want = lt.lstm2_bwd_reference(dy, x, w, res)
    got = _bwd_three_tf32_walk(dy, x, w, res, ksplit)
    snrs = {name: _snr_db(a, b) for name, a, b in zip(("dx", "dg1", "dg2"), want[:3], got)}
    assert all(a.shape == b.shape for a, b in zip(want[:3], got))
    assert min(snrs.values()) >= 80.0, snrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_sweep_shared_memory(dtype):
    """The reverse sweep's shared memory, both forms of dx at both shapes.
    At the shipped sub-band shape (D 34, H 384, O 2) dx stays k-split: in
    float32 dgates [16][4H + 4] (98,560 bytes), the dh1 and dh2 carries
    (49,152), the dy tile (128) and 12 dx partials [16][40] (30,720):
    178,560 bytes, one CTA an SM (bf16: 129,408). At FullSubNet's full-band
    shape (D 257, H 512, O 257) the 16 per-warp partials [16][264] alone
    would take 270,336 bytes, so dx is output-stationary and the block holds
    the dgates (131,328 / 65,792), the carries (65,536) and the dy tile
    (16,448): 213,312 bytes in float32, 147,776 in bf16, both under the
    232,448 a block may use."""
    size = 4 if dtype == torch.float32 else 2
    shipped = lt.bwd_shared_memory_bytes(16, 34, 384, 2, dtype)
    assert lt.bwd_dx_ksplit(16, 34, 384, 2, dtype)
    assert shipped == size * 16 * (1536 + 16 // size) + 4 * 16 * (768 + 2 + 12 * 40)
    assert shipped == {4: 178_560, 2: 129_408}[size] <= ops_lstm2.SMEM_LIMIT
    fb = lt.bwd_shared_memory_bytes(16, 257, 512, 257, dtype)
    assert not lt.bwd_dx_ksplit(16, 257, 512, 257, dtype)
    assert fb == size * 16 * (2048 + 16 // size) + 4 * 16 * (1024 + 257)
    assert fb == {4: 213_312, 2: 147_776}[size] <= ops_lstm2.SMEM_LIMIT
    assert 4 * 16 * 16 * 264 == 270_336 > ops_lstm2.SMEM_LIMIT
    # the 512-thread k-split at D 32 (tests/test_torch_cuda_kernels.py) still fits
    assert lt.bwd_dx_ksplit(16, 32, 512, 2, torch.float32)
    # a dy tile of O 2048 fits in neither form: the wrappers' check refuses it
    assert lt.bwd_shared_memory_bytes(16, 257, 512, 2048, dtype) > ops_lstm2.SMEM_LIMIT
    assert lt.bwd_shared_memory_bytes(16, 257, 512, 257, dtype, ksplit=True) == \
        fb + 4 * 16 * 16 * 264


# ---------------------------------------------------------------------------
# the reverse sweep's cluster form (csrc/lstm2_bwd_sweep.cuh, sweep_cluster_kernel)
# ---------------------------------------------------------------------------

def _cluster_columns(rank, cluster, hidden, d_in):
    """The output columns CTA `rank` of a cluster of `cluster` computes, as
    `sweep_cluster_kernel` assigns them (units U_c = [cU, (c + 1) U), U = H /
    C): of [dh1' | dh2_carry] U_c and H + U_c, of dh1_carry U_c, and of dx
    the n-tiles nt = c (mod C) of the ceil(D / 8) n-tiles, columns past D
    cut."""
    units = hidden // cluster
    own = list(range(rank * units, (rank + 1) * units))
    dx = [8 * nt + i for nt in range(rank, -(-d_in // 8), cluster) for i in range(8)
          if 8 * nt + i < d_in]
    return own + [hidden + j for j in own], own, dx


def _cluster_kpart(part, cluster, hidden, kch=16):
    """The gate columns k-part `part` of CLUSTER_KPARTS contracts over, in
    its order, as `owned_mma` walks them: its run of the 4H / kch k-chunks in
    owner-major order (owner o, then gate g, then chunk s of the owner's
    strip of U / kch chunks), chunk (o, g, s) the kch columns from g H + o U
    + s kch."""
    units, parts, chunks = hidden // cluster, lt.CLUSTER_KPARTS, 4 * hidden // kch
    strip = units // kch
    cols = []
    for q in range(part * chunks // parts, (part + 1) * chunks // parts):
        o, g, s = q // (4 * strip), q % (4 * strip) // strip, q % strip
        cols += range(g * hidden + o * units + s * kch, g * hidden + o * units + (s + 1) * kch)
    return cols


def _bwd_cluster_walk(dy, x, w, res, cluster):
    """The float32 cluster form walked as the kernel walks it: per step and
    CTA, the cells of its units (dy W_fc^T + the dh2 carry for layer 2, dh1'
    + the dh1 carry for layer 1), the tile's whole dgates (the exchange),
    then the CTA's own columns of each product (`_cluster_columns`) as
    CLUSTER_KPARTS k-parts (`_cluster_kpart`: owner-major runs of k-chunks
    of 16), each summed as three TF32 products of split operands with
    per-chunk partials (`_three_tf32`), added in k-part order from zero.
    -> (dx, dg1, dg2)."""
    n, d_in, steps = x.shape
    hidden = w.u1.shape[0]
    units, parts = hidden // cluster, lt.CLUSTER_KPARTS
    b_w2, b_u1, b_w1 = (_tf32_fragment_matrix(ops_lstm2.pack_tf32_b(m), m.shape[0])
                        for m in (w.w2, w.u1, w.w1))
    kparts = [_cluster_kpart(part, cluster, hidden) for part in range(parts)]

    def product(dg, b, cols):
        s = torch.zeros(n, len(cols))
        for k in kparts:
            s = s + _three_tf32(dg[:, k], b[k][:, cols])
        return s

    zeros = torch.zeros(n, hidden)
    dh1, dc1, dh2, dc2 = zeros, zeros.clone(), zeros, zeros.clone()
    dx, dg1, dg2 = [None] * steps, [None] * steps, [None] * steps
    for t in range(steps - 1, -1, -1):
        c2_prev = res.c2[t - 1] if t else zeros
        dg2[t], dc2 = lt._cell_bwd(dy[:, t] @ w.fc_w.t() + dh2, res.g2[t], res.c2[t], c2_prev,
                                   dc2)
        dinp2 = torch.zeros(n, 2 * hidden)
        for c in range(cluster):
            cols, _, _ = _cluster_columns(c, cluster, hidden, d_in)
            dinp2[:, cols] = product(dg2[t], b_w2, cols)
        dh2 = dinp2[:, hidden:]
        c1_prev = res.c1[t - 1] if t else zeros
        dg1[t], dc1 = lt._cell_bwd(dinp2[:, :hidden] + dh1, res.g1[t], res.c1[t], c1_prev, dc1)
        dh1, dx[t] = torch.zeros(n, hidden), torch.zeros(n, d_in)
        for c in range(cluster):
            _, own, dx_cols = _cluster_columns(c, cluster, hidden, d_in)
            dh1[:, own] = product(dg1[t], b_u1, own)
            dx[t][:, dx_cols] = product(dg1[t], b_w1, dx_cols)
        assert units * cluster == hidden
    return torch.stack(dx, dim=2), torch.stack(dg1), torch.stack(dg2)


@pytest.mark.parametrize("n,t,d,h,o,cluster", [(37, 4, 34, 64, 2, 2), (21, 3, 10, 128, 11, 4)])
def test_bwd_cluster_walk_holds_the_float32_floors(n, t, d, h, o, cluster):
    """The float32 cluster form walked in the kernel's order (each CTA its
    own 32 units' cells and its own columns of the three products, k-parts
    of three TF32 products with per-chunk partials added in order; clusters
    of 2 and 4, D 34 and 10 ragged over the CTAs' dx n-tiles) gives
    `lstm2_bwd_reference`'s dx and dgates at the 80 dB floor K3 and K4 are
    held to on the card, at two ragged folds."""
    x, w = _fwd_f32_case(n, t, d, h, o)
    _, res = lt.lstm2_train_fwd_reference(x, w)
    dy = torch.randn(n, t, o, generator=torch.Generator().manual_seed(13))
    want = lt.lstm2_bwd_reference(dy, x, w, res)
    got = _bwd_cluster_walk(dy, x, w, res, cluster)
    assert all(a.shape == b.shape for a, b in zip(want[:3], got))
    snrs = {name: _snr_db(a, b) for name, a, b in zip(("dx", "dg1", "dg2"), want[:3], got)}
    assert min(snrs.values()) >= 80.0, snrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_sweep_cluster_rule(dtype):
    """The reverse sweep's form (`bwd_sweep_cluster`, by shape alone): the
    tile form (0) at the shipped training fold (N 2304, D 34, H 384, O 2), a
    card's half of it on a 2-card mesh (N 1152) and FullSubNet's sub-band
    fold (N 4626, D 32); clusters of 16 at FullSubNet's full-band shape (D
    257, H 512, O 257) for N 18, 9 and 7, and in waves up to
    CLUSTER_MAX_ROWS; the tile form past it, for a wider O, another H and D
    > H."""
    for n, d, h, o in ((2304, 34, 384, 2), (1152, 34, 384, 2), (4626, 32, 384, 2), (18, 34, 384, 2)):
        assert lt.bwd_sweep_cluster(n, d, h, o, dtype) == 0
    for n in (18, 9, 7, 113, lt.CLUSTER_MAX_ROWS):
        assert lt.bwd_sweep_cluster(n, 257, 512, 257, dtype) == lt.SWEEP_CLUSTER == 16
    assert lt.bwd_sweep_cluster(lt.CLUSTER_MAX_ROWS + 1, 257, 512, 257, dtype) == 0
    assert lt.bwd_sweep_cluster(18, 257, 512, lt.CLUSTER_MAX_O + 1, dtype) == 0
    assert lt.bwd_sweep_cluster(18, 257, 256, 257, dtype) == 0
    assert lt.bwd_sweep_cluster(18, 513, 512, 257, dtype) == 0


@pytest.mark.parametrize("d", [257, 34])
@pytest.mark.parametrize("cluster", [8, 16])
def test_bwd_cluster_columns_have_one_owner(cluster, d):
    """Over H = 32 C split into C = 8 or 16 CTAs of 32 units, every output
    column of [dh1' | dh2_carry] (2H), of dh1_carry (H) and of dx (D 257: 33
    n-tiles; D 34: 5, so most CTAs own none) has exactly one owning CTA; and
    the k-parts of a product cover each of the 4H gate columns once, in both
    dtypes' k-chunks (16 float32 words, 32 bf16 ones), each spanning C / 8
    owners' blocks."""
    hidden = lt.CLUSTER_UNITS * cluster
    owners = [np.zeros(2 * hidden, int), np.zeros(hidden, int), np.zeros(d, int)]
    for c in range(cluster):
        for count, cols in zip(owners, _cluster_columns(c, cluster, hidden, d)):
            np.add.at(count, cols, 1)
    assert all((count == 1).all() for count in owners)
    units = hidden // cluster
    for kch in (16, 32):
        kparts = [_cluster_kpart(p, cluster, hidden, kch) for p in range(lt.CLUSTER_KPARTS)]
        assert sorted(sum(kparts, [])) == list(range(4 * hidden))
        for k in kparts:
            assert len({col % hidden // units for col in k}) == cluster // lt.CLUSTER_KPARTS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_cluster_shared_memory(dtype):
    """The cluster form's shared memory at FullSubNet's full-band shape (D
    257, H 512, O 257), clusters of 16 (32 units a CTA): an mbarrier an owner
    (128 bytes), the dgates as 16 owners' blocks [16][4U + pad] (135,168
    bytes in float32, 69,632 in bf16), W_fc's rows [32][260] (33,280) and the
    dy tile [16][260] (16,640; 260: an odd number of 4-float words), the
    k-part partials [8][16][72] (36,864) and dy W_fc^T [16][32] (2,048):
    224,128 / 158,592 bytes, under the 232,448 a block may use."""
    size = 4 if dtype == torch.float32 else 2
    got = lt.bwd_cluster_shared_memory_bytes(257, 512, 257, dtype)
    assert got == 128 + size * 16 * 16 * (128 + 16 // size) + 4 * (48 * 260 + 8 * 16 * 72 + 16 * 32)
    assert got == {4: 224_128, 2: 158_592}[size] <= ops_lstm2.SMEM_LIMIT
    assert lt.bwd_cluster_shared_memory_bytes(34, 512, 257, dtype) == got  # D does not enter


# ---------------------------------------------------------------------------
# the forward sweep's cluster form (csrc/lstm2_fwd_sweep.cuh, sweep_cluster_kernel)
# ---------------------------------------------------------------------------

def _fwd_cluster_kparts(d_in, hidden, kch=16):
    """Each k-part's k-chunks of the three products in the order a warp of
    `sweep_cluster_kernel` runs them, as row indices of the operand: layer 1
    ([x | h1], x padded to x_cols) its run of the x chunks, then its run of
    the h chunks (owner-major: owner o's block holds units [32o, 32o + 32));
    layer 2 ([h1 | h2]) the same h chunks of h2 first, then of h1; the fc
    (over h2) the same h chunks."""
    dtype = torch.float32 if kch == 16 else torch.bfloat16
    xc = ops_lstm2.x_cols(d_in, dtype)
    parts, xch, hch = ops_lstm2.FWD_CLUSTER_KPARTS, xc // kch, hidden // kch

    def rows(chunks, base=0):
        return [base + kch * q + i for q in chunks for i in range(kch)]

    out = []
    for kp in range(parts):
        xs = range(kp * xch // parts, (kp + 1) * xch // parts)
        hs = range(kp * hch // parts, (kp + 1) * hch // parts)
        out.append({"layer1": rows(xs) + rows(hs, xc), "layer2": rows(hs, hidden) + rows(hs),
                    "fc": rows(hs)})
    return out


def _fwd_cluster_columns(rank, cluster, hidden, out_dim):
    """The output columns CTA `rank` computes: the gates of its units [32c,
    32c + 32) (gate-major columns g H + unit) and the fc n-tiles nt = c (mod
    C), the one of index i taken by unit group i's warps, columns past O cut."""
    units = ops_lstm2.FWD_CLUSTER_UNITS
    assert hidden == cluster * units
    gates = [g * hidden + rank * units + u for g in range(4) for u in range(units)]
    tiles = list(range(rank, -(-out_dim // 8), cluster))
    assert len(tiles) <= ops_lstm2.FWD_CLUSTER_FC_TILES
    return gates, [8 * nt + i for nt in tiles for i in range(8) if 8 * nt + i < out_dim]


def _fwd_cluster_walk(x, w, cluster):
    """The float32 cluster form walked as the kernel walks it: per step, each
    CTA's products over its own 16 gate-interleaved n-tiles of the packed w1
    and w2 (`_tf32_fragment_matrix`) as FWD_CLUSTER_KPARTS k-parts in the
    warps' chunk order (`_fwd_cluster_kparts`), each three TF32 products of
    split operands with per-chunk partials (`_three_tf32`), added in k-part
    order onto the bias; the cells (h not rounded); the tile's whole h1 and
    h2 (the exchange); the fc of its n-tiles over h2 in k-parts, then + b_fc.
    -> (y [N, T, O], g1, c1, h1, g2, c2, h2 [T, N, .])."""
    n, d_in, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    units = ops_lstm2.FWD_CLUSTER_UNITS
    p, xc = ops_lstm2.pack_fwd_mma(w), ops_lstm2.x_cols(d_in, torch.float32)
    kparts = _fwd_cluster_kparts(d_in, hidden)

    def gate_major(b):  # a CTA's 128 interleaved columns 8 (4ug + g) + j -> g 32 + 8ug + j
        return b.reshape(*b.shape[:-1], 4, 4, 8).transpose(-3, -2).reshape(*b.shape[:-1], 128)

    ctas = []
    for c in range(cluster):
        tiles = slice(16 * c, 16 * (c + 1))  # unit groups 4c .. 4c + 3: their gate n-tiles
        ctas.append({
            "b1": gate_major(_tf32_fragment_matrix(p.w1[tiles], 128)),
            "b2": gate_major(_tf32_fragment_matrix(p.w2[tiles], 128)),
            "bias1": gate_major(p.b1[128 * c:128 * (c + 1)]),
            "bias2": gate_major(p.b2[128 * c:128 * (c + 1)]),
            "cols": _fwd_cluster_columns(c, cluster, hidden, out_dim)})
    b_fc = _tf32_fragment_matrix(p.fc, out_dim)

    def layer(a, which, c_state):  # every CTA's own units -> (activated gates, c, h)
        act, c_new, h = torch.zeros(n, 4 * hidden), torch.zeros(n, hidden), torch.zeros(n, hidden)
        for c, cta in enumerate(ctas):
            own = slice(units * c, units * (c + 1))
            s = cta[f"bias{which}"].expand(n, -1).clone()
            for k in kparts:
                rows = k[f"layer{which}"]
                s = s + _three_tf32(a[:, rows], cta[f"b{which}"][rows])
            pre = s.reshape(n, 4, units)
            i, f, g, o = (torch.sigmoid(pre[:, 0]), torch.sigmoid(pre[:, 1]),
                          torch.tanh(pre[:, 2]), torch.sigmoid(pre[:, 3]))
            c_new[:, own] = f * c_state[:, own] + i * g
            h[:, own] = o * torch.tanh(c_new[:, own])
            act[:, cta["cols"][0]] = torch.stack([i, f, g, o], 1).reshape(n, -1)
        return act, c_new, h

    h1, c1, h2, c2 = (torch.zeros(n, hidden) for _ in range(4))
    ys, saved = [], []
    for t in range(steps):
        g1, c1, h1 = layer(torch.cat([torch.nn.functional.pad(x[:, :, t], (0, xc - d_in)), h1], 1),
                           1, c1)
        g2, c2, h2 = layer(torch.cat([h1, h2], 1), 2, c2)
        y = torch.zeros(n, out_dim)
        for cta in ctas:
            cols = cta["cols"][1]
            s = torch.zeros(n, len(cols))
            for k in kparts:
                s = s + _three_tf32(h2[:, k["fc"]], b_fc[k["fc"]][:, cols])
            y[:, cols] = s + w.fc_b[cols]
        ys.append(y)
        saved.append([g1, c1, h1, g2, c2, h2])
    return (torch.stack(ys, 1), *(torch.stack(s) for s in zip(*saved)))


@pytest.mark.parametrize("n,t,d,h,o,cluster", [(37, 4, 34, 64, 2, 2), (21, 3, 10, 128, 11, 4)])
def test_fwd_cluster_walk_holds_the_float32_floors(n, t, d, h, o, cluster):
    """The float32 cluster form walked in the kernel's order (each CTA its
    own 32 units' gate n-tiles of the packed weights and its own fc n-tiles,
    k-parts of three TF32 products with per-chunk partials added in order;
    clusters of 2 and 4, D 34 and 10 padded to float32 k-chunks, O 11 over
    two n-tiles) gives the JAX kernel's y (`stacked_lstm2`, interpret mode,
    HIGHEST precision) and `lstm2_train_fwd_reference`'s residuals at 100 dB
    or more, the floor the tile form's walk holds."""
    params, fc, x, _ = _case(n, t, d, h, o)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(lp.stacked_lstm2(jax.tree_util.tree_map(jnp.asarray, params),
                                           jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, fc),
                                           tile_n=64, interpret=True))
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, requires_grad=False))
    y, *res = _fwd_cluster_walk(torch.tensor(x), w, cluster)
    _, res_ref = lt.lstm2_train_fwd_reference(torch.tensor(x), w)
    snrs = {"y": _snr_db(torch.tensor(want), y),
            **{f: _snr_db(e, r) for f, r, e in zip(lt.Residuals._fields, res, res_ref)}}
    assert y.shape == want.shape and all(r.shape == e.shape for r, e in zip(res, res_ref))
    assert min(snrs.values()) >= 100.0, snrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_sweep_cluster_rule(dtype):
    """The forward sweep's form (`fwd_sweep_cluster`, by shape alone): the
    tile form (0) at the shipped batch and training folds (D 34, H 384, O 2),
    FullSubNet's sub-band fold (D 32) and a card's half of the training fold;
    clusters of 16 at FullSubNet's full-band shape (D 257, H 512, O 257) for
    N 7 (the JAX fixture's), 8 (a batch), 18 (training) and up to
    FWD_CLUSTER_MAX_ROWS; the tile form past it, for another H, D > H and an
    O whose fc n-tiles overflow 4 a CTA. FWD_SWEEP_FORM overrides the rule."""
    for n, d, h, o in ((2056, 34, 384, 2), (2304, 34, 384, 2), (2056, 32, 384, 2),
                       (1152, 34, 384, 2), (8, 257, 384, 257)):
        assert ops_lstm2.fwd_sweep_cluster(n, d, h, o, dtype) == 0
    for n in (7, 8, 18, 112, ops_lstm2.FWD_CLUSTER_MAX_ROWS):
        assert ops_lstm2.fwd_sweep_cluster(n, 257, 512, 257, dtype) == ops_lstm2.FWD_CLUSTER == 16
    past = ops_lstm2.FWD_CLUSTER_MAX_ROWS + 1
    assert ops_lstm2.fwd_sweep_cluster(past, 257, 512, 257, dtype) == 0
    assert ops_lstm2.fwd_sweep_cluster(8, 257, 256, 257, dtype) == 0
    assert ops_lstm2.fwd_sweep_cluster(8, 513, 512, 257, dtype) == 0
    assert ops_lstm2.fwd_sweep_cluster(8, 257, 512, 512, dtype) == 16
    assert ops_lstm2.fwd_sweep_cluster(8, 257, 512, 513, dtype) == 0
    assert ops_lstm2.fwd_sweep_cluster(8, 257, 512, 257, torch.float64) == 0
    x = torch.zeros(8, 257, 1, dtype=dtype)
    w = ops_lstm2.pack_weights(*_torch_tensors(*_case(2, 1, 257, 512, 257)[:2], dtype,
                                               requires_grad=False))
    assert ops_lstm2.fwd_sweep_form(x, w) == 16
    for forced in (0, 16):
        ops_lstm2.FWD_SWEEP_FORM = forced
        try:
            assert ops_lstm2.fwd_sweep_form(x, w) == forced
        finally:
            ops_lstm2.FWD_SWEEP_FORM = None


class _FakeForwardLibrary:
    """Stands in for the built K1 and K2 libraries: records each call's row
    tile and form (the C entry points' arguments after n, steps, D, H, O)
    and, for a form in waves (the wave form, the pair form in waves), its
    steps a part and the carry's bytes; refuses the cluster form off H 512,
    as `fwd::cluster_runs` does, the pair forms off bf16, off 32 rows or
    past a block, as `fwd::pair_runs` does, a form in waves without its
    carry and part steps, and a tile or wave form whose shared memory
    overflows a block, as `fwd::launch_form` does."""

    def __init__(self):
        self.calls = []

    def _record(self, name, args, first_int):
        carry = args[first_int - 1]
        n, steps, d, h, o, rows, form, part_steps, dtype = args[first_int:first_int + 9]
        self.calls.append((name, rows, form))
        if form in (1, 3):
            self.calls[-1] += (part_steps, carry)
            if not carry or part_steps < 1:
                return 1
        if form in (2, 3):
            fits = ops_lstm2.fwd_pair_shared_memory_bytes(d, h) <= ops_lstm2.SMEM_LIMIT
            return 0 if dtype == 1 and rows == 32 and fits else 1
        if form == 16:
            return 1 if h != 512 else 0
        size = 4 if dtype == 0 else 2
        smem = ops_lstm2.fwd_mma_shared_memory_bytes(
            rows, d, h, {4: torch.float32, 2: torch.bfloat16}[size])
        return 1 if form not in (0, 1) or smem > ops_lstm2.SMEM_LIMIT else 0

    def lstm2_fwd(self, *args):
        return self._record("lstm2_fwd", args, 9)

    def lstm2_train_fwd(self, *args):
        return self._record("lstm2_train_fwd", args, 15)


@pytest.fixture
def fake_forward(monkeypatch):
    """K1's and K2's launch paths on CPU tensors, down to the C call, which
    `_FakeForwardLibrary` takes: no card, no nvcc."""
    import collections
    import contextlib
    import types

    from fullsubnet_plus_torch.ops import nvcc

    lib = _FakeForwardLibrary()
    monkeypatch.setattr(nvcc, "load", lambda *_: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *_: types.SimpleNamespace(multi_processor_count=132))
    for module, name in ((ops_lstm2, "LAUNCHES"), (ops_lstm2, "FWD_SWEEP_FORMS"),
                         (lt, "LAUNCHES_BY_CARD")):
        monkeypatch.setattr(module, name, collections.Counter())
    monkeypatch.setattr(lt, "LAUNCHES", dict.fromkeys(lt.LAUNCHES, 0))
    return lib


@pytest.mark.parametrize("n,d,h,o,dtype,want", [
    (7, 257, 512, 257, torch.float32, (16, 16)), (18, 257, 512, 257, torch.bfloat16, (16, 16)),
    (2304, 34, 384, 2, torch.bfloat16, (32, 3)), (2056, 34, 384, 2, torch.bfloat16, (32, 2)),
    (2056, 32, 384, 2, torch.bfloat16, (32, 2)), (2056, 34, 384, 2, torch.float32, (16, 0)),
    (2304, 32, 384, 2, torch.float32, (16, 1))])
def test_fwd_k1_and_k2_take_the_same_form(fake_forward, monkeypatch, n, d, h, o, dtype, want):
    """K1's `_launch` and K2's `_launch_train_fwd` pass the same (row tile,
    form) to their C entry points, the rule's (clusters of 16, rows 16, at
    FullSubNet's full-band folds; in bf16 at the sub-band folds the pair
    form, rows 32, in one launch where the card holds the fold's pairs (N
    2056 at D 34 and 32: 65 pairs) and in waves past them (N 2304: 72); in
    float32 the wave form, rows 16, past one wave of row tiles; else the
    tile form with `fwd_mma_row_tile`'s R; a form in waves with
    FWD_WAVE_STEPS steps a part and a carry of a tile's h and c), count
    each launch by form, and take a forced form; a form the kernel refuses
    raises, naming it, with no fallback."""
    params, fc = _case(2, 1, d, h, o)[:2]
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, dtype, requires_grad=False))
    x = torch.zeros(n, d, 2, dtype=dtype)
    ops_lstm2._launch(x, w)
    lt._launch_train_fwd(x, w)
    assert [c[:3] for c in fake_forward.calls] == [("lstm2_fwd", *want), ("lstm2_train_fwd", *want)]
    if want[1] in (ops_lstm2.FWD_SWEEP_WAVE, ops_lstm2.FWD_PAIR_WAVE):
        assert all(c[3] == ops_lstm2.FWD_WAVE_STEPS and c[4] for c in fake_forward.calls)
    tag = ops_lstm2.fwd_form_name(want[1])
    assert ops_lstm2.FWD_SWEEP_FORMS == {f"lstm2_fwd {tag}": 1, f"lstm2_train_fwd {tag}": 1}
    forced = 0 if want[1] == 16 else 16
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", forced)
    refused = [] if h == 512 else [pytest.raises(RuntimeError, match="cluster form, clusters of 16")]
    for launch in (ops_lstm2._launch, lt._launch_train_fwd):
        if refused:
            with refused[0]:
                launch(x, w)
        else:
            launch(x, w)
    assert [c[2] for c in fake_forward.calls[2:]] == [forced] * 2


def test_fwd_wave_launch_refused_raises_without_fallback(fake_forward, monkeypatch):
    """The wave form forced where its tile does not fit a block (float32 at
    D 512, H 512: two operand buffers [16][512 + 1024 + 4] and c1, c2 are
    262,656 bytes): K1's launch is refused and raises, naming the wave
    form; K2's check raises before its launch; nothing is counted and no
    other form or the plain version runs in its place."""
    params, fc = _case(2, 1, 512, 512, 2)[:2]
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, torch.float32, requires_grad=False))
    x = torch.zeros(40, 512, 2)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", ops_lstm2.FWD_SWEEP_WAVE)
    assert ops_lstm2.fwd_mma_shared_memory_bytes(16, 512, 512, torch.float32) == 262_656
    with pytest.raises(RuntimeError, match="lstm2_fwd launch failed \\(the wave form\\)"):
        ops_lstm2._launch(x, w)
    with pytest.raises(ValueError, match="more shared memory than a block has"):
        lt._launch_train_fwd(x, w)
    assert [c[:3] for c in fake_forward.calls] == [("lstm2_fwd", 16, 1)]
    assert not ops_lstm2.FWD_SWEEP_FORMS and not sum(ops_lstm2.LAUNCHES.values())
    assert lt.LAUNCHES["lstm2_train_fwd"] == 0


@pytest.mark.parametrize("d", [257, 34])
@pytest.mark.parametrize("cluster", [2, 4, 16])
def test_fwd_cluster_columns_have_one_owner(cluster, d):
    """Over H = 32 C split into C CTAs of 32 units, every gate column (4H)
    and every fc n-tile (at C 16 O 257: 33 n-tiles, at most 3 a CTA, and 4
    at O 512; at C 2 and 4 a ragged O of 4C - 1 n-tiles) has exactly one
    owning CTA; each product's k-parts cover its K (layer 1 x_cols(D) + H,
    layer 2 2H, the fc H) once, in both dtypes' k-chunks (16 float32 words,
    32 bf16 ones), and at C 16 each k-part's h chunks span 4 owners' blocks."""
    hidden = ops_lstm2.FWD_CLUSTER_UNITS * cluster
    out_dim = 257 if cluster == 16 else 32 * cluster - 3
    gates, fc_cols = np.zeros(4 * hidden, int), np.zeros(out_dim, int)
    for c in range(cluster):
        own_gates, own_fc = _fwd_cluster_columns(c, cluster, hidden, out_dim)
        np.add.at(gates, own_gates, 1)
        np.add.at(fc_cols, own_fc, 1)
    assert (gates == 1).all() and (fc_cols == 1).all()
    assert len(_fwd_cluster_columns(0, 16, 512, 512)[1]) == 4 * 8
    for kch, dtype in ((16, torch.float32), (32, torch.bfloat16)):
        kparts = _fwd_cluster_kparts(d, hidden, kch)
        xc = ops_lstm2.x_cols(d, dtype)
        for which, k in (("layer1", xc + hidden), ("layer2", 2 * hidden), ("fc", hidden)):
            assert sorted(sum((p[which] for p in kparts), [])) == list(range(k))
        if cluster == 16:
            for p in kparts:
                assert len({row // ops_lstm2.FWD_CLUSTER_UNITS for row in p["fc"]}) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_cluster_shared_memory(dtype):
    """The cluster form's shared memory at FullSubNet's full-band shape (D
    257, H 512, O 257), clusters of 16: 64 mbarriers (512 bytes), h1 and h2
    for both step parities as 16 owners' blocks [16][32 + pad] (147,456 bytes
    in float32, 81,920 in bf16), the x tile [16][x_cols + pad] (17,664 /
    9,472), the k-part partials [4][4][16][40] (40,960) and the fc's
    [4][4][16][8] (8,192): 214,784 / 141,056 bytes, under the 232,448 a block
    may use; the .cuh's constants are the ones reckoned with."""
    size = 4 if dtype == torch.float32 else 2
    got = ops_lstm2.fwd_cluster_shared_memory_bytes(257, 512, dtype)
    xc = ops_lstm2.x_cols(257, dtype)
    assert got == (512 + size * (4 * 16 * 16 * (32 + 16 // size) + 16 * (xc + 16 // size))
                   + 4 * (4 * 4 * 16 * 40 + 4 * 4 * 16 * 8))
    assert got == {4: 214_784, 2: 141_056}[size] <= ops_lstm2.SMEM_LIMIT
    assert ops_lstm2.fwd_cluster_shared_memory_bytes(34, 512, dtype) < got
    source = (Path(ops_lstm2.__file__).parent.parent / "csrc" / "lstm2_fwd_sweep.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+(?: \+ \d+)?);", source))
    assert consts["CLUSTER_SIZE"] == str(ops_lstm2.FWD_CLUSTER)
    assert consts["CL_UNITS"] == str(ops_lstm2.FWD_CLUSTER_UNITS)
    assert consts["CL_KPARTS"] == str(ops_lstm2.FWD_CLUSTER_KPARTS)
    assert consts["CL_FC_TILES"] == str(ops_lstm2.FWD_CLUSTER_FC_TILES)
    assert consts["CL_PART_LD"] == "CL_UNITS + 8" and consts["CL_FC_LD"] == "8"
    assert consts["CL_PAD_BYTES"] == str(ops_lstm2.FWD_MMA_PAD_BYTES)


# ---------------------------------------------------------------------------
# the forward sweep's bf16 pair form (csrc/lstm2_fwd_sweep.cuh, sweep_pair_kernel)
# ---------------------------------------------------------------------------

def _fwd_pair_owners(hidden, ctas):
    """{(CTA rank, warp, pass): unit group of 8} of the bf16 forward sweep
    over a 32-row tile split over `ctas` CTAs: one, the R 32 tile form
    (`sweep_mma_kernel`: warp w of the H / 32 owns unit groups 4w .. 4w + 3
    in MMA_PASSES passes); two, the pair form (`sweep_pair_kernel`: rank c's
    warp w owns (H / 16) c + 2w and + 1 in FWD_PAIR_PASSES passes)."""
    passes = 4 // ctas
    per_cta = hidden // 8 // ctas
    return {(c, warp, p): per_cta * c + passes * warp + p
            for c in range(ctas) for warp in range(hidden // 32) for p in range(passes)}


def _chain(acc, a, b):
    """A gate or fc sum as a tensor-core accumulator runs it: onto acc (the
    bias, or zero for the fc), the products of each k-step of 16 in k order,
    each k-step's 16 bf16 products summed exactly (in float64: they and their
    sums are exact at these magnitudes) and added in float32. Each column's
    sum reads its own operands alone, as an accumulator's does."""
    for k in range(0, a.shape[1], 16):
        acc = acc + (a[:, k:k + 16].double() @ b[k:k + 16].double()).float()
    return acc


def _fwd_pair_walk(x, w, ctas, part_steps=None, wave=None):
    """The bf16 forward sweep over 32-row tiles as the R 32 tile form (ctas
    1) or the pair form (ctas 2) runs it: each CTA keeps its own operand
    rows [x | h1 | h2] (x padded to x_cols) and the c words of its own
    units; per step and layer each (CTA, warp, pass) of `_fwd_pair_owners`
    runs its unit group's four gate n-tiles of the packed fragments
    (`_fragment_matrix`) as `_chain`s from the interleaved bias, its cell,
    its residuals (rows that exist), and writes its h (bf16) into every
    CTA's operand rows, the exchange; the fc's n-tile nt on rank nt mod
    ctas. With part_steps, the wave form's items (tile, part), part-major, in
    launches of `wave` items; an item stores its tile's carries (each rank
    its own half of every h row and its own c words) and the next part
    loads whole h rows. -> (y [N, T, O], residuals {name: [T, N, .]}, the
    writes of each y word and each residual word)."""
    n, d, steps = x.shape
    hidden, out_dim = w.u1.shape[0], w.fc_w.shape[1]
    p, xc = ops_lstm2.pack_fwd_mma(w), ops_lstm2.x_cols(d)
    b = (_fragment_matrix(p.w1, 4 * hidden), _fragment_matrix(p.w2, 4 * hidden))
    bias, bfc = (p.b1, p.b2), _fragment_matrix(p.fc, out_dim)
    rows, owners, span = ops_lstm2.FWD_PAIR_ROWS, _fwd_pair_owners(hidden, ctas), hidden // ctas
    tiles = -(-n // rows)
    part_steps = part_steps or steps
    items, wave = tiles * -(-steps // part_steps), wave or tiles
    y = torch.full((n, steps, out_dim), float("nan"))
    res = {f: torch.full((steps, n, 4 * hidden if f[0] == "g" else hidden), float("nan"))
           for f in lt.Residuals._fields}
    writes = {"y": torch.zeros(n, steps, out_dim, dtype=torch.int64),
              **{f: torch.zeros(v.shape, dtype=torch.int64) for f, v in res.items()}}
    carry = {}

    def save(name, t, r0, live, cols, v):
        res[name][t, r0:r0 + live, cols] = v[:live].to(torch.bfloat16).float()
        writes[name][t, r0:r0 + live, cols] += 1

    for item0 in range(0, items, wave):
        stored = {}
        for item in range(item0, min(items, item0 + wave)):
            part, tile = divmod(item, tiles)
            t_lo, t_hi = part * part_steps, min(steps, (part + 1) * part_steps) - 1
            r0 = tile * rows
            live = min(rows, n - r0)
            ops = [torch.zeros(rows, xc + 2 * hidden) for _ in range(ctas)]
            cs = [torch.zeros(2, rows, hidden) for _ in range(ctas)]
            if t_lo:  # whole h rows, this rank's c words
                h_rows, c_words = carry[tile]
                for c in range(ctas):
                    ops[c][:, xc:] = h_rows
                    cs[c] = c_words[c].clone()
            for t in range(t_lo, t_hi + 1):
                for c in range(ctas):
                    ops[c][:live, :d] = x[r0:r0 + live, :, t].float()
                for layer in range(2):
                    a_cols = slice(0, xc + hidden) if layer == 0 else slice(xc, xc + 2 * hidden)
                    col0 = xc + layer * hidden
                    new_h = []
                    for (c, _, _), ug in owners.items():
                        gcols, units = slice(32 * ug, 32 * ug + 32), slice(8 * ug, 8 * ug + 8)
                        acc = _chain(bias[layer][gcols].expand(rows, -1), ops[c][:, a_cols],
                                     b[layer][:, gcols])
                        pre = acc.reshape(rows, 4, 8)
                        i, f, g, o = (torch.sigmoid(pre[:, 0]), torch.sigmoid(pre[:, 1]),
                                      torch.tanh(pre[:, 2]), torch.sigmoid(pre[:, 3]))
                        cn = f * cs[c][layer][:, units] + i * g
                        cs[c][layer][:, units] = cn
                        h = (o * torch.tanh(cn)).to(torch.bfloat16).float()
                        new_h.append((units, h))
                        for gate, act in enumerate((i, f, g, o)):
                            save(f"g{layer + 1}", t, r0, live,
                                 slice(gate * hidden + 8 * ug, gate * hidden + 8 * ug + 8), act)
                        save(f"c{layer + 1}", t, r0, live, units, cn)
                        save(f"h{layer + 1}", t, r0, live, units, h)
                    for units, h in new_h:  # the exchange: into every CTA's rows
                        for dst in range(ctas):
                            ops[dst][:, col0 + units.start:col0 + units.stop] = h
                    assert all(torch.equal(ops[0][:, col0:col0 + hidden], o[:, col0:col0 + hidden])
                               for o in ops[1:])
                for nt in range(-(-out_dim // 8)):
                    cols = slice(8 * nt, min(out_dim, 8 * nt + 8))
                    acc = _chain(torch.zeros(rows, cols.stop - cols.start),
                                 ops[nt % ctas][:, xc + hidden:], bfc[:, cols])
                    y[r0:r0 + live, t, cols] = (acc + w.fc_b[cols])[:live].to(torch.bfloat16).float()
                    writes["y"][r0:r0 + live, t, cols] += 1
            if t_hi + 1 < steps:  # each rank its own half of every h row, and its c words
                h_rows = torch.full((rows, 2 * hidden), float("nan"))
                for c in range(ctas):
                    for layer in range(2):
                        own = slice(layer * hidden + c * span, layer * hidden + (c + 1) * span)
                        h_rows[:, own] = ops[c][:, xc + own.start:xc + own.stop]
                stored[tile] = (h_rows, [cw.clone() for cw in cs])
        carry.update(stored)  # read only by a later launch
    return y, res, writes


@pytest.mark.parametrize("hidden,d,out_dim", [(384, 34, 2), (384, 32, 2), (512, 34, 11),
                                              (64, 10, 11)])
def test_fwd_pair_columns_have_one_owner(hidden, d, out_dim):
    """In the pair form every gate column (4H, gate-interleaved n-tiles) and
    every h column of both layers has exactly one owner (CTA rank, warp,
    pass), rank c's units are the contiguous half [c H / 2, (c + 1) H / 2)
    of each h row, the owners run the R 32 tile form's unit groups each
    once, each h half reaches both CTAs (its owner writes it into its own
    rows and its peer's), the carries' h words are split between the ranks
    along the same halves (a 16-byte word never spans two owners), and
    each fc n-tile (O 2: one, on rank 0; O 11: two, one a rank) has one
    owner; the operand rows every CTA keeps are layer 1's K (x_cols(D) +
    H) and layer 2's (2 H) whole."""
    owners = _fwd_pair_owners(hidden, 2)
    assert len(owners) == hidden // 8 and len(set(owners.values())) == hidden // 8
    assert sorted(owners.values()) == sorted(_fwd_pair_owners(hidden, 1).values())
    gates, units = np.zeros(4 * hidden, int), np.zeros(hidden, int)
    received, by_rank = np.zeros((2, hidden), int), {0: set(), 1: set()}
    for (rank, warp, p), ug in owners.items():
        assert 0 <= warp < hidden // 32 and 0 <= p < ops_lstm2.FWD_PAIR_PASSES
        gates[32 * ug:32 * ug + 32] += 1
        units[8 * ug:8 * ug + 8] += 1
        by_rank[rank].update(range(8 * ug, 8 * ug + 8))
        for dst in (rank, rank ^ 1):
            received[dst, 8 * ug:8 * ug + 8] += 1
    assert (gates == 1).all() and (units == 1).all() and (received == 1).all()
    half = hidden // ops_lstm2.FWD_PAIR_CTAS
    assert [sorted(by_rank[c]) for c in (0, 1)] == [list(range(half)), list(range(half, hidden))]
    words = hidden * 2 // 16  # 16-byte words of a bf16 h row
    assert words % 2 == 0 and all(
        {(8 * k + u) // half for u in range(8)} == {k // (words // 2)} for k in range(words))
    fc_owners = [(nt % 2, nt // 2 % (hidden // 32)) for nt in range(-(-out_dim // 8))]
    assert len(set(fc_owners)) == len(fc_owners) and fc_owners[0] == (0, 0)
    assert {r for r, _ in fc_owners} == ({0} if out_dim <= 8 else {0, 1})
    xc = ops_lstm2.x_cols(d)
    assert (xc + hidden) % 32 == 0 and 2 * hidden % 32 == 0  # whole k-chunks of bf16


def test_fwd_pair_shared_memory():
    """The pair form's shared memory (`fwd_pair_shared_memory_bytes`, the
    .cuh's pair_shared_bytes): two operand buffers [32][x_cols + 2H + 8]
    bf16 and c1, c2 of a CTA's H / 2 units, float32: 156,672 bytes at D 34,
    152,576 at FullSubNet's sub-band D 32 (the R 32 tile form: 205,824 at D
    34), within a block wherever the rule gives it (every bf16 fold of the
    sub-band shapes; at H 512, D 34: 205,824); past a block at D 257, H 512
    (234,496), where the rule does not give it; never in float32. The
    .cuh's constants are the ones reckoned with."""
    assert ops_lstm2.fwd_pair_shared_memory_bytes(34, 384) == 2 * 2 * 32 * 840 + 2 * 4 * 32 * 192
    assert ops_lstm2.fwd_pair_shared_memory_bytes(34, 384) == 156_672
    assert ops_lstm2.fwd_pair_shared_memory_bytes(32, 384) == 152_576
    assert ops_lstm2.fwd_mma_shared_memory_bytes(32, 34, 384) == 205_824
    assert ops_lstm2.fwd_pair_shared_memory_bytes(34, 512) == 205_824 <= ops_lstm2.SMEM_LIMIT
    assert ops_lstm2.fwd_pair_shared_memory_bytes(257, 512) == 234_496 > ops_lstm2.SMEM_LIMIT
    for n, d in ((2056, 34), (2304, 34), (2056, 32), (2304, 32), (1152, 34), (771, 34), (7, 34)):
        form, rows = ops_lstm2.fwd_sweep_plan(n, d, 384, 2, torch.bfloat16)
        assert form in (ops_lstm2.FWD_PAIR, ops_lstm2.FWD_PAIR_WAVE) and rows == 32
        assert ops_lstm2.fwd_pair_shared_memory_bytes(d, 384) <= ops_lstm2.SMEM_LIMIT
    assert ops_lstm2.fwd_sweep_pair(8, 257, 512, torch.bfloat16) == 0
    assert ops_lstm2.fwd_sweep_pair(2056, 34, 384, torch.float32) == 0
    assert ops_lstm2.fwd_sweep_pair(2056, 34, 384, torch.bfloat16) == ops_lstm2.FWD_PAIR
    assert ops_lstm2.fwd_sweep_pair(2304, 34, 384, torch.bfloat16) == ops_lstm2.FWD_PAIR_WAVE
    source = (Path(ops_lstm2.__file__).parent.parent / "csrc" / "lstm2_fwd_sweep.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+);", source))
    assert consts["PAIR_CTAS"] == str(ops_lstm2.FWD_PAIR_CTAS)
    assert int(consts["PAIR_MT"]) * 16 == ops_lstm2.FWD_PAIR_ROWS
    assert consts["PAIR_PASSES"] == str(ops_lstm2.FWD_PAIR_PASSES)
    assert (consts["WAVE_FORM"], consts["PAIR_FORM"], consts["PAIR_WAVE_FORM"]) == tuple(
        str(f) for f in (ops_lstm2.FWD_SWEEP_WAVE, ops_lstm2.FWD_PAIR, ops_lstm2.FWD_PAIR_WAVE))


@pytest.mark.parametrize("part_steps,wave", [(None, None), (2, 2), (1, 2)],
                         ids=["one launch", "waves of 2-step items", "waves of 1-step items"])
def test_fwd_pair_walk_equals_the_r32_tile_walk(part_steps, wave):
    """The pair form walked as the kernel walks it (two CTAs, each its own
    half of the units' gate n-tiles and c words and its own copy of the
    operand rows, h exchanged after each layer, the fc's two n-tiles one a
    rank; H 64: two warps a CTA; D 10 padded to 32 columns; N 70: three
    tiles, the last ragged), in one launch and in the wave form's schedule
    (items of 2 and 1 steps in launches of 2 clusters, the last part of 2
    ragged, each resuming from carries whose h halves its tile's two ranks
    stored), gives the R 32 tile form's walk (one CTA owning every unit
    group) bit for bit, every y and residual word written once, and holds
    40 dB against `lstm2_fc_reference` and `lstm2_train_fwd_reference`."""
    n, t = 70, 5
    x, w = _fwd_case(n, t, 10, 64, 11)
    y_tile, res_tile, _ = _fwd_pair_walk(x, w, 1)
    y, res, writes = _fwd_pair_walk(x, w, 2, part_steps, wave)
    assert all((v == 1).all() for v in writes.values())
    assert torch.equal(y, y_tile) and all(torch.equal(res[k], res_tile[k]) for k in res)
    y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
    assert torch.equal(y_ref, ops_lstm2.lstm2_fc_reference(x, w))
    snrs = {"y": _snr_db(y_ref.float(), y),
            **{f: _snr_db(e.float(), res[f]) for f, e in zip(lt.Residuals._fields, res_ref)}}
    assert min(snrs.values()) >= 40.0, snrs


# ---------------------------------------------------------------------------
# the bf16 weight-gradient kernel's layout (csrc/lstm2_bwd_wgrad.cu, wgrad_mma_kernel)
# ---------------------------------------------------------------------------

WG_BK, WG_PAD = 64, 8  # contraction rows a staged slice, bf16 pad of a staged row


def _ldmatrix_x4_trans(smem: np.ndarray, addr: np.ndarray) -> np.ndarray:
    """ldmatrix.m8n8.x4.trans over a warp: lane l gives the element index of
    row l % 8 of matrix l / 8 (8 contiguous elements); lane t gets, from each
    matrix M, {M[2 (t % 4)][t / 4], M[2 (t % 4) + 1][t / 4]}. -> [lane, reg, 2]."""
    m = smem[addr[:, None] + np.arange(8)].reshape(4, 8, 8)  # [matrix, row, column]
    t = np.arange(32)
    return np.stack([m[:, 2 * (t % 4), t // 4], m[:, 2 * (t % 4) + 1, t // 4]], -1).transpose(1, 0, 2)


def _mma_m16n8k16(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """acc [lane, 4] += A B from the lanes' fragments (PTX ISA, m16n8k16 bf16):
    a [lane, 4 regs, 2] holds A[g + 8 (r % 2)][2q + 8 (r / 2) + e], b [lane, 2
    regs, 2] holds B[2q + 8 r + e][g], acc[e'] is D[g + 8 (e' / 2)][2q + e' % 2],
    for lane 4g + q."""
    t = np.arange(32)
    g, q = t // 4, t % 4
    am, bm = np.zeros((16, 16)), np.zeros((16, 8))
    for r in range(4):
        for e in range(2):
            am[g + 8 * (r % 2), 2 * q + 8 * (r // 2) + e] = a[:, r, e]
    for r in range(2):
        for e in range(2):
            bm[2 * q + 8 * r + e, g] = b[:, r, e]
    d = am @ bm
    for e in range(4):
        acc[:, e] += d[g + 8 * (e // 2), 2 * q + e % 2]


def _wgrad_tile_walk(a_steps, g_steps, lda, k_live, bm, bn, wm, wn):
    """One CTA tile (rows 0 .. bm, gate columns 0 .. bn) of the kernel's
    contraction, walked as `wgrad_mma_tile` walks it: for each step (newest
    first; None: h_{-1}) and slice of WG_BK rows, the staged ring slot filled
    as its cp.async copies fill it (zero past N, past the row's lda columns,
    and for h_{-1}), then each warp's ldmatrix.trans fragments and mma
    products; the accumulators written back where row < k_live."""
    n_rows = g_steps[0].shape[0]
    lda_s, ldg_s = bm + WG_PAD, bn + WG_PAD
    mi, ni = bm // wm // 16, bn // wn // 8
    acc = np.zeros((wm * wn, mi, ni, 32, 4))
    for a_t, g_t in zip(a_steps, g_steps):
        for nb in range(0, n_rows, WG_BK):
            smem = np.zeros(WG_BK * (lda_s + ldg_s))
            for r in range(min(WG_BK, n_rows - nb)):
                if a_t is not None:
                    cols = min(bm, lda)
                    smem[r * lda_s: r * lda_s + cols] = a_t[nb + r, :cols]
                smem[WG_BK * lda_s + r * ldg_s: WG_BK * lda_s + r * ldg_s + bn] = g_t[nb + r, :bn]
            lane = np.arange(32)
            for warp in range(wm * wn):
                m0, n0 = (warp // wn) * mi * 16, (warp % wn) * ni * 8
                a_row, a_col = (lane & 7) + 8 * (lane >> 4), m0 + 8 * ((lane >> 3) & 1)
                g_row, g_col = (lane & 7) + 8 * ((lane >> 3) & 1), n0 + 8 * (lane >> 4)
                for ks in range(WG_BK // 16):
                    af = [_ldmatrix_x4_trans(smem, (16 * ks + a_row) * lda_s + a_col + 16 * i)
                          for i in range(mi)]
                    bf = []
                    for j in range(ni // 2):
                        r = _ldmatrix_x4_trans(smem, WG_BK * lda_s + (16 * ks + g_row) * ldg_s
                                               + g_col + 16 * j)
                        bf += [r[:, 0:2], r[:, 2:4]]
                    for i in range(mi):
                        for j in range(ni):
                            _mma_m16n8k16(acc[warp, i, j], af[i], bf[j])
    out = np.full((bm, bn), np.nan)
    fr, fc = np.arange(32) >> 2, 2 * (np.arange(32) & 3)
    for warp in range(wm * wn):
        m0, n0 = (warp // wn) * mi * 16, (warp % wn) * ni * 8
        for i in range(mi):
            for j in range(ni):
                for e in range(4):
                    rows = m0 + 16 * i + fr + 8 * (e >> 1)
                    keep = rows < k_live
                    out[rows[keep], (n0 + 8 * j + fc + (e & 1))[keep]] = acc[warp, i, j][keep, e]
    return out[:k_live]


@pytest.mark.parametrize("bm,bn,wm,wn,k_live,lda", [
    (48, 64, 3, 2, 34, 40),     # dW1's tile: D = 34, x rows padded to 40
    (64, 128, 2, 4, 64, 64),    # the rule's H tile
    (128, 128, 2, 4, 96, 96),   # a candidate H tile with rows past H
])
def test_wgrad_fragment_walk_matches_the_products(bm, bn, wm, wn, k_live, lda):
    """The transposed-ldmatrix and mma fragment walk of one weight-gradient
    tile gives A^T G over two steps with N = 100 (a ragged second slice of
    64 rows), the older step's A being h_{-1} = 0, and columns past the A
    row's end zero-filled: the same bf16 operands, float64 sums here in
    another order (within 1e-6)."""
    rng = np.random.default_rng(11)
    n_rows = 100

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float().numpy()

    a1 = bf16(n_rows, lda)
    a1[:, k_live:] = 0.0  # x's pad columns are zero (the wrapper's padding)
    g1, g0 = bf16(n_rows, bn), bf16(n_rows, bn)
    got = _wgrad_tile_walk([a1, None], [g1, g0], lda, k_live, bm, bn, wm, wn)
    want = a1[:, :k_live].astype(np.float64).T @ g1.astype(np.float64)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _wgrad_blocks(d_in, hidden, h_tile, w1_tile):
    """The CTAs of one weight-gradient launch as `wgrad_mma_kernel` maps
    blockIdx.x: the tiles of dU1, dW2, dU2, each gradient row tile by row
    tile, then dW1's; as (gradient, first row, first gate column, rows,
    columns)."""
    blocks = []
    for name, k, (rows, cols) in (("du1", hidden, h_tile), ("dw2", hidden, h_tile),
                                  ("du2", hidden, h_tile), ("dw1", d_in, w1_tile)):
        blocks += [(name, r, c, rows, cols) for r in range(0, k, rows)
                   for c in range(0, 4 * hidden, cols)]
    return blocks


@pytest.mark.parametrize("d,hidden", [(34, 384), (34, 64), (257, 512)])
def test_wgrad_tiles_cover_each_gradient_once(d, hidden):
    """The CTAs of an mma.sync weight-gradient launch (each mma.sync
    candidate, forced: bf16 `WGRAD_H_TILES`, float32 `WGRAD_F32_TILES`; the
    rule takes the wgmma kernels, whose schedule
    `test_wgmma_schedule_owns_each_element_once_a_run` walks) cover every
    element of dW1 [D, 4H] and dU1, dW2, dU2 [H, 4H] exactly once; dW1's
    tile has 48 rows (three m16 tiles), and at the training shape the grid
    of the tiles the rule took there before the wgmma kernels fills a wave
    of the H100's 132 SMs."""
    w1_tile = lt.WGRAD_W1_TILE
    assert w1_tile == (48, 64) and lt.WGRAD_H_TILES[0] == (64, 128)
    for shape in (tile[:2] for tile in (*lt.WGRAD_H_TILES, *lt.WGRAD_F32_TILES)
                  if not lt.wgmma_tile(tile)):
        blocks = _wgrad_blocks(d, hidden, shape, w1_tile)
        for name in ("dw1", "du1", "dw2", "du2"):
            rows = d if name == "dw1" else hidden
            count = np.zeros((rows, 4 * hidden), np.int64)
            for grad, r0, c0, r, c in blocks:
                if grad == name:
                    assert r0 < rows and c0 < 4 * hidden  # no tile wholly outside
                    count[r0:r0 + r, c0:c0 + c] += 1
            assert (count == 1).all(), (shape, name)
    if (d, hidden) == (34, 384):
        for tile in (lt.WGRAD_H_TILES[0], lt.WGRAD_F32_TILES[4][:2]):
            assert len(_wgrad_blocks(d, hidden, tile, w1_tile)) >= 132


# ---------------------------------------------------------------------------
# the float32 weight-gradient kernel's layout (csrc/lstm2_bwd_wgrad.cu, wgrad_tf32_kernel)
# ---------------------------------------------------------------------------

def _f32_pitch(cols: int) -> int:
    """`f32_pitch`: a staged float32 row padded to 8 (mod 32) words."""
    return cols + (40 - cols % 32) % 32


def _tf32_fragment_words(pitch: int, ks: int, col0: int) -> dict:
    """The staged-word index each lane (g, t) = (lane / 4, lane % 4) loads for
    one m16n8k8 TF32 fragment at k-step ks, the fragment's first column col0:
    A (m-tile at col0) a0 = [8 ks + t][col0 + g], a1 = [.][col0 + g + 8], a2 =
    [8 ks + t + 4][col0 + g], a3 = [.][col0 + g + 8]; B (n-tile at col0) b0 =
    [8 ks + t][col0 + g], b1 = [8 ks + t + 4][col0 + g]."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    row0, row4 = (8 * ks + t) * pitch, (8 * ks + t + 4) * pitch
    return {"a0": row0 + col0 + g, "a1": row0 + col0 + g + 8, "a2": row4 + col0 + g,
            "a3": row4 + col0 + g + 8, "b0": row0 + col0 + g, "b1": row4 + col0 + g}


def _tf32_tile_walk(a_steps, g_steps, lda, k_live, bm, bn, bk, wm, wn, three=True):
    """One CTA tile (rows 0 .. bm, gate columns 0 .. bn) of the float32
    contraction, walked as `wgrad_tf32_tile` walks it: for each step (newest
    first; None: h_{-1}) and slice of bk rows, the ring slot filled as its
    16-byte cp.async copies fill it (4 words a copy; zero past N, from the
    copy that starts at or past the row's lda columns, and for h_{-1}), rows
    at the f32_pitch; each warp's 32-bit fragment loads, each word split
    once (`_split_tf32`), the three TF32 products of each m16 x n8 tile
    (small.big, big.small, big.big; with three=False big.big alone) added
    into a zeroed float32 partial a slice, which one float32 add puts into
    the sums; the sums written back where row < k_live."""
    n_rows = g_steps[0].shape[0]
    lda_s, ldg_s = _f32_pitch(bm), _f32_pitch(bn)
    mi, ni = bm // wm // 16, bn // wn // 8
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    acc = np.zeros((wm * wn, mi, ni, 16, 8), np.float32)
    for a_t, g_t in zip(a_steps, g_steps):
        for nb in range(0, n_rows, bk):
            rows = min(bk, n_rows - nb)
            a_s, g_s = np.zeros(bk * lda_s, np.float32), np.zeros(bk * ldg_s, np.float32)
            for kk in range(0, bm, 4):  # A's copies: 4 words each, zero from lda on
                if a_t is not None and kk < lda:
                    for r in range(rows):
                        a_s[r * lda_s + kk: r * lda_s + kk + 4] = a_t[nb + r, kk:kk + 4]
            for r in range(rows):
                g_s[r * ldg_s: r * ldg_s + bn] = g_t[nb + r, :bn]
            a_big, a_small = (v.numpy() for v in _split_tf32(torch.from_numpy(a_s)))
            g_big, g_small = (v.numpy() for v in _split_tf32(torch.from_numpy(g_s)))
            for warp in range(wm * wn):
                m0, n0 = (warp // wn) * mi * 16, (warp % wn) * ni * 8
                part = np.zeros((mi, ni, 16, 8), np.float32)
                for ks in range(bk // 8):
                    am = {h: np.zeros((mi, 16, 8), np.float32) for h in ("big", "small")}
                    bmat = {h: np.zeros((ni, 8, 8), np.float32) for h in ("big", "small")}
                    for half, (src_a, src_g) in (("big", (a_big, g_big)),
                                                 ("small", (a_small, g_small))):
                        for i in range(mi):  # A[m][k] of m16n8k8 from the lanes' words
                            w = _tf32_fragment_words(lda_s, ks, m0 + 16 * i)
                            am[half][i, g, t] = src_a[w["a0"]]
                            am[half][i, g + 8, t] = src_a[w["a1"]]
                            am[half][i, g, t + 4] = src_a[w["a2"]]
                            am[half][i, g + 8, t + 4] = src_a[w["a3"]]
                        for j in range(ni):  # B[k][n]
                            w = _tf32_fragment_words(ldg_s, ks, n0 + 8 * j)
                            bmat[half][j, t, g] = src_g[w["b0"]]
                            bmat[half][j, t + 4, g] = src_g[w["b1"]]
                    pairs = ((("small", "big"), ("big", "small"), ("big", "big")) if three
                             else (("big", "big"),))
                    for ha, hb in pairs:  # each product exact, each sum a float32 add
                        prod = np.einsum("imk,jkn->ijmn", am[ha].astype(np.float64),
                                         bmat[hb].astype(np.float64))
                        part = (part + prod).astype(np.float32)
                acc[warp] = acc[warp] + part
    out = np.full((bm, bn), np.nan, np.float32)
    for warp in range(wm * wn):
        m0, n0 = (warp // wn) * mi * 16, (warp % wn) * ni * 8
        for i in range(mi):
            for j in range(ni):
                out[m0 + 16 * i: m0 + 16 * i + 16, n0 + 8 * j: n0 + 8 * j + 8] = acc[warp, i, j]
    return out[:k_live]


@pytest.mark.parametrize("bm,bn,bk,wm,wn,k_live,lda", [
    (48, 64, 32, 3, 2, 34, 36),     # dW1's tile: D = 34, x rows padded to 36
    (64, 128, 64, 2, 4, 64, 64),    # a 64 x 128 tile, 64-row slices
    (128, 128, 32, 2, 4, 96, 96),   # 128 x 128 with rows past H, 32-row slices
])
def test_tf32_wgrad_fragment_walk_matches_the_products(bm, bn, bk, wm, wn, k_live, lda):
    """The float32 weight-gradient tile, walked with its 32-bit fragment
    loads, its split and its per-slice partials, gives A^T G over two steps
    with N = 100 (a ragged last slice), the older step's A being h_{-1} = 0,
    and columns past the A row's lda zero-filled: >= 100 dB against float64
    products of the float32 operands, while the same walk with one TF32
    product (big.big) falls under the float32 floor of 80 dB."""
    rng = np.random.default_rng(12)
    n_rows = 100
    a1 = rng.standard_normal((n_rows, lda)).astype(np.float32)
    a1[:, k_live:] = 0.0  # x's pad columns are zero (the wrapper's padding)
    g1 = rng.standard_normal((n_rows, bn)).astype(np.float32)
    g0 = rng.standard_normal((n_rows, bn)).astype(np.float32)
    want = a1[:, :k_live].astype(np.float64).T @ g1.astype(np.float64)

    def db(got):
        return 10 * np.log10((want ** 2).sum() / ((got - want) ** 2).sum())

    got = _tf32_tile_walk([a1, None], [g1, g0], lda, k_live, bm, bn, bk, wm, wn)
    assert db(got) >= 100.0
    one = _tf32_tile_walk([a1, None], [g1, g0], lda, k_live, bm, bn, bk, wm, wn, three=False)
    assert db(one) < 80.0


@pytest.mark.parametrize("cols", [48, 64, 128])
def test_tf32_fragment_loads_hit_32_banks(cols):
    """At the staged pitch (`f32_pitch`: 72 words for 48 and 64 columns, 136
    for 128) the 32 lanes' loads of each word of a TF32 fragment fall in 32
    different banks (word % 32), at every k-step and fragment column; an
    unpadded pitch (48, 64, 128 words) puts two or four lanes in a bank."""
    pitch = _f32_pitch(cols)
    assert pitch % 32 == 8 and pitch >= cols and pitch * 4 % 16 == 0
    for bk in (32, 64):
        for ks in range(bk // 8):
            for col0 in range(0, cols, 8):
                for name, words in _tf32_fragment_words(pitch, ks, col0).items():
                    assert len(set(words % 32)) == 32, (cols, ks, col0, name)
    unpadded = _tf32_fragment_words(cols, 0, 0)["a0"] % 32
    assert len(set(unpadded)) <= 16


# ---------------------------------------------------------------------------
# the wgmma weight-gradient kernels (csrc/lstm2_bwd_wgrad.cu, wgrad_wgmma_kernel,
# wgrad_wgmma_tf32_kernel; csrc/lstm2_wgmma.cuh)
# ---------------------------------------------------------------------------

WGMMA_TILES = [(dtype, tile) for dtype, tiles in ((torch.bfloat16, lt.WGRAD_H_TILES),
                                                  (torch.float32, lt.WGRAD_F32_TILES))
               for tile in tiles if lt.wgmma_tile(tile)]
GRADIENTS = ("dw1", "du1", "dw2", "du2")  # `which` 0 .. 3


def _wgmma_ctas(d_in, hidden, n, tile):
    """The CTAs of one wgmma weight-gradient launch as `wgmma_work` maps
    (blockIdx.x, blockIdx.y): the tiles of dU1, dW2 and dU2, then dW1's, all
    of one shape, once for each run of each step's row slices; as (gradient,
    first row, first gate column, live rows K, run, first row slice, row
    slices)."""
    bm, bn, bk, _, splits = tile
    cols = -(-4 * hidden // bn)
    h_tiles = -(-hidden // bm) * cols
    blocks = 3 * h_tiles + -(-d_in // bm) * cols
    all_slices = -(-n // bk)
    per = -(-all_slices // splits)
    ctas = []
    for run in range(splits):
        for b in range(blocks):
            if b < 3 * h_tiles:
                which = 1 + b // h_tiles
                b -= (which - 1) * h_tiles
                k = hidden
            else:
                which = 0
                b -= 3 * h_tiles
                k = d_in
            first = run * per
            ctas.append((GRADIENTS[which], (b // cols) * bm, (b % cols) * bn, k, run, first,
                         max(0, min(all_slices, first + per) - first)))
    return ctas


@pytest.mark.parametrize("dtype,tile", WGMMA_TILES)
@pytest.mark.parametrize("d,hidden", [(34, 384), (34, 64), (257, 512)])
def test_wgmma_schedule_owns_each_element_once_a_run(d, hidden, dtype, tile):
    """The wgmma kernels' CTA schedule: in every run of row slices, each
    element of dW1 [D, 4H] and dU1, dW2, dU2 [H, 4H] has exactly one owner
    (a CTA tile, cut to the gradient's rows and columns), no tile lies
    wholly outside its gradient, a tile's second warpgroup is live only
    where its 64 rows start inside the gradient, and the runs cut each
    step's row slices into disjoint ranges that cover them (N 2304: 36
    slices of 64 rows or 72 of 32; N 150 ragged). At the training shape the
    grid is one wave of the H100's 132 SMs."""
    bm, bn, bk, _, splits = tile
    g = 4 * hidden
    for n in (2304, 150):
        ctas = _wgmma_ctas(d, hidden, n, tile)
        for run in range(splits):
            for name in GRADIENTS:
                rows = d if name == "dw1" else hidden
                count = np.zeros((rows, g), np.int64)
                for grad, k0, c0, k, r, _, _ in ctas:
                    if grad == name and r == run:
                        assert k0 < k == rows and c0 < g
                        live = 2 if k0 + 64 < k else 1
                        assert min(k0 + bm, k) <= k0 + 64 * live
                        count[k0:k0 + bm, c0:c0 + bn] += 1
                assert (count == 1).all(), (tile, name, run)
        ranges = sorted({(first, count) for *_, first, count in ctas})
        covered = [s for first, count in ranges for s in range(first, first + count)]
        assert covered == list(range(-(-n // bk)))
    if (d, hidden) == (34, 384):
        assert len(_wgmma_ctas(d, hidden, 2304, tile)) <= 132


@pytest.mark.parametrize("n", [18, 63, 64, 150, 2304])
def test_wgrad_rule_by_dtype_and_rows(n):
    """The rule (`wgrad_tiles`, mirrored by `wgrad_tile` / `wgrad_f32_tile`
    in the kernel's source) takes the wgmma kernels at every fold, in
    both dtypes: they measured faster at the sub-band training folds (N
    2304) and at FullSubNet's full-band fold (N 18) alike; bf16 128 x 256 in
    two runs of row slices, float32 128 x 128 with 32-row slices in one,
    dW1 in the same tile. The mma.sync tiles stay as forced candidates."""
    for dtype, tiles, wgmma in ((torch.bfloat16, lt.WGRAD_H_TILES, 2),
                                (torch.float32, lt.WGRAD_F32_TILES, 6)):
        w1_tile, tile = lt.wgrad_tiles(34, 384, dtype, n)
        assert tile == tiles[wgmma] and lt.wgmma_tile(tile) and w1_tile == tile[:2]
        assert lt.wgrad_tiles(257, 512, dtype, n) == (w1_tile, tile)
        assert sum(map(lt.wgmma_tile, tiles)) == 1
    assert lt.WGRAD_H_TILES[2] == (128, 256, 64, "wgmma", 2)
    assert lt.WGRAD_F32_TILES[6] == (128, 128, 32, "wgmma", 1)


def _wgmma_run_sums(products, shifted, splits, chunk, fold=1):
    """Each run's float32 sums as the wgmma kernels keep them: products[t][s]
    is row slice s of step t (float32); the chunks sweep the steps newest
    first, a run starts from zero on the first chunk and reads its partial
    back on later ones, adds its slices t_hi first, slices in order, and
    skips t = 0 where the gradient reads h_{t-1} (h_{-1} = 0). With fold > 1
    (float32) a zeroed partial sums `fold` slices of one step before one
    float32 add puts it into the sums."""
    steps, slices = len(products), len(products[0])
    per = -(-slices // splits)
    runs = [np.zeros_like(products[0][0]) for _ in range(splits)]
    for t_hi in range(steps - 1, -1, -chunk):
        t_lo = max(0, t_hi - chunk + 1)
        for run in range(splits):
            acc = runs[run].copy()  # stored and read back exactly between chunks
            mine = range(run * per, min(slices, run * per + per))
            for t in range(t_hi, (1 if shifted and t_lo == 0 else t_lo) - 1, -1):
                part = None
                for i, s in enumerate(mine):
                    if fold == 1:
                        acc = (acc + products[t][s]).astype(np.float32)
                        continue
                    part = products[t][s] if i % fold == 0 else (part + products[t][s])
                    if i % fold == fold - 1 or i == len(mine) - 1:
                        acc = (acc + part).astype(np.float32)
            runs[run] = acc
    return runs


def _wgmma_reduce(runs):
    """`wgmma_reduce_kernel`: C = run 0's sums, then each later run's added in
    run order (float32 adds)."""
    c = runs[0].copy()
    for part in runs[1:]:
        c = (c + part).astype(np.float32)
    return c


@pytest.mark.parametrize("splits,fold", [(1, 1), (2, 1), (3, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("shifted", [False, True])
def test_wgmma_runs_reduce_in_a_fixed_order(splits, fold, shifted):
    """The model of the wgmma kernels' split partials and their reduction:
    with each run's partial kept across chunks, the weight gradient is the
    same bits at chunks of 1, 2, 5 and all 9 steps, equal to run 0's sums
    plus run 1's (plus run 2's) in that order, and within float32 rounding
    of the float64 sum (without step 0 where the gradient reads h_{t-1})."""
    rng = np.random.default_rng(21)
    steps, slices = 9, 5  # N 150 in 32-row slices: 5, the last ragged
    products = [[rng.standard_normal((4, 6)).astype(np.float32) for _ in range(slices)]
                for _ in range(steps)]
    got = {chunk: _wgmma_reduce(_wgmma_run_sums(products, shifted, splits, chunk, fold))
           for chunk in (1, 2, 5, steps)}
    for chunk, c in got.items():
        assert np.array_equal(c.view(np.int32), got[steps].view(np.int32)), chunk
    runs = _wgmma_run_sums(products, shifted, splits, 3, fold)
    in_order = runs[0]
    for part in runs[1:]:
        in_order = in_order + part
    assert np.array_equal(got[steps], in_order)
    want = sum(p.astype(np.float64) for t, step in enumerate(products) for p in step
               if not (shifted and t == 0))
    np.testing.assert_allclose(got[steps], want, rtol=1e-5, atol=1e-5)


def _swz128(off):
    """The 128-byte swizzle of a byte offset from a 1024-aligned base
    (`swz128`; CU_TENSOR_MAP_SWIZZLE_128B and the B128 descriptor layout)."""
    off = np.asarray(off)
    return off ^ (((off >> 7) & 7) << 4)


def _tma_box(smem, dst, array, row0, col0, box_rows, box_cols, elem, swizzle):
    """A TMA box [box_rows][box_cols] of `array` [rows][cols] (one step) from
    (row0, col0) into the byte buffer `smem` at `dst`: rows and columns past
    the array's arrive as zeros, the 128-byte swizzle on the destination."""
    rows, cols = array.shape
    box = np.zeros((box_rows, box_cols), array.dtype)
    r1, c1 = min(rows, row0 + box_rows), min(cols, col0 + box_cols)
    if r1 > row0 and c1 > col0:
        box[:r1 - row0, :c1 - col0] = array[row0:r1, col0:c1]
    off = (np.arange(box_rows)[:, None] * box_cols + np.arange(box_cols)[None, :]) * elem
    off = _swz128(off) if swizzle else off
    view = smem[dst:dst + box.nbytes].view(array.dtype)
    view[off.ravel() // elem] = box.ravel()


def _mn_major(smem, start, lbo, sbo, mn, k, dtype):
    """A B128 MN-major wgmma operand (bf16) read through its descriptor:
    element (mn, k) at start + (mn / 64) LBO + (k / 8) SBO + (k % 8) 128 +
    (mn % 64) 2, swizzled."""
    m, kk = np.meshgrid(np.arange(mn), np.arange(k), indexing="ij")
    addr = start + (m // 64) * lbo + (kk // 8) * sbo + (kk % 8) * 128 + (m % 64) * 2
    return smem.view(dtype)[_swz128(addr) // 2]


def _k_major(smem, start, sbo, rows, k):
    """A B128 K-major wgmma operand (32-bit TF32) read through its
    descriptor: element (row, k) at start + (row / 8) SBO + (row % 8) 128 +
    4 k, swizzled (a k8 step's descriptor starts 32 bytes further in)."""
    r, kk = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    addr = start + (r // 8) * sbo + (r % 8) * 128 + kk * 4
    return smem.view(np.uint32)[_swz128(addr) // 4]


def _bf16_bits(a):
    """float32 values that are bf16, as bf16 bits (uint16)."""
    return (a.view(np.uint32) >> 16).astype(np.uint16)


def test_wgmma_bf16_tile_walk_matches_the_products():
    """One bf16 wgmma CTA tile (128 rows k x 256 gate columns c, the second
    c-half past 4H: H 96, so 4H 384 and the tile at c0 256 has two live
    64-column boxes of four), walked as `wgrad_wgmma_kernel` walks it over
    one step with N = 100 (a ragged second slice of 64 rows): each slice's
    TMA boxes of 64 x 64 land swizzled (rows past N and columns past H
    zero), each consumer warpgroup reads its 64 rows of A and the whole G
    tile MN-major through descriptors (LBO 8192 between 64-wide blocks, SBO
    1024 between 8-row groups, a k16 step 2048 bytes further in), and the
    m64n256k16 products summed in float64 give A^T G exactly where k < H and
    c < 4H."""
    rng = np.random.default_rng(23)
    n_rows, hidden, c0 = 100, 96, 256
    g_cols = 4 * hidden

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float().numpy()

    a, g = bf16(n_rows, hidden), bf16(n_rows, g_cols)
    box = 64 * 128
    acc = np.zeros((128, 256))
    for nb in range(0, n_rows, 64):
        smem = np.zeros(1024 + 6 * box, np.uint8)[1024:]  # a 1024-aligned stage
        stale = rng.integers(0, 2 ** 16, 6 * box // 2, dtype=np.uint16)
        smem.view(np.uint16)[:] = stale  # boxes not issued keep whatever was there
        a_bits, g_bits = _bf16_bits(a), _bf16_bits(g)
        for b in range(2):  # A's boxes, issued where they start inside the H columns
            if 64 * b < hidden:
                _tma_box(smem, b * box, a_bits, nb, 64 * b, 64, 64, 2, True)
        for j in range(4):  # G's boxes, issued where they start inside 4H
            if c0 + 64 * j < g_cols:
                _tma_box(smem, (2 + j) * box, g_bits, nb, c0 + 64 * j, 64, 64, 2, True)
        for wg in range(2):
            for kk in range(4):
                am = _mn_major(smem, wg * box + 2048 * kk, box, 1024, 64, 16, np.uint16)
                bm = _mn_major(smem, 2 * box + 2048 * kk, box, 1024, 256, 16, np.uint16)
                with np.errstate(invalid="ignore", over="ignore"):
                    af = (am.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
                    bf = (bm.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
                    acc[64 * wg:64 * wg + 64] += af @ bf.T
    want = a.astype(np.float64).T @ g[:, c0:].astype(np.float64)
    np.testing.assert_array_equal(acc[:hidden, :g_cols - c0], want)


def _split_bits(words):
    """`lstm2::split_tf32` on uint32 words: big = the word rounded to TF32
    (half of the 13 low bits added, then cleared), small = word - big in
    float32 plus the same half; the tensor core drops each operand's 13 low
    bits (`_tf32_operand`)."""
    words = words.astype(np.uint32)
    big = (words + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    small = (words.view(np.float32) - big.view(np.float32)).view(np.uint32) + np.uint32(0x1000)
    return big, small


def _tf32_operand(words):
    """A TF32 operand as the tensor core reads it: the low 13 bits dropped."""
    return (words & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)


def test_wgmma_tf32_tile_walk_matches_the_products():
    """One float32 wgmma CTA tile (128 rows k x 128 gate columns, H 96 so
    rows past 96 are zero), walked as `wgrad_wgmma_tf32_kernel` walks it over
    one step with N = 100 (32-row slices, the last ragged): A lands in four
    swizzled 32 x 32 boxes and G in one plain 32 x 128 box; the staging
    warpgroup's thread c splits G[4 q + e][c] and stores each quad as 16
    bytes K-major and swizzled into big and small (row c, 128 bytes); each
    consumer lane loads its A words (mma.sync m16n8k8's A fragment of its
    warp's 16 rows) and splits them; each k8 step's B is read K-major
    through a descriptor 32 bytes further in (SBO 1024), and small.big +
    big.small + big.big summed in float64 comes within 2^-20 of the float64
    A^T G (>= 100 dB), where big.big alone does not reach 80 dB."""
    rng = np.random.default_rng(24)
    n_rows, hidden, bn = 100, 96, 128
    a = rng.standard_normal((n_rows, hidden)).astype(np.float32)
    g = rng.standard_normal((n_rows, bn)).astype(np.float32)
    abox, landed = 32 * 128, 4 * 32 * 128 + 32 * 128 * 4
    acc3, acc1 = np.zeros((128, bn)), np.zeros((128, bn))
    lane = np.arange(32)
    gl, tl = lane >> 2, lane & 3
    for nb in range(0, n_rows, 32):
        smem = np.zeros(landed + 2 * bn * 128, np.uint8)
        for b in range(4):
            if 32 * b < hidden:
                _tma_box(smem, b * abox, a, nb, 32 * b, 32, 32, 4, True)
        _tma_box(smem, 4 * abox, g, nb, 0, 32, bn, 4, False)
        words = smem.view(np.uint32)
        big_at, small_at = landed, landed + bn * 128
        for c in range(bn):  # the staging thread of column c
            for q in range(8):
                hi, lo = _split_bits(words[(4 * abox + ((4 * q + np.arange(4)) * bn + c) * 4) // 4])
                off = int(_swz128(c * 128 + q * 16))
                words[(big_at + off) // 4:(big_at + off) // 4 + 4] = hi
                words[(small_at + off) // 4:(small_at + off) // 4 + 4] = lo
        for kk in range(4):
            b_big = _tf32_operand(_k_major(smem, big_at + 32 * kk, 1024, bn, 8))
            b_small = _tf32_operand(_k_major(smem, small_at + 32 * kk, 1024, bn, 8))
            for cw in range(2):
                for warp in range(4):
                    kloc = 64 * cw + 16 * warp + gl  # rows k and k + 8 of the lanes
                    a_big, a_small = np.zeros((16, 8), np.uint32), np.zeros((16, 8), np.uint32)
                    for v, (dm, dn) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                        k, n = kloc + dm, 8 * kk + tl + dn
                        addr = (k // 32) * abox + _swz128(n * 128 + (k % 32) * 4)
                        hi, lo = _split_bits(words[addr // 4])
                        a_big[gl + dm, tl + dn], a_small[gl + dm, tl + dn] = hi, lo
                    rows = slice(64 * cw + 16 * warp, 64 * cw + 16 * warp + 16)
                    ab, asm = _tf32_operand(a_big), _tf32_operand(a_small)
                    acc3[rows] += asm @ b_big.T + ab @ b_small.T + ab @ b_big.T
                    acc1[rows] += ab @ b_big.T
    want = a.astype(np.float64).T @ g.astype(np.float64)

    def db(got):
        return 10 * np.log10((want ** 2).sum() / ((got[:hidden] - want) ** 2).sum())

    assert db(acc3) >= 100.0 and db(acc1) < 80.0
    assert not acc3[hidden:].any()  # rows past H: their A columns arrive as zeros


def test_x_is_padded_to_whole_copies():
    """x's rows as the weight-gradient kernels read them: D rounded up to
    16-byte copies (4 float32, 8 bf16) with zero columns, so every cp.async
    source is aligned."""
    expect = {(34, torch.float32): 36, (257, torch.float32): 260, (32, torch.float32): 32,
              (34, torch.bfloat16): 40, (257, torch.bfloat16): 264, (32, torch.bfloat16): 32}
    for (d, dtype), cols in expect.items():
        assert lt.wgrad_x_cols(d, dtype) == cols
        assert cols * torch.tensor([], dtype=dtype).element_size() % 16 == 0


# ---------------------------------------------------------------------------
# the reverse sweep's wave form (csrc/lstm2_bwd_sweep.cuh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_sweep_form_rule_and_shared_memory(dtype):
    """The reverse sweep's form by shape and SM count (`bwd_sweep_form`, an
    H100's 132 SMs): the wave form where the fold has more row tiles of 16
    than the card has SMs (the shipped training fold N 2304, D 34, H 384,
    O 2: 144 tiles; FullSubNet's sub-band training and batch folds, D 32; N
    2113), the tile form where one wave holds them (N 2112: 132 tiles; a
    card's half of the training fold, N 1152), and clusters of 16 at
    FullSubNet's full-band fold (N 18, D 257, H 512, O 257). On a card of
    144 SMs N 2304 is one wave. The wave form runs the tile form's kernel
    and layout, whose shared memory fits a block in both dtypes, as the
    cluster form's does."""
    for n, d in ((2304, 34), (2304, 32), (4626, 32), (2113, 34)):
        assert lt.bwd_sweep_form(n, d, 384, 2, dtype) == lt.SWEEP_WAVE == 1
    for n, d in ((2112, 34), (1152, 34), (771, 34), (40, 34)):
        assert lt.bwd_sweep_form(n, d, 384, 2, dtype) == 0
    assert lt.bwd_sweep_form(2304, 34, 384, 2, dtype, sm_count=144) == 0
    assert lt.bwd_sweep_form(18, 257, 512, 257, dtype) == lt.SWEEP_CLUSTER == 16
    assert lt.bwd_sweep_form(lt.CLUSTER_MAX_ROWS + 1, 257, 512, 257, dtype) == 0
    assert lt.SM_COUNT == 132 and lt.WAVE_STEPS >= 1
    # the wave form's dgates scratch: 32 steps at the training fold, the tile form's 16 / 2
    assert lt.wgrad_chunk_steps(2304, 384, 195, dtype, wave=True) == 32
    assert lt.wgrad_chunk_steps(2304, 384, 195, dtype) == (16 if dtype == torch.float32 else 2)
    assert lt.wgrad_chunk_steps(2304, 384, 9, dtype, wave=True) == 9  # never more than T
    assert lt.bwd_shared_memory_bytes(16, 34, 384, 2, dtype) <= ops_lstm2.SMEM_LIMIT
    assert lt.bwd_shared_memory_bytes(16, 32, 384, 2, dtype) <= ops_lstm2.SMEM_LIMIT
    assert lt.bwd_cluster_shared_memory_bytes(257, 512, 257, dtype) <= ops_lstm2.SMEM_LIMIT
    assert [lt.sweep_form_name(f) for f in (0, lt.SWEEP_WAVE, 16)] == ["tile", "wave", "cluster16"]


@pytest.mark.parametrize("n,steps", [(2304, 195), (2304, 16), (2304, 2), (4626, 195), (40, 9)])
@pytest.mark.parametrize("part_steps", [1, 4])
def test_wave_schedule_runs_each_part_after_the_one_before(n, steps, part_steps):
    """The wave form's schedule (`launch_mma` with part_steps > 0), walked
    here as the launches walk it: work items k = 0 .. tiles x parts - 1,
    item k the row tile k mod tiles over part k div tiles (part_steps steps,
    newest first), in launches of W = min(132, tiles) items. Every tile's
    parts cover its steps once and in order, and an item's previous part
    ran in an earlier launch (stream order is the only synchronisation).
    At the training fold the launches cost fewer steps' time than the tile
    form's two waves."""
    tiles = -(-n // 16)
    parts = -(-steps // part_steps)
    items, wave = tiles * parts, min(lt.SM_COUNT, tiles)
    covered = {}
    for k in range(items):
        part, tile = divmod(k, tiles)
        hi = steps - 1 - part * part_steps
        covered.setdefault(tile, []).extend(range(hi, max(0, hi - part_steps + 1) - 1, -1))
        if part:
            assert (k - tiles) // wave < k // wave
    assert all(v == list(range(steps - 1, -1, -1)) for v in covered.values())
    if n == 2304 and steps == 195:
        assert -(-items // wave) * part_steps < 2 * steps


# ---------------------------------------------------------------------------
# the forward sweep's wave form (csrc/lstm2_fwd_sweep.cuh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_sweep_plan_rule(dtype):
    """The forward sweep's (form, row tile) by shape and SM count
    (`fwd_sweep_plan`, an H100's 132 SMs), the pair K1 and K2 both take. In
    bf16 (`fwd_sweep_pair`) the pair form at 32 rows at every sub-band
    fold: in one launch where the card holds the fold's pairs (half its
    SMs: the batch fold N 2056, 65 pairs, a card's half of the training
    fold N 1152, N 771, N 2112, 66 pairs; N 2304 on a card of 144 SMs) and
    in waves past them (the training fold N 2304 at D 34 and at
    FullSubNet's sub-band D 32, 72 pairs; a batch of 9 utterances, N 2313;
    N 2113). In float32 the wave form at 16 rows where the fold has more
    row tiles of 16 than the card has SMs (FWD_WAVE_BY_DTYPE: N 2304, 2313,
    2113), the tile form with `fwd_mma_row_tile`'s R where one wave holds
    them or on a card of 144 SMs. Clusters of 16 at FullSubNet's full-band
    folds in both. FWD_SWEEP_FORM forces each form, with 16 rows for the
    cluster and wave forms, 32 for the pair forms and the tile form's own
    R. The carries of a form in waves are h1 and h2 in the weight dtype and
    c1, c2 float32."""
    pair = dtype == torch.bfloat16
    assert ops_lstm2.FWD_WAVE_BY_DTYPE[torch.float32]
    for n, d in ((2304, 34), (2304, 32), (2313, 34)):
        want = (ops_lstm2.FWD_PAIR_WAVE, 32) if pair else (ops_lstm2.FWD_SWEEP_WAVE, 16)
        assert ops_lstm2.fwd_sweep_plan(n, d, 384, 2, dtype) == want
    assert ops_lstm2.fwd_sweep_plan(2304, 34, 384, 2, dtype, sm_count=144) == (
        (ops_lstm2.FWD_PAIR, 32) if pair
        else (0, ops_lstm2.fwd_mma_row_tile(2304, 34, 384, 144, dtype)))
    for n in (2056, 1152, 771, 2112):
        assert ops_lstm2.fwd_sweep_plan(n, 34, 384, 2, dtype) == (
            (ops_lstm2.FWD_PAIR, 32) if pair
            else (0, ops_lstm2.fwd_mma_row_tile(n, 34, 384, 132, dtype)))
    assert ops_lstm2.fwd_sweep_plan(2113, 34, 384, 2, dtype)[0] == (3 if pair else 1)
    for n in (8, 18):
        assert ops_lstm2.fwd_sweep_plan(n, 257, 512, 257, dtype) == (16, 16)
    assert ops_lstm2.SM_COUNT == 132 and ops_lstm2.FWD_WAVE_STEPS >= 1
    assert ops_lstm2.FWD_SWEEP_WAVE == lt.SWEEP_WAVE == 1 and ops_lstm2.FWD_WAVE_ROWS == 16
    assert (ops_lstm2.FWD_PAIR, ops_lstm2.FWD_PAIR_WAVE, ops_lstm2.FWD_PAIR_ROWS) == (2, 3, 32)
    size = torch.tensor([], dtype=dtype).element_size()
    assert ops_lstm2.fwd_carry_bytes(16, 384, dtype) == 2 * 16 * 384 * (size + 4)
    assert [ops_lstm2.fwd_form_name(f) for f in (0, 1, 2, 3, 16)] == [
        "tile", "wave", "pair", "pair wave", "cluster16"]
    params, fc = _case(2, 1, 34, 384, 2)[:2]
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, dtype, requires_grad=False))
    x = torch.zeros(2304, 34, 1, dtype=dtype)
    assert ops_lstm2.fwd_sweep_launch(x, w) == ops_lstm2.fwd_sweep_plan(2304, 34, 384, 2, dtype)
    for forced, want in ((0, (0, ops_lstm2.fwd_mma_row_tile(2304, 34, 384, 132, dtype))),
                         (1, (1, 16)), (2, (2, 32)), (3, (3, 32)), (16, (16, 16))):
        ops_lstm2.FWD_SWEEP_FORM = forced
        try:
            assert ops_lstm2.fwd_sweep_launch(x, w) == want
            assert ops_lstm2.fwd_sweep_form(x, w) == forced
        finally:
            ops_lstm2.FWD_SWEEP_FORM = None
    carry = ops_lstm2.fwd_carry(x, 1, 16, 384)
    assert carry.dtype == torch.uint8 and carry.numel() == 144 * 2 * 16 * 384 * (size + 4)
    carry = ops_lstm2.fwd_carry(x, ops_lstm2.FWD_PAIR_WAVE, 32, 384)
    assert carry.dtype == torch.uint8 and carry.numel() == 72 * 2 * 32 * 384 * (size + 4)
    assert ops_lstm2.fwd_carry(x, 0, 16, 384) is None
    assert ops_lstm2.fwd_carry(x, ops_lstm2.FWD_PAIR, 32, 384) is None


def _fwd_wave_schedule(n, steps, part_steps, sm_count, rows=16):
    """The wave form's launches as `launch_mma_tile` makes them: work items
    k = 0 .. tiles x parts - 1, item k the row tile k mod tiles over part k
    div tiles (steps [part x part_steps, min(T, (part + 1) part_steps))),
    in launches of W = min(SMs, tiles) items. -> [[(tile, t_lo, t_hi), ..]
    a launch]."""
    tiles, parts = -(-n // rows), -(-steps // part_steps)
    items, wave = tiles * parts, min(sm_count, tiles)
    launches = []
    for item0 in range(0, items, wave):
        launch = []
        for k in range(item0, min(items, item0 + wave)):
            part, tile = divmod(k, tiles)
            launch.append((tile, part * part_steps, min(steps, (part + 1) * part_steps) - 1))
        launches.append(launch)
    return launches


@pytest.mark.parametrize("n,steps", [(2304, 195), (2313, 629), (2304, 9), (40, 9), (771, 5)])
@pytest.mark.parametrize("part_steps", [1, 4, 16])
def test_fwd_wave_schedule_runs_each_part_after_the_one_before(n, steps, part_steps):
    """The wave form's schedule on 132 SMs, oldest steps first: every tile's
    parts cover its steps once and in order, an item's previous part ran in
    an earlier launch (stream order is the only synchronisation), and every
    step's y has one writer (an item runs the fc of the steps before its last
    at the top of the next and its last one after its loop). At the training
    fold and 4 steps an item: 54 launches, 216 steps' time against the tile
    form's 195 of a full wave and 195 of a second."""
    launches = _fwd_wave_schedule(n, steps, part_steps, 132)
    covered, finished = {}, {}
    for i, launch in enumerate(launches):
        assert len({tile for tile, _, _ in launch}) == len(launch)
        for tile, lo, hi in launch:
            assert covered.get(tile, []) == list(range(lo))  # the steps before, all done
            assert lo == 0 or finished[tile] < i
            covered.setdefault(tile, []).extend(range(lo, hi + 1))
            finished[tile] = i
    assert len(covered) == -(-n // 16)
    assert all(v == list(range(steps)) for v in covered.values())
    if (n, steps, part_steps) == (2304, 195, 4):
        assert len(launches) == 54 and len(launches) * part_steps == 216 < 2 * steps


def _fwd_wave_walk(x, w, part_steps, sm_count, rows=16, carry_c=lambda c: c):
    """The forward sweep in the wave form's schedule, a tile's rows through
    the plain step (products in float32 from h rounded to the weight dtype,
    c float32), each item resuming from its tile's carries: h1 and h2 as the
    operand rows hold them (rounded) and c through `carry_c` (the kernel
    keeps the float32 words). -> (y [N, T, O], the residuals [T, N, .], the
    writers of each y row and step)."""
    n, _, steps = x.shape
    hidden, dtype = w.u1.shape[0], w.w1.dtype
    w1, u1, w2 = w.w1.float(), w.u1.float(), w.w2.float()
    y = torch.full((n, steps, w.fc_w.shape[1]), float("nan"))
    res = {f: torch.full((steps, n, 4 * hidden if f[0] == "g" else hidden), float("nan"))
           for f in lt.Residuals._fields}
    writers, carry = torch.zeros(n, steps, dtype=torch.int64), {}
    for launch in _fwd_wave_schedule(n, steps, part_steps, sm_count, rows):
        stored = {}
        for tile, lo, hi in launch:
            rs = slice(tile * rows, min(n, (tile + 1) * rows))
            h1, h2, c1, c2 = carry[tile] if lo else (torch.zeros(rs.stop - rs.start, hidden),) * 4
            for t in range(lo, hi + 1):
                gates1 = x[rs, :, t].float() @ w1 + h1 @ u1 + w.b1
                h1, c1 = ops_lstm2.lstm_cell(gates1, c1)
                h1 = h1.to(dtype).float()
                gates2 = torch.cat([h1, h2], dim=-1) @ w2 + w.b2
                h2, c2 = ops_lstm2.lstm_cell(gates2, c2)
                h2 = h2.to(dtype).float()
                y[rs, t] = h2 @ w.fc_w + w.fc_b
                writers[rs, t] += 1
                for name, v in zip(lt.Residuals._fields, (
                        _activated(gates1), c1, h1, _activated(gates2), c2, h2)):
                    res[name][t, rs] = v
            stored[tile] = (h1, h2, carry_c(c1), carry_c(c2))
        carry.update(stored)  # read only by a later launch
    return y.to(dtype), {k: v.to(dtype) for k, v in res.items()}, writers


def _activated(gates):
    i, f, g, o = gates.chunk(4, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("part_steps", [1, 4])
def test_fwd_wave_walk_equals_the_tile_walk(dtype, part_steps):
    """Walked in the wave form's schedule (3 row tiles in waves of 2, T 9,
    so the last part is ragged at 4 steps an item), the forward gives the
    tile form's y and residuals bit for bit when the carries are h1, h2 as
    the operand rows hold them and c as float32, every y word written once,
    and it agrees with `lstm2_train_fwd_reference`. Resuming from c rounded
    to bf16, as the saved residual c is, changes the bits."""
    n, t = 40, 9
    params, fc, x, _ = _case(n, t, 6, 32, 2, seed=3)
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, dtype, requires_grad=False))
    x = torch.tensor(x).to(dtype)
    y_tile, res_tile, _ = _fwd_wave_walk(x, w, t, 2)
    y, res, writers = _fwd_wave_walk(x, w, part_steps, 2)
    assert (writers == 1).all()
    assert torch.equal(y, y_tile)
    assert all(torch.equal(res[k], res_tile[k]) for k in res)
    y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(y.float().numpy(), y_ref.float().numpy(), atol=tol, rtol=tol)
    for name, want in zip(lt.Residuals._fields, res_ref):
        np.testing.assert_allclose(res[name].float().numpy(), want.float().numpy(), atol=tol,
                                   rtol=tol, err_msg=name)
    if dtype == torch.bfloat16:
        y_rounded, _, _ = _fwd_wave_walk(x, w, part_steps, 2,
                                         carry_c=lambda c: c.to(dtype).float())
        assert not torch.equal(y_rounded, y_tile)


# ---------------------------------------------------------------------------
# the bf16 reverse sweep's schedule (csrc/lstm2_bwd_sweep.cuh, sweep_mma_kernel)
# ---------------------------------------------------------------------------

def _bf16_round(a):
    """float32 -> bf16 (round to nearest even) -> float32, as __float2bfloat16_rn."""
    bits = a.astype(np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _sweep_emulated(dy, g1, c1, g2, c2, w2, u1, w1, fcw, part_steps, rng):
    """The reverse sweep as `sweep_mma_kernel` runs it in bf16, in float32
    numpy. Per row tile of 16 and work item of part_steps steps (None: the
    tile form, one item of every step), each of the H / 32 warps runs the
    kernel's program as a coroutine: its cells (units 32 w .. 32 w + 31,
    row by row) and its products (P2: [W2; U2] columns 64 w .. 64 w + 63 in
    two passes, P1: U1 columns 32 w .. 32 w + 31 and dx's k-split partial
    over its k-part), between the kernel's five barriers a step over one
    dgates tile and one d h1 buffer. It yields between each read and write
    of shared memory, and the warps are interleaved in a random order that
    __syncthreads allows. Each product is one float32 matmul of the rounded
    dgates, its epilogue writing (or adding, acc + old) as `store_acc`
    does. The carries pass between a tile's items, and an item adds its
    bias sums to the tile's. Returns dx, dg1, dg2, the bias sums
    [tiles][2][4H] (db_part) and the carries out [4][N][H]."""
    steps, n, hidden = c1.shape
    d_in, out_dim, gates = w1.shape[0], fcw.shape[1], 4 * hidden
    warps, dxc, tiles = hidden // 32, -(-d_in // 8) * 8, -(-n // 16)
    w1p = np.zeros((dxc, gates), np.float32)
    w1p[:d_in] = w1
    dx = np.zeros((steps, n, d_in), np.float32)
    dgs = [np.zeros((steps, n, gates), np.float32) for _ in range(2)]
    db_part = np.zeros((tiles, 2, gates), np.float32)
    carry_out = np.zeros((4, tiles * 16, hidden), np.float32)
    part_steps = part_steps or steps
    for tile in range(tiles):
        n0 = 16 * tile
        live = min(16, n - n0)
        carry = [np.zeros((16, hidden), np.float32) for _ in range(4)]  # dh1, dc1, dh2, dc2
        for t_hi in range(steps - 1, -1, -part_steps):
            t_lo = max(0, t_hi - part_steps + 1)
            first = t_hi == steps - 1
            sh = {"dg": np.zeros((16, gates), np.float32),
                  "dh1": np.zeros((16, hidden), np.float32),
                  "dh2": np.zeros((16, hidden), np.float32),
                  "dy": np.zeros((16, out_dim), np.float32),
                  "dxp": np.zeros((warps, 16, dxc), np.float32)}

            def res_row(a, t, r):
                return a[t, n0 + r] if t >= 0 and r < live else np.zeros(a.shape[2], np.float32)

            def warp_program(w):
                units = np.arange(32 * w, 32 * w + 32)
                cols = (np.arange(4)[:, None] * hidden + units).ravel()  # its units' gate columns
                dc = {1: carry[1][:, units].copy(), 2: carry[3][:, units].copy()}
                db = {1: np.zeros(4 * 32, np.float32), 2: np.zeros(4 * 32, np.float32)}
                mine = np.arange(32 * w, 32 * w + 32)  # this warp's thread indices

                def cell_row(layer, dh, t, r):  # this warp's units' cell backward, row r
                    g, c = (g1, c1) if layer == 1 else (g2, c2)
                    gi, gf, gg, go = np.split(res_row(g, t, r)[cols], 4)
                    cc, c_prev = res_row(c, t, r)[units], res_row(c, t - 1, r)[units]
                    tanh_c = np.tanh(cc)
                    d_o = dh * tanh_c
                    d_c = dh * go * (1 - tanh_c * tanh_c) + dc[layer][r]
                    dc[layer][r] = d_c * gf
                    d = np.concatenate([d_c * gg * gi * (1 - gi), d_c * c_prev * gf * (1 - gf),
                                        d_c * gi * (1 - gg * gg), d_o * go * (1 - go)])
                    db[layer] = (db[layer] + d).astype(np.float32)
                    rounded = _bf16_round(d)
                    if r < live:
                        dgs[layer - 1][t, n0 + r, cols] = rounded
                    return rounded

                def cells1_row(t, r):
                    dh = sh["dh1"][r, units].copy()
                    yield
                    sh["dg"][r, cols] = cell_row(1, dh, t, r)

                def cells2_row(t, r):
                    dh = np.zeros(32, np.float32)
                    for o in range(out_dim):
                        dh = (dh + sh["dy"][r, o] * fcw[units, o]).astype(np.float32)
                    dh = (dh + sh["dh2"][r, units]).astype(np.float32)
                    yield
                    sh["dg"][r, cols] = cell_row(2, dh, t, r)

                def load_dy(t):
                    idx = np.concatenate([np.arange(j, 16 * out_dim, hidden) for j in mine])
                    for i in idx:
                        r, o = divmod(int(i), out_dim)
                        sh["dy"][r, o] = dy[n0 + r, t, o] if r < live else 0.0
                    yield

                def put(target, at, acc, add):
                    target[:, at] = (acc + target[:, at]).astype(np.float32) if add else acc

                def p2_pass(half):  # d h1_t = dh1' + the carry; d h2_{t-1}
                    col0 = 64 * w + 32 * half
                    acc = (sh["dg"] @ w2[col0:col0 + 32].T).astype(np.float32)
                    yield
                    if col0 < hidden:
                        put(sh["dh1"], slice(col0, col0 + 32), acc, True)
                    else:
                        put(sh["dh2"], slice(col0 - hidden, col0 - hidden + 32), acc, False)
                    yield

                def p1():  # d h1_{t-1}, and this warp's k-part of dx
                    acc = (sh["dg"] @ u1[units].T).astype(np.float32)
                    yield
                    put(sh["dh1"], units, acc, False)
                    kp = slice(w * gates // warps, (w + 1) * gates // warps)
                    part = (sh["dg"][:, kp] @ w1p[:, kp].T).astype(np.float32)
                    yield
                    sh["dxp"][w] = part
                    yield

                def dx_sum(t):
                    idx = np.concatenate([np.arange(j, 16 * d_in, hidden) for j in mine])
                    for i in idx:
                        r, col = divmod(int(i), d_in)
                        s = np.float32(0)
                        for p in range(warps):
                            s = np.float32(s + sh["dxp"][p, r, col])
                        if r < live:
                            dx[t, n0 + r, col] = _bf16_round(np.array([s]))[0]
                    yield

                sh["dh1"][:, units] = carry[0][:, units]
                sh["dh2"][:, units] = carry[2][:, units]
                for s in range(t_hi, t_lo - 1, -1):
                    yield from load_dy(s)
                    yield "bar"
                    for r in range(16):
                        yield from cells2_row(s, r)
                    yield "bar"
                    for half in range(2):
                        yield from p2_pass(half)
                    yield "bar"
                    for r in range(16):
                        yield from cells1_row(s, r)
                    yield "bar"
                    yield from p1()
                    yield "bar"
                    yield from dx_sum(s)
                for layer in (1, 2):  # the tile's bias sums: old + this item's, as the kernel adds
                    old = 0 if first else db_part[tile, layer - 1, cols]
                    db_part[tile, layer - 1, cols] = old + db[layer]
                carry[0][:, units] = sh["dh1"][:, units]
                carry[1][:, units] = dc[1]
                carry[2][:, units] = sh["dh2"][:, units]
                carry[3][:, units] = dc[2]

            progs = [warp_program(w) for w in range(warps)]
            running = set(range(warps))
            while running:
                at_bar = set()
                while running - at_bar:
                    w = int(rng.choice(sorted(running - at_bar)))
                    try:
                        if next(progs[w]) == "bar":
                            at_bar.add(w)
                    except StopIteration:
                        running.discard(w)
                assert at_bar in (running, set()), "a warp left while the others wait at a barrier"
        carry_out[:, n0:n0 + 16] = carry
    return dx, dgs[0], dgs[1], db_part, carry_out


def _emulation_args(dy, x, w):
    """The bf16 residuals of x from the plain forward and the weights, as
    `_sweep_emulated`'s float32 numpy arguments, and the residuals."""
    _, res = lt.lstm2_train_fwd_reference(x, w)
    f32 = lambda a: a.float().numpy()  # noqa: E731
    args = (_bf16_round(dy.float().numpy()), *(f32(a) for a in (res.g1, res.c1, res.g2, res.c2)),
            f32(w.w2), f32(w.u1), f32(w.w1), w.fc_w.float().numpy())
    return args, res


@pytest.mark.parametrize("n,t", [(20, 11), (16, 8)], ids=["N20-T11", "N16-T8"])
@pytest.mark.parametrize("part_steps", [1, 4, 8, None], ids=["wave1", "wave4", "wave8", "tile"])
def test_bf16_sweep_schedule_emulated(n, t, part_steps):
    """`sweep_mma_kernel`'s bf16 schedule emulated with its warps
    interleaved at random (`_sweep_emulated`, H 256: 8 warps) on a ragged
    fold (N 20: a second tile of 4 live rows) and a full one, in wave items
    of 1, 4 and 8 steps (ragged last items at T 11) and in the tile form: no
    warp leaves a barrier open, two interleavings give the same bits (no
    read of shared memory races a write), the wave form gives the tile
    form's dx, dgates and carries out bit for bit (the carries pass between
    items whole; the bias sums, an item's added to the tile's, may round
    otherwise), and dx, the dgates and the bias sums hold the plain sweep
    (`lstm2_bwd_reference` in bf16) at the bf16 floor."""
    params, fc, x, dy = _case(n, t, 34, 256, 2, seed=26)
    w = ops_lstm2.pack_weights(*_torch_tensors(params, fc, torch.bfloat16, requires_grad=False))
    xt, dyt = torch.tensor(x).bfloat16(), torch.tensor(dy)
    args, res = _emulation_args(dyt, xt, w)
    got = _sweep_emulated(*args, part_steps, np.random.default_rng(1))
    for a, b in zip(got, _sweep_emulated(*args, part_steps, np.random.default_rng(2))):
        np.testing.assert_array_equal(a, b)
    tile = _sweep_emulated(*args, None, np.random.default_rng(3))
    for i in (0, 1, 2, 4):  # the bias sums alone are added an item at a time
        np.testing.assert_array_equal(got[i], tile[i])
    ref = lt.lstm2_bwd_reference(dyt, xt, w, res)
    want = (ref.dx.permute(2, 0, 1), ref.dg1, ref.dg2, ref.db1, ref.db2)
    mine = (*got[:3], got[3][:, 0].sum(0), got[3][:, 1].sum(0))
    for a, b in zip(want, mine):
        assert _snr_db(a.float(), torch.from_numpy(np.ascontiguousarray(b))) >= 40.0


_FIXTURE_GEN = Path(__file__).parent / "fixtures" / "gen_torch_kernel_fixture.py"


@pytest.mark.parametrize("part_steps", [1, 2, 4, None], ids=["wave1", "wave2", "wave4", "tile"])
def test_bf16_sweep_schedule_emulated_holds_the_jax_fixture(part_steps):
    """The same emulation on the JAX fixture's bf16 training case (N 50: four
    tiles, the last of 2 live rows; T 7, D 34, H 64: two warps), the
    residuals from the plain forward: dx and the bias gradients hold the JAX
    kernels' (`stacked_lstm2_train` in interpret mode) at the bf16 floor, as
    K4 does on the card."""
    spec = importlib.util.spec_from_file_location("gen_torch_kernel_fixture", _FIXTURE_GEN)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    name = "train_bfloat16_dgates"
    want = gen.load_fixture()[name]
    x, dy, lstm, linear = gen.port_operands(name)
    args, _ = _emulation_args(dy, x, lstm.packed(linear))
    dx, _, _, db_part, _ = _sweep_emulated(*args, part_steps, np.random.default_rng(part_steps))
    got = {"dx": dx.transpose(1, 2, 0), "d_bias_ih_l0": db_part[:, 0].sum(0),
           "d_bias_ih_l1": db_part[:, 1].sum(0)}
    for key, value in got.items():
        assert _snr_db(torch.from_numpy(want[key]), torch.from_numpy(value)) >= 40.0, key


@pytest.mark.parametrize("dtype,hidden,d,o", [
    (torch.float32, 384, 34, 2), (torch.float32, 64, 34, 2), (torch.bfloat16, 384, 34, 2),
    (torch.bfloat16, 384, 32, 2), (torch.bfloat16, 64, 34, 2), (torch.bfloat16, 512, 257, 257)])
def test_reverse_sweep_shared_memory_by_hand(dtype, hidden, d, o):
    """`sweep_mma_kernel`'s shared memory in every dtype (one dgates tile
    [16][4H + pad], the d h1 and d h2 carries, the dy tile and, where they
    fit, the dx partials) against the bytes written out by hand, at the
    shipped sub-band shape, FullSubNet's sub-band (D 32) and full-band
    shapes and a narrow one: each fits a block."""
    size = torch.tensor([], dtype=dtype).element_size()
    row = size * 16 * (4 * hidden + 16 // size)  # a dgates tile
    ksplit = lt.bwd_dx_ksplit(16, d, hidden, o, dtype)
    partials = 4 * 16 * (hidden // 32) * (-(-d // 8) * 8) if ksplit else 0
    assert lt.bwd_shared_memory_bytes(16, d, hidden, o, dtype) == (
        row + 4 * 16 * (2 * hidden + o) + partials) <= ops_lstm2.SMEM_LIMIT == 232_448


def test_reverse_sweep_has_one_kernel():
    """The tile and wave forms run `sweep_mma_kernel` alone: the wgmma sweep
    and its switch are gone from the source and the wrapper, the launch
    takes no kernel code (the C entry points' int arguments match the
    wrappers' argtypes), and SWEEP_FORMS names forms only."""
    csrc = Path(lt.__file__).parent.parent / "csrc"
    sweep = (csrc / "lstm2_bwd_sweep.cuh").read_text()
    assert "sweep_wgmma_kernel" not in sweep and "KERNEL_WGMMA" not in sweep
    assert "int launch_sweep(const SweepArgs<T>& a, int rows, int form, int part_steps, " \
           "cudaStream_t stream)" in sweep
    assert not any(hasattr(lt, n) for n in ("force_sweep_kernel", "SWEEP_KERNEL", "SWEEP_KERNELS"))
    for stem, argtypes in (("lstm2_bwd", lt._BWD_ARGTYPES),
                           ("lstm2_bwd_wgrad", lt._WGRAD_ARGTYPES)):
        source = (csrc / f"{stem}.cu").read_text()
        signature = source[source.index(f'extern "C" int {stem}('):]
        signature = signature[:signature.index(")")]
        assert signature.count("int ") - 1 == argtypes.count(lt._INT), stem
        assert signature.count("void*") == argtypes.count(lt._PTR), stem
    assert [lt.sweep_form_name(f) for f in (0, lt.SWEEP_WAVE, 16)] == ["tile", "wave", "cluster16"]
