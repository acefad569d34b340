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
    """FUSED_WGRAD None: bf16 takes the fused K3 and float32 K4 with
    `weight_grads` (measured on the card); a dtype the kernels do not take
    keeps the JAX package's fused form; True or False overrides both."""
    assert lt.FUSED_WGRAD is None
    assert lt.fused_wgrad(torch.bfloat16) and not lt.fused_wgrad(torch.float32)
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
    memory in a block, and a dgates scratch that does not grow with T."""
    for n in (2304, 2056, 771):
        assert lt.mma_rows_per_cta(n, 132) == lt.MMA_ROWS_PER_CTA == 16
    for dtype in (torch.float32, torch.bfloat16):
        assert lt.bwd_shared_memory_bytes(16, 34, 384, 2, dtype) <= ops_lstm2.SMEM_LIMIT
    assert lt.fwd_shared_memory_bytes(16, 34, 384, 2) <= ops_lstm2.SMEM_LIMIT
    for steps in (1, 195, 10_000):
        chunk = lt.wgrad_chunk_steps(2304, 384, steps, 4)
        assert chunk == 1 and 2 * chunk * 2304 * 1536 * 4 <= lt.WGRAD_SCRATCH_BYTES
    assert lt.wgrad_chunk_steps(2304, 384, 195, 2) == 2
    assert lt.wgrad_chunk_steps(20, 16, 9, 4) == 9  # never more than T


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
    """The CTAs of a bf16 weight-gradient launch (the tiles `wgrad_tiles`
    picks, and each candidate) cover every element of dW1 [D, 4H] and dU1,
    dW2, dU2 [H, 4H] exactly once; dW1's tile has 48 rows (three m16 tiles),
    and at the training shape the grid fills a wave of the H100's 132 SMs."""
    w1_tile, h_tile = lt.wgrad_tiles(d, hidden)
    assert w1_tile == (48, 64) and h_tile == lt.WGRAD_H_TILES[0] == (64, 128)
    for shape in lt.WGRAD_H_TILES:
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
        assert len(_wgrad_blocks(d, hidden, h_tile, w1_tile)) >= 132
