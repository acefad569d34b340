"""The port's CUDA kernels K1-K5 on an NVIDIA GPU (every test skips without
one). Imports nothing of JAX, so it runs on a machine that has a card and
no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Each kernel is held against its plain PyTorch version on the same inputs
and against the JAX kernel's own outputs (interpret mode on the CPU),
committed in tests/fixtures/torch_kernel_fixture.npz, whose generator also
rebuilds the inputs and weights from numpy seeds. Floors: float32 80 dB,
bf16 and int8 40 dB (float32 differs by sum order and expf / tanhf only; in
bf16 single roundings of h, the residuals and the dgates flip and carry
through the recurrence). K2's y equals K1's bit for bit, the forward sweep
gives the same bits at both bf16 row tiles, and K3 equals itself on a
repeat, also over several chunks: in bf16 at every tile shape of its
tensor-core weight gradients, and in float32; K5 equals itself on a repeat
at both of its row tiles and runs FullSubNet's full-band shape (D 257, H
512, O 257). chip_smoke.py repeats these checks at the model's folds.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fullsubnet_plus_torch.nn.layers import Linear
from fullsubnet_plus_torch.nn.lstm import LSTM2
from fullsubnet_plus_torch.ops import lstm2 as ops_lstm2
from fullsubnet_plus_torch.ops import lstm2_int8 as ops_int8
from fullsubnet_plus_torch.ops import lstm2_train as lt

_GEN_PATH = os.path.join(os.path.dirname(__file__), "fixtures", "gen_torch_kernel_fixture.py")
_spec = importlib.util.spec_from_file_location("gen_torch_kernel_fixture", _GEN_PATH)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

FLOOR = {torch.float32: 80.0, torch.bfloat16: 40.0}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _snr(ref, out) -> float:
    ref, out = torch.as_tensor(ref).double(), torch.as_tensor(out).double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def _modules(d, h, o, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    lstm, linear = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    linear.reset_parameters(g)
    return lstm.to("cuda", dtype), linear.to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm2_kernel_matches_plain_on_cuda(rng, dtype):
    _need_card()
    n, t, d, h, o = 3 * 257, 37, 34, 384, 2
    lstm, linear = _modules(d, h, o, dtype)
    x = torch.from_numpy((0.5 * rng.standard_normal((n, d, t))).astype(np.float32))
    x = x.to("cuda", dtype)
    w = lstm.packed(linear)
    before = sum(ops_lstm2.LAUNCHES.values())
    out = ops_lstm2.lstm2_fc(x, w).float()
    torch.cuda.synchronize()
    assert sum(ops_lstm2.LAUNCHES.values()) == before + 1
    ref = ops_lstm2.lstm2_fc_reference(x, w).float()
    assert _snr(ref, out) > FLOOR[dtype], _snr(ref, out)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h,o", [(3 * 257, 37, 384, 2), (50, 9, 64, 11)])
def test_bf16_forward_row_tiles_agree_on_cuda(monkeypatch, n, t, h, o):
    """The tensor-core forward sweep at R 16 and R 32 gives the same bits
    (each row's sums run in the same order at either tile); O 11 takes two
    n-tiles of the fc."""
    _need_card()
    lstm, linear = _modules(34, h, o, torch.bfloat16, seed=1)
    x = torch.rand(n, 34, t, generator=torch.Generator().manual_seed(2)).mul(2).to(
        "cuda", torch.bfloat16)
    w = lstm.packed(linear)
    outs = []
    for rows in ops_lstm2.FWD_MMA_ROWS_PER_CTA[torch.bfloat16]:
        monkeypatch.setattr(ops_lstm2, "fwd_mma_rows_per_cta", lambda *_, r=rows: r)
        outs.append(ops_lstm2.lstm2_fc(x, w))
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], other) for other in outs[1:])
    assert _snr(ops_lstm2.lstm2_fc_reference(x, w).float(), outs[0].float()) > 40.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,h,o", [(3 * 257, 37, 384, 2), (50, 9, 64, 11), (37, 5, 512, 3)])
def test_float32_forward_on_tensor_cores_on_cuda(monkeypatch, n, t, h, o):
    """The float32 forward sweep, every product as three TF32 products on
    mma.sync, against the plain float32 version at 80 dB at ragged folds (H
    384; H 64 with O 11, two n-tiles of the fc; H 512, the 512-thread
    build), and K2's y equal to K1's bit for bit at its tile."""
    _need_card()
    lstm, linear = _modules(34, h, o, torch.float32, seed=4)
    x = torch.rand(n, 34, t, generator=torch.Generator().manual_seed(5)).mul(2).cuda()
    w = lstm.packed(linear)
    outs = []
    for rows in ops_lstm2.FWD_MMA_ROWS_PER_CTA[torch.float32]:
        monkeypatch.setattr(ops_lstm2, "fwd_mma_rows_per_cta", lambda *_, r=rows: r)
        outs.append(ops_lstm2.lstm2_fc(x, w))
        y2, _ = lt.lstm2_train_fwd(x, w)
        assert torch.equal(y2, outs[-1])
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], other) for other in outs[1:])
    assert _snr(ops_lstm2.lstm2_fc_reference(x, w), outs[0]) >= FLOOR[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_runs_the_fullsubnet_full_band_shape(dtype):
    """FullSubNet's full-band LSTM shape (D 257, H 512, O 257: x padded to
    272 float32 or 288 bf16 columns, the 512-thread build, 33 n-tiles of the
    fc over 16 warps) at R 16 on a small ragged fold, against the plain
    version (float32 80 dB, bf16 40 dB), and K2's y equal to K1's."""
    _need_card()
    lstm, linear = _modules(257, 512, 257, dtype, seed=6)
    x = torch.rand(11, 257, 9, generator=torch.Generator().manual_seed(7)).mul(2).to("cuda", dtype)
    w = lstm.packed(linear)
    out = ops_lstm2.lstm2_fc(x, w)
    y2, _ = lt.lstm2_train_fwd(x, w)
    torch.cuda.synchronize()
    assert out.shape == (11, 9, 257) and torch.isfinite(out.float()).all()
    assert torch.equal(y2, out)
    ref = ops_lstm2.lstm2_fc_reference(x, w).float()
    assert _snr(ref, out.float()) >= FLOOR[dtype], _snr(ref, out.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, None])
def test_forward_runs_the_fullsubnet_sub_band_shape(dtype):
    """FullSubNet's sub-band LSTM shape (D 32 = 31 neighbours + the
    full-band output, H 384, O 2: x padded to 32 columns in every dtype, so
    its k-loop takes a count FullSubNet+'s D 34 never gives) on a ragged fold:
    K1 in float32 (80 dB) and bf16 (40 dB) and K5 (dtype None, 40 dB)
    against the plain version, each equal to itself on a repeat."""
    _need_card()
    lstm, linear = _modules(32, 384, 2, dtype or torch.bfloat16, seed=8)
    x = torch.rand(3 * 257, 32, 37, generator=torch.Generator().manual_seed(9)).mul(2).to(
        "cuda", dtype or torch.bfloat16)
    if dtype is None:
        w, kernel, plain, floor = (lstm.prepare_int8(linear), ops_int8.lstm2_int8_fc,
                                   ops_int8.lstm2_int8_fc_reference, 40.0)
    else:
        w, kernel, plain, floor = (lstm.packed(linear), ops_lstm2.lstm2_fc,
                                   ops_lstm2.lstm2_fc_reference, FLOOR[dtype])
    out, again = kernel(x, w), kernel(x, w)
    torch.cuda.synchronize()
    assert out.shape == (3 * 257, 37, 2) and torch.equal(out, again)
    ref = plain(x, w).float()
    assert _snr(ref, out.float()) >= floor, _snr(ref, out.float())


def _int8_case(rng, n, t, d, h, o):
    g = torch.Generator().manual_seed(0)
    lstm, linear = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    linear.reset_parameters(g)
    w = lstm.to("cuda", torch.bfloat16).prepare_int8(linear.to("cuda", torch.bfloat16))
    x = torch.from_numpy((0.5 * rng.standard_normal((n, d, t))).astype(np.float32))
    return x.to("cuda", torch.bfloat16), w


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,rows", [(3 * 257, 37, 16), (100, 9, 16), (3 * 257, 37, 32),
                                      (45, 9, 32)])
def test_int8_kernel_matches_plain_on_cuda(rng, monkeypatch, n, t, rows):
    """K5 at each row tile (forced) against the plain version (40 dB), and
    equal to itself bit for bit on a repeat."""
    _need_card()
    x, w = _int8_case(rng, n, t, 34, 384, 2)
    monkeypatch.setattr(ops_int8, "int8_rows_per_cta", lambda *_: rows)
    before = sum(ops_int8.LAUNCHES.values())
    out = ops_int8.lstm2_int8_fc(x, w)
    again = ops_int8.lstm2_int8_fc(x, w)
    torch.cuda.synchronize()
    assert sum(ops_int8.LAUNCHES.values()) == before + 2
    assert torch.equal(out, again)
    ref = ops_int8.lstm2_int8_fc_reference(x, w).float()
    assert _snr(ref, out.float()) >= 40.0, _snr(ref, out.float())


@pytest.mark.cuda
def test_int8_kernel_runs_the_fullsubnet_full_band_shape(rng):
    """FullSubNet's full-band LSTM shape (D 257, H 512, O 257: 33 n-tiles of
    the fc over 16 warps) at R 16, on a small ragged fold, against the plain
    version (40 dB)."""
    _need_card()
    x, w = _int8_case(rng, 37, 7, 257, 512, 257)
    out = ops_int8.lstm2_int8_fc(x, w).float()
    torch.cuda.synchronize()
    assert out.shape == (37, 7, 257) and torch.isfinite(out).all()
    ref = ops_int8.lstm2_int8_fc_reference(x, w).float()
    assert _snr(ref, out) >= 40.0, _snr(ref, out)


def _case(n, t, d, h, o, seed=0):
    """torch.nn.LSTM's eight tensors and the Linear's two (uniform in
    +-1/sqrt(H), numpy seed), x [N, D, T] and the cotangent dy [N, T, O]."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)
    shapes = [(4 * h, d), (4 * h, h), (4 * h,), (4 * h,), (4 * h, h), (4 * h, h), (4 * h,),
              (4 * h,), (o, h), (o,)]
    tensors = [torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32))
               for s in shapes]
    x = (rng.standard_normal((n, d, t)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((n, t, o)).astype(np.float32)
    return tensors, x, dy


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,hidden", [(50, 7, 64), (37, 9, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_cuda(dtype, n, t, hidden):
    """The three training kernels against their plain versions at ragged
    folds (N not a multiple of the row tile, T odd; H 384 gives the sweeps
    their 12 warps): K2 (and its y equal to K1's), K4's dx and dgates against
    the plain sweep, K3 and K4 with their weight gradients, K3 equal to
    itself on a repeat."""
    _need_card()
    floor = FLOOR[dtype]
    tensors, x, dy = _case(n, t, 34, hidden, 2)
    w = ops_lstm2.pack_weights(*(p.to("cuda", dtype) for p in tensors))
    xt, dyt = torch.tensor(x).to("cuda", dtype), torch.tensor(dy).cuda()
    y_ref, res_ref = lt.lstm2_train_fwd_reference(xt, w)
    y, res = lt.lstm2_train_fwd(xt, w)
    assert min(_snr(a, b) for a, b in zip((y_ref, *res_ref), (y, *res))) >= floor
    assert torch.equal(y, ops_lstm2.lstm2_fc(xt, w))
    sweep = lt.lstm2_bwd_reference(dyt, xt, w, res_ref)
    got = lt.lstm2_bwd_sweep(dyt, xt, w, res_ref)
    assert min(_snr(a, b) for a, b in zip(sweep[:3], got[:3])) >= floor
    want = lt.LSTM2Grads(sweep.dx, *lt.weight_grads(xt, res_ref, sweep.dg1, sweep.dg2)[:4],
                         sweep.db1, sweep.db2)
    for fused in (True, False):
        got = lt.lstm2_bwd(dyt, xt, w, res_ref, fused=fused)
        assert min(_snr(a, b) for a, b in zip(want, got)) >= floor
    again = lt.lstm2_bwd(dyt, xt, w, res_ref, fused=True)
    got = lt.lstm2_bwd(dyt, xt, w, res_ref, fused=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, *range(len(lt.WGRAD_H_TILES))])
@pytest.mark.parametrize("hidden", [64, 384])
def test_bf16_wgrad_kernel_matches_plain_over_chunks(monkeypatch, hidden, tile):
    """K3 in bf16, whose weight gradients run on the tensor cores, against
    `lstm2_bwd_plain` with the scratch cut to 3 steps, so T = 7 runs chunks
    of 3, 3 and 1: N = 150 is a multiple of no tile (16, 32, 48, 64, 128),
    D = 34, at each tile shape of dU1, dW2, dU2 (None: the rule's); and
    equal to itself on a repeat."""
    _need_card()
    n, t = 150, 7
    tensors, x, dy = _case(n, t, 34, hidden, 2, seed=3)
    w = ops_lstm2.pack_weights(*(p.to("cuda", torch.bfloat16) for p in tensors))
    xt, dyt = torch.tensor(x).to("cuda", torch.bfloat16), torch.tensor(dy).cuda()
    _, res = lt.lstm2_train_fwd_reference(xt, w)
    monkeypatch.setattr(lt, "WGRAD_SCRATCH_BYTES", 3 * 2 * n * 4 * hidden * 2)
    assert lt.wgrad_chunk_steps(n, hidden, t, 2) == 3
    want = lt.lstm2_bwd_plain(dyt, xt, w, res, fused=True)
    before = lt.force_wgrad_tile(tile)
    try:
        got = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
        again = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
        torch.cuda.synchronize()
    finally:
        lt.force_wgrad_tile(before)
    snrs = {name: _snr(a.float(), b.float()) for name, a, b in zip(want._fields, want, got)}
    assert min(snrs.values()) >= FLOOR[torch.bfloat16], snrs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d,hidden", [(34, 64), (34, 384), (32, 512), (257, 512)])
def test_float32_wgrad_sweep_matches_plain_over_chunks(monkeypatch, d, hidden):
    """K3 in float32, whose reverse sweep runs its three products on the
    tensor cores as three TF32 products of split operands, against
    `lstm2_bwd_plain` with the scratch cut to 3 steps, so T = 7 runs chunks
    of 3, 3 and 1 (the sweep resumes twice from the carries in device
    memory): N = 150 is a multiple of no row tile; H 512 takes the
    512-thread build (D 32: its dx k-split partials still fit a block; D
    257, FullSubNet's full-band width: they do not, and dx is
    output-stationary). K4's sweep against the plain one too; K3 equal to
    itself on a repeat."""
    _need_card()
    n, t = 150, 7
    tensors, x, dy = _case(n, t, d, hidden, 2, seed=3)
    w = ops_lstm2.pack_weights(*(p.cuda() for p in tensors))
    xt, dyt = torch.tensor(x).cuda(), torch.tensor(dy).cuda()
    _, res = lt.lstm2_train_fwd_reference(xt, w)
    monkeypatch.setattr(lt, "WGRAD_SCRATCH_BYTES", 3 * 2 * n * 4 * hidden * 4)
    assert lt.wgrad_chunk_steps(n, hidden, t, 4) == 3
    want = lt.lstm2_bwd_plain(dyt, xt, w, res, fused=True)
    got = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    again = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    sweep = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    sweep_ref = lt.lstm2_bwd_reference(dyt, xt, w, res)
    torch.cuda.synchronize()
    snrs = {name: _snr(a, b) for name, a, b in zip(want._fields, want, got)}
    snrs.update({f"k4_{name}": _snr(a, b) for name, a, b in
                 zip(("dx", "dg1", "dg2"), sweep_ref[:3], sweep[:3])})
    assert min(snrs.values()) >= FLOOR[torch.float32], snrs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(gen.CASES))
def test_kernel_matches_jax_fixture(name):
    """Each kernel through the port's entry points against the JAX kernel's
    outputs in the committed fixture: K1 (`lstm2_fc`), K5 (`lstm2_int8_fc`),
    and K2 with K3 or K4 (`lstm2_fc_train` and autograd, by `FUSED_WGRAD`)."""
    _need_card()
    kernel, *_, dtype, _, fused = gen.CASES[name]
    counts = {"k1": lambda: sum(ops_lstm2.LAUNCHES.values()),
              "k5": lambda: sum(ops_int8.LAUNCHES.values()),
              "train": lambda: (lt.LAUNCHES["lstm2_train_fwd"],
                                lt.LAUNCHES["lstm2_bwd_wgrad" if fused else "lstm2_bwd"])}[kernel]
    before = counts()
    got = gen.port_run(name, "cuda")
    after = counts()
    assert (np.asarray(after) - np.asarray(before) == 1).all(), (before, after)
    want = gen.load_fixture()[name]
    floor = FLOOR[getattr(torch, dtype)] if kernel != "k5" else 40.0
    snrs = {key: _snr(want[key], got[key]) for key in want}
    assert min(snrs.values()) >= floor, snrs
