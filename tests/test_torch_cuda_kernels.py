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
repeat, also over several chunks, at every tile shape of its tensor-core
weight gradients in both dtypes (float32 as 3xTF32; on mma.sync and on
wgmma), and its float32 weight gradients are the same bits at two scratch
sizes, as are those of the wgmma kernels in both dtypes; K5 equals itself on a repeat
at both of its row tiles and runs FullSubNet's full-band shape (D 257, H
512, O 257). At that shape the forward and reverse sweeps and K5 take their
cluster forms, held to the plain versions and to their tile forms (K1, K2
and K5 at several folds, in waves of clusters; K3 and K4 over chunks, in
waves and with one CTA's sends made late), and a cluster launch at a shape
the kernel does not run raises. The reverse and forward sweeps' wave forms
(work items of a row tile and a few steps, launched in waves of a CTA an
SM) equal their tile forms bit for bit, and a wave launch at a shape it
does not run raises. The forward's bf16 pair form (a cluster of two CTAs a
32-row tile, in one launch and in waves) equals the R 32 tile form bit for
bit in K1 and K2, and a pair launch at a shape it does not run raises.
chip_smoke.py repeats these checks at the model's folds.
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
    272 float32 or 288 bf16 columns, 33 n-tiles of the fc) on a small
    ragged fold in the form the rule takes (the cluster form), against the
    plain version (float32 80 dB, bf16 40 dB), and K2's y equal to K1's."""
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
    the fc) on a small ragged fold, in the form the rule takes there (the
    cluster form: 3 clusters of 16), against the plain version (40 dB)."""
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
    monkeypatch.setitem(lt.WGRAD_SCRATCH_BYTES, torch.bfloat16, 3 * 2 * n * 4 * hidden * 2)
    assert lt.wgrad_chunk_steps(n, hidden, t, torch.bfloat16) == 3
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
@pytest.mark.parametrize("tile", [None, *range(len(lt.WGRAD_F32_TILES))])
@pytest.mark.parametrize("d,hidden", [(34, 64), (34, 384), (32, 512), (257, 512)])
def test_float32_wgrad_sweep_matches_plain_over_chunks(monkeypatch, d, hidden, tile):
    """K3 in float32, whose reverse sweep runs its three products and whose
    weight-gradient kernel its four on the tensor cores as three TF32
    products of split operands, against `lstm2_bwd_plain` with the scratch
    cut to 3 steps, so T = 7 runs chunks of 3, 3 and 1 (the sweep resumes
    twice from the carries in device memory), at each tile of dU1, dW2, dU2
    (None: the rule's): N = 150 is a multiple of no row tile or slice; D 34
    and 257 pad x to 36 and 260 columns; H 512 takes the 512-thread build
    (D 32: its dx k-split partials still fit a block; D 257, FullSubNet's
    full-band width: they do not, and dx is output-stationary). K4's sweep
    against the plain one too; K3 equal to itself on a repeat."""
    _need_card()
    n, t = 150, 7
    tensors, x, dy = _case(n, t, d, hidden, 2, seed=3)
    w = ops_lstm2.pack_weights(*(p.cuda() for p in tensors))
    xt, dyt = torch.tensor(x).cuda(), torch.tensor(dy).cuda()
    _, res = lt.lstm2_train_fwd_reference(xt, w)
    monkeypatch.setitem(lt.WGRAD_SCRATCH_BYTES, torch.float32, 3 * 2 * n * 4 * hidden * 4)
    assert lt.wgrad_chunk_steps(n, hidden, t, torch.float32) == 3
    want = lt.lstm2_bwd_plain(dyt, xt, w, res, fused=True)
    before = lt.force_wgrad_tile(tile, torch.float32)
    try:
        got = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
        again = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
        torch.cuda.synchronize()
    finally:
        lt.force_wgrad_tile(before, torch.float32)
    sweep = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    sweep_ref = lt.lstm2_bwd_reference(dyt, xt, w, res)
    torch.cuda.synchronize()
    snrs = {name: _snr(a, b) for name, a, b in zip(want._fields, want, got)}
    snrs.update({f"k4_{name}": _snr(a, b) for name, a, b in
                 zip(("dx", "dg1", "dg2"), sweep_ref[:3], sweep[:3])})
    assert min(snrs.values()) >= FLOOR[torch.float32], snrs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d,hidden", [(34, 384), (257, 512)])
def test_float32_wgrad_same_bits_at_two_scratch_sizes(monkeypatch, d, hidden):
    """The chunk does not change the order of a weight-gradient sum (each
    reads, adds and writes its float32 accumulators in the same order at any
    chunk; the carries between sweeps are float32): float32 K3 with the
    scratch holding 2 steps and 5 steps (T 9: chunks 2, 2, 2, 2, 1 and 5, 4)
    gives dx, dW1, dU1, dW2 and dU2 bit for bit. The bias sums are summed in
    registers over each sweep's steps before they are added to the tile's
    row (lstm2_bwd_sweep.cuh), so their grouping follows the chunk: they
    agree to float32 rounding (>= 100 dB)."""
    _need_card()
    n, t = 150, 9
    tensors, x, dy = _case(n, t, d, hidden, 2, seed=6)
    w = ops_lstm2.pack_weights(*(p.cuda() for p in tensors))
    xt, dyt = torch.tensor(x).cuda(), torch.tensor(dy).cuda()
    _, res = lt.lstm2_train_fwd_reference(xt, w)
    outs = []
    for steps in (2, 5):
        monkeypatch.setitem(lt.WGRAD_SCRATCH_BYTES, torch.float32,
                            steps * 2 * n * 4 * hidden * 4)
        assert lt.wgrad_chunk_steps(n, hidden, t, torch.float32) == steps
        outs.append(lt.lstm2_bwd(dyt, xt, w, res, fused=True))
    torch.cuda.synchronize()
    a, b = outs
    for name in ("dx", "dw1", "du1", "dw2", "du2"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert min(_snr(a.db1, b.db1), _snr(a.db2, b.db2)) >= 100.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile", [
    *((torch.bfloat16, i) for i, shape in enumerate(lt.WGRAD_H_TILES) if lt.wgmma_tile(shape)),
    *((torch.float32, i) for i, shape in enumerate(lt.WGRAD_F32_TILES) if lt.wgmma_tile(shape))])
def test_wgmma_wgrad_same_bits_at_two_scratch_sizes(monkeypatch, dtype, tile):
    """K3's weight gradients on wgmma (`wgrad_wgmma_kernel` in bf16,
    `wgrad_wgmma_tf32_kernel` in float32), forced at each wgmma tile: each
    run of row slices keeps its partial across chunks and the runs are
    added in run order after the last, so the scratch holding 2 and 5 steps
    (T 9: chunks 2, 2, 2, 2, 1 and 5, 4) gives dW1, dU1, dW2 and dU2 bit for
    bit (N 150 ragged, D 34, H 384, the t = 0 step of dU1 and dU2 skipped);
    K3 is equal on a repeat and at the dtype's floor against
    `lstm2_bwd_plain`; the launches count the forced tile."""
    _need_card()
    n, t, hidden = 150, 9, 384
    tensors, x, dy = _case(n, t, 34, hidden, 2, seed=7)
    w = ops_lstm2.pack_weights(*(p.to("cuda", dtype) for p in tensors))
    xt, dyt = torch.tensor(x).to("cuda", dtype), torch.tensor(dy).cuda()
    _, res = lt.lstm2_train_fwd_reference(xt, w)
    want = lt.lstm2_bwd_plain(dyt, xt, w, res, fused=True)
    size = torch.tensor([], dtype=dtype).element_size()
    shape = (lt.WGRAD_F32_TILES if dtype == torch.float32 else lt.WGRAD_H_TILES)[tile]
    lt.WGRAD_TILES.clear()
    before = lt.force_wgrad_tile(tile, dtype)
    outs = []
    try:
        for steps in (2, 5, 5):
            for budget in (lt.WGRAD_SCRATCH_BYTES, lt.WAVE_SCRATCH_BYTES):
                monkeypatch.setitem(budget, dtype, steps * 2 * n * 4 * hidden * size)
            assert lt.wgrad_chunk_steps(n, hidden, t, dtype) == steps
            outs.append(lt.lstm2_bwd(dyt, xt, w, res, fused=True))
        torch.cuda.synchronize()
    finally:
        lt.force_wgrad_tile(before, dtype)
    assert dict(lt.WGRAD_TILES) == {f"lstm2_bwd_wgrad {'x'.join(map(str, shape))}": 3}
    a, b, again = outs
    for name in ("dw1", "du1", "dw2", "du2"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert all(torch.equal(u, v) for u, v in zip(b, again))
    snrs = {name: _snr(u.float(), v.float()) for name, u, v in zip(want._fields, want, b)}
    assert min(snrs.values()) >= FLOOR[dtype], snrs


FB = (257, 512, 257)  # FullSubNet's full-band LSTM: D, H, O


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(8, 9), (18, 9), (112, 5), (256, 3), (7, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_cluster_form_matches_plain_and_tile_on_cuda(monkeypatch, dtype, n, t):
    """The forward sweep's cluster form at FullSubNet's full-band shape (N 8
    a batch, 18 training, 112 seven clusters, 256 sixteen: more than the
    H100 holds at once, so they run in waves; T ragged): the rule takes it,
    K1's y and K2's y and residuals agree with the plain versions and with
    the tile form forced (FWD_SWEEP_FORM 0) at the floors, K2's y equals
    K1's bit for bit, K1 equals itself on a repeat, and each launch is
    counted by its form."""
    _need_card()
    assert ops_lstm2.fwd_sweep_cluster(n, *FB, dtype) == 16
    lstm, linear = _modules(*FB, dtype, seed=n)
    x = torch.rand(n, FB[0], t, generator=torch.Generator().manual_seed(t)).mul(2).to("cuda", dtype)
    w = lstm.packed(linear)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORMS", type(ops_lstm2.FWD_SWEEP_FORMS)())
    y, again = ops_lstm2.lstm2_fc(x, w), ops_lstm2.lstm2_fc(x, w)
    y2, res = lt.lstm2_train_fwd(x, w)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", 0)
    tile = ops_lstm2.lstm2_fc(x, w)
    y2_tile, res_tile = lt.lstm2_train_fwd(x, w)
    torch.cuda.synchronize()
    assert ops_lstm2.FWD_SWEEP_FORMS == {"lstm2_fwd cluster16": 2, "lstm2_train_fwd cluster16": 1,
                                         "lstm2_fwd tile": 1, "lstm2_train_fwd tile": 1}
    assert torch.equal(y, again) and torch.equal(y, y2) and torch.equal(tile, y2_tile)
    y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
    snrs = {"y": _snr(y_ref.float(), y.float()), "y_vs_tile": _snr(tile.float(), y.float())}
    snrs.update({name: _snr(a.float(), b.float()) for name, a, b in zip(res._fields, res_ref, res)})
    snrs.update({f"{name}_vs_tile": _snr(a.float(), b.float())
                 for name, a, b in zip(res._fields, res_tile, res)})
    assert min(snrs.values()) >= FLOOR[dtype], snrs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_cluster_form_refuses_a_shape_it_does_not_run(monkeypatch, dtype):
    """The cluster form forced at FullSubNet+'s sub-band shape (H 384, not
    16 x 32): the kernel refuses the launch (`fwd::cluster_runs`) and K1 and
    K2 raise, naming the form; nothing is launched or counted, and no path
    falls back to the tile form."""
    _need_card()
    lstm, linear = _modules(34, 384, 2, dtype, seed=3)
    x = torch.rand(20, 34, 4, generator=torch.Generator().manual_seed(3)).to("cuda", dtype)
    w = lstm.packed(linear)
    assert ops_lstm2.fwd_sweep_cluster(20, 34, 384, 2, dtype) == 0
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", 16)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORMS", type(ops_lstm2.FWD_SWEEP_FORMS)())
    before = (sum(ops_lstm2.LAUNCHES.values()), lt.LAUNCHES["lstm2_train_fwd"])
    with pytest.raises(RuntimeError, match="cluster form, clusters of 16"):
        ops_lstm2.lstm2_fc(x, w)
    with pytest.raises(RuntimeError, match="cluster form, clusters of 16"):
        lt.lstm2_train_fwd(x, w)
    torch.cuda.synchronize()
    assert (sum(ops_lstm2.LAUNCHES.values()), lt.LAUNCHES["lstm2_train_fwd"]) == before
    assert not ops_lstm2.FWD_SWEEP_FORMS


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(8, 9), (18, 9), (7, 13), (112, 5), (256, 3)])
def test_int8_cluster_form_matches_plain_and_tile_on_cuda(rng, monkeypatch, n, t):
    """K5's cluster form at FullSubNet's full-band shape (N 8 a batch and the
    daemon's 8 slots, 18 two tiles, 7 the fixture's, 112 seven clusters, 256
    sixteen: more than the H100 holds at once, so they run in waves; T
    ragged): the rule takes it, its y agrees with the plain version and with
    the tile form forced (INT8_SWEEP_FORM 0) at 40 dB, equals itself on a
    repeat, and each launch is counted by its form."""
    _need_card()
    assert ops_int8.int8_sweep_cluster(n, *FB) == 16
    x, w = _int8_case(rng, n, t, *FB)
    monkeypatch.setattr(ops_int8, "INT8_SWEEP_FORMS", type(ops_int8.INT8_SWEEP_FORMS)())
    before = sum(ops_int8.LAUNCHES.values())
    y, again = ops_int8.lstm2_int8_fc(x, w), ops_int8.lstm2_int8_fc(x, w)
    monkeypatch.setattr(ops_int8, "INT8_SWEEP_FORM", 0)
    tile = ops_int8.lstm2_int8_fc(x, w)
    torch.cuda.synchronize()
    assert ops_int8.INT8_SWEEP_FORMS == {"lstm2_int8_fwd cluster16": 2, "lstm2_int8_fwd tile": 1}
    assert sum(ops_int8.LAUNCHES.values()) == before + 3
    assert y.shape == (n, t, FB[2]) and torch.equal(y, again)
    ref = ops_int8.lstm2_int8_fc_reference(x, w).float()
    snrs = {"plain": _snr(ref, y.float()), "tile": _snr(tile.float(), y.float())}
    assert min(snrs.values()) >= 40.0, snrs


@pytest.mark.cuda
def test_int8_cluster_form_refuses_a_shape_it_does_not_run(rng, monkeypatch):
    """K5's cluster form forced at FullSubNet+'s sub-band shape (H 384, not
    16 x 32): the kernel refuses the launch (`cluster_runs` in the .cu) and
    the wrapper raises, naming the form; nothing is launched or counted, and
    no path falls back to the tile form."""
    _need_card()
    x, w = _int8_case(rng, 20, 4, 34, 384, 2)
    assert ops_int8.int8_sweep_cluster(20, 34, 384, 2) == 0
    monkeypatch.setattr(ops_int8, "INT8_SWEEP_FORM", 16)
    monkeypatch.setattr(ops_int8, "INT8_SWEEP_FORMS", type(ops_int8.INT8_SWEEP_FORMS)())
    before = sum(ops_int8.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="cluster form, clusters of 16"):
        ops_int8.lstm2_int8_fc(x, w)
    torch.cuda.synchronize()
    assert sum(ops_int8.LAUNCHES.values()) == before
    assert not ops_int8.INT8_SWEEP_FORMS


def _fb_case(n, t, dtype, seed):
    tensors, x, dy = _case(n, t, *FB, seed=seed)
    w = ops_lstm2.pack_weights(*(p.to("cuda", dtype) for p in tensors))
    xt, dyt = torch.tensor(x).to("cuda", dtype), torch.tensor(dy).cuda()
    return xt, dyt, w, lt.lstm2_train_fwd_reference(xt, w)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [18, 9, 7, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_sweep_matches_plain_and_tile_on_cuda(monkeypatch, dtype, n):
    """The reverse sweep's cluster form at FullSubNet's full-band shape, T 9
    (N 256: 16 clusters of 16, more than the H100 holds at once, so they run
    in waves): the rule takes it (clusters of 16), K4's dx and dgates and
    K3's gradients agree with the plain versions and with the tile form
    forced (SWEEP_FORM 0) at the floors, each launch counted by its form, and
    K3 equals itself on a repeat."""
    _need_card()
    xt, dyt, w, res = _fb_case(n, 9, dtype, seed=n)
    assert lt.bwd_sweep_cluster(n, *FB, dtype) == 16
    monkeypatch.setattr(lt, "SWEEP_FORMS", type(lt.SWEEP_FORMS)())
    got = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    k3 = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    again = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    monkeypatch.setattr(lt, "SWEEP_FORM", 0)
    tile = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    k3_tile = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    torch.cuda.synchronize()
    assert lt.SWEEP_FORMS == {"lstm2_bwd cluster16": 1, "lstm2_bwd_wgrad cluster16": 2,
                              "lstm2_bwd tile": 1, "lstm2_bwd_wgrad tile": 1}
    floor = FLOOR[dtype]
    ref = lt.lstm2_bwd_reference(dyt, xt, w, res)
    want = lt.lstm2_bwd_plain(dyt, xt, w, res, fused=True)
    snrs = {f"k4_{k}": _snr(a.float(), b.float()) for k, a, b in zip(("dx", "dg1", "dg2"), ref, got)}
    snrs.update({f"k3_{k}": _snr(a.float(), b.float()) for k, a, b in zip(want._fields, want, k3)})
    snrs.update({f"tile_k4_{k}": _snr(a.float(), b.float())
                 for k, a, b in zip(("dx", "dg1", "dg2"), tile, got)})
    snrs.update({f"tile_k3_{k}": _snr(a.float(), b.float())
                 for k, a, b in zip(want._fields, k3_tile, k3)})
    assert min(snrs.values()) >= floor, snrs
    assert all(torch.equal(a, b) for a, b in zip(k3, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_sweep_resumes_over_chunks(monkeypatch, dtype):
    """K3 in the cluster form over two chunks of steps (the scratch cut to 5
    steps, so T 9 runs 5 then 4: the second sweep resumes from the carries
    and adds to the bias sums in device memory) against `lstm2_bwd_plain`,
    and equal to itself on a repeat."""
    _need_card()
    n, t = 18, 9
    xt, dyt, w, res = _fb_case(n, t, dtype, seed=4)
    size = xt.element_size()
    monkeypatch.setitem(lt.WGRAD_SCRATCH_BYTES, dtype, 5 * 2 * n * 4 * FB[1] * size)
    assert lt.wgrad_chunk_steps(n, FB[1], t, dtype) == 5
    monkeypatch.setattr(lt, "SWEEP_FORMS", type(lt.SWEEP_FORMS)())
    want = lt.lstm2_bwd_plain(dyt, xt, w, res, fused=True)
    got = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    again = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    torch.cuda.synchronize()
    assert lt.SWEEP_FORMS == {"lstm2_bwd_wgrad cluster16": 2}
    snrs = {name: _snr(a.float(), b.float()) for name, a, b in zip(want._fields, want, got)}
    assert min(snrs.values()) >= FLOOR[dtype], snrs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_sweep_late_sends(monkeypatch, dtype):
    """K4's cluster form at N 18, T 195 with rank 0 of each cluster sending
    its dgates only after its own products (SWEEP_LATE_SENDS), so its copies
    still read its block when its threads reach the next cell backward:
    they must wait for the copies (`Exchange::sent`). The outputs equal the
    usual order's bit for bit and hold `lstm2_bwd_reference` at the floor."""
    _need_card()
    xt, dyt, w, res = _fb_case(18, 195, dtype, seed=5)
    got = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    monkeypatch.setattr(lt, "SWEEP_LATE_SENDS", 1)
    monkeypatch.setattr(lt, "SWEEP_FORMS", type(lt.SWEEP_FORMS)())
    late = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    torch.cuda.synchronize()
    assert lt.SWEEP_FORMS == {"lstm2_bwd cluster16": 1}
    assert all(torch.equal(a, b) for a, b in zip(got[:3], late[:3]))
    ref = lt.lstm2_bwd_reference(dyt, xt, w, res)
    snrs = {k: _snr(a.float(), b.float()) for k, a, b in zip(("dx", "dg1", "dg2"), ref, late)}
    assert min(snrs.values()) >= FLOOR[dtype], snrs


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


@pytest.mark.cuda
@pytest.mark.parametrize("pk", [1, 4])
@pytest.mark.parametrize("n,d", [(40, 34), (771, 34), (2304, 34), (771, 32), (2304, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wave_sweep_matches_plain_and_tile_on_cuda(monkeypatch, dtype, n, d, pk):
    """The reverse sweep's wave form (H 384, T 9, items of pk steps) at
    ragged folds, at D 34 and at FullSubNet's sub-band D 32: the rule takes
    it at N 2304 (144 row tiles on a card of fewer SMs), and it is forced at
    the smaller folds; K4's dx and dgates against the plain sweep and K3's
    gradients against `lstm2_bwd_plain` at the floors, K3 at two scratch
    sizes (2 steps, so each sweep but the first resumes from the carries,
    and all 9) with the same dx and weight gradients bit for bit, K3 and K4
    equal to themselves on a repeat. An item runs the tile form's steps from
    the carries in device memory, so K4's outputs and K3's dx and weight
    gradients equal the tile form forced (SWEEP_FORM 0) bit for bit; K3's
    bias sums, grouped by item, agree to float32 rounding."""
    _need_card()
    t, hidden = 9, 384
    tensors, x, dy = _case(n, t, d, hidden, 2, seed=n + d)
    w = ops_lstm2.pack_weights(*(p.to("cuda", dtype) for p in tensors))
    xt, dyt = torch.tensor(x).to("cuda", dtype), torch.tensor(dy).cuda()
    _, res = lt.lstm2_train_fwd_reference(xt, w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (lt.bwd_sweep_form(n, d, hidden, 2, dtype, sms) == lt.SWEEP_WAVE) == (n > 16 * sms)
    monkeypatch.setattr(lt, "SWEEP_FORM", lt.SWEEP_WAVE)
    monkeypatch.setattr(lt, "WAVE_STEPS", pk)
    monkeypatch.setattr(lt, "SWEEP_FORMS", type(lt.SWEEP_FORMS)())
    got = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    again = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    k3 = []
    for steps in (2, t, t):
        monkeypatch.setitem(lt.WAVE_SCRATCH_BYTES, dtype,
                            steps * 2 * n * 4 * hidden * xt.element_size())
        assert lt.wgrad_chunk_steps(n, hidden, t, dtype, wave=True) == steps
        k3.append(lt.lstm2_bwd(dyt, xt, w, res, fused=True))
    monkeypatch.setattr(lt, "SWEEP_FORM", 0)
    tile = lt.lstm2_bwd_sweep(dyt, xt, w, res)
    k3_tile = lt.lstm2_bwd(dyt, xt, w, res, fused=True)
    torch.cuda.synchronize()
    assert lt.SWEEP_FORMS == {"lstm2_bwd wave": 2, "lstm2_bwd_wgrad wave": 3,
                              "lstm2_bwd tile": 1, "lstm2_bwd_wgrad tile": 1}
    ref = lt.lstm2_bwd_reference(dyt, xt, w, res)
    want = lt.lstm2_bwd_plain(dyt, xt, w, res, fused=True)
    snrs = {f"k4_{k}": _snr(a.float(), b.float()) for k, a, b in zip(("dx", "dg1", "dg2"), ref, got)}
    for i, grads in enumerate(k3[:2]):
        snrs.update({f"k3_{i}_{k}": _snr(a.float(), b.float())
                     for k, a, b in zip(want._fields, want, grads)})
    assert min(snrs.values()) >= FLOOR[dtype], snrs
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    assert all(torch.equal(a, b) for a, b in zip(got[:3], tile[:3]))
    assert all(torch.equal(a, b) for a, b in zip(k3[1], k3[2]))
    for name in ("dx", "dw1", "du1", "dw2", "du2"):  # the bias sums are grouped by item
        assert torch.equal(getattr(k3[0], name), getattr(k3[1], name)), name
        assert torch.equal(getattr(k3[1], name), getattr(k3_tile, name)), name
    assert min(_snr(k3_tile.db1, k3[1].db1), _snr(k3_tile.db2, k3[1].db2)) >= 100.0


@pytest.mark.cuda
@pytest.mark.parametrize("pk", [1, 4])
@pytest.mark.parametrize("n", [40, 771, 2304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_wave_form_matches_plain_and_tile_on_cuda(monkeypatch, dtype, n, pk):
    """The forward sweep's wave form (H 384, D 34, T 9, items of pk steps, so
    at 4 the last part is ragged) at folds of 3, 49 and 144 row tiles: the
    rule takes it at N 2304 where FWD_WAVE_BY_DTYPE holds and the card has
    fewer SMs than tiles, and it is forced elsewhere. K1's y and K2's y and
    six residuals equal the tile form forced (FWD_SWEEP_FORM 0, at its own
    row tile: R 32 in bf16 at N 2304) bit for bit, and in bf16 the wave form
    at R 32 too; they hold the floors against the plain versions; K1 equals
    itself on a repeat and K2's y equals K1's; each launch is counted by its
    form."""
    _need_card()
    t = 9
    lstm, linear = _modules(34, 384, 2, dtype, seed=n + pk)
    x = torch.rand(n, 34, t, generator=torch.Generator().manual_seed(n)).mul(2).to("cuda", dtype)
    w = lstm.packed(linear)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule_wave = ops_lstm2.FWD_WAVE_BY_DTYPE[dtype] and -(-n // 16) > sms
    assert (ops_lstm2.fwd_sweep_plan(n, 34, 384, 2, dtype, sms)[0] == 1) == rule_wave
    monkeypatch.setattr(ops_lstm2, "FWD_WAVE_STEPS", pk)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORMS", type(ops_lstm2.FWD_SWEEP_FORMS)())
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", ops_lstm2.FWD_SWEEP_WAVE)
    y, again = ops_lstm2.lstm2_fc(x, w), ops_lstm2.lstm2_fc(x, w)
    y2, res = lt.lstm2_train_fwd(x, w)
    waves = []
    if dtype == torch.bfloat16:
        monkeypatch.setattr(ops_lstm2, "FWD_WAVE_ROWS", 32)
        waves = [ops_lstm2.lstm2_fc(x, w), lt.lstm2_train_fwd(x, w)]
        monkeypatch.setattr(ops_lstm2, "FWD_WAVE_ROWS", 16)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", 0)
    tile = ops_lstm2.lstm2_fc(x, w)
    y2_tile, res_tile = lt.lstm2_train_fwd(x, w)
    torch.cuda.synchronize()
    wave_k1, wave_k2 = (3, 2) if waves else (2, 1)
    assert ops_lstm2.FWD_SWEEP_FORMS == {"lstm2_fwd wave": wave_k1, "lstm2_train_fwd wave": wave_k2,
                                         "lstm2_fwd tile": 1, "lstm2_train_fwd tile": 1}
    assert torch.equal(y, again) and torch.equal(y, y2) and torch.equal(y, tile)
    assert torch.equal(y2_tile, tile)
    assert all(torch.equal(a, b) for a, b in zip(res, res_tile))
    if waves:
        assert torch.equal(waves[0], y) and torch.equal(waves[1][0], y)
        assert all(torch.equal(a, b) for a, b in zip(waves[1][1], res))
    y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
    snrs = {"y": _snr(y_ref.float(), y.float())}
    snrs.update({name: _snr(a.float(), b.float()) for name, a, b in zip(res._fields, res_ref, res)})
    assert min(snrs.values()) >= FLOOR[dtype], snrs


@pytest.mark.cuda
def test_fwd_wave_form_refuses_a_shape_it_does_not_run(monkeypatch):
    """The wave form forced where its row tile does not fit a block (float32
    at D 512, H 512): K1's launch is refused by the kernel's launcher and
    raises, naming the wave form; K2 raises at its shape check; nothing is
    launched or counted, and nothing falls back to another form."""
    _need_card()
    lstm, linear = _modules(512, 512, 2, torch.float32, seed=9)
    x = torch.rand(40, 512, 3, generator=torch.Generator().manual_seed(9)).cuda()
    w = lstm.packed(linear)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", ops_lstm2.FWD_SWEEP_WAVE)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORMS", type(ops_lstm2.FWD_SWEEP_FORMS)())
    before = (sum(ops_lstm2.LAUNCHES.values()), lt.LAUNCHES["lstm2_train_fwd"])
    with pytest.raises(RuntimeError, match="wave form"):
        ops_lstm2.lstm2_fc(x, w)
    with pytest.raises(ValueError, match="more shared memory"):
        lt.lstm2_train_fwd(x, w)
    torch.cuda.synchronize()
    assert (sum(ops_lstm2.LAUNCHES.values()), lt.LAUNCHES["lstm2_train_fwd"]) == before
    assert not ops_lstm2.FWD_SWEEP_FORMS


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d,h,o,pk", [
    (40, 9, 34, 384, 2, 1), (771, 9, 34, 384, 2, 4), (2304, 9, 34, 384, 2, 4),
    (2304, 7, 32, 384, 2, 4), (50, 9, 34, 64, 11, 2), (70, 5, 34, 512, 11, 4)])
def test_fwd_pair_form_matches_plain_and_tile_on_cuda(monkeypatch, n, t, d, h, o, pk):
    """The forward sweep's bf16 pair form (a cluster of two CTAs a 32-row
    tile, each owning half the units) in one launch and in waves (items of
    pk steps, so the last part may be ragged; at N 2304, 72 pairs, more
    than a wave holds) at D 34 and FullSubNet's D 32, H 384, 64 (two warps a
    CTA) and 512 (O 11: the fc's two n-tiles on both ranks): K1's y and K2's
    y and six residuals equal the R 32 tile form forced bit for bit in both,
    they hold 40 dB against the plain versions, K1 equals itself on a repeat
    and K2's y equals K1's; each launch is counted by its form."""
    _need_card()
    dtype = torch.bfloat16
    lstm, linear = _modules(d, h, o, dtype, seed=n + h)
    x = torch.rand(n, d, t, generator=torch.Generator().manual_seed(n)).mul(2).to("cuda", dtype)
    w = lstm.packed(linear)
    monkeypatch.setattr(ops_lstm2, "FWD_WAVE_STEPS", pk)
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORMS", type(ops_lstm2.FWD_SWEEP_FORMS)())
    runs = {}
    for form in (ops_lstm2.FWD_PAIR, ops_lstm2.FWD_PAIR_WAVE):
        monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", form)
        runs[form] = (ops_lstm2.lstm2_fc(x, w), ops_lstm2.lstm2_fc(x, w), lt.lstm2_train_fwd(x, w))
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", 0)
    monkeypatch.setattr(ops_lstm2, "fwd_mma_rows_per_cta", lambda *_: 32)
    tile = ops_lstm2.lstm2_fc(x, w)
    y2_tile, res_tile = lt.lstm2_train_fwd(x, w)
    torch.cuda.synchronize()
    assert ops_lstm2.FWD_SWEEP_FORMS == {
        "lstm2_fwd pair": 2, "lstm2_train_fwd pair": 1, "lstm2_fwd pair wave": 2,
        "lstm2_train_fwd pair wave": 1, "lstm2_fwd tile": 1, "lstm2_train_fwd tile": 1}
    assert torch.equal(y2_tile, tile)
    for form, (y, again, (y2, res)) in runs.items():
        assert torch.equal(y, again) and torch.equal(y, y2) and torch.equal(y, tile), form
        assert all(torch.equal(a, b) for a, b in zip(res, res_tile)), form
    y, _, (_, res) = runs[ops_lstm2.FWD_PAIR_WAVE]
    y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
    snrs = {"y": _snr(y_ref.float(), y.float())}
    snrs.update({name: _snr(a.float(), b.float()) for name, a, b in zip(res._fields, res_ref, res)})
    assert min(snrs.values()) >= FLOOR[dtype], snrs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,h", [(torch.float32, 34, 384), (torch.bfloat16, 257, 512)])
def test_fwd_pair_form_refuses_a_shape_it_does_not_run(monkeypatch, dtype, d, h):
    """The pair form forced where it does not run (float32, which it was
    not built for; bf16 at D 257, H 512, whose two operand buffers of 32
    rows and c words take 234,496 bytes, past a block): K1's and K2's
    launches are refused by the kernel's launcher and raise, naming the pair
    form, in one launch and in waves; nothing is launched or counted, and
    nothing falls back to another form."""
    _need_card()
    lstm, linear = _modules(d, h, 2, dtype, seed=3)
    x = torch.rand(40, d, 3, generator=torch.Generator().manual_seed(3)).to("cuda", dtype)
    w = lstm.packed(linear)
    assert ops_lstm2.fwd_sweep_pair(40, d, h, dtype) == 0
    monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORMS", type(ops_lstm2.FWD_SWEEP_FORMS)())
    before = (sum(ops_lstm2.LAUNCHES.values()), lt.LAUNCHES["lstm2_train_fwd"])
    for form in (ops_lstm2.FWD_PAIR, ops_lstm2.FWD_PAIR_WAVE):
        monkeypatch.setattr(ops_lstm2, "FWD_SWEEP_FORM", form)
        for launch in (ops_lstm2.lstm2_fc, lt.lstm2_train_fwd):
            with pytest.raises(RuntimeError, match="pair form"):
                launch(x, w)
    torch.cuda.synchronize()
    assert (sum(ops_lstm2.LAUNCHES.values()), lt.LAUNCHES["lstm2_train_fwd"]) == before
    assert not ops_lstm2.FWD_SWEEP_FORMS
