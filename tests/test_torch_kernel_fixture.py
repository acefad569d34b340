"""The committed JAX-kernel fixture (tests/fixtures/torch_kernel_fixture.npz,
made by tests/fixtures/gen_torch_kernel_fixture.py) against the port's plain
versions on the CPU, and against a fresh JAX run.

On the card, tests/test_torch_cuda_kernels.py holds the CUDA kernels K1-K5
to the same fixture (no JAX there). Here the plain versions `lstm2_fc_reference`,
`lstm2_int8_fc_reference` and the `LSTM2TrainFunction` plain path meet it
within the tolerances of the existing JAX-parity tests: K1 float32 atol 3e-5
/ rtol 1e-4 and bf16 atol 2e-2 / rtol 2e-2 (tests/test_torch_nn.py), K5 at
least 40 dB (tests/test_torch_int8.py), the training value and gradients
float32 atol 1e-4 / rtol 1e-4 with the value to rtol 1e-5, and bf16 within
3 % of each gradient's peak with the value to rtol 2e-2
(tests/test_torch_train_kernels.py). Regenerating a case with JAX must give
the committed numbers, so the fixture cannot go stale unnoticed.
"""

import importlib.util
import os

import numpy as np
import pytest

_GEN_PATH = os.path.join(os.path.dirname(__file__), "fixtures", "gen_torch_kernel_fixture.py")
_spec = importlib.util.spec_from_file_location("gen_torch_kernel_fixture", _GEN_PATH)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(scope="module")
def fixture():
    return gen.load_fixture()


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / max(((ref - out) ** 2).sum(), 1e-300))


@pytest.mark.parametrize("name", list(gen.CASES))
def test_plain_versions_match_the_jax_fixture(fixture, name):
    kernel, *_, dtype, _, _ = gen.CASES[name]
    want, got = fixture[name], gen.port_run(name)
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].shape == want[key].shape, key
        if kernel == "k5":
            assert _snr(want[key], got[key]) >= 40.0, (key, _snr(want[key], got[key]))
        elif kernel == "k1":
            atol, rtol = (3e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
            np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=rtol, err_msg=key)
        elif dtype == "float32":
            np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                       rtol=1e-5 if key == "value" else 1e-4, err_msg=key)
        elif key == "value":
            np.testing.assert_allclose(got[key], want[key], rtol=2e-2)
        else:
            scale = float(np.abs(want[key]).max()) + 1e-6
            assert float(np.abs(got[key] - want[key]).max()) / scale < 0.03, key


@pytest.mark.parametrize("name", ["k1_float32_h64", "train_float32_fused"])
def test_fixture_regenerates_from_jax(fixture, name):
    """A fresh interpret-mode run gives the committed numbers (the CPU's sum
    order is fixed, so only a changed recipe, case or JAX kernel moves them)."""
    fresh = gen.run_case(name)
    assert sorted(fresh) == sorted(fixture[name])
    for key, value in fresh.items():
        np.testing.assert_allclose(value, fixture[name][key], rtol=1e-6, atol=1e-7, err_msg=key)


def test_fixture_cases_are_small_and_ragged():
    """Every fold leaves a ragged last tile at both bf16 row tiles (16, 32)
    and the float32 ones (16, 20), T is odd, and the file stays small."""
    for kernel, n, t, d, h, o, *_ in gen.CASES.values():
        assert n % 16 and n % 20 and n % 32 and t % 2, (n, t)
        assert h % 32 == 0 and d <= h
    assert os.path.getsize(gen.FIXTURE) < 2 << 20
