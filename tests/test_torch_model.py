"""The port's FullSubNet+ (fullsubnet_plus_torch/models, io) against the JAX
package's, on the CPU: the weight bridge key for key and value for value,
strict loading, the `.npz` format both ways, and the forward at a tiny
config and once at full width. JAX runs at HIGHEST matmul precision, the
port in float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.io import checkpoint as jckpt
from fullsubnet_plus_tpu.io.torch_convert import export_fullsubnet_plus
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_torch.io import checkpoint as tckpt
from fullsubnet_plus_torch.io.convert import jax_from_state_dict, state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS, get_model
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus, FullSubNetPlusConfig

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(0), JConfig(**TINY)))


@pytest.fixture(scope="module")
def full_params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(1)))


def _snr(ref, out):
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


@pytest.mark.parametrize("which", ["tiny_params", "full_params"])
def test_state_dict_from_jax_matches_export(request, which):
    params = request.getfixturevalue(which)
    ours = state_dict_from_jax(params)
    theirs = export_fullsubnet_plus(params)
    assert list(ours) == list(theirs)  # same keys, in registration order
    for key, value in theirs.items():
        assert ours[key].dtype == torch.float32
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("which,kwargs", [("tiny_params", TINY), ("full_params", {})])
def test_module_loads_reference_state_dict_strict(request, which, kwargs):
    params = request.getfixturevalue(which)
    model = FullSubNetPlus(FullSubNetPlusConfig(**kwargs))
    export = export_fullsubnet_plus(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in export.items()}, strict=True)
    assert list(model.state_dict()) == list(export)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(v.size for v in export.values())


def test_npz_round_trip_between_packages(tmp_path, tiny_params):
    """A port-written `.npz` loads in the JAX package, and back."""
    model = FullSubNetPlus(FullSubNetPlusConfig(**TINY)).init_weights(
        torch.Generator().manual_seed(3))
    tckpt.save_flat(str(tmp_path / "port.npz"), {"params": jax_from_state_dict(model.state_dict())})
    flat, _ = jckpt.load_flat(str(tmp_path / "port.npz"))
    jtree = jckpt.nested_from_flat({k.removeprefix("params/"): v for k, v in flat.items()})
    back = state_dict_from_jax(jtree)
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(back[key].numpy(), value.numpy(), err_msg=key)

    jckpt.save_pytree(str(tmp_path / "jax.npz"), {"params": tiny_params}, {"epoch": 1})
    loaded = tckpt.load_jax_params(str(tmp_path / "jax.npz"))
    for (pa, a), (pb, b) in zip(tckpt.flat_from_nested(loaded).items(),
                                tckpt.flat_from_nested(tiny_params).items()):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_seeded_init_is_reproducible_with_torch_default_bounds():
    make = lambda seed: FullSubNetPlus(FullSubNetPlusConfig(**TINY)).init_weights(
        torch.Generator().manual_seed(seed))
    a, b, c = make(7).state_dict(), make(7).state_dict(), make(8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sb_model.sequence_model.weight_hh_l0"],
                           c["sb_model.sequence_model.weight_hh_l0"])
    bound = 1 / np.sqrt(16)  # LSTM: U(-1/sqrt(H), 1/sqrt(H))
    assert float(a["sb_model.sequence_model.weight_hh_l0"].abs().max()) <= bound
    assert torch.all(a["fb_model.sequence_model.0.prelu1.weight"] == 0.25)
    assert torch.all(a["fb_model.sequence_model.0.norm1.weight"] == 1.0)


def _views(rng, batch, freqs, frames):
    real = rng.standard_normal((batch, 1, freqs, frames)).astype(np.float32)
    imag = rng.standard_normal((batch, 1, freqs, frames)).astype(np.float32)
    return np.sqrt(real ** 2 + imag ** 2), real, imag


@pytest.mark.parametrize("valid", [None, [9, 20]])
def test_forward_matches_jax_tiny(rng, tiny_params, valid):
    views = _views(rng, 2, 33, 20)
    kw = {} if valid is None else {"valid_frames": np.asarray(valid, np.int32)}
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_MODEL.apply(
            tiny_params, *(jnp.asarray(v) for v in views), JConfig(**TINY),
            **{k: jnp.asarray(v) for k, v in kw.items()}))
    model = FullSubNetPlus(FullSubNetPlusConfig(**TINY)).load_jax_params(tiny_params)
    with torch.no_grad():
        out = model(*(torch.from_numpy(v) for v in views),
                    **{k: torch.from_numpy(v).long() for k, v in kw.items()}).numpy()
    assert out.shape == ref.shape == (2, 2, 33, 20)
    assert _snr(ref, out) > 80.0
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_forward_matches_jax_full_width(rng, full_params):
    """257 bins, TCN 512, LSTM 384, one 0.5 s utterance (32 frames)."""
    views = _views(rng, 1, 257, 32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_MODEL.apply(full_params, *(jnp.asarray(v) for v in views)))
    model = FullSubNetPlus().load_jax_params(full_params)
    with torch.no_grad():
        out = model(*(torch.from_numpy(v) for v in views)).numpy()
    assert out.shape == ref.shape == (1, 2, 257, 32)
    assert _snr(ref, out) > 80.0, _snr(ref, out)


def test_registry_and_config():
    assert get_model("fullsubnet_plus.model.fullsubnet_plus.FullSubNet_Plus") is FULLSUBNET_PLUS
    cfg = FULLSUBNET_PLUS.make_config({"kersize": [3, 5, 10], "weight_init": False,
                                      "sb_model_hidden_size": 384})
    assert cfg == FullSubNetPlusConfig()
    assert {f.name for f in dataclasses.fields(cfg)} <= {f.name for f in dataclasses.fields(JConfig)}


def _forward(config, **kwargs):
    views = (torch.ones(2, 1, 33, 5) for _ in range(3))
    return FullSubNetPlus(config)(*views, **kwargs)


@pytest.mark.parametrize("build,error,match", [
    (lambda: FullSubNetPlus(FullSubNetPlusConfig(**TINY, subband_num=2)), ValueError,
     "reference"),
    # the options ported since are held where they still refuse, as JAX does
    (lambda: _forward(FullSubNetPlusConfig(**TINY, subband_num=2, channel_attention_model="ECA"),
                      valid_frames=torch.tensor([5, 4])),
     ValueError, "subband_num == 1"),
    (lambda: FullSubNetPlus(FullSubNetPlusConfig(**TINY, norm_type="forgetting_norm")),
     ValueError, r"takes \[B, F, T\] only"),
    (lambda: _forward(FullSubNetPlusConfig(**TINY, channel_attention_model="DeepTSSE"),
                      valid_frames=torch.tensor([5, 4])),
     ValueError, "masked pooling is not wired for DeepTSSE"),
    # training=True is ported (drop_band); with valid_frames it still refuses
    (lambda: FullSubNetPlus(FullSubNetPlusConfig(**TINY))(
        *(torch.ones(4, 1, 33, 5) for _ in range(3)), training=True,
        valid_frames=torch.tensor([5, 5, 5, 5])),
     ValueError, "serving-path feature"),
])
def test_unported_options_raise(build, error, match):
    with pytest.raises(error, match=match):
        build()
