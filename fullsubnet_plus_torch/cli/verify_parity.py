"""Released-checkpoint waveform-parity harness.

    # with a checkpoint (a reference .tar / .pth, or an .npz of either package):
    python -m fullsubnet_plus_torch.cli.verify_parity -M best_model.tar \
        [-I some.wav] [-O enhanced.wav] [--model fullsubnet_plus|fullsubnet] \
        [--reference DIR] [--tol-db 55] [--device cuda|cpu]
    # the offline self-check against the committed fixture (needs the
    # reference's code, to rebuild its pinned-seed weights):
    python -m fullsubnet_plus_torch.cli.verify_parity --reference DIR [--model ...]

Counterpart of fullsubnet_plus_tpu/cli/verify_parity.py with its flags;
the pipeline is the port's `Enhancer` at the shipped config (STFT, model,
cIRM, iSTFT, the 0.8-peak rescale of the reference's inferencer,
fullsubnet_plus/inferencer/inferencer.py:141-160 and
base_inferencer.py:148-152), FullSubNet+ through
`mag_complex_full_band_crm_mask` and FullSubNet through
`full_band_crm_mask`, on the card unless `--device cpu`.

* With -M it enhances the input (default: the committed fixture's,
  tests/fixtures/parity_fixture.npz) with the checkpoint's weights and,
  when the reference's code can be imported, also runs the reference's
  pipeline live with the same checkpoint and compares the two waveforms.
* Without -M it rebuilds the reference model at the fixture's pinned seed,
  enhances the fixture's input with those weights and compares against the
  fixture's waveform (which the live reference made) and against the live
  reference. Those weights come only from the reference's code: without
  it, it exits with the JAX harness's message.

The reference's code is its `speech_enhance` directory, given by
`--reference` or the FULLSUBNET_PLUS_REFERENCE environment variable.
Parity holds at float32: the float32 path on the card runs its products in
full float32 (the kernels' 3xTF32 and matmuls without TF32).
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "fixtures", "parity_fixture.npz",
)
REFERENCE_ENV = "FULLSUBNET_PLUS_REFERENCE"


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    err = np.linalg.norm(est - ref)
    return float(20 * np.log10((np.linalg.norm(ref) + 1e-12) / (err + 1e-12)))


def reference_dir(given: str | None = None) -> str | None:
    """The reference's `speech_enhance` directory if it exists, else None."""
    path = given or os.environ.get(REFERENCE_ENV)
    return path if path and os.path.isdir(path) else None


def _import_reference(reference: str, model: str = "fullsubnet_plus"):
    sys.modules.setdefault("librosa", types.ModuleType("librosa"))
    sys.path[:0] = [p for p in (reference, os.path.dirname(reference)) if p not in sys.path]
    if model == "fullsubnet":
        from fullsubnet.model.fullsubnet import Model

        return Model
    from fullsubnet_plus.model.fullsubnet_plus import FullSubNet_Plus

    return FullSubNet_Plus


def shipped_model_args(model: str = "fullsubnet_plus") -> dict:
    """The reference's constructor arguments at the shipped config
    (config/train.toml:73-91; the baseline without the attention, kernel
    size and sub-band knobs, fullsubnet/model/fullsubnet.py:12-40)."""
    args = dict(num_freqs=257, look_ahead=2, sequence_model="LSTM", fb_num_neighbors=0,
                sb_num_neighbors=15, fb_output_activate_function="ReLU",
                sb_output_activate_function=False, fb_model_hidden_size=512,
                sb_model_hidden_size=384, norm_type="offline_laplace_norm",
                num_groups_in_drop_band=2, weight_init=False)
    if model == "fullsubnet_plus":
        args.update(channel_attention_model="TSSE", kersize=[3, 5, 10], subband_num=1)
    return args


def port_enhance(state_dict: dict, noisy: np.ndarray, model: str = "fullsubnet_plus",
                 device="cuda") -> np.ndarray:
    """The port's pipeline at the shipped config on a reference-layout
    state_dict: the 0.8-peak-rescaled float32 waveform (the value the
    reference quantizes to int16 when it writes)."""
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import get_model

    model_def = get_model(model)
    inference_type = ("mag_complex_full_band_crm_mask" if model_def.n_inputs == 3
                      else "full_band_crm_mask")
    enhancer = Enhancer(model_def, model_def.make_config({}), state_dict,
                        inference_type=inference_type, device=device)
    return enhancer.enhance(noisy.astype(np.float32))


def torch_enhance(reference: str, state_dict: dict, noisy: np.ndarray,
                  model: str = "fullsubnet_plus") -> np.ndarray:
    """The reference's pipeline live on the CPU (inferencer.py:141-160 and
    the 0.8 rescale; the baseline's inferencer.py:116-138, magnitude only)."""
    import torch

    cls = _import_reference(reference, model)
    from audio_zen.acoustics.mask import decompress_cIRM

    net = cls(**shipped_model_args(model)).eval()
    net.load_state_dict({k.removeprefix("module."): torch.as_tensor(np.asarray(v))
                         for k, v in state_dict.items()}, strict=True)
    with torch.no_grad():
        y = torch.from_numpy(noisy.astype(np.float32))[None]
        win = torch.hann_window(512)
        nc = torch.stft(y, 512, 256, 512, window=win, return_complex=True)
        if model == "fullsubnet":
            crm = net(nc.abs().unsqueeze(1))
        else:
            crm = net(nc.abs().unsqueeze(1), nc.real.unsqueeze(1), nc.imag.unsqueeze(1))
        crm = decompress_cIRM(crm.permute(0, 2, 3, 1))
        er = crm[..., 0] * nc.real - crm[..., 1] * nc.imag
        ei = crm[..., 1] * nc.real + crm[..., 0] * nc.imag
        enhanced = torch.istft(torch.complex(er, ei), 512, 256, 512, window=win,
                               length=y.shape[-1])[0].numpy()
    return (0.8 * enhanced / np.max(np.abs(enhanced))).astype(np.float32)


def load_state_dict(path: str, model: str = "fullsubnet_plus") -> dict:
    """A reference `.tar` / `.pth`, or an `.npz` (its parameters, through
    the weight bridge) -> a reference-layout state_dict."""
    from fullsubnet_plus_torch.io.checkpoint import load_jax_params, load_torch_state_dict
    from fullsubnet_plus_torch.io.convert import state_dict_from_jax

    if path.endswith((".tar", ".pth")):
        return load_torch_state_dict(path)
    return state_dict_from_jax(load_jax_params(path), model)


def run(model_path=None, input_path=None, output_path=None, fixture_path=FIXTURE,
        tol_db=55.0, model="fullsubnet_plus", reference=None, device="cuda") -> bool:
    """Enhance and compare as the module's docstring says; logs each
    comparison and returns whether every one reached `tol_db`."""
    from fullsubnet_plus_torch.data.wav import read_wav, write_wav
    from fullsubnet_plus_torch.utils import logger

    reference = reference_dir(reference)
    fx = np.load(fixture_path)
    sr = int(fx["sr"])
    noisy = np.asarray(read_wav(input_path, sr=sr), np.float32) if input_path else fx["noisy"]
    fixture_key = "enhanced_ref" if model == "fullsubnet_plus" else "enhanced_ref_fullsubnet"

    results = {}
    if model_path is None:
        if reference is None:
            raise SystemExit("no -M given and the torch reference code is not available to "
                             "rebuild the pinned-seed weights; pass a checkpoint with -M")
        import torch

        torch.manual_seed(int(fx["seed"]))
        state_dict = _import_reference(reference, model)(**shipped_model_args(model)).eval() \
            .state_dict()
        ours = port_enhance(state_dict, noisy, model, device)
        if input_path is None and fixture_key in fx:
            results["vs_committed_fixture"] = snr_db(fx[fixture_key], ours)
        results["vs_live_torch"] = snr_db(torch_enhance(reference, state_dict, noisy, model),
                                          ours)
    else:
        state_dict = load_state_dict(model_path, model)
        ours = port_enhance(state_dict, noisy, model, device)
        if reference is not None:
            results["vs_live_torch"] = snr_db(
                torch_enhance(reference, state_dict, noisy, model), ours)
        else:
            logger.log("NOTE: the torch reference was not run (its code is not available); "
                       "wrote the port's output only")

    if output_path:
        write_wav(output_path, ours, sr)
        logger.log(f"wrote {output_path}")
    int16_floor_db = 20 * np.log10(0.8 / (1 / 32768))  # the int16 write's quantization floor
    ok = True
    for name, db in results.items():
        ok &= db >= tol_db
        logger.log(f"parity {name}: {db:.1f} dB SNR (>= {tol_db:.0f} dB -> "
                   f"{'PASS' if db >= tol_db else 'FAIL'}; int16 write floor is "
                   f"{int16_floor_db:.0f} dB)")
    if not results:
        logger.log("no comparison target available: nothing verified")
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(description="released-checkpoint waveform-parity harness "
                                            "(offline self-check without -M)")
    p.add_argument("-M", "--model_checkpoint_path", default=None,
                   help="a reference .tar / .pth (e.g. the released best_model.tar) or an .npz")
    p.add_argument("-I", "--input_wav", default=None,
                   help="wav to enhance (default: the fixture's input)")
    p.add_argument("-O", "--output_wav", default=None)
    p.add_argument("--model", default="fullsubnet_plus", choices=["fullsubnet_plus", "fullsubnet"],
                   help="model family: the shipped FullSubNet+ (default) or the FullSubNet "
                        "baseline via full_band_crm_mask")
    p.add_argument("--fixture", default=FIXTURE)
    p.add_argument("--tol-db", type=float, default=55.0,
                   help="minimum SNR (dB) between the waveforms to PASS")
    p.add_argument("--reference", default=None,
                   help=f"the reference's speech_enhance directory (default: ${REFERENCE_ENV})")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    ok = run(args.model_checkpoint_path, args.input_wav, args.output_wav, args.fixture,
             args.tol_db, model=args.model, reference=args.reference, device=args.device)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
