"""How well-posed phase 10's bf16 and int8 agreement checks are: for seeded
full-width FullSubNet+ models (TSSE, CBAM, SE attentions; seeds 42-44), the
smoke's batch of 8 wavs with their lengths through `Enhancer.enhance_batch`
in bf16 (K1) and int8 (K5) against the same batch through the plain LSTMs,
compared twice: at the waveform and at the model's output (the compressed
cIRM, which the LSTM kernel feeds through its Linear), with the share of
cIRM values near the decompression's clamp and the largest one:

    python3 scripts/variant_snr_seeds.py

Needs an NVIDIA GPU; imports `chip_smoke.py` and the package from the
repository root above this script, and nothing of JAX. Prints the card's
name and power limit first and one `variant_snr` JSON line last.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the package beside chip_smoke.py
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

ATTENTIONS = ("TSSE", "CBAM", "SE")
SEEDS = (42, 43, 44)


def main() -> None:
    from fullsubnet_plus_torch.data.wav import read_wav
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
    from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
    with tempfile.TemporaryDirectory(prefix="variant_snr_") as root:
        lengths = cs.write_inputs(root)
        batch = np.zeros((len(lengths), -(-max(lengths) // cs.SR) * cs.SR), np.float32)
        for i, n in enumerate(lengths):
            batch[i, :n] = read_wav(os.path.join(root, "noisy", f"utt{i}.wav"))
    lens = torch.as_tensor(lengths, device="cuda")
    base = FULLSUBNET_PLUS.make_config({})
    results = []
    for attention in ATTENTIONS:
        config = dataclasses.replace(base, channel_attention_model=attention)
        for seed in SEEDS:
            model = FullSubNetPlus(config).init_weights(torch.Generator().manual_seed(seed))
            for dtype in ("bfloat16", "int8"):
                enhancer = Enhancer(FULLSUBNET_PLUS, config, model.state_dict(), device="cuda",
                                    compute_dtype=dtype)

                @torch.inference_mode()
                def run():
                    noisy = torch.from_numpy(batch).cuda()
                    mag, real, imag, valid = enhancer._spectrum(noisy, lens)
                    crm = enhancer._model(mag[:, None], real[:, None], imag[:, None],
                                          valid_frames=valid)
                    return enhancer.enhance_batch(batch, lengths=lengths), crm

                wave, crm = run()
                with cs.plain_lstms():
                    plain_wave, plain_crm = run()
                row = {"attention": attention, "seed": seed, "dtype": dtype,
                       "wave_snr_db": cs.snr_db(torch.from_numpy(plain_wave),
                                                torch.from_numpy(wave)),
                       "cirm_snr_db": cs.snr_db(plain_crm, crm),
                       "cirm_near_clamp_share": float((plain_crm.abs() > 9.0).float().mean()),
                       "cirm_max_abs": float(plain_crm.abs().max())}
                results.append(row)
                print(f"{attention} seed {seed} {dtype}: waveform {row['wave_snr_db']:.1f} dB, "
                      f"cIRM {row['cirm_snr_db']:.1f} dB, |cIRM| > 9 share "
                      f"{row['cirm_near_clamp_share']:.4f}, max |cIRM| {row['cirm_max_abs']:.3f}")
    print(json.dumps({"variant_snr": results}))


if __name__ == "__main__":
    main()
