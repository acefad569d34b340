"""Offline enhancement CLI.

    python -m fullsubnet_plus_torch.cli.enhance -C configs/inference.toml \
        -M checkpoint(.npz|.tar|.pth) -I noisy_dir -O out_dir \
        [--batch N] [--dtype float32|bfloat16|int8] [--device cuda|cpu]

Counterpart of fullsubnet_plus_tpu/cli/enhance.py:22-184. Takes the JAX
package's `.npz` checkpoints and the reference's torch `.tar`/`.pth`, of
FullSubNet+ or FullSubNet ([model] path), and any inference mode
([inferencer] type, with n_neighbor and the rest of [inferencer.args]).
Utterances are sorted by length and enhanced in batches padded to a whole
second; a length-aware mode gets their true lengths, so padding changes no
output. Each output is rescaled to 0.8 of its peak
(base_inferencer.py:151-152).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

log = logging.getLogger(__name__)


def load_state_dict(checkpoint_path: str) -> dict:
    """A reference-layout state_dict from a `.tar`/`.pth` or a JAX `.npz`."""
    from fullsubnet_plus_torch.io.checkpoint import load_jax_params, load_torch_state_dict
    from fullsubnet_plus_torch.io.convert import state_dict_from_jax

    if checkpoint_path.endswith((".tar", ".pth")):
        return load_torch_state_dict(checkpoint_path)
    return state_dict_from_jax(load_jax_params(checkpoint_path))


def run_enhance(config: dict, checkpoint_path: str, output_dir: str, input_dirs=None,
                batch_size: int = 8, compute_dtype: str | None = None,
                device: str = "cuda") -> dict:
    """Enhance every wav under the input directories into `output_dir`.
    compute_dtype: None (float32, the parity path), "bfloat16" or "int8";
    the config's [inferencer.args] compute_dtype applies when it is None."""
    from fullsubnet_plus_torch.data.datasets import InferenceDataset
    from fullsubnet_plus_torch.data.wav import write_wav
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import get_model

    model_def = get_model(config["model"]["path"])
    model_config = model_def.make_config(config["model"].get("args", {}))
    acoustics = config.get("acoustics", {})
    inferencer_args = config.get("inferencer", {}).get("args", {})
    enhancer = Enhancer(
        model_def, model_config, load_state_dict(checkpoint_path),
        inference_type=config.get("inferencer", {}).get(
            "type", "mag_complex_full_band_crm_mask"),
        n_fft=acoustics.get("n_fft", 512),
        hop_length=acoustics.get("hop_length", 256),
        win_length=acoustics.get("win_length", 512),
        sr=acoustics.get("sr", 16000),
        n_neighbor=inferencer_args.get("n_neighbor", 15),
        compute_dtype=compute_dtype or inferencer_args.get("compute_dtype"),
        inference_args=inferencer_args,
        device=device,
    )
    length_aware = enhancer.inference_type in Enhancer.LENGTH_AWARE_MODES

    sr = enhancer.sr
    dataset = InferenceDataset(input_dirs or config["dataset"]["args"]["dataset_dir_list"],
                               sr=sr)
    items = sorted((dataset[i] for i in range(len(dataset))), key=lambda kv: len(kv[0]))
    os.makedirs(output_dir, exist_ok=True)

    t_start = time.perf_counter()
    total_audio_s = 0.0
    for i in range(0, len(items), batch_size):
        batch = items[i:i + batch_size]
        lengths = np.asarray([len(w) for w, _ in batch])
        padded_len = -(-int(lengths.max()) // sr) * sr  # bucket: whole seconds
        stacked = np.zeros((len(batch), padded_len), np.float32)
        for j, (w, _) in enumerate(batch):
            stacked[j, :len(w)] = w
        enhanced = enhancer.enhance_batch(stacked, lengths=lengths if length_aware else None)
        for j, (w, name) in enumerate(batch):
            y = enhanced[j, :len(w)]
            peak = np.max(np.abs(y)) + 1e-12
            if peak > 1.0:
                log.warning("enhanced %s exceeds 1 before the rescale", name)
            write_wav(os.path.join(output_dir, f"{name}.wav"), y / peak * 0.8, sr)
        total_audio_s += float(lengths.sum()) / sr
    wall = time.perf_counter() - t_start
    stats = {
        "files": len(items),
        "audio_seconds": total_audio_s,
        "wall_seconds": wall,
        "throughput_audio_s_per_s": total_audio_s / max(wall, 1e-9),
        "device": str(enhancer.device),
    }
    log.info("enhanced %d files: %.1f audio-s/s on %s", stats["files"],
             stats["throughput_audio_s_per_s"], stats["device"])
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description="Batched offline enhancement (PyTorch)")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("-M", "--model_checkpoint_path", required=True)
    parser.add_argument("-I", "--dataset_dir_list", default=None,
                        help="comma-separated noisy dirs (overrides config)")
    parser.add_argument("-O", "--output_dir", required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--dtype", choices=["float32", "bfloat16", "int8"], default=None,
                        help="model compute dtype: float32 = parity path (default); "
                             "bfloat16 casts the model; int8 = bfloat16 with the "
                             "sub-band LSTM's recurrent products in int8 (the "
                             "serving default, not the parity path)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from fullsubnet_plus_torch.utils.config import load_config

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    run_enhance(
        load_config(args.configuration), args.model_checkpoint_path, args.output_dir,
        input_dirs=args.dataset_dir_list.split(",") if args.dataset_dir_list else None,
        batch_size=args.batch, compute_dtype=args.dtype, device=args.device,
    )


if __name__ == "__main__":
    main()
