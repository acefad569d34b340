"""The multi-device phase of chip_smoke.py (its phase 9) alone, on every
card the machine shows: the data-parallel training step as 2 ranks against
1 rank from one seeded state, `cli.train` as 2 ranks for 1 float32 epoch on
the smoke's seeded corpus, and `Enhancer(mesh=)` on the smoke's batch of 8
(rows over 'data', the fold over 'freq'; on 2 cards, or one named twice):

    python3 scripts/time_torch_multi_device.py

With 2 cards or more the ranks run over NCCL on cuda:0 and cuda:1; with one,
2 gloo ranks share it and a 1-rank NCCL group follows. It builds the five
kernels first (the smoke's phase 1, so the ranks find them built), starts
from the seeded state phase 6 starts from (seed 42) rather than from phase
6's end state, and prints the card's name and power limit and the
`multi_device` JSON line. Needs an NVIDIA GPU; imports `chip_smoke.py` and
the package from the repository root above this script, and nothing of JAX.
"""

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


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"cards: {smi.stdout.strip().splitlines()}; torch {torch.__version__}")
    cs.phase_build()
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    model_def, config, optimizer, _, _ = cs.train_setup()
    from fullsubnet_plus_torch.train import step

    state = step.init_train_state(
        model_def.module_cls(config).init_weights(torch.Generator().manual_seed(42)), optimizer,
        device=cards[0])
    rng = np.random.default_rng(4)
    pairs = [[cs.train_pair(rng, cs.TRAIN_SAMPLES) for _ in range(cs.TRAIN_BATCH)]
             for _ in range(cs.TRAIN_STEPS)]
    batches = {"noisy": np.stack([np.stack([p[0] for p in b]) for b in pairs]),
               "clean": np.stack([np.stack([p[1] for p in b]) for b in pairs])}
    with tempfile.TemporaryDirectory(prefix="multi_device_") as root:
        lengths = cs.write_inputs(root)
        cs.write_trainer_corpus(root)
        dp = cs.phase_data_parallel(root, state.state_dict(), batches, cards)
        cli = cs.phase_cli_ranks(root, cards)
        mesh = cs.phase_mesh_enhancer(root, lengths, cards)
    print(json.dumps({"multi_device": {
        "cards": len(cards),
        "data_parallel": {tag: [{"rank": r["rank"], "device": r["device"],
                                 "float32": r["float32"]["metrics"],
                                 "bfloat16": r["bfloat16"]["metrics"],
                                 "median_step_wall_ms": r["steps"]["median_wall_ms"]}
                                for r in ranks] for tag, ranks in dp["runs"].items()},
        "one_rank_median_step_wall_ms": dp["one_rank"]["steps"]["median_wall_ms"],
        "cli": {"backend": cli["backend"], "audio_s_per_s": cli["audio_s_per_s"]},
        "mesh_enhancer": mesh}}))
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
