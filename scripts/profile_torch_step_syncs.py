"""Where a training step makes the host wait for the card: the CUDA runtime
calls that block for a millisecond or more inside one float32 step at
configs/train.toml's width and batch (torch.profiler's CPU trace), each with
the operators that issued it, and the time until the step returns to the
host beside its wall; for the step on one card and on a one-process mesh
of two cards (rows over 'data'; on a one-card machine a mesh naming the
card twice):

    python3 scripts/profile_torch_step_syncs.py

It builds the five kernels first (chip_smoke.py's phase 1) and starts from
the seeded state chip_smoke.py's phase 6 starts from. Needs an NVIDIA GPU;
imports `chip_smoke.py` and the package from the repository root above
this script, and nothing of JAX.
"""

import collections
import importlib.util
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the package beside chip_smoke.py
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

BLOCKING_MS = 1.0  # runtime calls at least this long are listed


def parents(event) -> str:
    chain = []
    while event.cpu_parent is not None and len(chain) < 4:
        event = event.cpu_parent
        chain.append(event.name)
    return " < ".join(chain)


def profile_step(tag: str, train_step, state, noisy, clean) -> None:
    hosts, walls = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, noisy, clean)
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(state, noisy, clean)
        torch.cuda.synchronize()
    blocking = [e for e in prof.events() if e.name.startswith("cuda")
                and e.cpu_time_total / 1e3 >= BLOCKING_MS]
    by_name = collections.Counter(e.name for e in prof.events() if e.name.startswith("cuda"))
    print(f"{tag}: returns to the host after {statistics.median(hosts[1:]):.1f} ms of a "
          f"{statistics.median(walls[1:]):.1f} ms wall (median of 3, unprofiled); runtime "
          f"calls {dict(by_name.most_common(8))}")
    for e in blocking:
        print(f"    {e.cpu_time_total / 1e3:8.2f} ms {e.name} < {parents(e)}")


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.phase_build()
    from fullsubnet_plus_torch.parallel import make_mesh
    from fullsubnet_plus_torch.train import step

    model_def, config, optimizer, loss_fn, acoustics = cs.train_setup()
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = (cards * 2)[:2]
    rng = np.random.default_rng(4)
    pairs = [cs.train_pair(rng, cs.TRAIN_SAMPLES) for _ in range(cs.TRAIN_BATCH)]
    noisy, clean = (np.stack([p[i] for p in pairs]) for i in range(2))
    for tag, mesh in (("1 card", None), (f"mesh 2x1 on {devices}", make_mesh(2, 1, devices))):
        state = step.init_train_state(
            model_def.module_cls(config).init_weights(torch.Generator().manual_seed(42)),
            optimizer, device=devices[0])
        train_step = step.make_train_step(model_def, config, optimizer, loss_fn, mesh=mesh,
                                          device=devices[0], **acoustics)
        profile_step(tag, train_step, state, noisy, clean)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
