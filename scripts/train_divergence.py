"""How far training through the port's LSTM kernels strays from the plain
run, parameter by parameter: the 4 float32 steps of chip_smoke.py's phase 6
(`make_train_step` at the width of configs/train.toml, the same seeded
batches and weights), run in whichever checkout this is started from.

    python3 scripts/train_divergence.py [--kernels-only]         (from the repo's root)
    cd _parent && python3 ../scripts/train_divergence.py         (another checkout)

Needs an NVIDIA GPU and nvcc; imports the package of the working directory
and nothing of JAX. Runs from the same state: the plain forward with the
plain backward computed in float64 (rounded to float32 after), a reference
closer to exact than any other; K2 + K4 (FUSED_WGRAD False); each
kernel alone (the plain forward with K4, K2 with the plain backward); the
plain versions; and the plain versions NOISY_SEEDS times with the LSTM
backward's outputs scaled by 1 + BWD_NOISE N(0, 1), then with the plain
forward's outputs (y and the residuals) scaled by 1 + FWD_NOISE N(0, 1)
(seeded): how far random round-off of the kernels' size alone moves the
4-step trajectory (`--kernels-only`: the kernel runs alone). In the float64
run, each step's LSTM backward inputs also go through the kernels'
backward and the plain float32 one, whose dx, dgates and weight gradients
are printed as SNR against float64. Prints each run's loss and gradient norm by step, each step's gradient
error relative to the float64 run's gradient norm, and how far the first
Adam update (elementwise lr g / (|g| + eps)) differs from the float64
run's, with the parameters that differ most.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from fullsubnet_plus_torch.models import get_model  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2_train as lt  # noqa: E402
from fullsubnet_plus_torch.train import loss, step  # noqa: E402
from fullsubnet_plus_torch.utils.config import load_config  # noqa: E402

SR, BATCH, SAMPLES, STEPS = 16000, 18, 49152, 4
KERNELS = (lt.lstm2_train_fwd, lt.lstm2_bwd)
# relative noise of about the kernels' own error (dx at 133 dB against float64;
# K2's outputs at 129 dB against the plain forward)
BWD_NOISE, FWD_NOISE, NOISY_SEEDS = 2e-7, (1e-7, 3.5e-7), 4


def train_pair(rng, n):
    """chip_smoke.py's pair: a tone with a little noise, and under more noise."""
    t = np.arange(n) / SR
    clean = 0.3 * np.sin(2 * np.pi * rng.uniform(100.0, 400.0) * t) + 0.02 * rng.standard_normal(n)
    return ((clean + 0.1 * rng.standard_normal(n)).astype(np.float32), clean.astype(np.float32))


def snr(ref, out):
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def bwd_float64(dy, x, w, res, fused=None):
    """The plain backward in float64, its results rounded to float32; beside
    it, on the same inputs, the kernels' backward (K4 + `weight_grads`) and
    the plain float32 one, each printed as its SNR against this one."""
    grads = lt.lstm2_bwd_plain(dy.double(), x.double(), type(w)(*(t.double() for t in w)),
                               lt.Residuals(*(r.double() for r in res)), fused)
    sweep = lt.lstm2_bwd_reference(dy.double(), x.double(), type(w)(*(t.double() for t in w)),
                                   lt.Residuals(*(r.double() for r in res)))
    for tag, fn, sweep_fn in (("K4", KERNELS[1], lt.lstm2_bwd_sweep),
                              ("plain float32", lt.lstm2_bwd_plain, lt.lstm2_bwd_reference)):
        got, got_sweep = fn(dy, x, w, res, False), sweep_fn(dy, x, w, res)
        print(f"    {tag} against float64 on this step's inputs (dB): "
              + ", ".join(f"{n} {snr(a, b):.1f}" for n, a, b in
                          zip(("dx", "dg1", "dg2"), sweep[:3], got_sweep[:3]))
              + ", " + ", ".join(f"{n} {snr(a, b):.1f}" for n, a, b in
                                 zip(grads._fields[1:], grads[1:], got[1:])), flush=True)
    return lt.LSTM2Grads(*(g.float() for g in grads))


def main(kernels_only: bool):
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    print("tree:", os.getcwd(), flush=True)
    toml = load_config(os.path.join(os.getcwd(), "configs", "train.toml"))
    model_def = get_model(toml["model"]["path"])
    config = model_def.make_config(toml["model"]["args"])
    acoustics = {k: toml["acoustics"][k] for k in ("n_fft", "hop_length", "win_length")}
    optimizer = step.make_optimizer(
        **toml["optimizer"], clip_grad_norm=toml["trainer"]["train"]["clip_grad_norm_value"])
    loss_fn = loss.get_loss(toml["loss_function"]["name"])
    rng = np.random.default_rng(4)
    batches = [tuple(np.stack(rows) for rows in zip(*(train_pair(rng, SAMPLES)
                                                       for _ in range(BATCH))))
               for _ in range(STEPS)]
    grad = torch.autograd.grad

    def run(tag, fwd, bwd):
        model = model_def.module_cls(config).init_weights(torch.Generator().manual_seed(42))
        names = [name for name, _ in model.named_parameters()]
        state = step.init_train_state(model, optimizer, device="cuda")
        train_step = step.make_train_step(model_def, config, optimizer, loss_fn,
                                          compute_dtype=torch.float32, device="cuda", **acoustics)
        kept, saved = [], (lt.lstm2_train_fwd, lt.lstm2_bwd, lt.FUSED_WGRAD, torch.autograd.grad)

        def keep(*args, **kwargs):
            out = grad(*args, **kwargs)
            kept.append([g.detach().clone() for g in out])
            return out

        lt.lstm2_train_fwd, lt.lstm2_bwd, lt.FUSED_WGRAD = fwd, bwd, False
        torch.autograd.grad = keep
        metrics = []
        try:
            for noisy, clean in batches:
                state, m = train_step(state, noisy, clean)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        finally:
            lt.lstm2_train_fwd, lt.lstm2_bwd, lt.FUSED_WGRAD, torch.autograd.grad = saved
        print(f"{tag}: loss {', '.join(f'{a:.6f}' for a, _ in metrics)}; grad norm "
              f"{', '.join(f'{b:.4f}' for _, b in metrics)}", flush=True)
        return names, kept

    names, exact = run("plain forward, float64 plain backward", lt.lstm2_train_fwd_reference,
                       bwd_float64)

    def jitter(tensors, level, gen):
        return [t * (1 + level * torch.randn(t.shape, generator=gen, device=t.device))
                for t in tensors]

    def noisy_bwd(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return lambda dy, x, w, res, fused=None: lt.LSTM2Grads(
            *jitter(lt.lstm2_bwd_plain(dy, x, w, res, fused), BWD_NOISE, gen))

    def noisy_fwd(seed, level):
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def fwd(x, w):
            y, res = lt.lstm2_train_fwd_reference(x, w)
            y, *res = jitter((y, *res), level, gen)
            return y, lt.Residuals(*res)
        return fwd

    runs = [("K2 + K4", KERNELS[0], KERNELS[1]),
            ("plain forward + K4", lt.lstm2_train_fwd_reference, KERNELS[1]),
            ("K2 + plain backward", KERNELS[0], lt.lstm2_bwd_plain)]
    if not kernels_only:
        runs.append(("plain versions", lt.lstm2_train_fwd_reference, lt.lstm2_bwd_plain))
        runs += [(f"plain versions, backward outputs times (1 + {BWD_NOISE:g} N(0, 1)), seed "
                  f"{seed}", lt.lstm2_train_fwd_reference, noisy_bwd(seed))
                 for seed in range(NOISY_SEEDS)]
        runs += [(f"plain versions, forward outputs times (1 + {level:g} N(0, 1)), seed {seed}",
                  noisy_fwd(seed, level), lt.lstm2_bwd_plain)
                 for level in FWD_NOISE for seed in range(NOISY_SEEDS)]
    for tag, fwd, bwd in runs:
        _, grads = run(tag, fwd, bwd)
        errs = []
        for got, want in zip(grads, exact):
            flat_got, flat_want = (torch.cat([g.flatten() for g in gs]) for gs in (got, want))
            errs.append(float((flat_got - flat_want).norm() / flat_want.norm()))
        # Adam's first update is lr g / (|g| + eps), elementwise
        moved = sorted(((float((g / (g.abs() + optimizer.eps) - e / (e.abs() + optimizer.eps))
                                .norm()), n, float(e.abs().max()))
                        for n, g, e in zip(names, grads[0], exact[0])), reverse=True)
        print(f"  gradient error relative to the float64 run's norm by step: "
              f"{', '.join(f'{e:.2e}' for e in errs)}; first Adam update against the float64 "
              f"run's, in units of lr: {sum(m ** 2 for m, _, _ in moved) ** 0.5:.3e}, most in "
              + "; ".join(f"{n} {m:.2e} (largest float64 |g| {a:.1e})" for m, n, a in moved[:3]),
              flush=True)

if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    main(sys.argv[1:] == ["--kernels-only"])
