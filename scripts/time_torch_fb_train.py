"""The training kernels at FullSubNet's full-band shape (D 257, H 512, O 257)
and, for an A/B of two checkouts, digests of the kernels' outputs at the
shipped folds.

    python3 scripts/time_torch_fb_train.py                       (from the repo's root)
    python3 scripts/time_torch_fb_train.py --shipped             (the digest and times)
    python3 scripts/time_torch_fb_train.py --folds               (both forms over folds)
    cd _parent && python3 ../scripts/time_torch_fb_train.py --shipped   (another checkout)

Needs an NVIDIA GPU and nvcc; imports the package of the working directory
and nothing of JAX. Builds the five kernels in parallel and prints the
card's name and power limit. Without `--shipped`, at the full-band fold of
configs/train.toml's batch (N 18, T 195) and at a ragged one (N 7, T 9),
in float32 and bf16: K2 (`lstm2_train_fwd`) against
`lstm2_train_fwd_reference`, K4 (`lstm2_bwd_sweep`) against
`lstm2_bwd_reference` and K3 (`lstm2_bwd(fused=True)`) against
`lstm2_bwd_plain` (least SNR over the outputs; floors 80 dB float32, 40 dB
bf16), K3 equal to itself on a repeat, with the reverse sweep's form (the
cluster form at both folds) and the forward's (K2's; the cluster form at
both folds); at N 18 the median of 3 CUDA-event timings of
each beside its plain version, of the unfused backward (K4 +
`weight_grads`, the other side of `FUSED_WGRAD_BY_DTYPE`), and of K2, K4 and
K3 with the tile form forced (`FWD_SWEEP_FORM`, `SWEEP_FORM` 0), in the same
call. With `--folds`, K2 and K4 at the full-band shape, T 195, over folds
from N 18 to 2112 (132 row tiles: one tile-form CTA an SM) each in both
forms forced, the median of 3 timings of each and which is faster (what
`FWD_CLUSTER_MAX_ROWS` and `CLUSTER_MAX_ROWS` are set from: the cluster
forms' clusters run in waves of the few the card holds at once). With
`--shipped`, in both dtypes, a SHA-256 of each kernel's outputs from seeded
operands (equal digests in two checkouts: the same results bit for bit): K1
at the batch fold (N 2056, T 629, D 34, H 384, O 2), K2, K3 and K4 at the
training fold (N 2304, T 195) and K5 at the serving fold (N 2056, T 255),
all in the tile form, and K3 and K4 at the full-band fold (N 18, T 195) in
the reverse sweep's cluster form (K3 and K4 from the plain forward's
residuals); and the median of 5 timings of K3 and K4 at the training fold.
"""

import hashlib
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.getcwd())

from fullsubnet_plus_torch.nn.layers import Linear  # noqa: E402
from fullsubnet_plus_torch.nn.lstm import LSTM2  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2, lstm2_int8  # noqa: E402
from fullsubnet_plus_torch.ops import lstm2_train as lt  # noqa: E402
from fullsubnet_plus_torch.ops import nvcc  # noqa: E402

FB, SHIPPED = (257, 512, 257), (34, 384, 2)
FLOOR = {torch.float32: 80.0, torch.bfloat16: 40.0}


def ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def snr(ref, out):
    ref, out = ref.double(), out.double()
    return float(10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-300)))


def operands(n, t, shape, dtype, seed, int8=False):
    d, h, o = shape
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
    x = torch.rand(n, d, t, generator=g).mul_(2.0).to("cuda", dtype)
    dy = torch.randn(n, t, o, generator=g).to("cuda", dtype)
    return x, dy, lstm.prepare_int8(fc) if int8 else lstm.packed(fc)


def forward_forms():
    """The forward sweeps' launches by form since the last call (a tree
    with one form: none), cleared."""
    forms = dict(getattr(lstm2, "FWD_SWEEP_FORMS", {}))
    if forms:
        lstm2.FWD_SWEEP_FORMS.clear()
    return forms


def full_band(dtypes):
    for dtype, (n, t) in ((dt, nt) for dt in dtypes for nt in ((7, 9), (18, 195))):
        name = str(dtype)[6:]
        x, dy, w = operands(n, t, FB, dtype, seed=n + t)
        y_ref, res_ref = lt.lstm2_train_fwd_reference(x, w)
        y, res = lt.lstm2_train_fwd(x, w)
        k2 = min(snr(a.float(), b.float()) for a, b in zip((y_ref, *res_ref), (y, *res)))
        ref = lt.lstm2_bwd_reference(dy, x, w, res_ref)
        k4 = min(snr(a.float(), b.float())
                 for a, b in zip(ref[:3], lt.lstm2_bwd_sweep(dy, x, w, res_ref)[:3]))
        want = lt.lstm2_bwd_plain(dy, x, w, res_ref, fused=True)
        got = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
        again = lt.lstm2_bwd(dy, x, w, res_ref, fused=True)
        k3 = min(snr(a.float(), b.float()) for a, b in zip(want, got))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"fb N{n} T{t} {name} against the plain versions: K2 {k2:.1f} dB, K4 {k4:.1f} dB, "
              f"K3 {k3:.1f} dB, K3 equal on a repeat: {repeat}; reverse sweeps by form "
              f"{dict(lt.SWEEP_FORMS)}, forward sweeps by form {forward_forms()}", flush=True)
        lt.SWEEP_FORMS.clear()
        if min(k2, k3, k4) < FLOOR[dtype] or not repeat:
            raise SystemExit(f"a {name} training kernel disagrees with its plain version")
        if n != 18:
            continue
        times = {
            "K2": ms(lambda: lt.lstm2_train_fwd(x, w)),
            "K2 plain": ms(lambda: lt.lstm2_train_fwd_reference(x, w)),
            "K4": ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res)),
            "K4 plain": ms(lambda: lt.lstm2_bwd_reference(dy, x, w, res)),
            "K3": ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True)),
            "K3 plain": ms(lambda: lt.lstm2_bwd_plain(dy, x, w, res, True)),
            "K4 + weight_grads": ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=False)),
        }
        lt.SWEEP_FORM = 0
        times["K4 tile form"] = ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res))
        times["K3 tile form"] = ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True))
        lt.SWEEP_FORM = None
        lstm2.FWD_SWEEP_FORM = 0
        times["K2 tile form"] = ms(lambda: lt.lstm2_train_fwd(x, w))
        lstm2.FWD_SWEEP_FORM = None
        print(f"fb N{n} T{t} {name} ms: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()),
              flush=True)


def folds(dtypes):
    for dtype in dtypes:
        name, faster = str(dtype)[6:], {"K2": [], "K4": []}
        for n in (18, 112, 256, 512, 768, 1024, 1280, 1536, 2112):
            x, dy, w = operands(n, 195, FB, dtype, seed=n)
            _, res = lt.lstm2_train_fwd(x, w)
            times = {}
            for kernel, module, attr, cluster, fn in (
                    ("K2", lstm2, "FWD_SWEEP_FORM", lstm2.FWD_CLUSTER,
                     lambda: lt.lstm2_train_fwd(x, w)),
                    ("K4", lt, "SWEEP_FORM", lt.SWEEP_CLUSTER,
                     lambda: lt.lstm2_bwd_sweep(dy, x, w, res))):
                for form, tag in ((cluster, "cluster form"), (0, "tile form")):
                    setattr(module, attr, form)
                    try:
                        times[f"{kernel} {tag}"] = ms(fn)
                    finally:
                        setattr(module, attr, None)
                if times[f"{kernel} cluster form"] < times[f"{kernel} tile form"]:
                    faster[kernel].append(n)
            rules = (lstm2.fwd_sweep_cluster(n, *FB, dtype), lt.bwd_sweep_cluster(n, *FB, dtype))
            print(f"fb N{n} T195 {name} ms: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
                  + "; the rules take (K2, K4) "
                  + ", ".join(f"clusters of {r}" if r else "the tile form" for r in rules),
                  flush=True)
            del x, dy, w, res
            torch.cuda.empty_cache()
        for kernel, at in faster.items():
            print(f"fb {name}: {kernel}'s cluster form is faster at N {at}", flush=True)


def digest(tensors):
    sha = hashlib.sha256()
    for a in tensors:
        sha.update(a.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return sha.hexdigest()[:16]


def shipped(dtypes):
    for dtype in dtypes:
        name = str(dtype)[6:]
        x, _, w = operands(2056, 629, SHIPPED, dtype, seed=10)
        outs = {"K1 N2056 T629": (lstm2.lstm2_fc(x, w),)}
        x, dy, w = operands(2304, 195, SHIPPED, dtype, seed=11)
        outs["K2 N2304 T195"] = (lambda y, res: (y, *res))(*lt.lstm2_train_fwd(x, w))
        _, res = lt.lstm2_train_fwd_reference(x, w)
        outs["K3 N2304 T195"] = lt.lstm2_bwd(dy, x, w, res, fused=True)
        outs["K4 N2304 T195"] = lt.lstm2_bwd_sweep(dy, x, w, res)[:3]
        if dtype == torch.bfloat16:
            xq, _, wq = operands(2056, 255, SHIPPED, dtype, seed=12, int8=True)
            outs["K5 N2056 T255"] = (lstm2_int8.lstm2_int8_fc(xq, wq),)
        xf, dyf, wf = operands(18, 195, FB, dtype, seed=13)
        _, res_f = lt.lstm2_train_fwd_reference(xf, wf)
        outs["K3 fb N18 T195 (reverse cluster form)"] = lt.lstm2_bwd(dyf, xf, wf, res_f, fused=True)
        outs["K4 fb N18 T195 (reverse cluster form)"] = lt.lstm2_bwd_sweep(dyf, xf, wf, res_f)[:3]
        torch.cuda.synchronize()
        for kernel, tensors in outs.items():
            print(f"shipped {name} {kernel} digest {digest(tensors)}", flush=True)
        del outs, xf, dyf, wf, res_f
        times = {"K3": ms(lambda: lt.lstm2_bwd(dy, x, w, res, fused=True), reps=5),
                 "K4": ms(lambda: lt.lstm2_bwd_sweep(dy, x, w, res), reps=5)}
        print(f"shipped N2304 T195 {name} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
        torch.cuda.empty_cache()


def main(args):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("float32 matmuls must run in full float32 (allow_tf32 is set)")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    print("tree:", os.getcwd(), flush=True)
    sources = ("lstm2_fwd", "lstm2_int8_fwd", "lstm2_train_fwd", "lstm2_bwd", "lstm2_bwd_wgrad")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        list(pool.map(nvcc.build, sources))
    dtypes = (torch.float32, torch.bfloat16)
    if "--shipped" in args:
        shipped(dtypes)
    elif "--folds" in args:
        folds(dtypes)
    else:
        full_band(dtypes)


if __name__ == "__main__":
    main(sys.argv[1:])
