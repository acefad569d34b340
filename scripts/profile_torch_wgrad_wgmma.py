"""Where the time of the port's wgmma weight-gradient kernels goes (K3's
`wgrad_wgmma_kernel` in bf16 and `wgrad_wgmma_tf32_kernel` in float32,
fullsubnet_plus_torch/csrc/lstm2_bwd_wgrad.cu).

    python3 scripts/profile_torch_wgrad_wgmma.py        (from the repo's root)

Needs an NVIDIA GPU and nvcc. Copies the package into a temporary directory
once per variant and edits the copy's kernels: as they are; the loads alone
(the TMA ring and its barriers, and in float32 the staging warpgroup's TF32
splits, without a product); the products alone (the ring's barriers
completed without a copy, so the products run on what shared memory holds,
and in float32 without the splits of G); and, in float32, one TF32 product
instead of three; in bf16, the sums not read back at a chunk's start (a
diagnostic: ptxas serialises the wgmma chain whose accumulators were loaded
from memory, and reports it as C7515, printed here as SERIALISED). It builds the variants' K3 libraries in parallel and
prints the registers and spills of their wgmma functions, then, one variant
after another, times at the training fold (N 2304, D 34, H 384, O 2, T 195,
the default scratch) the device time of the weight-gradient kernel in one
K3 call (torch.profiler, after one warm-up call) at each wgmma tile of
WGRAD_H_TILES and WGRAD_F32_TILES, and at the rule's mma.sync tile beside
them. The variants that take work out compute wrong gradients; they only
time. Imports nothing of JAX.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WGRAD = "csrc/lstm2_bwd_wgrad.cu"
N, D, H, O, T = 2304, 34, 384, 2, 195
BF16_PRODUCTS = "      wgmma::wgmma_bf16_n256(acc, da, db, 1);"
TF32_PRODUCTS = """      wgmma::wgmma_tf32_n128(part, a_small[h], db_big, kk > 0);
      wgmma::wgmma_tf32_n128(part, a_big[h], db_small, 1);
      wgmma::wgmma_tf32_n128(part, a_big[h], db_big, 1);"""
# variant: [(file, text, its replacement, occurrences), ...]
VARIANTS = {
    "as committed": [],
    "the loads alone": [
        (WGRAD, BF16_PRODUCTS, "      (void)da, (void)db;", 1),
        (WGRAD, TF32_PRODUCTS, "      (void)db_big, (void)db_small;", 1)],
    "the products alone": [
        (WGRAD, "lstm2::mbar_arrive_expect(bar, bytes);", "mbar_arrive(bar);", 2),
        (WGRAD, "wgmma::tma_load_3d(dst", "if (0) wgmma::tma_load_3d(dst", 4),
        (WGRAD, "i < BN * BK / 4; i += SPLITTERS", "i < 0; i += SPLITTERS", 1)],
    "one TF32 product instead of three": [
        (WGRAD, TF32_PRODUCTS, "      wgmma::wgmma_tf32_n128(part, a_big[h], db_big, kk > 0);", 1)],
    "bf16 sums not read back": [(WGRAD, "if (!first && k < w.K && c < G)", "if (0)", 1)],
}


def make_variant(root: Path, edits) -> Path:
    """A copy of the package under root with its sources edited; each edited
    text must appear as often as the edit says."""
    package = root / "fullsubnet_plus_torch"
    shutil.copytree(REPO / "fullsubnet_plus_torch", package,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, old, new, count in edits:
        path = package / name
        text = path.read_text()
        if text.count(old) != count:
            raise SystemExit(f"{name} no longer has {count} of {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return root


def registers_and_spills(root: Path) -> str:
    """The registers and spill stores of each wgmma function in the
    variant's ptxas report."""
    report = next((root / "fullsubnet_plus_torch" / "_build").glob("lstm2_bwd_wgrad_*.ptxas.txt"))
    out, function = [], None
    for line in report.read_text().splitlines():
        if "C7515" in line:  # wgmma serialised by ptxas
            out.append("SERIALISED " + re.sub(r".*function '(.*)'", r"\1", line)[-70:])
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and (m := re.search(r"(wgrad_wgmma_(?:tf32_)?kernel)ILi(\d+)E", function)):
            if s := re.search(r"(\d+) bytes spill stores", line):
                out.append(f"{m[1]}<{m[2]}>: {s[1]} B spill stores")
            elif r := re.search(r"Used (\d+) registers", line):
                out.append(f"{m[1]}<{m[2]}>: {r[1]} registers")
    return ", ".join(out)


def time_here() -> None:
    """Run inside a variant's copy: the weight-gradient kernel's device time
    in one K3 call at each wgmma tile and at the rule's mma.sync tile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    wgrad = re.compile(r"wgrad_(mma_|tf32_|wgmma_(tf32_)?)?kernel|wgmma_reduce_kernel")
    cells = []
    for dtype, tiles in ((torch.bfloat16, lt.WGRAD_H_TILES), (torch.float32, lt.WGRAD_F32_TILES)):
        g = torch.Generator().manual_seed(3)
        lstm, fc = LSTM2(D, H), Linear(H, O)
        lstm.reset_parameters(g)
        fc.reset_parameters(g)
        lstm, fc = lstm.to("cuda", dtype), fc.to("cuda", dtype)
        x = torch.rand(N, D, T, generator=g).mul_(2.0).to("cuda", dtype)
        dy = torch.randn(N, T, O, generator=g).to("cuda", dtype)
        w = lstm.packed(fc)
        _, res = lt.lstm2_train_fwd_reference(x, w)  # only K3 is built in the variant
        mma = 0 if dtype == torch.bfloat16 else 4  # the rule's mma.sync tile before wgmma
        for shape in [mma, *(i for i, tile in enumerate(tiles) if lt.wgmma_tile(tile))]:
            lt.force_wgrad_tile(shape, dtype)
            lt.lstm2_bwd(dy, x, w, res, fused=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lt.lstm2_bwd(dy, x, w, res, fused=True)
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and wgrad.search(e.key)) / 1e3
            cells.append(f"{str(dtype)[6:]} {'x'.join(map(str, tiles[shape]))} {ms:.3f} ms")
        lt.force_wgrad_tile(None, dtype)
        del res
        torch.cuda.empty_cache()
    print(" | ".join(cells), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="wgmma_variants_") as tmp:
        roots = {name: make_variant(Path(tmp) / str(i), edits)
                 for i, (name, edits) in enumerate(VARIANTS.items())}

        def run(root, *args):
            env = {**os.environ, "PYTHONPATH": str(root)}
            return subprocess.Popen([sys.executable, *args], cwd=root, env=env)

        builds = [run(root, "-c", "from fullsubnet_plus_torch.ops import nvcc; "
                                  "nvcc.build('lstm2_bwd_wgrad')") for root in roots.values()]
        if [b.wait() for b in builds] != [0] * len(builds):
            raise SystemExit("a variant did not build")
        for name, root in roots.items():
            print(f"{name}: ptxas {registers_and_spills(root)}")
        for name, root in roots.items():
            print(f"{name}: ", end="", flush=True)
            if run(root, str(Path(__file__).resolve()), "--time").wait() != 0:
                raise SystemExit(f"{name} failed")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_here()
    else:
        main()
