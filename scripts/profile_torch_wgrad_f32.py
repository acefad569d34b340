"""Where the time of the port's float32 weight-gradient kernel goes (K3's
`wgrad_tf32_kernel`, fullsubnet_plus_torch/csrc/lstm2_bwd_wgrad.cu).

    python3 scripts/profile_torch_wgrad_f32.py        (from the repo's root)

Needs an NVIDIA GPU and nvcc. Copies the package into a temporary directory
once per variant and edits the copy's kernel: as it is; with a k-step's A
fragments all loaded first and its three products issued kind by kind
over all the warp's tiles (small.big for every tile, then big.small, then
big.big: each tile's sum order kept, so the same bits); without the
operands' cp.async copies into the ring (the products run on what the ring
holds); without the TF32 splits (both halves are the raw word: the three
products stay); with one TF32 product instead of three; without the
products (an XOR of the split words into the partial instead, so the
fragment loads and splits stay); with the copies and barriers alone (no
fragment load, split or product); and without the copies and the splits.
The variants without the copies take out the cp.async copies, so their
bulk-copy tiles run as committed.
It builds the variants' K3 libraries in parallel and prints the registers
and spills of their float32 weight-gradient functions, then, one variant
after another, times at the training fold (N 2304, D 34, H 384, O 2, T 195;
the scratch holding 8 steps) the device time of the float32 weight-gradient
kernel in one K3 call (torch.profiler, after one warm-up call) at each
tile of WGRAD_F32_TILES. The variants that take work out compute wrong
gradients; they only time. Imports nothing of JAX.
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
SCRATCH_STEPS = 8
COPIES_OUT = [
    (WGRAD, "cp_async16(as + (r * LDA + kk) * 4, ok ? At + (size_t)n * lda + k0 + kk : A, ok);",
     "if (0) cp_async16(as + (r * LDA + kk) * 4, ok ? At + (size_t)n * lda + k0 + kk : A, ok);"),
    (WGRAD, "cp_async16(gs + (r * LDG + cc) * 4, ok ? Gt + (size_t)n * G + c0 + cc : Gm, ok);",
     "if (0) cp_async16(gs + (r * LDG + cc) * 4, ok ? Gt + (size_t)n * G + c0 + cc : Gm, ok);"),
]
SPLITS_OUT = [(WGRAD, "lstm2::split_tf32(__float_as_uint(v), big, small);",
               "big = small = __float_as_uint(v);")]
PRODUCT = ("lstm2::mma_3xtf32(part[i][j], a_big, a_small, b_big[j][0], b_big[j][1], "
           "b_small[j][0],\n                            b_small[j][1]);")
# the m-tile loop of a k-step, and the same with all MI A fragments loaded first and the
# three products issued kind by kind over all the warp's tiles (each tile's sum order kept)
TILE_LOOP = """#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t a_big[4], a_small[4];
        const float* p = as + 8 * ks * LDA + 16 * i;
        split_word(p[0], a_big[0], a_small[0]);
        split_word(p[8], a_big[1], a_small[1]);
        split_word(p[4 * LDA], a_big[2], a_small[2]);
        split_word(p[4 * LDA + 8], a_big[3], a_small[3]);
#pragma unroll
        for (int j = 0; j < NI; ++j)
          lstm2::mma_3xtf32(part[i][j], a_big, a_small, b_big[j][0], b_big[j][1], b_small[j][0],
                            b_small[j][1]);
      }"""
KIND_MAJOR = """uint32_t a_big[MI][4], a_small[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* p = as + 8 * ks * LDA + 16 * i;
        split_word(p[0], a_big[i][0], a_small[i][0]);
        split_word(p[8], a_big[i][1], a_small[i][1]);
        split_word(p[4 * LDA], a_big[i][2], a_small[i][2]);
        split_word(p[4 * LDA + 8], a_big[i][3], a_small[i][3]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) lstm2::mma_tf32(part[i][j], a_small[i], b_big[j][0], b_big[j][1]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) lstm2::mma_tf32(part[i][j], a_big[i], b_small[j][0], b_small[j][1]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) lstm2::mma_tf32(part[i][j], a_big[i], b_big[j][0], b_big[j][1]);"""
# variant: [(file, text, its replacement), ...]
VARIANTS = {
    "as committed": [],
    "the products kind by kind over the warp's tiles": [(WGRAD, TILE_LOOP, KIND_MAJOR)],
    "without the copies": COPIES_OUT,
    "without the TF32 splits": SPLITS_OUT,
    "one TF32 product instead of three": [
        (WGRAD, PRODUCT, "lstm2::mma_tf32(part[i][j], a_big, b_big[j][0], b_big[j][1]);")],
    "without the products": [
        (WGRAD, PRODUCT, "part[i][j][0] += __uint_as_float(a_big[0] ^ a_small[1] ^ b_big[j][0] "
                         "^ b_small[j][1]);")],
    "the copies and barriers alone": [
        (WGRAD, "for (int ks = 0; ks < BK / 8; ++ks) {", "for (int ks = 0; ks < 0 * BK; ++ks) {")],
    "without the copies and the splits": COPIES_OUT + SPLITS_OUT,
}


def make_variant(root: Path, edits) -> Path:
    """A copy of the package under root with its sources edited; each edited
    text must appear exactly once in its file."""
    package = root / "fullsubnet_plus_torch"
    shutil.copytree(REPO / "fullsubnet_plus_torch", package,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, old, new in edits:
        path = package / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name} no longer has exactly one {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return root


def registers_and_spills(root: Path) -> str:
    """The registers and spill stores of each float32 weight-gradient
    function (one a tile shape) in the variant's ptxas report."""
    report = next((root / "fullsubnet_plus_torch" / "_build").glob("lstm2_bwd_wgrad_*.ptxas.txt"))
    out, function = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and "wgrad_tf32_kernel" in function:
            shape = re.search(r"wgrad_tf32_kernelILi(\d+)E", function)[1]
            if m := re.search(r"(\d+) bytes spill stores", line):
                out.append(f"tile {shape}: {m[1]} B spill stores")
            elif m := re.search(r"Used (\d+) registers", line):
                out.append(f"tile {shape}: {m[1]} registers")
    return ", ".join(out)


def time_here() -> None:
    """Run inside a variant's copy: the float32 weight-gradient kernel's
    device time in one K3 call at each tile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2
    from fullsubnet_plus_torch.ops import lstm2_train as lt

    g = torch.Generator().manual_seed(3)
    lstm, fc = LSTM2(D, H), Linear(H, O)
    lstm.reset_parameters(g)
    fc.reset_parameters(g)
    lstm, fc = lstm.cuda(), fc.cuda()
    x = torch.rand(N, D, T, generator=g).mul_(2.0).cuda()
    dy = torch.randn(N, T, O, generator=g).cuda()
    w = lstm.packed(fc)
    _, res = lt.lstm2_train_fwd_reference(x, w)  # only K3 is built in the variant
    lt.WGRAD_SCRATCH_BYTES[torch.float32] = lt.WAVE_SCRATCH_BYTES[torch.float32] = \
        SCRATCH_STEPS * 2 * N * 4 * H * 4
    cells = []
    for shape, tile in enumerate(lt.WGRAD_F32_TILES):
        lt.force_wgrad_tile(shape, torch.float32)
        lt.lstm2_bwd(dy, x, w, res, fused=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lt.lstm2_bwd(dy, x, w, res, fused=True)
            torch.cuda.synchronize()
        wgrad = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "wgrad_tf32_kernel" in e.key)
        cells.append(f"{'x'.join(map(str, tile))} {wgrad / 1e3:.2f} ms")
    print(" | ".join(cells), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory(prefix="wgrad_variants_") as tmp:
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
