"""FullSubNet+ in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `fullsubnet_plus_tpu`, which stays the reference
every module here is tested against (tests/test_torch_*.py). This package
imports torch, numpy, scipy and the standard library only.

Ported: FullSubNet+ and the FullSubNet baseline at full width, every
inference mode of the Enhancer (enhance.py; the shipped
`mag_complex_full_band_crm_mask` on FullSubNet+, `full_band_crm_mask` on
FullSubNet) in float32, bfloat16 and int8, the streaming engine (serve.py)
and its TCP daemon (cli/serve.py), FullSubNet+'s training step and both
models' evaluation steps (train/step.py), and the training driver: the CLI
(cli/train.py), the Trainer with validation metrics and checkpoints in the
JAX package's `.npz` layout (train/trainer.py, eval/, io/checkpoint.py),
the supervisor and the dynamic-mixing input pipeline (data/), and
multi-device runs (parallel/: data-parallel training one rank per card, a
mesh of a process's cards for enhancement and validation). The fused
2-layer LSTMs (the sub-band model of both, FullSubNet's full-band model)
run through hand-written CUDA kernels: the float forward (ops/lstm2.py,
csrc/lstm2_fwd.cu), the int8-recurrent forward, the serving default
(ops/lstm2_int8.py, csrc/lstm2_int8_fwd.cu), and for training the
residual-saving forward and the two reverse-sweep backwards behind a
torch.autograd.Function (ops/lstm2_train.py, csrc/lstm2_train_fwd.cu,
csrc/lstm2_bwd_wgrad.cu, csrc/lstm2_bwd.cu). What is not ported yet raises
NotImplementedError naming its ROADMAP.md item.
"""
