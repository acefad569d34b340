"""FullSubNet+ in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `fullsubnet_plus_tpu`, which stays the reference
every module here is tested against (tests/test_torch_*.py). This package
imports torch, numpy, scipy and the standard library only.

Scope of this slice: the shipped enhancement mode
(`Enhancer.mag_complex_full_band_crm_mask`) on FullSubNet+ at full width,
in float32 and bfloat16, with the fused 2-layer sub-band LSTM forward as a
hand-written CUDA kernel (ops/lstm2.py, csrc/lstm2_fwd.cu). What is not
ported yet raises NotImplementedError naming its ROADMAP.md item.
"""
