"""FullSubNet+ in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `fullsubnet_plus_tpu`, which stays the reference
every module here is tested against (tests/test_torch_*.py). This package
imports torch, numpy, scipy and the standard library only.

Ported: the shipped enhancement mode
(`Enhancer.mag_complex_full_band_crm_mask`) on FullSubNet+ at full width,
in float32, bfloat16 and int8, the streaming engine (serve.py) and its TCP
daemon (cli/serve.py). The fused 2-layer sub-band LSTM forward is a
hand-written CUDA kernel in two forms: float (ops/lstm2.py,
csrc/lstm2_fwd.cu) and int8-recurrent, the serving default
(ops/lstm2_int8.py, csrc/lstm2_int8_fwd.cu). What is not ported yet raises
NotImplementedError naming its ROADMAP.md item.
"""
