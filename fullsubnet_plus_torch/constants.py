"""Numerical constants of the port (its own copy of what it needs from
fullsubnet_plus_tpu/constants.py)."""

import numpy as np

# float32 machine epsilon: the denominator guard of the cIRM and of the
# SI-SNR loss (reference audio_zen/constant.py:8)
EPSILON = float(np.finfo(np.float32).eps)
