# Frozen copy of heligym_tpu_torch/utils/constants.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Shared physical/unit constants (same values as the JAX package's
`heligym_tpu/utils/constants.py`, which mirror the reference simulator)."""
import math

EPS = 1e-4                  # small value guarding division by zero (dynamics)
R2D = 180.0 / math.pi       # rad -> deg
D2R = 1.0 / R2D             # deg -> rad
SQRT_3 = 1.7320508075688772
FT2MTR = 0.3048             # ft -> m
TWO_D_PI = 0.6366197723675814  # 2/pi

FPS = 50.0                  # simulation tick rate [Hz]
DT = 1.0 / FPS              # simulation step [s]

# RK4 combination constant, written exactly as the reference does so float32
# arithmetic matches bit-for-bit.
RK4_SIXTH = 0.16666666666666666
