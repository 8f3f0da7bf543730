"""Precision of the float32 matrix products and convolutions on the chains'
paths.

On the GPU an f32 dot or convolution with no stated precision may run in
TF32 (about three decimal digits), far below the chains' fidelity bars.
Every dot_general and conv_general_dilated in tpudsp/kernels and
tpudsp/chains passes ``precision=MATMUL``; the value is read when a step
is traced.
"""

from jax import lax

MATMUL = lax.Precision.HIGHEST
