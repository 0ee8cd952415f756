"""Math primitives built from basic ops.

``atan2`` here is atan plus branch-free quadrant correction — pure
select/add, numerically identical to libm atan2 to float32 precision.  The
former target's backend had no atan2; on the GPU, whether jnp.arctan2 is
faster is open (ROADMAP Queue 3, item 2).
Used by the FM discriminator (ops/demod.py).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_PI = np.float32(np.pi)
_PI_2 = np.float32(np.pi / 2)


def atan2(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Four-quadrant arctangent from single-argument atan.

    Matches jnp.arctan2 within float32 rounding for all finite inputs,
    including the x==0 and y==0 axes.
    """
    x_zero = x == 0
    safe_x = jnp.where(x_zero, jnp.ones_like(x), x)
    base = jnp.arctan(y / safe_x)
    # Quadrant correction for x<0: add pi with the sign of y (treating
    # y==0 as +0 -> +pi, matching libm).
    y_sign = jnp.where(y < 0, jnp.float32(-1.0), jnp.float32(1.0))
    corrected = jnp.where(x < 0, base + y_sign * _PI, base)
    # x == 0 axis: +-pi/2 by sign of y; (0, 0) -> 0.
    on_axis = jnp.where(y == 0, jnp.zeros_like(y), y_sign * _PI_2)
    return jnp.where(x_zero, on_axis, corrected)
