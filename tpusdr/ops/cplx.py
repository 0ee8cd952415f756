"""Real-pair complex arithmetic — the device-side complex representation.

The framework's device path represents a complex stream explicitly as a
``Complex(re, im)`` pair of float32 arrays — a pytree, so it flows through
jit/scan/shard_map unchanged, and every op is plain float math.  The layout
was forced by the former target, whose backend had no complex dtype; the
GPU has one, and whether native complex64 is faster there is open
(ROADMAP Queue 3, item 2).

``ensure_pair`` / ``maybe_native`` let the pure-math ops accept either
representation: CPU-side tests use numpy complex oracles, the device path
stays pair-native end to end.

(The reference's equivalent decision: cuComplex float2 pairs throughout the
CUDA path — /root/reference/src/filters/Fir.cpp:244 et al.)
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np

import jax.numpy as jnp


class Complex(NamedTuple):
    """A complex tensor as a (re, im) pair of equal-shape real tensors."""

    re: jnp.ndarray
    im: jnp.ndarray

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, Complex):
            return Complex(self.re + other.re, self.im + other.im)
        return Complex(self.re + other, self.im)

    def __sub__(self, other):
        if isinstance(other, Complex):
            return Complex(self.re - other.re, self.im - other.im)
        return Complex(self.re - other, self.im)

    def __mul__(self, other):
        if isinstance(other, Complex):
            return Complex(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return Complex(self.re * other, self.im * other)

    __rmul__ = __mul__

    def conj(self) -> "Complex":
        return Complex(self.re, -self.im)

    def abs2(self) -> jnp.ndarray:
        return self.re * self.re + self.im * self.im

    def abs(self) -> jnp.ndarray:
        return jnp.sqrt(self.abs2())

    # -- structure ----------------------------------------------------------

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def __getitem__(self, idx):
        return Complex(self.re[idx], self.im[idx])

    def astype(self, dtype):
        return Complex(self.re.astype(dtype), self.im.astype(dtype))

    def reshape(self, *shape):
        return Complex(self.re.reshape(*shape), self.im.reshape(*shape))


CLike = Union[Complex, jnp.ndarray, np.ndarray]


def is_pair(x) -> bool:
    return isinstance(x, Complex)


def is_complex(x) -> bool:
    return is_pair(x) or jnp.iscomplexobj(x)


def ensure_pair(x: CLike) -> Complex:
    """Complex array (or pair) -> pair; real array -> pair with zero imag."""
    if is_pair(x):
        return x
    if jnp.iscomplexobj(x):
        return Complex(jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32))
    x = jnp.asarray(x)
    return Complex(x, jnp.zeros_like(x))


def maybe_native(y: Complex, proto: CLike) -> CLike:
    """Return pair if the prototype input was a pair, else native complex64
    (CPU test convenience — never used on the device path)."""
    if is_pair(proto):
        return y
    return (y.re + 1j * y.im).astype(jnp.complex64)


def to_numpy(x: CLike) -> np.ndarray:
    if is_pair(x):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    return np.asarray(x)


def from_numpy(z: np.ndarray) -> Complex:
    return Complex(
        jnp.asarray(np.real(z).astype(np.float32)),
        jnp.asarray(np.imag(z).astype(np.float32)),
    )


def zeros(shape, dtype=jnp.float32) -> Complex:
    return Complex(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def concat(parts, axis=-1) -> Complex:
    return Complex(
        jnp.concatenate([p.re for p in parts], axis=axis),
        jnp.concatenate([p.im for p in parts], axis=axis),
    )


def stack_ri(x: Complex, axis=0) -> jnp.ndarray:
    """Pack (re, im) along a new axis (for batched real kernels)."""
    return jnp.stack([x.re, x.im], axis=axis)


def unstack_ri(x: jnp.ndarray, axis=0) -> Complex:
    re, im = jnp.split(x, 2, axis=axis)
    return Complex(jnp.squeeze(re, axis), jnp.squeeze(im, axis))


def expj(theta: jnp.ndarray) -> Complex:
    """exp(j*theta) for real theta."""
    return Complex(jnp.cos(theta), jnp.sin(theta))
