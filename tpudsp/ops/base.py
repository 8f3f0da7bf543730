"""Shared machinery for the reference-compatible op classes.

Each op mirrors one reference class (names, kwargs, defaults from
wrapper.cpp) as a thin Python object holding an explicit state pytree and
dispatching to jitted kernels: `__call__` = array in / array out, state
carried between calls exactly as the reference's opaque liquid handles
carry theirs (SURVEY.md L2->L3 mapping).

Capability upgrades over the reference (mandated by SURVEY.md section 5):
every op exposes ``state`` (a serializable pytree) and ``with_state`` for
checkpoint/resume, which the reference cannot do (liquid state is opaque).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def as_c64(x, name="input"):
    x = np.asarray(x)
    if x.dtype not in (np.complex64, np.complex128):
        raise TypeError(f"{name}: expected complex64 array, got dtype {x.dtype}")
    if x.ndim != 1:
        raise TypeError(f"{name}: expected 1-D array, got shape {x.shape}")
    # dtype coercion in NumPy, then a plain transfer: jnp.asarray with a
    # differing dtype would be an eager on-device convert
    return jnp.asarray(np.asarray(x, np.complex64))


def as_f32(x, name="input"):
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating) and not np.issubdtype(x.dtype, np.integer):
        raise TypeError(f"{name}: expected float32 array, got dtype {x.dtype}")
    if x.ndim != 1:
        raise TypeError(f"{name}: expected 1-D array, got shape {x.shape}")
    return jnp.asarray(np.asarray(x, np.float32))


class StatefulOp:
    """Base: explicit-state op. Subclasses set self._state (pytree).

    Construction/reset are design-time: tiny NumPy math plus jnp constant
    creation. Those jnp creations are EAGER ops -- on a GPU each compiles
    and launches its own small kernel -- so every subclass ``__init__``
    and ``reset`` runs host-backed (utils/hostbuild.host_build): params
    land uncommitted on the host CPU backend when one is registered and
    move to the accelerator as plain transfers on the first jitted step.
    ``__call__`` is never wrapped (compute must dispatch to the
    accelerator)."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        import functools

        for name in ("__init__", "reset"):
            if name in cls.__dict__:
                orig = cls.__dict__[name]

                def wrapped(self, *a, _orig=orig, **k):
                    from ..utils.hostbuild import host_build
                    return host_build(_orig, self, *a, **k)

                setattr(cls, name, functools.wraps(orig)(wrapped))

    @property
    def state(self):
        """The op's full DSP state as a host pytree (checkpointable)."""
        return jax.tree.map(np.asarray, self._state)

    def with_state(self, state):
        """Resume from a previously captured state pytree."""
        self._state = jax.tree.map(jnp.asarray, state)
        return self
