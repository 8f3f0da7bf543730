"""AGC op class (reference agc.hpp:4-149, agc_docs.cpp, wrapper.cpp:228-242).

AGC(): automatic gain control + squelch on complex IQ. Property surface and
semantics follow the reference's documented contract exactly (agc_docs.cpp):
output = scale * gain * iq, zeroed in squelch states ENABLED(1)/SIGNALLO(5);
``onRise`` fires on transitions into RISE(2).

Block reformulation (SURVEY.md section 3.5): the kernel returns a per-sample
squelch-state tensor; callbacks fire host-side after the block -- events
become data. The reference's cross-instance shared-static squelch-edge bug
(agc.hpp:110, SURVEY.md Q2) is fixed: edge state is per-instance.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..kernels import agc as kagc
from ..kernels.warmup import chunk_for, warmup_for
from .base import StatefulOp, as_c64

_agc_exact = jax.jit(kagc.agc_apply)

# chunked kernels are jit-cached per (chunk, warmup) -- the warmup window
# is DERIVED from the live loop bandwidth at call time (kernels/warmup.py),
# never frozen
_agc_chunked_cache = {}


def _agc_chunked(params, state, x, chunk, warmup):
    key = (chunk, warmup)
    if key not in _agc_chunked_cache:
        _agc_chunked_cache[key] = jax.jit(
            partial(kagc.agc_apply_chunked, chunk=chunk, warmup=warmup))
    return _agc_chunked_cache[key](params, state, x)


class AGC(StatefulOp):
    def __init__(self, throughput_mode: bool = False):
        # throughput_mode selects the chunk-parallel kernel (documented
        # ~-86 dB approximation); default is the exact sequential scan.
        self._throughput = bool(throughput_mode)
        self._bandwidth = 0.01       # liquid agc default loop bandwidth
        self._squelch = False
        self._threshold = 0.0
        self._timeout = 100
        self._lock = False
        self._scale = 1.0
        self._onRise = None
        self._edge_state = kagc.SQ_UNKNOWN  # per-instance (Q2 fix)
        self._state = kagc.agc_init()

    # -- properties (wrapper.cpp:230-239) -------------------------------------
    @property
    def squelch(self):
        """Enable/disable squelch (agc_docs.cpp squelch_doc)."""
        return self._squelch

    @squelch.setter
    def squelch(self, val):
        self._squelch = bool(val)
        mode = kagc.SQ_ENABLED if self._squelch else kagc.SQ_DISABLED
        self._state = self._state._replace(sq_mode=jnp.int32(mode))

    @property
    def threshold(self):
        """Squelch trigger level in dB (agc_docs.cpp threshold_doc)."""
        return self._threshold

    @threshold.setter
    def threshold(self, t):
        self._threshold = float(t)

    @property
    def bandwidth(self):
        """Gain-loop bandwidth / settling rate (agc_docs.cpp bandwidth_doc)."""
        return self._bandwidth

    @bandwidth.setter
    def bandwidth(self, bw):
        self._bandwidth = float(bw)

    @property
    def level(self):
        """Current input linear level estimate = 1/gain (liquid
        agc_crcf_get_signal_level)."""
        return 1.0 / float(self._state.g)

    @level.setter
    def level(self, lvl):
        self._state = self._state._replace(g=jnp.float32(1.0 / max(float(lvl), 1e-30)))

    @property
    def level_dB(self):
        """Current input level in dB = -20 log10(gain) (liquid rssi)."""
        return -20.0 * float(np.log10(max(float(self._state.g), 1e-30)))

    @level_dB.setter
    def level_dB(self, rssi):
        self._state = self._state._replace(g=jnp.float32(10.0 ** (-float(rssi) / 20.0)))

    @property
    def lock(self):
        """When True, gain updates are frozen; level estimation continues
        (agc_docs.cpp lock_doc)."""
        return self._lock

    @lock.setter
    def lock(self, val):
        self._lock = bool(val)

    @property
    def gain(self):
        """Current linear gain (agc_docs.cpp gain_doc)."""
        return float(self._state.g)

    @gain.setter
    def gain(self, g):
        self._state = self._state._replace(g=jnp.float32(g))

    @property
    def scale(self):
        """Linear output scale (agc_docs.cpp scale_doc)."""
        return self._scale

    @scale.setter
    def scale(self, s):
        self._scale = float(s)

    @property
    def status(self):
        """Squelch FSM state, numbering per agc_docs.cpp:53-72."""
        return int(self._state.sq_mode)

    @property
    def onRise(self):
        """No-arg callable fired on squelch transition to RISE
        (agc_docs.cpp onRise_doc)."""
        return self._onRise

    @onRise.setter
    def onRise(self, clb):
        self._onRise = clb

    def print(self):
        print(
            f"agc [bw: {self._bandwidth:.4f}, gain: {self.gain:.3e}, "
            f"rssi: {self.level_dB:.2f} dB, squelch: {self._squelch}, "
            f"threshold: {self._threshold:.1f} dB, lock: {self._lock}, "
            f"scale: {self._scale:.3e}, status: {self.status}]"
        )

    def reset(self):
        """Reset to defaults; cancels lock and squelch in the process
        (agc_docs.cpp reset_doc)."""
        self._lock = False
        self._squelch = False
        self._state = kagc.agc_init(squelch=False, timeout=self._timeout)
        self._edge_state = kagc.SQ_UNKNOWN

    def __call__(self, inp):
        xj = as_c64(inp)
        params = kagc.make_params(
            alpha=self._bandwidth, locked=self._lock, squelch=self._squelch,
            threshold=self._threshold, timeout=self._timeout, scale=self._scale,
        )
        if self._throughput:
            warmup = warmup_for(
                agc_alpha=self._bandwidth,
                squelch_timeout=self._timeout if self._squelch else 0)
            chunk = chunk_for(warmup)
            self._state, (y, modes) = _agc_chunked(
                params, self._state, xj, chunk=chunk, warmup=warmup)
        else:
            self._state, (y, modes) = _agc_exact(params, self._state, xj)
        if self._squelch and self._onRise is not None:
            modes_h = np.asarray(modes)
            prev = np.concatenate([[self._edge_state], modes_h[:-1]])
            n_rises = int(((modes_h == kagc.SQ_RISE) & (prev != kagc.SQ_RISE)).sum())
            for _ in range(n_rises):
                self._onRise()
            self._edge_state = int(modes_h[-1])
        elif self._squelch:
            self._edge_state = int(np.asarray(modes)[-1])
        return np.asarray(y)
