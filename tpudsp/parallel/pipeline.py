"""PP analog: receiver-chain STAGES on different devices, blocks streamed
through (SURVEY.md section 2.3 row "PP": stage parallelism; the reference
runs every stage on one thread, SURVEY.md section 3.3).

The AM chain splits at its natural compute boundary:

  stage 0 (device 0):    fused bandpass+resample front end -- blocked
                         matmuls at the 2 Msps input rate;
  stage 1 (VPU device):  AGC -> AmpModem(PLL) -> de-emphasis -- the
                         chunk-parallel feedback scans at the 48 kHz rate.

Both stages execute CONCURRENTLY inside one jitted SPMD step over a
2-device ``stage`` mesh axis: at call t, device 0 runs the front end on
block t while device 1 runs the back end on block t-1's baseband; a single
``ppermute`` hands the activation to the next stage for call t+1. Steady
state overlaps the two stages' wall time (software pipelining, one-block
latency, fill/drain bubbles only at stream start/end).

Per-stage state carries a leading stage axis so each device owns its
stage's slice (front: resampler tail; back: AGC/PLL/de-emphasis carries;
in-flight activation buffer); non-owners update their slice as identity.
The streamed output equals the single-chip fused AM receiver exactly
(tests/test_pipeline.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..chains.am import AMConfig, AMParams, AMState, _back_end, _rational, build
from ..kernels import decimate as kdec
from .mesh import to_varying

STAGE_AXIS = "stage"
N_STAGES = 2


class AMPipeState(NamedTuple):
    rs_tail: jnp.ndarray   # (S, kf) complex64: stage-0 fused front-end tail
    agc: object            # AgcState, leaves stage-stacked (S, ...)
    am: object             # AmpDemodState, leaves stage-stacked
    deemph: jnp.ndarray    # (S,) float32
    buf: jnp.ndarray       # (S, n_out) complex64: stage-1 in-flight baseband


def _stack(tree, s: int):
    return jax.tree.map(lambda x: jnp.stack([x] * s), tree)


def _local(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _relift(tree):
    return jax.tree.map(lambda x: x[None], tree)


def pipeline_step(params: AMParams, state: AMPipeState, iq, valid, *,
                  cfg: AMConfig, exact: bool, backend: str, n_out: int):
    """Per-device body under shard_map over ``stage``. Each device sees its
    stage's state slice with a local leading axis of 1. Returns
    (state-with-axes, pcm (1, n_out)): the last stage's row is block t-1's
    audio. ``valid`` (scalar bool) is False only on the fill call, when the
    in-flight buffer holds no real block yet -- the back end must then be
    an identity, or silence would wind the AGC gain up before the first
    real block arrives."""
    s_idx = lax.axis_index(STAGE_AXIS)
    P_, Q = _rational(cfg.rate)
    nj = n_out // P_

    rs_tail = state.rs_tail[0]

    def front():
        # taps come offset-folded from chains/am.build (fold_offsets);
        # wire-format feeds ((N, 2) int16/uint8) convert inside the
        # stage-0 matmul, so only stage 0 ever touches wire samples
        if iq.ndim == 2 and iq.dtype == jnp.uint8:
            return kdec.fused_frontend_apply_shared_u8(
                params.taps_fused, params.u8_dc, rs_tail, iq, Q, nj)
        if iq.ndim == 2:
            return kdec.fused_frontend_apply_shared_i16(
                params.taps_fused, rs_tail, iq, Q, nj)
        return kdec.fused_frontend_apply_shared(
            params.taps_fused, rs_tail, iq, Q, nj)

    new_tail, act = lax.cond(
        s_idx == 0, front,
        # constants are replicated; mark them stage-varying to match the
        # live branch under check_vma
        lambda: (rs_tail, to_varying(jnp.zeros((n_out,), jnp.complex64),
                                     STAGE_AXIS)))

    back_in = AMState(
        fir_tail=jnp.zeros((0,), jnp.complex64),
        rs_tail=jnp.zeros((0,), jnp.complex64),
        agc=_local(state.agc), am=_local(state.am), deemph=state.deemph[0])

    def back():
        agc_s, am_s, d_s, pcm, _modes = _back_end(
            params, back_in, state.buf[0], cfg, exact, backend)
        return agc_s, am_s, d_s, pcm

    agc_s, am_s, d_s, pcm = lax.cond(
        jnp.logical_and(s_idx == 1, valid), back,
        lambda: (back_in.agc, back_in.am, back_in.deemph,
                 to_varying(jnp.zeros((n_out,), jnp.float32), STAGE_AXIS)))

    # hand the activation to the next stage (device 0 -> device 1)
    new_buf = lax.ppermute(act, STAGE_AXIS, [(0, 1)])

    new_state = AMPipeState(
        rs_tail=new_tail[None], agc=_relift(agc_s), am=_relift(am_s),
        deemph=d_s[None], buf=new_buf[None])
    return new_state, pcm[None]


def make_stage_mesh(devices=None) -> Mesh:
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    if len(devices) < N_STAGES:
        raise ValueError(f"pipeline needs {N_STAGES} devices")
    return Mesh(np.asarray(devices[:N_STAGES]), (STAGE_AXIS,))


class PipelinedAMReceiver:
    """Two-device pipelined AM receiver: front end and back end execute
    concurrently on different chips, one IQ block in flight.

    ``__call__(iq)`` returns the pcm for the PREVIOUS block (None on the
    first call); ``flush()`` drains the last block with a zero-filled
    feed. Streamed output is exactly the single-chip AMReceiver's
    (fused plan, same exact/backend settings)."""

    def __init__(self, cfg: AMConfig = AMConfig(), block_len: int = 1_000_000,
                 mesh: Mesh | None = None, exact: bool = False,
                 backend: str = "xla", input_format: str = "c64"):
        if _rational(cfg.rate) is None:
            raise ValueError("pipelined receiver needs a rational rate")
        self.cfg = cfg
        self.block_len = int(block_len)
        self.input_format = input_format
        self.mesh = mesh if mesh is not None else make_stage_mesh()
        from ..utils.hostbuild import host_build
        self.params, self._st0, self.n_out = host_build(
            build, cfg, self.block_len, input_format)
        self.reset()

        stage_specs = jax.tree.map(
            lambda x: P(STAGE_AXIS, *(None,) * (x.ndim - 1)), self.state)
        body = partial(pipeline_step, cfg=cfg, exact=exact, backend=backend,
                       n_out=self.n_out)
        mapped = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(), stage_specs, P(), P()),
            out_specs=(stage_specs, P(STAGE_AXIS, None)),
        )
        self._step = jax.jit(mapped)

    def __call__(self, iq):
        if self.input_format in ("i16", "u8"):
            want = jnp.int16 if self.input_format == "i16" else jnp.uint8
            iq = jnp.asarray(iq)
            if iq.dtype != want or iq.ndim != 2 or iq.shape[1] != 2:
                raise TypeError(
                    f"input_format={self.input_format!r} expects (N, 2) "
                    f"{want.__name__} [re, im]; got {iq.dtype} {iq.shape}")
        else:
            iq = jnp.asarray(iq, jnp.complex64)
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        valid = jnp.asarray(self._fed >= 1)
        self.state, pcm = self._step(self.params, self.state, iq, valid)
        self._fed += 1
        if self._fed < 2:
            return None  # pipeline fill bubble
        return pcm[-1]

    def reset(self):
        """Re-initialize all stage state for a fresh stream."""
        from ..utils.hostbuild import host_build
        st0 = self._st0
        self.state = host_build(lambda: AMPipeState(
            rs_tail=jnp.stack([st0.rs_tail] * N_STAGES),
            agc=_stack(st0.agc, N_STAGES),
            am=_stack(st0.am, N_STAGES),
            deemph=jnp.stack([st0.deemph] * N_STAGES),
            buf=jnp.zeros((N_STAGES, self.n_out), jnp.complex64),
        ))
        self._fed = 0

    def flush(self):
        """Drain the in-flight block and TERMINATE the stream: the drain
        feeds zeros through the front end, so the carried filter/AGC state
        afterwards belongs to the zero feed, not the user's stream. The
        receiver therefore resets itself (as if freshly constructed);
        start the next stream with plain __call__s."""
        if self._fed == 0:
            return None
        if self.input_format == "i16":
            zeros = jnp.zeros((self.block_len, 2), jnp.int16)
        elif self.input_format == "u8":
            # 127 ~ zero signal to within half an LSB
            zeros = jnp.full((self.block_len, 2), 127, jnp.uint8)
        else:
            zeros = jnp.zeros((self.block_len,), jnp.complex64)
        _, pcm = self._step(self.params, self.state, zeros,
                            jnp.asarray(True))
        self.reset()
        return pcm[-1]
