"""Time-sharded single-channel AM receiver (BASELINE.json config 1 on a
mesh; round-1 VERDICT "do this" #3).

Shards the flagship AM chain (chains/am.py, the reference README chain at
/root/reference/README.md:41-58) over the ``time`` mesh axis: one long IQ
block is split across devices, each shard computes its slice of the 48 kHz
PCM, and the three stream couplings become three cheap exchanges:

1. Fused front end (bandpass TIR folded into the rational polyphase
   decimator, kernels/decimate.py): a kf-sample INPUT halo from the left
   time neighbor (one ppermute). Because the local input length is a
   multiple of Q, every shard's output grid has the same phase pattern --
   this is the SURVEY.md section 5 "resampler shards by output index
   ranges with input halos" design, with the halo equal to the fused
   filter length.
2. AGC + carrier-PLL feedback loop: the warmup-chunk scheme IS the
   time-sharding scheme (parallel/bank.coherent_am_time_sharded) -- each
   shard re-derives its loop entry state from a warmup-sized baseband halo
   (window derived from the loop bandwidths, kernels/warmup.py), then runs
   the chunked front locally.
3. DC tracker + de-emphasis: first-order LINEAR recurrences cross shards
   exactly via the transition-aggregate prefix scan (one all_gather of T
   tiny aggregates each).

A (time=1) mesh reproduces the single-chip AMReceiver exactly; on an
(1, T) CPU mesh the output matches the exact-scan AMReceiver to >= 80 dB
(tests/test_sharded_am.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..chains.am import AMConfig, build as am_build
from ..kernels import agc as kagc
from ..kernels import am_backend as kab
from ..kernels import ampmodem as kam
from ..kernels import decimate as kdec
from ..kernels.warmup import warmup_for
from .bank import (_first_order_time_sharded_blocked,
                   coherent_am_time_sharded)
from .halo import left_halo
from .mesh import TIME_AXIS


class SAMState(NamedTuple):
    rs_tail: jnp.ndarray    # (kf,) carried fused-front input tail
    front: kab.FrontState   # AGC + PLL feedback state (scalar leaves)
    dc: jnp.ndarray         # f32 DC-tracker carry
    deemph: jnp.ndarray     # f32 de-emphasis carry


def _sharded_am_step(taps, amb, state: SAMState, iq_loc, *, Q: int,
                     nj_loc: int, warmup: int, b0: float, a: float):
    """shard_map body over the time axis. iq_loc: (N_loc,) local slice —
    or (N_loc, 2) raw wire samples (int16/uint8, taps carrying the wire
    scale; the kf-sample input halo then rides the ppermute at wire
    width)."""
    kf = state.rs_tail.shape[0]
    if iq_loc.ndim == 2:  # raw wire-format slice
        from .halo import left_halo_rows
        tail_loc = left_halo_rows(iq_loc, kf, TIME_AXIS, state.rs_tail)
        if iq_loc.dtype == jnp.uint8:
            t, dc = taps  # u8 plan: (scaled taps, per-phase DC sums)
            new_tail, y48 = kdec.fused_frontend_apply_shared_u8(
                t, dc, tail_loc, iq_loc, Q, nj_loc)
        else:
            new_tail, y48 = kdec.fused_frontend_apply_shared_i16(
                taps, tail_loc, iq_loc, Q, nj_loc)
    else:
        tail_loc = left_halo(iq_loc, kf, TIME_AXIS, state.rs_tail)
        new_tail, y48 = kdec.fused_frontend_apply_shared(
            taps, tail_loc, iq_loc, Q, nj_loc)

    # feedback back end across time shards (C_loc = 1 batch)
    front0 = jax.tree.map(lambda v: v[None], state.front)
    front, dc, audio = coherent_am_time_sharded(
        amb, front0, state.dc[None], y48[None, :], warmup=warmup)
    deemph, pcm = _first_order_time_sharded_blocked(
        b0, a, state.deemph[None], audio)

    new_state = SAMState(
        rs_tail=new_tail[None, :],                        # (1, kf) -> (T, kf)
        front=jax.tree.map(lambda v: v[:, None], front),  # (1,1) -> (1,T)
        dc=dc[:, None],
        deemph=deemph[:, None],
    )
    return new_state, pcm  # pcm: (1, M_loc) -> (1, M) over TIME


class ShardedAMReceiver:
    """The BASELINE config-1 AM receiver time-sharded over a mesh.

    cfg matches chains/am.AMConfig (the reference README chain); block_len
    must be a multiple of T * Q (Q = the rational rate's denominator, 125
    for 2 Msps -> 48 kHz) so each shard owns an integral output range."""

    def __init__(self, cfg: AMConfig = AMConfig(), mesh: Mesh = None,
                 block_len: int = 1_000_000, input_format: str = "c64"):
        from ..chains.am import _rational
        if mesh is None:
            raise ValueError("ShardedAMReceiver needs a mesh with a "
                             f"'{TIME_AXIS}' axis")
        if input_format not in ("c64", "i16", "u8"):
            raise ValueError(f"unknown input_format {input_format!r} "
                             "(use 'c64', 'i16' or 'u8')")
        self.input_format = input_format
        pq = _rational(cfg.rate)
        if pq is None:
            raise ValueError("time sharding needs a rational rate "
                             "(fused front end)")
        P_, Q = pq
        T = mesh.shape[TIME_AXIS]
        if block_len % (T * Q):
            raise ValueError(f"block_len must be a multiple of T*Q = {T * Q}")
        self.cfg = cfg
        self.mesh = mesh
        self.block_len = block_len
        n_loc = block_len // T
        nj_loc = n_loc // Q
        warmup = warmup_for(agc_alpha=cfg.agc_bandwidth,
                            pll_bw=kam.PLL_BW if cfg.carrier else None)
        if nj_loc * P_ < warmup:
            # the warmup halo is fetched from the immediate left neighbor
            # only; a shard shorter than the loop memory cannot re-derive
            # its entry state to the documented accuracy
            raise ValueError(
                f"local audio slice ({nj_loc * P_} samples) is shorter than "
                f"the loop warmup window ({warmup}); use block_len >= "
                f"{int(np.ceil(warmup / cfg.rate)) * T} or fewer time shards")

        def _design():
            # reuse the single-chip build for taps and the fused plan
            params, st0, _ = am_build(cfg, block_len, input_format)
            amb = kab.make_params(params.agc, cfg.modulation,
                                  params.deemph_b0, params.deemph_a,
                                  carrier=cfg.carrier)
            if input_format == "u8":
                taps = (params.taps_fused, params.u8_dc)
            else:
                taps = params.taps_fused
            state = SAMState(
                rs_tail=st0.rs_tail,  # (kf,) c64 or (kf, 2) wire samples
                front=kab.FrontState(agc=kagc.agc_init(),
                                     pll=kab.PllState(jnp.float32(0.0),
                                                      jnp.float32(0.0))),
                dc=jnp.float32(0.0),
                deemph=jnp.float32(0.0),
            )
            return params, taps, amb, state

        from ..utils.hostbuild import host_build
        params, self._taps, amb, self.state = host_build(_design)
        self.n_out = int(round(block_len * cfg.rate))
        self._amb = amb
        body = partial(_sharded_am_step, Q=Q, nj_loc=nj_loc, warmup=warmup,
                       b0=float(params.deemph_b0), a=float(params.deemph_a))
        state_in = SAMState(
            rs_tail=P(), front=jax.tree.map(lambda _: P(), self.state.front),
            dc=P(), deemph=P())
        state_out = SAMState(
            rs_tail=(P(TIME_AXIS, None, None) if self.state.rs_tail.ndim == 2
                     else P(TIME_AXIS, None)),
            front=jax.tree.map(lambda _: P(None, TIME_AXIS), self.state.front),
            dc=P(None, TIME_AXIS), deemph=P(None, TIME_AXIS))
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P(), self._taps),
                      jax.tree.map(lambda _: P(), amb),
                      state_in, P(TIME_AXIS)),
            out_specs=(state_out, P(None, TIME_AXIS)),
        )

        def step(taps, amb, state, iq):
            st, pcm = mapped(taps, amb, state, iq)
            # stream-boundary carries for the next block = LAST time shard
            new_state = SAMState(
                rs_tail=st.rs_tail[-1],
                front=jax.tree.map(lambda v: v[0, -1], st.front),
                dc=st.dc[0, -1],
                deemph=st.deemph[0, -1],
            )
            return new_state, pcm[0]

        self._step = jax.jit(step)

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
        iq = jax.device_put(iq, NamedSharding(self.mesh, P(TIME_AXIS)))
        self.state, pcm = self._step(self._taps, self._amb, self.state, iq)
        return pcm
