"""Multi-host initialization and the wideband scanner (BASELINE config 5).

Transport is JAX's own distributed runtime (SURVEY.md section 2.3: no
custom NCCL/MPI analog). On one GPU host, ONE process drives every card:
``jax.devices()`` already lists them all and XLA routes the collectives
over NVLink, so no initialization is needed. ``init_distributed`` wraps
jax.distributed.initialize for several processes (several hosts, or the
two-process CPU test in tests/test_multihost.py); once initialized,
``jax.devices()`` spans every process and every mesh built by
tpudsp/parallel/mesh.py places shards across them. Nothing else in the
framework is process-count aware -- the same ShardedBank /
ShardedChannelizer code runs in one process or several.

Scanner (config 5: 1 Gsps synthetic IQ over N >= 2 hosts): the PFB
channelizer time-sharded with overlap-save boundary exchange -- each time
shard needs (T-1)*C + C-1 carried samples from its left neighbor, one
ppermute -- followed by the per-channel demod bank, which is embarrassingly
parallel over the channel axis of each local frame block.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..chains.channelizer import (
    ChannelizedBankConfig, ChannelizerState, DemodBankState, bank_build,
)
from ..design import iirdes
from ..kernels.fastmath import patan2
from ..kernels import iir as kiir
from .mesh import TIME_AXIS

TWO_PI = 2.0 * np.pi


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Initialize the multi-process runtime. Returns False (a no-op) where
    jax.distributed.initialize cannot run, e.g. with no arguments on a
    machine that announces no cluster. Where several processes share one
    host, pass ``local_device_ids`` so each process owns its own card."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
        return True
    except Exception:
        return False


def _channelize_local(Ht, tail_local, x_local, os: int = 1):
    """Per-shard PFB given the exchanged tail (same math as
    chains/channelizer.py channelize; the branch-domain framing including
    the os=2 odd-frame roll is parallel/channelizer.py _frontend_local,
    whose local frame parity matches global parity because every shard
    owns an even frame count when block_len % (C * n_shards) == 0).
    Raw wire-format (N, 2) slices (int16 or RTL-SDR uint8) route through
    chains.channelizer.channelize_i16 (taps carry the wire scale; the
    tail stays at wire width)."""
    if x_local.ndim == 2:
        from ..chains.channelizer import channelize_i16
        st, Y = channelize_i16(Ht, ChannelizerState(tail=tail_local),
                               x_local, os)
        return st.tail, Y
    from .channelizer import _frontend_local
    T, C = Ht.shape
    u = _frontend_local(Ht, tail_local, x_local, os)
    Y = (jnp.fft.ifft(u, axis=1) * C).astype(jnp.complex64)
    xfull = jnp.concatenate([tail_local, x_local])
    return xfull[-((T - 1) * C + C - 1):], Y


def scanner_step(params, state: DemodBankState, x_local, *, cfg: ChannelizedBankConfig):
    """shard_map body: time-sharded channelize + demod. The (T-1)*C + C-1
    boundary samples come from the left time neighbor (overlap-save
    exchange); the leftmost shard uses the block-carried tail."""
    from .halo import left_halo, left_halo_rows
    from ..chains.channelizer import _am_indices, _demod_tuple, _is_mixed
    Ht, b0, a, amb, fm_mask = params
    T, C = Ht.shape
    halo = (T - 1) * C + C - 1
    if x_local.ndim == 2:  # raw-int16 (N_loc, 2) wire samples
        tail_local = left_halo_rows(x_local, halo, TIME_AXIS, state.ch.tail)
    else:
        tail_local = left_halo(x_local, halo, TIME_AXIS, state.ch.tail)
    new_tail, Y = _channelize_local(Ht, tail_local, x_local,
                                    os=cfg.channelizer.oversample)
    Yc = Y.T  # (C, M_loc)

    front, dc = state.front, state.dc
    mixed = _is_mixed(cfg)
    am_idx = _am_indices(cfg)

    def fm_base(y, prev0):
        prev = left_halo(y, 1, TIME_AXIS, prev0[:, None])
        xprev = jnp.concatenate([prev, y[:, :-1]], axis=1)
        d = y * jnp.conj(xprev)
        return patan2(d.imag, d.real) / jnp.float32(
            TWO_PI * cfg.kd)

    def coherent(y, front0, dc0):
        # coherent AM across time shards: warmup halo + chunked front
        # (same scheme as parallel/bank.py)
        from ..kernels.ampmodem import PLL_BW
        from ..kernels.warmup import warmup_for
        from .bank import coherent_am_time_sharded
        return coherent_am_time_sharded(
            amb, front0, dc0, y,
            warmup=warmup_for(agc_alpha=cfg.agc_bandwidth, pll_bw=PLL_BW))

    if not mixed and _demod_tuple(cfg)[0] == "fm":
        base = fm_base(Yc, state.fd_prev)
    elif not mixed and cfg.am_coherent:
        front, dc, base = coherent(Yc, front, dc)
    elif not mixed:
        base = jnp.abs(Yc).astype(jnp.float32)
    else:
        # mixed fm/am (EP): channels are LOCAL on the time-sharded mesh,
        # so the coherent back end gathers its static AM subgroup
        base = jnp.where(fm_mask[:, None], fm_base(Yc, state.fd_prev),
                         jnp.abs(Yc).astype(jnp.float32))
        if cfg.am_coherent and am_idx:
            idx = jnp.asarray(am_idx)
            front, dc, coh = coherent(Yc[idx, :], front, dc)
            base = base.at[idx].set(coh)

    # de-emphasis across time shards: local assoc scan + tiny cross-shard
    # prefix of transition aggregates (same pattern as parallel/bank.py)
    from ..design import iirdes as _iirdes
    from .bank import _first_order_time_sharded_blocked
    _b0de, _ade = _iirdes.deemphasis_coeffs(
        cfg.channelizer.chan_rate, cfg.deemph_tau)
    deemph, audio = _first_order_time_sharded_blocked(
        _b0de, _ade, state.deemph, base)

    new_state = DemodBankState(
        ch=ChannelizerState(tail=new_tail[None, :]),
        fd_prev=Yc[:, -1:],
        deemph=deemph[:, None],
        front=jax.tree.map(lambda v: v[:, None], front),
        dc=None if dc is None else dc[:, None],
    )
    return new_state, audio


class ShardedScanner:
    """Wideband scanner: PFB channelizer + demod bank, time-sharded over
    the mesh. Single-host it uses the local mesh; multi-host, build the
    mesh over jax.devices() after init_distributed."""

    def __init__(self, cfg: ChannelizedBankConfig, mesh: Mesh, block_len: int,
                 input_format: str = "c64"):
        if cfg.channelizer.engine != "shift":
            raise NotImplementedError(
                "the sharded channelizer front end implements the 'shift' "
                f"PFB accumulation only; engine={cfg.channelizer.engine!r} "
                "would be silently mis-measured (use chains.channelizer "
                "for the conv engine, or engine='shift' here)")
        C = cfg.channelizer.nchan
        n_time = mesh.shape[TIME_AXIS]
        if block_len % (C * n_time):
            raise ValueError(f"block_len must be a multiple of {C * n_time}")
        self.cfg = cfg
        self.mesh = mesh
        self.block_len = block_len
        self.input_format = input_format
        from ..utils.hostbuild import host_build
        self.params, self.state = host_build(bank_build, cfg, input_format)

        coherent = self.state.front is not None
        front_in = front_out = dc_in = dc_out = None
        if coherent:
            front_in = jax.tree.map(lambda _: P(), self.state.front)
            front_out = jax.tree.map(lambda _: P(None, TIME_AXIS),
                                     self.state.front)
            dc_in, dc_out = P(), P(None, TIME_AXIS)
        mapped = jax.shard_map(
            partial(scanner_step, cfg=cfg), mesh=mesh,
            in_specs=(P(), DemodBankState(
                ch=ChannelizerState(tail=P()),
                fd_prev=P(), deemph=P(), front=front_in, dc=dc_in),
                P(TIME_AXIS)),
            out_specs=(DemodBankState(
                ch=ChannelizerState(tail=P(TIME_AXIS, None)),
                fd_prev=P(None, TIME_AXIS), deemph=P(None, TIME_AXIS),
                front=front_out, dc=dc_out),
                P(None, TIME_AXIS)),
        )

        def step(params, state, iq):
            st, audio = mapped(params, state, iq)
            new_state = DemodBankState(
                ch=ChannelizerState(tail=st.ch.tail[-1]),
                fd_prev=st.fd_prev[:, -1],
                deemph=st.deemph[:, -1],
                front=jax.tree.map(lambda v: v[:, -1], st.front),
                dc=None if st.dc is None else st.dc[:, -1],
            )
            return new_state, audio

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
        self.state, audio = self._step(self.params, self.state, iq)
        return audio
