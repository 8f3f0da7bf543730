"""TP-sharded polyphase FFT channelizer: the C-point channel transform is
split ACROSS devices as a transpose-based two-stage distributed FFT
(SURVEY.md section 2.3 row "TP": intra-op parallelism of the channelizer
filterbank/FFT; the reference has no parallelism of any kind).

Factor C = C1 * C2 and write branch p = p1*C2 + p2, channel c = c2*C1 + c1:

    S[c2*C1 + c1] = sum_p2 e^{2 pi j p2 c2 / C2}
                      [ e^{2 pi j p2 c1 / C}            (twiddle)
                        * sum_p1 e^{2 pi j p1 c1 / C1} u[p1*C2 + p2] ]

so the C-point transform becomes: C1-point IFFTs batched over p2, a
twiddle, a transpose, then C2-point IFFTs batched over c1 -- the classic
four-step/transpose FFT, with the transposes as `all_to_all` collectives
(NCCL over NVLink on one GPU host). Combined with the time-sharded input this gives ONE mesh axis
playing both roles:

  1. input x time-sharded: each device frames its slice and runs the
     polyphase weighted-sum front end locally (frame halo = one ppermute,
     same scheme as parallel/bank.py);
  2. all_to_all #1 (frames -> p2 shards): split the p2 axis, gather frames;
  3. local stage-1 IFFT over p1 (+ twiddle with the *global* p2 index);
  4. all_to_all #2 (p2 shards -> c1 shards): split c1, gather p2;
  5. local stage-2 IFFT over p2: output Y[m, c1_loc, c2] -- the channel
     axis ends up sharded over c1, exactly what a per-channel demod bank
     wants (zero further communication).

Channel c lives at layout position [c1, c2] with c1 = c % C1, c2 = c // C1
(`channel_layout` maps between orders). A (1-device) mesh reproduces
chains/channelizer.py exactly (tested, tests/test_tp_channelizer.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..kernels.fastmath import patan2
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..chains.channelizer import (
    ChannelizerConfig, ChannelizedBankConfig, build as ch_build)
from ..design import iirdes
from .halo import left_halo

TWO_PI = 2.0 * np.pi


def channel_layout(C1: int, C2: int):
    """Map (c1, c2) layout order -> natural channel order.

    Returns ``perm`` with ``perm[i] = c2*C1 + c1`` for layout position
    ``i = c1*C2 + c2``: scatter ``Y_nat[:, perm] = Y_layout.reshape(M, C)``
    recovers natural channel order.
    """
    c1 = np.repeat(np.arange(C1), C2)
    c2 = np.tile(np.arange(C2), C1)
    return c2 * C1 + c1


def _factor(C: int, n_shards: int, c1: int | None):
    if c1 is None:
        # smallest C1 that keeps both stage batches shardable
        c1 = n_shards
        while C % c1 or (C // c1) % n_shards:
            c1 += n_shards
            if c1 > C:
                raise ValueError(f"cannot factor C={C} over {n_shards} shards")
    C1, C2 = c1, C // c1
    if C1 * C2 != C or C1 % n_shards or C2 % n_shards:
        raise ValueError(
            f"need C1*C2={C} with C1, C2 both multiples of {n_shards}; "
            f"got C1={C1}, C2={C2}")
    return C1, C2


def _frontend_local(Ht, halo_tail, x_loc, os: int = 1):
    """Polyphase weighted-sum front end on this shard's time slice.
    halo_tail: ((T-1)*C + C-1,) samples preceding x_loc in the stream.
    Returns u_loc (M_loc, C): branch p of frames owned by this shard
    (M_loc = os * len(x_loc) / C; see chains/channelizer.py::channelize
    for the hop-R derivation).

    At os=2 the odd-frame phase factor e^{-j pi c} is applied HERE, in the
    branch domain, as a circular C/2 roll of u (a modulation theorem pair:
    rolling u by C/2 multiplies the post-IFFT channel c by (-1)^c) -- so
    the distributed two-stage FFT downstream needs no channel-indexed
    correction. Local frame parity equals global parity because every
    shard owns an even frame count (block_len % (C * n_shards) == 0).

    Raw wire-format slices ((N_loc, 2) int16 or RTL-SDR uint8, with Ht
    carrying the wire scale — chains/channelizer.py build) frame at wire
    width and convert components at the FMA operand; the uint8 -127.5
    offset is a per-branch constant subtracted after accumulation (and
    before the os=2 roll, which therefore needs no correction)."""
    T, C = Ht.shape
    R = C // os
    wire = x_loc.ndim == 2
    n_loc = x_loc.shape[0]
    M_loc = (n_loc // C) * os
    xfull = jnp.concatenate([halo_tail, x_loc])
    M_all = M_loc + os * (T - 1)
    if wire:
        if os == 1:
            V = xfull[: M_all * C].reshape(M_all, C, 2)[:, ::-1]
        else:
            B = xfull[: (M_all + 1) * R].reshape(M_all + 1, R, 2)
            V = jnp.concatenate([B[:-1], B[1:]], axis=1)[:, ::-1]
        ur = jnp.zeros((M_loc, C), jnp.float32)
        ui = jnp.zeros((M_loc, C), jnp.float32)
        for t in range(T):
            sl = lax.dynamic_slice_in_dim(V, os * (T - 1 - t), M_loc, axis=0)
            ur = ur + Ht[t][None, :] * sl[..., 0].astype(jnp.float32)
            ui = ui + Ht[t][None, :] * sl[..., 1].astype(jnp.float32)
        if x_loc.dtype == jnp.uint8:
            dc = jnp.float32(127.5) * jnp.sum(Ht, axis=0)
            ur = ur - dc[None, :]
            ui = ui - dc[None, :]
        u = ur + 1j * ui
    else:
        if os == 1:
            V = xfull[: M_all * C].reshape(M_all, C)[:, ::-1]
        else:
            B = xfull[: (M_all + 1) * R].reshape(M_all + 1, R)
            V = jnp.concatenate([B[:-1], B[1:]], axis=1)[:, ::-1]
        u = jnp.zeros((M_loc, C), jnp.complex64)
        for t in range(T):
            u = u + Ht[t][None, :] * lax.dynamic_slice_in_dim(
                V, os * (T - 1 - t), M_loc, axis=0)
    if os == 2:
        odd = (jnp.arange(M_loc) % 2)[:, None].astype(jnp.complex64)
        u = (1.0 - odd) * u + odd * jnp.roll(u, -(C // 2), axis=1)
    return u.astype(jnp.complex64)


def tp_channelize_shard(Ht, tw, tail, x_loc, *, C1: int, C2: int,
                        axis_name: str, os: int = 1):
    """Per-shard body (under shard_map over ``axis_name``).

    Ht: (T, C) prototype branches (replicated); tw: (C1, C2//n) local
    twiddle slice e^{2 pi j c1 p2 / C} at this shard's global p2 block;
    tail: (htail,) carried stream tail (replicated; consumed by shard 0);
    x_loc: (N/n,) local time slice. Returns (tail_out (1, htail),
    Y_loc (M, C1//n, C2)) -- channel axis sharded over c1.
    """
    T, C = Ht.shape
    htail = (T - 1) * C + C - 1
    n_shards = lax.axis_size(axis_name)
    if x_loc.ndim == 2:  # raw wire-format (N_loc, 2) slices
        from .halo import left_halo_rows
        halo = left_halo_rows(x_loc, htail, axis_name, tail)
    else:
        halo = left_halo(x_loc, htail, axis_name, tail)
    u = _frontend_local(Ht, halo, x_loc, os)              # (M_loc, C)
    M_loc = u.shape[0]
    u = u.reshape(M_loc, C1, C2)
    # transpose 1: frame shards -> p2 shards
    u = lax.all_to_all(u, axis_name, split_axis=2, concat_axis=0, tiled=True)
    # stage 1: C1-point transform over p1, batched over (m, p2_loc)
    A = (jnp.fft.ifft(u, axis=1) * C1).astype(jnp.complex64)
    A = A * tw[None, :, :]
    # transpose 2: p2 shards -> c1 shards
    A = lax.all_to_all(A, axis_name, split_axis=1, concat_axis=2, tiled=True)
    # stage 2: C2-point transform over p2, batched over (m, c1_loc)
    Y = (jnp.fft.ifft(A, axis=2) * C2).astype(jnp.complex64)
    # next block's tail: last htail samples of the LAST shard's slice
    tail_out = jnp.concatenate([halo, x_loc])[-htail:]
    return tail_out[None, :], Y


class ShardedChannelizer:
    """Analysis channelizer with the channel transform sharded over a
    1-D mesh axis (TP analog). Input blocks are time-sharded; output
    channel matrices are channel-sharded in (c1, c2) layout order.

    ``__call__`` returns the (M, C) channel matrix in NATURAL channel
    order (host-side gather; use ``step_fn``/``layout_perm`` to stay in
    the sharded layout for zero-copy chaining into a demod bank).
    """

    def __init__(self, cfg: ChannelizerConfig, mesh: Mesh,
                 block_len: int, axis_name: str | None = None,
                 c1: int | None = None, input_format: str = "c64"):
        if cfg.engine != "shift":
            raise NotImplementedError(
                "the sharded channelizer front end implements the 'shift' "
                f"PFB accumulation only; engine={cfg.engine!r} would be "
                "silently mis-measured (use chains.channelizer for the "
                "conv engine, or engine='shift' here)")
        if axis_name is None:
            axis_name = mesh.axis_names[0]
        n = mesh.shape[axis_name]
        C = cfg.nchan
        if block_len % (C * n):
            raise ValueError(f"block_len must be a multiple of {C * n}")
        if block_len // n < cfg.taps_per_branch * C:
            raise ValueError(
                "per-shard slice must cover the frame halo: need "
                f"block_len >= {cfg.taps_per_branch * C * n}")
        self.cfg = cfg
        self.mesh = mesh
        self.axis_name = axis_name
        self.block_len = block_len
        self.input_format = input_format
        self.C1, self.C2 = _factor(C, n, c1)
        self.layout_perm = channel_layout(self.C1, self.C2)
        from ..utils.hostbuild import host_build

        def _design():
            Ht, st = ch_build(cfg, input_format)
            c1g = np.arange(self.C1)[:, None]
            p2g = np.arange(self.C2)[None, :]
            tw = jnp.asarray(
                np.exp(2j * np.pi * c1g * p2g / C).astype(np.complex64))
            return Ht, st.tail, tw

        self.Ht, self.tail, self.tw = host_build(_design)

        body = partial(tp_channelize_shard, C1=self.C1, C2=self.C2,
                       axis_name=axis_name, os=cfg.oversample)
        A = axis_name
        # wire-format tails are (htail, 2) -> gathered (n, htail, 2)
        tail_out_spec = (P(A, None, None) if self.tail.ndim == 2
                         else P(A, None))
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(None, A), P(), P(A)),
            out_specs=(tail_out_spec, P(None, A, None)),
        )

        def step(Ht, tw, tail, x):
            tails, Y = mapped(Ht, tw, tail, x)
            return tails[-1], Y

        self._step = jax.jit(step)

    def step_fn(self):
        """(Ht, tw, tail, x) -> (tail, Y (M, C1, C2) channel-sharded)."""
        return self._step

    def _coerce(self, iq):
        if self.input_format in ("i16", "u8"):
            want = jnp.int16 if self.input_format == "i16" else jnp.uint8
            iq = jnp.asarray(iq)
            if iq.dtype != want or iq.ndim != 2 or iq.shape[1] != 2:
                raise TypeError(
                    f"input_format={self.input_format!r} expects (N, 2) "
                    f"{want.__name__} [re, im]; got {iq.dtype} {iq.shape}")
            return iq
        return jnp.asarray(iq, jnp.complex64)

    def __call__(self, iq):
        iq = jax.device_put(self._coerce(iq),
                            NamedSharding(self.mesh, P(self.axis_name)))
        self.tail, Y = self._step(self.Ht, self.tw, self.tail, iq)
        M = Y.shape[0]
        Yl = np.asarray(Y).reshape(M, self.cfg.nchan)
        out = np.empty_like(Yl)
        out[:, self.layout_perm] = Yl
        return out


class TPBankState(NamedTuple):
    tail: jnp.ndarray      # (htail,) carried stream tail (replicated)
    fd_prev: jnp.ndarray   # (C1, C2) complex64, layout order, sharded c1
    deemph: jnp.ndarray    # (C1, C2) float32, layout order, sharded c1
    front: object = None   # kab.FrontState, leaves (C1, C2) (coherent AM)
    dc: object = None      # (C1, C2) f32 DC-tracker carry (coherent AM)


def tp_bank_shard(params, state: TPBankState, x_loc, *,
                  cfg: ChannelizedBankConfig, C1: int, C2: int,
                  axis_name: str):
    """Channelize (distributed FFT) + per-channel demod, one shard body.
    After the second all_to_all the channel axis is sharded and each shard
    holds the FULL time extent for its channels, so the whole demod back
    end — including coherent AM's AGC + carrier-PLL feedback scans
    (reference topology demod.hpp:87-152) — runs with zero further
    communication. Returns (state-with-axes, audio (C1_loc, C2, M))."""
    Ht, tw, b0, a, amb, fm_mask = params
    tail_out, Y = tp_channelize_shard(Ht, tw, state.tail, x_loc,
                                      C1=C1, C2=C2, axis_name=axis_name,
                                      os=cfg.channelizer.oversample)
    Yc = jnp.transpose(Y, (1, 2, 0))                    # (C1_loc, C2, M)
    from ..chains.channelizer import _am_indices, _demod_tuple, _is_mixed
    from ..kernels import iir as kiir
    c1_loc, c2 = Yc.shape[0], Yc.shape[1]
    c_loc = c1_loc * c2
    front, dc = state.front, state.dc
    mixed = _is_mixed(cfg)

    def fm_base(y):
        xprev = jnp.concatenate([state.fd_prev[:, :, None], y[:, :, :-1]],
                                axis=2)
        d = y * jnp.conj(xprev)
        return patan2(d.imag, d.real) / jnp.float32(
            TWO_PI * cfg.kd)

    def coherent(y):
        # per-channel feedback loops over the full local time axis — same
        # warmup-chunked kernel as the single-chip bank (chains/
        # channelizer.py bank_step), vmapped over this shard's channels
        from ..kernels import am_backend as kab
        from ..kernels import warmup as kwarm
        w = kwarm.warmup_for(agc_alpha=cfg.agc_bandwidth, pll_bw=kab.PLL_BW)
        fl = jax.tree.map(lambda v: v.reshape(c_loc), state.front)
        front_f, (vr, _modes) = jax.vmap(
            lambda s, xs: kab.front_chunked(
                amb, s, xs, chunk=kwarm.chunk_for(w), warmup=w)
        )(fl, y.reshape(c_loc, -1))
        fr = jax.tree.map(lambda v: v.reshape(c1_loc, c2), front_f)
        # matmul-blocked scan for the rho=0.9995 DC pole (110.6 dB vs
        # f64 serial; matches the single-chip channelizer's formulation)
        from ..kernels.ampmodem import DC_RHO
        dc_f, dct = jax.vmap(
            lambda d0, v: kiir.first_order_apply_blocked(
                1.0 - DC_RHO, DC_RHO, d0, v)
        )(state.dc.reshape(c_loc), vr)
        return (fr, dc_f.reshape(c1_loc, c2),
                ((vr - dct) * amb.inv_mod).reshape(c1_loc, c2, -1))

    if not mixed and _demod_tuple(cfg)[0] == "fm":
        base = fm_base(Yc)
    elif not mixed and cfg.am_coherent:
        front, dc, base = coherent(Yc)
    elif not mixed:
        base = jnp.abs(Yc).astype(jnp.float32)
    else:
        # mixed fm/am (EP) with the channel axis SHARDED: the per-shard
        # AM subgroup is not static, so coherent (when on) runs on every
        # local row and the (layout-ordered, c1-sharded) mask selects;
        # non-AM rows are dead compute traded for a uniform program
        base = jnp.where(fm_mask[:, :, None], fm_base(Yc),
                         jnp.abs(Yc).astype(jnp.float32))
        if cfg.am_coherent and _am_indices(cfg):
            front, dc, coh = coherent(Yc)
            am_mask = (~fm_mask)[:, :, None]
            base = jnp.where(am_mask, coh, base)
    fd_prev = Yc[:, :, -1]
    b0_de, a_de = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate,
                                           cfg.deemph_tau)
    deemph, audio = jax.vmap(
        lambda y0, xs: kiir.first_order_apply_blocked(b0_de, a_de, y0, xs)
    )(state.deemph.reshape(c_loc), base.reshape(c_loc, -1))
    new_state = TPBankState(
        tail=tail_out,                                   # (1, htail)
        fd_prev=fd_prev,
        deemph=deemph.reshape(base.shape[0], base.shape[1]),
        front=front, dc=dc,
    )
    return new_state, audio.reshape(base.shape)


class ShardedChannelizedBank:
    """1024-channel channelize+demod with the channel transform sharded
    across devices (TP) and the demod bank channel-parallel behind it.
    A 1-device mesh reproduces chains/channelizer.py's ChannelizedBank
    exactly (tested)."""

    def __init__(self, cfg: ChannelizedBankConfig, mesh: Mesh,
                 block_len: int, axis_name: str | None = None,
                 c1: int | None = None, input_format: str = "c64"):
        ccfg = cfg.channelizer
        sc = ShardedChannelizer(ccfg, mesh, block_len, axis_name, c1,
                                input_format)
        self.cfg = cfg
        self.mesh = mesh
        self.axis_name = sc.axis_name
        self.block_len = block_len
        self.input_format = input_format
        self._coerce = sc._coerce
        self.C1, self.C2 = sc.C1, sc.C2
        self.layout_perm = sc.layout_perm
        b0, a = iirdes.deemphasis_coeffs(ccfg.chan_rate, cfg.deemph_tau)
        from ..chains.channelizer import _am_indices, _is_mixed
        coherent = cfg.am_coherent and bool(_am_indices(cfg))
        # mixed fm/am: layout-ordered (C1, C2) mask, c1-sharded like the
        # channel data (natural->layout via layout_perm)
        fm_mask = None
        if _is_mixed(cfg):
            from ..chains.channelizer import _demod_tuple
            nat = np.asarray([d == "fm" for d in _demod_tuple(cfg)])
            fm_mask = jnp.asarray(
                nat[self.layout_perm].reshape(self.C1, self.C2))
        amb = front0 = dc0 = None
        front_spec = dc_spec = front_out = dc_out = None
        A = self.axis_name
        if coherent:
            from ..kernels import agc as kagc
            from ..kernels import am_backend as kab
            from ..kernels.pll import PllState
            from ..utils.hostbuild import host_build as _hb

            def _coh():
                amb = kab.make_params(
                    kagc.make_params(alpha=cfg.agc_bandwidth,
                                     scale=cfg.agc_scale),
                    cfg.modulation, b0, a, carrier=True)
                shp = (self.C1, self.C2)
                front0 = kab.FrontState(
                    agc=jax.tree.map(lambda v: jnp.broadcast_to(v, shp),
                                     kagc.agc_init()),
                    pll=PllState(jnp.zeros(shp, jnp.float32),
                                 jnp.zeros(shp, jnp.float32)))
                return amb, front0, jnp.zeros(shp, jnp.float32)

            amb, front0, dc0 = _hb(_coh)
            front_spec = jax.tree.map(lambda _: P(A, None), front0)
            dc_spec = P(A, None)
            front_out = front_spec
            dc_out = dc_spec
        from ..utils.hostbuild import host_build

        def _state():
            return ((sc.Ht, sc.tw, jnp.float32(b0), jnp.float32(a), amb,
                     fm_mask),
                    TPBankState(
                        tail=sc.tail,
                        fd_prev=jnp.full((self.C1, self.C2), 1.0 + 0.0j,
                                         jnp.complex64),
                        deemph=jnp.zeros((self.C1, self.C2), jnp.float32),
                        front=front0, dc=dc0))

        self.params, self.state = host_build(_state)

        body = partial(tp_bank_shard, cfg=cfg, C1=self.C1, C2=self.C2,
                       axis_name=A)
        amb_spec = None if amb is None else jax.tree.map(lambda _: P(), amb)
        tail_out_spec = (P(A, None, None) if self.state.tail.ndim == 2
                         else P(A, None))
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=((P(), P(None, A), P(), P(), amb_spec,
                       None if fm_mask is None else P(A, None)),
                      TPBankState(tail=P(), fd_prev=P(A, None),
                                  deemph=P(A, None),
                                  front=front_spec, dc=dc_spec),
                      P(A)),
            out_specs=(TPBankState(tail=tail_out_spec, fd_prev=P(A, None),
                                   deemph=P(A, None),
                                   front=front_out, dc=dc_out),
                       P(A, None, None)),
        )

        def step(params, state, x):
            st, audio = mapped(params, state, x)
            return st._replace(tail=st.tail[-1]), audio

        self._step = jax.jit(step)

    def step_fn(self):
        """(params, state, x) -> (state, audio (C1, C2, M) c1-sharded)."""
        return self._step

    def __call__(self, iq):
        iq = jax.device_put(self._coerce(iq),
                            NamedSharding(self.mesh, P(self.axis_name)))
        self.state, audio = self._step(self.params, self.state, iq)
        al = np.asarray(audio).reshape(self.C1 * self.C2, -1)
        out = np.empty_like(al)
        out[self.layout_perm] = al
        return out
