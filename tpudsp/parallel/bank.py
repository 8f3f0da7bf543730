"""Mesh-sharded receiver bank (BASELINE.json configs 4-5 foundation).

Shards chains/bank.py's step over a (channel, time) mesh with shard_map:

- ``channel`` axis: per-channel taps/phases sharded; zero communication
  (DP analog).
- ``time`` axis (SP analog): the shared IQ stream is split in time.
  Three boundary couplings, three collectives:
    1. channel-filter conv: (K1-1)-sample input halo from the left
       neighbor (ppermute); leftmost shard uses the carried tail.
    2. FM discriminator: 1-sample baseband halo (same ppermute pattern).
    3. audio conv: (K2-1)-sample baseband halo.
  De-emphasis and the coherent-AM DC tracker are first-order linear
  recurrences across the whole stream: each time shard runs the
  matmul-blocked local scan (kernels/iir.first_order_apply_blocked) and
  exposes its (a^n_loc, u_total) transition aggregate; an all_gather of
  the T tiny aggregates plus an exclusive double-float prefix gives
  each shard its entry value, applied via the exact first-order algebra
  y = y_zero + a^{k+1} entry -- the cross-device scan carry of
  SURVEY.md section 5 ("prefix-scan state propagation"), with T-element
  gathers instead of per-sample chains
  (_first_order_time_sharded_blocked).

The per-shard math is identical to the single-chip bank_step; a mesh of
(1, 1) reproduces it exactly (tested).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels.fastmath import patan2
from ..chains.bank import BankConfig, BankParams, BankState, build  # noqa: F401
from .halo import left_halo
from .mesh import CHANNEL_AXIS, TIME_AXIS, to_varying

TWO_PI = 2.0 * np.pi


def _left_halo_1d(x_local, halo, fill):
    return left_halo(x_local, halo, TIME_AXIS, fill)


def _first_order_time_sharded_blocked(b0: float, a: float, y0, x_local):
    """Cross-shard first-order scan for near-unit poles -- the
    coherent-AM DC tracker (rho = 0.9995), whose plain-f32 cross-shard
    scan floors at ~86 dB (FIDELITY.md). Same formulation as the
    single-chip chains since round 5 (kernels/iir.
    first_order_apply_blocked: matmul-blocked local prefix with a
    double-float cross-block carry; 122.9 dB isolated vs f64 serial at
    L=32; the single-chip and sharded chains use one formulation):

      1. zero-entry local scan per shard (vmapped blocked scan);
      2. shard transition aggregates (a^{n_loc} from float64 host math,
         u_total = the zero-entry scan's last sample) combined across
         the time axis in (hi, lo) double-float via all_gather + an
         exclusive sequential prefix (T elements);
      3. y = y_zero + a^{k+1} * entry  (exact first-order algebra).

    b0, a: static Python floats; y0: (C,) f32; x_local: (C, n_loc)."""
    from ..kernels.iir import _df_add, _df_mul, first_order_apply_blocked
    n_loc = x_local.shape[-1]
    _, y_zero = jax.vmap(
        lambda v: first_order_apply_blocked(b0, a, jnp.float32(0.0), v)
    )(x_local)
    u_tot = y_zero[..., -1]                           # (C,) f32
    aS64 = np.float64(a) ** n_loc
    aS_hi = jnp.float32(aS64)
    aS_lo = jnp.float32(aS64 - np.float64(np.float32(aS64)))
    u_all = lax.all_gather(u_tot, TIME_AXIS)          # (T, C)
    idx = lax.axis_index(TIME_AXIS)
    T = lax.axis_size(TIME_AXIS)

    def body(carry, t):
        pah, pal, puh, pul = carry
        take = t < idx
        na = _df_mul((pah, pal), (aS_hi, aS_lo))
        nu = _df_add(_df_mul((aS_hi, aS_lo), (puh, pul)),
                     (u_all[t], jnp.zeros_like(u_all[t])))
        sel = lambda new, old: jnp.where(take, new, old)
        return (sel(na[0], pah), sel(na[1], pal),
                sel(nu[0], puh), sel(nu[1], pul)), None

    init = to_varying((jnp.ones_like(u_tot), jnp.zeros_like(u_tot),
                       jnp.zeros_like(u_tot), jnp.zeros_like(u_tot)),
                      TIME_AXIS)
    (pah, pal, puh, pul), _ = lax.scan(body, init, jnp.arange(T))
    eh, el = _df_add(_df_mul((pah, pal), (y0, jnp.zeros_like(y0))),
                     (puh, pul))
    entry = eh + el                                   # (C,) f32
    k = jnp.arange(n_loc, dtype=jnp.float32)
    powv = jnp.float32(a) ** (k + 1.0)
    y_local = y_zero + powv[None, :] * entry[:, None]
    return y_local[..., -1], y_local


def coherent_am_time_sharded(amb, front0, dc0, y1, warmup: int):
    """Coherent AM back end (AGC + carrier PLL + DC tracker) across time
    shards: the warmup-chunk scheme IS the time-sharding scheme -- each
    shard's feedback-loop entry state is re-derived from a `warmup`-sample
    baseband halo fetched from the left time neighbor (one ppermute),
    exactly as a chunk's entry state is re-derived inside
    kernels/am_backend.front_chunked (which then runs locally, chunked
    again for on-chip parallelism). The globally-first shard starts from
    the block-carried state directly. The DC tracker is a first-order
    linear recurrence and crosses shards exactly via the transition-
    aggregate prefix scan.

    amb: kab.AmBackendParams; front0: FrontState (C_loc,); dc0: (C_loc,);
    y1: (C_loc, M_loc) local baseband; warmup: halo/warmup window in
    samples -- derive with kernels/warmup.warmup_for from the loop
    bandwidths inside amb (the caller knows them statically).
    Returns (front, dc, base)."""
    from ..kernels import am_backend as kab
    nj1 = y1.shape[1]
    w = min(warmup, nj1)
    halo = _left_halo_1d(y1, w, jnp.zeros((y1.shape[0], w), y1.dtype))
    not_first = lax.axis_index(TIME_AXIS) > 0
    # the block-carried entry state is replicated over 'time'; the warmup
    # scan output varies per shard -- mark the carry varying explicitly so
    # shard_map's replication checking (check_vma) can verify the rest
    front0 = to_varying(front0, TIME_AXIS)

    def warm(st0, xs):
        def step(st, xn):
            st2, _ = kab.front_sample_step(
                amb, st, xn.real.astype(jnp.float32),
                xn.imag.astype(jnp.float32))
            return jax.tree.map(
                lambda a2, b2: jnp.where(not_first, a2, b2), st2, st), None
        st_out, _ = lax.scan(step, st0, xs)
        return st_out

    entry = jax.vmap(warm)(front0, halo)
    from ..kernels.warmup import chunk_for
    front, (vr, _modes) = jax.vmap(
        lambda s, xs: kab.front_chunked(
            amb, s, xs, chunk=chunk_for(warmup), warmup=warmup))(entry, y1)
    from ..kernels.ampmodem import DC_RHO
    dc, dct = _first_order_time_sharded_blocked(
        1.0 - DC_RHO, DC_RHO, dc0, vr)
    return front, dc, (vr - dct) * amb.inv_mod


def sharded_bank_step(params: BankParams, state: BankState, iq, *, cfg: BankConfig,
                      coherent_mode: str = None, am_idx: tuple = ()):
    """Per-shard body (call under shard_map). iq: local (N_loc,) slice.
    params.taps_*/dtheta/h2 carry a local channel shard; state fields are
    sharded to match. Returns (new_state, audio_local). The channel-filter
    input halo comes from the left time neighbour by lax.ppermute before
    the front-end matmul.

    coherent_mode routes cfg.am_coherent in MIXED demod banks (the EP
    composition the reference gets for free from per-radio demod objects,
    wrapper.cpp:189-199):
    - 'gather': channels live locally on every shard (no channel-axis
      sharding) -- statically gather the `am_idx` subgroup, run the
      coherent back end on it alone, scatter back (the single-chip
      chains/bank.py scheme, time-sharded).
    - 'all': channels are sharded, so the local subgroup is not static --
      run the coherent back end on EVERY local channel and mask-select;
      the non-AM rows are dead compute traded for a uniform shard_map
      program (state.front/dc are (C,)-sized in this mode)."""
    C_loc = params.dtheta.shape[0]
    D1, D2 = cfg.decim1, cfg.decim2
    K1, K2 = cfg.taps1, cfg.taps2
    n_loc = iq.shape[0]
    t_idx = lax.axis_index(TIME_AXIS)

    from ..kernels import decimate as kdec
    nj1 = n_loc // D1
    if iq.ndim == 2:  # raw wire-format (N_loc, 2) slice
        from .halo import left_halo_rows
        halo_in = left_halo_rows(iq, K1 - 1, TIME_AXIS, state.in_tail)
        X = jnp.concatenate([halo_in, iq])
        y1m = kdec.strided_cfir(X, params.taps_re, params.taps_im, D1, nj1)
    else:
        halo_in = _left_halo_1d(iq, K1 - 1, state.in_tail)
        X = jnp.concatenate([halo_in, iq])
        y1m = kdec.strided_cfir(X, params.taps_re, params.taps_im, D1, nj1)

    # rotation with the GLOBAL output index: m_glob = t_idx*n_loc/D1 + m
    m0 = (t_idx.astype(jnp.uint32) * jnp.uint32(nj1))
    m = m0 + jnp.arange(nj1, dtype=jnp.uint32)
    th_u = (state.phase[:, None]
            + (state.n0 * params.dtheta)[:, None]
            + m[None, :] * (params.dtheta * jnp.uint32(D1))[:, None])
    theta = th_u.astype(jnp.float32) * jnp.float32(TWO_PI / 4294967296.0)
    y1 = y1m * jnp.exp(-1j * theta)

    def fm_base():
        prev = _left_halo_1d(y1, 1, state.fd_prev[:, None])
        xprev = jnp.concatenate([prev, y1[:, :-1]], axis=1)
        d = y1 * jnp.conj(xprev)
        return patan2(d.imag, d.real) / jnp.float32(
            TWO_PI * cfg.kd)

    from ..chains.bank import _audio_decimate, _demod_tuple
    demods = _demod_tuple(cfg)
    ssb_any = any(d in ("usb", "lsb") for d in demods)
    all_ssb = all(d in ("usb", "lsb") for d in demods)
    front, dc = state.front, state.dc
    if cfg.demod == "fm":
        base = fm_base()
    elif cfg.demod == "am":
        if cfg.am_coherent:
            from ..kernels.ampmodem import PLL_BW
            from ..kernels.warmup import warmup_for
            front, dc, base = coherent_am_time_sharded(
                params.amb, state.front, state.dc, y1,
                warmup=warmup_for(
                    agc_alpha=cfg.agc_bandwidth, pll_bw=PLL_BW,
                    squelch_timeout=(cfg.squelch_timeout if cfg.squelch
                                     else 0)))
        else:
            base = jnp.abs(y1).astype(jnp.float32)
    elif isinstance(cfg.demod, str) and ssb_any:
        # real SSB demod is below (one-sided h2s decimator); this base
        # only maintains the real-path a_tail carry
        base = y1.real.astype(jnp.float32)
    else:  # mixed: branch-free per-channel dispatch (EP analog)
        base = jnp.where(params.fm_mask[:, None], fm_base(),
                         jnp.where(params.ssb_mask[:, None],
                                   y1.real.astype(jnp.float32),
                                   jnp.abs(y1).astype(jnp.float32)))
        if cfg.am_coherent and coherent_mode is not None:
            from ..kernels.ampmodem import PLL_BW
            from ..kernels.warmup import warmup_for
            w = warmup_for(
                agc_alpha=cfg.agc_bandwidth, pll_bw=PLL_BW,
                squelch_timeout=(cfg.squelch_timeout if cfg.squelch
                                 else 0))
            if coherent_mode == "gather":
                idx = jnp.asarray(am_idx)
                front, dc, coh = coherent_am_time_sharded(
                    params.amb, state.front, state.dc, y1[idx, :],
                    warmup=w)
                base = base.at[idx].set(coh)
            else:  # 'all': per-shard subgroup is dynamic; scan every row
                front, dc, coh = coherent_am_time_sharded(
                    params.amb, state.front, state.dc, y1, warmup=w)
                am_mask = ~(params.fm_mask | params.ssb_mask)
                base = jnp.where(am_mask[:, None], coh, base)
    fd_prev = y1[:, -1]

    nj2 = nj1 // D2
    halo_a = _left_halo_1d(base, K2 - 1, state.a_tail)
    A = jnp.concatenate([halo_a, base], axis=1)
    audio = _audio_decimate(A, params.h2, D2, nj2)

    # SSB channels: one-sided (analytic) decimation of the complex
    # baseband -- same branch-free scheme as chains/bank.py bank_step,
    # with the (K2-1)-sample complex baseband tail as a time halo
    y1_tail = state.y1_tail
    if ssb_any:
        K2s = cfg.taps2_ssb
        halo_y1 = _left_halo_1d(y1, K2s - 1, state.y1_tail)
        Yf = jnp.concatenate([halo_y1, y1], axis=1)
        yi = Yf.imag * params.lsb_sign[:, None]
        audio_ssb = (_audio_decimate(Yf.real, params.h2s_re, D2, nj2)
                     - _audio_decimate(yi, params.h2s_im, D2, nj2))
        audio = audio_ssb if all_ssb else jnp.where(
            params.ssb_mask[:, None], audio_ssb, audio)
        y1_tail = Yf[:, -(K2s - 1):]

    # static coefficients re-derived at trace time (cfg static), so the
    # de-emphasis runs the same matmul-blocked cross-shard scan as the DC
    # tracker (kernels/iir.first_order_apply_blocked locally)
    from ..design import iirdes as _iirdes
    _b0de, _ade = _iirdes.deemphasis_coeffs(cfg.audio_rate)
    deemph, audio = _first_order_time_sharded_blocked(
        _b0de, _ade, state.deemph, audio)

    # per-shard state, with an explicit leading/inner time axis of size 1 so
    # out_specs can lay shards out along TIME and the caller selects the
    # last time shard's carry (the stream boundary for the next block)
    new_state = BankState(
        in_tail=X[-(K1 - 1):][None, :],             # (1, K1-1)    -> (T, K1-1)
        phase=state.phase,                          # unchanged, replicated in T
        n0=state.n0 + jnp.uint32(n_loc * lax.axis_size(TIME_AXIS)),
        fd_prev=fd_prev[:, None],                   # (C_loc, 1)   -> (C, T)
        a_tail=A[:, None, -(K2 - 1):],              # (C_loc,1,K2-1)->(C,T,K2-1)
        deemph=deemph[:, None],                     # (C_loc, 1)   -> (C, T)
        front=jax.tree.map(lambda v: v[:, None], front),  # (C_loc,1)->(C,T)
        dc=None if dc is None else dc[:, None],
        y1_tail=None if y1_tail is None else y1_tail[:, None, :],
    )
    return new_state, audio


class ShardedBank:
    """Receiver bank jitted over a (channel, time) mesh.

    Per-channel params/state shard over 'channel'; the IQ stream shards
    over 'time'. Stream-boundary carries (filter tails, discriminator
    previous sample, de-emphasis value) are produced per time shard with an
    explicit time axis; the wrapper keeps the LAST time shard's carry as
    the next block's left boundary, which shard 0 consumes through the
    leftmost-fill path of the halo exchange. A (1, 1) mesh reproduces the
    single-chip chains/bank.py bank_step exactly (tested)."""

    def __init__(self, cfg: BankConfig, mesh: Mesh, block_len: int,
                 input_format: str = "c64"):
        if input_format not in ("c64", "i16", "u8"):
            raise ValueError(f"unknown input_format {input_format!r} "
                             "(use 'c64', 'i16' or 'u8')")
        D = cfg.decim1 * cfg.decim2
        n_time = mesh.shape[TIME_AXIS]
        # a time-only mesh (no channel axis) keeps channels local to every
        # shard
        CA = CHANNEL_AXIS if CHANNEL_AXIS in mesh.axis_names else None
        n_chan = mesh.shape[CHANNEL_AXIS] if CA else 1
        if cfg.nchan % n_chan:
            raise ValueError("channel count must divide over the channel axis")
        if block_len % (D * n_time):
            raise ValueError(f"block_len must be a multiple of {D * n_time}")
        self.cfg = cfg
        self.mesh = mesh
        self.block_len = block_len
        self.input_format = input_format
        from ..utils.hostbuild import host_build
        from ..chains.bank import _am_indices
        self.params, self.state = host_build(build, cfg, input_format)

        if (self.params.lsb_sign is not None
                and block_len // (cfg.decim1 * n_time) < cfg.taps2_ssb - 1):
            raise ValueError(
                "SSB channels need a per-time-shard baseband slice of at "
                f"least taps2_ssb-1 = {cfg.taps2_ssb - 1} samples for the "
                "one-sided-decimator halo; raise block_len to at least "
                f"{cfg.decim1 * n_time * (cfg.taps2_ssb - 1)}")
        am_idx = _am_indices(cfg)
        coherent = cfg.am_coherent and bool(am_idx)
        # mixed coherent banks (EP): static subgroup gather when channels
        # are local to every shard, all-channel scan + mask-select when
        # the channel axis is sharded (see sharded_bank_step docstring)
        coherent_mode = None
        if coherent and cfg.demod != "am":
            coherent_mode = "gather" if n_chan == 1 else "all"
            if coherent_mode == "all":
                C = cfg.nchan
                self.state = self.state._replace(
                    front=host_build(lambda: jax.tree.map(
                        lambda v: jnp.broadcast_to(v[:1], (C,) + v.shape[1:]),
                        self.state.front)),
                    dc=host_build(
                        lambda: jnp.zeros((C,), jnp.float32)))
        front_spec = dc_spec = None
        front_out = dc_out = None
        if coherent:
            front_spec = jax.tree.map(lambda _: P(CA),
                                      self.state.front)
            dc_spec = P(CA)
            front_out = jax.tree.map(lambda _: P(CA, TIME_AXIS),
                                     self.state.front)
            dc_out = P(CA, TIME_AXIS)
        has_ssb = self.params.lsb_sign is not None
        param_specs = BankParams(
            taps_re=P(CA), taps_im=P(CA),
            dtheta=P(CA), h2=P(),  # audio taps shared
            deemph_b0=P(), deemph_a=P(), fm_mask=P(CA),
            amb=None if self.params.amb is None
            else jax.tree.map(lambda _: P(), self.params.amb),
            ssb_mask=P(CA),
            h2s_re=P() if has_ssb else None,
            h2s_im=P() if has_ssb else None,
            lsb_sign=P(CA) if has_ssb else None,
        )
        state_specs = BankState(
            in_tail=P(), phase=P(CA), n0=P(),
            fd_prev=P(CA), a_tail=P(CA), deemph=P(CA),
            front=front_spec, dc=dc_spec,
            y1_tail=P(CA) if has_ssb else None,
        )
        body = partial(sharded_bank_step, cfg=cfg,
                       coherent_mode=coherent_mode, am_idx=tuple(am_idx))
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(param_specs, state_specs, P(TIME_AXIS)),
            out_specs=(BankState(
                in_tail=(P(TIME_AXIS, None, None)
                         if self.state.in_tail.ndim == 2
                         else P(TIME_AXIS, None)),
                phase=P(CA), n0=P(),
                fd_prev=P(CA, TIME_AXIS),
                a_tail=P(CA, TIME_AXIS, None),
                deemph=P(CA, TIME_AXIS),
                front=front_out, dc=dc_out,
                y1_tail=P(CA, TIME_AXIS, None) if has_ssb else None,
            ), P(CA, TIME_AXIS)),
        )

        def step(params, state, iq):
            st, audio = mapped(params, state, iq)
            # collapse per-time-shard copies: the stream-boundary carries for
            # the next block come from the LAST time shard
            new_state = BankState(
                in_tail=st.in_tail[-1],
                phase=st.phase,
                n0=st.n0,
                fd_prev=st.fd_prev[:, -1],
                a_tail=st.a_tail[:, -1, :],
                deemph=st.deemph[:, -1],
                front=jax.tree.map(lambda v: v[:, -1], st.front),
                dc=None if st.dc is None else st.dc[:, -1],
                y1_tail=None if st.y1_tail is None else st.y1_tail[:, -1, :],
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
