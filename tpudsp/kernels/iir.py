"""Block-parallel IIR execution (JAX/XLA).

Two execution modes for the liquid ``iirfilt_*`` equivalents (reference
iirfilter.hpp:52-58, 292-298):

1. ``sos_scan``: exact SOS cascade as a log-depth associative scan over
   2x2 state-transition operators -- the reference's per-sample transposed
   direct-form-II recurrence reformulated as a parallel prefix
   (SURVEY.md section 2.2 row "iirfilt SOS engine").

2. truncated-impulse-response mode (see tpudsp/design/iirdes.py
   sos_impulse_response + tpudsp/kernels/fir.py): the LTI filter runs as a
   fully parallel overlap-save convolution. Ops choose this when the
   impulse response decays within a budget; it has no sequential
   dependence at all.

State convention: every function is pure, ``(params, state, x) -> (state, y)``
with state an explicit pytree (SURVEY.md section 7 core decision 1).

Transposed direct form II per biquad (b0,b1,b2,1,a1,a2):
    y[n]  = b0 x[n] + s1[n-1]
    s1[n] = b1 x[n] - a1 y[n] + s2[n-1]
    s2[n] = b2 x[n] - a2 y[n]
Eliminating y[n] gives the linear state recurrence v[n] = A v[n-1] + c x[n]:
    A = [[-a1, 1], [-a2, 0]],  c = [b1 - a1 b0, b2 - a2 b0]
whose prefix products are computed with jax.lax.associative_scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import precision as kp


def sos_init(sos: np.ndarray, dtype=jnp.float32):
    """Zero state for an SOS cascade: (S, 2) per-biquad DF2T state."""
    return jnp.zeros((len(sos), 2), dtype=dtype)


def _biquad_scan(coef, v0, x):
    """One biquad over a block via associative scan.

    coef: (6,) float32 [b0,b1,b2,1,a1,a2]; v0: (2,) state; x: (N,).
    Returns (v_last, y).
    """
    b0, b1, b2, _, a1, a2 = [coef[i] for i in range(6)]
    n = x.shape[0]
    # Elements (M, u): prefix P[n] = (A^{n+1}, sum_k A^{n-k} c x[k]),
    # combine (M1,u1) then (M2,u2) -> (M2 M1, M2 u1 + u2).
    A = jnp.stack(
        [jnp.stack([-a1, jnp.ones_like(a1)]), jnp.stack([-a2, jnp.zeros_like(a2)])]
    )
    c = jnp.stack([b1 - a1 * b0, b2 - a2 * b0])

    M = jnp.broadcast_to(A, (n, 2, 2))
    u = c[None, :] * x[:, None]

    def combine(e1, e2):
        M1, u1 = e1
        M2, u2 = e2
        return (jnp.matmul(M2, M1, precision=kp.MATMUL),
                jnp.einsum("nij,nj->ni", M2, u1, precision=kp.MATMUL) + u2)

    Mp, up = jax.lax.associative_scan(combine, (M, u))
    v = jnp.einsum("nij,j->ni", Mp, v0, precision=kp.MATMUL) + up  # v[n]
    v_prev = jnp.concatenate([v0[None, :], v[:-1]], 0)  # v[n-1]
    y = b0 * x + v_prev[:, 0]
    return v[-1], y


def sos_apply(sos, state, x):
    """SOS cascade over a 1-D block. sos: (S, 6) float32 device array;
    state: (S, 2) (complex for complex x); x: (N,) float32/complex64.
    Returns (new_state, y). Stages run sequentially (S is small), each
    stage block-parallel."""
    S = sos.shape[0]
    new_states = []
    y = x
    for s in range(S):
        vs, y = _biquad_scan(sos[s], state[s], y)
        new_states.append(vs)
    return jnp.stack(new_states), y


# --- compensated (double-float) scan: the plain f32 associative scan
# sits at a ~60 dB floor for high-Q poles (prefix products of
# near-unit-circle transition matrices cancel catastrophically at
# log-depth). Representing every scan value as an UNEVALUATED f32 PAIR
# (hi, lo) with error-free transforms (Dekker/Knuth) carries ~48
# mantissa bits through the combine at f32 register width -- no float64
# anywhere. ~20x the flops of the plain
# combine, still fully parallel; this is the non-default fallback path
# for impulse responses past the TIR budget, where it measures >110 dB
# on the README's order-8 cheby2 (tests/test_kernels.py).

_DK = 4097.0  # 2^12 + 1: Dekker split point for f32 (24-bit mantissa)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dk_split(a):
    t = _DK * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _dk_split(a)
    bh, bl = _dk_split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _df_renorm(hi, lo):
    s = hi + lo
    return s, lo - (s - hi)


def _df_add(x, y):
    sh, se = _two_sum(x[0], y[0])
    return _df_renorm(sh, se + (x[1] + y[1]))


def _df_mul(x, y):
    ph, pe = _two_prod(x[0], y[0])
    return _df_renorm(ph, pe + (x[0] * y[1] + x[1] * y[0]))


def sos_split_df(sos64: np.ndarray):
    """Host-side: float64 SOS (S, 6) -> double-float scan coefficients.

    Splitting happens BEFORE f32 rounding: for low-Fc high-Q designs the
    f32-rounded a1/a2 move the poles by enough to change the transfer
    function itself (~60 dB floor on the README's cheby2 order-8
    Fc=0.0075) -- no runtime precision can recover that, so the (hi, lo)
    pairs are computed from the float64 design values.

    Returns (A_hi, A_lo (S,2,2) f32; c_hi, c_lo (S,2) f32; b0 (S,) f32).
    """
    sos64 = np.asarray(sos64, np.float64)
    S = len(sos64)
    A64 = np.zeros((S, 2, 2))
    c64 = np.zeros((S, 2))
    for s, (b0, b1, b2, _, a1, a2) in enumerate(sos64):
        A64[s] = [[-a1, 1.0], [-a2, 0.0]]
        c64[s] = [b1 - a1 * b0, b2 - a2 * b0]
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi).astype(np.float32)
    c_hi = c64.astype(np.float32)
    c_lo = (c64 - c_hi).astype(np.float32)
    return (jnp.asarray(A_hi), jnp.asarray(A_lo), jnp.asarray(c_hi),
            jnp.asarray(c_lo), jnp.asarray(sos64[:, 0], jnp.float32))


def _biquad_scan_df(A_hi, A_lo, c_hi, c_lo, b0, v0, x):
    """Compensated twin of _biquad_scan for REAL x (the biquad recurrence
    has real coefficients, so complex blocks run it on re/im separately).
    A_*: (2,2) f32 pair; c_*: (2,) f32 pair; b0 scalar; v0: (2,) f32
    carried state; x: (N,) f32. Returns (v_last (2,), y (N,)) in f32."""
    n = x.shape[0]
    Mh = jnp.broadcast_to(A_hi, (n, 2, 2))
    Ml = jnp.broadcast_to(A_lo, (n, 2, 2))
    uh, ul = _two_prod(jnp.broadcast_to(c_hi[None, :], (n, 2)), x[:, None])
    uh, ul = _df_renorm(uh, ul + c_lo[None, :] * x[:, None])

    def combine(e1, e2):
        M1h, M1l, u1h, u1l = e1
        M2h, M2l, u2h, u2l = e2
        # 2x2 df matmul M2 @ M1 and df matvec M2 @ u1 + u2, unrolled
        Mh_rows, Ml_rows = [], []
        uh_rows, ul_rows = [], []
        for i in range(2):
            mr_h, mr_l = [], []
            acc = None
            for j in range(2):
                s = _df_mul((M2h[..., i, 0], M2l[..., i, 0]),
                            (M1h[..., 0, j], M1l[..., 0, j]))
                t = _df_mul((M2h[..., i, 1], M2l[..., i, 1]),
                            (M1h[..., 1, j], M1l[..., 1, j]))
                m = _df_add(s, t)
                mr_h.append(m[0])
                mr_l.append(m[1])
            Mh_rows.append(jnp.stack(mr_h, axis=-1))
            Ml_rows.append(jnp.stack(mr_l, axis=-1))
            s = _df_mul((M2h[..., i, 0], M2l[..., i, 0]), (u1h[..., 0], u1l[..., 0]))
            t = _df_mul((M2h[..., i, 1], M2l[..., i, 1]), (u1h[..., 1], u1l[..., 1]))
            acc = _df_add(_df_add(s, t), (u2h[..., i], u2l[..., i]))
            uh_rows.append(acc[0])
            ul_rows.append(acc[1])
        return (jnp.stack(Mh_rows, axis=-2), jnp.stack(Ml_rows, axis=-2),
                jnp.stack(uh_rows, axis=-1), jnp.stack(ul_rows, axis=-1))

    Mph, Mpl, uph, upl = jax.lax.associative_scan(combine, (Mh, Ml, uh, ul))
    # v[n] = Mp[n] @ v0 + up[n], df throughout; emit f32
    vh, vl = [], []
    for i in range(2):
        s = _df_mul((Mph[:, i, 0], Mpl[:, i, 0]), (v0[0], jnp.zeros_like(v0[0])))
        t = _df_mul((Mph[:, i, 1], Mpl[:, i, 1]), (v0[1], jnp.zeros_like(v0[1])))
        r = _df_add(_df_add(s, t), (uph[:, i], upl[:, i]))
        vh.append(r[0])
        vl.append(r[1])
    v = jnp.stack([vh[0] + vl[0], vh[1] + vl[1]], axis=-1)
    v_prev = jnp.concatenate([v0[None, :], v[:-1]], 0)
    y = b0 * x + v_prev[:, 0]
    return v[-1], y


def sos_apply_df(params_df, state, x):
    """Compensated-f32 twin of sos_apply (the mode='scan' op path).
    params_df from sos_split_df; state/x as sos_apply. Complex blocks run
    the real-coefficient recurrence on re/im independently; carried state
    stays f32 (hi only) at block edges -- the boundary rounding is
    per-block and does not compound."""
    A_hi, A_lo, c_hi, c_lo, b0 = params_df
    S = A_hi.shape[0]
    new_states = []
    y = x
    for s in range(S):
        args = (A_hi[s], A_lo[s], c_hi[s], c_lo[s], b0[s])
        if jnp.iscomplexobj(y):
            vr, yr = _biquad_scan_df(*args, state[s].real, y.real)
            vi, yi = _biquad_scan_df(*args, state[s].imag, y.imag)
            vs = vr + 1j * vi
            y = (yr + 1j * yi).astype(jnp.complex64)
        else:
            vs, y = _biquad_scan_df(*args, state[s], y)
        new_states.append(vs)
    return jnp.stack(new_states), y


def first_order_split_df(b0_64: float, a_64: float):
    """Host-side: float64 one-pole coefficients -> f32 (hi, lo) pairs for
    the compensated scan (split BEFORE f32 rounding, like sos_split_df)."""
    b_hi = np.float32(b0_64)
    a_hi = np.float32(a_64)
    return (jnp.float32(a_hi), jnp.float32(np.float64(a_64) - a_hi),
            jnp.float32(b_hi), jnp.float32(np.float64(b0_64) - b_hi))


def first_order_prefix_df(params_df, x):
    """Inclusive double-float prefixes of the first-order recurrence on
    the trailing axis: returns (aph, apl, uph, upl) with
    y[k] = (ap[k]) * y_entry + up[k] in (hi, lo) arithmetic. Shared core
    of first_order_apply_df and the cross-shard transition-aggregate
    scans (parallel/bank.py _first_order_time_sharded_df): the LAST
    element of each prefix is the block/shard transition aggregate."""
    a_hi, a_lo, b_hi, b_lo = params_df
    ah = jnp.broadcast_to(a_hi, x.shape)
    al = jnp.broadcast_to(a_lo, x.shape)
    uh, ul = _two_prod(jnp.broadcast_to(b_hi, x.shape), x)
    uh, ul = _df_renorm(uh, ul + b_lo * x)

    def combine(e1, e2):
        a1h, a1l, u1h, u1l = e1
        a2h, a2l, u2h, u2l = e2
        a = _df_mul((a1h, a1l), (a2h, a2l))
        u = _df_add(_df_mul((a2h, a2l), (u1h, u1l)), (u2h, u2l))
        return (a[0], a[1], u[0], u[1])

    return jax.lax.associative_scan(combine, (ah, al, uh, ul), axis=-1)


def first_order_apply_df(params_df, y_prev, x):
    """Compensated (double-float) twin of first_order_apply for REAL x.

    Near-unit poles (e.g. the ampmodem DC tracker, rho = 0.9995) floor
    the plain f32 associative scan at ~86 dB (measured, FIDELITY.md):
    the prefix products a^k stay ~1 while the u-prefix accumulates ~N
    roundings of comparable magnitude. The (hi, lo) carry holds ~48
    mantissa bits through the combine; boundary state stays f32 (per-
    block rounding, does not compound)."""
    aph, apl, uph, upl = first_order_prefix_df(params_df, x)
    yh, yl = _df_add(_df_mul((aph, apl),
                             (y_prev, jnp.zeros_like(y_prev))), (uph, upl))
    y = yh + yl
    return y[..., -1], y


def first_order_apply_blocked(b0: float, a: float, y_prev, x,
                              L: int = 32):
    """Matmul-blocked first-order scan: y[n] = b0 x[n] + a y[n-1].

    The formulation of the near-unit-pole recurrence (DC tracker rho =
    0.9995, de-emphasis): within an L-sample block the inclusive prefix
    is ONE lower-triangular matmul against the a-power kernel
    T[i, j] = b0 a^{i-j} (j <= i) -- generated from iota at trace time,
    so the program carries no (L, L) constant -- and the cross-block
    entry value is carried exactly-ish in (hi, lo) double-float through
    a tiny sequential lax.scan (n/L steps).

    Accuracy: f32 rounding is confined WITHIN one L-block (error ~L eps:
    measured 129/123/117/111 dB at L=16/32/64/128 vs the f64 serial
    oracle at rho=0.9995 over 50k samples, on the CPU; default L=32 --
    the plain f32 associative scan floors at ~86 dB), the long-range
    accumulation runs in double-float, and a^L is split from float64.

    b0, a MUST be static Python floats (fold design-time coefficients
    at trace time, e.g. iirdes.deemphasis_coeffs / ampmodem.DC_RHO).
    x: (N,) real; y_prev: f32 scalar. Returns (y_last, y)."""
    b0 = float(b0)
    a = float(a)
    n = x.shape[-1]
    B = -(-n // L)
    pad = B * L - n
    xp = jnp.pad(x, (0, pad)) if pad else x
    i = jnp.arange(L, dtype=jnp.float32)
    E = i[:, None] - i[None, :]
    # a^E is finite for E < 0 too (a^-L ~ 1.07 at rho=0.9995); the tril
    # mask zeroes the upper triangle afterwards, so no inf*0 anywhere
    T = jnp.where(E >= 0, jnp.float32(b0) * jnp.float32(a) ** E, 0.0)
    powers = jnp.float32(a) ** (i + 1.0)
    U = xp.reshape(B, L)
    Yin = jnp.einsum("bl,il->bi", U, T,
                     preferred_element_type=jnp.float32,
                     precision=kp.MATMUL)
    S = Yin[:, -1]
    aL = np.float64(a) ** L
    aL_hi = jnp.float32(aL)
    aL_lo = jnp.float32(np.float64(aL) - np.float64(np.float32(aL)))

    def body(carry, s_b):
        ch, cl = carry  # df entry value y[bL-1] for this block
        nh, nl = _df_add(_df_mul((aL_hi, aL_lo), (ch, cl)),
                         (s_b, jnp.zeros_like(s_b)))
        return (nh, nl), (ch, cl)

    # carry init inherits S's varying-axes set (0*S[0]) so the scan is
    # well-typed under shard_map whatever the callers' sharding
    y0 = jnp.asarray(y_prev, jnp.float32) + 0.0 * S[0]
    (_, _), (EH, EL) = jax.lax.scan(body, (y0, 0.0 * S[0]), S)
    Y = Yin + powers[None, :] * (EH + EL)[:, None]
    y = Y.reshape(B * L)[:n]
    return y[-1], y


def first_order_apply_blocked_c64(b0: float, a: float, y_prev, x,
                                  L: int = 32):
    """Complex-input twin of first_order_apply_blocked (same within-
    block lower-triangular a-power matmul) with a plain complex64
    cross-block lax.scan carry instead of the (hi, lo) double-float one
    -- the precision class of the f32 associative scan it replaces,
    which is all the pilot smoothers need (rho = 0.999, phase estimate
    normalized to unit magnitude downstream); the df carry is for the
    near-unit REAL poles with >= 100 dB pins. b0, a static Python
    floats; x: (N,) complex64."""
    b0 = float(b0)
    a = float(a)
    n = x.shape[-1]
    B = -(-n // L)
    pad = B * L - n
    xp = jnp.pad(x, (0, pad)) if pad else x
    i = jnp.arange(L, dtype=jnp.float32)
    E = i[:, None] - i[None, :]
    T = jnp.where(E >= 0, jnp.float32(b0) * jnp.float32(a) ** E, 0.0)
    powers = (jnp.float32(a) ** (i + 1.0)).astype(jnp.complex64)
    U = xp.reshape(B, L)
    Yin = jnp.einsum("bl,il->bi", U, T.astype(jnp.complex64),
                     preferred_element_type=jnp.complex64,
                     precision=kp.MATMUL)
    S = Yin[:, -1]
    aL = jnp.complex64(np.float64(a) ** L)

    def body(c, s_b):
        return aL * c + s_b, c

    # carry init inherits S's varying-axes set (see the real twin)
    _, Ecar = jax.lax.scan(
        body, jnp.asarray(y_prev, jnp.complex64) + 0.0 * S[0], S)
    Y = Yin + powers[None, :] * Ecar[:, None]
    y = Y.reshape(B * L)[:n]
    return y[-1], y


def first_order_apply_blocked_mc(b0: float, a: float, y_prev, x,
                                 L: int = 32):
    """Multi-channel column twin of first_order_apply_blocked: the SAME
    recurrence y[n, c] = b0 x[n, c] + a y[n-1, c] run down axis 0 of a
    row-major (N, C) frame matrix — the natural layout of the polyphase
    channelizer's output, where transposing the c64 frames first costs
    more than the whole scan (measured: the (M, C) -> (C, M) transpose
    fused into the back end adds ~30 ms at M=2048, C=1024 on CPU).

    Within-block prefix is one (L, L) lower-triangular a-power matmul
    against (B, L, C) blocks — a larger matmul than the vmapped
    per-channel form — and the cross-block entry values carry in (hi, lo)
    double-float through a length-B lax.scan exactly as the 1-D kernel
    does (same precision class; equality with the vmapped twin is pinned
    by test_kernels). b0, a static Python floats; x: (N, C) f32;
    y_prev: (C,) f32. Returns (y_last (C,), y (N, C))."""
    b0 = float(b0)
    a = float(a)
    n, C = x.shape
    B = -(-n // L)
    pad = B * L - n
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    i = jnp.arange(L, dtype=jnp.float32)
    E = i[:, None] - i[None, :]
    T = jnp.where(E >= 0, jnp.float32(b0) * jnp.float32(a) ** E, 0.0)
    powers = jnp.float32(a) ** (i + 1.0)
    U = xp.reshape(B, L, C)
    Yin = jnp.einsum("il,blc->bic", T, U,
                     preferred_element_type=jnp.float32,
                     precision=kp.MATMUL)
    S = Yin[:, -1, :]                                   # (B, C)
    aL = np.float64(a) ** L
    aL_hi = jnp.float32(aL)
    aL_lo = jnp.float32(np.float64(aL) - np.float64(np.float32(aL)))

    def body(carry, s_b):
        ch, cl = carry
        nh, nl = _df_add(_df_mul((aL_hi, aL_lo), (ch, cl)),
                         (s_b, jnp.zeros_like(s_b)))
        return (nh, nl), (ch, cl)

    y0 = jnp.asarray(y_prev, jnp.float32) + 0.0 * S[0]
    (_, _), (EH, EL) = jax.lax.scan(body, (y0, 0.0 * y0), S)
    Y = Yin + powers[None, :, None] * (EH + EL)[:, None, :]
    y = Y.reshape(B * L, C)[:n]
    return y[-1], y


def first_order_init(dtype=jnp.float32):
    return jnp.zeros((), dtype=dtype)


def first_order_apply(b0, a, y_prev, x):
    """y[n] = b0 x[n] + a y[n-1] via first-order associative scan
    (deemphasis / one-pole smoothers, reference iirfilter.hpp:358-392).
    b0, a: scalars; y_prev: scalar carried state; x: (N,).
    Returns (y_last, y)."""
    n = x.shape[0]
    a_arr = jnp.broadcast_to(jnp.asarray(a, x.real.dtype), (n,))
    u = b0 * x + jnp.zeros_like(x)

    def combine(e1, e2):
        a1, u1 = e1
        a2, u2 = e2
        return a1 * a2, a2 * u1 + u2

    ap, up = jax.lax.associative_scan(combine, (a_arr, u))
    y = ap * y_prev + up
    return y[-1], y
