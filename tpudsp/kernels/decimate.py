"""Strided (decimating) FIR as a blocked matmul.

The fused receiver front ends evaluate long FIR filters only at decimated
output points: y_r[j] = sum_i X[off_r + j*Q + i] * taps_r[i], stride Q,
P phases. Instead of a lax.conv with a multi-thousand-tap kernel, the
filter runs as a blocked matmul:

    pad taps to Kc*Q;  T_r[c, q] = taps_r[c*Q + q]            (Kc, Q)
    Xt_r = X[off_r : off_r + M*Q].reshape(M, Q)               (M, Q)
    Z_r  = Xt_r @ T_r^T                                       (M, Kc)
    y_r[j] = sum_c Z_r[j + c, c]        (diagonal sum: Kc shifted slices)

One (M x Q) @ (Q x Kc) matmul per phase (Q = decimation factor ~ 125
rides the contraction dim); the diagonal sum is Kc cheap vector adds.
Complex input decomposes into re/im real matmuls.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import precision as kp


def plan_phase_taps(taps_per_phase: np.ndarray, Q: int):
    """Host-side: (P, Kf) per-phase taps -> (P, Kc, Q) blocked/padded."""
    P, Kf = taps_per_phase.shape
    Kc = -(-Kf // Q)
    T = np.zeros((P, Kc * Q), taps_per_phase.dtype)
    T[:, :Kf] = taps_per_phase
    return T.reshape(P, Kc, Q)


def strided_fir_matmul(X, T, offsets, Q: int, nj: int):
    """X: (L,) float32/complex64 padded input (L >= max(off)+ (nj+Kc-1)*Q);
    T: (P, Kc, Q) float32 blocked taps; offsets: P python ints; nj: outputs
    per phase. Returns y: (P, nj) with X's dtype."""
    P, Kc, _ = T.shape
    M = nj + Kc - 1
    ys = []
    for r in range(P):
        Xr = lax.dynamic_slice(X, (offsets[r],), (M * Q,)).reshape(M, Q)
        if jnp.iscomplexobj(X):
            Zr = jnp.einsum("mq,kq->mk", Xr.real, T[r],
                            preferred_element_type=jnp.float32,
                            precision=kp.MATMUL)
            Zi = jnp.einsum("mq,kq->mk", Xr.imag, T[r],
                            preferred_element_type=jnp.float32,
                            precision=kp.MATMUL)
            Z = Zr + 1j * Zi
        else:
            Z = jnp.einsum("mq,kq->mk", Xr, T[r],
                           preferred_element_type=jnp.float32,
                           precision=kp.MATMUL)
        acc = Z[0:nj, 0]
        for c in range(1, Kc):
            acc = acc + Z[c:c + nj, c]
        ys.append(acc)
    return jnp.stack(ys)  # (P, nj)


def interleave_phases(y_phases):
    """(P, nj) per-phase outputs -> (P*nj,) stream in output order
    (output k = j*P + r)."""
    return jnp.stack(y_phases, axis=1).reshape(-1) if y_phases.ndim == 2 else y_phases


def plan_fused_frontend(H_bank: np.ndarray, h_lti: np.ndarray, P: int, Q: int):
    """Fold an LTI filter (taps at the input rate) into the P polyphase
    rows a rational-rate (P/Q) decimator needs, blocked for the matmul.

    The bank rows apply correlation-style (window dot row, kernels/resamp.py),
    so the combined correlation taps for phase r are
    d_r = conv(bank_row_r, reverse(h_lti)); output k = j*P + r reads the
    window starting at X index j*Q + floor(r*Q/P), where X carries a
    kf = len(h_lti) + 2m - 1 sample tail (the composed chain's exact
    alignment -- pinned by the fused==composed equivalence test).

    Returns (taps_blocked (P, Kc, Q) float32, kf, offsets)."""
    npfb = H_bank.shape[0] - 1
    rows = []
    for r in range(P):
        f_r = (r * Q / P) % 1.0
        fb = f_r * npfb
        b = int(np.floor(fb))
        w = fb - b
        bank = (1 - w) * H_bank[b] + w * H_bank[b + 1]
        rows.append(np.convolve(bank, h_lti[::-1]))
    taps = plan_phase_taps(np.stack(rows).astype(np.float32), Q)
    kf = len(h_lti) + H_bank.shape[1] - 1
    offsets = [(r * Q) // P for r in range(P)]
    return taps, kf, offsets


def fused_frontend_apply(taps, tail, iq, offsets, Q: int, nj: int):
    """Run the fused filter+decimate front end over one block.

    taps: (P, Kc, Q) from plan_fused_frontend; tail: (>=kf,) carried input
    samples (the last kf are used); iq: (N,) complex64, N = nj * P / rate...
    i.e. nj outputs per phase. Returns (new_tail, y (nj*P,) complex64 in
    output order)."""
    P, Kc, _ = taps.shape
    kf = tail.shape[0]
    X = jnp.concatenate([tail, iq, jnp.zeros(((Kc + 1) * Q,), iq.dtype)])
    yp = strided_fir_matmul(X, taps, offsets, Q, nj)
    y = jnp.stack([yp[r] for r in range(P)], axis=1).reshape(-1).astype(jnp.complex64)
    new_tail = jnp.concatenate([tail, iq])[-kf:]
    return new_tail, y


def fold_offsets(taps, offsets, Q: int):
    """Fold per-phase window offsets into left-zero-padded taps so every
    phase shares the stride-Q window grid starting at j*Q: taps'[r][i] =
    taps[r][i - off_r]. One einsum then serves all P phases with a SINGLE
    pass over the input (the per-phase dynamic_slice formulation reads the
    whole stream P times). taps: (P, Kc, Q); returns (P, Kc2, Q)."""
    P, Kc, Q_ = taps.shape
    flat = np.asarray(taps).reshape(P, Kc * Q_)
    kc2 = -(-(max(offsets) + flat.shape[1]) // Q)
    out = np.zeros((P, kc2 * Q), np.float32)
    for r, off in enumerate(offsets):
        out[r, off:off + flat.shape[1]] = flat[r]
    return out.reshape(P, kc2, Q)


def _shared_grid_matmul(Xm, T, nj: int):
    """Xm: (M, Q) frames (any real/complex dtype castable for the dot);
    T: (P, Kc2, Q) offset-folded taps. Returns (nj, P) outputs in frame
    order (output k = j*P + r at row [j, r])."""
    P, Kc2, _ = T.shape
    Z = jnp.einsum("mq,pkq->pmk", Xm, T,
                   preferred_element_type=jnp.float32,
                   precision=kp.MATMUL)   # (P, M, Kc2)
    acc = Z[:, 0:nj, 0]
    for c in range(1, Kc2):
        acc = acc + Z[:, c:c + nj, c]
    return acc.T                                          # (nj, P)


def fused_frontend_apply_shared(taps, tail, iq, Q: int, nj: int):
    """fused_frontend_apply with offset-folded taps (fold_offsets): the
    input stream is read ONCE for all P phases. taps: (P, Kc2, Q) from
    fold_offsets; tail: (kf,) complex64; iq: (N,) complex64. Returns
    (new_tail, y (nj*P,) complex64)."""
    P, Kc2, _ = taps.shape
    kf = tail.shape[0]
    X = jnp.concatenate([tail, iq, jnp.zeros(((Kc2 + 1) * Q,), iq.dtype)])
    M = nj + Kc2 - 1
    Xm = X[: M * Q].reshape(M, Q)
    yr = _shared_grid_matmul(Xm.real.astype(jnp.float32), taps, nj)
    yi = _shared_grid_matmul(Xm.imag.astype(jnp.float32), taps, nj)
    y = (yr + 1j * yi).reshape(-1).astype(jnp.complex64)
    new_tail = jnp.concatenate([tail, iq])[-kf:]
    return new_tail, y


def fused_frontend_apply_shared_i16(taps, tail, iq2, Q: int, nj: int):
    """Raw-int16 twin of fused_frontend_apply_shared: taps carry the
    1/32767 scale (see fused_frontend_apply_i16); tail/iq2 are (.., 2)
    int16 [re, im]. One pass over the 2 B/component input."""
    P, Kc2, _ = taps.shape
    kf = tail.shape[0]
    X = jnp.concatenate(
        [tail, iq2, jnp.zeros(((Kc2 + 1) * Q, 2), jnp.int16)])
    M = nj + Kc2 - 1
    F = X[: M * Q].reshape(M, Q, 2)
    yr = _shared_grid_matmul(F[..., 0].astype(jnp.float32), taps, nj)
    yi = _shared_grid_matmul(F[..., 1].astype(jnp.float32), taps, nj)
    y = (yr + 1j * yi).reshape(-1).astype(jnp.complex64)
    new_tail = jnp.concatenate([tail, iq2])[-kf:]
    return new_tail, y


def fused_frontend_apply_shared_u8(taps, dc, tail, iq2, Q: int, nj: int):
    """RTL-SDR wire format: (N, 2) uint8 with sample value (b-127.5)/127.5
    (standard RTL-SDR practice, matching tpudsp's io.u8_to_iq; the
    reference itself has no uint8 ingest — its bytes_to_iq is int16-only,
    utility.hpp:61-69). The affine conversion folds into
    the matmul: y = sum t_i (b_i-127.5)/127.5 = sum (t_i/127.5) b_i -
    sum t_i, so taps carry the 1/127.5 scale and ``dc`` is the per-phase
    original-tap sum subtracted from each output component. HBM ingest:
    2 B/sample. taps: (P, Kc2, Q) f32 offset-folded scaled taps; dc: (P,)
    f32; tail: (kf, 2) uint8 (init 127 ~ half-LSB of zero signal)."""
    P, Kc2, _ = taps.shape
    kf = tail.shape[0]
    # pad value is irrelevant: windows only overlap the pad region where
    # the folded taps are zero (real taps end within tail+iq by plan)
    X = jnp.concatenate(
        [tail, iq2, jnp.full(((Kc2 + 1) * Q, 2), 127, jnp.uint8)])
    M = nj + Kc2 - 1
    F = X[: M * Q].reshape(M, Q, 2)
    yr = _shared_grid_matmul(F[..., 0].astype(jnp.float32), taps, nj) - dc
    yi = _shared_grid_matmul(F[..., 1].astype(jnp.float32), taps, nj) - dc
    y = (yr + 1j * yi).reshape(-1).astype(jnp.complex64)
    new_tail = jnp.concatenate([tail, iq2])[-kf:]
    return new_tail, y


def fused_frontend_apply_i16(taps, tail, iq2, offsets, Q: int, nj: int):
    """fused_frontend_apply for RAW int16 interleaved input — the radio's
    native format (reference utility.hpp:61-69 converts host-side; here
    the conversion rides the matmul operand load, so HBM reads 4 B/sample
    instead of 8).

    taps: (P, Kc, Q) float32 with the 1/32767 int16 scale PRE-FOLDED
    (scale the float taps once at plan time); tail: (kf, 2) int16 carried
    raw samples; iq2: (N, 2) int16 [re, im] columns. Returns
    (new_tail (kf, 2) int16, y (nj*P,) complex64) — identical to the
    float path on bytes_to_iq-converted input up to float associativity.
    """
    P, Kc, _ = taps.shape
    kf = tail.shape[0]
    X = jnp.concatenate(
        [tail, iq2, jnp.zeros(((Kc + 1) * Q, 2), jnp.int16)])
    M = nj + Kc - 1
    ys = []
    for r in range(P):
        Xr = lax.dynamic_slice(X, (offsets[r], 0), (M * Q, 2))
        F = Xr.reshape(M, Q, 2)
        # the i16->f32 convert is a unary on the dot operand (XLA fuses
        # it into the operand read); no complex64 input buffer exists
        Zr = jnp.einsum("mq,kq->mk", F[..., 0].astype(jnp.float32), taps[r],
                        preferred_element_type=jnp.float32,
                        precision=kp.MATMUL)
        Zi = jnp.einsum("mq,kq->mk", F[..., 1].astype(jnp.float32), taps[r],
                        preferred_element_type=jnp.float32,
                        precision=kp.MATMUL)
        acc_r = Zr[0:nj, 0]
        acc_i = Zi[0:nj, 0]
        for c in range(1, Kc):
            acc_r = acc_r + Zr[c:c + nj, c]
            acc_i = acc_i + Zi[c:c + nj, c]
        ys.append(acc_r + 1j * acc_i)
    y = jnp.stack(ys, axis=1).reshape(-1).astype(jnp.complex64)
    new_tail = jnp.concatenate([tail, iq2])[-kf:]
    return new_tail, y


def strided_cfir_matmul_wide(X, Tre, Tim, Q: int, nj: int):
    """Same contract as strided_cfir_matmul, reformulated as ONE wide
    matmul.

    The blocked scheme contracts over q (= Q ~ 10), a sliver of a
    matrix unit's depth. Here the Kc shifted frame slices are
    concatenated into explicit windows (im2col from the (M, Q) frame
    matrix -- no gather), and the complex product is packed into one real
    matmul:

        W  = [wr | wi]                      (nj, 2*K1)   K1 = Kc*Q
        TT = [[Tre, Tim], [-Tim, Tre]]      (2*K1, 2*C)
        [yr | yi] = W @ TT                  (nj, 2*C)

    Contraction depth 2*K1 (256 for the default 128-tap bank); the window
    materialization costs Kc x the input bytes, which is far below the
    blocked scheme's (C, M, Kc) x4 intermediates."""
    C, Kc, Q_ = Tre.shape
    K1 = Kc * Q_
    M = nj + Kc - 1
    Xm = X[: M * Q_].reshape(M, Q_)
    xr = Xm.real.astype(jnp.float32)
    xi = Xm.imag.astype(jnp.float32)
    wr = jnp.concatenate([xr[c:c + nj] for c in range(Kc)], axis=1)
    wi = jnp.concatenate([xi[c:c + nj] for c in range(Kc)], axis=1)
    W = jnp.concatenate([wr, wi], axis=1)              # (nj, 2*K1)
    Tr = Tre.reshape(C, K1).T
    Ti = Tim.reshape(C, K1).T
    TT = jnp.concatenate(
        [jnp.concatenate([Tr, Ti], axis=1),
         jnp.concatenate([-Ti, Tr], axis=1)], axis=0)  # (2*K1, 2*C)
    Y = jnp.dot(W, TT, preferred_element_type=jnp.float32,
                precision=kp.MATMUL)
    return (Y[:, :C].T + 1j * Y[:, C:].T).astype(jnp.complex64)


def strided_cfir_matmul_wide_i16(X2, Tre, Tim, Q: int, nj: int):
    """strided_cfir_matmul_wide for RAW interleaved int16 input: X2 is
    (L, 2) int16 [re, im] wire samples and Tre/Tim carry the 1/32767
    scale pre-folded. The im2col window matrix stays int16 until the dot
    operand (2 B/component device-memory traffic instead of 4), with the
    convert fused into the operand read. Returns (C, nj) complex64."""
    C, Kc, Q_ = Tre.shape
    K1 = Kc * Q_
    M = nj + Kc - 1
    F = X2[: M * Q_].reshape(M, Q_, 2)
    xr = F[..., 0]
    xi = F[..., 1]
    wr = jnp.concatenate([xr[c:c + nj] for c in range(Kc)], axis=1)
    wi = jnp.concatenate([xi[c:c + nj] for c in range(Kc)], axis=1)
    W = jnp.concatenate([wr, wi], axis=1).astype(jnp.float32)  # (nj, 2*K1)
    Tr = Tre.reshape(C, K1).T
    Ti = Tim.reshape(C, K1).T
    TT = jnp.concatenate(
        [jnp.concatenate([Tr, Ti], axis=1),
         jnp.concatenate([-Ti, Tr], axis=1)], axis=0)  # (2*K1, 2*C)
    Y = jnp.dot(W, TT, preferred_element_type=jnp.float32,
                precision=kp.MATMUL)
    return (Y[:, :C].T + 1j * Y[:, C:].T).astype(jnp.complex64)


def strided_cfir_matmul_wide_u8(X2, Tre, Tim, Q: int, nj: int):
    """strided_cfir_matmul_wide for the RTL-SDR uint8 wire format: X2 is
    (L, 2) uint8 [re, im] with sample value (b - 127.5)/127.5 (reference
    io convention, u8_to_iq). The affine conversion folds into the
    matmul: Tre/Tim carry the 1/127.5 scale pre-folded, and the -127.5
    offset becomes a per-channel complex DC term computed from the tap
    sums (127.5 * sum(T') = sum(T_orig)) and subtracted from the packed
    outputs. HBM ingest: 2 B/sample. Returns (C, nj) complex64."""
    C, Kc, Q_ = Tre.shape
    K1 = Kc * Q_
    M = nj + Kc - 1
    F = X2[: M * Q_].reshape(M, Q_, 2)
    xr = F[..., 0]
    xi = F[..., 1]
    wr = jnp.concatenate([xr[c:c + nj] for c in range(Kc)], axis=1)
    wi = jnp.concatenate([xi[c:c + nj] for c in range(Kc)], axis=1)
    W = jnp.concatenate([wr, wi], axis=1).astype(jnp.float32)  # (nj, 2*K1)
    Tr = Tre.reshape(C, K1).T
    Ti = Tim.reshape(C, K1).T
    TT = jnp.concatenate(
        [jnp.concatenate([Tr, Ti], axis=1),
         jnp.concatenate([-Ti, Tr], axis=1)], axis=0)  # (2*K1, 2*C)
    Y = jnp.dot(W, TT, preferred_element_type=jnp.float32,
                precision=kp.MATMUL)
    # wr_true = br/127.5 - 1, wi_true = bi/127.5 - 1 applied to the packed
    # product: y_r -= sum(Tre) - sum(Tim); y_i -= sum(Tre) + sum(Tim)
    # (original-tap sums; the taps here are pre-scaled by 1/127.5)
    sre = jnp.float32(127.5) * jnp.sum(Tr, axis=0)      # (C,)
    sim = jnp.float32(127.5) * jnp.sum(Ti, axis=0)
    yr = Y[:, :C] - (sre - sim)[None, :]
    yi = Y[:, C:] - (sre + sim)[None, :]
    return (yr.T + 1j * yi.T).astype(jnp.complex64)


def _cfir_conv_core(xr, xi, Tre, Tim, Q: int, nj: int):
    """Shared lax.conv lowering for the conv engine: xr/xi are (L,)
    float32 input components with L >= (nj + Kc - 1) * Q; returns
    (yr, yi) each (C, nj) float32."""
    C, Kc, Q_ = Tre.shape
    K1 = Kc * Q_
    L = (nj + Kc - 1) * Q_
    lhs = jnp.stack([xr[:L], xi[:L]])[None]              # (1, 2, L)
    tr = Tre.reshape(C, K1)
    ti = Tim.reshape(C, K1)
    # complex product packed as 2C real output features:
    #   y_r = xr*tr - xi*ti ; y_i = xr*ti + xi*tr
    rhs = jnp.concatenate(
        [jnp.stack([tr, -ti], axis=1),
         jnp.stack([ti, tr], axis=1)], axis=0)           # (2C, 2, K1)
    Y = lax.conv_general_dilated(
        lhs, rhs, (Q_,), "VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=kp.MATMUL)                              # (1, 2C, nj)
    return Y[0, :C], Y[0, C:]


def strided_cfir_conv(X, Tre, Tim, Q: int, nj: int):
    """strided_cfir_matmul_wide's contract through XLA's native strided
    convolution (the CPU engine: Eigen's conv path beats both matmul
    formulations ~2-9x there; measured C=16/K=128/2M-sample block: conv
    52 ms vs blocked 454 ms vs wide 998 ms on a CPU). On the GPU the wide
    matmul wins -- see cfir_engine()."""
    xr = X.real.astype(jnp.float32)
    xi = X.imag.astype(jnp.float32)
    yr, yi = _cfir_conv_core(xr, xi, Tre, Tim, Q, nj)
    return (yr + 1j * yi).astype(jnp.complex64)


def strided_cfir_conv_i16(X2, Tre, Tim, Q: int, nj: int):
    """Conv-engine twin of strided_cfir_matmul_wide_i16: X2 is (L, 2)
    int16 wire samples, taps carry the 1/32767 scale pre-folded."""
    xr = X2[:, 0].astype(jnp.float32)
    xi = X2[:, 1].astype(jnp.float32)
    yr, yi = _cfir_conv_core(xr, xi, Tre, Tim, Q, nj)
    return (yr + 1j * yi).astype(jnp.complex64)


def strided_cfir_conv_u8(X2, Tre, Tim, Q: int, nj: int):
    """Conv-engine twin of strided_cfir_matmul_wide_u8: raw (L, 2) uint8
    RTL-SDR samples, taps pre-scaled by 1/127.5, per-channel DC terms
    (the folded -127.5 offset) subtracted from the packed outputs --
    identical algebra to the wide path."""
    C, Kc, Q_ = Tre.shape
    K1 = Kc * Q_
    xr = X2[:, 0].astype(jnp.float32)
    xi = X2[:, 1].astype(jnp.float32)
    yr, yi = _cfir_conv_core(xr, xi, Tre, Tim, Q, nj)
    sre = jnp.float32(127.5) * jnp.sum(Tre.reshape(C, K1), axis=1)  # (C,)
    sim = jnp.float32(127.5) * jnp.sum(Tim.reshape(C, K1), axis=1)
    yr = yr - (sre - sim)[:, None]
    yi = yi - (sre + sim)[:, None]
    return (yr + 1j * yi).astype(jnp.complex64)


# 'auto' engine per platform, measured on the bank front end: XLA:CPU's
# strided conv beats both matmul forms 2-9x on the CPU; on an H100 SXM
# (700 W) the wide matmul beats cuDNN's conv (16-channel bank, 8M-sample
# block: 63 vs 91 ms per step in c64, 56 vs 74 ms in u8; WBFM mono, 2M
# samples: 15 vs 23 ms)
AUTO_ENGINE = {"cpu": "conv", "gpu": "wide"}


def cfir_engine(engine: str = "auto") -> str:
    """Resolve the bank front-end engine: 'conv' | 'wide' | 'auto'.

    'auto' (the default everywhere) picks by the process backend at
    trace time (AUTO_ENGINE); a backend with no measured choice is an
    error. Override with TPUDSP_CFIR_ENGINE=conv|wide for measurements."""
    import os
    eng = os.environ.get("TPUDSP_CFIR_ENGINE", engine)
    if eng == "auto":
        backend = jax.default_backend()
        if backend not in AUTO_ENGINE:
            raise ValueError(f"no measured cfir engine for backend "
                             f"{backend!r}; pass engine='conv' or 'wide'")
        eng = AUTO_ENGINE[backend]
    if eng not in ("conv", "wide"):
        raise ValueError(f"unknown cfir engine {eng!r}")
    return eng


def strided_cfir(X, Tre, Tim, Q: int, nj: int, engine: str = "auto"):
    """Engine-dispatched multi-channel strided complex FIR over one
    shared input stream (the receiver-bank front end). X: (L,) complex64
    OR (L, 2) int16/uint8 wire samples (taps must carry the matching
    pre-folded scale, chains/bank.py build()). Returns (C, nj) c64."""
    eng = cfir_engine(engine)
    if X.ndim == 2 and X.dtype == jnp.uint8:
        f = strided_cfir_conv_u8 if eng == "conv" else strided_cfir_matmul_wide_u8
    elif X.ndim == 2:
        f = strided_cfir_conv_i16 if eng == "conv" else strided_cfir_matmul_wide_i16
    else:
        f = strided_cfir_conv if eng == "conv" else strided_cfir_matmul_wide
    return f(X, Tre, Tim, Q, nj)


def strided_cfir_matmul(X, Tre, Tim, Q: int, nj: int):
    """Multi-channel complex-taps strided FIR as blocked matmuls
    (the receiver-bank front end: per-channel modulated taps, one shared
    input stream).

    X: (L,) complex64 with L >= (nj + Kc - 1) * Q;
    Tre/Tim: (C, Kc, Q) float32 blocked correlation-order taps
    (y[c, j] = sum_i (Tre + j Tim)_flat[c, i] * X[j*Q + i]).
    Returns (C, nj) complex64."""
    C, Kc, _ = Tre.shape
    M = nj + Kc - 1
    Xm = X[: M * Q].reshape(M, Q)
    xr = Xm.real.astype(jnp.float32)
    xi = Xm.imag.astype(jnp.float32)
    # (M, Q) x (C, Kc, Q) -> (C, M, Kc); 4 real matmuls for complex result
    zrr = jnp.einsum("mq,ckq->cmk", xr, Tre, preferred_element_type=jnp.float32,
                     precision=kp.MATMUL)
    zii = jnp.einsum("mq,ckq->cmk", xi, Tim, preferred_element_type=jnp.float32,
                     precision=kp.MATMUL)
    zri = jnp.einsum("mq,ckq->cmk", xr, Tim, preferred_element_type=jnp.float32,
                     precision=kp.MATMUL)
    zir = jnp.einsum("mq,ckq->cmk", xi, Tre, preferred_element_type=jnp.float32,
                     precision=kp.MATMUL)
    Zr = zrr - zii
    Zi = zri + zir
    accr = Zr[:, 0:nj, 0]
    acci = Zi[:, 0:nj, 0]
    for k in range(1, Kc):
        accr = accr + Zr[:, k:k + nj, k]
        acci = acci + Zi[:, k:k + nj, k]
    return (accr + 1j * acci).astype(jnp.complex64)
