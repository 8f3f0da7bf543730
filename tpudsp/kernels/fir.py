"""Block-parallel FIR execution with carried overlap state (JAX/XLA).

Equivalent of liquid ``firfilt_{rrrf,crcf,cccf}`` (reference
firfilter.hpp:29-35): y[n] = sum_k h[k] x[n-k]. The sample-serial delay
line becomes an explicit (ntaps-1)-sample carried tail; execution is
either a direct convolution (short taps) or overlap-save FFT segments
(long taps) -- both fully parallel over the block (SURVEY.md section 2.2
row "firfilt").

The carried tail is also the halo that time-sharded execution exchanges
between neighboring devices (tpudsp/parallel/halo.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# direct conv below this tap count; overlap-save FFT above
DIRECT_TAPS_MAX = 96


def fir_init(ntaps: int, dtype=jnp.float32):
    """Zero tail state: the last (ntaps-1) inputs."""
    return jnp.zeros((max(ntaps - 1, 0),), dtype=dtype)


def _next_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def _conv_valid_direct(X, h):
    """Valid-mode convolution: out[n] = sum_k h[k] X[n + K-1 - k]."""
    K = h.shape[0]
    N = X.shape[0] - K + 1
    # small-K path: sum of shifted scalings (XLA fuses this into a few
    # vector ops; avoids gather)
    acc = jnp.zeros((N,), dtype=jnp.result_type(X.dtype, h.dtype))
    for k in range(K):
        acc = acc + h[k] * jax.lax.dynamic_slice(X, (K - 1 - k,), (N,))
    return acc


def _conv_valid_fft(X, h):
    """Overlap-save FFT valid convolution. X: (K-1+N,), h: (K,)."""
    K = h.shape[0]
    N = X.shape[0] - K + 1
    F = max(_next_pow2(2 * K), 4096)
    hop = F - (K - 1)
    nseg = -(-N // hop)  # ceil
    pad = (K - 1) + nseg * hop - X.shape[0]
    Xp = jnp.pad(X, (0, max(pad, 0)))
    # segment s covers output samples [s*hop, s*hop + hop), reads
    # Xp[s*hop : s*hop + F). Window length F = hop + (K-1) < 2*hop, so
    # segment s spans hop-rows s and s+1 exactly: two reshapes + a
    # concat, NO gather -- a gather's (nseg, F) index matrix lowers as a
    # dense i32 constant in the program (measured 1.18 MB of the WBFM
    # stereo step's 1.36 MB).
    Xp = jnp.pad(Xp, (0, (nseg + 1) * hop - Xp.shape[0]))
    A = Xp.reshape(nseg + 1, hop)
    segs = jnp.concatenate([A[:-1], A[1:, : K - 1]], axis=1)
    complex_in = jnp.iscomplexobj(X) or jnp.iscomplexobj(h)
    Hf = jnp.fft.fft(h.astype(jnp.complex64), n=F)
    Sf = jnp.fft.fft(segs.astype(jnp.complex64), axis=-1)
    y = jnp.fft.ifft(Sf * Hf[None, :], axis=-1)[:, K - 1 :]
    y = y.reshape(-1)[:N]
    if not complex_in:
        y = y.real
    return y.astype(jnp.result_type(X.dtype, h.dtype))


def fir_apply(h, tail, x, method: str = "auto"):
    """Apply FIR taps ``h`` to block ``x`` with carried tail state.

    h: (K,) float32 or complex64; tail: (K-1,) same dtype family as x;
    x: (N,). Returns (new_tail, y) with y[n] = sum_k h[k] x_full[n-k]
    where x_full is the concatenated stream.
    """
    K = h.shape[0]
    if K == 1:
        return tail, h[0] * x
    X = jnp.concatenate([tail.astype(x.dtype), x])
    if method == "direct" or (method == "auto" and K <= DIRECT_TAPS_MAX):
        y = _conv_valid_direct(X, h)
    else:
        y = _conv_valid_fft(X, h)
    new_tail = X[-(K - 1) :]
    return new_tail, y


def delay_init(nd: int, dtype=jnp.float32):
    """Zero state for an nd-sample delay line (liquid wdelay{f,cf},
    reference utility.hpp:14-15, read-before-push semantics)."""
    return jnp.zeros((nd,), dtype=dtype)


def delay_apply(buf, x):
    """nd-sample delay: emits the buffered samples first. Returns
    (new_buf, y) with y[n] = x_full[n - nd]."""
    nd = buf.shape[0]
    if nd == 0:
        return buf, x
    X = jnp.concatenate([buf.astype(x.dtype), x])
    return X[-nd:], X[: x.shape[0]]
