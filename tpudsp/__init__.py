"""tpudsp -- software-radio DSP framework in JAX.

A brand-new JAX/XLA/Pallas implementation of the capabilities of
``colbyAtCRI/python-liquiddsp`` (see SURVEY.md): the full 29-class +
bytes_to_iq API surface of the reference (names, kwargs, defaults from its
wrapper.cpp), built on block-parallel kernels with explicit carried state
instead of sample-at-a-time C state machines, plus channel/time-sharded
receiver chains for device meshes (one or several GPUs).

Drop-in usage (matching the reference's README example):

    from tpudsp import ComplexResampler, ComplexIIRFilter, AmpModem, AGC, \
        DeemphasisFilter
"""

from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from . import chains, design, io, kernels, parallel, utils  # noqa: F401

__all__ = list(_ops_all)
__version__ = "0.1.0"
