"""Hand-written Pallas kernels for the hot paths XLA does not serve well.

Each kernel has an XLA twin in tpudsp/kernels pinned by equivalence tests.
The route is chosen from the platform the computation is lowered for,
never from the process default: CUDA compiles the kernel through Triton,
CPU runs it in the Pallas interpreter (the tests), and any other platform
is refused when the program is lowered."""

from functools import partial

from jax import lax


def on_platform(fn, *args):
    """Call ``fn(*args, interpret=...)`` with the route for the lowering
    platform: ``interpret=False`` (Triton) on CUDA, ``interpret=True`` on
    CPU. No branch exists for other platforms, so lowering for one raises."""
    return lax.platform_dependent(*args, cpu=partial(fn, interpret=True),
                                  cuda=partial(fn, interpret=False))
