"""The GPU translation: the Pallas route per platform, the feedback-core
kernel's lane/tail layout, the matmul precision the chains state, the
front-end engine per platform, and the GPU entry points (bench.py peaks,
compile-cache placement, chip_smoke.py refusing a machine without a GPU).

The CPU runs the kernel in the Pallas interpreter; the one test that needs
the card is marked ``chip`` and decides inside a fixture."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpudsp.kernels import agc as kagc
from tpudsp.kernels import am_backend as kab
from tpudsp.pallas.am_backend_scan import front_chunked_pallas
from tests.util import snr_db


def _params(alpha=0.05):
    return kab.make_params(kagc.make_params(alpha=alpha, scale=0.5), 0.5,
                           0.05, 0.95, carrier=True)


def _streams(C, L):
    t = np.arange(L)
    return np.stack([
        (1 + 0.5 * np.sin(2 * np.pi * (0.01 + 0.003 * c) * t))
        * (0.2 + 0.1 * c) * np.exp(2j * np.pi * 0.001 * (c + 1) * t)
        for c in range(C)]).astype(np.complex64)


def _state(C):
    return kab.FrontState(
        agc=jax.tree.map(lambda v: jnp.broadcast_to(v, (C,)),
                         kagc.agc_init()),
        pll=kab.PllState(jnp.zeros((C,), jnp.float32),
                         jnp.zeros((C,), jnp.float32)))


def _kernel_fn(chunk=512, warmup=512):
    p = _params()
    return jax.jit(lambda s, x: front_chunked_pallas(p, s, x, chunk=chunk,
                                                     warmup=warmup))


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found "
                    f"{jax.devices()[0].platform!r}")
    return jax.devices()[0]


# -- route -------------------------------------------------------------------
def test_pallas_route_cpu_runs_the_interpreter():
    """On the CPU the kernel runs (interpret mode) and agrees with the
    exact sequential front on a short stream."""
    x = jnp.asarray(_streams(1, 600))
    front, (vr, modes) = _kernel_fn()(_state(1), x)
    fe, (vre, _) = kab.front_exact(_params(), jax.tree.map(lambda v: v[0],
                                                           _state(1)), x[0])
    assert snr_db(np.asarray(vre), np.asarray(vr[0])) > 100.0
    assert modes.dtype == jnp.int32


def test_pallas_route_refuses_other_platforms():
    """No route exists for ROCm: lowering for it raises rather than
    silently interpreting."""
    traced = _kernel_fn().trace(_state(1), jnp.asarray(_streams(1, 600)))
    with pytest.raises(NotImplementedError):
        traced.lower(lowering_platforms=("rocm",))


def test_pallas_route_lowers_through_triton_for_cuda():
    """Lowered for CUDA (possible without a card), the kernel is a Triton
    call, not the interpreter's discharged loops."""
    traced = _kernel_fn().trace(_state(2), jnp.asarray(_streams(2, 3000)))
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text
    assert "am_front_chunked" in text


# -- the kernel's lanes and time tail ----------------------------------------
@pytest.mark.parametrize("C,L,chunk", [
    (1, 700, 512),      # one chunk + warmup: a single exact lane
    (2, 3000, 512),     # L not a multiple of chunk: masked time tail
    (3, 4096, 512),     # L a multiple of chunk
    (5, 2600, 256),     # lanes (5 x 11) spill past one 32-lane program
    (40, 1200, 256),    # 40 x 5 lanes: seven programs, padded last block
])
def test_kernel_lanes_match_xla_twin(C, L, chunk):
    """Every stream of the (C, L) batch matches the XLA warmup-chunk twin
    (kernels/am_backend.front_chunked) run per stream, output and carried
    state, whatever the lane padding and the time tail."""
    p = _params()
    x = jnp.asarray(_streams(C, L))
    front, (vr, modes) = jax.jit(lambda s, v: front_chunked_pallas(
        p, s, v, chunk=chunk, warmup=chunk))(_state(C), x)
    fx, (vx, mx) = jax.vmap(lambda s, v: kab.front_chunked(
        p, s, v, chunk=chunk, warmup=chunk))(_state(C), x)
    assert vr.shape == (C, L) and modes.shape == (C, L)
    for c in range(C):
        assert snr_db(np.asarray(vx[c]), np.asarray(vr[c])) > 100.0, c
    np.testing.assert_array_equal(np.asarray(modes), np.asarray(mx))
    np.testing.assert_allclose(np.asarray(front.agc.g), np.asarray(fx.agc.g),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(front.pll.theta),
                               np.asarray(fx.pll.theta), atol=1e-4)


def test_kernel_rejects_warmup_longer_than_chunk():
    p = _params()
    with pytest.raises(ValueError, match="warmup <= chunk"):
        front_chunked_pallas(p, _state(1), jnp.asarray(_streams(1, 4000)),
                             chunk=512, warmup=1024)


@pytest.mark.chip
def test_kernel_on_card_matches_interpreter(gpu):
    """The Triton-compiled kernel on the card against the same kernel in
    the interpreter on the host CPU device."""
    x = _streams(4, 20_000)
    f = _kernel_fn(chunk=1024, warmup=1024)
    _, (vr_gpu, _) = f(_state(4), jnp.asarray(x))
    cpu = jax.devices("cpu")[0]
    _, (vr_cpu, _) = f(jax.device_put(_state(4), cpu), jax.device_put(x, cpu))
    for c in range(4):
        assert snr_db(np.asarray(vr_cpu[c]), np.asarray(vr_gpu[c])) > 100.0


# -- precision ---------------------------------------------------------------
def _dot_precisions(jaxpr):
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            found.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found += _dot_precisions(sub)
    return found


def _chain_step(name):
    from functools import partial
    from tpudsp.chains.am import AMConfig, am_step_fused, build as am_build
    from tpudsp.chains.bank import BankConfig, bank_step, build as bk_build
    from tpudsp.chains.channelizer import (ChannelizedBankConfig,
                                           ChannelizerConfig,
                                           bank_build as ch_build,
                                           bank_step as ch_step)
    from tpudsp.chains.wbfm import WBFMStereoReceiver, _stereo_step
    if name.startswith("am_"):
        fmt = name[3:]
        n = 125_000
        p, s, _ = am_build(AMConfig(), n, fmt)
        x = (jnp.zeros((n,), jnp.complex64) if fmt == "c64"
             else jnp.zeros((n, 2), jnp.int16 if fmt == "i16" else jnp.uint8))
        return partial(am_step_fused, cfg=AMConfig()), (p, s, x)
    if name == "wbfm_stereo":
        rx = WBFMStereoReceiver(block_len=10_000)
        return (partial(_stereo_step, cfg=rx.cfg),
                (rx._params, rx.state, jnp.zeros((10_000,), jnp.complex64)))
    if name == "bank16_coherent":
        cfg = BankConfig(freqs=tuple(float(f) for f in range(0, 16_000, 1000)),
                         demod=("fm", "am") * 8, am_coherent=True)
        p, s = bk_build(cfg)
        return partial(bank_step, cfg=cfg), (p, s, jnp.zeros((20_000,),
                                                             jnp.complex64))
    cfg = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=64))
    p, s = ch_build(cfg)
    return partial(ch_step, cfg=cfg), (p, s, jnp.zeros((64 * 64,),
                                                       jnp.complex64))


@pytest.mark.parametrize("name", ["am_c64", "am_i16", "am_u8", "wbfm_stereo",
                                  "bank16_coherent", "channelized"])
def test_chain_step_states_its_matmul_precision(name):
    """Every f32 dot and convolution of a chain step carries the chosen
    precision (kernels/precision.MATMUL): an unstated one may run in
    TF32 on the GPU, far below the chains' fidelity bars."""
    from tpudsp.kernels import precision as kp
    step, args = _chain_step(name)
    found = _dot_precisions(jax.make_jaxpr(step)(*args).jaxpr)
    assert found, "no dot or convolution in the step"
    for prec in found:
        assert prec is not None, name
        pair = prec if isinstance(prec, tuple) else (prec, prec)
        assert all(q == kp.MATMUL for q in pair), (name, prec)


# -- front-end engine --------------------------------------------------------
@pytest.mark.parametrize("backend,want", [("cpu", "conv"), ("gpu", "wide"),
                                          ("rocm", None)])
def test_cfir_engine_resolves_per_platform(monkeypatch, backend, want):
    from tpudsp.kernels import decimate as kdec
    monkeypatch.delenv("TPUDSP_CFIR_ENGINE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(ValueError, match="no measured cfir engine"):
            kdec.cfir_engine("auto")
    else:
        assert kdec.cfir_engine("auto") == want


# -- entry points ------------------------------------------------------------
@pytest.mark.parametrize("kind,hbm", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                      ("NVIDIA H100 PCIe", 2.0e12)])
def test_bench_peaks_by_device_kind(kind, hbm):
    import bench
    peaks = bench.peaks_for(kind)
    assert peaks["hbm_bytes_per_s"] == hbm
    assert peaks["bf16_flops_per_s"] > peaks["tf32_flops_per_s"]


def test_bench_unknown_device_kind_is_an_error():
    import bench
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks_for("NVIDIA A100-SXM4-80GB")


def test_bench_refuses_cpu_without_flag(capsys):
    import bench
    assert bench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "--cpu" in out.err


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from tpudsp.utils import gpu
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(jax.config, "update", lambda *a: seen.append(a))
    assert gpu.enable_compile_cache() == str(tmp_path)
    assert seen == []  # JAX reads the variable itself


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import os
    from tpudsp.utils import gpu
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = []
    monkeypatch.setattr(jax.config, "update", lambda *a: seen.append(a))
    d = gpu.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(root, ".jax_cache")
    assert seen == [("jax_compilation_cache_dir", d)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert all('"ok"' not in line for line in out.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.strip().splitlines()[-1] if out.strip() else "")
