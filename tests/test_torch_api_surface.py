"""The port's flat namespace against the JAX package's (tests/test_api_surface
.py): every name of the reference's ``tfc.*`` surface at the top level, the
parameter wrappers, the native ops, the rounding modules against the JAX
package's flax modules (float32 at 1e-6), and trace / annotate."""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compression_tpu as tpc
import compression_tpu_torch as port
from compression_tpu.layers import soft_round as jax_soft_round

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_api_surface import _FUNCTIONAL_EQUIVALENTS, _REFERENCE_NAMES  # noqa: E402

torch.set_num_threads(1)


def test_reference_surface_present():
    missing = [n for n in _REFERENCE_NAMES + _FUNCTIONAL_EQUIVALENTS if not hasattr(port, n)]
    assert not missing, missing


def test_every_public_name_of_the_jax_package_is_present():
    # Submodules appear as attributes once anything imports them: skip them.
    names = [n for n in dir(tpc) if not n.startswith("_")
             and not isinstance(getattr(tpc, n), types.ModuleType)]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    assert port.IdentityInitializer is port.identity_kernel_init
    assert port.EntropyBottleneck is port.ContinuousBatchedEntropyModel
    assert port.GaussianConditional is port.LocationScaleIndexedEntropyModel


def test_the_package_imports_no_jax():
    import subprocess

    code = ("import sys, compression_tpu_torch, compression_tpu_torch.models.toy_sources; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'compression_tpu.')) "
            "or m == 'compression_tpu' for m in sys.modules), 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=__file__.rsplit("/", 2)[0])


def test_parameter_wrappers_roundtrip_and_grad():
    g = port.GDNParameter.create(torch.tensor([0.5, 0.0, 2.0]), minimum=0.0)
    np.testing.assert_allclose(g().detach().numpy(), [0.5, 0.0, 2.0], atol=1e-6)
    assert isinstance(g, port.Parameter)
    grads = torch.autograd.grad((g() ** 2).sum(), g.stored)[0]
    assert grads.shape == g.stored.shape and torch.isfinite(grads).all()
    want = tpc.GDNParameter.create(jnp.array([0.5, 0.0, 2.0]), minimum=0.0)
    np.testing.assert_allclose(g.stored.detach().numpy(), np.asarray(want.stored), rtol=1e-6)


def test_native_ops_callable_from_top_level():
    cdf = port.pmf_to_quantized_cdf(np.array([0.5, 0.25, 0.25]), np.array([3], np.int32), 12)
    assert cdf[0, -1] == 4096
    assert (np.diff(cdf[0]) > 0).all()
    vals = np.array([0, 0, 7, 0, 0, 0, -3, 1], np.int32)
    blob = port.run_length_gamma_encode(vals)
    assert blob == tpc.run_length_gamma_encode(vals)
    np.testing.assert_array_equal(port.run_length_gamma_decode(blob, vals.shape), vals)


@pytest.mark.parametrize("alpha", [0.5, 5.0, 20.0])
def test_rounding_modules_equal_jax(alpha):
    x = (np.random.RandomState(int(alpha)).randn(3, 50) * 3).astype(np.float32)
    cases = [
        (port.Round(), jax_soft_round.Round()),
        (port.SoftRound(alpha), jax_soft_round.SoftRound(alpha)),
        (port.SoftRound(alpha, inverse=True), jax_soft_round.SoftRound(alpha, inverse=True)),
        (port.SoftRoundConditionalMean(alpha), jax_soft_round.SoftRoundConditionalMean(alpha)),
    ]
    for mod, jax_mod in cases:
        want = np.asarray(jax_mod.apply({}, jnp.asarray(x)))
        np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=type(mod).__name__)
    xt = torch.from_numpy(x).requires_grad_()
    port.Round()(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    from compression_tpu_torch.util.profiling import StageTimer, annotate, trace

    timer = StageTimer()
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("entropy-coding"), timer.stage("coding"):
            torch.randn(64, 64).sum()
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert "entropy-coding" in text
    assert any(e.key == "entropy-coding" for e in prof.key_averages())
    assert "coding" in timer.report()
