"""The port's joint G/D step against the JAX package's under the
log-proportional rate law (``hinge_softness > 0``), on the patch's interior
rate (lambda then carries a gradient into the rate) and on the probe's
rate; the comparisons, sizes and tolerances of
tests/test_torch_hific_step.py."""

import pytest

from test_torch_hific_step import WARMUP, inputs, run_case  # noqa: F401  (a fixture)


@pytest.mark.parametrize("probe", [-1.0, 0.6])
def test_joint_step_under_the_log_proportional_law_matches_jax(inputs, monkeypatch,  # noqa: F811
                                                               probe):
    run_case(inputs, monkeypatch, {"hinge_softness": 8.0}, WARMUP, probe, -1.0)
