"""Post-install smoke run of the port (counterpart of
``compression_tpu/all_tests.py``):

    python -m compression_tpu_torch.all_tests

Beside a checkout's ``tests/`` tree it runs the port's tests
(``tests/test_torch_*.py``, which compare the port with the JAX package).
Without one, as in an installed package, it imports the package and
round-trips four symbols through the port's host range coder (built from
its C++ source at first use).
"""

from __future__ import annotations

import glob
import os
import sys

TESTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")


def main() -> int:
    if not os.path.isdir(TESTS_DIR):
        import numpy as np

        import compression_tpu_torch as tpc
        from compression_tpu_torch.codec import host

        cdf = host.pmf_to_quantized_cdf(
            np.array([[0.5, 0.3, 0.2]]), np.array([3], np.int32), 12
        )
        strings = host.entropy_encode(
            np.array([[0, 1, 2, 1]], np.int32),
            np.zeros((1, 4), np.int32),
            cdf, np.array([4], np.int32), np.zeros(1, np.int32), 12,
        )
        back = host.entropy_decode(
            strings, np.zeros((1, 4), np.int32), cdf,
            np.array([4], np.int32), np.zeros(1, np.int32), 12,
        )
        assert back.tolist() == [[0, 1, 2, 1]]
        print(f"compression_tpu_torch {tpc.__version__}: smoke test OK")
        return 0
    import pytest

    return pytest.main(sorted(glob.glob(os.path.join(TESTS_DIR, "test_torch_*.py"))) + ["-q"])


if __name__ == "__main__":
    sys.exit(main())
