"""Fixtures shared by the port's CPU tests (tests/test_torch_port_*.py).

`native_build_outside_checkout` sends the port's native C++ builds
(menghini_neurips23_tpu_torch/data/_native.py, build/native/ at the
repository root by default) into a temporary directory, so that a test run
writes nothing into the checkout.  A test file takes it by importing it.
"""

import pytest

from menghini_neurips23_tpu_torch.data import _native


@pytest.fixture(scope="module", autouse=True)
def native_build_outside_checkout(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_native, "_BUILD_DIR", str(tmp_path_factory.mktemp("native")))
        yield
