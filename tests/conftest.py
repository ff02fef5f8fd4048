import numpy as np
import pytest

# NOTE: no XLA_FLAGS here — tests must see the real single CPU device;
# only launch/dryrun.py requests 512 placeholder devices.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel; skips without a CUDA card")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
