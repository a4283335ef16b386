import os
import sys
from pathlib import Path

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single CPU device; only the dry-run launcher forces 512 host devices.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips elsewhere")
