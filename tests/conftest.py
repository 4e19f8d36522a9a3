import os
import sys

# Tests run on the single real CPU device (the 512-device override is
# exclusively the dry-run's; see launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))  # hypothesis_compat shim


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel of repro_torch on an NVIDIA "
        "GPU; skips inside the test where torch.cuda.is_available() is "
        "False")
