import os
import sys

# smoke tests and benches must see 1 device; only launch/dryrun.py sets 512.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (run with -m gpu); skips without one")
