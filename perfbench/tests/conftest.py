"""The benchmark's own CPU tests (``python -m pytest perfbench/tests``).
Registers the marker of tests that need a CUDA device, as the repo's
``tests/conftest.py`` does, so this folder runs on its own too."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on an NVIDIA GPU; skipped without one")
