"""Build the native loader library once, before any test module is collected.

``tests/test_device_pipeline.py`` asks the JAX package's loader for
``native/libodcib.so`` while it is imported, and that loader builds the
library in place on first use. pytest-xdist workers collect at once, so on
a checkout without the library they would race: one worker opens the file
another is still writing, fails, and keeps that failure. This root conftest
is loaded by the controller before the workers start (and by each worker
before it collects, where the library is then already there), and builds
the library through the port's locked, atomic build
(``object_detection_cib_torch/data/native_loader.py``). A failed build is
reported once, as a warning with the compiler's message; the tests that
need the library then fail or skip on their own.
"""

import subprocess

import pytest

from object_detection_cib_torch.data import native_loader


def pytest_configure(config):
    try:
        native_loader.build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        config.issue_config_time_warning(
            pytest.PytestWarning(f"native/{native_loader.LIB_NAME} could not be built: {e}"),
            stacklevel=2)
