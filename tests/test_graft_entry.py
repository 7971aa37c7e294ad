"""The multi-device correctness check must pass when invoked from a process
whose JAX backend exposes fewer devices than requested. We reproduce that
invocation in a subprocess whose backend is a single CPU device —
`dryrun_multichip` must detect the shortfall and re-exec itself onto an
8-device virtual mesh."""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_self_bootstraps():
    env = dict(os.environ)
    # Force the parent process onto a 1-device CPU backend (the analog of a
    # one-device host): cpu platform, NO forced device count.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f
    )
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    code = (
        "import jax; "
        "assert len(jax.devices()) == 1, jax.devices(); "
        "import __graft_entry__ as g; g.dryrun_multichip(8)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip OK" in proc.stdout, proc.stdout
    assert "'cells': 4" in proc.stdout and "'genes': 2" in proc.stdout, proc.stdout
