"""Entry-point contract tests for __graft_entry__.

A caller imports the module in its own interpreter — sometimes after
having already initialized a JAX backend — and calls
``dryrun_multichip(8)`` with NO environment preparation. An early
failure was exactly this path (the function assumed devices already
existed), so these tests invoke it the way such a caller does: a fresh
subprocess, JAX-related env stripped.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # quick tier: -m 'not slow'

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_dryrun_multichip_fresh_interpreter():
    """Exactly the driver's call: no env, fresh process."""
    r = _run("import __graft_entry__; __graft_entry__.dryrun_multichip(8)")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "bf16 mesh ok" in r.stdout, (r.stdout, r.stderr[-500:])


def test_dryrun_multichip_after_backend_init():
    """Driver variant: a CPU backend is already live with 1 device when
    dryrun_multichip is called; it must re-provision."""
    r = _run(
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) < 8\n"
        "import __graft_entry__\n"
        "__graft_entry__.dryrun_multichip(8)\n"
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "bf16 mesh ok" in r.stdout, (r.stdout, r.stderr[-500:])
