"""chip_smoke.py refuses to report anything off the GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_a_gpu():
    out = _run(REPO, REPO / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_alone_in_a_directory(tmp_path):
    """Copied away from the repo, the script has no program to run."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
