"""chip_smoke.py's contract, rehearsed on the CPU backend at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600,
    )


def test_rehearse_last_line_shape():
    out = _run([str(REPO / "chip_smoke.py"), "--rehearse"], REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"ok", "device"}
    assert last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}
    assert last["device"]["count"] == 1
    # a rehearsal never claims the GPU
    assert "gpu" not in lines[-1]
    assert "REHEARSAL" in out.stdout


def test_fails_without_gpu_and_alone(tmp_path):
    # on the CPU backend without --rehearse: no result, nonzero exit
    out = _run([str(REPO / "chip_smoke.py")], REPO)
    assert out.returncode != 0
    assert json.loads(out.stdout.strip().splitlines()[-1])["ok"] is False
    # in a directory that holds chip_smoke.py and nothing else of the repo
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert out.returncode != 0
    assert json.loads(out.stdout.strip().splitlines()[-1])["ok"] is False
