"""`chip_smoke.py`: refuses to run without a GPU; its card phases."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", DENSEPOINTS_NO_CACHE="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "not a GPU" in out.stdout + out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text()
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")


@pytest.mark.chip
def test_scoring_parity_on_card(gpu):
    """Phase 2 of chip_smoke: both scoring paths vs the f64 oracle."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    chip_smoke.phase_parity()
