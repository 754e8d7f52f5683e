"""chip_smoke.py's contract where there is no GPU: it fails, prints no
result, and picks its phases from the command line."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_fails_without_gpu(args):
    r = _run(REPO, *args)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_four_cards_selects_only_its_phase():
    assert chip_smoke.selected_phases(["--four-cards"]) == ["four"]


def test_default_runs_every_single_card_phase():
    assert chip_smoke.selected_phases([]) == [
        "dense", "video", "served", "sparse", "solver",
    ]
