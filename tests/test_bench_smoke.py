"""bench.py and chip_smoke.py measure the GPU and nothing else: on a host
where JAX finds no GPU they exit non-zero with a clear message and print no
result."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd=REPO, args=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-u", script, *args],
        env=env, cwd=cwd, capture_output=True, text=True, timeout=300,
    )


def test_bench_json_contract():
    out = _run(os.path.join(REPO, "bench.py"))
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert "{" not in out.stdout


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_chip_smoke_fails_without_gpu(args):
    out = _run(os.path.join(REPO, "chip_smoke.py"), args=args)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_image_fails_without_gpu():
    out = _run(os.path.join(REPO, "benchmarks", "bench_image.py"))
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
