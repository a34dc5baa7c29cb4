"""chip_smoke.py: refuses to run without a GPU, and its phase functions
(the on-card checks) run and pass at tiny sizes on the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu_or_repo(tmp_path, alone):
    """No GPU (here), or a directory holding chip_smoke.py and nothing else
    of the repo: nonzero exit and no result line."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = _run("chip_smoke.py", tmp_path)
    else:
        proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_hit_agree_tiny():
    out = chip_smoke.phase_hit_agree(width=32, height=16,
                                     oracle_device=jax.devices("cpu")[0])
    assert out["rays"] == 2 * 32 * 16 and out["hits"] > 0
    assert out["route"] == "brute"


def test_phase_bvh_traverse_tiny():
    out = chip_smoke.phase_bvh_traverse(width=32, height=16, n_spheres=256,
                                        mesh_detail=0)
    assert out["hits"] > 0


def test_phase_goldens_pool_matches_cpu_golden():
    out = chip_smoke.phase_goldens(names=["smoke_fused_64x36"], runs=1)
    mean_d, _ = out["smoke_fused_64x36"]["run0"]
    # The pool's CPU render is the golden's own computation.
    assert mean_d < 1e-3


def test_phase_main_path_tiny(tmp_path):
    out = chip_smoke.phase_main_path(
        width=32, height=18, spp=2, funnel_size=(24, 16),
        funnel_kw=dict(n_spheres=64, mesh_detail=0), pool_size=(24, 16),
        out_dir=str(tmp_path))
    assert out["segments_per_s"] > 0


def test_phase_gradient_tiny():
    out = chip_smoke.phase_gradient(width=24, height=16)
    assert out["grad"] != 0.0


def test_phase_four_on_virtual_devices():
    """The four-card phase on four of the eight virtual CPU devices."""
    out = chip_smoke.phase_four(width=32, height=16, spp=2)
    assert out["mean_d"] < 1e-5


@pytest.mark.gpu
def test_hit_agree_on_card(gpu_devices):
    """Full-size hit agreement against the host-CPU oracle (on the card:
    python -m pytest tests/ -m gpu)."""
    out = chip_smoke.phase_hit_agree()
    assert out["rays"] == 262_144
